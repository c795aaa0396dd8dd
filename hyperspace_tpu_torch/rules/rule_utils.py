"""Shared rule machinery (counterpart of `hyperspace_tpu/rules/rule_utils.py`).

`get_candidate_indexes` keeps the ACTIVE indexes of one kind whose recorded
signature provider recomputes the same signature on the query's relation
(reference `RuleUtils.scala`); `_index_relation` (from the JAX package's
`filter_index_rule.py` :312) builds the relation that substitutes an index
for its source. Deletes that a refresh folded into the log entry ride every
candidate, so the rules wrap its scan in `lineage_prune_condition`. With
Hybrid Scan on, an index whose source drifted since its last refresh is a
candidate too when the drift is recoverable (`hybrid_delta`): files appended
since are merged in at query time, files that vanished are pruned by lineage.

Telemetry (`rule_utils.py:130-260`): `record_rule_decision` counts each
decision (`rule.<Rule>.applied|skipped`) and, while a trace records, appends
it to the ambient `rule:<Rule>` span, where `explain(analyze=True)` reads
it; `log_rule_failure` warns, records the failure as a skipped decision and
logs a `HyperspaceRuleFailureEvent`; candidate selection keeps the per-index
staleness gauge (`index.staleness_s.<name>`) and counts quarantined skips
per asking rule.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

from ..actions import states
from ..config import IndexConstants
from ..engine.expr import Col, Expr, IsIn, Not
from ..engine.logical import BucketSpec, LogicalPlan, ScanNode, SourceRelation, find_single_relation
from ..engine.schema import Schema
from ..index import quarantine
from ..index.log_entry import IndexLogEntry
from ..index.signatures import create_provider
from ..storage.filesystem import FileStatus
from ..telemetry import metrics, tracing
from ..telemetry.event_logging import log_event
from ..telemetry.events import HyperspaceRuleFailureEvent


class CandidateIndex:
    """An applicable index and the source-file delta since it was built
    (`rule_utils.CandidateIndex` :175): the files appended (merged at
    execution time) and the files whose rows it must prune by lineage at scan
    time (vanished or folded). Both empty for an exact match with no folded
    deletes."""

    def __init__(self, entry: IndexLogEntry, appended: Optional[List[FileStatus]] = None,
                 deleted: Optional[List[str]] = None):
        self.entry = entry
        self.appended = appended or []
        self.deleted = deleted or []


def _hash_scheme_compatible(entry: IndexLogEntry) -> bool:
    """Whether the index was bucketed under the current hash scheme (entries
    with no recorded version predate the field and used scheme 1)."""
    props = getattr(entry.derived_dataset, "properties", None) or {}
    return props.get(IndexConstants.HASH_SCHEME_KEY) in (None, IndexConstants.HASH_SCHEME_VERSION)


def hybrid_delta(entry: IndexLogEntry, plan: LogicalPlan, deletes_without_lineage_ok: bool = False):
    """(appended files, deleted paths) between the index's recorded source
    inventory and the relation's current one, or None when Hybrid Scan cannot
    answer from the index (JAX :54-92): a recorded file changed in place
    (same path, other size or mtime) mixes old rows with new ones; a vanished
    file is tolerable only when the index carries lineage, whose column lets
    the scan prune its rows, or when the index kind keeps its data per source
    file (`deletes_without_lineage_ok`: a data-skipping index, whose vanished
    file simply leaves the scan). None too when nothing drifted."""
    if not isinstance(plan, ScanNode):
        return None
    recorded = {(f.name, f.size, f.modified_time) for r in entry.relations for f in r.data.file_infos()}
    current = plan.relation.files
    current_keys = {(f.path, f.size, f.modified_time) for f in current}
    current_paths = {f.path for f in current}
    deleted: List[str] = []
    for name, size, mtime in recorded:
        if (name, size, mtime) in current_keys:
            continue
        if name in current_paths:
            return None  # changed in place: its rows are not separable
        deleted.append(name)
    if deleted and not deletes_without_lineage_ok and not entry.has_lineage():
        return None
    appended = [f for f in current if (f.path, f.size, f.modified_time) not in recorded]
    if not appended and not deleted:
        return None
    return appended, sorted(deleted)


def get_candidate_indexes(
    index_manager,
    plan: LogicalPlan,
    hybrid_scan: bool = False,
    kind: str = "CoveringIndex",
    deletes_without_lineage_ok: bool = False,
    rule_name: Optional[str] = None,
) -> List[CandidateIndex]:
    """ACTIVE indexes of `kind` applicable to `plan` (a relation node), less
    the quarantined ones (`index/quarantine.py`) and those bucketed under
    another hash scheme. Exact applicability: the recorded signature provider
    recomputes the same signature. With `hybrid_scan`, an index whose
    inventory drifted recoverably (`hybrid_delta`) is a candidate as well.
    The deletes a refresh folded (`entry.deleted_source_files()`) ride every
    candidate, exact matches included: the signature covers the source after
    the delete, but the index data holds those rows until a full rewrite or
    a compaction (JAX :20-127). A quarantined skip counts in
    `rule.<rule_name>.quarantined`, and every candidate refreshes its
    staleness gauge (`_update_staleness`)."""
    signature_map: Dict[str, Optional[str]] = {}

    def signature_valid(entry: IndexLogEntry) -> bool:
        sig = entry.signature()
        if sig.provider not in signature_map:
            signature_map[sig.provider] = create_provider(sig.provider).signature(plan)
        computed = signature_map[sig.provider]
        return computed is not None and computed == sig.value

    out: List[CandidateIndex] = []
    for e in index_manager.get_indexes([states.ACTIVE]):
        if e.kind != kind or not e.created:
            continue
        if quarantine.is_quarantined(e.name):
            metrics.counter(f"rule.{rule_name}.quarantined" if rule_name else "rule.quarantined").inc()
            continue
        if not _hash_scheme_compatible(e):
            continue
        folded = e.deleted_source_files()
        if signature_valid(e):
            out.append(CandidateIndex(e, [], folded))
            _update_staleness(e, [])
        elif hybrid_scan:
            delta = hybrid_delta(e, plan, deletes_without_lineage_ok)
            if delta is not None:
                out.append(CandidateIndex(e, delta[0], sorted(set(delta[1]) | set(folded))))
                _update_staleness(e, delta[0])
    return out


def _update_staleness(entry: IndexLogEntry, appended) -> None:
    """`index.staleness_s.<name>`: now less the newest unindexed source
    file's mtime, 0 when the index covers the source (:130)."""
    staleness = 0.0
    if appended:
        staleness = max(0.0, time.time() - max(f.modified_time for f in appended) / 1000.0)
    metrics.gauge(f"index.staleness_s.{entry.name}").set(round(staleness, 3))


def record_rule_decision(rule_name: str, applied: bool, reason: Optional[str] = None,
                         indexes: Optional[List[str]] = None, **extra) -> None:
    """One rule decision at a node that matched the rule's pattern: the
    `rule.<Rule>.applied|skipped` counter, and while a trace records, a
    decision on the ambient span (:203-230)."""
    metrics.counter(f"rule.{rule_name}.{'applied' if applied else 'skipped'}").inc()
    sp = tracing.current_span()
    if sp is not None:
        d = {"rule": rule_name, "applied": applied}
        if reason:
            d["reason"] = reason
        if indexes:
            d["indexes"] = list(indexes)
        d.update(extra)
        sp.append_attr("decisions", d)


def log_rule_failure(session, rule_name: str, exc: BaseException) -> None:
    """A rule raised and the query keeps its original plan: a warning, a
    skipped decision naming the error, and a `HyperspaceRuleFailureEvent`
    (:232-260)."""
    logging.getLogger("hyperspace_tpu_torch.rules").warning(
        "%s failed; query falls back to the original plan: %s: %s", rule_name, type(exc).__name__, exc
    )
    record_rule_decision(rule_name, False, reason=f"error: {type(exc).__name__}: {exc}")
    log_event(session, HyperspaceRuleFailureEvent(
        rule_name=rule_name, exception=f"{type(exc).__name__}: {exc}",
        message=f"{rule_name} failed; original plan returned.",
    ))


def lineage_prune_condition(deleted: List[str]) -> Expr:
    """The scan-time filter that prunes the rows of folded source files:
    `NOT (_data_file_name IN deleted)`. It keeps bucket membership and the
    order within a bucket, so the co-bucketed join stays sound over it."""
    return Not(IsIn(Col(IndexConstants.DATA_FILE_NAME_COLUMN), list(deleted)))


def get_scan_node(plan: LogicalPlan) -> Optional[ScanNode]:
    return find_single_relation(plan)


def index_files_as_statuses(entry: IndexLogEntry) -> List[FileStatus]:
    return [
        FileStatus(path=f.name, size=f.size, modified_time=f.modified_time, is_dir=False)
        for f in entry.content.file_infos()
    ]


def _index_relation(entry: IndexLogEntry, with_bucket_spec: bool = False, files=None) -> SourceRelation:
    """The substituted relation over the index's own data files. No bucket
    spec for filter scans (the join rule asks for one); `files` restricts the
    scan to a subset (bucket pruning), and the relation then names the rule
    that pruned it."""
    spec = None
    if with_bucket_spec:
        spec = BucketSpec(
            num_buckets=entry.num_buckets,
            bucket_columns=tuple(entry.indexed_columns),
            sort_columns=tuple(entry.indexed_columns),
        )
    all_files = index_files_as_statuses(entry)
    pruned = files is not None and len(files) < len(all_files)
    return SourceRelation(
        root_paths=[entry.index_location()],
        file_format="parquet",
        schema=Schema.from_json_string(entry.schema_json),
        files=all_files if files is None else files,
        bucket_spec=spec,
        index_name=entry.name,
        log_entry_id=entry.id,
        pruned_by=["FilterIndexRule:bucket"] if pruned else [],
    )

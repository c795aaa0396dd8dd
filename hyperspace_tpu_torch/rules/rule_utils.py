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
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..actions import states
from ..config import IndexConstants
from ..engine.expr import Col, Expr, IsIn, Not
from ..engine.logical import BucketSpec, LogicalPlan, ScanNode, SourceRelation
from ..engine.schema import Schema
from ..index import quarantine
from ..index.log_entry import IndexLogEntry
from ..index.signatures import create_provider
from ..storage.filesystem import FileStatus


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
) -> List[CandidateIndex]:
    """ACTIVE indexes of `kind` applicable to `plan` (a relation node), less
    the quarantined ones (`index/quarantine.py`) and those bucketed under
    another hash scheme. Exact applicability: the recorded signature provider
    recomputes the same signature. With `hybrid_scan`, an index whose
    inventory drifted recoverably (`hybrid_delta`) is a candidate as well.
    The deletes a refresh folded (`entry.deleted_source_files()`) ride every
    candidate, exact matches included: the signature covers the source after
    the delete, but the index data holds those rows until a full rewrite or
    a compaction (JAX :20-127). The JAX package also sets a per-index
    staleness gauge here (`_update_staleness`) and counts quarantined skips
    per asking rule (its `rule_name`); both wait for the port's telemetry
    (ROADMAP.md Queue 1, item 12)."""
    signature_map: Dict[str, Optional[str]] = {}

    def signature_valid(entry: IndexLogEntry) -> bool:
        sig = entry.signature()
        if sig.provider not in signature_map:
            signature_map[sig.provider] = create_provider(sig.provider).signature(plan)
        computed = signature_map[sig.provider]
        return computed is not None and computed == sig.value

    out: List[CandidateIndex] = []
    for e in index_manager.get_indexes([states.ACTIVE]):
        if e.kind != kind or not e.created or quarantine.is_quarantined(e.name):
            continue
        if not _hash_scheme_compatible(e):
            continue
        folded = e.deleted_source_files()
        if signature_valid(e):
            out.append(CandidateIndex(e, [], folded))
        elif hybrid_scan:
            delta = hybrid_delta(e, plan, deletes_without_lineage_ok)
            if delta is not None:
                out.append(CandidateIndex(e, delta[0], sorted(set(delta[1]) | set(folded))))
    return out


def lineage_prune_condition(deleted: List[str]) -> Expr:
    """The scan-time filter that prunes the rows of folded source files:
    `NOT (_data_file_name IN deleted)`. It keeps bucket membership and the
    order within a bucket, so the co-bucketed join stays sound over it."""
    return Not(IsIn(Col(IndexConstants.DATA_FILE_NAME_COLUMN), list(deleted)))


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

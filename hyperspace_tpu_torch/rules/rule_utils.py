"""Shared rule machinery (counterpart of `hyperspace_tpu/rules/rule_utils.py`).

`get_candidate_indexes` keeps the ACTIVE covering indexes whose recorded
signature provider recomputes the same signature on the query's relation
(reference `RuleUtils.scala`); `_index_relation` (from the JAX package's
`filter_index_rule.py` :312) builds the relation that substitutes an index
for its source. Deletes that a refresh folded into the log entry ride every
candidate, so the rules wrap its scan in `lineage_prune_condition`. Hybrid
Scan is not ported: an index whose source drifted since its last refresh is
not a candidate, and the conf asking for it raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..actions import states
from ..config import IndexConstants
from ..engine.expr import Col, Expr, IsIn, Not
from ..engine.logical import BucketSpec, LogicalPlan, SourceRelation
from ..engine.schema import Schema
from ..index import quarantine
from ..index.log_entry import IndexLogEntry
from ..index.signatures import create_provider
from ..storage.filesystem import FileStatus


class CandidateIndex:
    """An applicable index (exact signature match) and the source files whose
    rows it must prune by lineage at scan time (its folded deletes)."""

    def __init__(self, entry: IndexLogEntry, deleted: Optional[List[str]] = None):
        self.entry = entry
        self.deleted = deleted or []


def _hash_scheme_compatible(entry: IndexLogEntry) -> bool:
    """Whether the index was bucketed under the current hash scheme (entries
    with no recorded version predate the field and used scheme 1)."""
    props = getattr(entry.derived_dataset, "properties", None) or {}
    return props.get(IndexConstants.HASH_SCHEME_KEY) in (None, IndexConstants.HASH_SCHEME_VERSION)


def get_candidate_indexes(index_manager, plan: LogicalPlan) -> List[CandidateIndex]:
    """ACTIVE covering indexes applicable to `plan` (a relation node), less
    the quarantined ones (`index/quarantine.py`). The deletes a refresh folded
    (`entry.deleted_source_files()`) ride every candidate, exact matches
    included: the signature covers the source after the delete, but the
    index data holds those rows until a full rewrite (JAX :38-44)."""
    signature_map: Dict[str, Optional[str]] = {}

    def signature_valid(entry: IndexLogEntry) -> bool:
        sig = entry.signature()
        if sig.provider not in signature_map:
            signature_map[sig.provider] = create_provider(sig.provider).signature(plan)
        computed = signature_map[sig.provider]
        return computed is not None and computed == sig.value

    return [
        CandidateIndex(e, e.deleted_source_files())
        for e in index_manager.get_indexes([states.ACTIVE])
        if e.kind == "CoveringIndex" and e.created and not quarantine.is_quarantined(e.name)
        and _hash_scheme_compatible(e) and signature_valid(e)
    ]


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

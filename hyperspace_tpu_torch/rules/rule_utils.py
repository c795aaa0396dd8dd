"""Shared rule machinery (counterpart of `hyperspace_tpu/rules/rule_utils.py`).

`get_candidate_indexes` keeps the ACTIVE covering indexes whose recorded
signature provider recomputes the same signature on the query's relation
(reference `RuleUtils.scala`); `_index_relation` (from the JAX package's
`filter_index_rule.py`) builds the relation that substitutes an index for its
source. Hybrid scan and lineage-based delete tolerance are not ported yet:
an index whose source drifted is simply not a candidate.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..actions import states
from ..config import IndexConstants
from ..engine.logical import BucketSpec, LogicalPlan, SourceRelation
from ..engine.schema import Schema
from ..index.log_entry import IndexLogEntry
from ..index.signatures import create_provider
from ..storage.filesystem import FileStatus


class CandidateIndex:
    """An applicable index (exact signature match)."""

    def __init__(self, entry: IndexLogEntry):
        self.entry = entry


def _hash_scheme_compatible(entry: IndexLogEntry) -> bool:
    """Whether the index was bucketed under the current hash scheme (entries
    with no recorded version predate the field and used scheme 1)."""
    props = getattr(entry.derived_dataset, "properties", None) or {}
    return props.get(IndexConstants.HASH_SCHEME_KEY) in (None, IndexConstants.HASH_SCHEME_VERSION)


def get_candidate_indexes(index_manager, plan: LogicalPlan) -> List[CandidateIndex]:
    """ACTIVE covering indexes applicable to `plan` (a relation node)."""
    signature_map: Dict[str, Optional[str]] = {}

    def signature_valid(entry: IndexLogEntry) -> bool:
        sig = entry.signature()
        if sig.provider not in signature_map:
            signature_map[sig.provider] = create_provider(sig.provider).signature(plan)
        computed = signature_map[sig.provider]
        return computed is not None and computed == sig.value

    return [
        CandidateIndex(e)
        for e in index_manager.get_indexes([states.ACTIVE])
        if e.kind == "CoveringIndex" and e.created and _hash_scheme_compatible(e) and signature_valid(e)
    ]


def index_files_as_statuses(entry: IndexLogEntry) -> List[FileStatus]:
    return [
        FileStatus(path=f.name, size=f.size, modified_time=f.modified_time, is_dir=False)
        for f in entry.content.file_infos()
    ]


def _index_relation(entry: IndexLogEntry, with_bucket_spec: bool = False) -> SourceRelation:
    """The substituted relation over the index's own data files."""
    spec = None
    if with_bucket_spec:
        spec = BucketSpec(
            num_buckets=entry.num_buckets,
            bucket_columns=tuple(entry.indexed_columns),
            sort_columns=tuple(entry.indexed_columns),
        )
    return SourceRelation(
        root_paths=[entry.index_location()],
        file_format="parquet",
        schema=Schema.from_json_string(entry.schema_json),
        files=index_files_as_statuses(entry),
        bucket_spec=spec,
        index_name=entry.name,
        log_entry_id=entry.id,
    )

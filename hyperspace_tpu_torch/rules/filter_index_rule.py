"""FilterIndexRule: rewrite Filter-over-relation plans to scan a covering index.

Parity: `hyperspace_tpu/rules/filter_index_rule.py` (reference
`index/rules/FilterIndexRule.scala:38-253`):
- pattern: Project? > Filter > Relation (:211-253);
- applicability: the index covers every output and filter column AND the
  filter references the head (first) indexed column (:183-195);
- rewrite: the relation becomes a scan of the index's files with NO bucket
  spec (filters prefer full scan parallelism, :100-132), under the same filter
  and a projection that keeps the output column order;
- bucket pruning (`hyperspace.index.filter.bucketPruning`, default on): the
  build buckets rows by the hash of ALL indexed columns together, so when
  conjuncts pin every indexed column to literals (`==` or `isin`), the rows
  that can match live only in the buckets of those literal tuples and every
  other `part-<bucket>` file is skipped. A filter that leaves an indexed
  column free prunes nothing. (The JAX package hashes the head literal alone,
  which drops rows of a multi-column index; the port does not copy that.)
- deletes folded by a refresh, or files vanished under Hybrid Scan: the
  index scan sits under the lineage prune filter, below the user's filter
  and the output projection (:132-138);
- Hybrid Scan (`hyperspace.index.hybridscan.enabled`): the user's filter
  goes over `Union(Project(needed, index scan), Project(needed, scan of the
  appended source files))`, so the appended rows answer beside the index's
  (:139-160);
- ranking: the least source drift first (appended and deleted files, each
  costs work per query), then first-candidate (:300-303);
- any exception returns the original plan (:74-78).
Each match records its decision (`record_rule_decision`); an applied
rewrite logs a `HyperspaceIndexUsageEvent`, a failure `log_rule_failure`.
"""

from __future__ import annotations

import os
import re
from typing import List

import numpy as np

from ..engine.expr import BinaryOp, Col, IsIn, Lit
from ..engine.logical import FilterNode, LogicalPlan, ProjectNode, ScanNode, SourceRelation, UnionNode
from ..engine.schema import BOOL, FLOAT64, INT32, INT64, STRING, Schema
from ..engine.table import Column
from ..index.log_entry import IndexLogEntry
from ..ops.hashing import bucket_id
from ..util.resolver_utils import resolve, resolve_all
from ..telemetry.event_logging import log_event
from ..telemetry.events import HyperspaceIndexUsageEvent
from .rule_utils import (
    _index_relation,
    get_candidate_indexes,
    index_files_as_statuses,
    lineage_prune_condition,
    log_rule_failure,
    record_rule_decision,
)


def _extract_filter_node(plan: LogicalPlan):
    """Match Project?>Filter>Scan: (project or None, filter, scan), or None."""
    if isinstance(plan, ProjectNode) and isinstance(plan.child, FilterNode):
        f = plan.child
        if isinstance(f.child, ScanNode):
            return plan, f, f.child
    if isinstance(plan, FilterNode) and isinstance(plan.child, ScanNode):
        return None, plan, plan.child
    return None


def index_covers_plan(
    output_columns: List[str], filter_columns: List[str], entry: IndexLogEntry, case_sensitive: bool = False
) -> bool:
    """All referenced columns ⊆ index columns AND the filter references the head
    indexed column (reference :183-195)."""
    head = entry.indexed_columns[0]
    if resolve(head, filter_columns, case_sensitive) is None:
        return False
    index_cols = entry.indexed_columns + entry.included_columns
    return resolve_all(output_columns + filter_columns, index_cols, case_sensitive) is not None


class FilterIndexRule:
    """Rule protocol: apply(plan, session) -> plan."""

    def apply(self, plan: LogicalPlan, session) -> LogicalPlan:
        from ..hyperspace import _index_manager_for

        try:
            index_manager = _index_manager_for(session)
            cs = session.hs_conf.case_sensitive
            hybrid = session.hs_conf.hybrid_scan_enabled

            def rewrite(node: LogicalPlan) -> LogicalPlan:
                m = _extract_filter_node(node)
                if m is None:
                    return node
                project, filt, scan = m
                if scan.relation.index_name is not None:
                    return node  # already rewritten
                output_columns = project.column_names if project is not None else scan.output_schema.names
                filter_columns = sorted(filt.condition.references())
                candidates = get_candidate_indexes(index_manager, scan, hybrid, rule_name="FilterIndexRule")
                if not candidates:
                    record_rule_decision("FilterIndexRule", False, reason="no-candidate-index")
                    return node
                usable = [c for c in candidates if index_covers_plan(list(output_columns), filter_columns, c.entry, cs)]
                if not usable:
                    record_rule_decision("FilterIndexRule", False, reason="not-covering",
                                         candidates=[c.entry.name for c in candidates])
                    return node
                chosen = rank(usable)
                best = chosen.entry
                pruned_files = None
                if session.hs_conf.filter_bucket_pruning:
                    pruned_files = _bucket_pruned_files(best, filt.condition, cs)
                index_child: LogicalPlan = ScanNode(_index_relation(best, files=pruned_files))
                if chosen.deleted:
                    # Prune the folded or vanished files' rows by lineage
                    # before the projection drops the column.
                    index_child = FilterNode(lineage_prune_condition(chosen.deleted), index_child)
                if chosen.appended:
                    # Hybrid Scan: the index data and the appended source
                    # files, both projected to the columns the query needs so
                    # that the union's schemas line up.
                    needed = list(dict.fromkeys(list(output_columns) + filter_columns))
                    rel = scan.relation
                    appended = SourceRelation(
                        root_paths=list(rel.root_paths), file_format=rel.file_format, schema=rel.schema,
                        files=chosen.appended, options=dict(rel.options), partition_spec=rel.partition_spec,
                    )
                    index_child = UnionNode(
                        [ProjectNode(needed, index_child), ProjectNode(needed, ScanNode(appended))]
                    )
                # Always project: the index stores its columns in
                # indexed + included order, not the source's.
                new_plan = ProjectNode(list(output_columns), FilterNode(filt.condition, index_child))
                record_rule_decision(
                    "FilterIndexRule", True, indexes=[best.name],
                    bucket_pruned_files=None if pruned_files is None else len(pruned_files),
                    hybrid_appended=len(chosen.appended), lineage_pruned=len(chosen.deleted),
                )
                log_event(session, HyperspaceIndexUsageEvent(
                    index_names=[best.name], plan_before=node.tree_string(), plan_after=new_plan.tree_string(),
                    message="Filter index rule applied.",
                ))
                return new_plan

            return plan.transform_up(rewrite)
        except Exception as e:  # never break the user's query over an index problem
            log_rule_failure(session, "FilterIndexRule", e)
            return plan


def _equality_values(condition, column: str, case_sensitive: bool):
    """Literal values v such that `condition` implies column == v: a top-level
    conjunct `column == lit` (either orientation) or `column IN [lits]`. None =
    no such conjunct. Only AND-descent, only plain literals."""

    def is_column(e) -> bool:
        return isinstance(e, Col) and resolve(e.name, [column], case_sensitive) is not None

    stack = [condition]
    while stack:
        e = stack.pop()
        if isinstance(e, BinaryOp) and e.op == "and":
            stack += [e.left, e.right]
            continue
        if isinstance(e, BinaryOp) and e.op == "==":
            for a, b in ((e.left, e.right), (e.right, e.left)):
                if is_column(a) and isinstance(b, Lit):
                    return [b.value]
        if isinstance(e, IsIn) and is_column(e.child):
            return list(e.values)
    return None


def _literal_array(value, dtype: str):
    """A literal as a one-element array in its column's hash space, or None
    when it has no place there (then no pruning)."""
    if isinstance(value, bool):
        return np.asarray([value]) if dtype == BOOL else None
    if dtype == STRING:
        return np.asarray([value]) if isinstance(value, str) else None
    if dtype in (INT32, INT64):
        # Integers hash from their int64 bits; an integral float literal equals
        # the same int rows, any other equals none (skip pruning).
        if isinstance(value, (int, np.integer)) or (isinstance(value, float) and float(value).is_integer()):
            v = int(value)
            return np.asarray([v], dtype=np.int64) if -(2**63) <= v < 2**63 else None
        return None
    if dtype == FLOAT64:
        ok = isinstance(value, (int, float, np.integer, np.floating))
        return np.asarray([float(value)], dtype=np.float64) if ok else None
    return None  # float32 storage widens before hashing: another literal space


def _buckets_of_literals(values_per_column, dtypes, num_buckets: int):
    """The hash buckets that the build gives every tuple of the pinned
    literals (one list per indexed column, in index order), or None when a
    literal has no place in its column's hash space. Uses the build's own
    `bucket_id` over all the columns, so build and prune agree."""
    per_column = []
    for values, dtype in zip(values_per_column, dtypes):
        arrays = [_literal_array(v, dtype) for v in values]
        if any(a is None for a in arrays):
            return None
        per_column.append(np.concatenate(arrays))
    grids = np.meshgrid(*[np.arange(len(a)) for a in per_column], indexing="ij")
    cols = [Column.from_values(a[g.ravel()], "cpu") for a, g in zip(per_column, grids)]
    return set(bucket_id(cols, num_buckets).tolist())


def _bucket_pruned_files(entry: IndexLogEntry, condition, case_sensitive: bool):
    """The index files a point lookup can touch: when the conjuncts pin every
    indexed column, rows that match live ONLY in the buckets of the pinned
    tuples, so every other `part-<bucket>` file is skipped. None = no pruning
    (an indexed column left free, a literal without a bucket, or a file outside
    the `part-<bucket>` naming)."""
    schema = Schema.from_json_string(entry.schema_json)
    values_per_column, dtypes = [], []
    for name in entry.indexed_columns:
        values = _equality_values(condition, name, case_sensitive)
        resolved = resolve(name, schema.names, case_sensitive)
        if values is None or resolved is None:
            return None
        values_per_column.append(values)
        dtypes.append(schema.field(resolved).dtype)
    if any(len(v) == 0 for v in values_per_column):
        buckets = set()  # an empty IN list matches no row
    else:
        buckets = _buckets_of_literals(values_per_column, dtypes, entry.num_buckets)
        if buckets is None:
            return None
    kept = []
    for f in index_files_as_statuses(entry):
        m = re.match(r"part-(\d+)\.parquet$", os.path.basename(f.path))
        if m is None:
            return None  # an unexpected layout: never prune what cannot be placed
        if int(m.group(1)) in buckets:
            kept.append(f)
    return kept


def rank(candidates):
    """FilterIndexRanker: exact matches before Hybrid Scan ones, the least
    source drift first (each appended file is read and each deleted one
    pruned per query), then the first (reference ranking TODO at :202-208)."""
    return sorted(candidates, key=lambda c: len(c.appended) + len(c.deleted))[0]

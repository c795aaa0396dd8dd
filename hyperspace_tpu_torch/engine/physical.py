"""Physical plan + executor (counterpart of `hyperspace_tpu/engine/physical.py`).

The operators of the slice: file scans, bucketed index scans, filters,
projections and the co-bucketed inner sort-merge join that `JoinIndexRule`
sets up. A filter evaluates its predicate on the device (`engine/evaluate.py`)
and keeps the surviving rows in order. Both join
sides arrive hash-partitioned into the same buckets on the join keys, so the
merge runs per bucket pair with no exchange (reference
`JoinIndexRule.scala:137-162`): `ops.bucket_join` probes all bucket pairs at
once, candidate pairs are verified by exact key equality (a 64-bit hash
collision can never join unequal rows), and the payload columns are gathered —
all as torch ops on the tables' device. The JAX package's memos and caches
(`physical.py:1817-2101`) are not ported: every query recomputes.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..exceptions import HyperspaceException, not_in_slice
from ..ops.hashing import key64
from . import io as engine_io
from .evaluate import evaluate_predicate
from .expr import Expr, extract_equi_join_keys
from .logical import FilterNode, JoinNode, LogicalPlan, ProjectNode, ScanNode, SourceRelation
from .schema import Schema
from .table import Column, Table

_BUCKET_FILE_RE = re.compile(r"part-(\d+)")


class ExecContext:
    def __init__(self, session):
        self.session = session

    @property
    def device(self) -> torch.device:
        return self.session.device


class PhysicalNode:
    name = "Physical"

    def children(self) -> Sequence["PhysicalNode"]:
        return ()

    def execute(self, ctx: ExecContext) -> Table:
        raise NotImplementedError

    def execute_count(self, ctx: ExecContext) -> int:
        return self.execute(ctx).num_rows

    def simple_string(self) -> str:
        return self.name

    def tree_string(self, indent: int = 0) -> str:
        lines = ["  " * indent + ("+- " if indent else "") + self.simple_string()]
        for c in self.children():
            lines.append(c.tree_string(indent + 1))
        return "\n".join(lines)

    def collect_nodes(self) -> List["PhysicalNode"]:
        out: List[PhysicalNode] = [self]
        for c in self.children():
            out.extend(c.collect_nodes())
        return out


class ScanExec(PhysicalNode):
    name = "Scan"

    def __init__(self, relation: SourceRelation, columns: Optional[List[str]] = None):
        self.relation = relation
        self.columns = columns

    def execute(self, ctx) -> Table:
        files = [f.path for f in self.relation.files]
        return engine_io.read_files(files, self.relation.file_format, self.columns, ctx.device)

    def execute_count(self, ctx) -> int:
        return engine_io.footer_row_count(self.relation.files)

    def simple_string(self):
        cols = f" [{', '.join(self.columns)}]" if self.columns else ""
        tag = f" index={self.relation.index_name}" if self.relation.index_name else ""
        if self.relation.pruned_by:
            tag += f" (files pruned by {','.join(self.relation.pruned_by)})"
        return f"Scan{tag} {','.join(self.relation.root_paths)}{cols}"


class BucketedIndexScanExec(PhysicalNode):
    """Reads index data preserving bucket structure: bucket ids come from the
    `part-<bucket>` file naming contract of the bucketed writer."""

    name = "BucketedIndexScan"

    def __init__(self, relation: SourceRelation, columns: Optional[List[str]] = None):
        assert relation.bucket_spec is not None
        self.relation = relation
        self.columns = columns

    def execute_concat(self, ctx) -> Tuple[Table, np.ndarray]:
        """The scan as one contiguous table + bucket start offsets (bucket b =
        rows[starts[b]:starts[b+1]])."""
        spec = self.relation.bucket_spec
        per_bucket: List[List[str]] = [[] for _ in range(spec.num_buckets)]
        for f in self.relation.files:
            m = _BUCKET_FILE_RE.search(os.path.basename(f.path))
            if m is None:
                raise HyperspaceException(f"Not a bucketed index file: {f.path}")
            per_bucket[int(m.group(1))].append(f.path)
        ordered = [p for paths in per_bucket for p in paths]
        starts = np.zeros(spec.num_buckets + 1, dtype=np.int64)
        if not ordered:
            names = self.columns or self.relation.schema.names
            empty = {n: _empty_column(self.relation.schema.field(n).dtype, ctx.device) for n in names}
            return Table(empty), starts
        # read_files concatenates in sorted path order: within one version
        # directory that is bucket order (zero-padded `part-<b>` names).
        if sorted(ordered) != ordered:
            raise not_in_slice("index data spread over several version directories")
        rows: List[int] = []
        table = engine_io.read_files(ordered, "parquet", self.columns, ctx.device, row_counts=rows)
        sizes = np.zeros(spec.num_buckets, dtype=np.int64)
        np.add.at(sizes, [b for b, paths in enumerate(per_bucket) for _ in paths], rows)
        np.cumsum(sizes, out=starts[1:])
        return table, starts

    def execute(self, ctx) -> Table:
        return self.execute_concat(ctx)[0]

    def execute_count(self, ctx) -> int:
        return engine_io.footer_row_count(self.relation.files)

    def simple_string(self):
        spec = self.relation.bucket_spec
        return (
            f"BucketedIndexScan index={self.relation.index_name} "
            f"buckets={spec.num_buckets} by {list(spec.bucket_columns)}"
        )


def _empty_column(dtype: str, device) -> Column:
    if dtype == "string":
        return Column(dtype, torch.empty(0, dtype=torch.int32, device=device), np.empty(0, dtype="<U1"))
    return Column.from_values(np.empty(0, np.dtype(dtype)), device)


class FilterExec(PhysicalNode):
    """Keeps the rows whose predicate is true and known, in order
    (physical.py:653)."""

    name = "Filter"

    def __init__(self, condition: Expr, child: PhysicalNode):
        self.condition = condition
        self.child = child

    def children(self):
        return (self.child,)

    @property
    def relation(self) -> SourceRelation:
        return self.child.relation

    def _keep(self, t: Table) -> torch.Tensor:
        return torch.nonzero(evaluate_predicate(self.condition, t)).squeeze(1)

    def execute(self, ctx) -> Table:
        t = self.child.execute(ctx)
        return t if t.num_rows == 0 else t.take(self._keep(t))

    def execute_concat(self, ctx) -> Tuple[Table, np.ndarray]:
        """A filtered bucketed scan with its bucket structure kept: a filter
        moves no row across buckets and keeps the order within one, so the
        co-bucketed join stays sound over it."""
        table, starts = self.child.execute_concat(ctx)
        if table.num_rows:
            keep = self._keep(table)
            bounds = torch.as_tensor(np.asarray(starts, np.int64), device=keep.device)
            starts = torch.searchsorted(keep, bounds).cpu().numpy().astype(np.int64)
            table = table.take(keep)
        return table, starts

    def simple_string(self):
        return f"Filter {self.condition!r}"


def _bucketed(node: PhysicalNode) -> bool:
    """A bucketed index scan, or a filter over one."""
    if isinstance(node, FilterExec):
        node = node.child
    return isinstance(node, BucketedIndexScanExec)


class ProjectExec(PhysicalNode):
    name = "Project"

    def __init__(self, column_names: Sequence[str], child: PhysicalNode):
        self.column_names = list(column_names)
        self.child = child

    def children(self):
        return (self.child,)

    def execute(self, ctx) -> Table:
        return self.child.execute(ctx).select(self.column_names)

    def execute_count(self, ctx) -> int:
        return self.child.execute_count(ctx)

    def simple_string(self):
        return f"Project [{', '.join(self.column_names)}]"


def _assemble_join(left: Table, right: Table, li: torch.Tensor, ri: torch.Tensor) -> Table:
    """Inner-join output from verified pairs: left columns, then right columns
    (a right name already on the left gets the `_r` suffix)."""
    out: Dict[str, Column] = dict(left.take(li).columns)
    for n, c in right.take(ri).columns.items():
        out[n if n not in out else f"{n}_r"] = c
    return Table(out)


def _verify_pairs(
    left: Table, right: Table, left_keys: List[str], right_keys: List[str],
    li: torch.Tensor, ri: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop candidate pairs whose keys differ (64-bit hash collisions) by exact
    key equality (physical.py:1624)."""
    if len(li):
        keep = torch.ones(li.shape[0], dtype=torch.bool, device=li.device)
        for lk, rk in zip(left_keys, right_keys):
            keep &= left.column(lk).data[li] == right.column(rk).data[ri]
        if not bool(keep.all()):
            li, ri = li[keep], ri[keep]
    return li, ri


def _gather_verified(
    left: Table, right: Table, left_keys: List[str], right_keys: List[str],
    li: torch.Tensor, ri: torch.Tensor,
) -> Table:
    """Verify candidate pairs, then gather the inner-join output (physical.py:1661)."""
    li, ri = _verify_pairs(left, right, left_keys, right_keys, li, ri)
    return _assemble_join(left, right, li, ri)


def _table_key64(table: Table, keys: List[str]) -> torch.Tensor:
    """Join key64 of a table's key columns (physical.py:2222)."""
    return key64([table.column(k).data for k in keys])


def _value_mode_column(table: Table, keys: List[str]) -> Optional[Column]:
    """The single join-key column when the side may run in value mode (one
    numeric non-bool key; string and nullable keys are refused earlier)."""
    if len(keys) != 1:
        return None
    c = table.column(keys[0])
    return None if c.dtype == "bool" else c


def _classed_plan(left: Table, right: Table, l_keys, r_keys, l_starts, r_starts):
    """The joint size-classed layout: value mode only when both sides qualify,
    else both sides pad by key64 hash (physical.py:2044)."""
    from ..ops.bucket_join import build_classed_plan, value_mode_vals

    lc = _value_mode_column(left, l_keys)
    rc = _value_mode_column(right, r_keys)
    if lc is not None and rc is not None:
        lv = value_mode_vals(lc.data, l_starts)
        rv = value_mode_vals(rc.data, r_starts)
        if lv is not None and rv is not None:
            return build_classed_plan(lv, rv, l_starts, r_starts, "value")
    lk = _table_key64(left, list(l_keys))
    rk = _table_key64(right, list(r_keys))
    return build_classed_plan(lk, rk, l_starts, r_starts, "hash")


class SortMergeJoinExec(PhysicalNode):
    """The co-bucketed inner sort-merge join over two bucketed index scans."""

    name = "SortMergeJoin"

    def __init__(self, left: PhysicalNode, right: PhysicalNode, left_keys: List[str], right_keys: List[str]):
        self.left = left
        self.right = right
        self.left_keys = left_keys
        self.right_keys = right_keys

    def children(self):
        return (self.left, self.right)

    def execute(self, ctx) -> Table:
        left, right, plan, ranges = self._plan_and_ranges(ctx)
        if plan is None:
            empty = torch.empty(0, dtype=torch.int64, device=ctx.device)
            return _assemble_join(left, right, empty, empty)
        li, ri = self._bucketed_pairs(plan, ranges)
        return _gather_verified(left, right, self.left_keys, self.right_keys, li, ri)

    def execute_count(self, ctx) -> int:
        left, right, plan, ranges = self._plan_and_ranges(ctx)
        n = self._bucketed_count_fast(plan, ranges)
        if n is not None:
            return n
        li, ri = self._bucketed_pairs(plan, ranges)
        return len(_verify_pairs(left, right, self.left_keys, self.right_keys, li, ri)[0])

    def _plan_and_ranges(self, ctx):
        """Both sides' bucketed concats, their joint size-classed layout and its
        probe (plan and ranges None when a side is empty)."""
        from ..ops.bucket_join import probe_classed

        left, l_starts = self.left.execute_concat(ctx)
        right, r_starts = self.right.execute_concat(ctx)
        for table, keys in ((left, self.left_keys), (right, self.right_keys)):
            if any(table.column(k).is_string or table.column(k).has_nulls for k in keys):
                raise not_in_slice("string or nullable join keys")
        if left.num_rows == 0 or right.num_rows == 0:
            return left, right, None, None
        plan = _classed_plan(left, right, self.left_keys, self.right_keys, l_starts, r_starts)
        return left, right, plan, probe_classed(plan)

    @staticmethod
    def _bucketed_count_fast(plan, ranges) -> Optional[int]:
        """Value-mode probe counts compare the actual key values, so their total
        is the exact inner-join count with no pair expansion (physical.py:2685).
        None in hash mode, whose candidates must be verified."""
        if plan is None:
            return 0
        return ranges.total if plan.mode == "value" else None

    @staticmethod
    def _bucketed_pairs(plan, ranges):
        """Candidate (li, ri) pairs in bucket-major order (physical.py:2584)."""
        from ..ops.bucket_join import classed_pairs

        return classed_pairs(plan, ranges)

    def simple_string(self):
        pairs = ", ".join(f"{l}={r}" for l, r in zip(self.left_keys, self.right_keys))
        return f"SortMergeJoin [{pairs}] (bucketed, no exchange)"


def _orient_join_keys(pairs, left_schema: Schema, right_schema: Schema):
    """Orient each (a, b) condition pair as (left_col, right_col); a name
    resolving on both sides is refused (physical.py:3007)."""
    lkeys, rkeys = [], []
    for a, b in pairs:
        a_in_l, a_in_r = a in left_schema, a in right_schema
        b_in_l, b_in_r = b in left_schema, b in right_schema
        if a.lower() == b.lower() and a_in_l and b_in_r:
            lkeys.append(a)
            rkeys.append(b)
        elif a_in_l and b_in_r and not (a_in_r or b_in_l):
            lkeys.append(a)
            rkeys.append(b)
        elif a_in_r and b_in_l and not (a_in_l or b_in_r):
            lkeys.append(b)
            rkeys.append(a)
        else:
            raise HyperspaceException(f"Cannot resolve join condition column(s) {a!r}/{b!r}")
    return lkeys, rkeys


def _bucketed_join_keys(lbucket, rbucket, lkeys, rkeys, key):
    """The join keys in bucket-column order when both sides are bucketed on
    exactly the join keys, in the same order under the key mapping, with equal
    bucket counts and hash kinds (the planner-side re-check of the join rule's
    compatibility condition); else None."""
    lspec, rspec = lbucket.relation.bucket_spec, rbucket.relation.bucket_spec
    pair_map: Dict[str, str] = {}
    for l, r in zip(lkeys, rkeys):
        if key(pair_map.get(key(l), r)) != key(r):
            return None
        pair_map[key(l)] = r
    lbc, rbc = list(lspec.bucket_columns), list(rspec.bucket_columns)
    if not (
        len({key(k) for k in lkeys}) == len(lkeys)
        and lspec.num_buckets == rspec.num_buckets
        and {key(c) for c in lbc} == {key(k) for k in lkeys}
        and [key(pair_map.get(key(c), "")) for c in lbc] == [key(c) for c in rbc]
    ):
        return None
    jl, jr = lbc, [pair_map[key(c)] for c in lbc]

    def kind(schema, name):
        dt = schema.field(name).dtype
        return "f" if dt in ("float32", "float64") else ("s" if dt == "string" else "i")

    if any(kind(lbucket.relation.schema, a) != kind(rbucket.relation.schema, b) for a, b in zip(jl, jr)):
        return None
    return jl, jr


def plan_physical(
    logical: LogicalPlan, required: Optional[List[str]] = None, case_sensitive: bool = False
) -> PhysicalNode:
    """Compile a logical plan, pushing column pruning into scans (physical.py:3044)."""
    from ..util.resolver_utils import resolution_key

    def key(s: str) -> str:
        return resolution_key(s, case_sensitive)

    if isinstance(logical, ScanNode):
        rel = logical.relation
        cols = None
        if required is not None:
            wanted = {key(r) for r in required}
            cols = [n for n in rel.schema.names if key(n) in wanted] or rel.schema.names[:1]
        if rel.bucket_spec is not None:
            return BucketedIndexScanExec(rel, cols)
        return ScanExec(rel, cols)

    if isinstance(logical, FilterNode):
        child_required = None
        if required is not None:
            child_required = list(dict.fromkeys(list(required) + sorted(logical.condition.references())))
        return FilterExec(logical.condition, plan_physical(logical.child, child_required, case_sensitive))

    if isinstance(logical, ProjectNode):
        return ProjectExec(
            logical.column_names,
            plan_physical(logical.child, list(logical.column_names), case_sensitive),
        )

    if isinstance(logical, JoinNode):
        pairs = extract_equi_join_keys(logical.condition)
        if pairs is None:
            raise HyperspaceException(f"Only equi-joins are supported: {logical.condition!r}")
        lschema, rschema = logical.left.output_schema, logical.right.output_schema
        lkeys, rkeys = _orient_join_keys(pairs, lschema, rschema)
        lreq = rreq = None
        if required is not None:
            req = {key(r) for r in required}
            lreq = list(dict.fromkeys([n for n in lschema.names if key(n) in req] + lkeys))
            rreq = list(dict.fromkeys([n for n in rschema.names if key(n) in req] + rkeys))
        lphys = plan_physical(logical.left, lreq, case_sensitive)
        rphys = plan_physical(logical.right, rreq, case_sensitive)
        if _bucketed(lphys) and _bucketed(rphys):
            keys = _bucketed_join_keys(lphys, rphys, lkeys, rkeys, key)
            if keys is not None:
                return SortMergeJoinExec(lphys, rphys, keys[0], keys[1])
        raise not_in_slice("the join without a compatible pair of covering indexes")

    raise not_in_slice(f"the {type(logical).__name__} operator")

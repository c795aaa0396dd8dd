"""Logical plan IR (counterpart of `hyperspace_tpu/engine/logical.py`).

The node set of the slice: relation scans, filters, projections, equi-joins
of every type (inner, left, right and full outer, left semi and left anti),
computed columns, grouped aggregates, ORDER BY, LIMIT, the row union (of
`DataFrame.union` and of Hybrid Scan's filter rewrite), the DISTINCT set
operations INTERSECT and EXCEPT, and the star join `JoinIndexRule` wraps
around a cascade of inner joins. Class names are the JAX package's: the plan
signature and the serialized plan fold over them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..exceptions import HyperspaceException
from ..storage.filesystem import FileStatus
from .expr import BinaryOp, Col, Expr, IsIn, IsNull, Lit, Not, Udf
from .schema import Field, Schema, dtype_from_numpy


@dataclass(frozen=True)
class BucketSpec:
    """Bucketing contract of written data: hash-partitioned into `num_buckets`
    by `bucket_columns`, sorted within each bucket by `sort_columns`."""

    num_buckets: int
    bucket_columns: tuple
    sort_columns: tuple


@dataclass
class SourceRelation:
    """A file-backed source: root paths + resolved file inventory + schema +
    format. An index scan substituted by a rewrite carries its bucket spec,
    index name and log entry id; under Hybrid Scan the join rule's also
    carries the source files appended since the index was built
    (`hybrid_append`), merged into its buckets at execution time."""

    root_paths: List[str]
    file_format: str
    schema: Schema
    files: List[FileStatus] = field(default_factory=list)
    options: Dict[str, str] = field(default_factory=dict)
    bucket_spec: Optional[BucketSpec] = None
    index_name: Optional[str] = None
    log_entry_id: Optional[int] = field(default=None, compare=False)
    hybrid_append: Optional["HybridAppend"] = None
    # Names of the rules that pruned this scan's file list (bucket pruning).
    pruned_by: List[str] = field(default_factory=list)
    # Hive partitioning (`engine/partitioning.PartitionSpec`), None when the
    # source has no `key=value` layout.
    partition_spec: Optional[object] = None

    def __repr__(self):
        tag = f" index={self.index_name}" if self.index_name else ""
        if self.hybrid_append is not None:
            tag += f" (+{len(self.hybrid_append.files)} appended)"
        if self.pruned_by:
            tag += f" (files pruned by {','.join(self.pruned_by)})"
        return f"Relation[{self.file_format}]({','.join(self.root_paths)}{tag})"


@dataclass
class HybridAppend:
    """Source files appended after the index was built and how to read them
    (`logical.HybridAppend` :61): their format, schema and partition layout
    are the source's, not the index's."""

    files: List[FileStatus]
    file_format: str
    schema: Schema
    root_paths: List[str] = field(default_factory=list)
    partition_spec: Optional[object] = None


class LogicalPlan:
    def children(self) -> Sequence["LogicalPlan"]:
        return ()

    @property
    def output_schema(self) -> Schema:
        raise NotImplementedError

    def transform_up(self, fn) -> "LogicalPlan":
        """Bottom-up plan rewrite (Catalyst `transformUp` analogue)."""
        new_children = [c.transform_up(fn) for c in self.children()]
        node = self.with_children(new_children) if new_children else self
        return fn(node)

    def with_children(self, children: Sequence["LogicalPlan"]) -> "LogicalPlan":
        raise NotImplementedError

    def simple_string(self) -> str:
        return type(self).__name__

    def tree_string(self, indent: int = 0) -> str:
        lines = ["  " * indent + ("+- " if indent else "") + self.simple_string()]
        for c in self.children():
            lines.append(c.tree_string(indent + 1))
        return "\n".join(lines)

    def collect_nodes(self) -> List["LogicalPlan"]:
        out: List[LogicalPlan] = [self]
        for c in self.children():
            out.extend(c.collect_nodes())
        return out

    def is_linear(self) -> bool:
        kids = self.children()
        if len(kids) > 1:
            return False
        return all(c.is_linear() for c in kids)


def internal_column(name: str) -> bool:
    """The reserved index-internal column names (the lineage column
    `_data_file_name`): hidden from logical schemas, read only when a filter
    names it (the delete prune) and stripped after that filter
    (`logical.internal_column` :124)."""
    from ..config import IndexConstants

    return name.lower() == IndexConstants.DATA_FILE_NAME_COLUMN


class ScanNode(LogicalPlan):
    def __init__(self, relation: SourceRelation):
        self.relation = relation

    @property
    def output_schema(self) -> Schema:
        if self.relation.index_name:
            # An index relation's lineage column is bookkeeping: a rewrite
            # keeps the output schema, so the logical schema hides it.
            fields = [f for f in self.relation.schema.fields if not internal_column(f.name)]
            if len(fields) != len(self.relation.schema.fields):
                return Schema(fields)
        return self.relation.schema

    def with_children(self, children):
        return self

    def simple_string(self):
        return f"Scan {self.relation!r}"


class FilterNode(LogicalPlan):
    def __init__(self, condition: Expr, child: LogicalPlan):
        self.condition = condition
        self.child = child

    def children(self):
        return (self.child,)

    @property
    def output_schema(self) -> Schema:
        return self.child.output_schema

    def with_children(self, children):
        return FilterNode(self.condition, children[0])

    def simple_string(self):
        return f"Filter {self.condition!r}"


class ProjectNode(LogicalPlan):
    def __init__(self, column_names: Sequence[str], child: LogicalPlan):
        self.column_names = list(column_names)
        self.child = child

    def children(self):
        return (self.child,)

    @property
    def output_schema(self) -> Schema:
        return self.child.output_schema.select(self.column_names)

    def with_children(self, children):
        return ProjectNode(self.column_names, children[0])

    def simple_string(self):
        return f"Project [{', '.join(self.column_names)}]"


_NUMERIC_DTYPES = frozenset({"int32", "int64", "float32", "float64", "bool"})


def _check_schema_compatible(op: str, a: Schema, b: Schema) -> None:
    """A multi-child operator's schema contract (`logical._check_schema_compatible`
    :204): names match case-insensitively by position; numeric widths may
    differ (execution promotes), a string against a number fails here."""
    if [n.lower() for n in a.names] != [n.lower() for n in b.names]:
        raise ValueError(f"{op} children schemas differ: {a.names} vs {b.names}")
    for fa, fb in zip(a.fields, b.fields):
        if fa.dtype != fb.dtype and not (fa.dtype in _NUMERIC_DTYPES and fb.dtype in _NUMERIC_DTYPES):
            raise ValueError(f"{op} column {fa.name!r} type mismatch: {fa.dtype} vs {fb.dtype}")


class UnionNode(LogicalPlan):
    """Row union of same-schema children (`logical.UnionNode` :220): the
    Hybrid Scan filter shape, index data ∪ appended source files. Numeric
    widths promote across children, as the concatenation promotes the data."""

    def __init__(self, children: Sequence[LogicalPlan]):
        self._children = list(children)
        first = self._children[0].output_schema
        dtypes = [f.dtype for f in first.fields]
        for c in self._children[1:]:
            sch = c.output_schema
            _check_schema_compatible("Union", first, sch)
            for i, fb in enumerate(sch.fields):
                if dtypes[i] != fb.dtype:
                    dtypes[i] = dtype_from_numpy(np.promote_types(np.dtype(dtypes[i]), np.dtype(fb.dtype)))
        self._schema = Schema([Field(f.name, d) for f, d in zip(first.fields, dtypes)])

    def children(self):
        return tuple(self._children)

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def with_children(self, children):
        return UnionNode(children)

    def simple_string(self):
        return f"Union ({len(self._children)} children)"


class SetOpNode(LogicalPlan):
    """The DISTINCT set operations (`logical.SetOpNode` :264): output rows are
    deduplicated and nulls equal each other. The schema contract is
    `UnionNode`'s, so a string against a number fails here."""

    op = ""

    def __init__(self, left: LogicalPlan, right: LogicalPlan):
        self.left = left
        self.right = right
        _check_schema_compatible(self.op, left.output_schema, right.output_schema)

    def children(self):
        return (self.left, self.right)

    @property
    def output_schema(self) -> Schema:
        return self.left.output_schema

    def with_children(self, children):
        return type(self)(children[0], children[1])

    def simple_string(self):
        return self.op


class IntersectNode(SetOpNode):
    """The distinct rows present in both children."""

    op = "Intersect"


class ExceptNode(SetOpNode):
    """The distinct rows of the left child absent from the right."""

    op = "Except"


_JOIN_TYPES = {
    "inner": "inner",
    "cross": "inner",
    "left": "left",
    "leftouter": "left",
    "left_outer": "left",
    "right": "right",
    "rightouter": "right",
    "right_outer": "right",
    "full": "full",
    "outer": "full",
    "fullouter": "full",
    "full_outer": "full",
    "semi": "left_semi",
    "leftsemi": "left_semi",
    "left_semi": "left_semi",
    "anti": "left_anti",
    "leftanti": "left_anti",
    "left_anti": "left_anti",
}


def normalize_join_type(how: str) -> str:
    """Spark's join-type spellings → the canonical {inner, left, right, full,
    left_semi, left_anti} (`logical.normalize_join_type` :327)."""
    key = how.strip().lower().replace(" ", "")
    if key not in _JOIN_TYPES:
        raise HyperspaceException(f"Unsupported join type: {how}")
    return _JOIN_TYPES[key]


class JoinNode(LogicalPlan):
    def __init__(self, left: LogicalPlan, right: LogicalPlan, condition: Expr, how: str = "inner"):
        self.left = left
        self.right = right
        self.condition = condition
        self.how = normalize_join_type(how)

    def children(self):
        return (self.left, self.right)

    @property
    def output_schema(self) -> Schema:
        if self.how in ("left_semi", "left_anti"):
            return self.left.output_schema
        return Schema(list(self.left.output_schema.fields) + list(self.right.output_schema.fields))

    def with_children(self, children):
        return JoinNode(children[0], children[1], self.condition, self.how)

    def simple_string(self):
        return f"Join {self.how} on {self.condition!r}"


@dataclass
class StarDimension:
    """One dimension of a recognized star join (`logical.StarDimension`
    :364): its covering-index subplan (`plan`, an index scan, under the
    lineage prune filter when the index has deleted files, built as the
    binary rewrite builds it), the fact→dimension key mapping and the columns
    the query needs of the dimension. `plan` is not a child of the
    `StarJoinNode`: later rules leave it alone, and the cascade never runs
    it."""

    plan: "LogicalPlan"
    fact_keys: List[str]
    dim_keys: List[str]
    dim_required: List[str]
    index_name: Optional[str]
    num_buckets: int


class StarJoinNode(LogicalPlan):
    """An N-way star join (one fact, two or more dimensions, inner
    equi-joins on fact keys) that `JoinIndexRule` recognized over a left-deep
    cascade of binary joins (`logical.StarJoinNode` :383). `cascade`, the
    untouched cascaded plan, is the only child, so later rules rewrite it as
    they would without the wrapper, and it is what every consumer but the
    streamed star aggregate executes. `dims` lists the dimensions innermost
    join first (the cascade's fold order)."""

    def __init__(self, cascade: LogicalPlan, dims: Sequence[StarDimension], fact_required: Sequence[str]):
        self.cascade = cascade
        self.dims = list(dims)
        self.fact_required = list(fact_required)

    def children(self):
        return (self.cascade,)

    @property
    def output_schema(self) -> Schema:
        return self.cascade.output_schema

    def with_children(self, children):
        return StarJoinNode(children[0], self.dims, self.fact_required)

    def simple_string(self):
        names = ", ".join(d.index_name or "?" for d in self.dims)
        return f"StarJoin ({len(self.dims)} dims: {names})"


def infer_expr_dtype(e: Expr, schema: Schema) -> str:
    """Static result type of an expression against a schema
    (`logical.infer_expr_dtype` :418): comparisons, boolean operators and
    null tests are bool; `/` is float64 (float32 when both sides are);
    `+ - *` promote as numpy does; columns and literals keep their own."""
    if isinstance(e, Col):
        return schema.field(e.name).dtype
    if isinstance(e, Lit):
        v = e.value
        if isinstance(v, bool):
            return "bool"
        if isinstance(v, int):
            return "int64"
        if isinstance(v, float):
            return "float64"
        if isinstance(v, str):
            return "string"
        raise HyperspaceException(f"Cannot type literal: {v!r}")
    if isinstance(e, (Not, IsNull, IsIn)):
        return "bool"
    if isinstance(e, Udf):
        return e.dtype  # declared by udf(fn, dtype)
    if isinstance(e, BinaryOp):
        if e.op in BinaryOp.COMPARISONS or e.op in BinaryOp.BOOLEAN:
            return "bool"
        lt = infer_expr_dtype(e.left, schema)
        rt = infer_expr_dtype(e.right, schema)
        if "string" in (lt, rt) or "bool" in (lt, rt):
            raise HyperspaceException(f"Arithmetic on {lt}/{rt}: {e!r}")
        if e.op == "/":
            return "float32" if lt == rt == "float32" else "float64"
        return str(np.result_type(np.dtype(lt), np.dtype(rt)))
    raise HyperspaceException(f"Cannot type expression: {e!r}")


class WithColumnNode(LogicalPlan):
    """A computed column (`logical.WithColumnNode` :460): `name` = `expr`
    per row, replacing a same-named column in place, else appended."""

    def __init__(self, name: str, expr: Expr, child: LogicalPlan):
        self.name = name
        self.expr = expr
        self.child = child
        dtype = infer_expr_dtype(expr, child.output_schema)
        fields = []
        replaced = False
        for f in child.output_schema.fields:
            if f.name.lower() == name.lower():
                fields.append(Field(f.name, dtype))
                replaced = True
            else:
                fields.append(f)
        if not replaced:
            fields.append(Field(name, dtype))
        self._schema = Schema(fields)

    def children(self):
        return (self.child,)

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def with_children(self, children):
        return WithColumnNode(self.name, self.expr, children[0])

    def references(self) -> List[str]:
        return sorted(self.expr.references())

    def simple_string(self):
        return f"WithColumn {self.name} = {self.expr!r}"


class AggregateNode(LogicalPlan):
    """GROUP BY and aggregates (`logical.AggregateNode` :500). `aggs` =
    [(out_name, fn, column | None)]; column None is count(*)."""

    def __init__(self, group_keys: Sequence[str], aggs: Sequence[tuple], child: LogicalPlan):
        from ..ops.aggregate import result_dtype  # validates names and types

        self.group_keys = list(group_keys)
        self.aggs = [tuple(a) for a in aggs]
        self.child = child
        schema = child.output_schema
        fields = [schema.field(k) for k in self.group_keys]
        seen = {f.name.lower() for f in fields}
        for out_name, fn, col in self.aggs:
            if out_name.lower() in seen:
                raise HyperspaceException(f"Duplicate aggregate output name: {out_name!r}")
            seen.add(out_name.lower())
            in_dtype = schema.field(col).dtype if col is not None else None
            fields.append(Field(out_name, result_dtype(fn, in_dtype)))
        self._schema = Schema(fields)

    def children(self):
        return (self.child,)

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def with_children(self, children):
        return AggregateNode(self.group_keys, self.aggs, children[0])

    def references(self) -> List[str]:
        return self.group_keys + [c for _, _, c in self.aggs if c is not None]

    def simple_string(self):
        aggs = ", ".join(f"{o}={fn}({c if c is not None else '*'})" for o, fn, c in self.aggs)
        return f"Aggregate [{', '.join(self.group_keys)}] [{aggs}]"


class OrderByNode(LogicalPlan):
    """ORDER BY (`logical.OrderByNode` :549): `keys` = [(column, ascending)].
    Nulls order as Spark's default: first ascending, last descending."""

    def __init__(self, keys: Sequence[tuple], child: LogicalPlan):
        self.keys = [(k, bool(asc)) for k, asc in keys]
        self.child = child
        for k, _ in self.keys:
            child.output_schema.field(k)  # resolve or raise

    def children(self):
        return (self.child,)

    @property
    def output_schema(self) -> Schema:
        return self.child.output_schema

    def with_children(self, children):
        return OrderByNode(self.keys, children[0])

    def references(self) -> List[str]:
        return [k for k, _ in self.keys]

    def simple_string(self):
        keys = ", ".join(f"{k} {'ASC' if a else 'DESC'}" for k, a in self.keys)
        return f"OrderBy [{keys}]"


class LimitNode(LogicalPlan):
    """LIMIT n (`logical.LimitNode` :577): the child's first n rows."""

    def __init__(self, n: int, child: LogicalPlan):
        if n < 0:
            raise ValueError(f"limit must be non-negative: {n}")
        self.n = int(n)
        self.child = child

    def children(self):
        return (self.child,)

    @property
    def output_schema(self) -> Schema:
        return self.child.output_schema

    def with_children(self, children):
        return LimitNode(self.n, children[0])

    def simple_string(self):
        return f"Limit {self.n}"


def push_filters_below_computed(plan: LogicalPlan) -> LogicalPlan:
    """`Filter > WithColumn` becomes `WithColumn > Filter` when the predicate
    does not name the computed column (`logical.push_filters_below_computed`
    :598), so that `.with_column(...).filter(...)` still meets the rules'
    `Filter > Scan` pattern. The sink passes through stacks of computed
    columns and of filters between them in one pass; a filter moves only when
    such a computed column sits beneath it, so plain filter stacks keep their
    order."""

    def sinkable(refs, child: LogicalPlan) -> bool:
        while isinstance(child, FilterNode):
            child = child.child
        return isinstance(child, WithColumnNode) and child.name.lower() not in refs

    def sink(cond: Expr, refs, child: LogicalPlan) -> LogicalPlan:
        if isinstance(child, WithColumnNode) and child.name.lower() not in refs:
            return WithColumnNode(child.name, child.expr, sink(cond, refs, child.child))
        if isinstance(child, FilterNode) and sinkable(refs, child.child):
            return FilterNode(child.condition, sink(cond, refs, child.child))
        return FilterNode(cond, child)

    def swap(node: LogicalPlan) -> LogicalPlan:
        if isinstance(node, FilterNode):
            refs = {r.lower() for r in node.condition.references()}
            if sinkable(refs, node.child):
                return sink(node.condition, refs, node.child)
        return node

    return plan.transform_up(swap)


def find_single_relation(plan: LogicalPlan) -> Optional[ScanNode]:
    """The single ScanNode of a linear plan (reference `RuleUtils.getLogicalRelation`)."""
    if not plan.is_linear():
        return None
    scans = [n for n in plan.collect_nodes() if isinstance(n, ScanNode)]
    return scans[0] if len(scans) == 1 else None

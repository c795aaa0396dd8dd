"""Logical plan IR (counterpart of `hyperspace_tpu/engine/logical.py`).

The node set of the slice: relation scans, projections and inner equi-joins.
Class names are the JAX package's: the plan signature folds over them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from ..exceptions import not_in_slice
from ..storage.filesystem import FileStatus
from .expr import Expr
from .schema import Schema


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
    index name and log entry id."""

    root_paths: List[str]
    file_format: str
    schema: Schema
    files: List[FileStatus] = field(default_factory=list)
    options: Dict[str, str] = field(default_factory=dict)
    bucket_spec: Optional[BucketSpec] = None
    index_name: Optional[str] = None
    log_entry_id: Optional[int] = field(default=None, compare=False)

    def __repr__(self):
        tag = f" index={self.index_name}" if self.index_name else ""
        return f"Relation[{self.file_format}]({','.join(self.root_paths)}{tag})"


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


class ScanNode(LogicalPlan):
    def __init__(self, relation: SourceRelation):
        self.relation = relation

    @property
    def output_schema(self) -> Schema:
        return self.relation.schema

    def with_children(self, children):
        return self

    def simple_string(self):
        return f"Scan {self.relation!r}"


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


class JoinNode(LogicalPlan):
    def __init__(self, left: LogicalPlan, right: LogicalPlan, condition: Expr, how: str = "inner"):
        if how.strip().lower() not in ("inner", "cross"):
            raise not_in_slice(f"{how} joins")
        self.left = left
        self.right = right
        self.condition = condition
        self.how = "inner"

    def children(self):
        return (self.left, self.right)

    @property
    def output_schema(self) -> Schema:
        return Schema(list(self.left.output_schema.fields) + list(self.right.output_schema.fields))

    def with_children(self, children):
        return JoinNode(children[0], children[1], self.condition, self.how)

    def simple_string(self):
        return f"Join {self.how} on {self.condition!r}"


def find_single_relation(plan: LogicalPlan) -> Optional[ScanNode]:
    """The single ScanNode of a linear plan (reference `RuleUtils.getLogicalRelation`)."""
    if not plan.is_linear():
        return None
    scans = [n for n in plan.collect_nodes() if isinstance(n, ScanNode)]
    return scans[0] if len(scans) == 1 else None

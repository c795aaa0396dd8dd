"""Logical plan serialization (counterpart of `hyperspace_tpu/serde/plan_serde.py`).

A plan becomes versioned JSON, base64-encoded (the `rawPlan` format of the
reference's `LogicalPlanSerDeUtils`). The format is the JAX package's, tag
for tag and key for key, so each package deserializes the other's plans. A
UDF travels as its function's module and qualified name and is imported
again on the way back; a lambda or a local function cannot make the trip
and fails loudly there.
"""

from __future__ import annotations

import base64
import importlib
import json
from typing import Any, Dict

from ..engine.expr import BinaryOp, Col, Expr, IsIn, IsNull, Lit, Not, Udf
from ..engine.logical import (
    AggregateNode,
    BucketSpec,
    ExceptNode,
    FilterNode,
    IntersectNode,
    JoinNode,
    LimitNode,
    LogicalPlan,
    OrderByNode,
    ProjectNode,
    ScanNode,
    SourceRelation,
    UnionNode,
    WithColumnNode,
)
from ..engine.partitioning import PartitionSpec
from ..engine.schema import Schema
from ..exceptions import HyperspaceException
from ..storage.filesystem import FileStatus

_VERSION = "1"


def expr_to_dict(e: Expr) -> Dict[str, Any]:
    if isinstance(e, Col):
        return {"t": "col", "name": e.name}
    if isinstance(e, Lit):
        v = e.value
        return {"t": "lit", "value": v.item() if hasattr(v, "item") else v}
    if isinstance(e, BinaryOp):
        return {"t": "bin", "op": e.op, "left": expr_to_dict(e.left), "right": expr_to_dict(e.right)}
    if isinstance(e, Not):
        return {"t": "not", "child": expr_to_dict(e.child)}
    if isinstance(e, IsIn):
        return {"t": "isin", "child": expr_to_dict(e.child), "values": list(e.values)}
    if isinstance(e, IsNull):
        return {"t": "isnull", "child": expr_to_dict(e.child), "negated": e.negated}
    if isinstance(e, Udf):
        return {
            "t": "udf",
            "name": e.name,
            "dtype": e.dtype,
            "module": getattr(e.fn, "__module__", None),
            "qualname": getattr(e.fn, "__qualname__", None),
            "args": [expr_to_dict(a) for a in e.args],
        }
    raise HyperspaceException(f"Cannot serialize expression: {e!r}")


def _import_udf(d: Dict[str, Any]):
    module, qualname = d.get("module"), d.get("qualname")
    if not (module and qualname) or "<" in qualname:
        raise HyperspaceException(
            f"Cannot deserialize UDF {d.get('name')!r}: lambdas and local "
            "functions cannot round-trip; define the UDF at module scope"
        )
    try:
        obj = importlib.import_module(module)
        for part in qualname.split("."):
            obj = getattr(obj, part)
    except Exception as e:  # an import-time bug must show as itself
        raise HyperspaceException(
            f"Cannot deserialize UDF {d.get('name')!r}: importing "
            f"{module}.{qualname} failed: {type(e).__name__}: {e}"
        ) from e
    return obj


def expr_from_dict(d: Dict[str, Any]) -> Expr:
    t = d["t"]
    if t == "col":
        return Col(d["name"])
    if t == "lit":
        return Lit(d["value"])
    if t == "bin":
        return BinaryOp(d["op"], expr_from_dict(d["left"]), expr_from_dict(d["right"]))
    if t == "not":
        return Not(expr_from_dict(d["child"]))
    if t == "isin":
        return IsIn(expr_from_dict(d["child"]), d["values"])
    if t == "isnull":
        return IsNull(expr_from_dict(d["child"]), d.get("negated", False))
    if t == "udf":
        return Udf(_import_udf(d), d["dtype"], [expr_from_dict(a) for a in d["args"]], d.get("name"))
    raise HyperspaceException(f"Cannot deserialize expression tag: {t}")


def _relation_to_dict(rel: SourceRelation) -> Dict[str, Any]:
    spec = rel.bucket_spec
    return {
        "rootPaths": rel.root_paths,
        "fileFormat": rel.file_format,
        "schema": rel.schema.to_json_string(),
        "options": rel.options,
        "files": [{"path": f.path, "size": f.size, "mtime": f.modified_time} for f in rel.files],
        "bucketSpec": None if spec is None else {
            "numBuckets": spec.num_buckets,
            "bucketColumns": list(spec.bucket_columns),
            "sortColumns": list(spec.sort_columns),
        },
        "indexName": rel.index_name,
        "partitionSpec": None if rel.partition_spec is None else rel.partition_spec.to_json(),
    }


def _relation_from_dict(d: Dict[str, Any]) -> SourceRelation:
    spec = d.get("bucketSpec")
    return SourceRelation(
        root_paths=d["rootPaths"],
        file_format=d["fileFormat"],
        schema=Schema.from_json_string(d["schema"]),
        files=[FileStatus(f["path"], f["size"], f["mtime"], False) for f in d.get("files", [])],
        options=d.get("options", {}),
        bucket_spec=None if spec is None else BucketSpec(
            spec["numBuckets"], tuple(spec["bucketColumns"]), tuple(spec["sortColumns"])
        ),
        index_name=d.get("indexName"),
        partition_spec=PartitionSpec.from_json(d.get("partitionSpec")),
    )


def plan_to_dict(plan: LogicalPlan) -> Dict[str, Any]:
    if isinstance(plan, ScanNode):
        return {"t": "scan", "relation": _relation_to_dict(plan.relation)}
    if isinstance(plan, FilterNode):
        return {"t": "filter", "condition": expr_to_dict(plan.condition), "child": plan_to_dict(plan.child)}
    if isinstance(plan, ProjectNode):
        return {"t": "project", "columns": plan.column_names, "child": plan_to_dict(plan.child)}
    if isinstance(plan, JoinNode):
        return {
            "t": "join",
            "how": plan.how,
            "condition": expr_to_dict(plan.condition),
            "left": plan_to_dict(plan.left),
            "right": plan_to_dict(plan.right),
        }
    if isinstance(plan, AggregateNode):
        return {
            "t": "aggregate",
            "groupKeys": list(plan.group_keys),
            "aggs": [[o, fn, c] for o, fn, c in plan.aggs],
            "child": plan_to_dict(plan.child),
        }
    if isinstance(plan, OrderByNode):
        return {"t": "orderby", "keys": [[k, asc] for k, asc in plan.keys], "child": plan_to_dict(plan.child)}
    if isinstance(plan, LimitNode):
        return {"t": "limit", "n": plan.n, "child": plan_to_dict(plan.child)}
    if isinstance(plan, WithColumnNode):
        return {"t": "withcolumn", "name": plan.name, "expr": expr_to_dict(plan.expr), "child": plan_to_dict(plan.child)}
    if isinstance(plan, UnionNode):
        return {"t": "union", "children": [plan_to_dict(c) for c in plan.children()]}
    if isinstance(plan, (IntersectNode, ExceptNode)):
        return {
            "t": "intersect" if isinstance(plan, IntersectNode) else "except",
            "left": plan_to_dict(plan.left),
            "right": plan_to_dict(plan.right),
        }
    raise HyperspaceException(f"Cannot serialize plan node: {plan.simple_string()}")


def plan_from_dict(d: Dict[str, Any]) -> LogicalPlan:
    t = d["t"]
    if t == "scan":
        return ScanNode(_relation_from_dict(d["relation"]))
    if t == "filter":
        return FilterNode(expr_from_dict(d["condition"]), plan_from_dict(d["child"]))
    if t == "project":
        return ProjectNode(d["columns"], plan_from_dict(d["child"]))
    if t == "join":
        return JoinNode(plan_from_dict(d["left"]), plan_from_dict(d["right"]), expr_from_dict(d["condition"]), d["how"])
    if t == "aggregate":
        return AggregateNode(d["groupKeys"], [(o, fn, c) for o, fn, c in d["aggs"]], plan_from_dict(d["child"]))
    if t == "orderby":
        return OrderByNode([(k, asc) for k, asc in d["keys"]], plan_from_dict(d["child"]))
    if t == "limit":
        return LimitNode(d["n"], plan_from_dict(d["child"]))
    if t == "withcolumn":
        return WithColumnNode(d["name"], expr_from_dict(d["expr"]), plan_from_dict(d["child"]))
    if t == "union":
        return UnionNode([plan_from_dict(c) for c in d["children"]])
    if t == "intersect":
        return IntersectNode(plan_from_dict(d["left"]), plan_from_dict(d["right"]))
    if t == "except":
        return ExceptNode(plan_from_dict(d["left"]), plan_from_dict(d["right"]))
    raise HyperspaceException(f"Cannot deserialize plan tag: {t}")


def serialize_plan(plan: LogicalPlan) -> str:
    """A plan as a base64 JSON string (base64 keeps a log entry's JSON clean,
    as the reference's base64 Kryo bytes do)."""
    payload = json.dumps({"version": _VERSION, "plan": plan_to_dict(plan)})
    return base64.b64encode(payload.encode("utf-8")).decode("ascii")


def deserialize_plan(s: str) -> LogicalPlan:
    payload = json.loads(base64.b64decode(s.encode("ascii")).decode("utf-8"))
    if payload.get("version") != _VERSION:
        raise HyperspaceException(f"Unsupported serialized plan version: {payload.get('version')!r}")
    return plan_from_dict(payload["plan"])

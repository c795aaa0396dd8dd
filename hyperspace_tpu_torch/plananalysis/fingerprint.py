"""Stable plan fingerprints: the identity of a query's execution class
(counterpart of `hyperspace_tpu/plananalysis/fingerprint.py`).

`plan_fingerprint(node)` hashes a canonical JSON of the physical tree's node
signatures and the ambient flag posture, 16 hex characters of a sha256:

- stable across processes and re-created lakes (a root path is its
  basename);
- class-shaped: literal values are abstracted to their type names, the
  predicate structure kept;
- sensitive to the index generation (the relation's log entry id) and to
  the behavior flags set (`FLAG_KEYS`, telemetry sinks excluded).

The signatures are the JAX package's, node for node, so the same query over
the same lake under the same flags gets the same fingerprint in both
packages.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

from ..telemetry import accounting as _accounting
from ..telemetry import tracing as _tracing

FLAG_KEYS = (
    "HYPERSPACE_BUILD_DECODE_THREADS",
    "HYPERSPACE_DISTRIBUTED",
    "HYPERSPACE_ENCODED_DICT_MAX",
    "HYPERSPACE_ENCODED_EXEC",
    "HYPERSPACE_FORCE_DEVICE_OPS",
    "HYPERSPACE_HASH_QUANTIZE",
    "HYPERSPACE_INDEX_ROW_GROUP_ROWS",
    "HYPERSPACE_JOIN_CHUNK_ROWS",
    "HYPERSPACE_JOIN_OUTLIER_FACTOR",
    "HYPERSPACE_JOIN_SIZE_CLASSES",
    "HYPERSPACE_MESH_ROW_QUANTUM",
    "HYPERSPACE_MULTIWAY",
    "HYPERSPACE_PALLAS_PROBE",
    "HYPERSPACE_PALLAS_SORT",
    "HYPERSPACE_PLANNER",
    "HYPERSPACE_PRED_FUSE_MAX_CLASSES",
    "HYPERSPACE_PRED_FUSE_MIN_ROWS",
    "HYPERSPACE_QUERY_CHUNK_ROWS",
    "HYPERSPACE_QUERY_PREFETCH_FILES",
    "HYPERSPACE_QUERY_STREAMING",
    "HYPERSPACE_SCAN_PUSHDOWN",
    "HYPERSPACE_SERVING",
)


def flag_posture() -> dict:
    """The behavior flags that are set, by name."""
    return {k: os.environ[k] for k in FLAG_KEYS if k in os.environ}


def expr_signature(e) -> list:
    """An expression's structure: columns and operators as they are,
    literal values as their type names; another type as its class name over
    its children's signatures."""
    from ..engine import expr as _expr

    if e is None:
        return ["none"]
    if isinstance(e, _expr.Col):
        return ["col", e.name]
    if isinstance(e, _expr.Lit):
        return ["lit", type(e.value).__name__]
    if isinstance(e, _expr.BinaryOp):
        return [e.op, expr_signature(e.left), expr_signature(e.right)]
    if isinstance(e, _expr.IsNull):
        return ["isnotnull" if e.negated else "isnull", expr_signature(e.child)]
    if isinstance(e, _expr.Not):
        return ["not", expr_signature(e.child)]
    if isinstance(e, _expr.IsIn):
        return ["in", expr_signature(e.child), sorted({type(v).__name__ for v in e.values})]
    out = [type(e).__name__.lower()]
    try:
        out.extend(expr_signature(c) for c in e.children())
    except Exception:
        pass
    return out


def _relation_signature(rel) -> list:
    """Root basenames, format, the index's name and log entry id, the bucket
    layout, the appended files' count and the pruning rules."""
    roots = sorted(os.path.basename(p.rstrip("/\\")) or p for p in (rel.root_paths or []))
    out = ["rel", roots, rel.file_format, rel.index_name, getattr(rel, "log_entry_id", None)]
    if rel.bucket_spec is not None:
        spec = rel.bucket_spec
        out.append(["buckets", spec.num_buckets, list(spec.bucket_columns), list(spec.sort_columns)])
    if rel.hybrid_append is not None:
        out.append(["hybrid", len(rel.hybrid_append.files)])
    if rel.pruned_by:
        out.append(["pruned_by", sorted(rel.pruned_by)])
    return out


def node_signature(node) -> list:
    """One physical operator's signature, its children's inside."""
    from ..engine import physical as _phys

    sig: list = [type(node).__name__]
    if isinstance(node, (_phys.ScanExec, _phys.BucketedIndexScanExec)):
        sig.append(_relation_signature(node.relation))
        if getattr(node, "columns", None):
            sig.append(["cols", sorted(node.columns)])
        if getattr(node, "pushdown", None) is not None:
            sig.append(["pushdown", expr_signature(node.pushdown)])
    elif isinstance(node, _phys.FilterExec):
        sig.append(expr_signature(node.condition))
    elif isinstance(node, _phys.ProjectExec):
        sig.append(list(node.column_names))
    elif isinstance(node, _phys.WithColumnExec):
        sig.append([node.col_name, expr_signature(node.expr)])
    elif isinstance(node, _phys.HashAggregateExec):
        sig.append(["keys", list(node.group_keys)])
        sig.append(["aggs", [list(a) for a in node.aggs]])
    elif isinstance(node, _phys.SortMergeJoinExec):
        sig.append([node.how, bool(node.bucketed), list(node.left_keys), list(node.right_keys)])
    elif isinstance(node, _phys.MultiwayJoinExec):
        sig.append(["star", [[list(fk), list(dk), name, int(nb)] for _exec, fk, dk, name, nb in node.dims]])
    elif isinstance(node, (_phys.SortExec, _phys.ShuffleExchangeExec)):
        sig.append(list(getattr(node, "keys", ())))
    elif isinstance(node, _phys.OrderByExec):
        sig.append([[k, bool(asc)] for k, asc in node.keys])
    elif isinstance(node, _phys.LimitExec):
        sig.append(node.n)
    elif isinstance(node, _phys.SetOpExec):
        sig.append(node.op)
    children = node.children()
    if children:
        sig.append([node_signature(c) for c in children])
    return sig


def plan_fingerprint(node, posture: Optional[dict] = None) -> str:
    """The 16-hex fingerprint of `node`'s execution class. Never raises."""
    if posture is None:
        posture = flag_posture()
    try:
        payload = json.dumps({"plan": node_signature(node), "flags": posture}, sort_keys=True,
                             separators=(",", ":"), default=str)
    except Exception:
        payload = f"{type(node).__name__}:{posture}"
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def fingerprint_wanted() -> bool:
    """Whether a fingerprint reaches a consumer: an open ledger or a span
    sink. The workload history store, the JAX package's third consumer, is
    not ported (ROADMAP Queue 1 item 6). Off: one contextvar read and the
    sink check."""
    if _accounting.current_ledger() is not None:
        return True
    return _tracing.active()

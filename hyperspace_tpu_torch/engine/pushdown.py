"""Predicate pushdown: conjunct normalization and the zone-map evaluator.

Counterpart of `hyperspace_tpu/engine/pushdown.py`. One home for the decision
"can a value zone [min, max] (plus its null count) hold a row that satisfies
`col op literal`?", read by the scan layer's row-group pruning
(`engine.io.read_files` evaluates a `ScanPredicate` against parquet footer
zone maps and decodes only the row groups that qualify) and by the filtered
bucketed index scan (`FilterExec.execute_concat` pruning inside
`part-<bucket>` files).

Soundness: a zone is pruned only when NO row in it can satisfy the conjunct
under `engine.evaluate`'s semantics. A comparison with null is unknown and
WHERE drops unknowns, so an all-null zone satisfies no comparison; float
zones are never pruned on `!=` (a NaN row satisfies `x != lit`, and parquet
min/max statistics leave NaN out); a missing min/max or a type mismatch keeps
the zone. Pruned rows are exactly rows the filter above would have dropped,
so results are identical with pruning on and off
(`HYPERSPACE_SCAN_PUSHDOWN=0`). The JAX package asks its planner when the
flag is unset; the planner is not ported, so unset means on.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..config import ENV_SCAN_PUSHDOWN
from .expr import BinaryOp, Col, Expr, IsIn, IsNull, Lit, split_conjuncts


def pushdown_enabled() -> bool:
    """Default on; `HYPERSPACE_SCAN_PUSHDOWN=0` turns every row-group pruning
    decision off (whole files decode as before the pushdown). Unset, the
    planner's decision rules when it made one."""
    raw = os.environ.get(ENV_SCAN_PUSHDOWN, "")
    if raw != "":
        return raw != "0"
    from ..plananalysis.planner import decided_value

    decided = decided_value("pushdown")
    return True if decided is None else bool(decided)


_FLIPPED = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "==": "==", "!=": "!="}


def normalize_conjunct(e: Expr) -> Optional[tuple]:
    """(op, column_name, literal(s)) for the zone-prunable conjunct shapes:
    `(cmp, col, value)` for `col <cmp> lit` in either orientation,
    `("in", col, [values])` and `("isnull" | "isnotnull", col, None)`.
    None for anything else (arithmetic, `or`, column against column)."""
    if isinstance(e, IsIn) and isinstance(e.child, Col):
        return ("in", e.child.name, e.values)
    if isinstance(e, IsNull) and isinstance(e.child, Col):
        return ("isnotnull" if e.negated else "isnull", e.child.name, None)
    if not isinstance(e, BinaryOp) or e.op not in BinaryOp.COMPARISONS:
        return None
    l, r = e.left, e.right
    if isinstance(l, Col) and isinstance(r, Lit):
        return (e.op, l.name, r.value)
    if isinstance(l, Lit) and isinstance(r, Col):
        return (_FLIPPED[e.op], r.name, l.value)
    return None


def prunable_conjuncts(condition: Expr) -> List[tuple]:
    """The normalized prunable conjuncts of a condition's CNF split."""
    out = []
    for c in split_conjuncts(condition):
        n = normalize_conjunct(c)
        if n is not None:
            out.append(n)
    return out


def _is_floatish(v) -> bool:
    return isinstance(v, (float, np.floating))


def minmax_keeps(op: str, value, mn, mx) -> bool:
    """Can a zone with value range [mn, mx] hold a row satisfying `col op
    value`? Incomparable types and `!=` keep (the NaN-aware `!=` rule lives
    in `zone_keeps`)."""
    try:
        if op == "==":
            return mn <= value <= mx
        if op == "<":
            return mn < value
        if op == "<=":
            return mn <= value
        if op == ">":
            return mx > value
        if op == ">=":
            return mx >= value
    except TypeError:
        return True
    return True


class ZoneStats:
    """One zone's statistics: bounds over the NON-NULL rows (valid only when
    `has_minmax`) and the null count (None = unknown), straight from a parquet
    column chunk's footer statistics."""

    __slots__ = ("mn", "mx", "has_minmax", "null_count")

    def __init__(self, mn=None, mx=None, has_minmax: bool = False, null_count=None):
        self.mn = mn
        self.mx = mx
        self.has_minmax = has_minmax
        self.null_count = null_count


def zone_keeps(op: str, value, st: ZoneStats, zone_rows: int) -> bool:
    """Can a zone of `zone_rows` rows with stats `st` hold a row the conjunct
    keeps? THE pruning decision (module docstring)."""
    if op == "isnull":
        return st.null_count is None or st.null_count > 0
    if op == "isnotnull":
        return st.null_count is None or st.null_count < zone_rows
    # A comparison with null is unknown and WHERE drops unknowns: an all-null
    # zone satisfies no value-matching conjunct.
    if st.null_count is not None and st.null_count >= zone_rows:
        return False
    if not st.has_minmax:
        return True
    try:
        if op == "in":
            return any(minmax_keeps("==", v, st.mn, st.mx) for v in value)
        if op == "!=":
            # Prunable only when every row equals the literal, and never over
            # floats (a NaN row satisfies != but is absent from min/max).
            if _is_floatish(st.mn) or _is_floatish(st.mx) or _is_floatish(value):
                return True
            return not (st.mn == st.mx == value)
        return minmax_keeps(op, value, st.mn, st.mx)
    except TypeError:
        return True


def _resolve_name(name: str, names: Sequence[str], case_sensitive: bool) -> Optional[str]:
    """A conjunct's column spelling against a file's schema names: exact match
    first, then a unique case-insensitive one; None leaves the conjunct out
    for this file."""
    if name in names:
        return name
    if case_sensitive:
        return None
    ci = [n for n in names if n.lower() == name.lower()]
    return ci[0] if len(ci) == 1 else None


class ScanPredicate:
    """A query's conjunctive filter compiled to its zone-prunable conjuncts,
    carried down the scan path by the physical plan. `select_row_groups`
    resolves the conjuncts against each file's footer."""

    __slots__ = ("conjuncts", "case_sensitive")

    def __init__(self, conjuncts: List[tuple], case_sensitive: bool = False):
        self.conjuncts = conjuncts
        self.case_sensitive = case_sensitive

    @staticmethod
    def from_condition(condition: Expr, case_sensitive: bool = False) -> Optional["ScanPredicate"]:
        """None when no conjunct is prunable (the scan then runs exactly as
        without pushdown: no footer reads, no key changes)."""
        cj = prunable_conjuncts(condition)
        return ScanPredicate(cj, case_sensitive) if cj else None

    def select_row_groups(self, meta) -> Optional[Tuple[int, ...]]:
        """The surviving row-group indices of one file (`meta`, an
        `engine.io.FileFooterMeta`). None = every row group survives (the
        caller keeps the whole-file path and its cache keys); a tuple,
        possibly empty, is a real pruning decision."""
        resolved = []
        for op, name, value in self.conjuncts:
            rn = _resolve_name(name, meta.names, self.case_sensitive)
            if rn is not None:
                resolved.append((op, rn, value))
        if not resolved:
            return None
        keep: List[int] = []
        dropped = False
        for i, rg in enumerate(meta.row_groups):
            ok = True
            for op, rn, value in resolved:
                st = rg.stats.get(rn)
                if st is not None and not zone_keeps(op, value, st, rg.num_rows):
                    ok = False
                    break
            if ok:
                keep.append(i)
            else:
                dropped = True
        return tuple(keep) if dropped else None

"""Predicate evaluation on the table's device (counterpart of `hyperspace_tpu/engine/evaluate.py`).

The eager subset of `evaluate` :104 and `evaluate_predicate` :703, as torch
ops on the table's device. String comparisons against a literal translate to
code-space integer compares on the host (one binary search of the sorted
dictionary per literal, `_str_lit_compare` :79); no string reaches the device.

Null semantics (SQL/Spark) ride a validity lane: every result carries an
optional bool tensor of the non-null slots. Comparisons propagate invalidity;
`and`/`or` follow Kleene logic (a known FALSE decides `and`, a known TRUE
decides `or`); `evaluate_predicate` keeps a row only when the value is true AND
known. The JAX package's compiled predicate programs (:449-700) cache XLA
programs and have no counterpart here: torch runs eagerly.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..exceptions import HyperspaceException
from .expr import BinaryOp, Col, Expr, IsIn, IsNull, Lit, Not
from .table import Column, Table, align_dictionaries


class _Val:
    """An evaluation result: a numeric/bool tensor, string codes with their
    dictionary, or a literal, plus the validity lane (None = all valid)."""

    __slots__ = ("kind", "arr", "dictionary", "value", "valid")

    def __init__(self, kind, arr=None, dictionary=None, value=None, valid=None):
        self.kind = kind  # "num" | "str" | "lit"
        self.arr = arr
        self.dictionary = dictionary
        self.value = value
        self.valid = valid


def _and_valid(a: Optional[torch.Tensor], b: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def _str_lit_compare(op: str, codes: torch.Tensor, dictionary: np.ndarray, lit: str) -> torch.Tensor:
    """A string-vs-literal comparison in code space (the sorted dictionary
    makes codes order-preserving)."""
    left_cut = int(np.searchsorted(dictionary, lit, side="left"))
    present = left_cut < len(dictionary) and dictionary[left_cut] == lit
    if op == "==":
        return codes == left_cut if present else torch.zeros(codes.shape, dtype=torch.bool, device=codes.device)
    if op == "!=":
        return codes != left_cut if present else torch.ones(codes.shape, dtype=torch.bool, device=codes.device)
    if op == "<":
        return codes < left_cut
    if op == ">=":
        return codes >= left_cut
    right_cut = int(np.searchsorted(dictionary, lit, side="right"))
    if op == "<=":
        return codes < right_cut
    if op == ">":
        return codes >= right_cut
    raise HyperspaceException(f"Unsupported string comparison: {op}")


def _compare(op: str, a, b) -> torch.Tensor:
    if op == "==":
        return a == b
    if op == "!=":
        return a != b
    if op == "<":
        return a < b
    if op == "<=":
        return a <= b
    if op == ">":
        return a > b
    return a >= b


def _numeric_operand(v: _Val, other: _Val):
    """A comparison operand: the tensor, or the literal as a Python scalar. A
    float literal against an integer column compares in float64, the JAX
    package's promotion (torch would round the column to float32)."""
    if v.kind == "num":
        if other.kind == "lit" and isinstance(other.value, float) and not v.arr.is_floating_point():
            return v.arr.to(torch.float64)
        return v.arr
    return v.value


def _full(table: Table, value: bool) -> torch.Tensor:
    device = next(iter(table.columns.values())).data.device if table.columns else "cpu"
    return torch.full((table.num_rows,), value, dtype=torch.bool, device=device)


def evaluate(expr: Expr, table: Table) -> _Val:
    if isinstance(expr, Col):
        col = table.column(expr.name)
        if col.is_string:
            return _Val("str", col.data, col.dictionary, valid=col.validity)
        return _Val("num", col.data, valid=col.validity)

    if isinstance(expr, Lit):
        return _Val("lit", value=expr.value)

    if isinstance(expr, IsNull):
        v = evaluate(expr.child, table)
        if v.kind == "lit":
            base = _full(table, v.value is None)
        elif v.valid is None:
            base = torch.zeros(v.arr.shape, dtype=torch.bool, device=v.arr.device)
        else:
            base = ~v.valid
        return _Val("num", ~base if expr.negated else base)  # never itself null

    if isinstance(expr, Not):
        v = evaluate(expr.child, table)
        if v.kind != "num":
            raise HyperspaceException("NOT requires a boolean operand")
        return _Val("num", ~v.arr, valid=v.valid)

    if isinstance(expr, IsIn):
        v = evaluate(expr.child, table)
        if v.kind == "lit":
            raise HyperspaceException(f"IN over a literal is not supported: {expr!r}")
        # Kleene: `x IN (v1, NULL)` is TRUE on a match, else UNKNOWN.
        had_null = any(x is None for x in expr.values)
        values = [x for x in expr.values if x is not None]
        arr, test = v.arr, None
        if v.kind == "str":
            wanted = [str(x) for x in values]
            positions = np.searchsorted(v.dictionary, wanted)
            hits = [int(c) for c, x in zip(positions, wanted) if c < len(v.dictionary) and v.dictionary[c] == x]
            test = torch.tensor(hits, dtype=torch.int32, device=arr.device)
        elif values:
            test = torch.from_numpy(np.asarray(values)).to(arr.device)
            common = torch.promote_types(arr.dtype, test.dtype)
            arr, test = arr.to(common), test.to(common)
        if test is None or test.numel() == 0:
            match = torch.zeros(v.arr.shape, dtype=torch.bool, device=v.arr.device)
        else:
            match = torch.isin(arr, test)
        valid = _and_valid(v.valid, match) if had_null else v.valid
        return _Val("num", match, valid=valid)

    if isinstance(expr, BinaryOp):
        l = evaluate(expr.left, table)
        r = evaluate(expr.right, table)
        op = expr.op

        if op in BinaryOp.BOOLEAN:
            if l.kind != "num" or r.kind != "num":
                raise HyperspaceException(f"'{op}' requires boolean operands")
            lv, rv = l.arr, r.arr
            value = (lv & rv) if op == "and" else (lv | rv)
            if l.valid is None and r.valid is None:
                return _Val("num", value)
            lk = l.valid if l.valid is not None else torch.ones_like(lv)
            rk = r.valid if r.valid is not None else torch.ones_like(rv)
            if op == "and":  # known iff both known, or either is a known FALSE
                valid = (lk & rk) | (lk & ~lv) | (rk & ~rv)
            else:  # known iff both known, or either is a known TRUE
                valid = (lk & rk) | (lk & lv) | (rk & rv)
            return _Val("num", value, valid=valid)

        # A null literal compares unknown against everything.
        if (l.kind == "lit" and l.value is None) or (r.kind == "lit" and r.value is None):
            return _Val("num", _full(table, False), valid=_full(table, False))

        valid = _and_valid(l.valid, r.valid)
        if l.kind == "str" or r.kind == "str":
            if l.kind == "str" and r.kind == "lit":
                return _Val("num", _str_lit_compare(op, l.arr, l.dictionary, str(r.value)), valid=valid)
            if r.kind == "str" and l.kind == "lit":
                flipped = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "==": "==", "!=": "!="}
                return _Val("num", _str_lit_compare(flipped[op], r.arr, r.dictionary, str(l.value)), valid=valid)
            if l.kind == "str" and r.kind == "str":
                # Cross-column compare: codes over the union dictionary.
                la, ra = align_dictionaries(
                    Column("string", l.arr, l.dictionary), Column("string", r.arr, r.dictionary)
                )
                return _Val("num", _compare(op, la.data, ra.data), valid=valid)
            raise HyperspaceException("Cannot compare string with non-string")
        if l.kind == "lit" and r.kind == "lit":
            raise HyperspaceException(f"A comparison of two literals is not supported: {expr!r}")
        return _Val("num", _compare(op, _numeric_operand(l, r), _numeric_operand(r, l)), valid=valid)

    raise HyperspaceException(f"Cannot evaluate expression: {expr!r}")


def evaluate_predicate(expr: Expr, table: Table) -> torch.Tensor:
    """A boolean expression over a table -> bool mask on its device. A row
    survives only when the predicate is TRUE and KNOWN (WHERE drops unknowns)."""
    v = evaluate(expr, table)
    if v.kind != "num" or v.arr.dtype != torch.bool:
        raise HyperspaceException(f"Not a boolean predicate: {expr!r}")
    return v.arr if v.valid is None else v.arr & v.valid

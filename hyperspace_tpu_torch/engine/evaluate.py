"""Expression evaluation on the table's device (counterpart of `hyperspace_tpu/engine/evaluate.py`).

The eager `evaluate` :104, `evaluate_column` :281 and `evaluate_predicate`
:703, as torch ops on the table's device. String comparisons against a
literal translate to code-space integer compares on the host (one binary
search of the sorted dictionary per literal, `_str_lit_compare` :79); no
string reaches the device. A user function (`Udf`) is the one expression
evaluated on the host, by its contract (`_evaluate_udf`).

Null semantics (SQL/Spark) ride a validity lane: every result carries an
optional bool tensor of the non-null slots. Comparisons and arithmetic
propagate invalidity, and `x / 0` is null; `and`/`or` follow Kleene logic (a
known FALSE decides `and`, a known TRUE decides `or`); `evaluate_predicate`
keeps a row only when the value is true AND known. Arithmetic takes the JAX
package's types (`_arith_dtype`): a Python literal is weakly typed, so
`int32 + 1` stays int32 and `int64 * 1.5` is float64, and true division of
integers gives float32 for int32 and float64 for int64. Arithmetic of two
literals is a 0-d value that `evaluate_column` broadcasts. The JAX package's
compiled predicate programs (:449-700) cache XLA programs and have no
counterpart here: torch runs eagerly.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..exceptions import HyperspaceException
from .expr import BinaryOp, Col, Expr, IsIn, IsNull, Lit, Not, Udf
from .schema import TORCH_DTYPES
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


def _device_of(table: Table) -> torch.device:
    return next(iter(table.columns.values())).data.device if table.columns else torch.device("cpu")


def _full(table: Table, value: bool) -> torch.Tensor:
    return torch.full((table.num_rows,), value, dtype=torch.bool, device=_device_of(table))


def _literal_dtype(value) -> torch.dtype:
    if isinstance(value, bool):
        return torch.bool
    return torch.float64 if isinstance(value, float) else torch.int64


def _arith_dtype(l: _Val, r: _Val, op: str) -> torch.dtype:
    """The result type of `l op r` under the JAX package's promotion: two
    tensors promote by the lattice; a Python literal is weak (an int keeps
    the tensor's type, a float makes an integer tensor float64); two
    literals are int64 or float64. True division of integers is float32 for
    int32 and float64 otherwise."""
    if l.kind == "num" and r.kind == "num":
        dt = torch.promote_types(l.arr.dtype, r.arr.dtype)
    elif l.kind == "num" or r.kind == "num":
        t, x = (l.arr, r.value) if l.kind == "num" else (r.arr, l.value)
        if isinstance(x, float):
            dt = t.dtype if t.is_floating_point() else torch.float64
        else:
            dt = torch.int64 if t.dtype == torch.bool and not isinstance(x, bool) else t.dtype
    else:
        dt = torch.promote_types(_literal_dtype(l.value), _literal_dtype(r.value))
    if op == "/" and not dt.is_floating_point:
        dt = torch.float32 if dt == torch.int32 else torch.float64
    return dt


def _arith_operand(v: _Val, dtype: torch.dtype, device) -> torch.Tensor:
    if v.kind == "num":
        return v.arr.to(dtype)
    return torch.tensor(v.value, dtype=dtype, device=device)


def _arithmetic(op: str, l: _Val, r: _Val, valid, device) -> _Val:
    """`+ - * /` with the JAX package's types; `x / 0` is null (SQL), its
    slot filled with 0."""
    dt = _arith_dtype(l, r, op)
    lv, rv = _arith_operand(l, dt, device), _arith_operand(r, dt, device)
    if op == "+":
        return _Val("num", lv + rv, valid=valid)
    if op == "-":
        return _Val("num", lv - rv, valid=valid)
    if op == "*":
        return _Val("num", lv * rv, valid=valid)
    zero = rv == 0
    value = lv / torch.where(zero, torch.ones_like(rv), rv)
    nonzero = torch.broadcast_to(~zero, value.shape)
    valid = nonzero if valid is None else (valid & nonzero)
    return _Val("num", torch.where(nonzero, value, torch.zeros((), dtype=value.dtype, device=device)), valid=valid)


def evaluate(expr: Expr, table: Table) -> _Val:
    if isinstance(expr, Col):
        col = table.column(expr.name)
        if col.is_string:
            return _Val("str", col.data, col.dictionary, valid=col.validity)
        return _Val("num", col.data, valid=col.validity)

    if isinstance(expr, Lit):
        return _Val("lit", value=expr.value)

    if isinstance(expr, Udf):
        return _evaluate_udf(expr, table)

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
            if op not in BinaryOp.COMPARISONS:
                raise HyperspaceException(f"Arithmetic on strings is not supported: {op}")
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
        if op in BinaryOp.ARITHMETIC:
            return _arithmetic(op, l, r, valid, _device_of(table))
        if l.kind == "lit" and r.kind == "lit":
            raise HyperspaceException(f"A comparison of two literals is not supported: {expr!r}")
        return _Val("num", _compare(op, _numeric_operand(l, r), _numeric_operand(r, l)), valid=valid)

    raise HyperspaceException(f"Cannot evaluate expression: {expr!r}")


def _host_argument(a: Expr, table: Table):
    """A UDF argument on the host: ("lit", value) or ("arr", values, valid)
    with strings decoded and `valid` None when every row is valid."""
    if isinstance(a, Col):
        c = table.column(a.name)
        return ("arr", c.decode(), None if c.validity is None else c.validity.cpu().numpy())
    v = evaluate(a, table)
    if v.kind == "lit":
        return ("lit", v.value)
    data = v.arr.cpu().numpy()
    if v.kind == "str":
        data = np.asarray(v.dictionary)[data]
    if data.ndim == 0:  # arithmetic of literals: a per-row constant
        return ("lit", data.item())
    valid = None if v.valid is None else v.valid.cpu().numpy()
    if valid is not None and valid.ndim == 0:
        valid = np.full(data.shape, bool(valid))
    return ("arr", data, valid)


def _evaluate_udf(expr: Udf, table: Table) -> _Val:
    """A user function, on the host by contract (`evaluate._evaluate_udf`
    :255): its arguments decoded, None at null slots, one call a row; the
    result takes the declared type, None a null, and goes back to the
    table's device."""
    n = table.num_rows
    device = _device_of(table)
    prepared = [_host_argument(a, table) for a in expr.args]
    out = []
    for i in range(n):
        args = []
        for arg in prepared:
            if arg[0] == "lit":
                args.append(arg[1])
            elif arg[2] is not None and not arg[2][i]:
                args.append(None)
            else:
                x = arg[1][i]
                args.append(x.item() if hasattr(x, "item") else x)
        out.append(expr.fn(*args))
    if expr.dtype == "string":
        if n == 0:
            return _Val("str", torch.empty(0, dtype=torch.int32, device=device), np.empty(0, "<U1"))
        col = Column.from_values(np.asarray(out, dtype=object), device)
        return _Val("str", col.data, col.dictionary, valid=col.validity)
    npdtype = np.dtype(expr.dtype)
    null_mask = np.fromiter((v is None for v in out), bool, count=n)
    fill = np.zeros((), npdtype).item()
    filled = np.asarray([fill if v is None else v for v in out], dtype=npdtype)
    valid = torch.from_numpy(~null_mask).to(device) if null_mask.any() else None
    return _Val("num", torch.from_numpy(filled).to(device), valid=valid)


def evaluate_column(expr: Expr, table: Table) -> Column:
    """An expression as a column (the computed-column executor,
    `evaluate.evaluate_column` :281). Null slots are refilled with 0 so that
    hashing and grouping over computed columns keep nulls in one cluster; a
    literal, or arithmetic of literals, is broadcast to the table's rows."""
    n = table.num_rows
    device = _device_of(table)
    v = evaluate(expr, table)
    if v.kind == "str":
        codes = v.arr if v.valid is None else torch.where(v.valid, v.arr, torch.zeros((), dtype=v.arr.dtype, device=device))
        return Column("string", codes.to(torch.int32), np.asarray(v.dictionary), v.valid)
    if v.kind == "lit":
        if isinstance(v.value, str):
            return Column("string", torch.zeros(n, dtype=torch.int32, device=device), np.asarray([v.value]))
        dt = _literal_dtype(v.value)
        return Column(_type_name(dt), torch.full((n,), v.value, dtype=dt, device=device))
    arr, valid = v.arr, v.valid
    if arr.ndim == 0:
        arr = arr.expand(n).clone()
    if valid is not None and valid.ndim == 0:
        valid = valid.expand(n).clone()
    if valid is not None and not bool(valid.all()):
        arr = torch.where(valid, arr, torch.zeros((), dtype=arr.dtype, device=device))
    return Column(_type_name(arr.dtype), arr, None, valid)


def _type_name(dtype: torch.dtype) -> str:
    return next(k for k, v in TORCH_DTYPES.items() if v == dtype and k != "string")


def evaluate_predicate(expr: Expr, table: Table) -> torch.Tensor:
    """A boolean expression over a table -> bool mask on its device. A row
    survives only when the predicate is TRUE and KNOWN (WHERE drops unknowns)."""
    v = evaluate(expr, table)
    if v.kind != "num" or v.arr.dtype != torch.bool:
        raise HyperspaceException(f"Not a boolean predicate: {expr!r}")
    return v.arr if v.valid is None else v.arr & v.valid

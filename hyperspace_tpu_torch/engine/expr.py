"""Expression IR for filters, computed columns and join conditions
(counterpart of `hyperspace_tpu/engine/expr.py`).

The rules pattern-match the tree (`EqualTo`/`And` CNF for joins, reference
`JoinIndexRule.scala:188-194`; head-column equality for bucket pruning), so
the shapes are the JAX package's: comparisons, `and`/`or` and the arithmetic
`+ - * /` as `BinaryOp` (a literal on either side), `Not`, `IsNull`, `IsIn`
and the host-evaluated user function `Udf`.
"""

from __future__ import annotations

import itertools
import weakref
from typing import List, Optional, Sequence, Set


class Expr:
    def references(self) -> Set[str]:
        """All column names referenced by this expression."""
        out: Set[str] = set()
        self._collect_refs(out)
        return out

    def _collect_refs(self, out: Set[str]) -> None:
        for c in self.children():
            c._collect_refs(out)

    def children(self) -> Sequence["Expr"]:
        return ()

    # -- operator sugar -----------------------------------------------------

    def __eq__(self, other):  # type: ignore[override]
        return BinaryOp("==", self, _lit(other))

    def __ne__(self, other):  # type: ignore[override]
        return BinaryOp("!=", self, _lit(other))

    def __lt__(self, other):
        return BinaryOp("<", self, _lit(other))

    def __le__(self, other):
        return BinaryOp("<=", self, _lit(other))

    def __gt__(self, other):
        return BinaryOp(">", self, _lit(other))

    def __ge__(self, other):
        return BinaryOp(">=", self, _lit(other))

    def __and__(self, other):
        return BinaryOp("and", self, _lit(other))

    def __or__(self, other):
        return BinaryOp("or", self, _lit(other))

    def __invert__(self):
        return Not(self)

    def __add__(self, other):
        return BinaryOp("+", self, _lit(other))

    def __radd__(self, other):
        return BinaryOp("+", _lit(other), self)

    def __sub__(self, other):
        return BinaryOp("-", self, _lit(other))

    def __rsub__(self, other):
        return BinaryOp("-", _lit(other), self)

    def __mul__(self, other):
        return BinaryOp("*", self, _lit(other))

    def __rmul__(self, other):
        return BinaryOp("*", _lit(other), self)

    def __truediv__(self, other):
        return BinaryOp("/", self, _lit(other))

    def __rtruediv__(self, other):
        return BinaryOp("/", _lit(other), self)

    def is_null(self) -> "IsNull":
        return IsNull(self, negated=False)

    def is_not_null(self) -> "IsNull":
        return IsNull(self, negated=True)

    def isin(self, *values) -> "IsIn":
        vals = values[0] if len(values) == 1 and isinstance(values[0], (list, tuple)) else values
        return IsIn(self, list(vals))

    def __hash__(self):
        return hash(repr(self))

    def semantic_equals(self, other: "Expr") -> bool:
        return repr(self) == repr(other)


class Col(Expr):
    def __init__(self, name: str):
        self.name = name

    def _collect_refs(self, out: Set[str]) -> None:
        out.add(self.name)

    def __repr__(self):
        return f"col({self.name})"


class Lit(Expr):
    def __init__(self, value):
        self.value = value

    def __repr__(self):
        return f"lit({self.value!r})"


class BinaryOp(Expr):
    COMPARISONS = ("==", "!=", "<", "<=", ">", ">=")
    BOOLEAN = ("and", "or")
    ARITHMETIC = ("+", "-", "*", "/")

    def __init__(self, op: str, left: Expr, right: Expr):
        if op not in self.COMPARISONS + self.BOOLEAN + self.ARITHMETIC:
            raise ValueError(f"unknown operator {op!r}")
        self.op = op
        self.left = left
        self.right = right

    def children(self) -> Sequence[Expr]:
        return (self.left, self.right)

    def __repr__(self):
        return f"({self.left!r} {self.op} {self.right!r})"


class Not(Expr):
    def __init__(self, child: Expr):
        self.child = child

    def children(self) -> Sequence[Expr]:
        return (self.child,)

    def __repr__(self):
        return f"(not {self.child!r})"


class IsNull(Expr):
    """IS NULL / IS NOT NULL: the only expressions that observe the validity
    lane directly (and whose result is never itself null)."""

    def __init__(self, child: Expr, negated: bool = False):
        self.child = child
        self.negated = negated

    def children(self) -> Sequence[Expr]:
        return (self.child,)

    def __repr__(self):
        return f"({self.child!r} is {'not ' if self.negated else ''}null)"


class IsIn(Expr):
    def __init__(self, child: Expr, values: Sequence):
        self.child = child
        self.values = list(values)

    def children(self) -> Sequence[Expr]:
        return (self.child,)

    def __repr__(self):
        return f"({self.child!r} in {self.values!r})"


class Udf(Expr):
    """A user-defined column function applied row by row to its argument
    expressions (`expr.Udf` :173).

    Evaluated on the host by contract: the argument columns are decoded on
    the host, a null arrives as None, the function runs once a row in Python,
    and a None it returns is a null; the result column goes back to the
    session's device. The rewrite rules still apply around a UDF (an index
    fires when the UDF reads only columns it covers)."""

    def __init__(self, fn, dtype: str, args: Sequence[Expr], name: Optional[str] = None):
        self.fn = fn
        self.dtype = dtype
        self.args = list(args)
        self.name = name or getattr(fn, "__name__", "udf")

    def children(self) -> Sequence[Expr]:
        return tuple(self.args)

    def __repr__(self):
        # The repr keys the scan caches and join memos, so it carries the
        # function's identity: two lambdas over the same arguments differ.
        args = ", ".join(repr(a) for a in self.args)
        return f"udf:{self.name}#{_udf_uid(self.fn)}({args})"


_udf_uids: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_udf_uids_strong: dict = {}  # id(fn) -> (fn, uid) for callables that take no weak reference
_udf_counter = itertools.count()


def _udf_uid(fn) -> int:
    """A number per function object, never reused (unlike `id()`): weakly
    keyed, so it dies with its function. A callable that takes no weak
    reference (a numpy ufunc) is kept by a strong entry, which pins its id."""
    try:
        u = _udf_uids.get(fn)
        if u is None:
            u = next(_udf_counter)
            _udf_uids[fn] = u
        return u
    except TypeError:
        ent = _udf_uids_strong.get(id(fn))
        if ent is None or ent[0] is not fn:
            ent = (fn, next(_udf_counter))
            _udf_uids_strong[id(fn)] = ent
        return ent[1]


def udf(fn, dtype: str, name: Optional[str] = None):
    """A plain Python function as a column-expression factory (`expr.udf`
    :236):

        tier = udf(lambda q: "big" if q > 25 else "small", "string")
        df.with_column("tier", tier(col("qty")))

    `dtype` declares the result type ("int64", "float64", "bool", "string",
    ...). See `Udf` for the host evaluation and the null contract."""

    def make(*args) -> Udf:
        return Udf(fn, dtype, [_lit(a) for a in args], name)

    return make


def _lit(v) -> Expr:
    return v if isinstance(v, Expr) else Lit(v)


def col(name: str) -> Col:
    return Col(name)


def lit(value) -> Lit:
    return Lit(value)


def canonical_condition_repr(e: Expr, case_sensitive: bool = False) -> str:
    """A condition's cache-key spelling (`expr.canonical_condition_repr`
    :267): under case-insensitive resolution column names are lowercased, so
    `col("X") == 1` and `col("x") == 1` share one entry; injective per
    distinct condition."""
    if case_sensitive:
        return repr(e)

    def walk(x: Expr) -> str:
        if isinstance(x, Col):
            return f"col({x.name.lower()})"
        if isinstance(x, BinaryOp):
            return f"({walk(x.left)} {x.op} {walk(x.right)})"
        if isinstance(x, Not):
            return f"(not {walk(x.child)})"
        if isinstance(x, IsNull):
            return f"({walk(x.child)} is {'not ' if x.negated else ''}null)"
        if isinstance(x, IsIn):
            return f"({walk(x.child)} in {x.values!r})"
        if isinstance(x, Udf):
            args = ", ".join(walk(a) for a in x.args)
            return f"udf:{x.name}#{_udf_uid(x.fn)}({args})"
        return repr(x)

    return walk(e)


def split_conjuncts(e: Expr) -> List[Expr]:
    """Flatten a tree of `and`s into conjuncts (CNF split)."""
    if isinstance(e, BinaryOp) and e.op == "and":
        return split_conjuncts(e.left) + split_conjuncts(e.right)
    return [e]


def extract_equi_join_keys(condition: Expr):
    """(left_col_name, right_col_name) pairs if the condition is pure equi-join
    CNF (`==` joined by `and`, each side a bare column); else None. The caller
    orients each pair against the actual child plans."""
    pairs = []
    for conj in split_conjuncts(condition):
        if not (isinstance(conj, BinaryOp) and conj.op == "=="):
            return None
        l, r = conj.left, conj.right
        if not (isinstance(l, Col) and isinstance(r, Col)):
            return None
        pairs.append((l.name, r.name))
    return pairs

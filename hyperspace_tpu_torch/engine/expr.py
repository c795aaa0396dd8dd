"""Expression IR for join conditions (counterpart of `hyperspace_tpu/engine/expr.py`).

The join rule pattern-matches equi-join CNF (`EqualTo`/`And` only, reference
`JoinIndexRule.scala:188-194`), so the tree shape is explicit: `==` and `&`
build the same trees as the JAX package. Other operators and predicate
evaluation (filters) are not ported yet.
"""

from __future__ import annotations

from typing import List, Sequence, Set


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

    def __eq__(self, other):  # type: ignore[override]
        return BinaryOp("==", self, _lit(other))

    def __and__(self, other):
        return BinaryOp("and", self, _lit(other))

    def __hash__(self):
        return hash(repr(self))


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
    OPS = ("==", "and")

    def __init__(self, op: str, left: Expr, right: Expr):
        assert op in self.OPS, op
        self.op = op
        self.left = left
        self.right = right

    def children(self) -> Sequence[Expr]:
        return (self.left, self.right)

    def __repr__(self):
        return f"({self.left!r} {self.op} {self.right!r})"


def _lit(v) -> Expr:
    return v if isinstance(v, Expr) else Lit(v)


def col(name: str) -> Col:
    return Col(name)


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

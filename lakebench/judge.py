"""The comparison that decides `correct`: a query's collected rows against
its plain reference's answer.

A reference module (`reference/<query>.py`) states its query's `COLUMNS`,
`LIMIT`, the sort keys `ORDER` ((column, "asc" | "desc") ...), the columns
that identify a row (`IDENT`), those compared exactly (`EXACT`) and the
measures compared by their relative error (`MEASURES`), and returns every
group in the query's order. A query is wrong when its columns, its row
count, the rows at each position or an exact column differ; rows whose sort
keys tie (measures within `TIE_RTOL`) may come in any order among
themselves, and a tie across the last row may bring any of its members.
Its measures give the run's largest relative error, which has a limit of
its own (`limits/<cell>.json`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

#: Two sums this close sort as a tie: float64 sums of the same values in
#: another order differ by some 1e-16 of their value.
TIE_RTOL = 1e-9


def _values(v) -> np.ndarray:
    a = np.asarray(v)
    return a.astype(str) if a.dtype.kind in "OUS" else a


def _row_keys(cols: dict, names) -> list:
    return list(zip(*[_values(cols[n]).tolist() for n in names]))


def tie_classes(want: dict, ref) -> np.ndarray:
    """Each reference row's tie class: consecutive rows whose sort keys are
    equal, measures within `TIE_RTOL`."""
    n = len(_values(want[ref.COLUMNS[0]]))
    same = np.ones(max(n - 1, 0), bool)
    for name, _ in ref.ORDER:
        v = _values(want[name])
        if name in ref.MEASURES:
            same &= np.isclose(v[1:].astype(np.float64), v[:-1].astype(np.float64), rtol=TIE_RTOL, atol=0)
        else:
            same &= v[1:] == v[:-1]
    return np.concatenate([[0], np.cumsum(~same)]).astype(np.int64)


def compare(got: dict, want: dict, ref) -> Tuple[bool, float, str]:
    """(wrong, largest relative error of a measure, why wrong)."""
    if list(got) != list(ref.COLUMNS):
        return True, 0.0, f"columns {list(got)}, want {list(ref.COLUMNS)}"
    n_want = len(_values(want[ref.COLUMNS[0]]))
    m = min(ref.LIMIT, n_want)
    n_got = len(_values(got[ref.COLUMNS[0]]))
    if n_got != m:
        return True, 0.0, f"{n_got} rows, want {m}"
    cls = tie_classes(want, ref)
    have_keys = _row_keys(got, ref.IDENT)
    want_keys = _row_keys(want, ref.IDENT)
    for c in np.unique(cls[:m]):
        pos, members = np.nonzero(cls[:m] == c)[0], np.nonzero(cls == c)[0]
        have = {have_keys[i] for i in pos}
        allowed = {want_keys[i] for i in members}
        if not (have <= allowed if members[-1] >= m else have == allowed) or len(have) != len(pos):
            return True, 0.0, f"rows {pos.tolist()} hold {sorted(have)}, the reference {sorted(allowed)}"
    at = {k: i for i, k in enumerate(want_keys)}
    rows = np.array([at[k] for k in have_keys], np.int64)
    for name in ref.EXACT:
        g, w = _values(got[name]), _values(want[name])[rows]
        if g.dtype.kind in "fiub" and w.dtype.kind in "fiub":
            same = np.array_equal(g.astype(np.float64), w.astype(np.float64))
        else:
            same = g.astype(str).tolist() == w.astype(str).tolist()
        if not same:
            return True, 0.0, f"column {name} differs"
    err = 0.0
    for name in ref.MEASURES:
        g = _values(got[name]).astype(np.float64)
        w = _values(want[name])[rows].astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = np.where(w == g, 0.0, np.abs(g - w) / np.abs(w))
        if len(rel):
            err = max(err, float(np.nan_to_num(rel, nan=np.inf).max()))
    return False, err, ""


def top(cols: dict, ref, order: np.ndarray) -> dict:
    """The reference's rows in `order`, cut after the query's limit where no
    tie runs across it."""
    out = {n: np.asarray(cols[n])[order] for n in ref.COLUMNS}
    cls = tie_classes(out, ref)
    if len(cls) > ref.LIMIT:
        end = int(np.searchsorted(cls, cls[ref.LIMIT - 1], side="right"))
        out = {n: v[:end] for n, v in out.items()}
    return out


def group_sum(inverse: np.ndarray, values: np.ndarray, groups: int, dtype) -> np.ndarray:
    """Per-group sums in `dtype` (float64 and int64 exactly as numpy adds;
    float32, the control's, accumulated in float32)."""
    dtype = np.dtype(dtype)
    if dtype == np.float64:
        return np.bincount(inverse, weights=values.astype(np.float64), minlength=groups)
    out = np.zeros(groups, dtype)
    np.add.at(out, inverse, values.astype(dtype))
    return out

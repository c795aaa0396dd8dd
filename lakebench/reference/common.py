"""Helpers of the references."""

from __future__ import annotations

import numpy as np


def np_join(lk: np.ndarray, rk: np.ndarray):
    """All equal-key (left, right) index pairs of two key arrays."""
    r_order = np.argsort(rk, kind="stable")
    rs = rk[r_order]
    lo = np.searchsorted(rs, lk, "left")
    cnt = np.searchsorted(rs, lk, "right") - lo
    li = np.repeat(np.arange(len(lk)), cnt)
    off = np.arange(len(li)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    return li, r_order[lo[li] + off]


def ranges(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """The indices of [starts[i], ends[i]) for every i, concatenated."""
    lens = ends - starts
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    first = np.repeat(starts - np.concatenate([[0], np.cumsum(lens)[:-1]]), lens)
    return first + np.arange(total)


def lookup(sorted_keys: np.ndarray, keys: np.ndarray):
    """(positions, found) of `keys` in a sorted key array."""
    pos = np.searchsorted(sorted_keys, keys)
    pos_c = np.minimum(pos, len(sorted_keys) - 1)
    found = (pos < len(sorted_keys)) & (sorted_keys[pos_c] == keys) if len(sorted_keys) else np.zeros(len(keys), bool)
    return pos_c, found


def count_le(cum: np.ndarray, vmin: int, v: int) -> int:
    """How many values are <= v, from the cumulative counts `cum` of the
    values vmin, vmin + 1, ..."""
    if v < vmin:
        return 0
    return int(cum[min(v - vmin, len(cum) - 1)])

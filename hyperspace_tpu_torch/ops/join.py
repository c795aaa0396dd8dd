"""Host merge of one oversized bucket (counterpart of `hyperspace_tpu/ops/join.py`
`host_merge_pairs` :85): the size-classed join sends outlier buckets here
instead of padding every bucket of their class to the outlier's size."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def host_merge_pairs(lk: np.ndarray, rk: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """All equal-key (left_index, right_index) pairs of two host arrays. Pair
    order: left rows in stable sorted-key order, each with its matches in the
    right side's stable sorted order — the same within-bucket order the padded
    expansion emits."""
    lk, rk = np.asarray(lk), np.asarray(rk)
    if lk.shape[0] == 0 or rk.shape[0] == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    l_order = np.argsort(lk, kind="stable")
    r_order = np.argsort(rk, kind="stable")
    ls, rs = lk[l_order], rk[r_order]
    lo = np.searchsorted(rs, ls, side="left")
    counts = np.searchsorted(rs, ls, side="right") - lo
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    starts = np.cumsum(counts) - counts
    l_pos = np.repeat(np.arange(lk.shape[0]), counts)
    offset = np.arange(total) - starts[l_pos]
    r_pos = lo[l_pos] + offset
    return l_order[l_pos], r_order[r_pos]

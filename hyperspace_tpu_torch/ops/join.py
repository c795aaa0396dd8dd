"""The general sort-merge join primitive (counterpart of `hyperspace_tpu/ops/join.py`).

Both sides' join keys are 64-bit value hashes (`ops.hashing.key64`), so the
merge works on one comparable integer whatever the column count or the string
dictionaries. The pipeline is a stable sort of each side, a left and a right
`searchsorted` of the left keys into the right ones, and the expansion of the
ranges into pairs; every step stays on the keys' device except one scalar
sync for the output size (`merge_join_pairs`, as at `ops/join.py:68`). Equal
key tuples always hash equal; unequal tuples that collide are dropped by the
caller's exact verification, so the join is exact.

The JAX package computes this in XLA outside any Pallas kernel; here it is
torch ops. `host_merge_pairs` is the numpy twin: the per-bucket merge of the
size-classed join's outlier buckets, and the oracle of the torch path.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..telemetry import tracing as _tracing


def stable_argsort_host(x) -> np.ndarray:
    """A stable argsort of a host array, as a numpy permutation (:26)."""
    return np.argsort(np.asarray(x), kind="stable")


def _range_probe_body(l_key64, r_key64, l_order, r_order, searchsorted=np.searchsorted):
    """(lo, counts) of each sorted left key in the sorted right keys: the one
    home of the probe's semantics (:32), for numpy arrays and, with
    `searchsorted=torch.searchsorted`, for tensors."""
    ls = l_key64[l_order]
    rs = r_key64[r_order]
    lo = searchsorted(rs, ls, side="left")
    hi = searchsorted(rs, ls, side="right")
    return lo, hi - lo


def merge_join_pairs(l_key64: torch.Tensor, r_key64: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """All (left_index, right_index) pairs with equal keys, as int64 tensors
    on the keys' device (:54). Pair order: left rows in stable sorted-key
    order, each with its right matches in stable sorted-key order — the JAX
    package's order on every backend. Steps `join.sort` and `join.merge`
    while tracing."""
    dev = l_key64.device
    n_l, n_r = int(l_key64.shape[0]), int(r_key64.shape[0])
    empty = torch.empty(0, dtype=torch.int64, device=dev)
    if n_l == 0 or n_r == 0:
        return empty, empty
    with _tracing.step("join.sort"):
        l_order = torch.sort(l_key64, stable=True).indices
        r_order = torch.sort(r_key64, stable=True).indices
    with _tracing.step("join.merge"):
        lo, counts = _range_probe_body(l_key64, r_key64, l_order, r_order, torch.searchsorted)
        total = int(counts.sum())  # the one scalar sync: the output size
        if total == 0:
            return empty, empty
        starts = torch.cumsum(counts, 0) - counts
        l_pos = torch.repeat_interleave(torch.arange(n_l, device=dev), counts, output_size=total)
        r_pos = lo[l_pos] + (torch.arange(total, device=dev) - starts[l_pos])
        return l_order[l_pos], r_order[r_pos]


def host_merge_pairs(lk: np.ndarray, rk: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """All equal-key (left_index, right_index) pairs of two host arrays (:85),
    in `merge_join_pairs`' order — the same within-bucket order the padded
    expansion emits, so the size-classed join sends oversized outlier buckets
    here instead of padding their whole class to the outlier's size."""
    lk, rk = np.asarray(lk), np.asarray(rk)
    if lk.shape[0] == 0 or rk.shape[0] == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    l_order = stable_argsort_host(lk)
    r_order = stable_argsort_host(rk)
    lo, counts = _range_probe_body(lk, rk, l_order, r_order)
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    starts = np.cumsum(counts) - counts
    l_pos = np.repeat(np.arange(lk.shape[0]), counts)
    offset = np.arange(total) - starts[l_pos]
    r_pos = lo[l_pos] + offset
    return l_order[l_pos], r_order[r_pos]

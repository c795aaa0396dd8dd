"""Co-bucketed merge join, size-classed: all bucket pairs of a class in one probe.

Counterpart of `hyperspace_tpu/ops/bucket_join.py`'s size-classed executor.
Both join sides arrive hash-partitioned into the same buckets (the covering
indexes were built with the same hash), so bucket b of the left joins only
bucket b of the right. The bucket axis becomes a batch dimension:

1. `joint_partition` groups the buckets that are non-empty on both sides into
   classes by the power-of-two capacity of their two sides; buckets far above
   the median leave the padded layout and merge on the host (outliers).
2. `_build_side` scatters each class's rows into a padded [B, cap] matrix. In
   value mode (one numeric null-free key, buckets already sorted by it at
   build time) the rows are the key values and need no sort; in hash mode
   they are `key64` hashes and each row is sorted by kernel K1
   (`cuda_sort.sort_rows`).
3. `probe_classed` range-probes each class with kernel K2
   (`cuda_probe.range_probe`), the smaller-capacity side probing the larger.
4. `classed_pairs` expands the ranges into (left_row, right_row) candidate
   pairs in bucket-major order, with torch ops on the tables' device.

The JAX package builds the class matrices on the host with numpy on its CPU
backend and with jitted programs on a TPU; the port has one path, torch ops on
the session's device, and only the kernels' wrappers tell CPU from CUDA.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .cuda_probe import range_probe
from .cuda_sort import sort_rows
from .join import host_merge_pairs

_PAD = torch.iinfo(torch.int64).max

#: A bucket whose larger side exceeds this many times the median of the
#: active buckets' larger sides merges on the host (the JAX package's
#: default `HYPERSPACE_JOIN_OUTLIER_FACTOR`).
OUTLIER_FACTOR = 8.0
_MAX_CLASSES = 8


def _cap_pow2(n: int) -> int:
    """Next power of two (≥ 1)."""
    return 1 << (max(1, int(n)) - 1).bit_length()


class _ClassSide:
    """One side of one capacity class: `keys` [B, cap] sorted within each row,
    `lengths` [B] valid counts, `order` [B, cap] sorted slot → storage slot
    (None in value mode), `starts` [B] global row offsets of the class's
    buckets (B pow2-padded with empty buckets)."""

    __slots__ = ("keys", "lengths", "order", "starts", "cap")

    def __init__(self, keys, lengths, order, starts, cap: int):
        self.keys = keys
        self.lengths = lengths
        self.order = order
        self.starts = starts
        self.cap = cap


class JoinSegment:
    """One capacity class: its bucket ids (ascending, shared by both sides) and
    the two padded sides."""

    __slots__ = ("ids", "l", "r")

    def __init__(self, ids: np.ndarray, l: _ClassSide, r: _ClassSide):
        self.ids = ids
        self.l = l
        self.r = r


class ClassedJoinPlan:
    """Joint size-classed layout of one co-bucketed join pair. `l_vals`/`r_vals`
    are the key tensors in the joint key space (key64 in hash mode, the
    canonical values in value mode), concatenated in bucket order."""

    def __init__(self, mode, segments, outlier_ids, l_vals, r_vals, l_starts, r_starts):
        self.mode = mode  # "value" | "hash"
        self.segments = segments
        self.outlier_ids = outlier_ids
        self.l_vals = l_vals
        self.r_vals = r_vals
        self.l_starts = l_starts
        self.r_starts = r_starts
        self.num_buckets = len(l_starts) - 1


class ClassedRanges:
    """Probe output of a classed plan: per segment (lo, counts, swapped,
    seg_total), plus the outlier buckets' global candidate pairs. `total`
    counts every candidate pair (exact matches in value mode)."""

    def __init__(self, segments, outliers, total: int):
        self.segments = segments
        self.outliers = outliers
        self.total = total


def joint_partition(l_starts: np.ndarray, r_starts: np.ndarray) -> Tuple[List[np.ndarray], np.ndarray]:
    """Classes (ascending id arrays) and outlier ids of the buckets with rows on
    both sides — a pure function of the two offset arrays (bucket_join.py:731)."""
    l_lens = np.diff(np.asarray(l_starts, np.int64))
    r_lens = np.diff(np.asarray(r_starts, np.int64))
    active = np.nonzero((l_lens > 0) & (r_lens > 0))[0]
    if len(active) == 0:
        return [], np.empty(0, np.int64)
    mx = np.maximum(l_lens, r_lens)[active]
    out_mask = mx > OUTLIER_FACTOR * max(float(np.median(mx)), 1.0)
    outliers = active[out_mask]
    rest = active[~out_mask]
    if len(rest) == 0:
        return [], outliers

    def group_by_caps(quantize) -> dict:
        classes: dict = {}
        for b in rest:
            key = (quantize(int(l_lens[b])), quantize(int(r_lens[b])))
            classes.setdefault(key, []).append(int(b))
        return classes

    classes = group_by_caps(_cap_pow2)
    if len(classes) > _MAX_CLASSES:
        def cap_pow4(n: int) -> int:
            bits = (max(1, n) - 1).bit_length()
            return 1 << (bits + (bits & 1))

        classes = group_by_caps(cap_pow4)
    if len(classes) > _MAX_CLASSES:
        classes = {("all", "all"): [int(b) for b in rest]}
    groups = [
        np.asarray(sorted(ids), np.int64)
        for _key, ids in sorted(classes.items(), key=lambda kv: (str(kv[0]), kv[1][0]))
    ]
    return groups, outliers


def value_mode_vals(data: torch.Tensor, starts: np.ndarray) -> Optional[torch.Tensor]:
    """Canonical key values for value mode, or None when the column
    disqualifies: NaN keys, or buckets not sorted by the key
    (bucket_join.py:782)."""
    vals = data
    if vals.is_floating_point():
        if bool(torch.isnan(vals).any()):
            return None
        vals = torch.where(vals == 0, torch.zeros((), dtype=vals.dtype, device=vals.device), vals)
    n = vals.shape[0]
    if n > 1:
        adj = vals[1:] >= vals[:-1]
        bounds = np.asarray(starts, np.int64)[1:-1] - 1
        bounds = bounds[(bounds >= 0) & (bounds < n - 1)]
        adj[torch.as_tensor(bounds, device=vals.device)] = True
        if not bool(adj.all()):
            return None
    return vals


def _pad_value(dtype: torch.dtype):
    if dtype.is_floating_point:
        return torch.finfo(dtype).max
    return torch.iinfo(dtype).max


def _pad_scatter(vals: torch.Tensor, gstarts: torch.Tensor, lens: torch.Tensor, cap: int) -> torch.Tensor:
    """Scatter the rows of the buckets starting at `gstarts` (lengths `lens`)
    into an unsorted [B, cap] matrix padded with the dtype's max."""
    dev = vals.device
    total = int(lens.sum())
    local_starts = torch.cumsum(lens, 0) - lens
    b_row = torch.repeat_interleave(torch.arange(lens.shape[0], device=dev), lens, output_size=total)
    slot = torch.arange(total, device=dev) - local_starts[b_row]
    padded = torch.full((lens.shape[0], cap), _pad_value(vals.dtype), dtype=vals.dtype, device=dev)
    padded[b_row, slot] = vals[gstarts[b_row] + slot]
    return padded


def pad_buckets_by_value(vals, gstarts, lens, cap: int) -> torch.Tensor:
    """Value-direct padded matrix: the buckets are already sorted by the key
    (the index build sorted them), so no sort runs (bucket_join.py:304)."""
    return _pad_scatter(vals, gstarts, lens, cap)


def pad_buckets_by_hash(key64, gstarts, lens, cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hash-key padded matrix sorted within each row by kernel K1, with the
    sorted slot → storage slot order (bucket_join.py:351)."""
    return sort_rows(_pad_scatter(key64, gstarts, lens, cap))


def _build_side(vals: torch.Tensor, starts: np.ndarray, ids: np.ndarray, mode: str) -> _ClassSide:
    """Padded matrices of one class of one side (bucket_join.py:812), with the
    bucket axis pow2-padded by empty virtual buckets."""
    dev = vals.device
    lens = (starts[ids + 1] - starts[ids]).astype(np.int64)
    cap = _cap_pow2(int(lens.max()))
    b_pad = _cap_pow2(len(ids))
    lens_t = torch.zeros(b_pad, dtype=torch.int64, device=dev)
    lens_t[: len(ids)] = torch.as_tensor(lens, device=dev)
    gstarts = torch.zeros(b_pad, dtype=torch.int64, device=dev)
    gstarts[: len(ids)] = torch.as_tensor(starts[ids].astype(np.int64), device=dev)
    if mode == "hash":
        keys, order = pad_buckets_by_hash(vals, gstarts, lens_t, cap)
        return _ClassSide(keys, lens_t, order, gstarts, cap)
    return _ClassSide(pad_buckets_by_value(vals, gstarts, lens_t, cap), lens_t, None, gstarts, cap)


def build_classed_plan(
    l_vals: torch.Tensor, r_vals: torch.Tensor, l_starts, r_starts, mode: str
) -> ClassedJoinPlan:
    """The joint size-classed layout of one co-bucketed join pair (bucket_join.py:891)."""
    l_starts = np.asarray(l_starts, np.int64)
    r_starts = np.asarray(r_starts, np.int64)
    if mode == "hash":
        # Real hashes stay below the pad so pads sort last.
        l_vals = torch.clamp(l_vals, max=_PAD - 1)
        r_vals = torch.clamp(r_vals, max=_PAD - 1)
    groups, outlier_ids = joint_partition(l_starts, r_starts)
    segments = [
        JoinSegment(ids, _build_side(l_vals, l_starts, ids, mode), _build_side(r_vals, r_starts, ids, mode))
        for ids in groups
    ]
    return ClassedJoinPlan(mode, segments, outlier_ids, l_vals, r_vals, l_starts, r_starts)


def probe_keys_promoted(a_keys: torch.Tensor, b_keys: torch.Tensor):
    """Key matrices promoted to a common dtype by numpy's promotion lattice,
    matching the exact verification (bucket_join.py:398)."""
    if a_keys.dtype == b_keys.dtype:
        return a_keys, b_keys
    na = torch.empty(0, dtype=a_keys.dtype).numpy().dtype
    nb = torch.empty(0, dtype=b_keys.dtype).numpy().dtype
    common = torch.from_numpy(np.empty(0, np.promote_types(na, nb))).dtype
    return a_keys.to(common), b_keys.to(common)


def probe_ranges(ls, rs, l_len, r_len):
    """The range probe of one class: kernel K2 (bucket_join.py:409)."""
    return range_probe(ls, rs, l_len, r_len)


def _outlier_bucket_pairs(plan: ClassedJoinPlan, b: int):
    """Host merge of one oversized bucket → global candidate pairs."""
    ls, le = int(plan.l_starts[b]), int(plan.l_starts[b + 1])
    rs, re = int(plan.r_starts[b]), int(plan.r_starts[b + 1])
    lv, rv = probe_keys_promoted(plan.l_vals[ls:le], plan.r_vals[rs:re])
    li, ri = host_merge_pairs(lv.cpu().numpy(), rv.cpu().numpy())
    return li + ls, ri + rs


def probe_classed(plan: ClassedJoinPlan) -> ClassedRanges:
    """Range-probe every class (the smaller capacity probes the larger) and
    merge the outlier buckets on the host (bucket_join.py:962)."""
    segs = []
    total = 0
    for seg in plan.segments:
        if seg.l.cap > seg.r.cap:
            a, b, swapped = seg.r, seg.l, True
        else:
            a, b, swapped = seg.l, seg.r, False
        ak, bk = probe_keys_promoted(a.keys, b.keys)
        lo, counts = probe_ranges(ak, bk, a.lengths, b.lengths)
        seg_total = int(counts.sum(dtype=torch.int64))
        total += seg_total
        segs.append((lo, counts, swapped, seg_total))
    outs = []
    for b in plan.outlier_ids:
        li, ri = _outlier_bucket_pairs(plan, int(b))
        total += len(li)
        outs.append((int(b), li, ri))
    return ClassedRanges(segs, outs, total)


def _expand(lo, counts, a_starts, b_starts, a_order, b_order, total: int):
    """Count ranges → global (a_row, b_row) pairs, in flat (bucket row, probe
    slot) order, each probe slot's matches in the other side's sorted order."""
    cap_a = counts.shape[1]
    dev = counts.device
    counts_flat = counts.reshape(-1).to(torch.int64)
    first = torch.cumsum(counts_flat, 0) - counts_flat
    a_flat = torch.repeat_interleave(
        torch.arange(counts_flat.shape[0], device=dev), counts_flat, output_size=total
    )
    offset = torch.arange(total, device=dev) - first[a_flat]
    bkt = a_flat // cap_a
    a_slot = a_flat % cap_a
    b_slot = lo.reshape(-1).to(torch.int64)[a_flat] + offset
    if a_order is not None:
        a_slot = a_order[bkt, a_slot].to(torch.int64)
    if b_order is not None:
        b_slot = b_order[bkt, b_slot].to(torch.int64)
    return a_starts[bkt] + a_slot, b_starts[bkt] + b_slot


def classed_pairs(plan: ClassedJoinPlan, ranges: ClassedRanges) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate (li, ri) pairs in BUCKET-MAJOR order (ascending bucket id;
    within a bucket, probe-side sorted-slot order) — the order of the JAX
    package's `classed_pairs` :987, whatever class a bucket landed in."""
    dev = plan.l_vals.device
    per_bucket = torch.zeros(plan.num_buckets, dtype=torch.int64, device=dev)
    seg_out = []
    for seg, (lo, counts, swapped, seg_total) in zip(plan.segments, ranges.segments):
        if seg_total == 0:
            continue
        a, b = (seg.r, seg.l) if swapped else (seg.l, seg.r)
        ai, bi = _expand(lo, counts, a.starts, b.starts, a.order, b.order, seg_total)
        li, ri = (bi, ai) if swapped else (ai, bi)
        ids = torch.as_tensor(seg.ids, device=dev)
        tots = counts.sum(dim=1, dtype=torch.int64)[: len(seg.ids)]
        per_bucket[ids] = tots
        seg_out.append((ids, li, ri, tots))
    for b, li_o, _ri_o in ranges.outliers:
        per_bucket[b] = len(li_o)
    out_starts = torch.zeros(plan.num_buckets + 1, dtype=torch.int64, device=dev)
    out_starts[1:] = torch.cumsum(per_bucket, 0)
    li_all = torch.empty(ranges.total, dtype=torch.int64, device=dev)
    ri_all = torch.empty(ranges.total, dtype=torch.int64, device=dev)
    for ids, li, ri, tots in seg_out:
        first = torch.cumsum(tots, 0) - tots
        pos = torch.repeat_interleave(out_starts[ids] - first, tots, output_size=li.shape[0])
        pos = pos + torch.arange(li.shape[0], device=dev)
        li_all[pos] = li
        ri_all[pos] = ri
    if ranges.outliers:
        host_starts = out_starts.cpu().numpy()
        for b, li_o, ri_o in ranges.outliers:
            s = int(host_starts[b])
            li_all[s : s + len(li_o)] = torch.as_tensor(li_o, device=dev)
            ri_all[s : s + len(ri_o)] = torch.as_tensor(ri_o, device=dev)
    return li_all, ri_all

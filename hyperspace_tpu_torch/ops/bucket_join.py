"""Co-bucketed merge join: every bucket pair in one probe, in one of two layouts.

Counterpart of `hyperspace_tpu/ops/bucket_join.py`. Both join sides arrive
hash-partitioned into the same buckets (the covering indexes were built with
the same hash), so bucket b of the left joins only bucket b of the right. The
bucket axis becomes a batch dimension. In value mode (one numeric null-free
key, buckets already sorted by it at build time) the rows are the key values
and need no sort; in hash mode they are `key64` hashes and each row is sorted
by kernel K1 (`cuda_sort.sort_rows`). Kernel K2 (`cuda_probe.range_probe`)
range-probes the smaller-capacity side into the larger.

The size-classed layout (the default, `size_classes_enabled()`):

1. `joint_partition` groups the buckets that are non-empty on both sides into
   classes by the power-of-two capacity of their two sides; buckets far above
   the median leave the padded layout and merge on the host (outliers).
2. `_build_side` scatters each class's rows into a padded [B, cap] matrix.
3. `probe_classed` probes each class, oriented class by class.
4. `classed_pairs` expands the ranges into (left_row, right_row) candidate
   pairs in bucket-major order, with torch ops on the tables' device.

The dense layout (`HYPERSPACE_JOIN_SIZE_CLASSES=0`, or the planner's decision
against classes): each side is one `PaddedBuckets`, every bucket padded to
the side's largest (`pad_buckets_by_value`, `pad_buckets_by_hash`), probed in
one orientation for all buckets (`probe_orientation`) and expanded by
`probe_padded` in the JAX package's `_expand_np` order.

A star join's fact was never bucketed on a dimension's keys: its rows are
hashed into the dimension's buckets and laid out in their order on the fly
(`fact_bucket_layout`), and such a pair always pads by hash.

`pad_buckets_by_codes` and `probe_code_ranges` are the packed code-mode reps
of one low-cardinality string key (kernels K4 and K5). As in the JAX package,
they are an ops-level API that no engine operator calls yet.

The JAX package builds the padded matrices on the host with numpy on its CPU
backend and with jitted programs on a TPU; the port has one path, torch ops on
the session's device, and only the kernels' wrappers tell CPU from CUDA.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..engine.packed_codes import lanes_per_word, pack_rows, probe_bits_for_cardinality
from .cuda_packed_probe import probe_packed
from .cuda_packed_sort import sort_codes_packed
from .cuda_probe import range_probe
from .cuda_sort import sort_rows
from ..telemetry import device_observatory as _devobs
from .join import host_merge_pairs

_PAD = torch.iinfo(torch.int64).max

#: A bucket whose larger side exceeds this many times the median of the
#: active buckets' larger sides merges on the host (`_outlier_factor` :58:
#: `HYPERSPACE_JOIN_OUTLIER_FACTOR`, 8 when unset; 0 or less: no outliers).
ENV_OUTLIER_FACTOR = "HYPERSPACE_JOIN_OUTLIER_FACTOR"
OUTLIER_FACTOR = 8.0
_MAX_CLASSES = 8


#: The size-classed layout's gate (`size_classes_enabled` :46): "0" runs a
#: co-bucketed binary join in the dense layout and keeps a star query on the
#: cascade.
ENV_SIZE_CLASSES = "HYPERSPACE_JOIN_SIZE_CLASSES"


def size_classes_enabled() -> bool:
    """The flag when set ("0" off), else the planner's decision, else on."""
    raw = os.environ.get(ENV_SIZE_CLASSES, "")
    if raw != "":
        return raw != "0"
    from ..plananalysis.planner import decided_value

    decided = decided_value("join_size_classes")
    return True if decided is None else bool(decided)


def _outlier_factor() -> float:
    raw = os.environ.get(ENV_OUTLIER_FACTOR, "")
    try:
        return float(raw) if raw else OUTLIER_FACTOR
    except ValueError:
        return OUTLIER_FACTOR


def mesh_probe_skew_safe(l_starts, r_starts) -> bool:
    """Whether the mesh's sharded probe should take this bucket layout
    (bucket_join.py:72). It pads every bucket to the largest one, so one
    outlier bucket multiplies every shard's probe: a layout with an outlier
    by the size-classed executor's own criterion stays on that executor.
    With size classes off, or no outlier criterion, always."""
    if not size_classes_enabled():
        return True
    l_lens = np.diff(np.asarray(l_starts, np.int64))
    r_lens = np.diff(np.asarray(r_starts, np.int64))
    n = min(len(l_lens), len(r_lens))
    l_lens, r_lens = l_lens[:n], r_lens[:n]
    active = np.nonzero((l_lens > 0) & (r_lens > 0))[0]
    factor = _outlier_factor()
    if len(active) == 0 or factor <= 0:
        return True
    mx = np.maximum(l_lens, r_lens)[active]
    return bool(mx.max(initial=0) <= factor * max(float(np.median(mx)), 1.0))


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

    @property
    def nbytes(self) -> int:
        """Device bytes the plan holds (its charge to the join memos)."""
        sides = [s for seg in self.segments for s in (seg.l, seg.r)]
        parts = [self.l_vals, self.r_vals] + [
            t for s in sides for t in (s.keys, s.lengths, s.order, s.starts) if t is not None
        ]
        return sum(int(t.nbytes) for t in parts)


class ClassedRanges:
    """Probe output of a classed plan: per segment (lo, counts, swapped,
    seg_total), plus the outlier buckets' global candidate pairs. `total`
    counts every candidate pair (exact matches in value mode)."""

    def __init__(self, segments, outliers, total: int):
        self.segments = segments
        self.outliers = outliers
        self.total = total

    @property
    def nbytes(self) -> int:
        """Bytes the ranges hold (their charge to the join memos)."""
        n = sum(int(lo.nbytes) + int(counts.nbytes) for lo, counts, _, _ in self.segments)
        return n + sum(int(li.nbytes) + int(ri.nbytes) for _, li, ri in self.outliers)


def joint_partition(l_starts: np.ndarray, r_starts: np.ndarray) -> Tuple[List[np.ndarray], np.ndarray]:
    """Classes (ascending id arrays) and outlier ids of the buckets with rows on
    both sides — a pure function of the two offset arrays (bucket_join.py:731)."""
    l_lens = np.diff(np.asarray(l_starts, np.int64))
    r_lens = np.diff(np.asarray(r_starts, np.int64))
    active = np.nonzero((l_lens > 0) & (r_lens > 0))[0]
    if len(active) == 0:
        return [], np.empty(0, np.int64)
    mx = np.maximum(l_lens, r_lens)[active]
    factor = _outlier_factor()
    if factor > 0:
        out_mask = mx > factor * max(float(np.median(mx)), 1.0)
    else:
        out_mask = np.zeros(len(active), bool)
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
    rows, item = int(lens.sum()), vals.element_size()
    _devobs.record_pad("join_class", rows * item, (b_pad * cap - rows) * item)
    padded = _pad_scatter(vals, gstarts, lens_t, cap)
    if mode == "hash":
        # Hash keys sort within each row (K1); value rows are sorted already.
        keys, order = sort_rows(padded)
        return _ClassSide(keys, lens_t, order, gstarts, cap)
    return _ClassSide(padded, lens_t, None, gstarts, cap)


def fact_bucket_layout(bucket_ids: torch.Tensor, num_buckets: int) -> Tuple[torch.Tensor, np.ndarray]:
    """Bucket-order layout of a probe side that was never bucketed on a star
    dimension's keys (`fact_bucket_layout` :872): `perm` reorders its rows
    stably into ascending bucket order, and `starts` (host, num_buckets + 1)
    bound each bucket's slice, the (rows, starts) contract
    `build_classed_plan` takes of a bucketed index. Stability keeps each
    bucket's rows in table order, so repeated probes and the pair memos
    agree."""
    bid = bucket_ids.to(torch.int64)
    perm = torch.sort(bid, stable=True).indices
    starts = np.zeros(num_buckets + 1, np.int64)
    np.cumsum(torch.bincount(bid, minlength=num_buckets).cpu().numpy(), out=starts[1:])
    return perm, starts


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


# ---------------------------------------------------------------------------
# The dense layout: one [B, cap] matrix a side, every bucket padded to the
# side's largest (`HYPERSPACE_JOIN_SIZE_CLASSES=0`)
# ---------------------------------------------------------------------------


class PaddedBuckets:
    """One side of a co-bucketed join in the dense layout
    (`bucket_join.py:277`): `keys` [B, cap] sorted within each row (pads at
    the dtype's max), `lengths` [B] valid counts, `order` [B, cap] sorted
    slot -> storage slot (None in value mode, where storage order is sorted
    order), `starts` the host bucket offsets [B + 1]. The engine keeps it per
    table, so a steady-state join starts at the probe."""

    __slots__ = ("keys", "lengths", "order", "starts", "mode")

    def __init__(self, keys, lengths, order, starts, mode: str):
        self.keys = keys
        self.lengths = lengths
        self.order = order
        self.starts = starts
        self.mode = mode  # "value" | "hash"

    @property
    def nbytes(self) -> int:
        """Bytes the rep holds (its charge to the device-cache budget)."""
        return sum(int(getattr(a, "nbytes", 0) or 0) for a in (self.keys, self.lengths, self.order, self.starts))


def _record_bucket_pad(rows: int, num_buckets: int, cap: int, itemsize: int) -> None:
    """The padding of one dense [B, cap] key matrix (`bucket_join.py:342`)."""
    _devobs.record_pad("join_buckets", rows * itemsize, (num_buckets * cap - rows) * itemsize)


def _dense_scatter(vals: torch.Tensor, starts_np: np.ndarray, cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every bucket of a side scattered into one unsorted [B, cap] matrix,
    and the bucket lengths [B] on the rows' device."""
    dev = vals.device
    lens = torch.as_tensor(np.diff(starts_np), device=dev)
    return _pad_scatter(vals, torch.as_tensor(starts_np[:-1], device=dev), lens, cap), lens


def pad_buckets_by_value(vals: torch.Tensor, starts_np) -> Optional[PaddedBuckets]:
    """The value-direct dense rep of a side whose buckets the index build
    sorted by its one numeric null-free key (`bucket_join.py:304`): no hash,
    no sort. None when the side does not qualify, and the caller pads by
    hash: no rows, a NaN key (even a singleton bucket's, which no
    sortedness check sees: a probe would match NaN with NaN), or a bucket
    that is not sorted (several files a bucket after a refresh or a Hybrid
    Scan append). -0.0 is stored as +0.0; pads are the dtype's max."""
    starts_np = np.asarray(starts_np, np.int64)
    num_buckets = len(starts_np) - 1
    lens = np.diff(starts_np)
    if num_buckets == 0 or lens.max(initial=0) == 0:
        return None
    canon = value_mode_vals(vals, starts_np)
    if canon is None:
        return None
    cap = _cap_pow2(int(lens.max()))
    keys, lengths = _dense_scatter(canon, starts_np, cap)
    _record_bucket_pad(int(starts_np[-1]), num_buckets, cap, canon.element_size())
    return PaddedBuckets(keys, lengths, None, starts_np, "value")


def pad_buckets_by_hash(key64: torch.Tensor, starts_np) -> PaddedBuckets:
    """The hash-key dense rep (`bucket_join.py:351`): the keys nudged below
    the pad, scattered into [B, cap = pow2(largest bucket)] and each row
    sorted by kernel K1, with its sorted slot -> storage slot order. Past
    K1's index range (rows * cap >= 2**31) the kernel's wrapper raises on
    the card: there is no other sort to fall back to."""
    starts_np = np.asarray(starts_np, np.int64)
    num_buckets = len(starts_np) - 1
    cap = _cap_pow2(int(np.diff(starts_np).max())) if num_buckets else 1
    padded, lengths = _dense_scatter(torch.clamp(key64, max=_PAD - 1), starts_np, cap)
    keys, order = sort_rows(padded)
    _record_bucket_pad(int(starts_np[-1]), num_buckets, cap, 8)
    return PaddedBuckets(keys, lengths, order, starts_np, "hash")


def probe_orientation(left: PaddedBuckets, right: PaddedBuckets):
    """(probe side, build side, swapped) of a dense pair (`bucket_join.py:387`):
    the smaller capacity probes into the larger; on a tie the left probes."""
    if left.keys.shape[1] > right.keys.shape[1]:
        return right, left, True
    return left, right, False


def probe_padded(left: PaddedBuckets, right: PaddedBuckets, ranges=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate (li, ri) pairs of a dense pair in one mode (`bucket_join.py:1074`):
    K2's (lo, counts) in `probe_orientation`'s orientation (or `ranges`, the
    engine's probe memo), expanded in flat (bucket, probe slot) order, each
    probe slot's matches in the build side's sorted order."""
    if left.mode != right.mode:
        raise ValueError(f"mixed padded modes: {left.mode} vs {right.mode}")
    a, b, swapped = probe_orientation(left, right)
    if ranges is None:
        ak, bk = probe_keys_promoted(a.keys, b.keys)
        ranges = probe_ranges(ak, bk, a.lengths, b.lengths)
    lo, counts = ranges
    dev = counts.device
    total = int(counts.sum(dtype=torch.int64))
    if total == 0:
        empty = torch.empty(0, dtype=torch.int64, device=dev)
        return empty, empty
    a_starts = torch.as_tensor(a.starts[:-1], device=dev)
    b_starts = torch.as_tensor(b.starts[:-1], device=dev)
    ai, bi = _expand(lo, counts, a_starts, b_starts, a.order, b.order, total)
    return (bi, ai) if swapped else (ai, bi)


# ---------------------------------------------------------------------------
# Packed code-mode padded reps (sub-byte dictionary codes)
# ---------------------------------------------------------------------------
#
# A single string key of at most 13 distinct values needs no 64-bit hash: its
# dictionary codes order-embed the equality, and they pack 1, 2 or 4 bits a
# lane into 32-bit words (`engine/packed_codes.py`). The resident padded
# matrices stay packed (`packed_codes.pack_rows`, the JAX package's
# `_pack_code_rows` :507); K4 sorts them and K5 probes them word-packed.


class PackedCodeBuckets:
    """Packed twin of a padded class side (`bucket_join.py:458`): `words`
    [B, cap / lpw] (int32 tensors carrying 32 bits) of sorted BIASED codes
    (code + 1; pads at the top lane value), `bits` the lane width, `lengths`
    [B] valid counts, `order` [B, cap] sorted slot -> storage slot, `starts`
    the host bucket offsets."""

    __slots__ = ("words", "bits", "lengths", "order", "starts", "cap")

    def __init__(self, words, bits: int, lengths, order, starts, cap: int):
        self.words = words
        self.bits = bits
        self.lengths = lengths
        self.order = order
        self.starts = starts
        self.cap = cap


def _pad_scatter_codes(codes: torch.Tensor, starts: torch.Tensor, num_buckets: int, cap: int, bits: int):
    """Raw codes (null = -1) of consecutive buckets -> an UNSORTED [B, cap]
    int32 matrix of biased codes padded with 2**bits - 1, and the bucket
    lengths (`bucket_join.py:482`)."""
    n = codes.shape[0]
    pos = torch.arange(n, device=codes.device)
    b_of_row = torch.searchsorted(starts, pos, right=True) - 1
    slot = pos - starts[b_of_row]
    padded = torch.full((num_buckets, cap), (1 << bits) - 1, dtype=torch.int32, device=codes.device)
    padded[b_of_row, slot] = codes.to(torch.int32) + 1
    return padded, starts[1:] - starts[:-1]


def _pad_and_sort_codes(codes: torch.Tensor, starts: torch.Tensor, num_buckets: int, cap: int, bits: int):
    """The reference twin of the K4 route (`bucket_join.py:498`): scatter,
    then a stable argsort of the flat biased matrix. (sorted, order, lengths)."""
    padded, lengths = _pad_scatter_codes(codes, starts, num_buckets, cap, bits)
    order = torch.sort(padded, dim=1, stable=True).indices
    return padded.gather(1, order), order.to(torch.int32), lengths


def pad_buckets_by_codes(
    codes, starts_np: np.ndarray, cardinality: int, has_nulls: bool = False
) -> Optional[PackedCodeBuckets]:
    """Packed code-mode rep of a single low-cardinality string key whose rows
    lie bucket after bucket (`bucket_join.py:520`); each row sorted by K4.
    None when the key does not qualify: nulls present (null semantics belong
    to the hash path), a cardinality past the 4-bit sort/probe class, or no
    rows."""
    if has_nulls:
        return None
    bits = probe_bits_for_cardinality(int(cardinality))
    if bits is None:
        return None
    starts_np = np.asarray(starts_np, np.int64)
    num_buckets = len(starts_np) - 1
    lens = np.diff(starts_np)
    if num_buckets == 0 or lens.max(initial=0) == 0:
        return None
    cap = max(_cap_pow2(int(lens.max())), lanes_per_word(bits))
    codes = torch.as_tensor(codes)
    starts = torch.as_tensor(starts_np, device=codes.device)
    padded, lengths = _pad_scatter_codes(codes, starts, num_buckets, cap, bits)
    sorted_codes, order = sort_codes_packed(pack_rows(padded, bits), bits)
    words = pack_rows(sorted_codes, bits)
    rows = int(starts_np[-1])
    _devobs.record_pad("join_buckets", -(-rows * bits // 8), -(-(num_buckets * cap - rows) * bits // 8))
    return PackedCodeBuckets(words, bits, lengths, order, starts_np, cap)


def probe_code_ranges(l: PackedCodeBuckets, r: PackedCodeBuckets) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, counts) of two packed code reps by K5 (`bucket_join.py:578`)."""
    if l.bits != r.bits:
        raise ValueError(f"packed rep bits mismatch: {l.bits} != {r.bits}")
    return probe_packed(l.words, r.words, l.bits, l.lengths, r.lengths)

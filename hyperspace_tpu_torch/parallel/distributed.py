"""The build's all-to-all exchange and the co-bucketed join's per-shard counts
(counterpart of `hyperspace_tpu/parallel/distributed.py`).

The build's `repartition(numBuckets, cols)` is a two-pass exchange with
static shapes, as in the JAX package:

1. count: each shard counts its rows per destination device, an
   [n_dev, n_dev] host matrix (`exchange_counts`);
2. the capacity `cap` is its largest entry, pow2-quantized
   (`mesh.quantize_cap`);
3. exchange: each shard sorts its rows stably by destination, scatters every
   lane into an [n_dev, cap] send matrix, and `all_to_all` hands device d
   the d-th row of every sender's matrix; then each shard sorts what it
   received by (valid first, bucket, sort keys..., receive position).

Device d ends up owning buckets [d*B/n, (d+1)*B/n), grouped and sorted. The
receive position is the global row order (every sender holds a contiguous
block of rows and the destination sort is stable), so the order is the
engine's canonical stable build order and a mesh-built index file is
byte-identical to a single-device one. The receive-side sort is the port's
build sort on each shard's valid rows (`ops.partition`: K1's composites for
one integer key of at most 32,768 rows, K3's packed composites for one
string key that packs, else the stable chain), which orders floats as
`lax.sort` does (-0.0 ties 0.0, NaNs tie after +inf).

`all_to_all` is plain tensor code, as the JAX package's is an XLA
collective and not a kernel: `send[s][d].to(devices[d], non_blocking=True)`,
a peer copy over NVLink between two cards and no copy at all between two
shards of one device.

The coded twins (`exchange_counts_coded`, `distributed_bucketize_coded`,
`HYPERSPACE_ENCODED_DEVICE`) move narrow lanes (a bucket lane in the
smallest width `num_buckets` fits, int8 validity, int32 row ids, narrow
dictionary codes) and, under `HYPERSPACE_PACKED_CODES`, bit-pack marked
lanes into 32-bit words after the scatter (`engine/packed_codes.py`). Every
sort operand carries the flat path's values, so the result is the same and
only `parallel.exchange.bytes_moved` shrinks.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..engine.packed_codes import pack_rows, unpack_rows
from ..ops.cuda_probe import range_probe
from ..ops.partition import composite_build_sort, packed_build_sort, sort_perm
from ..telemetry import device_observatory as _devobs
from ..telemetry import metrics as _metrics
from ..telemetry import stage_ledger as _stage_ledger
from .mesh import Mesh, quantize_cap, shard_rows

#: Packed wire lanes ride 32-bit words (`engine/packed_codes.py` layout).
_WORD_BITS = 32
_M32 = 0xFFFFFFFF
#: The JAX package's hash lane is uint32.
_H1_ITEMSIZE = 4

#: Traffic of the all-to-all (ticked once an exchange, on the host):
#: payload = the real rows' bytes, moved = the padded send matrices' bytes.
_EXCHANGE_ROWS = _metrics.counter("parallel.exchange.rows")
_EXCHANGE_BYTES_PAYLOAD = _metrics.counter("parallel.exchange.bytes_payload")
_EXCHANGE_BYTES_MOVED = _metrics.counter("parallel.exchange.bytes_moved")
_EXCHANGES = _metrics.counter("parallel.exchange.count")

Shards = List[torch.Tensor]


def all_to_all(mesh: Mesh, sends: Shards) -> Shards:
    """`lax.all_to_all(split_axis=0, concat_axis=0)` over the bucket axis:
    sender s holds an [n_dev, ...] matrix on device s, and receiver d gets
    the stack of every sender's row d on device d (row s from sender s)."""
    return [
        torch.stack([send[d].to(dev, non_blocking=True) for send in sends])
        for d, dev in enumerate(mesh.devices)
    ]


def _u32(h1: torch.Tensor) -> torch.Tensor:
    """A uint32 hash lane (int64 holding it, or int32 carrying its bits) as
    int64 values in [0, 2**32)."""
    return h1.to(torch.int64) & _M32


def _dest_of(bucket: torch.Tensor, num_buckets: int, n_dev: int) -> torch.Tensor:
    return bucket.to(torch.int64) * n_dev // num_buckets


def _counts(mesh: Mesh, buckets: Shards, num_buckets: int) -> np.ndarray:
    n_dev = mesh.size
    rows = [torch.bincount(_dest_of(b, num_buckets, n_dev), minlength=n_dev).cpu() for b in buckets]
    return torch.stack(rows).numpy().astype(np.int32)


def exchange_counts(mesh: Mesh, h1, num_buckets: int) -> np.ndarray:
    """Pass 1: the [n_dev, n_dev] matrix of rows device i sends to device j
    (distributed.py:86). `h1` is the uint32 row hash, global or sharded."""
    return _counts(mesh, [_u32(h) % num_buckets for h in shard_rows(mesh, h1)], num_buckets)


def exchange_counts_coded(mesh: Mesh, bucket, num_buckets: int) -> np.ndarray:
    """Pass 1 over a pre-computed (narrow) bucket-id lane (distributed.py:268)."""
    return _counts(mesh, shard_rows(mesh, bucket), num_buckets)


def _record_exchange(n_valid: int, n_dev: int, cap: int, itemsizes: Sequence[int], packed_spec=None) -> None:
    """The traffic of one exchange (distributed.py:147): each lane moves an
    [n_dev, n_dev, cap] matrix of its item size, a packed lane its 32-bit
    words, and carries `n_valid` rows of payload (a packed lane its bits)."""
    _EXCHANGES.inc()
    _EXCHANGE_ROWS.inc(int(n_valid))
    payload = moved = 0
    for i, item in enumerate(itemsizes):
        bits = packed_spec[i][0] if packed_spec is not None else 0
        if bits:
            payload += -(-int(n_valid) * bits // 8)
            moved += n_dev * n_dev * (cap * bits // _WORD_BITS) * 4
        else:
            payload += int(n_valid) * int(item)
            moved += n_dev * n_dev * cap * int(item)
    _EXCHANGE_BYTES_PAYLOAD.inc(payload)
    _EXCHANGE_BYTES_MOVED.inc(moved)
    _devobs.record_pad("mesh_exchange", payload, moved - payload)


class _Route:
    """One shard's stable destination sort: row `order[i]` goes to slot
    `slot[i]` of destination `dest[i]`."""

    __slots__ = ("order", "dest", "slot")

    def __init__(self, bucket: torch.Tensor, num_buckets: int, n_dev: int):
        dest = _dest_of(bucket, num_buckets, n_dev)
        self.order = torch.sort(dest, stable=True).indices  # ties keep the global row order
        self.dest = dest[self.order]
        starts = torch.searchsorted(self.dest, torch.arange(n_dev, device=dest.device))
        self.slot = torch.arange(dest.shape[0], device=dest.device) - starts[self.dest]

    def scatter(self, col: torch.Tensor, n_dev: int, cap: int) -> torch.Tensor:
        send = torch.zeros((n_dev, cap), dtype=col.dtype, device=col.device)
        send[self.dest, self.slot] = col[self.order]
        return send


def _exchange_lane(mesh: Mesh, routes: List[_Route], lane: Shards, cap: int, spec=(0, 0)) -> Shards:
    """One lane scattered, exchanged and flattened to [n_dev * cap] a shard.
    A packed lane (`spec` = (bits, bias)) crosses as 32-bit words: biased
    so the null code -1 lands on 0, packed after the scatter and unpacked to
    the same values on the receive side (pad slots scatter as 0 and come
    back 0)."""
    n_dev = mesh.size
    sends = [r.scatter(c, n_dev, cap) for r, c in zip(routes, lane)]
    bits, bias = spec
    if not bits:
        return [m.reshape(-1) for m in all_to_all(mesh, sends)]
    words = [pack_rows(s.to(torch.int32) + bias if bias else s, bits) for s in sends]
    out = []
    for recv, col in zip(all_to_all(mesh, words), lane):
        vals = unpack_rows(recv.reshape(n_dev, -1), bits)
        out.append((vals - bias if bias else vals).to(col.dtype).reshape(-1))
    return out


def _shard_sort(bucket: torch.Tensor, keys: Sequence[torch.Tensor], num_buckets: int,
                key_cards: Sequence[Optional[int]]) -> torch.Tensor:
    """The permutation ordering one shard's valid rows by (bucket, keys...,
    receive position): the build's own routes (`partition._bucket_key_sort`)."""
    if len(keys) == 1:
        card = key_cards[0] if key_cards else None
        if card is not None:
            res = packed_build_sort(bucket, keys[0], card, num_buckets)
        else:
            res = composite_build_sort(bucket, keys[0], int(keys[0].shape[0]), num_buckets)
        if res is not None:
            return res[0].long()
    return sort_perm(bucket, list(keys))


def _receive_sort(valid: torch.Tensor, bucket: torch.Tensor, keys: Sequence[torch.Tensor], num_buckets: int,
                  key_cards) -> torch.Tensor:
    """One shard's receive-side order (distributed.py:117-133): its valid
    slots by (bucket, keys..., receive position), then the invalid slots."""
    ok = valid != 0
    valid_idx = torch.nonzero(ok).squeeze(1)
    perm = _shard_sort(bucket[valid_idx], [k[valid_idx] for k in keys], num_buckets, key_cards)
    return torch.cat([valid_idx[perm], torch.nonzero(~ok).squeeze(1)])


def _exchange(mesh: Mesh, first: Shards, valid: Shards, payload, keys, num_buckets: int, cap: int, bucket_of,
              sort_from_payload=(), spec=(), key_cards=()):
    """The exchange pass both variants share: route on `bucket_of(first)`,
    move (first, valid, *payload, *keys), sort each shard's receipt (with
    payload lanes `sort_from_payload` as the leading sort keys). Returns
    per-shard (bucket ids int32, valid int32, [payload lanes])."""
    n_dev = mesh.size
    routes = [_Route(bucket_of(x), num_buckets, n_dev) for x in first]
    lanes = [first, valid, *payload, *keys]
    recv = [_exchange_lane(mesh, routes, lane, cap, spec[i] if i < len(spec) else (0, 0))
            for i, lane in enumerate(lanes)]
    r_first, r_valid, r_payload, r_keys = recv[0], recv[1], recv[2:2 + len(payload)], recv[2 + len(payload):]
    out_bucket, out_valid, out_payload = [], [], [[] for _ in payload]
    for d in range(n_dev):
        b = bucket_of(r_first[d]).to(torch.int32)
        v = r_valid[d].to(torch.int32)
        sort_lanes = [r_payload[i][d] for i in sort_from_payload] + [k[d] for k in r_keys]
        perm = _receive_sort(v, b, sort_lanes, num_buckets, key_cards)
        out_bucket.append(b[perm])
        out_valid.append(v[perm])
        for i, lane in enumerate(r_payload):
            out_payload[i].append(lane[d][perm])
    return out_bucket, out_valid, out_payload


def exchange_rows(mesh: Mesh, h1, payload: Sequence, sort_keys: Sequence, num_buckets: int, cap: int,
                  in_valid=None, n_valid=None, key_cards: Sequence[Optional[int]] = ()):
    """Pass 2 (distributed.py:176): the all-to-all and each shard's sort.

    `in_valid` (0/1 a row, sharded like `h1`) marks padding rows that make
    the global row count divide the mesh: they travel but come out with
    valid 0, sorted last. `n_valid`, the real row count, feeds the traffic
    counters (a call without `in_valid` counts every row). `key_cards`
    names the dictionary cardinality of a single string sort key, for the
    shard sort's packed route. Returns per-shard (bucket ids, valid,
    [payload lanes]), each [n_dev * cap]: device d's bucket range, its valid
    rows first in (bucket, sort keys...) order."""
    with _stage_ledger.stage_scope("exchange"):
        h1 = shard_rows(mesh, h1)
        if in_valid is None:
            in_valid = [torch.ones(h.shape, dtype=torch.int32, device=h.device) for h in h1]
            if n_valid is None:
                n_valid = sum(int(h.shape[0]) for h in h1)
        valid = shard_rows(mesh, in_valid)
        payload = [shard_rows(mesh, p) for p in payload]
        keys = [shard_rows(mesh, k) for k in sort_keys]
        if n_valid is not None:
            sizes = [_H1_ITEMSIZE, valid[0].element_size()]
            sizes += [lane[0].element_size() for lane in payload + keys]
            _record_exchange(n_valid, mesh.size, cap, sizes)
        # The hash crosses as its 32 bits; each side takes the bucket of it.
        wire = [h.to(torch.int32) for h in h1]
        return _exchange(mesh, wire, valid, payload, keys, num_buckets, cap,
                         lambda h: _u32(h) % num_buckets, key_cards=key_cards)


def distributed_bucketize(mesh: Mesh, h1, payload: Sequence, sort_keys: Sequence, num_buckets: int,
                          in_valid=None, n_valid=None, key_cards: Sequence[Optional[int]] = ()):
    """Both passes (distributed.py:215): rows arrive sharded over the mesh,
    and come back as (bucket ids, valid, payload) blocks, one bucket range
    a device."""
    counts = exchange_counts(mesh, h1, num_buckets)
    cap = quantize_cap(int(counts.max()) if counts.size else 0)
    return exchange_rows(mesh, h1, payload, sort_keys, num_buckets, cap, in_valid, n_valid, key_cards)


def distributed_bucketize_coded(mesh: Mesh, bucket, payload: Sequence, sort_keys: Sequence, num_buckets: int,
                                in_valid, n_valid: int, sort_from_payload: Sequence[int] = (),
                                packed_spec: Sequence[Tuple[int, int]] = (),
                                key_cards: Sequence[Optional[int]] = ()):
    """Both passes over narrow lanes (distributed.py:384): `bucket` is the
    pre-computed h1 % num_buckets in its smallest width, `in_valid` int8,
    `sort_from_payload` names payload lanes that are sort keys too (sent
    once), and `packed_spec`, aligned with (bucket, valid, *payload,
    *sort_keys), bit-packs the marked lanes across the wire. The output
    matches `distributed_bucketize`'s: int32 bucket ids and validity, payload
    lanes in their input dtypes."""
    with _stage_ledger.stage_scope("exchange"):
        counts = exchange_counts_coded(mesh, bucket, num_buckets)
        cap = quantize_cap(int(counts.max()) if counts.size else 0)
        spec = tuple(tuple(s) for s in packed_spec)
        for bits, _bias in spec:
            if bits and (_WORD_BITS % bits or cap % (_WORD_BITS // bits)):
                raise ValueError(f"a {bits}-bit wire lane does not pack a capacity of {cap}")
        bucket = shard_rows(mesh, bucket)
        valid = shard_rows(mesh, in_valid)
        payload = [shard_rows(mesh, p) for p in payload]
        keys = [shard_rows(mesh, k) for k in sort_keys]
        sizes = [lane[0].element_size() for lane in [bucket, valid, *payload, *keys]]
        _record_exchange(n_valid, mesh.size, cap, sizes, packed_spec=spec or None)
        return _exchange(mesh, bucket, valid, payload, keys, num_buckets, cap, lambda b: b,
                         tuple(sort_from_payload), spec, key_cards)


def distributed_bucketed_join_counts(mesh: Mesh, l_sorted_keys, r_sorted_keys, l_len, r_len) -> torch.Tensor:
    """Per-bucket match counts of co-located padded bucket matrices [B, cap]
    sharded over the bucket axis (distributed.py:447): kernel K2 on each
    shard, with no data crossing between shards. Returns int64 [B] on the
    left keys' device."""
    home = l_sorted_keys.device
    parts = zip(*(shard_rows(mesh, x) for x in (l_sorted_keys, r_sorted_keys, l_len, r_len)))
    out = []
    for ls, rs, ll, rl in parts:
        _lo, counts = range_probe(ls, rs, ll, rl)
        out.append(counts.sum(dim=1, dtype=torch.int64).to(home))
    return torch.cat(out)


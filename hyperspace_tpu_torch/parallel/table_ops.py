"""Table-level mesh operations: the bridge between the engine's `Table`s and
the exchange in `distributed.py` (counterpart of
`hyperspace_tpu/parallel/table_ops.py`).

- `distributed_bucketize_perm` / `distributed_bucketize_table`: the build's
  shuffle (the reference's `repartition(numBuckets, cols)` and bucketed
  write, `CreateActionBase.scala:119-140`). Rows leave in row blocks, ride
  the all-to-all to their bucket's device and come back grouped by bucket
  and sorted within it. Same hash and same stable tie order as
  `ops.partition.bucketize_table`, so the index files are byte-identical.
- `distributed_exchange_table`: the general join's ShuffleExchange. Two
  tables exchanged on compatible keys over one mesh are co-partitioned, and
  their exchanged key blocks stay on the shards for the probe.
- `probe_dist_blocks` / `distributed_bucketed_join_pairs`: the co-bucketed
  probe, shard by shard with nothing crossing between shards: each shard
  pads its bucket block into [B_local, cap] matrices, sorts each row with
  kernel K1 (`cuda_sort.sort_rows`, stable, as `jnp.argsort` is in
  table_ops.py:404) and probes with kernel K2 (`cuda_probe.range_probe`).
  The pairs come out bucket-major, each bucket's in the stable order of its
  left keys' hashes, as the JAX package's `_expand_np` gives them.

The JAX package pads the hash inputs to the quantized row count before
hashing (its programs trace one shape a class). Here the hashes of the pad
rows are the hashes of the pad value 0, computed alike, so the count
matrix, the capacity and the traffic counters equal the JAX package's; only
the real rows' values decide the result.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..engine.table import Column, Table
from ..ops.bucket_join import _expand, _pad_scatter
from ..ops.cuda_probe import range_probe
from ..ops.cuda_sort import sort_rows
from ..ops.hashing import combined_hash_u32, key64
from ..telemetry import device_observatory as _devobs
from .distributed import distributed_bucketize, distributed_bucketize_coded
from .mesh import Mesh, quantize_cap, quantized_rows

_PAD = torch.iinfo(torch.int64).max


def _bucket_lane_dtype(num_buckets: int) -> torch.dtype:
    """Smallest signed width carrying bucket ids [0, num_buckets) (table_ops.py:51)."""
    if num_buckets <= 127:
        return torch.int8
    if num_buckets <= 32767:
        return torch.int16
    return torch.int32


def _coded_rowid_dtype(n_pad_total: int) -> torch.dtype:
    """int32 row ids whenever the padded global row count fits (table_ops.py:60)."""
    return torch.int32 if n_pad_total <= torch.iinfo(torch.int32).max else torch.int64


def _record_coded_stage(n_rows: int, flat_itemsizes, coded_lanes, packed_spec=None) -> None:
    """The encoded-vs-flat ledger entry of one exchange's wire lanes
    (table_ops.py:67): what the flat item sizes would stage against the
    narrow lanes, a packed lane at its bits."""
    flat = sum(n_rows * int(item) for item in flat_itemsizes)
    staged = packed = 0
    for i, lane in enumerate(coded_lanes):
        bits = packed_spec[i][0] if packed_spec is not None else 0
        if bits:
            lane_bytes = -(-n_rows * bits // 8)
            packed += lane_bytes
        else:
            lane_bytes = n_rows * lane.element_size()
        staged += lane_bytes
    _devobs.record_encoded_stage("mesh_exchange", flat, staged, packed_bytes=packed if packed else None)


def _packed_wire_spec(num_buckets: int, bucket: torch.Tensor, n_pad_total: int, rowid: torch.Tensor,
                      key_pairs=()) -> tuple:
    """Per-lane (bits, bias) wire spec in (bucket, valid, rowid, *keys)
    order, or () with the packed layer off (table_ops.py:91). A lane packs
    only where its wire class is narrower than its item; a string key whose
    codes were narrowed packs biased by 1, so the null code -1 lands on 0."""
    from ..engine.packed_codes import bits_for_cardinality, packed_codes_enabled, wire_bits_for_range

    if not packed_codes_enabled():
        return ()

    def lane(n_values, arr, bias=0):
        bits = wire_bits_for_range(n_values)
        if bits is None or bits >= 8 * arr.element_size():
            return (0, 0)
        return (bits, bias)

    spec = [lane(num_buckets, bucket), (1, 0), lane(n_pad_total, rowid)]
    for col, staged in key_pairs:
        bits = None
        if col.is_string and staged.dtype in (torch.int8, torch.int16):
            bits = bits_for_cardinality(len(col.dictionary))
        spec.append((bits, 1) if bits else (0, 0))
    return tuple(spec)


def _pad_rows(x: torch.Tensor, pad: int, fill=0) -> torch.Tensor:
    if pad == 0:
        return x
    return torch.cat([x, torch.full((pad,), fill, dtype=x.dtype, device=x.device)])


def _key_lane(col: Column, narrow: bool) -> torch.Tensor:
    """A sort key's lane (table_ops.py:136): narrow codes for a narrowable
    string column on the coded wire, bools as int32, else the data."""
    from ..engine.encoded_device import narrow_codes, narrowable

    a = narrow_codes(col) if narrow and narrowable(col) else col.data
    return a.to(torch.int32) if a.dtype == torch.bool else a


def _padded_hash_lanes(cols: Sequence[Column], pad: int) -> list:
    """The key columns with `pad` rows of value 0 (code 0) appended: the JAX
    package hashes its padded inputs, so its pad rows carry these hashes."""
    import dataclasses

    return [dataclasses.replace(c, data=_pad_rows(c.data, pad), validity=None) for c in cols]


def _valid_lane(n: int, pad: int, dtype: torch.dtype, device) -> torch.Tensor:
    valid = torch.ones(n + pad, dtype=dtype, device=device)
    valid[n:] = 0
    return valid


def _gather_valid(home, valid: List[torch.Tensor], *lanes: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each lane's valid slots, shard after shard, on `home` (table_ops.py:174).
    Device d's block holds its bucket range, so the concatenation is grouped
    by bucket."""
    keep = [v.to(torch.bool) for v in valid]
    return [torch.cat([x[k].to(home) for x, k in zip(lane, keep)]) for lane in lanes]


def _exchange_layout(mesh: Mesh, table: Table, key_columns: Sequence[str], num_partitions: int, with_k64: bool):
    """The exchange of `table`'s row ids (and key64) on the hash of its key
    columns into `num_partitions` buckets, through the coded wire under
    `HYPERSPACE_ENCODED_DEVICE` and the flat one otherwise. Returns the
    per-shard (bucket ids, valid, row ids, key64 or None)."""
    from ..engine.encoded_device import encoded_device_enabled

    n_dev = mesh.size
    n = table.num_rows
    dev = table.columns[next(iter(table.columns))].data.device
    cols = [table.column(c) for c in key_columns]
    n_pad_total = quantized_rows(n, n_dev)
    pad = n_pad_total - n
    lanes_p = _padded_hash_lanes(cols, pad)
    h1 = combined_hash_u32(lanes_p)
    k64 = key64(lanes_p) if with_k64 else None
    cards = [len(c.dictionary) if c.is_string else None for c in cols] if len(cols) == 1 else []
    if encoded_device_enabled():
        # Narrow lanes carrying the flat path's values: the bucket id in
        # place of the hash, int8 validity, int32 row ids where they fit,
        # narrow string codes; a join's key64 doubles as its sort key.
        bucket = (h1 % num_partitions).to(_bucket_lane_dtype(num_partitions))
        valid = _valid_lane(n, pad, torch.int8, dev)
        rowid = _pad_rows(torch.arange(n, dtype=_coded_rowid_dtype(n_pad_total), device=dev), pad)
        if with_k64:
            spec = _packed_wire_spec(num_partitions, bucket, n_pad_total, rowid)
            spec = spec + ((0, 0),) if spec else spec
            _record_coded_stage(n_pad_total, [4, 4, 8, 8, 8], [bucket, valid, rowid, k64], spec or None)
            b, v, (r, k) = distributed_bucketize_coded(
                mesh, bucket, [rowid, k64], [], num_partitions, valid, n, sort_from_payload=(1,),
                packed_spec=spec)
            return b, v, r, k
        keys = [_pad_rows(_key_lane(c, narrow=True), pad) for c in cols]
        spec = _packed_wire_spec(num_partitions, bucket, n_pad_total, rowid, list(zip(cols, keys)))
        flat_keys = [4 if c.data.dtype == torch.bool else c.data.element_size() for c in cols]
        _record_coded_stage(n_pad_total, [4, 4, 8, *flat_keys], [bucket, valid, rowid, *keys], spec or None)
        b, v, (r,) = distributed_bucketize_coded(mesh, bucket, [rowid], keys, num_partitions, valid, n,
                                                  packed_spec=spec, key_cards=cards)
        return b, v, r, None
    valid = _valid_lane(n, pad, torch.int32, dev)
    rowid = _pad_rows(torch.arange(n, dtype=torch.int64, device=dev), pad)
    if with_k64:
        b, v, (r, k) = distributed_bucketize(mesh, h1, [rowid, k64], [k64], num_partitions, valid, n)
        return b, v, r, k
    keys = [_pad_rows(_key_lane(c, narrow=False), pad) for c in cols]
    b, v, (r,) = distributed_bucketize(mesh, h1, [rowid], keys, num_partitions, valid, n, key_cards=cards)
    return b, v, r, None


def _starts_of(bucket_v: torch.Tensor, num_buckets: int) -> np.ndarray:
    edges = torch.arange(num_buckets + 1, dtype=bucket_v.dtype, device=bucket_v.device)
    return torch.searchsorted(bucket_v, edges).cpu().numpy().astype(np.int64)


def distributed_bucketize_perm(mesh: Mesh, table: Table, bucket_columns: Sequence[str],
                               num_buckets: int) -> Tuple[torch.Tensor, np.ndarray]:
    """(permutation on the table's device, host bucket starts) of the mesh
    build: `table.take(perm)` is grouped by bucket and sorted within it by
    (keys, original row), as `bucketize_table` orders it."""
    dev = table.columns[next(iter(table.columns))].data.device
    bucket, valid, rowid, _ = _exchange_layout(mesh, table, bucket_columns, num_buckets, with_k64=False)
    perm, bucket_v = _gather_valid(dev, valid, rowid, bucket)
    if len(perm) != table.num_rows:
        raise RuntimeError(f"the exchange dropped rows: {len(perm)} != {table.num_rows}")
    return perm.long(), _starts_of(bucket_v, num_buckets)


def distributed_bucketize_table(mesh: Mesh, table: Table, bucket_columns: Sequence[str],
                                num_buckets: int) -> Tuple[Table, np.ndarray]:
    """Mesh-wide hash-partition and in-bucket sort, a drop-in for
    `bucketize_table` (table_ops.py:186)."""
    perm, starts = distributed_bucketize_perm(mesh, table, bucket_columns, num_buckets)
    return table.take(perm), starts


class DistBlocks:
    """One join side's keys laid out on the mesh: `blocks[d]` holds device
    d's rows (its contiguous bucket range) as int64 keys on device d, in
    bucket order, pads at int64 max; `lstarts[d]` its local bucket offsets
    [B_local + 1] on device d; `starts_np` the global bucket offsets (padded
    to the mesh); `cap` the pow2-quantized largest bucket; `home` the device
    the pairs come back to. Built once a (table, mesh): a steady-state join
    probes it without moving its keys again."""

    __slots__ = ("blocks", "lstarts", "starts_np", "buckets_local", "cap", "home")

    def __init__(self, blocks, lstarts, starts_np, buckets_local, cap, home):
        self.blocks = blocks
        self.lstarts = lstarts
        self.starts_np = starts_np
        self.buckets_local = buckets_local
        self.cap = cap
        self.home = home

    @property
    def nbytes(self) -> int:
        return int(sum(t.nbytes for t in self.blocks) + sum(t.nbytes for t in self.lstarts) + self.starts_np.nbytes)


#: How many block layouts were built and how many probes ran: a cached
#: steady state probes without building.
DIST_JOIN_STATS = {"block_builds": 0, "probes": 0}
#: The last probe's shards: each one's device and the [B_local, cap] shapes
#: its K1 sorts (left, right) and its K2 probe takes (left into right).
LAST_PROBE: List[dict] = []


def _local_starts(starts_np: np.ndarray, n_dev: int, buckets_local: int) -> Tuple[np.ndarray, np.ndarray]:
    """(device row bounds [n_dev + 1], local bucket offsets [n_dev,
    B_local + 1]): device d owns buckets [d*B_local, (d+1)*B_local)
    (table_ops.py:431)."""
    bounds = starts_np[0::buckets_local][: n_dev + 1]
    local = np.zeros((n_dev, buckets_local + 1), dtype=np.int64)
    for d in range(n_dev):
        local[d] = starts_np[d * buckets_local: (d + 1) * buckets_local + 1] - bounds[d]
    return bounds, local


def pad_starts_to_mesh(starts_np: np.ndarray, n_dev: int) -> np.ndarray:
    """Empty virtual buckets appended so the bucket count divides the mesh
    (table_ops.py:490): 200 buckets on 8 shards become 208."""
    pad_b = (-(len(starts_np) - 1)) % n_dev
    if not pad_b:
        return starts_np
    return np.concatenate([starts_np, np.full(pad_b, starts_np[-1], dtype=starts_np.dtype)])


def _lstarts_on(mesh: Mesh, local: np.ndarray) -> List[torch.Tensor]:
    return [torch.as_tensor(local[d], device=dev) for d, dev in enumerate(mesh.devices)]


def build_dist_blocks(mesh: Mesh, keys: torch.Tensor, starts_np: np.ndarray) -> Optional[DistBlocks]:
    """Lay one side's key64 (bucket order) out on the mesh (table_ops.py:502);
    None when it has no buckets or no rows."""
    n_dev = mesh.size
    starts_np = pad_starts_to_mesh(np.asarray(starts_np, np.int64), n_dev)
    if len(starts_np) == 1:
        return None
    buckets_local = (len(starts_np) - 1) // n_dev
    lens = np.diff(starts_np)
    if lens.max(initial=0) == 0:
        return None
    keys = torch.clamp(keys, max=_PAD - 1)
    bounds, local = _local_starts(starts_np, n_dev, buckets_local)
    blocks = [keys[int(bounds[d]):int(bounds[d + 1])].to(dev, non_blocking=True)
              for d, dev in enumerate(mesh.devices)]
    DIST_JOIN_STATS["block_builds"] += 1
    return DistBlocks(blocks, _lstarts_on(mesh, local), starts_np, buckets_local, quantize_cap(int(lens.max())),
                      keys.device)


def distributed_exchange_table(mesh: Mesh, table: Table, key_columns: Sequence[str],
                               partitions_per_device: int = 8) -> Tuple[Table, np.ndarray, DistBlocks]:
    """The general join's real hash exchange (table_ops.py:272): (the
    reordered table, its partition starts, the exchanged key blocks). Each
    shard's block is its exchange output, valid rows first in (partition,
    key64) order; invalid slots hold the pad value and real keys sit below
    it, so the probe reads the blocks where they landed."""
    n_dev = mesh.size
    num_partitions = n_dev * partitions_per_device
    dev = table.columns[next(iter(table.columns))].data.device
    bucket, valid, rowid, k64 = _exchange_layout(mesh, table, key_columns, num_partitions, with_k64=True)
    perm, bucket_v = _gather_valid(dev, valid, rowid, bucket)
    if len(perm) != table.num_rows:
        raise RuntimeError(f"the exchange dropped rows: {len(perm)} != {table.num_rows}")
    starts = _starts_of(bucket_v, num_partitions)
    masked = [torch.where(v.to(torch.bool), torch.clamp(k, max=_PAD - 1), _PAD) for v, k in zip(valid, k64)]
    lens = np.diff(starts)
    cap = quantize_cap(int(lens.max())) if lens.size and lens.max(initial=0) else 1
    _, local = _local_starts(starts, n_dev, partitions_per_device)
    blocks = DistBlocks(masked, _lstarts_on(mesh, local), starts, partitions_per_device, cap, dev)
    return table.take(perm.long()), starts, blocks


def _pad_sort(block: torch.Tensor, lstarts: torch.Tensor, cap: int):
    """One shard's side: its buckets scattered into a [B_local, cap] matrix
    padded with int64 max, each row sorted by K1. Returns (sorted keys,
    order, lengths)."""
    lens = lstarts[1:] - lstarts[:-1]
    keys, order = sort_rows(_pad_scatter(block, lstarts[:-1], lens, cap))
    return keys, order, lens


def probe_dist_blocks(mesh: Mesh, left: DistBlocks, right: DistBlocks) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """The sharded probe of two block layouts → global (left_row, right_row)
    candidate pairs on the left's home device (table_ops.py:528). The
    smaller capacity probes into the larger, and the pair order is swapped
    back. None when the two layouts split the buckets differently."""
    if left.buckets_local != right.buckets_local:
        return None
    if left.cap > right.cap:
        out = probe_dist_blocks(mesh, right, left)
        if out is None:
            return None
        ri, li = out
        return li, ri
    DIST_JOIN_STATS["probes"] += 1
    LAST_PROBE.clear()
    home = left.home
    parts = []
    for d in range(mesh.size):
        ls, l_order, l_len = _pad_sort(left.blocks[d], left.lstarts[d], left.cap)
        rs, r_order, r_len = _pad_sort(right.blocks[d], right.lstarts[d], right.cap)
        lo, counts = range_probe(ls, rs, l_len, r_len)
        LAST_PROBE.append({"device": str(mesh.devices[d]), "left": list(ls.shape), "right": list(rs.shape)})
        parts.append([t.to(home, non_blocking=True) for t in (lo, counts, l_order, r_order)])
    lo, counts, l_order, r_order = (torch.cat(x) for x in zip(*parts))
    total = int(counts.sum(dtype=torch.int64))
    if total == 0:
        empty = torch.empty(0, dtype=torch.int64, device=home)
        return empty, empty
    l_starts = torch.as_tensor(left.starts_np[:-1], device=home)
    r_starts = torch.as_tensor(right.starts_np[:-1], device=home)
    return _expand(lo, counts, l_starts, r_starts, l_order, r_order, total)


def distributed_bucketed_join_pairs(mesh: Mesh, l_keys: torch.Tensor, l_starts_np: np.ndarray,
                                    r_keys: torch.Tensor, r_starts_np: np.ndarray):
    """The mesh-sharded `bucketed_merge_join_pairs` (table_ops.py:566): every
    bucket pair probed on the shard owning its bucket range, with nothing
    crossing between shards; a bucket count that does not divide the mesh
    is padded with empty virtual buckets. None only when the two sides'
    bucket counts differ. Uncached: the engine caches `build_dist_blocks`
    per table instead."""
    if len(l_starts_np) != len(r_starts_np):
        return None
    l_blocks = build_dist_blocks(mesh, l_keys, l_starts_np)
    r_blocks = build_dist_blocks(mesh, r_keys, r_starts_np)
    if l_blocks is None or r_blocks is None:
        empty = torch.empty(0, dtype=torch.int64, device=l_keys.device)
        return empty, empty
    return probe_dist_blocks(mesh, l_blocks, r_blocks)


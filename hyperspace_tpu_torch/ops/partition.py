"""Index-build bucketize: hash-partition + in-bucket sort.

Counterpart of `hyperspace_tpu/ops/partition.py` `bucketize_table` :108 and
`bucket_starts` :103. The build order is the JAX package's canonical one:
rows grouped by bucket id, sorted by the indexed columns within a bucket
(string columns by their sorted-dictionary codes, null slots by their fill),
ties in original row order. Three routes give it, as in the JAX package's
device path:

- one integer key of a build of at most 32,768 rows packs
  (bucket, key - min, row) into ONE unique int64 composite, sorted by kernel
  K1 (`cuda_sort.sort_rows`; `pallas_composite_build_sort` :303, the JAX
  package's staged build's sort), when the composite fits int64's headroom;
- one dictionary string key of at most 15 distinct values packs
  (bucket, code + 1, row) into ONE unique int32 composite, sorted by kernel K3
  (`cuda_comp_sort.sort_comp_rows`; `_packed_build_comp` :239 and
  `pallas_packed_build_sort` :252), when the composite fits int32;
- every other key takes a chain of stable `torch.sort` passes, last key
  first (a least-significant-digit lexsort), the counterpart of `_sort_perm`
  :34, a stable `lax.sort`, and of the CPU build's `np.lexsort`
  (`host_sort_perm` :86). A float key sorts through an int64 lane that ties
  -0.0 with +0.0 and puts every NaN last, tied, as numpy's comparisons do.

Compaction sorts every merged bucket at once with `sort_perm`, its source
file rank a last key lane, so its files equal a rebuild's.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..engine.packed_codes import bits_for_cardinality, packed_codes_enabled
from ..engine.table import Table
from .cuda_comp_sort import sort_comp_rows
from .cuda_sort import sort_rows
from .hashing import bucket_id

#: The composite build sort's row lengths (`pallas_sort.py` `_MIN_CAP` /
#: `_MAX_CAP` :43-44): pow2 padded builds of 256 to 32,768 rows.
COMPOSITE_MIN_ROWS, COMPOSITE_MAX_ROWS = 256, 32768


def sortable_lane(d: torch.Tensor) -> torch.Tensor:
    """A lane whose stable ascending sort orders `d` as `np.lexsort` does:
    bools as int32, integers as themselves, floats through their float64 bits
    mapped to a monotone int64 after -0.0 becomes +0.0 and every NaN one NaN,
    so signed zeros tie and NaNs tie after +inf (a sort of the raw bits, as a
    radix sort does, would split both)."""
    if d.dtype == torch.bool:
        return d.to(torch.int32)
    if not d.is_floating_point():
        return d
    d = d.to(torch.float64)
    d = torch.where(d == 0, torch.zeros((), dtype=d.dtype, device=d.device), d)
    d = torch.where(torch.isnan(d), torch.full((), float("nan"), dtype=d.dtype, device=d.device), d)
    bits = d.view(torch.int64)
    return bits ^ ((bits >> 63) & 0x7FFFFFFFFFFFFFFF)


def sort_perm(bucket: torch.Tensor, keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Permutation ordering rows by (bucket, key1, key2, ..., row)."""
    perm = torch.arange(bucket.shape[0], device=bucket.device)
    for lane in list(reversed(list(keys))) + [bucket]:
        order = torch.sort(sortable_lane(lane)[perm], stable=True).indices
        perm = perm[order]
    return perm


def bucket_starts(sorted_b: torch.Tensor, num_buckets: int) -> np.ndarray:
    """Bucket start offsets (length num_buckets+1) of a bucket-sorted id tensor,
    as a host array (a few hundred integers that the host loops over)."""
    edges = torch.arange(num_buckets + 1, dtype=sorted_b.dtype, device=sorted_b.device)
    return torch.searchsorted(sorted_b, edges).cpu().numpy().astype(np.int64)


def pow2_ceil(n: int) -> int:
    """The power of two at or above `n` (at least 2)."""
    return 1 << max(n - 1, 1).bit_length()


def packed_build_comp(b: torch.Tensor, codes: torch.Tensor, bits: int, log2np: int, n_pad: int,
                      num_buckets: int) -> torch.Tensor:
    """((bucket << bits) | (code + 1)) << log2np | row as int32, padded to
    [1, n_pad] with the supremum (num_buckets << bits) << log2np, which sorts
    after every real composite."""
    n = codes.shape[0]
    biased = codes.to(torch.int32) + 1
    rows = torch.arange(n, dtype=torch.int32, device=codes.device)
    comp = (((b.to(torch.int32) << bits) | biased) << log2np) | rows
    padded = torch.full((1, n_pad), (num_buckets << bits) << log2np, dtype=torch.int32, device=codes.device)
    padded[0, :n] = comp
    return padded


def packed_build_sort(
    b: torch.Tensor, codes: torch.Tensor, cardinality: int, num_buckets: int
) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(perm, sorted bucket ids) by K3 for a single dictionary key whose
    cardinality has a packed class, or None when the packed layer is off, no
    class holds the cardinality, or the composite overflows int32. The row
    bits make the composites unique, so the order is the canonical stable
    (bucket, code, row) one and index files are the same whichever route ran."""
    if not packed_codes_enabled():
        return None
    bits = bits_for_cardinality(int(cardinality))
    if bits is None:
        return None
    n = int(codes.shape[0])
    if n == 0:
        empty = torch.empty(0, dtype=torch.int32, device=codes.device)
        return empty, empty
    n_pad = pow2_ceil(n)
    log2np = n_pad.bit_length() - 1
    if (num_buckets << bits) << log2np >= 1 << 31:
        return None  # the pad composite must fit signed int32
    head = sort_comp_rows(packed_build_comp(b, codes, bits, log2np, n_pad, num_buckets))[0, :n]
    return head & (n_pad - 1), head >> (bits + log2np)


def _bucket_key_sort(b: torch.Tensor, cols, num_buckets: int) -> Tuple[torch.Tensor, torch.Tensor, str]:
    """(perm, sorted bucket ids, route) by (bucket, key columns, row): for
    one key, K1 on its composites where the key is an integer of a small
    build (`composite`) or K3 where a dictionary key packs (`packed`); else
    the stable sort chain (`chain`). Null slots sort by their fill, as in the
    JAX package."""
    if len(cols) == 1:
        c = cols[0]
        if c.is_string:
            res, route = packed_build_sort(b, c.data, len(c.dictionary), num_buckets), "packed"
        else:
            res, route = composite_build_sort(b, c.data, int(c.data.shape[0]), num_buckets), "composite"
        if res is not None:
            return res + (route,)
    perm = sort_perm(b, [c.data for c in cols])
    return perm, b[perm], "chain"


def composite_build_keys(
    b: torch.Tensor, key: torch.Tensor, n: int, num_buckets: int
) -> Optional[Tuple[torch.Tensor, int]]:
    """(the [1, n_pad] int64 composites, span) of a small build with one
    integer key: `(b * span + (key - lo)) * n_pad + row`, span = hi - lo + 1,
    padded with `num_buckets * span * n_pad` (above every real composite).
    None, where the JAX package declines too: a float or bool key, n_pad
    outside 256-32,768 (n == 0 included), or a composite past int64's
    headroom."""
    if key.dtype == torch.bool or key.is_floating_point() or key.is_complex():
        return None
    n_pad = pow2_ceil(n)
    if not COMPOSITE_MIN_ROWS <= n_pad <= COMPOSITE_MAX_ROWS:
        return None
    k64 = key[:n].to(torch.int64)
    lo, hi = torch.stack(torch.aminmax(k64)).tolist()  # one sync for both
    span = hi - lo + 1
    if span > (1 << 62) // ((num_buckets + 1) * n_pad):
        return None
    rows = torch.arange(n, dtype=torch.int64, device=key.device)
    padded = torch.full((1, n_pad), num_buckets * span * n_pad, dtype=torch.int64, device=key.device)
    padded[0, :n] = (b[:n].to(torch.int64) * span + (k64 - lo)) * n_pad + rows
    return padded, span


def composite_build_sort(
    b: torch.Tensor, key: torch.Tensor, n: int, num_buckets: int
) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(perm, sorted bucket ids) of a small build with one integer key: its
    `composite_build_keys` sorted by K1. The row bits make the composites
    unique, so the order is the canonical stable (bucket, key, row) one.
    None where `composite_build_keys` declines."""
    made = composite_build_keys(b, key, n, num_buckets)
    if made is None:
        return None
    padded, span = made
    keys, order = sort_rows(padded)
    return order[0, :n].long(), ((keys[0, :n] // padded.shape[1]) // span).to(torch.int32)


def bucketize_table(
    table: Table, bucket_columns: Sequence[str], num_buckets: int
) -> Tuple[Table, np.ndarray]:
    """Hash-partition `table` into `num_buckets` by `bucket_columns`, sorted by
    those columns within each bucket. Returns (reordered table, bucket start
    offsets): bucket b = rows[starts[b]:starts[b+1]]."""
    cols = [table.column(c) for c in bucket_columns]
    perm, sorted_b, _ = _bucket_key_sort(bucket_id(cols, num_buckets), cols, num_buckets)
    return table.take(perm.long()), bucket_starts(sorted_b, num_buckets)


"""Index-build bucketize: hash-partition + in-bucket sort.

Counterpart of `hyperspace_tpu/ops/partition.py` `bucketize_table` :108 and
`bucket_starts` :103. The build order is the JAX package's canonical one:
rows grouped by bucket id, sorted by the indexed columns within a bucket,
ties in original row order. Its device sort `_sort_perm` :34 is a stable
`lax.sort`, not a Pallas kernel; its counterpart here is a chain of stable
`torch.sort` passes, last key first (a least-significant-digit lexsort).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..engine.table import Table
from .hashing import bucket_id


def sort_perm(bucket: torch.Tensor, keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Permutation ordering rows by (bucket, key1, key2, ..., row)."""
    perm = torch.arange(bucket.shape[0], device=bucket.device)
    for lane in list(reversed(list(keys))) + [bucket]:
        if lane.dtype == torch.bool:
            lane = lane.to(torch.int32)
        order = torch.sort(lane[perm], stable=True).indices
        perm = perm[order]
    return perm


def bucket_starts(sorted_b: torch.Tensor, num_buckets: int) -> np.ndarray:
    """Bucket start offsets (length num_buckets+1) of a bucket-sorted id tensor,
    as a host array (a few hundred integers that the host loops over)."""
    edges = torch.arange(num_buckets + 1, dtype=sorted_b.dtype, device=sorted_b.device)
    return torch.searchsorted(sorted_b, edges).cpu().numpy().astype(np.int64)


def bucketize_table(
    table: Table, bucket_columns: Sequence[str], num_buckets: int
) -> Tuple[Table, np.ndarray]:
    """Hash-partition `table` into `num_buckets` by `bucket_columns`, sorted by
    those columns within each bucket. Returns (reordered table, bucket start
    offsets): bucket b = rows[starts[b]:starts[b+1]]."""
    keys = [table.column(c).data for c in bucket_columns]
    b = bucket_id(keys, num_buckets)
    perm = sort_perm(b, keys)
    return table.take(perm), bucket_starts(b[perm], num_buckets)

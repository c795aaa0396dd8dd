"""In-bucket sort of padded join buckets: kernel K1 and its plain version.

`sort_rows` replaces `hyperspace_tpu/ops/pallas_sort.py` `sort_padded_with_order`
:159 (the Pallas `_sort_kernel` :107). It sorts each row of an int64 [B, cap]
matrix (pads = int64 max) ascending and returns the sorted keys and the int32
slot order, `sorted[b, s] == keys[b, order[b, s]]`: exactly the stable argsort.
On a CUDA tensor it launches `csrc/bucket_sort.cu`, a stable merge sort; on a
CPU tensor it computes `sort_rows_plain`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..telemetry import compile_log as _compile_log
from . import _kernels

#: The launch label (K1); `launches` is its registry count (read-only).
LABEL = _compile_log.LABELS["K1"]

#: Pairs a block of the kernel sorts in shared memory (4096 or 8192): a row of
#: up to a tile is sorted in one launch, longer rows add one merge pass over
#: device memory per doubling. Shorter rows share a 4096-pair tile.
TILE_PAIRS, MAX_TILE_PAIRS = 4096, 8192


def sort_rows_plain(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: a stable sort along each row, with a gather."""
    order = torch.sort(keys, dim=1, stable=True).indices
    return keys.gather(1, order), order.to(torch.int32)


def sort_rows(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sorted keys int64 [B, cap], order int32 [B, cap]) of an int64 [B, cap]
    matrix whose cap is a power of two."""
    if keys.device.type == "cpu":
        return sort_rows_plain(keys)
    if keys.device.type != "cuda":
        raise ValueError(f"sort_rows: unsupported device {keys.device}")
    if keys.dtype != torch.int64 or keys.dim() != 2:
        raise ValueError(f"sort_rows: needs a 2-D int64 tensor, got {keys.dtype} {tuple(keys.shape)}")
    if not keys.is_contiguous():
        raise ValueError("sort_rows: the key matrix must be contiguous")
    rows, cap = keys.shape
    if cap < 1 or cap & (cap - 1) or rows * cap >= 2**31:
        raise ValueError(f"sort_rows: cap must be a power of two, got shape {tuple(keys.shape)}")
    out_keys = torch.empty_like(keys)
    order = torch.empty(keys.shape, dtype=torch.int32, device=keys.device)
    if rows == 0:
        return out_keys, order
    tile = min(max(cap, TILE_PAIRS), MAX_TILE_PAIRS)
    # The merge passes ping-pong through a scratch copy of both outputs
    # (rows * cap int64 keys, then as many int32 slots).
    scratch = torch.empty(rows * cap * 3 // 2, dtype=torch.int64, device=keys.device) if cap > tile else None
    lib = _kernels.library()  # built before the probe: a build is no device time
    with _kernels.on_device(keys.device), _compile_log.observed_launch(LABEL, keys.device):
        err = lib.hs_bucket_sort(
            keys.data_ptr(), out_keys.data_ptr(), order.data_ptr(),
            None if scratch is None else scratch.data_ptr(), rows, cap, tile,
            _kernels.stream(keys.device),
        )
        _kernels.check(err, "hs_bucket_sort")
    return out_keys, order


_compile_log.launch_view(__name__, LABEL)

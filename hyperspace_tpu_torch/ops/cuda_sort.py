"""In-bucket sort of padded join buckets: kernel K1 and its plain version.

`sort_rows` replaces `hyperspace_tpu/ops/pallas_sort.py` `sort_padded_with_order`
:159 (the Pallas `_sort_kernel` :107). It sorts each row of an int64 [B, cap]
matrix (pads = int64 max) by the pair (key, slot) and returns the sorted keys
and the int32 slot order, `sorted[b, s] == keys[b, order[b, s]]`. Slots are
unique, so the order is exactly the stable argsort. On a CUDA tensor it
launches `csrc/bucket_sort.cu`; on a CPU tensor it computes `sort_rows_plain`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _kernels

#: Launches of the CUDA kernel since the count was last set to 0.
launches = 0


def sort_rows_plain(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: a stable sort along each row, with a gather."""
    order = torch.sort(keys, dim=1, stable=True).indices
    return keys.gather(1, order), order.to(torch.int32)


def sort_rows(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sorted keys int64 [B, cap], order int32 [B, cap]) of an int64 [B, cap]
    matrix whose cap is a power of two."""
    if keys.device.type == "cpu":
        return sort_rows_plain(keys)
    global launches
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
    err = _kernels.library().hs_bucket_sort(
        keys.data_ptr(), out_keys.data_ptr(), order.data_ptr(), rows, cap,
        torch.cuda.current_stream(keys.device).cuda_stream,
    )
    _kernels.check(err, "hs_bucket_sort")
    launches += 1
    return out_keys, order

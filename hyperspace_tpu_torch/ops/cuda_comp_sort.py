"""Composite sort of the sub-byte-key index build: kernel K3 and its plain version.

`sort_comp_rows` replaces `hyperspace_tpu/ops/pallas_sort.py` `sort_comp_padded`
:261 (the Pallas `_sort_comp_kernel` :256). It sorts each row of an int32
[B, cap] matrix of unique build composites ascending
(`ops/partition.packed_build_sort` packs them). On a CUDA tensor it launches
`csrc/comp_sort.cu`; on a CPU tensor it computes `sort_comp_rows_plain`.
"""

from __future__ import annotations

import torch

from . import _kernels

#: Launches of the CUDA kernel since the count was last set to 0.
launches = 0


def sort_comp_rows_plain(v: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: a sort along each row (the composites are
    unique, so stability does not matter)."""
    return torch.sort(v, dim=1).values


def sort_comp_rows(v: torch.Tensor) -> torch.Tensor:
    """Each row of an int32 [B, cap] matrix (cap a power of two) ascending."""
    if v.device.type == "cpu":
        return sort_comp_rows_plain(v)
    global launches
    if v.device.type != "cuda":
        raise ValueError(f"sort_comp_rows: unsupported device {v.device}")
    if v.dtype != torch.int32 or v.dim() != 2 or not v.is_contiguous():
        raise ValueError(f"sort_comp_rows: needs a contiguous 2-D int32 tensor, got {v.dtype} {tuple(v.shape)}")
    rows, cap = v.shape
    if cap < 1 or cap & (cap - 1) or rows * cap >= 2**31:
        raise ValueError(f"sort_comp_rows: cap must be a power of two, got shape {tuple(v.shape)}")
    out = torch.empty_like(v)
    if rows == 0:
        return out
    err = _kernels.library().hs_comp_sort(
        v.data_ptr(), out.data_ptr(), rows, cap, torch.cuda.current_stream(v.device).cuda_stream
    )
    _kernels.check(err, "hs_comp_sort")
    launches += 1
    return out

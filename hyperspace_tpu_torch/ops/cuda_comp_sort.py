"""Composite sort of the sub-byte-key index build: kernel K3 and its plain version.

`sort_comp_rows` replaces `hyperspace_tpu/ops/pallas_sort.py` `sort_comp_padded`
:261 (the Pallas `_sort_comp_kernel` :256). It sorts each row of an int32
[B, cap] matrix ascending, whatever the values; the build hands it one row of
unique composites (`ops/partition.packed_build_sort` packs them). On a CUDA
tensor it launches `csrc/comp_sort.cu`, a one-sweep radix sort that spreads
even one row over the card; on a CPU tensor it computes
`sort_comp_rows_plain`.
"""

from __future__ import annotations

import torch

from ..telemetry import compile_log as _compile_log
from . import _kernels

#: The launch label (K3); `launches` is its registry count (read-only).
LABEL = _compile_log.LABELS["K3"]

#: Keys per block of a radix pass: 2048 spreads a 262,144-key row over 128
#: blocks; from 2^21 keys a matrix takes 4096, which halves the blocks' fixed
#: cost and the look-back words.
TILE_KEYS, WIDE_TILE_KEYS, WIDE_FROM = 2048, 4096, 1 << 21
_DIGITS = 256  # 8-bit digits
_PASSES = 4


def sort_comp_rows_plain(v: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: a sort along each row (equal keys are
    indistinguishable, so stability does not matter)."""
    return torch.sort(v, dim=1).values


def sort_comp_rows(v: torch.Tensor) -> torch.Tensor:
    """Each row of an int32 [B, cap] matrix (cap a power of two) ascending."""
    if v.device.type == "cpu":
        return sort_comp_rows_plain(v)
    if v.device.type != "cuda":
        raise ValueError(f"sort_comp_rows: unsupported device {v.device}")
    if v.dtype != torch.int32 or v.dim() != 2 or not v.is_contiguous():
        raise ValueError(f"sort_comp_rows: needs a contiguous 2-D int32 tensor, got {v.dtype} {tuple(v.shape)}")
    rows, cap = v.shape
    if cap < 1 or cap & (cap - 1) or rows * cap >= 2**31:
        raise ValueError(f"sort_comp_rows: cap must be a power of two, got shape {tuple(v.shape)}")
    tile = min(cap, WIDE_TILE_KEYS if rows * cap >= WIDE_FROM else TILE_KEYS)
    status_words = rows * (cap // tile) * _DIGITS
    if status_words >= 2**31 or rows * _PASSES * _DIGITS >= 2**31:
        raise ValueError(f"sort_comp_rows: too many rows for the kernel's state, got shape {tuple(v.shape)}")
    out = torch.empty_like(v)
    if rows == 0:
        return out
    # One allocation: the ping-pong buffer, then the kernel's zeroed state
    # (8-byte look-back words, the digit totals of the passes, the tile
    # counters), in int64 words. It is freed on return: the caching allocator
    # hands it out again only to work queued after these kernels on the stream.
    scratch_words = (rows * cap + 1) // 2
    work = torch.empty(scratch_words + status_words + rows * _PASSES * _DIGITS // 2 + _PASSES // 2,
                       dtype=torch.int64, device=v.device)
    scratch = work.data_ptr()
    lib = _kernels.library()  # built before the probe: a build is no device time
    with _kernels.on_device(v.device), _compile_log.observed_launch(LABEL, v.device):
        err = lib.hs_comp_sort(
            v.data_ptr(), out.data_ptr(), scratch, scratch + 8 * scratch_words, rows, cap, tile,
            _kernels.stream(v.device),
        )
        _kernels.check(err, "hs_comp_sort")
    return out


_compile_log.launch_view(__name__, LABEL)

"""Range probe of packed sub-byte code rows: kernel K5 and its plain version.

`probe_packed` replaces `hyperspace_tpu/ops/pallas_probe.py`
`probe_packed_pallas` :310 (the Pallas `_probe_packed_kernel` :254): K2's
(lo, counts) contract (`cuda_probe.range_probe`) over packed biased-lane word
rows, each row sorted over its valid prefix, pads at the top lane value. On a
CUDA tensor it launches `csrc/packed_probe.cu`; on a CPU tensor it computes
`probe_packed_plain`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..engine.packed_codes import PACKED_BITS, lanes_per_word, unpack_rows
from . import _kernels
from .cuda_probe import range_probe_plain

#: Launches of the CUDA kernel since the count was last set to 0.
launches = 0


def probe_packed_plain(lw, rw, bits: int, l_len, r_len) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: unpack both sides, then K2's plain probe."""
    return range_probe_plain(unpack_rows(lw, bits), unpack_rows(rw, bits), l_len, r_len)


def probe_packed(lw, rw, bits: int, l_len, r_len) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, counts) int32 [B, cap_l] of the left lanes probed into the right
    rows' valid prefixes; words are int32 tensors carrying 32 bits. Lengths
    clamp to [0, cap] (on the card inside the kernel, with no sync)."""
    if bits not in PACKED_BITS:
        raise ValueError(f"probe_packed: bits must be one of {PACKED_BITS}, got {bits}")
    if lw.device.type == "cpu":
        return probe_packed_plain(lw, rw, bits, l_len, r_len)
    global launches
    if lw.device.type != "cuda" or rw.device != lw.device:
        raise ValueError(f"probe_packed: unsupported devices {lw.device}, {rw.device}")
    for w in (lw, rw):
        if w.dtype != torch.int32 or w.dim() != 2 or not w.is_contiguous():
            raise ValueError(f"probe_packed: needs contiguous 2-D int32 word matrices, got {w.dtype} {tuple(w.shape)}")
    rows = lw.shape[0]
    lpw = lanes_per_word(bits)
    cap_l, cap_r = lw.shape[1] * lpw, rw.shape[1] * lpw
    if rw.shape[0] != rows or tuple(l_len.shape) != (rows,) or tuple(r_len.shape) != (rows,):
        raise ValueError(f"probe_packed: shapes {tuple(lw.shape)}, {tuple(rw.shape)}, {tuple(l_len.shape)}, {tuple(r_len.shape)}")
    if rows * max(cap_l, cap_r) >= 2**31:
        raise ValueError(f"probe_packed: matrices too large {tuple(lw.shape)}, {tuple(rw.shape)}")
    l_len = l_len.to(device=lw.device, dtype=torch.int32).contiguous()
    r_len = r_len.to(device=lw.device, dtype=torch.int32).contiguous()
    lo = torch.empty((rows, cap_l), dtype=torch.int32, device=lw.device)
    counts = torch.empty((rows, cap_l), dtype=torch.int32, device=lw.device)
    if rows == 0 or cap_l == 0:
        return lo, counts
    err = _kernels.library().hs_packed_probe(
        lw.data_ptr(), rw.data_ptr(), l_len.data_ptr(), r_len.data_ptr(), lo.data_ptr(), counts.data_ptr(),
        rows, cap_l, cap_r, bits, torch.cuda.current_stream(lw.device).cuda_stream,
    )
    _kernels.check(err, "hs_packed_probe")
    launches += 1
    return lo, counts

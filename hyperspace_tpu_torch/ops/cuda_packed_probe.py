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
from ..telemetry import compile_log as _compile_log
from . import _kernels

#: The launch label (K5); `launches` is its registry count (read-only).
LABEL = _compile_log.LABELS["K5"]
from .cuda_probe import range_probe_plain


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
    dev = lw.device
    if dev.type != "cuda" or rw.device != dev:
        raise ValueError(f"probe_packed: unsupported devices {dev}, {rw.device}")
    for w in (lw, rw):
        if w.dtype != torch.int32 or w.dim() != 2 or not w.is_contiguous():
            raise ValueError(f"probe_packed: needs contiguous 2-D int32 word matrices, got {w.dtype} {tuple(w.shape)}")
    (rows, words_l), (rows_r, words_r) = lw.shape, rw.shape
    lpw = lanes_per_word(bits)
    cap_l, cap_r = words_l * lpw, words_r * lpw
    if rows_r != rows or l_len.shape != (rows,) or r_len.shape != (rows,):
        raise ValueError(f"probe_packed: shapes {tuple(lw.shape)}, {tuple(rw.shape)}, {tuple(l_len.shape)}, {tuple(r_len.shape)}")
    if rows * max(cap_l, cap_r) >= 2**31:
        raise ValueError(f"probe_packed: matrices too large {tuple(lw.shape)}, {tuple(rw.shape)}")
    l_len, r_len = _lengths(l_len, r_len, dev)
    out = lw.new_empty((2, rows, cap_l))  # int32 lo, then counts: one allocation
    if rows == 0 or cap_l == 0:
        return out.unbind(0)
    lo_ptr = out.data_ptr()
    lib = _kernels.library()  # built before the probe: a build is no device time
    with _kernels.on_device(dev), _compile_log.observed_launch(LABEL, dev):
        err = lib.hs_packed_probe(
            lw.data_ptr(), rw.data_ptr(), l_len.data_ptr(), r_len.data_ptr(), lo_ptr, lo_ptr + 4 * rows * cap_l,
            rows, cap_l, cap_r, bits, l_len.dtype == torch.int64, _kernels.stream(dev),
        )
        _kernels.check(err, "hs_packed_probe")
    return out.unbind(0)


def _lengths(l_len, r_len, device):
    """The lengths as the kernel reads them: on the card, contiguous, both
    int32 or both int64. Lengths that already are (the reps' int64 lengths)
    pass as they are, with no launch."""
    if (l_len.dtype != r_len.dtype or l_len.dtype not in (torch.int32, torch.int64)
            or l_len.device != device or r_len.device != device):
        l_len, r_len = (x.to(device=device, dtype=torch.int64) for x in (l_len, r_len))
    return l_len.contiguous(), r_len.contiguous()


_compile_log.launch_view(__name__, LABEL)

"""Sort of packed sub-byte code rows: kernel K4 and its plain version.

`sort_codes_packed` replaces `hyperspace_tpu/ops/pallas_sort.py`
`sort_codes_packed` :243 (the Pallas `_sort_packed_kernel` :210). Input: a
[B, cap / lpw] matrix of words (int32 tensors carrying the 32 bits) holding
biased code lanes big-endian (`engine/packed_codes.py`), pad slots at the top
lane value. Output: the lanes of each row sorted ascending, int32 [B, cap], and
`order` int32 [B, cap] with sorted[b, s] == lanes[b, order[b, s]]: exactly the
stable argsort, ties included. On a CUDA tensor it launches
`csrc/packed_sort.cu`, a counting sort; on a CPU tensor it computes
`sort_codes_packed_plain`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..engine.packed_codes import PACKED_BITS, lanes_per_word, unpack_rows
from ..telemetry import compile_log as _compile_log
from . import _kernels

#: The launch label (K4); `launches` is its registry count (read-only).
LABEL = _compile_log.LABELS["K4"]

#: Slots a block of the kernel sorts; longer rows are cut into chunks of this
#: many, counted by a first launch.
CHUNK_SLOTS = 4096


def sort_codes_packed_plain(words: torch.Tensor, bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: unpack, stable argsort, gather
    (`bucket_join._pad_and_sort_codes` :498)."""
    lanes = unpack_rows(words, bits)
    order = torch.sort(lanes, dim=1, stable=True).indices
    return lanes.gather(1, order), order.to(torch.int32)


def sort_codes_packed(words: torch.Tensor, bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sorted biased lanes, order), both int32 [B, cap], of a packed word
    matrix whose row length cap = words.shape[1] * 32 / bits is a power of two."""
    if bits not in PACKED_BITS:
        raise ValueError(f"sort_codes_packed: bits must be one of {PACKED_BITS}, got {bits}")
    if words.device.type == "cpu":
        return sort_codes_packed_plain(words, bits)
    if words.device.type != "cuda":
        raise ValueError(f"sort_codes_packed: unsupported device {words.device}")
    if words.dtype != torch.int32 or words.dim() != 2 or not words.is_contiguous():
        raise ValueError(
            f"sort_codes_packed: needs a contiguous 2-D int32 word matrix, got {words.dtype} {tuple(words.shape)}"
        )
    rows = words.shape[0]
    cap = words.shape[1] * lanes_per_word(bits)
    if cap < 1 or cap & (cap - 1) or rows * cap >= 2**31 or ((1 << bits) - 1) * cap >= 2**31:
        raise ValueError(f"sort_codes_packed: row length {cap} is not a power of two that fits")
    # One allocation: the two outputs, then the per-chunk value counts of
    # rows longer than a chunk.
    n = rows * cap
    hist = rows * (cap // CHUNK_SLOTS) << bits if cap > CHUNK_SLOTS else 0
    out = torch.empty(2 * n + hist, dtype=torch.int32, device=words.device)
    codes, order = out[:n].view(rows, cap), out[n: 2 * n].view(rows, cap)
    if rows == 0:
        return codes, order
    base = out.data_ptr()
    lib = _kernels.library()  # built before the probe: a build is no device time
    with _kernels.on_device(words.device), _compile_log.observed_launch(LABEL, words.device):
        err = lib.hs_packed_sort(
            words.data_ptr(), base, base + 4 * n, base + 8 * n if hist else None, rows, cap, bits, CHUNK_SLOTS,
            _kernels.stream(words.device),
        )
        _kernels.check(err, "hs_packed_sort")
    return codes, order


_compile_log.launch_view(__name__, LABEL)

"""Sort of packed sub-byte code rows: kernel K4 and its plain version.

`sort_codes_packed` replaces `hyperspace_tpu/ops/pallas_sort.py`
`sort_codes_packed` :243 (the Pallas `_sort_packed_kernel` :210). Input: a
[B, cap / lpw] matrix of words (int32 tensors carrying the 32 bits) holding
biased code lanes big-endian (`engine/packed_codes.py`), pad slots at the top
lane value. Output: the lanes of each row sorted ascending, int32 [B, cap], and
`order` int32 [B, cap] with sorted[b, s] == lanes[b, order[b, s]]: exactly the
stable argsort, ties included. On a CUDA tensor it launches
`csrc/packed_sort.cu`; on a CPU tensor it computes `sort_codes_packed_plain`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..engine.packed_codes import PACKED_BITS, lanes_per_word, unpack_rows
from . import _kernels

#: Launches of the CUDA kernel since the count was last set to 0.
launches = 0


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
    global launches
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
    codes = torch.empty((rows, cap), dtype=torch.int32, device=words.device)
    order = torch.empty((rows, cap), dtype=torch.int32, device=words.device)
    if rows == 0:
        return codes, order
    err = _kernels.library().hs_packed_sort(
        words.data_ptr(), codes.data_ptr(), order.data_ptr(), rows, cap, bits,
        _kernels.stream(words.device),
    )
    _kernels.check(err, "hs_packed_sort")
    launches += 1
    return codes, order

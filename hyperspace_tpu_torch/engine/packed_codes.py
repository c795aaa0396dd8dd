"""Bit-packed sub-byte code lanes (counterpart of `hyperspace_tpu/engine/packed_codes.py`).

Dictionary codes of at most 15 distinct values pack 1, 2 or 4 bits a lane
into 32-bit words. The layout contract is the JAX package's:

- Lanes are BIASED: lane value = code + 1, so the null code -1 folds into the
  reserved lane value 0. A dictionary of `card` entries needs
  `card + 1 <= 2**bits` (`bits_for_cardinality`).
- Lanes pack BIG-ENDIAN: lane j of a word occupies bits
  [32 - bits*(j+1), 32 - bits*j), so lane 0 is in the top bits and comparing
  two words as UNSIGNED integers compares their lane tuples lexicographically.
- The sort/probe path (kernels K4 and K5) also reserves the top lane value
  2**bits - 1 for pad slots, which must sort last: `card + 2 <= 2**bits`
  (`probe_bits_for_cardinality`).

torch on the CPU has no uint32 shift, remainder or compare, so the torch
pack/unpack compute in int64 masked to 32 bits and hold a word as an int32
tensor carrying the same 32 bits. Nothing here compares packed words as
signed integers.

`HYPERSPACE_PACKED_CODES`: unset = auto (rides `HYPERSPACE_ENCODED_DEVICE`),
`0` = off, anything else = on. The JAX package asks its planner when unset;
the planner is not ported, so unset means its default.
"""

from __future__ import annotations

import os

import numpy as np
import torch

ENV_PACKED_CODES = "HYPERSPACE_PACKED_CODES"

_WORD_BITS = 32
_M32 = 0xFFFFFFFF
#: The sub-byte width classes.
PACKED_BITS = (1, 2, 4)
#: The mesh exchange's wire classes (row ids may take 16 bits).
WIRE_BITS = (1, 2, 4, 8, 16)


def packed_codes_mode() -> str:
    """"off" | "force" | "auto" (the unset default)."""
    raw = os.environ.get(ENV_PACKED_CODES, "")
    if raw == "":
        return "auto"
    return "off" if raw == "0" else "force"


def packed_codes_enabled() -> bool:
    """The flag when `HYPERSPACE_PACKED_CODES` is set, else the planner's
    decision, else `HYPERSPACE_ENCODED_DEVICE`'s gate."""
    mode = packed_codes_mode()
    if mode != "auto":
        return mode == "force"
    from ..plananalysis.planner import decided_value

    decided = decided_value("packed_codes")
    if decided is not None:
        return bool(decided)
    from .encoded_device import encoded_device_enabled

    return encoded_device_enabled()


def lanes_per_word(bits: int) -> int:
    return _WORD_BITS // bits


def bits_for_cardinality(card: int):
    """Smallest width whose lanes hold biased codes [0, card]; None = no
    sub-byte class."""
    for bits in PACKED_BITS:
        if card + 1 <= (1 << bits):
            return bits
    return None


def wire_bits_for_range(n_values: int):
    """Smallest mesh-wire class holding unsigned field values [0, n_values);
    None when even 16 bits is too narrow (the lane crosses unpacked)."""
    for bits in WIRE_BITS:
        if n_values <= (1 << bits):
            return bits
    return None


def probe_bits_for_cardinality(card: int):
    """Width for the sort/probe path, which also reserves the top lane value
    for pads; None = no sub-byte class."""
    for bits in PACKED_BITS:
        if card + 2 <= (1 << bits):
            return bits
    return None


def packed_lane_count(n: int, bits: int) -> int:
    """Lanes of a length-`n` code array packed to whole words."""
    lpw = lanes_per_word(bits)
    return -(-max(int(n), 1) // lpw) * lpw


def packed_word_count(n: int, bits: int) -> int:
    return packed_lane_count(n, bits) // lanes_per_word(bits)


def _host_shifts(bits: int) -> np.ndarray:
    return (_WORD_BITS - bits * (np.arange(lanes_per_word(bits)) + 1)).astype(np.uint32)


def pack_codes_host(codes: np.ndarray, bits: int) -> np.ndarray:
    """Host code array (values >= -1) -> big-endian biased uint32 words. Lanes
    past `len(codes)` hold the reserved 0."""
    n = int(len(codes))
    biased = np.zeros(packed_lane_count(n, bits), np.uint32)
    biased[:n] = (np.asarray(codes).astype(np.int64) + 1).astype(np.uint32)
    lanes = biased.reshape(-1, lanes_per_word(bits))
    return (lanes << _host_shifts(bits)[None, :]).sum(axis=1, dtype=np.uint32)


def unpack_codes_host(words: np.ndarray, n: int, bits: int) -> np.ndarray:
    """Inverse of `pack_codes_host`: the first `n` lanes as int32 codes
    (reserved 0 -> the null code -1)."""
    mask = np.uint32((1 << bits) - 1)
    lanes = (words[:, None] >> _host_shifts(bits)[None, :]) & mask
    return lanes.reshape(-1)[:n].astype(np.int64).astype(np.int32) - 1


def _shifts(bits: int, device) -> torch.Tensor:
    return torch.tensor(
        [_WORD_BITS - bits * (j + 1) for j in range(lanes_per_word(bits))], dtype=torch.int64, device=device
    )


def words_to_int32(words64: torch.Tensor) -> torch.Tensor:
    """int64 lanes holding 32-bit words -> int32 tensor of the same bits."""
    return (words64 - ((words64 >> 31) << 32)).to(torch.int32)


def pack_rows(mat: torch.Tensor, bits: int) -> torch.Tensor:
    """[R, C] non-negative lane values (C a multiple of the lanes per word) ->
    [R, C / lpw] words as int32 bits, big-endian (`pack_rows_traced` :176)."""
    lanes = mat.to(torch.int64).reshape(mat.shape[0], -1, lanes_per_word(bits))
    words = (lanes << _shifts(bits, mat.device)).sum(dim=2)  # disjoint fields: sum == or
    return words_to_int32(words)


def unpack_rows(words: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of `pack_rows`: [R, W] words -> [R, W * lpw] int32 lane values
    (`unpack_rows_traced` :190)."""
    w = words.to(torch.int64) & _M32
    lanes = (w.unsqueeze(-1) >> _shifts(bits, words.device)) & ((1 << bits) - 1)
    return lanes.reshape(words.shape[0], -1).to(torch.int32)


def packable_bits(col):
    """Packed width of a column's code lane, or None when the packed layer is
    off, the column does not qualify for encoded staging, or its dictionary
    exceeds every sub-byte class."""
    if not packed_codes_enabled():
        return None
    from .encoded_device import column_qualifies

    if not column_qualifies(col) or col.data.dtype != torch.int32:
        return None
    return bits_for_cardinality(len(col.dictionary))


def packed_host_codes(col, bits: int) -> np.ndarray:
    """Packed uint32 words of a column's code lane, on the host."""
    return pack_codes_host(col.data.cpu().numpy(), bits)

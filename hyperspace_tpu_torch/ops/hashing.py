"""Bucket ids and 64-bit join keys, bit-identical to `hyperspace_tpu/ops/hashing.py`.

The JAX package hashes with uint32 vector ops (murmur3 finalizer mixing). Bucket
co-location across independently built indexes — what makes the shuffle-free
bucketed join sound — needs every package to hash identically, so this module
computes the same functions: `fmix32` :100, `_mix_combine` :111, `_words_u32`
:118 (its numeric part), `hash_device_values` :145, `key64` :324 and
`bucket_id` :337.

torch has no uint32 shifts or compares on every device, so each lane is an
int64 tensor holding a value in [0, 2^32), masked after every multiply: the
product of two such values may wrap int64, but its low 32 bits survive the
wrap, and those are all that is kept.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

_M32 = 0xFFFFFFFF
_SEED1 = 0x9747B28C
_SEED2 = 0x85EBCA6B


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer on int64 lanes holding uint32 values."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def _mix_combine(h: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Combine an accumulated hash with a new lane (murmur-style stream step)."""
    h = h ^ fmix32(k)
    return (h * 5 + 0xE6546B64) & _M32


def _words_u32(x: torch.Tensor, force_float: bool = False):
    """The (low, high) 32-bit words of a value's canonical 64-bit pattern:
    ints and bools as int64, floats as float64 with -0.0 made +0.0. XLA runs
    the JAX package's `x == 0` canonicalization with denormals flushed to
    zero, so subnormal floats hash as +0.0 there; they do here too."""
    if force_float or x.is_floating_point():
        x = x.to(torch.float64)
        zero = x.abs() < torch.finfo(torch.float64).tiny
        x = torch.where(zero, torch.zeros((), dtype=x.dtype, device=x.device), x)
        bits = x.view(torch.int64)
    else:
        bits = x.to(torch.int64)
    return [bits & _M32, (bits >> 32) & _M32]


def hash_device_values(x: torch.Tensor, seed: int, force_float: bool = False) -> torch.Tensor:
    """uint32 hash (in an int64 lane) of a numeric tensor's values."""
    words = _words_u32(x, force_float)
    h = torch.full(words[0].shape, seed, dtype=torch.int64, device=x.device)
    for w in words:
        h = _mix_combine(h, w)
    return fmix32(h)


def _lane(arrays: Sequence[torch.Tensor], seed: int, force_float) -> torch.Tensor:
    h = None
    for i, a in enumerate(arrays):
        hc = hash_device_values(a, seed, bool(force_float[i]) if force_float else False)
        h = hc if h is None else fmix32(_mix_combine(h, hc))
    return h


def key64(arrays: Sequence[torch.Tensor], force_float: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """Signed 64-bit join/sort key from two independent 32-bit hash lanes:
    `(h1 << 32) | h2` in two's complement. h1 is first mapped to its signed
    32-bit value, so the shift is a multiply that never leaves int64."""
    h1 = _lane(arrays, _SEED1, force_float)
    h2 = _lane(arrays, _SEED2, force_float)
    h1_signed = h1 - ((h1 >> 31) << 32)
    return h1_signed * (1 << 32) + h2


def bucket_id(arrays: Sequence[torch.Tensor], num_buckets: int) -> torch.Tensor:
    """Bucket assignment: h1 % num_buckets (the repartition hash), int32."""
    return (_lane(arrays, _SEED1, None) % int(num_buckets)).to(torch.int32)

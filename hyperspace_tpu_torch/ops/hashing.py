"""Bucket ids and 64-bit join keys, bit-identical to `hyperspace_tpu/ops/hashing.py`.

The JAX package hashes with uint32 vector ops (murmur3 finalizer mixing). Bucket
co-location across independently built indexes — what makes the shuffle-free
bucketed join sound — needs every package to hash identically, so this module
computes the same functions: `fmix32` :100, `_mix_combine` :111, `_words_u32`
:118, `hash_device_values` :145, `host_hash_dictionary` :163,
`column_hash_u32` :205, `combined_hash_u32` :315, `key64` :324 and
`bucket_id` :337. `key64` on a CUDA device is one launch of kernel K6
(`ops/cuda_hash.py`); `key64_plain` is its plain version.

A key lane is a tensor of numeric values, or a `Column`: a string column
hashes through its dictionary (one 4-byte blake2b per distinct value on the
host, then a gather through the codes on the device), so the string bytes are
touched once per dictionary entry; the hashes of a dictionary are memoized
per dictionary object and seed, so a later query over the same column hashes
nothing. Null slots hash their fill value (numeric
0, string code 0), as in the JAX package.

torch has no uint32 shifts or compares on every device, so each lane is an
int64 tensor holding a value in [0, 2^32), masked after every multiply: the
product of two such values may wrap int64, but its low 32 bits survive the
wrap, and those are all that is kept.
"""

from __future__ import annotations

import hashlib
import sys
import threading
import weakref
from typing import Optional, Sequence

import numpy as np
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


# The dictionary-hash memo (`hashing.py` :153-200): one blake2b pass per
# (dictionary object, seed), not per query, with its copies on each device.
# Entries are keyed weakly, so they die with their dictionaries and a reused
# id never serves a dead dictionary's hashes.
_dict_hash_cache: dict = {}
_dict_hash_lock = threading.RLock()


def _hash_strings(dictionary: np.ndarray, seed: int) -> torch.Tensor:
    """A 4-byte blake2b of each entry's UTF-8 bytes, the seed as
    little-endian salt, as uint32 values in int64 lanes on the host."""
    out = np.empty(len(dictionary), dtype=np.uint32)
    salt = int(seed).to_bytes(4, "little")
    for i, s in enumerate(dictionary):
        d = hashlib.blake2b(str(s).encode("utf-8"), digest_size=4, salt=salt).digest()
        out[i] = np.frombuffer(d, dtype=np.uint32)[0]
    return torch.from_numpy(out.astype(np.int64))


def host_hash_dictionary(dictionary: np.ndarray, seed: int, device=None) -> torch.Tensor:
    """uint32 hash (in int64 lanes) of each dictionary entry, on `device`
    (the host when None), memoized per dictionary object and seed."""
    dev = torch.device("cpu" if device is None else device)
    key = (id(dictionary), int(seed))
    # The miss is hashed under the lock, so that concurrent queries meeting a
    # new dictionary hash it once (the loop holds the GIL all the same).
    with _dict_hash_lock:
        ent = _dict_hash_cache.get(key)
        if ent is not None and ent[0]() is dictionary:
            copies = ent[1]
            if dev not in copies:
                copies[dev] = copies[torch.device("cpu")].to(dev)
            return copies[dev]
        host = _hash_strings(dictionary, seed)
        copies = {torch.device("cpu"): host}
        if dev.type != "cpu":
            copies[dev] = host.to(dev)

        def _evict(wr, key=key, finalizing=sys.is_finalizing):
            if finalizing():  # interpreter exit: the module's globals may be gone
                return
            with _dict_hash_lock:
                ent_now = _dict_hash_cache.get(key)
                if ent_now is not None and ent_now[0] is wr:
                    _dict_hash_cache.pop(key, None)

        try:
            _dict_hash_cache[key] = (weakref.ref(dictionary, _evict), copies)
        except TypeError:  # a container that takes no weak reference: not memoized
            pass
        return copies[dev]


def column_hash_u32(lane, seed: int, force_float: bool = False) -> torch.Tensor:
    """uint32 hash (in an int64 lane) of one key lane: a numeric tensor, or a
    Column (string columns through their dictionary; codes may be narrow)."""
    if isinstance(lane, torch.Tensor):
        return hash_device_values(lane, seed, force_float)
    if lane.is_string:
        return host_hash_dictionary(lane.dictionary, seed, lane.data.device)[lane.data.long()]
    return hash_device_values(lane.data, seed, force_float)


def _lane(lanes: Sequence, seed: int, force_float) -> torch.Tensor:
    h = None
    for i, a in enumerate(lanes):
        hc = column_hash_u32(a, seed, bool(force_float[i]) if force_float else False)
        h = hc if h is None else fmix32(_mix_combine(h, hc))
    return h


def combined_hash_u32(arrays: Sequence) -> torch.Tensor:
    """The row hash h1 of the key lanes (`combined_hash_u32` :315): uint32
    values in an int64 lane, whose remainder by the bucket count is the
    bucket id."""
    return _lane(arrays, _SEED1, None)


def key64(arrays: Sequence, force_float: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """Signed 64-bit join/sort key from two independent 32-bit hash lanes:
    `(h1 << 32) | h2` in two's complement. Lanes on the CPU run
    `key64_plain`; lanes on a CUDA device launch kernel K6
    (`ops/cuda_hash.key64`), which gives the same bits."""
    first = arrays[0] if isinstance(arrays[0], torch.Tensor) else arrays[0].data
    if first.device.type == "cpu":
        return key64_plain(arrays, force_float)
    from . import cuda_hash

    return cuda_hash.key64(arrays, force_float)


def key64_plain(arrays: Sequence, force_float: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """The plain PyTorch version of `key64`. h1 is first mapped to its signed
    32-bit value, so the shift is a multiply that never leaves int64."""
    h1 = _lane(arrays, _SEED1, force_float)
    h2 = _lane(arrays, _SEED2, force_float)
    h1_signed = h1 - ((h1 >> 31) << 32)
    return h1_signed * (1 << 32) + h2


def bucket_id(arrays: Sequence, num_buckets: int) -> torch.Tensor:
    """Bucket assignment: h1 % num_buckets (the repartition hash), int32."""
    return (combined_hash_u32(arrays) % int(num_buckets)).to(torch.int32)

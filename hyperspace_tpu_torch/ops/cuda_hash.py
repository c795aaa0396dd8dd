"""64-bit join and group keys on the card: kernel K6.

`key64` computes `hashing.key64_plain`'s bits, `(h1 << 32) | h2` of the key
lanes under the two murmur3 streams, in one launch of `csrc/key_hash.cu` for
up to `MAX_LANES` lanes, where the plain version dispatches about 89
elementwise torch ops a lane. It replaces no TPU kernel: the JAX package's
`key64` (`hyperspace_tpu/ops/hashing.py` :324) is jnp ops that XLA fuses into
one program. `hashing.key64` calls it for lanes on a CUDA device and runs the
plain version for lanes on the CPU.

A lane is a numeric tensor or a `Column`, as in `hashing`. `plan` turns the
lanes into the kernel's descriptors: integer and bool lanes hash as int64
words, float lanes (and `force_float` ones) as canonical float64, string
columns through their dictionary's two per-seed hash tables, gathered by
code on the card. A call with more than `MAX_LANES` lanes runs one launch
per `MAX_LANES`, each resuming from the partial hashes the last one wrote.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from ..telemetry import compile_log as _compile_log
from . import _kernels
from .hashing import _SEED1, _SEED2, host_hash_dictionary

#: The launch label (K6); `launches` is its registry count (read-only).
LABEL = _compile_log.LABELS["K6"]

#: Lanes one launch takes (`kMaxLanes` in `csrc/key_hash.cu`).
MAX_LANES = 8

KIND_INT, KIND_FLOAT, KIND_STRING = 0, 1, 2

#: The kernel's dtype codes (`Dtype` in `csrc/key_hash.cu`).
DTYPE_CODES = {
    torch.int8: 0, torch.int16: 1, torch.int32: 2, torch.int64: 3,
    torch.uint8: 4, torch.bool: 5, torch.float32: 6, torch.float64: 7,
}
_FLOATS = (torch.float32, torch.float64)


class _Lane(ctypes.Structure):
    """One lane descriptor, laid out as `HsLane` in `csrc/key_hash.cu`."""

    _fields_ = [("data", ctypes.c_void_p), ("table1", ctypes.c_void_p), ("table2", ctypes.c_void_p),
                ("kind", ctypes.c_int32), ("dtype", ctypes.c_int32)]


def abi() -> Tuple[int, ...]:
    """The constants above, in the order `hs_key64_abi` of
    `csrc/key_hash.cu` gives the kernel's own."""
    return (MAX_LANES, KIND_INT, KIND_FLOAT, KIND_STRING, *DTYPE_CODES.values(), ctypes.sizeof(_Lane))


_abi_checked = False


def _check_abi(lib) -> None:
    """Raises unless the built kernel's constants are `abi()`: a change to
    one side alone would hash wrong lanes or refuse every launch."""
    global _abi_checked
    if _abi_checked:
        return
    want = abi()
    buf = (ctypes.c_int * len(want))()
    count = lib.hs_key64_abi(buf, len(want))
    got = tuple(buf[:min(count, len(want))])
    if count != len(want) or got != want:
        raise RuntimeError(f"key64: csrc/key_hash.cu's constants {got} ({count}) differ from cuda_hash's {want}")
    _abi_checked = True


def _data(lane) -> torch.Tensor:
    return lane if isinstance(lane, torch.Tensor) else lane.data


def _is_string(lane) -> bool:
    return not isinstance(lane, torch.Tensor) and lane.is_string


def plan(lanes: Sequence, force_float: Optional[Sequence[bool]] = None) -> List[List[Tuple[int, int, int]]]:
    """The launches of a call: for each, its lanes as (lane index, kind,
    dtype code), at most `MAX_LANES` a launch. Raises on no lanes and on a
    dtype the kernel does not take."""
    if not lanes:
        raise ValueError("key64: needs at least one key lane")
    descs = []
    for i, lane in enumerate(lanes):
        dtype = _data(lane).dtype
        code = DTYPE_CODES.get(dtype)
        if code is None:
            raise ValueError(f"key64: lane {i} has dtype {dtype}, which the kernel does not take")
        if _is_string(lane):
            if dtype in _FLOATS or dtype == torch.bool:
                raise ValueError(f"key64: string lane {i} has {dtype} codes")
            kind = KIND_STRING
        elif dtype in _FLOATS or (force_float and force_float[i]):
            kind = KIND_FLOAT
        else:
            kind = KIND_INT
        descs.append((i, kind, code))
    return [descs[lo:lo + MAX_LANES] for lo in range(0, len(descs), MAX_LANES)]


def key64(lanes: Sequence, force_float: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """Signed int64 key of each row of the key lanes (1-D, equal lengths, on
    one CUDA device), bit-identical to `hashing.key64_plain`."""
    launches = plan(lanes, force_float)
    datas = [_data(lane) for lane in lanes]
    dev = datas[0].device
    if dev.type != "cuda" or any(d.device != dev for d in datas):
        raise ValueError(f"key64: needs lanes on one CUDA device, got {[str(d.device) for d in datas]}")
    n = int(datas[0].shape[0]) if datas[0].dim() == 1 else -1
    if any(d.dim() != 1 or int(d.shape[0]) != n for d in datas):
        raise ValueError(f"key64: needs 1-D lanes of equal length, got {[tuple(d.shape) for d in datas]}")
    out = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return out
    # The contiguous lanes and the string lanes' tables outlive the launches:
    # the caching allocator hands their memory out again only to work queued
    # after the kernel on this stream.
    keep = []
    lib = _kernels.library()  # built before the probe: a build is no device time
    _check_abi(lib)
    with _kernels.on_device(dev):
        stream = _kernels.stream(dev)
        for j, chunk in enumerate(launches):
            descs = (_Lane * len(chunk))()
            for d, (i, kind, code) in zip(descs, chunk):
                data = datas[i].contiguous()
                keep.append(data)
                d.data, d.kind, d.dtype = data.data_ptr(), kind, code
                if kind == KIND_STRING:
                    dictionary = lanes[i].dictionary
                    t1 = host_hash_dictionary(dictionary, _SEED1, dev)
                    t2 = host_hash_dictionary(dictionary, _SEED2, dev)
                    keep += [t1, t2]
                    d.table1, d.table2 = t1.data_ptr(), t2.data_ptr()
            with _compile_log.observed_launch(LABEL, dev):
                err = lib.hs_key64(descs, len(chunk), n, out.data_ptr(), int(j > 0), stream)
                _kernels.check(err, "hs_key64")
    return out


_compile_log.launch_view(__name__, LABEL)

"""The device mesh (counterpart of `hyperspace_tpu/parallel/mesh.py`).

The distribution axis is "buckets": index data is hash-partitioned into
`num_buckets` buckets, and on a mesh each device owns a contiguous bucket
block. The build's all-to-all exchange and the co-bucketed join's sharded
probe both ride this one axis.

One process drives the whole mesh, as one JAX controller drives every
device of its `Mesh`: a `Mesh` here is an ordered tuple of
`torch.device`s, and a sharded array is a list of tensors, one on each
device, in mesh order. No `torch.distributed` process group is involved:
NCCL wants one process per card and refuses two ranks on one card, so it
could neither keep the engine single-controller nor run a mesh on a
one-card machine.

The visible devices are, for a CUDA session, `cuda:0 … cuda:n-1` (as
`jax.devices()` lists every device), and for a CPU session the CPU alone.
`virtual_devices(n, device)` makes `n` shards of one device the visible set
of sessions on that device type while it is entered, the counterpart of
`force_virtual_cpu` :62: the tests run an 8-shard CPU mesh with it, and a
one-card machine a virtual CUDA mesh.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

BUCKET_AXIS = "buckets"

#: Minimum rows a mesh shape is quantized to (env-tunable, mesh.py:30).
#: Every per-device row dimension (exchange shard rows, send-matrix
#: capacity, probe block width) is ceil'd to a power of two and floored at
#: this quantum. torch compiles no shapes, but the send matrix's capacity is
#: what `parallel.exchange.bytes_moved` and the `mesh_exchange` pad ledger
#: count, and a power of two keeps it a multiple of every packed wire
#: lane's `lanes_per_word`.
ENV_ROW_QUANTUM = "HYPERSPACE_MESH_ROW_QUANTUM"
_DEFAULT_ROW_QUANTUM = 1024


def mesh_row_quantum() -> int:
    try:
        q = int(os.environ.get(ENV_ROW_QUANTUM, _DEFAULT_ROW_QUANTUM))
    except ValueError:
        return _DEFAULT_ROW_QUANTUM
    if q < 1:
        return _DEFAULT_ROW_QUANTUM
    return 1 << (q - 1).bit_length()


def quantize_cap(n: int) -> int:
    """Pow2-quantize a per-device capacity, floored at the mesh row quantum."""
    return 1 << (max(int(n), mesh_row_quantum()) - 1).bit_length()


def quantized_rows(num_rows: int, n_dev: int) -> int:
    """The padded global row count of `num_rows` rows on an `n_dev` mesh:
    every device's shard holds the same pow2-quantized number of rows."""
    per = -(-max(int(num_rows), 1) // n_dev)
    return quantize_cap(per) * n_dev


class Mesh:
    """An ordered tuple of devices along the bucket axis."""

    __slots__ = ("devices",)

    def __init__(self, devices: Sequence):
        self.devices: Tuple[torch.device, ...] = tuple(torch.device(d) for d in devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({', '.join(str(d) for d in self.devices)})"


_virtual_lock = threading.Lock()
_virtual: Optional[Tuple[torch.device, ...]] = None


def visible_devices(device) -> Tuple[torch.device, ...]:
    """The devices a session on `device` can shard over, in mesh order."""
    dev = torch.device(device)
    virtual = _virtual
    if virtual is not None and virtual[0].type == dev.type:
        return virtual
    if dev.type == "cuda" and torch.cuda.is_available():
        return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    return (dev,)


@contextlib.contextmanager
def virtual_devices(n: int, device="cuda") -> Iterator[Tuple[torch.device, ...]]:
    """Make `n` shards of `device` the visible devices of sessions on its
    device type while the block runs; the previous set comes back on exit,
    however the block ends, so nothing outlives it."""
    global _virtual
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    shards = (dev,) * int(n)
    with _virtual_lock:
        previous, _virtual = _virtual, shards
    try:
        yield shards
    finally:
        with _virtual_lock:
            _virtual = previous


def make_mesh(num_devices: Optional[int] = None, device="cuda") -> Mesh:
    """A mesh over the first `num_devices` (default: all) devices visible to
    a session on `device` (mesh.py:104)."""
    devices = visible_devices(device)
    n = num_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"Requested {n} devices; only {len(devices)} available.")
    return Mesh(devices[:n])


def shard_rows(mesh: Mesh, x) -> List[torch.Tensor]:
    """Rows split into `mesh.size` equal blocks, block d on device d (the
    counterpart of placing an array with `row_sharding`). A list is taken
    to be sharded already."""
    if isinstance(x, (list, tuple)):
        return list(x)
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split evenly over {mesh.size} devices")
    per = n // mesh.size
    return [x[d * per:(d + 1) * per].to(dev, non_blocking=True) for d, dev in enumerate(mesh.devices)]

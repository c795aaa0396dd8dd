"""Build and load the package's CUDA kernels.

The sources under `csrc/` are compiled with `nvcc` for `sm_90a` (one `nvcc` per
source, all started together), linked into one shared library with a plain C
interface, and loaded with `ctypes`. The build runs at first use, into
`build/hyperspace_tpu_torch/` beside the package, keyed by a hash of the
sources and flags, so an edit rebuilds and an unchanged tree reuses the
library. No PyTorch header is compiled: a build takes seconds.

A build runs through `telemetry.compile_log.observed_build` (timed, counted,
the `device.compile` fault point), and `HYPERSPACE_COMPILE_TIMEOUT_S` bounds
its `nvcc` processes: past it they are killed and a `CompileTimeoutError`
is raised.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import signal
import subprocess
import tempfile
import threading
import time
from typing import Optional

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
_SOURCES = ("bucket_sort.cu", "range_probe.cu", "comp_sort.cu", "packed_sort.cu", "packed_probe.cu", "key_hash.cu")
_HEADERS: tuple = ()  # headers the sources include, hashed into the build digest
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "hyperspace_tpu_torch")
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: Wall seconds the last build took (0.0 when the library was reused).
build_seconds = 0.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "hs_bucket_sort": (_P, _P, _P, _P, _I, _I, _I, _P),
    "hs_range_probe_i64": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "hs_range_probe_f64": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "hs_comp_sort": (_P, _P, _P, _P, _I, _I, _I, _P),
    "hs_packed_sort": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "hs_packed_probe": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "hs_key64": (_P, _I, _L, _P, _I, _P),
    "hs_key64_abi": (_P, _I),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _popen(cmd) -> subprocess.Popen:
    """A compiler process in a session of its own, so that `_kill` also ends
    the tools it starts (cicc, ptxas)."""
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, start_new_session=True)


def _kill(p: subprocess.Popen) -> None:
    try:
        os.killpg(p.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    p.communicate()


def _communicate(p: subprocess.Popen, cmd, deadline: Optional[float]) -> bytes:
    """`p`'s output, waiting at most until `deadline` (monotonic seconds)."""
    from ..exceptions import CompileTimeoutError
    from ..telemetry import compile_log

    try:
        out, _ = p.communicate(timeout=None if deadline is None else max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        _kill(p)
        compile_log.note_deadline_exceeded()
        limit = compile_log.compile_timeout_s()
        raise CompileTimeoutError(
            f"{' '.join(cmd)} did not finish within HYPERSPACE_COMPILE_TIMEOUT_S={limit:g}s",
            elapsed_s=limit, timeout_s=limit,
        ) from None
    if p.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{out.decode(errors='replace')}")
    return out


def _build(target: str) -> None:
    global build_seconds
    from ..telemetry import compile_log

    t0 = time.monotonic()
    limit = compile_log.compile_timeout_s()
    deadline = t0 + limit if limit > 0 else None
    nvcc = _nvcc()
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        objs, procs = [], []
        for name in _SOURCES:
            obj = os.path.join(tmp, name + ".o")
            objs.append(obj)
            cmd = [nvcc, *_FLAGS, "-c", os.path.join(_CSRC, name), "-o", obj]
            procs.append((cmd, _popen(cmd)))
        try:
            for cmd, p in procs:
                _communicate(p, cmd, deadline)
        finally:
            for _, p in procs:  # a failed or timed-out build leaves no compiler running
                if p.poll() is None:
                    _kill(p)
        lib_tmp = os.path.join(tmp, "lib.so")
        cmd = [nvcc, *_FLAGS, "-shared", *objs, "-o", lib_tmp]
        _communicate(_popen(cmd), cmd, deadline)
        os.replace(lib_tmp, target)  # atomic: a concurrent loader sees all or nothing
    build_seconds = time.monotonic() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is not None:  # every launch asks: no lock once it is loaded
        return _lib
    with _lock:
        if _lib is None:
            target = os.path.join(_BUILD_DIR, f"libhyperspace_tpu_torch_{_digest()}.so")
            if not os.path.exists(target):
                from ..telemetry import compile_log

                compile_log.observed_build(_build, target)
            lib = ctypes.CDLL(target)
            for fn, argtypes in _SIGNATURES.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            lib.hs_error_string.argtypes = [ctypes.c_int]
            lib.hs_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def on_device(device):
    """The context a launch on `device` runs in: `torch.cuda.device(device)`
    when another card is current (a mesh shard on cuda:1 launches on
    cuda:1, not on the current card), else no switch at all."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def stream(device) -> int:
    """The raw pointer of `device`'s current CUDA stream, read without building
    a `torch.cuda.Stream` object."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(err: int, kernel: str) -> None:
    """Raise when a C entry returned a CUDA error (its `cudaGetLastError()`)."""
    if err != 0:
        name = library().hs_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: {name} ({err})")

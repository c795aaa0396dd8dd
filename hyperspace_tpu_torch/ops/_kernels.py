"""Build and load the package's CUDA kernels.

The sources under `csrc/` are compiled with `nvcc` for `sm_90a` (one `nvcc` per
source, all started together), linked into one shared library with a plain C
interface, and loaded with `ctypes`. The build runs at first use, into
`build/hyperspace_tpu_torch/` beside the package, keyed by a hash of the
sources and flags, so an edit rebuilds and an unchanged tree reuses the
library. No PyTorch header is compiled: a build takes seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
_SOURCES = ("bucket_sort.cu", "range_probe.cu")
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
_SIGNATURES = {
    "hs_bucket_sort": (_P, _P, _P, _I, _I, _P),
    "hs_range_probe_i64": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "hs_range_probe_f64": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
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
    for name in _SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _build(target: str) -> None:
    global build_seconds
    t0 = time.monotonic()
    nvcc = _nvcc()
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        objs, procs = [], []
        for name in _SOURCES:
            obj = os.path.join(tmp, name + ".o")
            objs.append(obj)
            cmd = [nvcc, *_FLAGS, "-c", os.path.join(_CSRC, name), "-o", obj]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        for cmd, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"{' '.join(cmd)} failed:\n{out.decode(errors='replace')}")
        lib_tmp = os.path.join(tmp, "lib.so")
        cmd = [nvcc, *_FLAGS, "-shared", *objs, "-o", lib_tmp]
        p = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if p.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{p.stdout.decode(errors='replace')}")
        os.replace(lib_tmp, target)  # atomic: a concurrent loader sees all or nothing
    build_seconds = time.monotonic() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            target = os.path.join(_BUILD_DIR, f"libhyperspace_tpu_torch_{_digest()}.so")
            if not os.path.exists(target):
                _build(target)
            lib = ctypes.CDLL(target)
            for fn, argtypes in _SIGNATURES.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            lib.hs_error_string.argtypes = [ctypes.c_int]
            lib.hs_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, kernel: str) -> None:
    """Raise when a C entry returned a CUDA error (its `cudaGetLastError()`)."""
    if err != 0:
        name = library().hs_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: {name} ({err})")

"""Kernel-build and launch observatory: the CUDA counterpart of
`hyperspace_tpu/telemetry/compile_log.py`.

The JAX package compiles one XLA program per traced shape and watches those
compiles. The port compiles nothing per shape: its kernels are one library
built once from `csrc/` (`ops/_kernels.py`), then launched. So this module
watches two events.

- **The library build** (`observed_build`): timed and counted in
  `xla.compiles.count`, `xla.compiles.seconds` and the program summary's
  `kernels.library` entry, and charged to the ambient ledger's
  `xla_compiles` / `xla_compile_s` and the ambient span. These names are the
  JAX package's, kept so that both packages' records read alike; in the
  port they count builds of the kernel library, which happen at most once a
  process (none when a built library for the same sources is on disk). The
  `device.compile` fault point fires here, and `HYPERSPACE_COMPILE_TIMEOUT_S`
  bounds the `nvcc` processes (`_kernels._build`).
- **Launches** (`observed_launch(label, device)`): each CUDA kernel wrapper
  in `ops/cuda_*.py` launches inside it. A launch adds one to
  `kernel.launches.<label>` and to the label's `launches` in
  `program_summary()`, and `launches.<label>` on the ambient span; under
  `HYPERSPACE_DEVICE_TIMING` it is bracketed by the device probes of
  `device_observatory`. The wrappers' module attributes `launches` are
  read-only views of these counters (`launch_view`).

The JAX package's recompile-storm warning has no counterpart: a storm is
many compiles of one program for new shapes, and the port's kernels are not
compiled per shape.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
import types
from typing import Dict, Iterator

from . import device_observatory as _devobs
from . import metrics as _metrics

ENV_COMPILE_TIMEOUT_S = "HYPERSPACE_COMPILE_TIMEOUT_S"

#: Labels of the kernel wrappers, by kernel of the TPU table (PERF.md).
LABELS = {
    "K1": "cuda_sort.sort_rows",
    "K2": "cuda_probe.range_probe",
    "K3": "cuda_comp_sort.sort_comp_rows",
    "K4": "cuda_packed_sort.sort_codes_packed",
    "K5": "cuda_packed_probe.probe_packed",
    "K6": "cuda_hash.key64",
}
LIBRARY_LABEL = "kernels.library"

_COMPILES = _metrics.counter("xla.compiles.count")
_COMPILE_SECONDS = _metrics.histogram("xla.compiles.seconds")
_DEADLINE_EXCEEDED = _metrics.counter("xla.compiles.deadline_exceeded")

_lock = threading.Lock()
_programs: Dict[str, dict] = {}
_launch_counters: Dict[str, _metrics.Counter] = {}


def compile_timeout_s() -> float:
    """The deadline of one library build in seconds (unset or 0: none)."""
    try:
        return max(0.0, float(os.environ.get(ENV_COMPILE_TIMEOUT_S, "") or 0.0))
    except ValueError:
        return 0.0


def note_deadline_exceeded() -> None:
    _DEADLINE_EXCEEDED.inc()


def _program(label: str) -> dict:
    with _lock:
        p = _programs.get(label)
        if p is None:
            p = _programs[label] = {"launches": 0, "compiles": 0, "compile_s": 0.0}
        return p


def launch_counter(label: str) -> _metrics.Counter:
    c = _launch_counters.get(label)
    if c is None:
        c = _launch_counters[label] = _metrics.counter(f"kernel.launches.{label}")
        _program(label)
    return c


def launch_count(label: str) -> int:
    return launch_counter(label).value


def reset_launches(*labels: str) -> None:
    """Set the named labels' launch counts to 0 (all of them when none is
    named): the registry counters and the program summary alike."""
    for label in labels or tuple(LABELS.values()):
        launch_counter(label).reset()
        with _lock:
            _programs[label]["launches"] = 0


@contextlib.contextmanager
def observed_launch(label: str, device=None) -> Iterator[None]:
    """Bracket one kernel launch: count it when the body returns, and probe
    its device time under `HYPERSPACE_DEVICE_TIMING` (one env read off)."""
    counter = launch_counter(label)
    probe = _devobs.probe_start(label, device)
    yield
    counter.inc()
    p = _programs[label]
    with _lock:
        p["launches"] += 1
    from . import tracing as _tracing

    sp = _tracing.current_span()
    if sp is not None:
        sp.inc_attr(f"launches.{label}", 1)
    if probe is not None:
        _devobs.probe_finish(label, probe, device)


def observed_build(build, *args):
    """Run one library build `build(*args)`: the `device.compile` fault
    point first, then the build, timed and counted."""
    from . import accounting as _accounting
    from . import faults as _faults
    from . import tracing as _tracing

    _faults.check("device.compile")
    t0 = time.monotonic()
    out = build(*args)
    dt = time.monotonic() - t0
    _COMPILES.inc()
    _COMPILE_SECONDS.observe(dt)
    p = _program(LIBRARY_LABEL)
    with _lock:
        p["compiles"] += 1
        p["compile_s"] += dt
    sp = _tracing.current_span()
    if sp is not None:
        sp.inc_attr("xla_compiles", 1)
        sp.inc_attr("xla_compile_s", round(dt, 6))
    _accounting.add("xla_compiles", 1)
    _accounting.add("xla_compile_s", round(dt, 6))
    return out


def program_summary() -> dict:
    """Per label: launches, compiles and compile_s, labels sorted."""
    with _lock:
        return {lbl: {"launches": p["launches"], "compiles": p["compiles"], "compile_s": round(p["compile_s"], 4)}
                for lbl, p in sorted(_programs.items())}


def reset_programs() -> None:
    """Zero the program summary and the launch counters in place (tests)."""
    with _lock:
        for p in _programs.values():
            p.update(launches=0, compiles=0, compile_s=0.0)
    for c in list(_launch_counters.values()):
        c.reset()


def launch_view(module_name: str, label: str) -> None:
    """Give module `module_name` a read-only `launches` attribute: the
    registry count of `label`."""
    module = sys.modules[module_name]

    class _LaunchView(types.ModuleType):
        @property
        def launches(self) -> int:
            return launch_count(label)

    module.__class__ = _LaunchView
    launch_counter(label)

"""Continuous metrics export: periodic JSONL frames and Prometheus text
(counterpart of `hyperspace_tpu/telemetry/exporter.py`, same env knobs,
frame keys and metric names).

A daemon thread appends one JSON frame per `HYPERSPACE_METRICS_INTERVAL_S`
(default 10 s) to `HYPERSPACE_METRICS_FILE`, rotated at
`HYPERSPACE_METRICS_MAX_MB` (`rotation.append`). A frame is `{"schema_version",
"ts", "seq", "interval_s", "snapshot", "ledgers", "compile_programs",
"reliability", "replica_id"}` and, when they have something, `"tenants"`,
`"slo"`, `"history"`, `"device_live_bytes"` (with its age), `"device"` and
`"planner"`; the last frame carries `"final": true`.

- `snapshot` is the registry's (histograms with p50 / p90 / p99),
  `ledgers` every ledger closed since the last frame
  (`accounting.drain_pending`), `compile_programs` the kernel launches per
  label and the kernel library's builds (`compile_log.program_summary`).
- `device_live_bytes` is `torch.cuda.memory_allocated`, read only when this
  process already holds a CUDA context (`torch.cuda.is_initialized()`): the
  exporter's thread never initializes CUDA.
- `replica_id` is the process's fleet identity
  (`serve.replicas.replica_id`, fleet on or off); `slo` the serving lanes'
  objectives and burn rates (`telemetry.slo.summary`), omitted while no
  lane has run.
- Off by default: no env, no thread, no file. `stop()` wakes the thread,
  joins it and writes the final frame; `atexit` and, on the main thread, a
  SIGTERM / SIGINT chain stop a running exporter. One write and flush a
  frame, under a lock.

`prometheus_text()` renders the registry in the Prometheus text format on
demand: counters, gauges, histograms with cumulative `le` buckets, `_sum`
and `_count`, the per-tenant counters, the lane-labeled SLO series and the
`replica_info` series (labels `replica_id`, `host`, `pid`).
"""

from __future__ import annotations

import atexit
import json
import math
import os
import signal
import socket
import threading
import time
from typing import Optional

from . import metrics as _metrics

ENV_METRICS_FILE = "HYPERSPACE_METRICS_FILE"
ENV_METRICS_INTERVAL = "HYPERSPACE_METRICS_INTERVAL_S"
_DEFAULT_INTERVAL_S = 10.0

#: Frame schema version: bumped only for a change a reader that ignores
#: unknown keys could not absorb.
SCHEMA_VERSION = 1

# An RLock: the signal handler runs stop() on the main thread, which may be
# inside start() or stop() holding this lock already.
_lock = threading.RLock()
_exporter: Optional["MetricsExporter"] = None


def _interval_from_env() -> float:
    try:
        v = float(os.environ.get(ENV_METRICS_INTERVAL, "") or _DEFAULT_INTERVAL_S)
    except ValueError:
        v = _DEFAULT_INTERVAL_S
    return max(0.01, v)


def _device_live_bytes():
    """(bytes, age_s) from the accounting sampler on the current CUDA device,
    or (None, None) when this process has no CUDA context."""
    import torch

    if not torch.cuda.is_initialized():
        return None, None
    from . import accounting as _accounting

    return _accounting.device_live_bytes_sample("cuda")


class MetricsExporter:
    """One export stream (`start` / `stop` manage the process's; tests make
    their own)."""

    def __init__(self, path: str, interval_s: float):
        self.path = path
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._write_lock = threading.Lock()
        self._seq = 0
        self._thread = threading.Thread(target=self._run, name="hyperspace-metrics-exporter", daemon=True)

    def start(self) -> "MetricsExporter":
        self._thread.start()
        return self

    @property
    def running(self) -> bool:
        return self._thread.is_alive()

    def _frame(self, final: bool = False) -> dict:
        from .. import resilience as _resilience
        from ..plananalysis import planner as _planner
        from . import accounting, compile_log
        from . import device_observatory as _devobs
        from . import history as _history

        out = {
            "schema_version": SCHEMA_VERSION,
            "ts": round(time.time(), 6),
            "seq": self._seq,
            "interval_s": self.interval_s,
            "snapshot": _metrics.snapshot(),
            "ledgers": accounting.drain_pending(),
            "compile_programs": compile_log.program_summary(),
        }
        try:
            from ..serve.replicas import replica_id as _rid

            out["replica_id"] = _rid()
        except Exception:
            pass
        out["reliability"] = _resilience.reliability_rollup(out["snapshot"])
        tenants = accounting.tenant_rollup()
        if tenants:
            out["tenants"] = tenants
        from . import slo as _slo

        slo_state = _slo.summary()
        if slo_state:
            out["slo"] = slo_state
        hist = _history.frame_summary()
        if hist:
            out["history"] = hist
        dev, age = _device_live_bytes()
        if dev is not None:
            out["device_live_bytes"] = dev
            if age is not None:
                out["device_live_bytes_age_s"] = round(age, 3)
            _metrics.gauge("device.live_bytes").set(dev)
        programs, pads, transfers = _devobs.device_summary(), _devobs.pad_summary(), _devobs.transfer_summary()
        if programs or pads or any(t["count"] for t in transfers.values()):
            out["device"] = {"programs": programs, "pads": pads, "transfers": transfers}
        activity = _planner.activity_summary()
        if activity:
            out["planner"] = activity
        if final:
            out["final"] = True
        return out

    def _write_frame(self, final: bool = False) -> None:
        try:
            from . import rotation as _rotation

            line = json.dumps(self._frame(final), default=str)
            with self._write_lock:
                self._seq += 1
                # A final frame that trips the cap lands in the fresh file.
                _rotation.append(self.path, line + "\n", _rotation.ENV_METRICS_MAX_MB)
        except Exception:
            pass  # telemetry never fails the process it observes

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._write_frame()

    def stop(self, timeout: float = 5.0) -> None:
        """Wake and join the thread, then append the final frame."""
        self._stop.set()
        self._thread.join(timeout)
        self._write_frame(final=True)


def running() -> bool:
    e = _exporter
    return e is not None and e.running


_signals_installed = False


def _install_signal_handlers() -> None:
    """Chain SIGTERM and SIGINT so a killed process still writes its final
    frame; the previous handler (or the default action, re-delivered) runs
    after. Only the main thread may install handlers."""
    global _signals_installed
    if _signals_installed or threading.current_thread() is not threading.main_thread():
        return
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev = signal.getsignal(sig)

            def _handler(signum, frame, _prev=prev):
                stop()
                if callable(_prev):
                    _prev(signum, frame)
                elif _prev == signal.SIG_DFL:
                    # Death by the signal stays visible in the exit status.
                    signal.signal(signum, signal.SIG_DFL)
                    os.kill(os.getpid(), signum)

            signal.signal(sig, _handler)
        except (ValueError, OSError):
            return
    _signals_installed = True


def start(path: Optional[str] = None, interval_s: Optional[float] = None) -> bool:
    """Start the process's exporter (a running one wins); `path` defaults to
    `HYPERSPACE_METRICS_FILE`. False with no path."""
    global _exporter
    with _lock:
        if _exporter is not None and _exporter.running:
            return True
        path = path or os.environ.get(ENV_METRICS_FILE)
        if not path:
            return False
        try:
            _exporter = MetricsExporter(path, _interval_from_env() if interval_s is None else interval_s).start()
        except Exception:
            _exporter = None
            return False
    # Outside the lock: a signal landing now runs stop() on this thread.
    _install_signal_handlers()
    return True


def stop(timeout: float = 5.0) -> None:
    """Stop the process's exporter and write its final frame; a no-op
    without one, safe to repeat and from `atexit`."""
    global _exporter
    with _lock:
        e, _exporter = _exporter, None
    if e is not None and e.running:
        e.stop(timeout)


def maybe_start_from_env() -> bool:
    """Start the stream iff `HYPERSPACE_METRICS_FILE` is set (the package's
    import calls this)."""
    if not os.environ.get(ENV_METRICS_FILE):
        return False
    return start()


atexit.register(stop)


def _prom_name(name: str) -> str:
    out = "".join(c if (c.isalnum() or c == "_") else "_" for c in name)
    return out if not out[:1].isdigit() else "_" + out


def _prom_num(v) -> str:
    if isinstance(v, float) and math.isinf(v):
        return "+Inf"
    return repr(float(v)) if isinstance(v, float) else str(v)


def _prom_label(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def prometheus_text(prefix: str = "hyperspace") -> str:
    """The registry in the Prometheus text exposition format, the tenant
    rollup as counters labeled by `tenant`, the SLO state as series labeled
    by `lane`, and the process's `replica_info` series."""
    reg = _metrics.global_registry()
    with reg._lock:
        counters = list(reg._counters.values())
        gauges = list(reg._gauges.values())
        hists = list(reg._histograms.values())
    lines = []
    for c in counters:
        n = f"{prefix}_{_prom_name(c.name)}"
        lines += [f"# TYPE {n} counter", f"{n} {c.value}"]
    for g in gauges:
        n = f"{prefix}_{_prom_name(g.name)}"
        lines += [f"# TYPE {n} gauge", f"{n} {_prom_num(g.value)}"]
    for h in hists:
        n = f"{prefix}_{_prom_name(h.name)}"
        count, total, buckets = h.export_state()  # one lock: _count == the +Inf bucket
        lines.append(f"# TYPE {n} histogram")
        lines += [f'{n}_bucket{{le="{_prom_num(le)}"}} {cum}' for le, cum in buckets]
        lines += [f"{n}_sum {_prom_num(round(total, 6))}", f"{n}_count {count}"]
    from . import accounting as _accounting

    tenants = _accounting.tenant_rollup()
    for field in sorted({f for t in tenants.values() for f in t}):
        n = f"{prefix}_tenant_{_prom_name(field)}"
        lines.append(f"# TYPE {n} counter")
        for tenant in sorted(tenants):
            v = tenants[tenant].get(field)
            if v is not None:
                lines.append(f'{n}{{tenant="{_prom_label(tenant)}"}} {_prom_num(v)}')
    from . import slo as _slo

    slo_state = _slo.summary()
    for field, mtype in (("objective_ms", "gauge"), ("compliance", "gauge"), ("burn_5m", "gauge"),
                         ("burn_1h", "gauge"), ("total", "counter"), ("violations", "counter")):
        n = f"{prefix}_slo_{_prom_name(field)}"
        series = [(lane, slo_state[lane].get(field)) for lane in sorted(slo_state)]
        series = [(lane, v) for lane, v in series if v is not None]
        if series:
            lines.append(f"# TYPE {n} {mtype}")
            lines += [f'{n}{{lane="{lane}"}} {_prom_num(v)}' for lane, v in series]
    try:
        from ..serve.replicas import replica_id as _rid

        n = f"{prefix}_replica_info"
        lines.append(f"# TYPE {n} gauge")
        lines.append(f'{n}{{replica_id="{_prom_label(_rid())}",host="{_prom_label(socket.gethostname())}",'
                     f'pid="{os.getpid()}"}} 1')
    except Exception:
        pass
    return "\n".join(lines) + "\n"

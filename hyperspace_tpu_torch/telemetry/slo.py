"""Serving SLOs: per-lane latency objectives and error-budget burn rates
(counterpart of `hyperspace_tpu/telemetry/slo.py`, same env knobs, metric
names and summary fields).

- Objectives: `HYPERSPACE_SLO_INTERACTIVE_P99_MS` (250),
  `HYPERSPACE_SLO_BATCH_P99_MS` (5000), `HYPERSPACE_SLO_<LANE>_P99_MS` for
  another lane; one compliance target `HYPERSPACE_SLO_TARGET` (0.99).
- Observation: `serve.scheduler` calls `observe(lane, wall_s, tenant,
  failed)` at every served completion, in the concurrent and the
  `HYPERSPACE_SERVING=0` paths alike: the latency is the client's, from
  admission to result, queue wait included. A failed query is a violation
  however fast it failed.
- Burn rates over sliding windows of 5 min and 1 h: `burn = error rate /
  (1 - target)`. A burn of `FAST_BURN_THRESHOLD` (14.4) or more over the
  short window with at least `FAST_BURN_MIN_EVENTS` events ticks
  `slo.fast_burn_alerts`, warns once a lane and asks
  `device_observatory.maybe_capture` for a profile window.

Surfaces: the `slo.<lane>.total` / `slo.<lane>.violations` counters, the
exporter frame's `slo` key and its lane-labeled Prometheus series.
`compliance_over(records)` judges stored ledgers (a history directory) by
the same objectives. The monitor is process-wide, as lanes are.
"""

from __future__ import annotations

import os
import threading
import time
import warnings
from collections import deque
from typing import Dict, Optional

from . import metrics as _metrics

ENV_TARGET = "HYPERSPACE_SLO_TARGET"
ENV_INTERACTIVE_P99_MS = "HYPERSPACE_SLO_INTERACTIVE_P99_MS"
ENV_BATCH_P99_MS = "HYPERSPACE_SLO_BATCH_P99_MS"

_DEFAULT_TARGET = 0.99
_DEFAULT_OBJECTIVE_MS = {"interactive": 250.0, "batch": 5000.0}
_FALLBACK_OBJECTIVE_MS = 5000.0

#: (window seconds, label), short to long.
WINDOWS = ((300.0, "5m"), (3600.0, "1h"))
#: The fast-burn page threshold on the short window.
FAST_BURN_THRESHOLD = 14.4
#: Events the short window needs before a fast burn can fire.
FAST_BURN_MIN_EVENTS = 20

#: Events kept a lane: past that rate a window covers less than its span,
#: which `summary()` reports as `window_<w>_covered_s`.
_EVENTS_MAXLEN = 65536

#: Tenants kept a lane; the rest fold into `TENANT_OVERFLOW`.
TENANT_MAX = 256
TENANT_OVERFLOW = "<other>"

_FAST_BURN_ALERTS = _metrics.counter("slo.fast_burn_alerts")


def target() -> float:
    try:
        v = float(os.environ.get(ENV_TARGET, "") or _DEFAULT_TARGET)
    except ValueError:
        v = _DEFAULT_TARGET
    return min(max(v, 0.5), 0.99999)


def objective_ms(lane: str) -> float:
    env = os.environ.get(f"HYPERSPACE_SLO_{lane.upper()}_P99_MS")
    if env:
        try:
            v = float(env)
            if v > 0:
                return v
        except ValueError:
            pass
    return _DEFAULT_OBJECTIVE_MS.get(lane, _FALLBACK_OBJECTIVE_MS)


def _burn(bad: int, total: int) -> float:
    budget = 1.0 - target()
    return (bad / total) / budget if budget > 0 else float(bad)


class SLOMonitor:
    """Per-lane sliding windows, lifetime totals and per-tenant compliance."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: Dict[str, deque] = {}
        self._totals: Dict[str, list] = {}  # lane -> [total, violations]
        self._tenants: Dict[str, Dict[str, list]] = {}  # lane -> tenant -> [total, violations]
        self._fast_burn_warned: set = set()
        # lane -> [last check (monotonic), completions since]: the window walk
        # runs once a second or every FAST_BURN_MIN_EVENTS completions.
        self._fast_check: Dict[str, list] = {}

    def observe(self, lane: str, wall_s: float, tenant: Optional[str] = None, failed: bool = False) -> None:
        lane = lane or "batch"
        ok = (not failed) and (wall_s * 1000.0) <= objective_ms(lane)
        now = time.monotonic()
        with self._lock:
            ev = self._events.get(lane)
            if ev is None:
                ev = self._events[lane] = deque(maxlen=_EVENTS_MAXLEN)
            ev.append((now, ok))
            tot = self._totals.setdefault(lane, [0, 0])
            tot[0] += 1
            if not ok:
                tot[1] += 1
            if tenant is not None:
                tmap = self._tenants.setdefault(lane, {})
                if tenant not in tmap and len(tmap) >= TENANT_MAX:
                    tenant = TENANT_OVERFLOW
                tt = tmap.setdefault(tenant, [0, 0])
                tt[0] += 1
                if not ok:
                    tt[1] += 1
            fc = self._fast_check.setdefault(lane, [0.0, 0])
            fc[1] += 1
            due = (now - fc[0] >= 1.0) or fc[1] >= FAST_BURN_MIN_EVENTS
            if due:
                fc[0], fc[1] = now, 0
        _metrics.counter(f"slo.{lane}.total").inc()
        if not ok:
            _metrics.counter(f"slo.{lane}.violations").inc()
        if due:
            self._maybe_fast_burn(lane)

    def _window_stats(self, lane: str, window_s: float, now: float):
        """(total, bad, covered seconds) of the trailing window (lock held)."""
        ev = self._events.get(lane)
        if not ev:
            return 0, 0, 0.0
        cutoff = now - window_s
        total = bad = 0
        oldest = now
        for ts, ok in reversed(ev):
            if ts < cutoff:
                break
            total += 1
            oldest = ts
            if not ok:
                bad += 1
        return total, bad, (now - oldest if total else 0.0)

    def burn_rate(self, lane: str, window_s: float) -> Optional[float]:
        """Error rate over error budget in the trailing window; None before
        any event in it."""
        with self._lock:
            total, bad, _ = self._window_stats(lane, window_s, time.monotonic())
        return None if total == 0 else _burn(bad, total)

    def _maybe_fast_burn(self, lane: str) -> None:
        with self._lock:
            total, bad, _ = self._window_stats(lane, WINDOWS[0][0], time.monotonic())
        if total < FAST_BURN_MIN_EVENTS:
            return
        burn = _burn(bad, total)
        if burn < FAST_BURN_THRESHOLD:
            return
        _FAST_BURN_ALERTS.inc()
        try:
            from . import device_observatory as _devobs

            _devobs.maybe_capture("slo_fast_burn", {"lane": lane, "burn": round(burn, 2), "window": WINDOWS[0][1]})
        except Exception:
            pass  # a capture never fails a completion
        if lane in self._fast_burn_warned:
            return
        self._fast_burn_warned.add(lane)
        warnings.warn(
            f"hyperspace SLO: lane '{lane}' is fast-burning its error budget (burn {burn:.1f}x over the last "
            f"{WINDOWS[0][1]}; objective {objective_ms(lane):g} ms at target {target():.2%}). Further alerts "
            "tick slo.fast_burn_alerts silently.",
            RuntimeWarning,
            stacklevel=3,
        )

    def summary(self) -> dict:
        """Per lane: objective, target, lifetime totals and compliance, the
        windows' burn rates, event counts and covered seconds, the fast-burn
        flag and per-tenant compliance. Empty before any observation."""
        now = time.monotonic()
        out = {}
        with self._lock:
            for lane, (total, violations) in self._totals.items():
                entry = {
                    "objective_ms": objective_ms(lane),
                    "target": target(),
                    "total": total,
                    "violations": violations,
                    "compliance": round(1.0 - violations / total, 6) if total else None,
                }
                for window_s, label in WINDOWS:
                    wt, wb, cov = self._window_stats(lane, window_s, now)
                    if wt:
                        entry[f"burn_{label}"] = round(_burn(wb, wt), 4)
                        entry[f"window_{label}_n"] = wt
                        entry[f"window_{label}_covered_s"] = round(cov, 1)
                entry["fast_burn"] = lane in self._fast_burn_warned
                tmap = self._tenants.get(lane)
                if tmap:
                    entry["tenants"] = {
                        t: {"total": tv[0], "violations": tv[1], "compliance": round(1.0 - tv[1] / tv[0], 6)}
                        for t, tv in sorted(tmap.items())
                    }
                out[lane] = entry
        return out

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._totals.clear()
            self._tenants.clear()
            self._fast_burn_warned.clear()


_MONITOR = SLOMonitor()


def monitor() -> SLOMonitor:
    return _MONITOR


def observe(lane: str, wall_s: float, tenant: Optional[str] = None, failed: bool = False) -> None:
    _MONITOR.observe(lane, wall_s, tenant, failed=failed)


def summary() -> dict:
    return _MONITOR.summary()


def reset() -> None:
    _MONITOR.reset()


def compliance_over(records, lane_key: str = "lane", wall_key: str = "wall_s") -> dict:
    """SLO compliance over stored ledgers (dicts, e.g. a history
    directory's): the live objectives and target applied to recorded walls,
    a ledger of `status` "error" a violation whatever its wall. The live
    monitor's latency starts at admission, a ledger's at execution."""
    lanes: Dict[str, list] = {}
    for led in records:
        lane, wall = led.get(lane_key), led.get(wall_key)
        if lane is None or not isinstance(wall, (int, float)):
            continue
        tot = lanes.setdefault(lane, [0, 0])
        tot[0] += 1
        if led.get("status") == "error" or wall * 1000.0 > objective_ms(lane):
            tot[1] += 1
    return {
        lane: {
            "objective_ms": objective_ms(lane),
            "target": target(),
            "total": t,
            "violations": v,
            "compliance": round(1.0 - v / t, 6) if t else None,
            "met": (1.0 - v / t) >= target() if t else None,
        }
        for lane, (t, v) in sorted(lanes.items())
    }

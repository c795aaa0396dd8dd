"""Process-wide metrics registry: named counters, gauges and histograms
(counterpart of `hyperspace_tpu/telemetry/metrics.py`).

The one place the port reports to, under the JAX package's metric names:
the scan caches (`cache.<name>.hits|misses|evictions|bytes`), the join
memos (`memo.<tag>.hits|misses`, `memo.evictions`,
`memo.device_cache.bytes[_peak]`), the scan layer (`io.*`), the resilience
layer (`io.retries.*`, `query.timeouts`), the fault points
(`faults.injected`, `faults.<point>.injected`), the optimizer rules
(`rule.<Rule>.applied|skipped`) and the CUDA kernels
(`kernel.launches.<label>`, see `compile_log.observed_launch`).

- Each metric is a lock-guarded singleton per name: increments from any
  thread are never lost.
- `snapshot()` is a point-in-time copy of plain dicts, with the derived hit
  `rates` of every `<base>.hits`/`<base>.misses` pair.
- Metrics are always on: an integer add per event, one object per name.

The registry belongs to this package alone: a process that also imports the
JAX package holds two registries, and each package's `counters_delta` is
read against its own snapshots.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, List, Optional, Tuple


class Counter:
    """Monotonic counter; `inc` is atomic under the metric's own lock."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += int(n)

    def reset(self) -> None:
        with self._lock:
            self._value = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins scalar; `add` (and `inc`/`dec`) accounts up and down
    race-free, `set_max` keeps a high-water mark."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    def add(self, n) -> None:
        with self._lock:
            self._value += n

    def inc(self, n=1) -> None:
        self.add(n)

    def dec(self, n=1) -> None:
        self.add(-n)

    def set_max(self, v) -> None:
        with self._lock:
            if v > self._value:
                self._value = v

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0

    @property
    def value(self):
        with self._lock:
            return self._value


#: Log-spaced bucket upper bounds, 4 per decade over 1e-6 .. 1e10, with the
#: cumulative-`le` semantics of a Prometheus histogram: one fixed array per
#: histogram. A quantile is exact to a bucket's width (10^0.25, 1.78x); the
#: extremes ride `min`/`max`.
BUCKET_BOUNDS: Tuple[float, ...] = tuple(10.0 ** (k / 4.0) for k in range(-24, 41))
_N_BUCKETS = len(BUCKET_BOUNDS) + 1  # + overflow (+Inf)


class Histogram:
    """count / total / min / max and the log buckets, so `summary()` also
    carries p50/p90/p99. Fixed memory per name."""

    __slots__ = ("name", "_lock", "count", "total", "min", "max", "_buckets")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._buckets = [0] * _N_BUCKETS

    def observe(self, v) -> None:
        v = float(v)
        # A non-positive observation lands in the first bucket; an exact
        # boundary value in its own bucket.
        idx = bisect.bisect_left(BUCKET_BOUNDS, v) if v > 0.0 else 0
        with self._lock:
            self.count += 1
            self.total += v
            self.min = v if self.min is None or v < self.min else self.min
            self.max = v if self.max is None or v > self.max else self.max
            self._buckets[idx] += 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0
            self.total = 0.0
            self.min = None
            self.max = None
            self._buckets = [0] * _N_BUCKETS

    def _quantile_locked(self, q: float) -> Optional[float]:
        if self.count == 0:
            return None
        rank = max(1, math.ceil(q * self.count))
        cum = 0
        for i, n in enumerate(self._buckets):
            if n == 0:
                continue
            if cum + n >= rank:
                lo = BUCKET_BOUNDS[i - 1] if i > 0 else 0.0
                hi = BUCKET_BOUNDS[i] if i < len(BUCKET_BOUNDS) else (self.max if self.max is not None else lo)
                est = lo + (hi - lo) * ((rank - cum) / n)
                # Never claim a value outside what was observed.
                if self.min is not None:
                    est = max(est, self.min)
                if self.max is not None:
                    est = min(est, self.max)
                return est
            cum += n
        return self.max

    def quantile(self, q: float) -> Optional[float]:
        """Estimated q-quantile (0 < q <= 1), clamped to [min, max]; None
        before any observation."""
        with self._lock:
            return self._quantile_locked(q)

    def bucket_counts(self) -> List[Tuple[float, int]]:
        """Cumulative (upper bound, count <= bound) pairs of the non-empty
        range plus the +Inf total; empty before any observation."""
        return self.export_state()[2]

    def summary(self) -> dict:
        with self._lock:
            out = {"count": self.count, "total": round(self.total, 6), "min": self.min, "max": self.max}
            if self.count:
                for key, q in (("p50", 0.5), ("p90", 0.9), ("p99", 0.99)):
                    v = self._quantile_locked(q)
                    out[key] = None if v is None else round(v, 6)
            return out

    def dump_state(self) -> dict:
        """The JSON state the history store checkpoints (`metrics.py:201` of
        the JAX package, same keys): count, total, min/max and the non-empty
        bucket slots by index."""
        with self._lock:
            out = {"count": self.count, "total": round(self.total, 9)}
            if self.min is not None:
                out["min"] = self.min
                out["max"] = self.max
            buckets = {str(i): n for i, n in enumerate(self._buckets) if n}
            if buckets:
                out["buckets"] = buckets
            return out

    def merge_state(self, state: dict) -> None:
        """Add a `dump_state` payload into this histogram. Everything is
        parsed before anything changes: a malformed record neither raises
        nor half-merges; a non-number min or max is dropped."""
        if not isinstance(state, dict):
            return
        try:
            count = int(state.get("count", 0))
            total = float(state.get("total", 0.0))
        except (TypeError, ValueError):
            return

        def num(v):
            return float(v) if isinstance(v, (int, float)) and not isinstance(v, bool) else None

        mn, mx = num(state.get("min")), num(state.get("max"))
        buckets = []
        raw = state.get("buckets")
        if isinstance(raw, dict):
            for key, n in raw.items():
                try:
                    i, cnt = int(key), int(n)
                except (TypeError, ValueError):
                    continue
                if 0 <= i < _N_BUCKETS:
                    buckets.append((i, cnt))
        with self._lock:
            self.count += count
            self.total += total
            if mn is not None:
                self.min = mn if self.min is None else min(self.min, mn)
            if mx is not None:
                self.max = mx if self.max is None else max(self.max, mx)
            for i, cnt in buckets:
                self._buckets[i] += cnt

    def export_state(self) -> Tuple[int, float, List[Tuple[float, int]]]:
        """(count, total, cumulative buckets) read under one lock hold."""
        with self._lock:
            out: List[Tuple[float, int]] = []
            if self.count:
                cum = 0
                for i, n in enumerate(self._buckets):
                    cum += n
                    if n and i < len(BUCKET_BOUNDS):
                        out.append((BUCKET_BOUNDS[i], cum))
                out.append((math.inf, self.count))
            return self.count, self.total, out


class MetricsRegistry:
    """Name -> metric. Creation is get-or-create under the registry lock;
    each metric then takes only its own lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def _get(self, table: dict, cls, name: str):
        with self._lock:
            m = table.get(name)
            if m is None:
                m = table[name] = cls(name)
            return m

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, Counter, name)

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, Gauge, name)

    def histogram(self, name: str) -> Histogram:
        return self._get(self._histograms, Histogram, name)

    def snapshot(self) -> dict:
        """Every metric's value, JSON-serializable, with the hit `rates` of
        each `<base>.hits` / `<base>.misses` counter pair."""
        with self._lock:
            counters = {n: c.value for n, c in self._counters.items()}
            gauges = {n: g.value for n, g in self._gauges.items()}
            hists = {n: h.summary() for n, h in self._histograms.items()}
        rates = {}
        for name, hits in counters.items():
            # Exact last segment: "memo.pairs.peek_hits" has no miss twin.
            base, _, leaf = name.rpartition(".")
            if leaf != "hits" or not base:
                continue
            total = hits + counters.get(base + ".misses", 0)
            if total:
                rates[base] = round(hits / total, 4)
        out = {"counters": counters}
        if gauges:
            out["gauges"] = gauges
        if hists:
            out["histograms"] = hists
        if rates:
            out["rates"] = rates
        return out

    def reset(self) -> None:
        """Zero every metric in place (tests). The objects stay registered:
        hot paths bind them once at import."""
        with self._lock:
            metrics = list(self._counters.values()) + list(self._gauges.values()) + list(self._histograms.values())
        for m in metrics:
            m.reset()


_REGISTRY = MetricsRegistry()


def global_registry() -> MetricsRegistry:
    return _REGISTRY


def counter(name: str) -> Counter:
    return _REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return _REGISTRY.gauge(name)


def histogram(name: str) -> Histogram:
    return _REGISTRY.histogram(name)


def snapshot() -> dict:
    return _REGISTRY.snapshot()


def counters_delta(before: dict, after: dict) -> dict:
    """The counters whose value changed between two `snapshot()`s, and by how
    much (what `explain(analyze=True)` prints for one query)."""
    b = before.get("counters", {})
    out = {}
    for name, v in after.get("counters", {}).items():
        d = v - b.get(name, 0)
        if d:
            out[name] = d
    return out

"""Per-query resource ledger: what each query spent (counterpart of
`hyperspace_tpu/telemetry/accounting.py`).

One `QueryLedger` rides each root query scope (the boundary
`tracing.query_span` opens). Engine hooks call `add(key, n)`, which resolves
the ambient ledger through a contextvar: one contextvar read with no ledger.
Pool workers adopt the submitter's ledger with `use_ledger`.

Fields (`_COUNTER_FIELDS`, the JAX package's names): `bytes_decoded` /
`bytes_skipped` (pruned decodes, the same values as the
`io.pruning.bytes_*` counters), `decode_files` / `decode_task_s` (decode
pool work charged to the submitting query), `rows_produced` (the root
result), `cache_bytes_charged` / `cache_bytes_evicted`,
`device_upload_bytes` (host-to-device copies), `d2h_bytes`,
`pad_bytes_payload` / `pad_bytes_padded` (the join's bucket pads), the
encoded-staging split; besides them `device_time_s` (CUDA-event probes,
`device_observatory`), `xla_compiles` / `xla_compile_s` (in the port: the
kernel library's build, `compile_log`), `io_retries`, `faults_injected`,
`plan_fingerprint`, `planner` and `stages`.

`device_live_bytes` is `torch.cuda.memory_allocated` of the query's CUDA
device sampled at close (at most once a second, with its age), and absent
for a CPU session.

A closed ledger lands on the root span (`attrs["ledger"]`), in a bounded
history (`recent_ledgers`, `ledger_for`), in the exporter's bounded queue
(`drain_pending`), in the `accounting.<field>` counters, in the
`latency.<root name>` histogram and, under `HYPERSPACE_HISTORY=1`, in the
workload history store (`history.land`). A ledger records the serving
lane at open (`resilience.current_lane`) and, at close, the process's
replica id (`serve.replicas.replica_id`, fleet on or off), as the JAX
package's does.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
from collections import deque
from typing import Iterator, List, Optional

from . import history as _history
from . import metrics as _metrics
from . import stage_ledger as _stage_ledger

ENV_ACCOUNTING = "HYPERSPACE_ACCOUNTING"

_COUNTER_FIELDS = (
    "bytes_decoded",
    "bytes_skipped",
    "bytes_encoded_kept",
    "bytes_materialized",
    "decode_files",
    "rows_produced",
    "cache_bytes_charged",
    "cache_bytes_evicted",
    "device_upload_bytes",
    "d2h_bytes",
    "pad_bytes_payload",
    "pad_bytes_padded",
    "device_code_bytes_flat",
    "device_code_bytes_staged",
    "device_code_bytes_packed",
)

_current: "contextvars.ContextVar[Optional[QueryLedger]]" = contextvars.ContextVar(
    "hyperspace_torch_query_ledger", default=None
)
_tenant: "contextvars.ContextVar[Optional[str]]" = contextvars.ContextVar(
    "hyperspace_torch_tenant", default=None
)

_TENANT_FIELDS = ("wall_s", "bytes_decoded", "decode_files", "rows_produced", "cache_bytes_charged", "io_retries")
_tenant_totals: dict = {}
_tenant_lock = threading.Lock()
#: Tenant labels past this many aggregate into "<other>" (totals stay exact).
TENANT_ROLLUP_MAX = 256
TENANT_OVERFLOW = "<other>"

_RECENT: "deque[QueryLedger]" = deque(maxlen=32)
_recent_lock = threading.Lock()
#: Closed ledgers for the exporter's next frame; bounded, so with no
#: exporter the oldest age out.
_PENDING: "deque[dict]" = deque(maxlen=256)


class QueryLedger:
    """Thread-safe resource accumulator for one root query scope."""

    __slots__ = ("query_id", "name", "tenant", "lane", "start_s", "wall_s", "_lock", "_counts", "stage_attr",
                 "device", "probes")

    def __init__(self, query_id: str, name: str, tenant: Optional[str] = None, lane: Optional[str] = None):
        self.query_id = query_id
        self.name = name
        self.tenant = tenant
        self.lane = lane
        self.start_s = time.time()
        self.wall_s: Optional[float] = None
        self._lock = threading.Lock()
        self._counts: dict = {}
        #: Stage attribution, read once at open (`stage_ledger.enabled`).
        self.stage_attr = False
        #: The session's device, noted by the session (`note_device`).
        self.device = None
        #: CUDA-event pairs of this query's probed launches, read at close.
        self.probes: list = []

    def add(self, key: str, n) -> None:
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + n

    def set_value(self, key: str, n) -> None:
        with self._lock:
            self._counts[key] = n

    def get(self, key: str):
        with self._lock:
            return self._counts.get(key, 0)

    def to_dict(self) -> dict:
        with self._lock:
            out = {"query_id": self.query_id, "name": self.name, "start_s": round(self.start_s, 6)}
            if self.tenant is not None:
                out["tenant"] = self.tenant
            if self.lane is not None:
                out["lane"] = self.lane
            if self.wall_s is not None:
                out["wall_s"] = round(self.wall_s, 6)
            for k in sorted(self._counts):
                v = self._counts[k]
                out[k] = round(v, 6) if isinstance(v, float) else v
            return out


def enabled() -> bool:
    """Whether query scopes carry a ledger: `HYPERSPACE_ACCOUNTING=1`,
    `HYPERSPACE_HISTORY=1` (the store lands closed ledgers), a tenant label,
    an active span sink or a running exporter."""
    if os.environ.get(ENV_ACCOUNTING) == "1" or _history.enabled():
        return True
    if _tenant.get() is not None:
        return True
    from . import exporter, tracing

    return tracing.active() or exporter.running()


def current_ledger() -> Optional[QueryLedger]:
    return _current.get()


def add(key: str, n) -> None:
    """Charge `n` of `key` to the ambient ledger (and, with stage
    attribution on, to the ambient stage); one contextvar read without."""
    led = _current.get()
    if led is not None:
        led.add(key, n)
        if led.stage_attr:
            _stage_ledger.stamp_counter(key, n)


def set_value(key: str, n) -> None:
    """Last-write-wins field on the ambient ledger (root facts such as
    `rows_produced`: the outer action writes last)."""
    led = _current.get()
    if led is not None:
        led.set_value(key, n)


def note_device(device) -> None:
    """Record the session's device on the ambient ledger (what
    `device_live_bytes` samples at close)."""
    led = _current.get()
    if led is not None and led.device is None:
        led.device = device


@contextlib.contextmanager
def use_ledger(led: Optional[QueryLedger]) -> Iterator[None]:
    """Adopt `led` on this thread (a pool worker)."""
    if led is None:
        yield
        return
    token = _current.set(led)
    try:
        yield
    finally:
        _current.reset(token)


@contextlib.contextmanager
def tenant_scope(tenant: Optional[str]) -> Iterator[None]:
    """Label every root query opened under this scope with `tenant`; its
    closed ledgers fold into `tenant_rollup`."""
    if tenant is None:
        yield
        return
    token = _tenant.set(str(tenant))
    try:
        yield
    finally:
        _tenant.reset(token)


def current_tenant() -> Optional[str]:
    return _tenant.get()


def _bank_tenant(led: QueryLedger) -> None:
    if led.tenant is None:
        return
    with _tenant_lock:
        name = led.tenant
        if name not in _tenant_totals and len(_tenant_totals) >= TENANT_ROLLUP_MAX:
            name = TENANT_OVERFLOW
        t = _tenant_totals.setdefault(name, {"queries": 0})
        t["queries"] += 1
        for f in _TENANT_FIELDS:
            v = led.wall_s if f == "wall_s" else led.get(f)
            if v:
                t[f] = round(t.get(f, 0) + v, 6) if isinstance(v, float) else t.get(f, 0) + v


def tenant_rollup() -> dict:
    """Per tenant: queries, wall_s, bytes_decoded, decode_files,
    rows_produced, cache_bytes_charged and io_retries over its ledgers."""
    with _tenant_lock:
        return {k: dict(v) for k, v in _tenant_totals.items()}


def reset_tenant_rollup() -> None:
    with _tenant_lock:
        _tenant_totals.clear()


_DEVICE_SAMPLE_MIN_INTERVAL_S = 1.0
_device_sample_lock = threading.Lock()
# [claim monotonic ts, bytes, value monotonic ts]
_device_sample: list = [-_DEVICE_SAMPLE_MIN_INTERVAL_S, None, None]


def device_live_bytes_sample(device=None) -> "tuple[Optional[int], Optional[float]]":
    """(`torch.cuda.memory_allocated(device)`, the reading's age in seconds)
    on a CUDA device, (None, None) on the CPU; read at most once a second,
    a reused reading coming back with its real age."""
    import torch

    if device is None or torch.device(device).type != "cuda":
        return None, None
    now = time.monotonic()
    with _device_sample_lock:
        if now - _device_sample[0] < _DEVICE_SAMPLE_MIN_INTERVAL_S:
            taken = _device_sample[2]
            return _device_sample[1], (now - taken) if taken is not None else None
        _device_sample[0] = now
    try:
        val = int(torch.cuda.memory_allocated(torch.device(device)))
    except Exception:
        val = None
    with _device_sample_lock:
        _device_sample[1] = val
        _device_sample[2] = time.monotonic()
    if val is not None:
        _metrics.gauge("device.live_bytes.peak").set_max(val)
    return val, 0.0


@contextlib.contextmanager
def ledger_scope(query_id: str, name: str, root=None) -> Iterator[QueryLedger]:
    """The ledger of one root query scope; under an open ledger, that
    ledger. At close: the probed device seconds are read, the host remainder,
    pad ratio, stage vectors and planner annotations derived, the counters
    and the latency histogram fed, and the ledger banked and put on `root`."""
    existing = _current.get()
    if existing is not None:
        yield existing
        return
    # Lazy: resilience imports this module at load.
    from .. import resilience as _resilience

    led = QueryLedger(query_id, name, tenant=_tenant.get(), lane=_resilience.current_lane())
    led.stage_attr = _stage_ledger.enabled()
    token = _current.set(led)
    t0 = time.monotonic()
    try:
        yield led
    except BaseException:
        led.set_value("status", "error")
        raise
    finally:
        _current.reset(token)
        _close(led, root, t0)


def _close(led: QueryLedger, root, t0: float) -> None:
    wall = getattr(root, "duration_s", None) if root is not None else None
    if wall is None:
        wall = time.monotonic() - t0
    led.wall_s = wall
    if led.probes:
        from . import device_observatory as _devobs

        try:
            _devobs.resolve_ledger_probes(led)
        except Exception:
            pass
    dev, age = device_live_bytes_sample(led.device)
    if dev is not None:
        led.add("device_live_bytes", dev)
        if age is not None:
            led.set_value("device_live_bytes_age_s", round(age, 3))
        _metrics.gauge("device.live_bytes").set(dev)
    dev_s = led.get("device_time_s")
    if dev_s:
        led.set_value("host_time_s", round(max(0.0, wall - dev_s), 6))
    pad_payload, pad_padded = led.get("pad_bytes_payload"), led.get("pad_bytes_padded")
    if pad_payload or pad_padded:
        led.set_value("pad_ratio", round(pad_padded / (pad_payload + pad_padded), 4))
    _metrics.histogram(f"latency.{led.name.replace(':', '.')}").observe(wall)
    for field in _COUNTER_FIELDS:
        v = led.get(field)
        if v:
            _metrics.counter(f"accounting.{field}").inc(v)
    if led.stage_attr:
        try:
            stages = _stage_ledger.close_stages(led)
            if stages:
                led.set_value("stages", stages)
        except Exception:
            pass
    if led.get("planner"):
        try:
            from ..plananalysis import planner as _planner

            _planner.annotate_close(led, wall)
        except Exception:
            pass
    try:
        from ..serve.replicas import replica_id as _rid

        led.set_value("replica_id", _rid())
    except Exception:
        pass
    _bank_tenant(led)
    d = led.to_dict()
    if root is not None:
        try:
            root.set_attr("ledger", d)
        except Exception:
            pass
    if _history.enabled():
        _history.land(d, root)
    with _recent_lock:
        _RECENT.append(led)
        _PENDING.append(d)


def recent_ledgers() -> List[QueryLedger]:
    """Closed ledgers, oldest first."""
    with _recent_lock:
        return list(_RECENT)


def ledger_for(query_id: str) -> Optional[QueryLedger]:
    with _recent_lock:
        for led in reversed(_RECENT):
            if led.query_id == query_id:
                return led
    return None


def drain_pending() -> List[dict]:
    """Every ledger closed since the last drain, oldest first (the
    exporter's frames)."""
    out: List[dict] = []
    with _recent_lock:
        while _PENDING:
            out.append(_PENDING.popleft())
    return out


def reset() -> None:
    """Forget the closed ledgers, the exporter's queue and the tenant rollup
    (tests)."""
    with _recent_lock:
        _RECENT.clear()
        _PENDING.clear()
    reset_tenant_rollup()

"""Per-query stage ledger: cost vectors billed to the pipeline stage that
spent them (counterpart of `hyperspace_tpu/telemetry/stage_ledger.py`).

- `stage_scope(name)` marks the current stage in a contextvar. Every
  `StageTimings.timed(stage)` block opens one, so the streamed executors'
  decode/eval/pad/probe/expand/verify/gather/partial brackets label
  themselves; the decode pool's workers bill `decode`, the scans' copies to
  the card `h2d`. Leaving a scope banks its wall seconds on the ambient
  `resilience.QueryScope` (busy time: stages overlap).
- `accounting.add` forwards the cost-vector counters (`_COUNTER_VECTOR`)
  through `stamp_counter` to the ambient stage, or to `<unlabeled>`, so the
  stages' totals equal the query's by construction. Pool workers inherit
  the submitting stage through `worker_stage()`.
- `close_stages()` joins them at the ledger's close: per stage `{wall_s,
  device_s, bytes_decoded, bytes_h2d, bytes_padded, xla_compiles, rows}`, the
  ledger's `stages`.
- `chrome_trace(spans)` turns one exported trace into Chrome-trace JSON, one
  lane per stage, the format of `HYPERSPACE_TIMELINE_DIR` and
  `tools/hstimeline.py`.

On by default; `HYPERSPACE_STAGE_ATTRIBUTION=0` makes a scope one env read.
It only observes: results are the same either way.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

ENV_STAGE_ATTRIBUTION = "HYPERSPACE_STAGE_ATTRIBUTION"
ENV_TIMELINE_DIR = "HYPERSPACE_TIMELINE_DIR"

UNLABELED = "<unlabeled>"

#: Query-ledger counter -> stage cost-vector field.
_COUNTER_VECTOR = {
    "device_time_s": "device_s",
    "bytes_decoded": "bytes_decoded",
    "device_upload_bytes": "bytes_h2d",
    "pad_bytes_padded": "bytes_padded",
    "xla_compiles": "xla_compiles",
}

VECTOR_FIELDS = ("wall_s", "device_s", "bytes_decoded", "bytes_h2d", "bytes_padded", "xla_compiles", "rows")

_stage: "contextvars.ContextVar[Optional[str]]" = contextvars.ContextVar("hyperspace_torch_stage", default=None)


def enabled() -> bool:
    return os.environ.get(ENV_STAGE_ATTRIBUTION, "") != "0"


class StageLedger:
    """Thread-safe per-stage accumulator of one root query scope."""

    __slots__ = ("_lock", "_stages")

    def __init__(self):
        self._lock = threading.Lock()
        self._stages: Dict[str, Dict[str, float]] = {}

    def add(self, stage: str, field: str, n) -> None:
        with self._lock:
            vec = self._stages.setdefault(stage, {})
            vec[field] = vec.get(field, 0) + n

    def wall_snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {st: float(vec["wall_s"]) for st, vec in self._stages.items() if vec.get("wall_s")}

    def snapshot(self) -> Dict[str, dict]:
        """Per-stage vectors in `VECTOR_FIELDS` order, zeros dropped."""
        with self._lock:
            out: Dict[str, dict] = {}
            for st in sorted(self._stages):
                vec = self._stages[st]
                row = {}
                for f in VECTOR_FIELDS:
                    v = vec.get(f)
                    if v:
                        row[f] = round(v, 6) if isinstance(v, float) else v
                if row:
                    out[st] = row
            return out


def _scope_ledger(create: bool) -> Optional[StageLedger]:
    from .. import resilience as _resilience

    sc = _resilience.current_scope()
    if sc is None:
        return None
    sl = sc.stage_ledger
    if sl is None and create:
        with sc._lock:
            sl = sc.stage_ledger
            if sl is None:
                sl = sc.stage_ledger = StageLedger()
    return sl


def current_stage() -> Optional[str]:
    return _stage.get()


def worker_stage(default: Optional[str] = None) -> Optional[str]:
    """The stage a pool's workers bill: the ambient one, else `default` (the
    pool's own stage) when attribution is on, else None."""
    st = _stage.get()
    if st is not None:
        return st
    if default is not None and enabled():
        return default
    return None


@contextlib.contextmanager
def stage_scope(name: Optional[str]) -> Iterator[None]:
    """Mark the body as stage `name`; its wall seconds bank on the ambient
    QueryScope at exit. None, or attribution off, is a no-op."""
    if name is None or not enabled():
        yield
        return
    token = _stage.set(name)
    t0 = time.monotonic()
    try:
        yield
    finally:
        _stage.reset(token)
        sl = _scope_ledger(create=True)
        if sl is not None:
            sl.add(name, "wall_s", time.monotonic() - t0)


def stamp_counter(key: str, n, stage: Optional[str] = None) -> None:
    """Bill one ledger counter to `stage` (default: the ambient one)."""
    field = _COUNTER_VECTOR.get(key)
    if field is None:
        return
    sl = _scope_ledger(create=True)
    if sl is not None:
        sl.add(stage or _stage.get() or UNLABELED, field, n)


def note_rows(n: int) -> None:
    """Rows through the ambient stage (the `rows` field)."""
    st = _stage.get()
    if st is None or not n:
        return
    sl = _scope_ledger(create=True)
    if sl is not None:
        sl.add(st, "rows", int(n))


def query_stage_walls() -> Optional[Dict[str, float]]:
    """The ambient query's per-stage busy walls so far, or None."""
    if not enabled():
        return None
    sl = _scope_ledger(create=False)
    if sl is None:
        return None
    return sl.wall_snapshot() or None


def close_stages(led) -> Optional[Dict[str, dict]]:
    """The ambient scope's stage vectors for a ledger opened with
    attribution on, or None."""
    if not getattr(led, "stage_attr", False):
        return None
    sl = _scope_ledger(create=False)
    if sl is None:
        return None
    return sl.snapshot() or None


_STAGE_KINDS = ("build", "query", "join")


def _lane_of(span: dict) -> str:
    """A span's timeline lane: the root its own, each stage one, operators
    `ops`, pool workers `workers`, the rest by name family."""
    name = str(span.get("name", ""))
    if span.get("parent_id") is None:
        return "query"
    if ":" in name:
        kind, rest = name.split(":", 1)
        if kind in _STAGE_KINDS:
            return f"stages:{kind}" if rest == "stages" else f"stage:{rest}"
        if kind == "op":
            return "ops"
        if kind in ("worker", "pool", "decode"):
            return "workers"
        return kind
    return name


def chrome_trace(spans: List[dict]) -> dict:
    """Chrome-trace JSON of one query's exported spans: a complete event
    (`ph:"X"`) per span, a lane (tid) per stage / worker family / op class,
    named by thread-name metadata events."""
    spans = [s for s in spans if isinstance(s, dict)]
    starts = [float(s["start_s"]) for s in spans if isinstance(s.get("start_s"), (int, float))]
    t0 = min(starts) if starts else 0.0
    lanes: Dict[str, int] = {}
    events: List[dict] = []
    for s in spans:
        start = s.get("start_s")
        if not isinstance(start, (int, float)):
            continue
        dur = s.get("duration_s")
        dur = float(dur) if isinstance(dur, (int, float)) else 0.0
        tid = lanes.setdefault(_lane_of(s), len(lanes) + 1)
        ev = {
            "name": str(s.get("name", "?")),
            "ph": "X",
            "ts": round((float(start) - t0) * 1e6, 1),
            "dur": round(max(0.0, dur) * 1e6, 1),
            "pid": 1,
            "tid": tid,
        }
        attrs = s.get("attrs")
        if isinstance(attrs, dict) and attrs:
            ev["args"] = attrs
        if s.get("status") not in (None, "ok"):
            ev.setdefault("args", {})["status"] = s["status"]
        events.append(ev)
    meta = [{"name": "thread_name", "ph": "M", "pid": 1, "tid": tid, "args": {"name": lane}}
            for lane, tid in lanes.items()]
    qids = {s.get("query_id") for s in spans if s.get("query_id")}
    return {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "otherData": {"query_id": sorted(qids)[0] if qids else None, "lanes": sorted(lanes)},
    }

"""A span tree per query (counterpart of `hyperspace_tpu/telemetry/tracing.py`).

Every user-facing action (`DataFrame.collect/count`, `create_index`,
`refresh_index`, `optimize_index`, `explain(analyze=True)`) opens a root span
with a `query_id`; the planner (`plan`), the optimizer rules
(`rule:<Name>`), the physical operators (`op:<name>`, with `node_id`) and
the stage summaries of the streamed executors (`<kind>:stages` and
`<kind>:<stage>`) hang below it.

- **Off by default.** Spans record only while a sink is attached:
  `HYPERSPACE_TRACE_FILE` (JSONL export), `HYPERSPACE_TIMELINE_DIR` (one
  Chrome trace per query, `stage_ledger.chrome_trace`), `HYPERSPACE_TRACING=1`
  or a `capture()` scope. Otherwise every hook is one predicate and the
  shared `NOOP_SPAN`: no allocation, no device work.
- **Threads.** The ambient span rides a contextvar; a pool worker that does
  not inherit the submitter's context passes `parent=` explicitly, and an
  explicit real parent records whatever this thread's `active()` says.
- **Bounded.** Finished traces sit in a deque of 16, and a trace holds at
  most `MAX_SPANS_PER_TRACE` spans: the overflow is counted on the root
  (`spans_dropped`) and in `trace.spans.dropped`.
- **The card.** A span's wall is the host's: kernels launched inside it may
  still run after it closes. Device seconds come only from the CUDA-event
  probes of `device_observatory` (the ledger's `device_time_s`). The JAX
  package's profiler annotations have no counterpart here.

JSONL (`HYPERSPACE_TRACE_FILE`): one line per span, written when the root
ends, `{"query_id", "span_id", "parent_id", "name", "start_s", "duration_s",
"status", "attrs"}`, the schema `tools/hstimeline.py` reads. The file
rotates at `HYPERSPACE_TRACE_MAX_MB` (`rotation.append`).
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time
import uuid
from collections import deque
from typing import Dict, Iterator, List, Optional

ENV_TRACE_FILE = "HYPERSPACE_TRACE_FILE"
ENV_TRACING = "HYPERSPACE_TRACING"
ENV_TIMELINE_DIR = "HYPERSPACE_TIMELINE_DIR"

MAX_SPANS_PER_TRACE = 4096

_RECENT: "deque[QueryTrace]" = deque(maxlen=16)
_recent_lock = threading.Lock()
_export_lock = threading.Lock()

_current_span: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "hyperspace_torch_current_span", default=None
)
_capture: "contextvars.ContextVar[Optional[Capture]]" = contextvars.ContextVar(
    "hyperspace_torch_trace_capture", default=None
)


def new_query_id() -> str:
    return uuid.uuid4().hex[:16]


class QueryTrace:
    """All spans of one root query, in creation order (root first)."""

    def __init__(self, query_id: str):
        self.query_id = query_id
        self.spans: List[Span] = []
        self.dropped = 0
        self._lock = threading.Lock()
        self._next_id = 0

    def _register(self, span: "Span") -> bool:
        with self._lock:
            if len(self.spans) >= MAX_SPANS_PER_TRACE:
                self.dropped += 1
                return False
            span.span_id = self._next_id
            self._next_id += 1
            self.spans.append(span)
            return True

    @property
    def root(self) -> "Span":
        return self.spans[0]

    def spans_by_parent(self) -> Dict[Optional[int], List["Span"]]:
        out: Dict[Optional[int], List[Span]] = {}
        with self._lock:
            for s in self.spans:
                out.setdefault(s.parent_id, []).append(s)
        return out

    def find(self, name: str) -> List["Span"]:
        with self._lock:
            return [s for s in self.spans if s.name == name]


class Span:
    """One named, timed node of a query's span tree."""

    __slots__ = ("trace", "name", "span_id", "parent_id", "start_s", "_t0", "duration_s", "status", "attrs",
                 "_lock", "_registered")

    def __init__(self, trace: QueryTrace, name: str, parent_id: Optional[int], attrs=None):
        self.trace = trace
        self.name = name
        self.span_id = -1
        self.parent_id = parent_id
        self.start_s = time.time()
        self._t0 = time.monotonic()
        self.duration_s: Optional[float] = None
        self.status = "ok"
        self.attrs: dict = dict(attrs) if attrs else {}
        self._lock = threading.Lock()
        self._registered = trace._register(self)

    @property
    def query_id(self) -> str:
        return self.trace.query_id

    def set_attr(self, key: str, value) -> None:
        with self._lock:
            self.attrs[key] = value

    def add_attrs(self, **attrs) -> None:
        with self._lock:
            self.attrs.update(attrs)

    def append_attr(self, key: str, value) -> None:
        """Append to a list-valued attribute (rule decisions accumulate)."""
        with self._lock:
            self.attrs.setdefault(key, []).append(value)

    def inc_attr(self, key: str, delta) -> None:
        with self._lock:
            self.attrs[key] = self.attrs.get(key, 0) + delta

    def end(self, status: Optional[str] = None, error: Optional[BaseException] = None) -> None:
        """Close the span; the first end wins."""
        with self._lock:
            if self.duration_s is not None:
                return
            self.duration_s = max(0.0, time.monotonic() - self._t0)
            if error is not None:
                self.status = "error"
                self.attrs["error"] = f"{type(error).__name__}: {error}"
            elif status is not None:
                self.status = status

    def to_json(self) -> dict:
        with self._lock:
            attrs = dict(self.attrs)
            duration = self.duration_s
            status = self.status
        return {
            "query_id": self.trace.query_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start_s": round(self.start_s, 6),
            "duration_s": None if duration is None else round(duration, 6),
            "status": status,
            "attrs": attrs,
        }


class _NoopSpan:
    """The shared do-nothing span every hook gets while tracing is off."""

    __slots__ = ()
    name = "<noop>"
    span_id = -1
    parent_id = None
    query_id = ""
    duration_s = 0.0
    status = "ok"
    attrs: dict = {}

    def set_attr(self, key, value):
        pass

    def add_attrs(self, **attrs):
        pass

    def append_attr(self, key, value):
        pass

    def inc_attr(self, key, delta):
        pass

    def end(self, status=None, error=None):
        pass


NOOP_SPAN = _NoopSpan()


class Capture:
    """In-memory sink: the first root trace finished under it lands in
    `.trace`."""

    def __init__(self):
        self.trace: Optional[QueryTrace] = None


def active() -> bool:
    """Whether spans record: a sink is attached. One contextvar read and at
    most three env reads."""
    if _capture.get() is not None:
        return True
    if os.environ.get(ENV_TRACE_FILE) or os.environ.get(ENV_TIMELINE_DIR):
        return True
    return os.environ.get(ENV_TRACING) == "1"


def current_span():
    return _current_span.get()


def set_attr(key: str, value) -> None:
    """An attribute on the ambient span; nothing without one."""
    sp = _current_span.get()
    if sp is not None:
        sp.set_attr(key, value)


@contextlib.contextmanager
def capture() -> Iterator[Capture]:
    """Record the traces started under this scope whatever the env says,
    and hand the first finished root trace to the caller."""
    cap = Capture()
    token = _capture.set(cap)
    try:
        yield cap
    finally:
        _capture.reset(token)


@contextlib.contextmanager
def query_span(name: str, **attrs) -> Iterator:
    """The root span of one user-facing action. Under an open span it is a
    plain child (one query_id per outermost action). With no sink it yields
    `NOOP_SPAN`, inside a ledger-only scope when accounting is on
    (`HYPERSPACE_ACCOUNTING=1`), so the ledgers survive without span trees."""
    from . import accounting as _accounting

    if not active():
        if not _accounting.enabled():
            yield NOOP_SPAN
            return
        with _accounting.ledger_scope(new_query_id(), name):
            yield NOOP_SPAN
        return
    if _current_span.get() is not None:
        with span(name, **attrs) as sp:
            yield sp
        return
    trace = QueryTrace(new_query_id())
    root = Span(trace, name, None, attrs)
    tenant = _accounting.current_tenant()
    if tenant is not None:
        root.set_attr("tenant", tenant)
    token = _current_span.set(root)
    led = _accounting.ledger_scope(trace.query_id, name, root=root)
    led.__enter__()
    try:
        yield root
        root.end()
    except BaseException as e:
        root.end(error=e)
        raise
    finally:
        # The ledger closes after the root (it reads the root's duration and
        # writes the `ledger` attr) and before the export (which carries it).
        try:
            led.__exit__(None, None, None)
        except Exception:
            pass
        _current_span.reset(token)
        _finalize(trace)


@contextlib.contextmanager
def span(name: str, parent=None, **attrs) -> Iterator:
    """A child span under `parent` (default: the ambient span); a no-op with
    no root or with tracing off. An exception closes it with
    `status="error"` and propagates."""
    if parent is None:
        if not active():
            yield NOOP_SPAN
            return
        parent = _current_span.get()
    if parent is None or isinstance(parent, _NoopSpan):
        yield NOOP_SPAN
        return
    sp = Span(parent.trace, name, parent.span_id, attrs)
    token = _current_span.set(sp)
    try:
        yield sp
        sp.end()
    except BaseException as e:
        sp.end(error=e)
        raise
    finally:
        _current_span.reset(token)


def record_stage_spans(kind: str, summary: dict, parent=None) -> None:
    """One `StageTimings` summary as child spans of the ambient span: a
    `<kind>:stages` span carrying the summary, and under it a
    `<kind>:<stage>` span per stage whose duration is the stage's busy
    seconds (stages overlap). Both are back-dated by the summary's wall, so a
    timeline places them inside the operation."""
    if parent is None:
        if not active():
            return
        parent = _current_span.get()
    if parent is None or isinstance(parent, _NoopSpan):
        return
    meta = Span(parent.trace, f"{kind}:stages", parent.span_id)
    wall = summary.get("wall_s")
    wall = float(wall) if isinstance(wall, (int, float)) else 0.0
    meta.start_s -= wall
    meta.duration_s = wall
    meta.set_attr("synthesized", True)
    counts = summary.get("stage_counts") or {}
    for key, val in summary.items():
        if not key.endswith("_s") or key == "wall_s" or not isinstance(val, (int, float)):
            continue
        stage = key[:-2]
        sp = Span(meta.trace, f"{kind}:{stage}", meta.span_id)
        sp.start_s = meta.start_s
        sp.set_attr("busy_s", float(val))
        if counts.get(stage) is not None:
            sp.set_attr("count", counts[stage])
        sp.duration_s = max(0.0, float(val))
    meta.attrs.update({k: v for k, v in summary.items() if _json_safe(v)})


def _json_safe(v) -> bool:
    try:
        json.dumps(v)
        return True
    except (TypeError, ValueError):
        return False


def recent_traces() -> List[QueryTrace]:
    """Finished root traces, oldest first."""
    with _recent_lock:
        return list(_RECENT)


def last_trace() -> Optional[QueryTrace]:
    with _recent_lock:
        return _RECENT[-1] if _RECENT else None


def reset() -> None:
    """Forget the finished traces (tests)."""
    with _recent_lock:
        _RECENT.clear()


def _closed_spans(trace: QueryTrace) -> List[dict]:
    """Every span as its JSON dict; a worker span left open is closed at the
    root's end as `unclosed`."""
    out = []
    for s in list(trace.spans):
        if s.duration_s is None:
            s.end(status="unclosed")
        out.append(s.to_json())
    return out


def _finalize(trace: QueryTrace) -> None:
    """The root ended: bank the trace, hand it to a capture, export the
    JSONL and the timeline when their env sinks are set. An export failure
    never fails the query."""
    if trace.dropped:
        trace.root.set_attr("spans_dropped", trace.dropped)
        from . import metrics as _metrics

        _metrics.counter("trace.spans.dropped").inc(trace.dropped)
    with _recent_lock:
        _RECENT.append(trace)
    cap = _capture.get()
    if cap is not None and cap.trace is None:
        cap.trace = trace
    path = os.environ.get(ENV_TRACE_FILE)
    if path:
        try:
            from . import rotation as _rotation

            lines = "".join(json.dumps(s, default=str) + "\n" for s in _closed_spans(trace))
            # One whole trace per append, rotated at HYPERSPACE_TRACE_MAX_MB.
            with _export_lock:
                _rotation.append(path, lines, _rotation.ENV_TRACE_MAX_MB)
        except Exception:
            pass
    tdir = os.environ.get(ENV_TIMELINE_DIR)
    if tdir:
        try:
            from . import stage_ledger as _stage_ledger

            doc = _stage_ledger.chrome_trace(_closed_spans(trace))
            os.makedirs(tdir, exist_ok=True)
            with open(os.path.join(tdir, f"timeline-{trace.query_id}.json"), "w") as fh:
                json.dump(doc, fh, default=str)
        except Exception:
            pass

"""Resilient execution: bounded retries with backoff, query deadlines and
retry budgets (counterpart of `hyperspace_tpu/resilience.py`).

- `retry_io(point, fn)` retries `fn` on a transient fault
  (`exceptions.is_transient`) up to `HYPERSPACE_IO_RETRIES` times with
  exponential backoff and jitter; a permanent fault, or the last transient
  one, propagates unchanged. Used at every lake-touching site (decodes,
  footers, parquet writes, log writes).
- `query_scope(name)` opens one scope per root action (collect, count,
  create_index, refresh_index, optimize_index; a nested scope reuses the
  outer one). It carries the deadline (`HYPERSPACE_QUERY_TIMEOUT_S`), the
  retry budget (`HYPERSPACE_QUERY_RETRY_BUDGET`) and the planner's
  decisions for the query.
- `check_deadline(where)` raises a `QueryTimeoutError` past the deadline.
  It is called at file, chunk and bucket boundaries; the caches and memos
  keep only finished work, so a timed-out query leaves no entry.
- `use_scope(scope)` adopts a scope on a pool thread (a worker starts in a
  fresh context; its submitter hands over `current_scope()`).

The counters live in the metrics registry (`io.retries.attempts`,
`io.retries.exhausted`, `io.retries.<point>`, `query.timeouts`;
`counters()` reads them); a retry is also charged to the query's ledger
(`io_retries`) and to the ambient span. The scope carries the query's stage
ledger (`telemetry.stage_ledger`). The JAX package's serving lanes and yield
hook (`lane_scope`, `register_yield_hook`) wait for the port's serving layer.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import random
import threading
import time
from typing import Callable, Dict, Iterator, Optional, TypeVar

from .exceptions import QueryTimeoutError, RetryBudgetExceededError, is_transient
from .telemetry import accounting as _accounting
from .telemetry import metrics as _metrics
from .telemetry import tracing as _tracing

ENV_IO_RETRIES = "HYPERSPACE_IO_RETRIES"
ENV_RETRY_BACKOFF_S = "HYPERSPACE_RETRY_BACKOFF_S"
ENV_QUERY_RETRY_BUDGET = "HYPERSPACE_QUERY_RETRY_BUDGET"
ENV_QUERY_TIMEOUT_S = "HYPERSPACE_QUERY_TIMEOUT_S"

_DEFAULT_IO_RETRIES = 2  # retries per operation (attempts = retries + 1)
_DEFAULT_BACKOFF_S = 0.02
_DEFAULT_RETRY_BUDGET = 256
_BACKOFF_CAP_S = 2.0

_RETRY_ATTEMPTS = _metrics.counter("io.retries.attempts")
_RETRY_EXHAUSTED = _metrics.counter("io.retries.exhausted")
_TIMEOUTS = _metrics.counter("query.timeouts")


def _is_resilience_counter(name: str) -> bool:
    return name.startswith("io.retries.") or name == "query.timeouts"


def counters() -> Dict[str, int]:
    """The registry's `io.retries.attempts`, `io.retries.exhausted`,
    `io.retries.<point>` and `query.timeouts` that are not 0."""
    return {n: v for n, v in _metrics.snapshot()["counters"].items() if v and _is_resilience_counter(n)}


def reset_counters() -> None:
    """Zero those registry counters (tests)."""
    for n in _metrics.snapshot()["counters"]:
        if _is_resilience_counter(n):
            _metrics.counter(n).reset()


def max_retries() -> int:
    try:
        return max(0, int(os.environ.get(ENV_IO_RETRIES, "") or _DEFAULT_IO_RETRIES))
    except ValueError:
        return _DEFAULT_IO_RETRIES


def _backoff_base_s() -> float:
    try:
        return max(0.0, float(os.environ.get(ENV_RETRY_BACKOFF_S, "") or _DEFAULT_BACKOFF_S))
    except ValueError:
        return _DEFAULT_BACKOFF_S


def retry_budget() -> int:
    try:
        return max(0, int(os.environ.get(ENV_QUERY_RETRY_BUDGET, "") or _DEFAULT_RETRY_BUDGET))
    except ValueError:
        return _DEFAULT_RETRY_BUDGET


def query_timeout_s() -> Optional[float]:
    raw = os.environ.get(ENV_QUERY_TIMEOUT_S)
    if not raw:
        return None
    try:
        v = float(raw)
    except ValueError:
        return None
    return v if v > 0 else None


class QueryScope:
    """Deadline, retry budget and planner decisions of one root action."""

    __slots__ = ("name", "start_mono", "deadline_mono", "timeout_s", "_lock", "retries", "plan_decisions",
                 "stage_ledger")

    def __init__(self, name: str, timeout_s: Optional[float]):
        self.name = name
        self.start_mono = time.monotonic()
        self.timeout_s = timeout_s
        self.deadline_mono = None if timeout_s is None else self.start_mono + timeout_s
        self._lock = threading.Lock()
        self.retries = 0
        #: The planner's `PlanDecisions` of the running query, so that pool
        #: workers that adopt the scope see the same decisions.
        self.plan_decisions = None
        #: The query's per-stage cost vectors (`telemetry.stage_ledger`),
        #: made at the first stage bracket; every adopting worker bills it.
        self.stage_ledger = None

    def charge_retry(self) -> int:
        with self._lock:
            self.retries += 1
            return self.retries


_scope: "contextvars.ContextVar[Optional[QueryScope]]" = contextvars.ContextVar(
    "hyperspace_torch_query_scope", default=None
)


def current_scope() -> Optional[QueryScope]:
    return _scope.get()


@contextlib.contextmanager
def query_scope(name: str) -> Iterator[QueryScope]:
    """The scope of one root action; under an open scope, that scope."""
    existing = _scope.get()
    if existing is not None:
        yield existing
        return
    sc = QueryScope(name, query_timeout_s())
    token = _scope.set(sc)
    try:
        yield sc
    finally:
        _scope.reset(token)


@contextlib.contextmanager
def use_scope(sc: Optional[QueryScope]) -> Iterator[None]:
    """Adopt `sc` on this thread (a pool worker)."""
    if sc is None:
        yield
        return
    token = _scope.set(sc)
    try:
        yield
    finally:
        _scope.reset(token)


def check_deadline(where: str = "") -> None:
    """Raise `QueryTimeoutError` when the ambient scope's deadline has
    passed; one contextvar read without a scope or a deadline."""
    sc = _scope.get()
    if sc is None or sc.deadline_mono is None:
        return
    now = time.monotonic()
    if now < sc.deadline_mono:
        return
    _TIMEOUTS.inc()
    elapsed = now - sc.start_mono
    at = f" at {where}" if where else ""
    raise QueryTimeoutError(
        f"query '{sc.name}' exceeded HYPERSPACE_QUERY_TIMEOUT_S={sc.timeout_s:g}s "
        f"(elapsed {elapsed:.3f}s{at}); workers drained, no partial cache/memo entries were committed",
        elapsed_s=elapsed,
        timeout_s=sc.timeout_s or 0.0,
    )


def remaining_s() -> Optional[float]:
    """Seconds left before the ambient deadline (None: no deadline)."""
    sc = _scope.get()
    if sc is None or sc.deadline_mono is None:
        return None
    return max(0.0, sc.deadline_mono - time.monotonic())


def reliability_rollup(snapshot: Optional[dict] = None) -> dict:
    """The reliability summary (`resilience.reliability_rollup` :266) over a
    `metrics.snapshot()` (taken now when none is given; a `counters()` dict
    is read as its counters) and the quarantine."""
    from .index import quarantine as _quarantine

    if snapshot is None:
        snapshot = _metrics.snapshot()
    c = snapshot.get("counters", snapshot)
    q = _quarantine.stats()
    return {
        "faults_injected": c.get("faults.injected", 0),
        "io_retries": c.get("io.retries.attempts", 0),
        "retries_exhausted": c.get("io.retries.exhausted", 0),
        "query_timeouts": c.get("query.timeouts", 0),
        "quarantine_events": q["events"],
        "quarantined": sorted(_quarantine.snapshot()),
    }


T = TypeVar("T")


def retry_io(point: str, fn: Callable[[], T]) -> T:
    """Run `fn`, retrying transient failures with exponential backoff and
    jitter; the sleep never outlives the ambient deadline. `point` names the
    site's `io.retries.<point>` counter."""
    retries = max_retries()
    attempt = 0
    while True:
        check_deadline(point)
        try:
            return fn()
        except BaseException as e:
            transient = is_transient(e)
            if not transient or attempt >= retries:
                if transient:
                    _RETRY_EXHAUSTED.inc()
                raise
            attempt += 1
            sc = _scope.get()
            if sc is not None and sc.charge_retry() > retry_budget():
                raise RetryBudgetExceededError(
                    f"query '{sc.name}' exceeded its retry budget "
                    f"({retry_budget()} retries; HYPERSPACE_QUERY_RETRY_BUDGET)"
                ) from e
            _RETRY_ATTEMPTS.inc()
            _metrics.counter(f"io.retries.{point}").inc()
            _accounting.add("io_retries", 1)
            sp = _tracing.current_span()
            if sp is not None:
                sp.inc_attr("io_retries", 1)
            delay = min(_backoff_base_s() * (2 ** (attempt - 1)), _BACKOFF_CAP_S) * (0.5 + random.random())
            rem = remaining_s()
            if rem is not None:
                delay = min(delay, rem)
            if delay > 0:
                time.sleep(delay)

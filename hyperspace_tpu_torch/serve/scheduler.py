"""The query scheduler: bounded workers, priority lanes, tenant labels
(counterpart of `hyperspace_tpu/serve/scheduler.py`, same env knobs, lanes
and metric names).

`QueryServer` is the multi-tenant front door of one engine process. A caller
submits a thunk (`lambda: df.collect()`); the server admission-checks it
(`serve.admission`), queues it in a priority lane and runs it on a bounded
pool of worker threads. Below the thunk runs the unchanged engine: each
query opens its own resilience scope, root span and ledger (labeled with
its tenant through `accounting.tenant_scope` and its lane through
`resilience.lane_scope`) and shares the process's caches under single-flight
(`serve.singleflight`).

- Bounded concurrency (`HYPERSPACE_SERVE_MAX_CONCURRENT`, 4): threads,
  because a query's heavy parts release the GIL (pyarrow decodes, CUDA
  launches and copies). Every worker launches on the device's default
  stream, the one a new thread starts on: the kernels of all queries run
  in launch order, so a tensor one query caches (a scan table, a join memo
  entry, a single-flight result) is ready for the next with no event.
- Priority lanes: "interactive" is always popped before "batch", and with
  two or more workers worker 0 serves the interactive lane alone, so an
  interactive query never waits out a cold batch scan. Workers spawn
  lazily, at the first concurrent submission; the first spawn installs the
  batch lane's cooperative yield hook (`_yield_to_interactive`, called at
  every `resilience.check_deadline` of a batch scope),
  `sys.setswitchinterval` (`HYPERSPACE_SERVE_GIL_SWITCH_S`, 0.001) and, unless
  `HYPERSPACE_SERVE_GC_TUNE=0`, a rarer full garbage collection. The batch
  workers lower their own thread's priority (`os.setpriority` on the
  worker's own thread id, `HYPERSPACE_SERVE_BATCH_NICE`, 10).
- `HYPERSPACE_SERVING=0` runs every submission inline on the submitting
  thread under one server-wide lock: no admission, no flights, one query at
  a time; its future resolves before `submit` returns.

A failing query resolves its own future with its exception (a failed CUDA
launch included: nothing is retried on the CPU) and releases its token.

Metrics: the `serve.queue.depth`, `serve.queue.depth.<lane>`,
`serve.active` and `serve.inflight.<lane>` gauges, the `serve.queue.wait_s`,
`serve.latency.<lane>` and `latency.serve.<lane>` histograms, the
`serve.completed` and `serve.failed` counters; each completion feeds
`telemetry.slo`.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Optional, TypeVar

from .. import resilience as _resilience
from ..exceptions import HyperspaceException
from ..telemetry import accounting as _accounting
from ..telemetry import metrics as _metrics
from ..telemetry import slo as _slo
from .admission import AdmissionController
from .singleflight import serving_enabled

ENV_MAX_CONCURRENT = "HYPERSPACE_SERVE_MAX_CONCURRENT"
ENV_BATCH_NICE = "HYPERSPACE_SERVE_BATCH_NICE"
ENV_GIL_SWITCH_S = "HYPERSPACE_SERVE_GIL_SWITCH_S"
ENV_GC_TUNE = "HYPERSPACE_SERVE_GC_TUNE"
_DEFAULT_MAX_CONCURRENT = 4
_DEFAULT_GIL_SWITCH_S = 0.001
_DEFAULT_BATCH_NICE = 10
#: One batch-lane pause: slices of `_YIELD_SLICE_S`, at most `_YIELD_MAX_S`,
#: so interactive pressure slows batch work and never stops it.
_YIELD_SLICE_S = 0.002
_YIELD_MAX_S = 0.05

#: The pop order is the priority order.
LANES = ("interactive", "batch")

_QUEUE_DEPTH = _metrics.gauge("serve.queue.depth")
_ACTIVE = _metrics.gauge("serve.active")
_QUEUE_WAIT_S = _metrics.histogram("serve.queue.wait_s")
_COMPLETED = _metrics.counter("serve.completed")
_FAILED = _metrics.counter("serve.failed")
_LANE_LATENCY = {lane: _metrics.histogram(f"serve.latency.{lane}") for lane in LANES}
_LANE_QUEUE_DEPTH = {lane: _metrics.gauge(f"serve.queue.depth.{lane}") for lane in LANES}
_LANE_INFLIGHT = {lane: _metrics.gauge(f"serve.inflight.{lane}") for lane in LANES}
_LANE_SERVE_LATENCY = {lane: _metrics.histogram(f"latency.serve.{lane}") for lane in LANES}


def default_max_concurrent() -> int:
    try:
        return max(1, int(os.environ.get(ENV_MAX_CONCURRENT, "") or _DEFAULT_MAX_CONCURRENT))
    except ValueError:
        return _DEFAULT_MAX_CONCURRENT


def _batch_nice() -> int:
    try:
        return max(0, int(os.environ.get(ENV_BATCH_NICE, "") or _DEFAULT_BATCH_NICE))
    except ValueError:
        return _DEFAULT_BATCH_NICE


# Interactive queries queued or running, process-wide (every server shares
# the caches and the host's cores): the yield gate's state.
_pressure_lock = threading.Lock()
_interactive_pending = 0


def _interactive_begin() -> None:
    global _interactive_pending
    with _pressure_lock:
        _interactive_pending += 1


def _interactive_end() -> None:
    global _interactive_pending
    with _pressure_lock:
        _interactive_pending = max(0, _interactive_pending - 1)


def interactive_pending() -> bool:
    return _interactive_pending > 0


def _yield_to_interactive() -> None:
    """The batch lane's pause at a chunk or file boundary while interactive
    work is pending, at most `_YIELD_MAX_S`. A thread leading a flight that
    someone waits on never pauses: the waiter may be the interactive query."""
    from .singleflight import leading_with_followers

    waited = 0.0
    while _interactive_pending > 0 and waited < _YIELD_MAX_S:
        if leading_with_followers():
            return
        time.sleep(_YIELD_SLICE_S)
        waited += _YIELD_SLICE_S


T = TypeVar("T")


class _Item:
    __slots__ = ("future", "fn", "tenant", "lane", "t_admitted")

    def __init__(self, future, fn, tenant, lane):
        self.future = future
        self.fn = fn
        self.tenant = tenant
        self.lane = lane
        self.t_admitted = time.monotonic()


class QueryServer:
    """One serving front door over the engine of this process.

    >>> with QueryServer() as srv:
    ...     fut = srv.submit(lambda: df.collect(), tenant="alice", lane="interactive")
    ...     table = fut.result()

    Arguments left None take the env knobs. `close()` (or leaving the
    `with`) runs what is queued and joins the workers. With
    `HYPERSPACE_REPLICAS=1` making a server joins this process to the
    on-lake fleet (`serve.replicas.join_fleet`)."""

    def __init__(self, max_concurrent: Optional[int] = None, queue_depth: Optional[int] = None,
                 tenant_budget: Optional[int] = None):
        self.max_concurrent = default_max_concurrent() if max_concurrent is None else max(1, int(max_concurrent))
        self.admission = AdmissionController(queue_depth, tenant_budget)
        from . import replicas as _replicas

        if _replicas.fleet_enabled():
            _replicas.join_fleet()
        self._cv = threading.Condition()
        self._lanes = {lane: deque() for lane in LANES}
        self._workers: list = []
        self._closed = False
        self._serial_lock = threading.Lock()  # the HYPERSPACE_SERVING=0 path

    def __enter__(self) -> "QueryServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _ensure_workers_locked(self) -> None:
        """Spawn the workers up to the bound (holding `_cv`). Worker 0 serves
        only the interactive lane when there are two or more."""
        if not self._workers:
            _resilience.register_yield_hook(_yield_to_interactive)
            try:
                switch = float(os.environ.get(ENV_GIL_SWITCH_S, "") or _DEFAULT_GIL_SWITCH_S)
            except ValueError:
                switch = _DEFAULT_GIL_SWITCH_S
            if switch > 0:
                import sys

                sys.setswitchinterval(min(sys.getswitchinterval(), switch))
            if os.environ.get(ENV_GC_TUNE, "") != "0":
                # Full collections pause every thread; freeze the warm
                # start-up objects out of them and make them 10x rarer.
                # Collect first: garbage frozen with them would never be
                # freed (device tensors in it included).
                import gc

                gc.collect()
                gc.freeze()
                t0, t1, _t2 = gc.get_threshold()
                gc.set_threshold(t0, t1, 100)
        while len(self._workers) < self.max_concurrent:
            idx = len(self._workers)
            reserved = idx == 0 and self.max_concurrent >= 2
            t = threading.Thread(
                target=self._worker_loop, args=(reserved,),
                name=f"hyperspace-serve-{idx}{'-interactive' if reserved else ''}", daemon=True,
            )
            t.start()  # before registering: close() must never join an unstarted thread
            self._workers.append(t)

    def close(self, wait: bool = True) -> None:
        """Take no more work; what is queued still runs."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
            workers = list(self._workers)
        if wait:
            for t in workers:
                t.join()

    def submit(self, fn: Callable[[], T], *, tenant: str = "default", lane: str = "batch") -> "Future[T]":
        """Admission-check and queue one query thunk; its future. Raises
        `AdmissionRejectedError` at the door (a rejected query holds no token
        and has no future). `lane` is "interactive" or "batch"."""
        if lane not in LANES:
            raise HyperspaceException(f"Unknown serve lane '{lane}'; expected one of {LANES}")
        with self._cv:
            if self._closed:
                raise HyperspaceException("QueryServer is closed")
        if not serving_enabled():
            return self._run_serial(fn, tenant, lane)
        self.admission.admit(tenant)
        fut: "Future[T]" = Future()
        item = _Item(fut, fn, tenant, lane)
        try:
            with self._cv:
                if self._closed:
                    raise HyperspaceException("QueryServer is closed")
                self._ensure_workers_locked()
                if lane == "interactive":
                    _interactive_begin()  # ended in _execute's finally
                self._lanes[lane].append(item)
                _QUEUE_DEPTH.set(sum(len(q) for q in self._lanes.values()))
                _LANE_QUEUE_DEPTH[lane].set(len(self._lanes[lane]))
                # All: one wake could land on the interactive worker for a
                # batch item and leave it queued.
                self._cv.notify_all()
        except BaseException:
            self.admission.release(tenant)  # a leaked token would ratchet the queue shut
            raise
        return fut

    def run(self, fn: Callable[[], T], *, tenant: str = "default", lane: str = "batch") -> T:
        """`submit` and wait."""
        return self.submit(fn, tenant=tenant, lane=lane).result()

    def _run_serial(self, fn, tenant: str, lane: str = "batch") -> Future:
        """The `HYPERSPACE_SERVING=0` path: inline, one at a time; the tenant
        and lane labels still ride for telemetry and SLOs."""
        fut: Future = Future()
        fut.set_running_or_notify_cancel()
        t0 = time.monotonic()
        failed = False
        try:
            with self._serial_lock, _accounting.tenant_scope(tenant), _resilience.lane_scope(lane):
                out = fn()
        except BaseException as e:
            failed = True
            _FAILED.inc()
            fut.set_exception(e)
            return fut
        finally:
            wall = time.monotonic() - t0
            _LANE_SERVE_LATENCY[lane].observe(wall)
            _slo.observe(lane, wall, tenant=tenant, failed=failed)
        _COMPLETED.inc()
        fut.set_result(out)
        return fut

    def _pop_locked(self, reserved: bool = False) -> Optional[_Item]:
        for lane in ("interactive",) if reserved else LANES:
            if self._lanes[lane]:
                item = self._lanes[lane].popleft()
                _QUEUE_DEPTH.set(sum(len(q) for q in self._lanes.values()))
                _LANE_QUEUE_DEPTH[lane].set(len(self._lanes[lane]))
                return item
        return None

    def _worker_loop(self, reserved: bool = False) -> None:
        if not reserved and self.max_concurrent >= 2:
            nice = _batch_nice()
            if nice:
                try:
                    # This worker's own thread only: a thread may lower its
                    # own priority without privileges.
                    os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), nice)
                except (OSError, AttributeError):
                    pass  # unsupported here: the priority is a nudge
        while True:
            with self._cv:
                item = self._pop_locked(reserved)
                while item is None and not self._closed:
                    self._cv.wait()
                    item = self._pop_locked(reserved)
            if item is None:
                return  # closed and drained
            self._execute(item)

    def _execute(self, item: _Item) -> None:
        t_start = time.monotonic()
        if not item.future.set_running_or_notify_cancel():
            self.admission.release(item.tenant)
            if item.lane == "interactive":
                _interactive_end()
            return  # cancelled while queued
        _QUEUE_WAIT_S.observe(t_start - item.t_admitted)
        _ACTIVE.inc()
        _LANE_INFLIGHT[item.lane].inc()
        out = err = None
        try:
            with _accounting.tenant_scope(item.tenant), _resilience.lane_scope(item.lane):
                out = item.fn()
        except BaseException as e:
            err = e
        finally:
            _ACTIVE.dec()
            _LANE_INFLIGHT[item.lane].dec()
            if item.lane == "interactive":
                _interactive_end()
            # The token goes back before the future resolves: a caller that
            # resubmits on the result must find it free.
            self.admission.release(item.tenant)
            # The client's latency: admission to completion, queue wait in.
            wall = time.monotonic() - item.t_admitted
            _LANE_LATENCY[item.lane].observe(wall)
            _LANE_SERVE_LATENCY[item.lane].observe(wall)
            _slo.observe(item.lane, wall, tenant=item.tenant, failed=err is not None)
        if err is not None:
            _FAILED.inc()
            item.future.set_exception(err)
        else:
            _COMPLETED.inc()
            item.future.set_result(out)

    def stats(self) -> dict:
        with self._cv:
            queued = {lane: len(q) for lane, q in self._lanes.items()}
            workers = len(self._workers)
        out = self.admission.stats()
        out.update({"queued": queued, "workers": workers, "max_concurrent": self.max_concurrent,
                    "serving_enabled": serving_enabled()})
        from . import replicas as _replicas

        if _replicas.fleet_enabled():
            out["replicas"] = _replicas.fleet_stats()
        return out

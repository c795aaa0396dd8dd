"""Single-flight deduplication over the engine's shared caches (counterpart
of `hyperspace_tpu/serve/singleflight.py`, same env knob and metric names).

Two queries that miss the same cold cache entry at the same instant would
each decode the lake. Single-flight collapses that: the first requester of
a key leads and computes (populating the cache); every concurrent requester
of the same key follows, blocks until the leader is done, then re-probes the
cache the leader filled. N identical concurrent cold requests decode once.

Keys are the caches' own keys, namespaced: a file's decode ("file", path,
projection, row-group selection, device: a pruned decode never aliases the
whole-file one), a footer ("meta", path), a multi-file scan ("scan", ...),
a bucketed or filtered concatenation, a join memo ("memo", tag, ...).

- `shared(key, attempt, reprobe)` runs one computation under its key (the
  reference's API).
- `claim(keys)`, `finish(...)` and `follow(flight)` serve a batch: the
  port's file decode converts and copies a whole batch of files at once, so
  a query claims, without blocking, every key no flight holds (it leads
  those) and notes the others (it follows those). It decodes the batch it
  leads, finishes those flights, and only then waits on the ones it follows.
  A query never waits while it holds an unfinished flight of the same
  level, so two queries that each lead one file and follow the other's
  cannot deadlock.

Failure: a leader's exception is its caller's alone. The flight is cleared
in a `finally` and marked not-ok, and each follower retries on its own,
leading a new flight (nothing failed is cached). A follower's wait is
bounded by its own query deadline (`resilience.check_deadline` at every
`_WAIT_SLICE_S`). A leader whose entry was evicted before a follower
re-probed leaves that follower to lead its own flight.

`HYPERSPACE_SERVING=0` turns every flight off: `shared` runs its attempt
inline, and the batch path is the single-caller one.

Metrics: `serve.singleflight.leaders`, `serve.singleflight.dedup_hits`
(followers served by a leader's work), `serve.singleflight.follower_retries`
and the `serve.singleflight.wait_s` histogram.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Callable, Dict, Iterable, Iterator, Optional, Tuple, TypeVar

from .. import resilience as _resilience
from ..telemetry import metrics as _metrics

ENV_SERVING = "HYPERSPACE_SERVING"

_LEADERS = _metrics.counter("serve.singleflight.leaders")
_DEDUP_HITS = _metrics.counter("serve.singleflight.dedup_hits")
_FOLLOWER_RETRIES = _metrics.counter("serve.singleflight.follower_retries")
_WAIT_S = _metrics.histogram("serve.singleflight.wait_s")

#: A follower's wake-up slice: the query deadline is checked at each.
_WAIT_SLICE_S = 0.05


def serving_enabled() -> bool:
    """On unless `HYPERSPACE_SERVING=0`, the exact single-caller fallback."""
    return os.environ.get(ENV_SERVING, "") != "0"


class _Flight:
    """One computation in progress that other requesters can wait on."""

    __slots__ = ("done", "ok", "waiters")

    def __init__(self):
        self.done = threading.Event()
        self.ok = False  # set by a leader that completed normally
        self.waiters = 0  # followers blocked on it now


_lock = threading.Lock()
_flights: Dict[tuple, _Flight] = {}

# The flights this thread leads (leaders nest: a scan flight's leader leads
# file flights inside it), read by `leading_with_followers`.
_local = threading.local()


def _leading() -> list:
    leading = getattr(_local, "leading", None)
    if leading is None:
        leading = _local.leading = []
    return leading


def leads() -> list:
    """The flights this thread leads: a pool's submitter hands them to its
    workers (`lead_with`), who do the leader's work."""
    return _leading()


@contextlib.contextmanager
def lead_with(leading: Optional[list]) -> Iterator[None]:
    """Run a pool worker as part of its submitter's flights, so that the
    yield gate never pauses a worker whose output another query waits on."""
    if leading is None:
        yield
        return
    prev = getattr(_local, "leading", None)
    _local.leading = leading
    try:
        yield
    finally:
        _local.leading = prev


def leading_with_followers() -> bool:
    """Whether this thread leads a flight someone waits on: its work is on
    another query's critical path, so the scheduler's yield gate must not
    pause it (that would be priority inversion)."""
    flights = getattr(_local, "leading", None)
    return bool(flights) and any(fl.waiters > 0 for fl in flights)


def in_flight_count() -> int:
    with _lock:
        return len(_flights)


T = TypeVar("T")


def follow(fl: _Flight) -> bool:
    """Wait for `fl` to finish, checking the ambient deadline at every slice;
    True when its leader completed normally."""
    with _lock:
        fl.waiters += 1
    t0 = time.monotonic()
    try:
        while not fl.done.wait(_WAIT_SLICE_S):
            _resilience.check_deadline("serve.singleflight")
    finally:
        with _lock:
            fl.waiters -= 1
    _WAIT_S.observe(time.monotonic() - t0)
    return fl.ok


def claim(keys: Iterable[tuple]) -> Tuple[Dict[tuple, _Flight], Dict[tuple, _Flight]]:
    """(led, followed): a new flight for every key no flight holds, which
    this thread now leads and must `finish`, and the running flight of each
    other key. Never blocks."""
    led: Dict[tuple, _Flight] = {}
    followed: Dict[tuple, _Flight] = {}
    with _lock:
        for key in keys:
            if key in led or key in followed:
                continue
            fl = _flights.get(key)
            if fl is None:
                fl = _flights[key] = _Flight()
                led[key] = fl
            else:
                followed[key] = fl
    if led:
        _LEADERS.inc(len(led))
        _leading().extend(led.values())
    return led, followed


def finish(led: Dict[tuple, _Flight], ok) -> None:
    """End the flights `led` (from `claim`): each is cleared before its
    followers wake, and marked ok when its key is in `ok`."""
    leading = _leading()
    for fl in led.values():
        try:
            leading.remove(fl)
        except ValueError:
            pass
    with _lock:
        for key, fl in led.items():
            if _flights.get(key) is fl:
                del _flights[key]
    for key, fl in led.items():
        fl.ok = key in ok
        fl.done.set()


def note_dedup_hit() -> None:
    _DEDUP_HITS.inc()


def note_follower_retry() -> None:
    _FOLLOWER_RETRIES.inc()


def shared(key: tuple, attempt: Callable[[], T], reprobe: Optional[Callable[[], Optional[T]]] = None) -> T:
    """Run `attempt` with at most one concurrent execution per `key`. The
    leader runs it (it is expected to populate the cache); a follower waits
    and returns `reprobe()`'s entry. A follower whose leader failed, or
    whose re-probe found nothing, leads a flight of its own. Serving off:
    `attempt()` alone."""
    if not serving_enabled():
        return attempt()
    while True:
        led, followed = claim((key,))
        if led:
            ok = ()
            try:
                out = attempt()
                ok = led.keys()
                return out
            finally:
                finish(led, ok)
        if follow(followed[key]) and reprobe is not None:
            hit = reprobe()
            if hit is not None:
                _DEDUP_HITS.inc()
                return hit
        _FOLLOWER_RETRIES.inc()

"""Per-stage timings of index builds and the streamed executors
(counterpart of `hyperspace_tpu/telemetry/profiling.py` `StageTimings` :32,
`record_build_stages` :139, `record_query_stages` :164 and
`record_join_stages` :189).

An index build (`index/build_pipeline.py`), a streamed scan aggregate
(`engine/streaming.stream_aggregate`) and a streamed star join
(`stream_star_aggregate`) each fill one `StageTimings` and record its
summary; `last_build_stages()`, `last_query_stages()` and
`last_join_stages()` read the newest. The summaries carry the JAX package's
field names (`<stage>_s`, `wall_s`, `overlap_ratio`, `mode`,
`stage_counts`, and what the operation adds: `rows`, `sort_route`,
`chunks`, `join_mode`, `star_dims` ...), so both packages' records read alike.
`*_stages_history()` give the last few of each kind, oldest first, and
`io_pruning_summary()` the scan's pushdown and encoded-read counters.

`trace(log_dir)` profiles a scope with `torch.profiler` (CPU, and CUDA
when the card is in use) and writes a Chrome trace into `log_dir`;
`annotate(name)` names a region of it (`record_function`, and an NVTX range
on the card). Both do nothing with `enabled=False`, and `trace` with no
`log_dir`, as the JAX package's (:260, :282). Unlike the JAX package's,
`trace` lets a profiler that fails to start raise: the caller asked for a
profile.

On a CUDA device every timed block ends with a synchronization of that
device (`StageTimings(device=...)`): the card runs the block's work
asynchronously, and without it a stage's seconds would be the host's
launch time, not the work's.

Every timed block is also a stage of the stage ledger
(`stage_ledger.stage_scope`), so what the block charges to the query's
ledger bills that stage. A summary carries the kernel launches made during
its operation (`launches`, per label: the JAX package's Pallas-fallback
delta has no counterpart, the port never falls back), feeds the
`latency.<kind>.wall` and `latency.stage.<kind>.<stage>` histograms, and
becomes stage spans of the ambient trace (`tracing.record_stage_spans`).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from typing import Dict, Iterator, Optional

import torch

from . import stage_ledger

class StageTimings:
    """Thread-safe per-stage busy seconds and counts of one streamed
    operation, plus its wall clock: `overlap_ratio` = the stages' sum over
    the wall (above 1 when stages ran at once)."""

    def __init__(self, mode: str = "", device=None):
        self._lock = threading.Lock()
        self._stages: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self.mode = mode
        dev = None if device is None else torch.device(device)
        self._sync = dev if dev is not None and dev.type == "cuda" else None
        self._t0 = time.monotonic()
        self._wall: Optional[float] = None
        self._launches0 = _launch_counts()

    def add(self, stage: str, seconds: float) -> None:
        with self._lock:
            self._stages[stage] = self._stages.get(stage, 0.0) + float(seconds)
            self._counts[stage] = self._counts.get(stage, 0) + 1

    @contextlib.contextmanager
    def timed(self, stage: str, sync: bool = True) -> Iterator[None]:
        """Time a block as `stage`. `sync=False` is for host work that must
        not wait for the card's other queued work (a copy on a side stream)."""
        t0 = time.monotonic()
        try:
            with stage_ledger.stage_scope(stage):
                yield
        finally:
            if sync and self._sync is not None:
                torch.cuda.synchronize(self._sync)
            self.add(stage, time.monotonic() - t0)

    def finish(self) -> None:
        if self._wall is None:
            self._wall = time.monotonic() - self._t0

    def summary(self) -> dict:
        self.finish()
        with self._lock:
            wall = self._wall or 0.0
            busy = sum(self._stages.values())
            out = {f"{k}_s": round(v, 4) for k, v in sorted(self._stages.items())}
            out["wall_s"] = round(wall, 4)
            out["overlap_ratio"] = round(busy / wall, 3) if wall > 0 else None
            out["mode"] = self.mode
            out["stage_counts"] = dict(sorted(self._counts.items()))
        now = _launch_counts()
        delta = {k: v - self._launches0.get(k, 0) for k, v in now.items() if v - self._launches0.get(k, 0) > 0}
        if delta:
            out["launches"] = delta
        return out


def _launch_counts() -> Dict[str, int]:
    """Every kernel label's launch count so far."""
    from . import compile_log

    return {label: p["launches"] for label, p in compile_log.program_summary().items() if p["launches"]}


def _observe_stage_histograms(kind: str, summary: dict) -> None:
    """`latency.<kind>.wall` and `latency.stage.<kind>.<stage>` of one summary."""
    from . import metrics

    wall = summary.get("wall_s")
    if isinstance(wall, (int, float)):
        metrics.histogram(f"latency.{kind}.wall").observe(wall)
    for key, val in summary.items():
        if key.endswith("_s") and key != "wall_s" and isinstance(val, (int, float)):
            metrics.histogram(f"latency.stage.{kind}.{key[:-2]}").observe(val)


def _record(kind: str, history: "deque[dict]", summary: dict) -> None:
    from . import tracing

    d = dict(summary)
    with _lock:
        history.append(d)
    _observe_stage_histograms(kind, d)
    tracing.record_stage_spans(kind, d)


def timed(stages: Optional[StageTimings], stage: str):
    """`stages.timed(stage)`, or nothing when no stages are kept."""
    return contextlib.nullcontext() if stages is None else stages.timed(stage)


# The newest summaries of builds, streamed scan aggregates and streamed
# joins, bounded so that a long-lived session keeps a fixed amount.
_BUILD_STAGES: "deque[dict]" = deque(maxlen=16)
_QUERY_STAGES: "deque[dict]" = deque(maxlen=16)
_JOIN_STAGES: "deque[dict]" = deque(maxlen=16)
_lock = threading.Lock()


def record_build_stages(summary: dict) -> None:
    """Record one index build's summary."""
    _record("build", _BUILD_STAGES, summary)


def last_build_stages() -> Optional[dict]:
    """The newest build's summary (None if no build ran). Its `launches`
    are the process's launches while the build ran: a query that ran at the
    same time (`hs.server()`) adds its own."""
    with _lock:
        return dict(_BUILD_STAGES[-1]) if _BUILD_STAGES else None


def build_stages_history() -> list:
    """The summaries of the last few builds, oldest first."""
    with _lock:
        return [dict(d) for d in _BUILD_STAGES]


def record_query_stages(summary: dict) -> None:
    """Record one streamed scan aggregate's summary."""
    _record("query", _QUERY_STAGES, summary)


def last_query_stages() -> Optional[dict]:
    """The newest streamed scan aggregate's summary (None if none ran)."""
    with _lock:
        return dict(_QUERY_STAGES[-1]) if _QUERY_STAGES else None


def query_stages_history() -> list:
    """The summaries of the last few streamed scan aggregates, oldest first."""
    with _lock:
        return [dict(d) for d in _QUERY_STAGES]


def record_join_stages(summary: dict) -> None:
    """Record one streamed join's summary."""
    _record("join", _JOIN_STAGES, summary)


def last_join_stages() -> Optional[dict]:
    """The newest streamed join's summary (None if none ran)."""
    with _lock:
        return dict(_JOIN_STAGES[-1]) if _JOIN_STAGES else None


def join_stages_history() -> list:
    """The summaries of the last few streamed joins, oldest first."""
    with _lock:
        return [dict(d) for d in _JOIN_STAGES]


def io_pruning_summary() -> dict:
    """The process's scan counters under the JAX package's keys (:235): row
    groups scanned and skipped by the footer zone maps, the bytes behind
    them, the encoded read's columns and bytes (`engine/encoding.py`) and
    the footer cache's hits and misses."""
    from . import metrics

    return {key: metrics.counter(name).value for key, name in (
        ("row_groups_scanned", "io.pruning.row_groups_scanned"),
        ("row_groups_skipped", "io.pruning.row_groups_skipped"),
        ("bytes_decoded", "io.pruning.bytes_decoded"),
        ("bytes_skipped", "io.pruning.bytes_skipped"),
        ("bytes_encoded_kept", "io.pruning.bytes_encoded_kept"),
        ("bytes_materialized", "io.pruning.bytes_materialized"),
        ("columns_encoded", "io.encoded.columns_encoded"),
        ("columns_flattened", "io.encoded.columns_flattened"),
        ("footer_hits", "io.footer.hits"),
        ("footer_misses", "io.footer.misses"),
    )}


def _cuda_in_use() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextlib.contextmanager
def trace(log_dir: Optional[str], enabled: bool = True) -> Iterator[None]:
    """Profile the scope into `log_dir`: a `torch.profiler` window of the
    CPU and, when the card is in use, CUDA, written as the Chrome trace
    `device_observatory.CHROME_TRACE_NAME`. Nothing with `enabled=False`
    or no `log_dir`."""
    if not enabled or not log_dir:
        yield
        return
    from . import device_observatory

    os.makedirs(log_dir, exist_ok=True)
    prof = device_observatory.start_profile(_cuda_in_use())
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, device_observatory.CHROME_TRACE_NAME))


@contextlib.contextmanager
def annotate(name: str, enabled: bool = True) -> Iterator[None]:
    """Name a region of the trace: a `torch.profiler.record_function`
    region, and an NVTX range when the card is in use."""
    if not enabled:
        yield
        return
    nvtx = _cuda_in_use()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()

"""One run of one cell: set-up, the measured window, the judgement and the
metrics. `run.py` drives it on the card; the CPU tests drive it with
`device="cpu"` at a tiny scale.

Set-up makes the configuration's tables from the seed, writes them with
pyarrow, builds its indexes through `Hyperspace.create_index`, sizes the
port's caches as the configuration states, turns the rules on and warms the
mix's queries up through the server. The window then runs the mix's closed
loop streams: each stream builds its next query's DataFrame and submits
`lambda: df.collect()` to `Hyperspace(session).server()` as soon as its last
query returned, for `seconds` seconds. Every query submitted in the window is
judged afterwards against the plain reference, and its plan must scan the
indexes its mix entry names.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from . import devtrace, judge, spec, traffic
from .gen.common import write_table

#: How long past the window's close a query may take to answer before it
#: counts as never answered.
ANSWER_GRACE_S = 60.0


@dataclass
class Query:
    """One query a stream sent: what, when, and what came back."""

    stream: int
    query: str
    params: dict
    indexes: List[str]
    t_submit: float
    df: object = None
    wall_submit: float = 0.0
    wall_done: float = 0.0
    t_done: Optional[float] = None
    table: object = None
    error: Optional[str] = None
    wrong: Optional[str] = None
    plan_miss: Optional[str] = None
    rel_err: float = 0.0

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.t_done is None else self.t_done - self.t_submit


class _Gate:
    """Lets streams submit while open; counts queries in flight, so that a
    traced stretch can start and end with none."""

    def __init__(self):
        self._cv = threading.Condition()
        self._open = True
        self.in_flight = 0

    def enter(self) -> None:
        with self._cv:
            while not self._open:
                self._cv.wait()
            self.in_flight += 1

    def leave(self) -> None:
        with self._cv:
            self.in_flight -= 1
            self._cv.notify_all()

    def close_and_drain(self, deadline: float) -> None:
        with self._cv:
            self._open = False
            while self.in_flight and time.perf_counter() < deadline:
                self._cv.wait(0.05)

    def open(self) -> None:
        with self._cv:
            self._open = True
            self._cv.notify_all()


@dataclass
class Run:
    """Everything a run measured; the per-layer metric readers read it."""

    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    workdir: str
    device: str = "cuda"
    t_process: float = field(default_factory=time.perf_counter)
    setup_parts: Dict[str, float] = field(default_factory=dict)
    index_build_s: Dict[str, float] = field(default_factory=dict)
    queries: List[Query] = field(default_factory=list)
    window: tuple = (0.0, 0.0)
    window_wall: tuple = (0.0, 0.0)
    before: dict = field(default_factory=dict)
    after: dict = field(default_factory=dict)
    spans: List[dict] = field(default_factory=list)
    traces: Dict[str, List[dict]] = field(default_factory=dict)
    stretch: Optional[devtrace.Stretch] = None
    stretch_queries: List[Query] = field(default_factory=list)
    memory_peak_bytes: int = 0
    setup_s: float = 0.0
    tables: dict = field(default_factory=dict)
    refs: dict = field(default_factory=dict)
    stretch_offset_ns: int = 0

    # -- helpers the readers use ----------------------------------------
    def completed(self) -> List[Query]:
        """Queries that answered inside the window."""
        return [q for q in self.queries if q.t_done is not None and q.t_done <= self.window[1] and not q.error]

    def counter_delta(self, name: str) -> float:
        """The change over the window of one of the program's registry
        counters."""
        get = lambda side: side.get("metrics", {}).get("counters", {}).get(name, 0)  # noqa: E731
        return get(self.after) - get(self.before)

    def trace_of(self, q: Query) -> List[dict]:
        """The program's spans of query q (traced runs): the trace whose root
        its stream's tenant opened while q was in flight."""
        for qid, spans in self.traces.items():
            root = spans[0]
            if (root["attrs"].get("tenant") == f"stream{q.stream}"
                    and q.wall_submit <= root["start_s"] <= q.wall_done):
                return spans
        return []

    # -- the phases ------------------------------------------------------
    def sync(self) -> None:
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()

    def setup(self) -> None:
        conf, mix = self.cell.config, self.cell.mix
        shutil.rmtree(self.workdir, ignore_errors=True)
        os.makedirs(self.workdir)
        t = time.perf_counter()
        gen = spec.module("gen", conf["generator"])
        self.tables = gen.generate(conf, self.seed)
        self.setup_parts["generate_s"] = time.perf_counter() - t
        t = time.perf_counter()
        src = os.path.join(self.workdir, "src")
        for name, table in self.tables.items():
            tspec = conf["tables"][name]
            write_table(table, os.path.join(src, name), tspec["columns"], tspec.get("row_group_rows"))
        self.setup_parts["write_sources_s"] = time.perf_counter() - t

        os.environ["HYPERSPACE_INDEX_ROW_GROUP_ROWS"] = str(int(conf["index_row_group_rows"]))
        t = time.perf_counter()
        import hyperspace_tpu_torch as hst
        from hyperspace_tpu_torch.engine import physical, scan_cache

        self.setup_parts["import_s"] = time.perf_counter() - t
        t = time.perf_counter()
        caches = conf["caches"]
        scan_cache.global_scan_cache().set_capacity(caches["scan_bytes"])
        scan_cache.global_bucketed_cache().set_capacity(caches["bucketed_concat_bytes"])
        scan_cache.global_concat_cache().set_capacity(caches["concat_bytes"])
        scan_cache.global_filtered_cache().set_capacity(caches["filtered_bytes"])
        physical.set_device_cache_budget(caches["join_memo_bytes"])
        s = hst.HyperspaceSession(warehouse=os.path.join(self.workdir, "warehouse"), device=self.device)
        s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, int(conf["num_buckets"]))
        hs = hst.Hyperspace(s)
        self.reads = {name: s.read.parquet(os.path.join(src, name)) for name in self.tables}
        self.sync()
        self.setup_parts["session_s"] = time.perf_counter() - t
        for ix in conf["indexes"]:
            df = self.reads[ix["table"]]
            t = time.perf_counter()
            hs.create_index(df, hst.IndexConfig(ix["name"], ix["indexed"], ix["included"]))
            self.sync()
            self.index_build_s[ix["name"]] = time.perf_counter() - t
        hst.enable_hyperspace(s)
        self.session, self.col = s, hst.col
        self.server = hs.server(max_concurrent=int(mix["workers"]))
        t = time.perf_counter()
        self._streams(purpose="warmup", rounds=int(mix["warmup_rounds"]))
        if self.trace:
            self._profile_warmup()
        self.setup_parts["warmup_s"] = time.perf_counter() - t

    def _profile_warmup(self) -> None:
        """CUPTI's first start costs seconds: pay it in set-up."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device == "cuda" else [])
        with profile(activities=acts):
            torch.ones(1024, device=self.device).sum().item()

    def _read(self, table: str):
        return self.reads[table]

    def _stream(self, stream: int, purpose: str, rounds: Optional[int], t_end: float, gate: _Gate,
                out: List[Query]) -> None:
        mix = self.cell.mix
        for k, (entry, params) in enumerate(traffic.stream_queries(mix, self.seed, stream, purpose)):
            if rounds is not None and k >= rounds * len(mix["queries"]):
                return
            if rounds is None and time.perf_counter() >= t_end:
                return
            gate.enter()
            try:
                if rounds is None and time.perf_counter() >= t_end:
                    return
                df = spec.module("queries", entry["query"]).build(self._read, self.col, params)
                q = Query(stream, entry["query"], params, list(entry.get("indexes", [])), time.perf_counter(), df)
                out.append(q)
                q.wall_submit = time.time()
                fut = self.server.submit(lambda df=df: df.collect(), tenant=f"stream{stream}", lane=mix["lane"])
                try:
                    q.table = fut.result(timeout=max(0.0, t_end - time.perf_counter()) + ANSWER_GRACE_S
                                         if rounds is None else None)
                    q.t_done = time.perf_counter()
                    q.wall_done = time.time()
                except Exception as e:  # a query that fails or never answers is judged failed
                    q.error = f"{type(e).__name__}: {e}"
                    if rounds is not None:
                        raise
            finally:
                gate.leave()

    def _streams(self, purpose: str, rounds: Optional[int] = None, t_end: float = 0.0,
                 gate: Optional[_Gate] = None) -> List[Query]:
        gate = gate or _Gate()
        out: List[Query] = []
        errors: List[BaseException] = []

        def body(i):
            try:
                self._stream(i, purpose, rounds, t_end, gate, out)
            except BaseException as e:
                errors.append(e)

        threads = [threading.Thread(target=body, args=(i,), name=f"lakebench-stream-{i}", daemon=True)
                   for i in range(int(self.cell.mix["streams"]))]
        for th in threads:
            th.start()
        if rounds is None and self.trace:
            self._traced_stretch(gate, t_end)
        for th in threads:
            th.join(timeout=max(0.0, t_end - time.perf_counter()) + ANSWER_GRACE_S + 30 if rounds is None else None)
        if errors:
            raise errors[0]
        return out

    def _traced_stretch(self, gate: _Gate, t_end: float) -> None:
        """Profile a stretch in the middle of the window that starts and ends
        with no query in flight: the streams pause before their next submit
        at each end, so every query of the stretch lies wholly inside it."""
        from torch.profiler import ProfilerActivity, profile, record_function

        lead, length = self.profile_bounds()
        time.sleep(max(0.0, self.window[0] + lead - time.perf_counter()))
        gate.close_and_drain(t_end + ANSWER_GRACE_S)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device == "cuda" else [])
        prof = profile(activities=acts)
        prof.start()
        self.sync()
        wall_mark = time.time_ns()
        with record_function("lakebench:stretch"):
            pass
        t0 = time.time_ns()
        p0 = time.perf_counter()
        gate.open()
        time.sleep(length)
        gate.close_and_drain(t_end + ANSWER_GRACE_S)
        self.sync()
        t1 = time.time_ns()
        p1 = time.perf_counter()
        prof.stop()
        gate.open()
        mark = next((e for e in prof.profiler.kineto_results.events() if e.name() == "lakebench:stretch"), None)
        offset = int(mark.start_ns()) - wall_mark if mark is not None else 0
        self.stretch = devtrace.from_profiler(prof, t0 + offset, t1 + offset)
        self.stretch_offset_ns = offset
        self._stretch_perf = (p0, p1)

    def profile_bounds(self) -> tuple:
        """(seconds into the window, length) of the traced stretch: the
        middle half of the window, at most 8 seconds."""
        length = min(8.0, self.seconds / 2)
        return (self.seconds - length) / 2, length

    def measure(self) -> None:
        from hyperspace_tpu_torch.engine import io as engine_io
        from hyperspace_tpu_torch.engine import physical
        from hyperspace_tpu_torch.telemetry import metrics

        metrics.histogram("serve.queue.wait_s").reset()
        self.before = {"metrics": metrics.snapshot(), "io": engine_io.io_stats(), "memo": physical.memo_stats()}
        t0 = time.perf_counter()
        self.setup_s = t0 - self.t_process
        self.window = (t0, t0 + self.seconds)
        self.window_wall = (time.time(), time.time() + self.seconds)
        self.queries = self._streams("window", None, self.window[1])
        self.sync()
        self.after = {"metrics": metrics.snapshot(), "io": engine_io.io_stats(), "memo": physical.memo_stats(),
                      "queue_wait_p95_s": metrics.histogram("serve.queue.wait_s").quantile(0.95)}
        if self.stretch is not None:
            p0, p1 = self._stretch_perf
            self.stretch_queries = [q for q in self.queries if q.t_submit >= p0 and q.t_done is not None
                                    and q.t_done <= p1]
        if self.device == "cuda":
            import torch

            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated())

    def release(self) -> None:
        """Close the server and free the program's device state, so that the
        judgement runs on a quiet process."""
        from hyperspace_tpu_torch.engine import physical, scan_cache

        self.server.close(wait=False)
        for q in self.queries:
            if q.table is not None:
                try:
                    q.table = q.table.to_numpy()
                except Exception as e:
                    q.error = q.error or f"to_numpy: {type(e).__name__}: {e}"
                    q.table = None
        scan_cache.clear_scan_caches()
        physical.clear_device_memos()
        if self.device == "cuda":
            import torch

            torch.cuda.empty_cache()

    def check_plans(self) -> None:
        """An indexed query whose plan does not scan its indexes is failed."""
        from hyperspace_tpu_torch.engine.physical import BucketedIndexScanExec

        seen: Dict[tuple, Optional[str]] = {}
        for q in self.queries:
            if not q.indexes:
                continue
            key = traffic.param_key(q.query, q.params)
            if key not in seen:
                scanned = {n.relation.index_name for n in q.df.physical_plan().collect_nodes()
                           if isinstance(n, BucketedIndexScanExec)}
                missing = sorted(set(q.indexes) - scanned)
                seen[key] = f"plan scans {sorted(scanned)}, not {missing}" if missing else None
            q.plan_miss = seen[key]

    def prepare_references(self) -> None:
        shared: dict = {}
        for entry in self.cell.mix["queries"]:
            name = entry["query"]
            if name not in self.refs:
                ref = spec.module("reference", name)
                self.refs[name] = (ref, ref.prepare(self.tables, entry["params"], shared))

    def judge(self) -> None:
        """Each query's rows against the reference's."""
        self.prepare_references()
        want: Dict[tuple, dict] = {}
        for q in self.queries:
            if q.error or q.table is None:
                continue
            ref, state = self.refs[q.query]
            key = traffic.param_key(q.query, q.params)
            if key not in want:
                want[key] = ref.answer(state, q.params, ref.DTYPE)
            wrong, q.rel_err, why = judge.compare(q.table, want[key], ref)
            q.wrong = why if wrong else None

    def readings(self) -> Dict[str, float]:
        """The numbers compared with the cell's limits."""
        judged = [q for q in self.queries]
        return {
            "errors": sum(1 for q in judged if q.error),
            "wrong_answers": sum(1 for q in judged if q.wrong),
            "plan_misses": sum(1 for q in judged if q.plan_miss),
            "measure_rel_err": max([q.rel_err for q in judged] + [0.0]),
        }

    def checks(self) -> Dict[str, dict]:
        lim = self.cell.limits
        return {k: {"value": v, "limit": lim[k]} for k, v in self.readings().items()}

    def correct(self) -> bool:
        return bool(self.queries) and all(c["value"] <= c["limit"] for c in self.checks().values())

    def failed(self) -> int:
        return sum(1 for q in self.queries if q.error or q.wrong or q.plan_miss)

    def end_to_end(self) -> Dict[str, dict]:
        done = self.completed()
        lat = np.array([q.latency_s for q in done]) * 1e3
        values = {
            "qps": len(done) / self.seconds,
            "p50_ms": float(np.percentile(lat, 50)) if len(lat) else None,
            "p95_ms": float(np.percentile(lat, 95)) if len(lat) else None,
            "setup_s": self.setup_s,
        }
        return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in self.cell.end_to_end
                if values.get(m["name"]) is not None}

    def load_spans(self, path: str) -> None:
        """The program's spans (its JSONL trace file) of the window's queries."""
        if not path or not os.path.exists(path):
            return
        lo, hi = self.window_wall[0], self.window_wall[1] + ANSWER_GRACE_S
        with open(path) as f:
            spans = [json.loads(line) for line in f if line.strip()]
        roots = {s["query_id"] for s in spans if s.get("parent_id") is None and lo <= s["start_s"] <= hi}
        self.spans = [s for s in spans if s["query_id"] in roots]
        for s in self.spans:  # each trace root first: the JSONL lists a trace's spans in creation order
            self.traces.setdefault(s["query_id"], []).append(s)
        if self.stretch is not None:
            self.stretch.host = devtrace.host_spans(self.spans, self.stretch.t0, self.stretch.t1,
                                                    self.stretch_offset_ns)

    def per_layer(self) -> Dict[str, dict]:
        out = {}
        for m in self.cell.per_layer:
            v = spec.module("metrics", m["name"]).read(self)
            if v is not None:
                out[m["name"]] = {"value": float(v), "unit": m["unit"]}
        return out

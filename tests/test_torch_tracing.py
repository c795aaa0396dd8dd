"""The port's span tree, metrics registry and events against the JAX package.

Counterparts of `tests/test_tracing.py` (all of it but the Pallas-fallback
case, which becomes "launch counts attach to the summaries") and of the
registry cases of `tests/test_observability.py` (:49-121, :403-431). Where
a case runs a query, both packages run it over the same parquet files and
must give the same span names, parents, rows and decisions; the registry
cases hold the port's `metrics` to the JAX package's `metrics` on the same
observations. Each package has its own process-wide registry, so counters
are compared as each package's own `counters_delta`, never as absolute
values. Tolerance: exact, but for the histogram quantiles, which are held to
the reference's bucket band (within 2x of numpy's quantile) and to the JAX
package's own estimates exactly.
"""

import itertools
import json
import os
import threading
import time
import tracemalloc
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import chip_smoke
import hyperspace_tpu_torch as hst
from hyperspace_tpu.telemetry import metrics as jax_metrics
from hyperspace_tpu.telemetry import tracing as jax_tracing
from hyperspace_tpu_torch.engine import io as engine_io
from hyperspace_tpu_torch.engine import physical, scan_cache
from hyperspace_tpu_torch.engine.table import Table
from hyperspace_tpu_torch.serve import singleflight
from hyperspace_tpu_torch.telemetry import compile_log, metrics, profiling, tracing
from test_torch_star_join import _q2, _star2, make_star
from test_torch_udf_setops import Twin

SINK_ENVS = ("HYPERSPACE_TRACE_FILE", "HYPERSPACE_TRACING", "HYPERSPACE_TIMELINE_DIR", "HYPERSPACE_ACCOUNTING",
             "HYPERSPACE_DEVICE_TIMING", "HYPERSPACE_STAGE_ATTRIBUTION")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    monkeypatch.setenv("HYPERSPACE_FORCE_DEVICE_OPS", "1")
    for k in SINK_ENVS + ("HYPERSPACE_QUERY_STREAMING", "HYPERSPACE_MULTIWAY"):
        monkeypatch.delenv(k, raising=False)
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()
    tracing.reset()
    yield
    tracing.reset()


def _check_jsonl_schema(spans):
    """Every span has a query_id, a non-negative duration and a parent that
    resolves within its trace (`test_tracing._check_jsonl_schema`)."""
    assert spans
    ids = {(sp["query_id"], sp["span_id"]) for sp in spans}
    for sp in spans:
        assert sp["query_id"] and isinstance(sp["span_id"], int), sp
        assert sp["duration_s"] is not None and sp["duration_s"] >= 0, sp
        assert sp["status"] in ("ok", "error", "unclosed"), sp
        if sp["parent_id"] is not None:
            assert (sp["query_id"], sp["parent_id"]) in ids, sp


def _jsonl(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def _is_step(name):
    """The port's operator steps (`<op>.<step>`), which the JAX package does
    not open."""
    return "." in name and ":" not in name


def _edges(spans):
    """(name, parent name) of every span but the synthesized stage spans,
    whose set depends on which stages ran, and the port's steps: a span
    under a step counts under the step's operator."""
    by_id = {sp["span_id"]: sp for sp in spans}

    def parent_name(sp):
        parent = by_id.get(sp["parent_id"])
        while parent is not None and _is_step(parent["name"]):
            parent = by_id.get(parent["parent_id"])
        return None if parent is None else parent["name"]

    return sorted((sp["name"], parent_name(sp)) for sp in spans if not _is_step(sp["name"])
                  and (not sp["name"].startswith(("join:", "query:stages")) or sp["name"] == "join:stages"))


def test_star_query_is_one_span_tree_exported_as_jsonl(tmp_path, monkeypatch):
    """One query = one query_id over plan, rules, operators and the star's
    stage spans, in the JSONL both packages export, with the same spans and
    parents (`test_indexed_join_agg_single_span_tree`; the port's streamed
    join is the star stream)."""
    fact, dims = _star2()
    twin = make_star(tmp_path / "lake", fact, dims)
    exported = []
    for p in (twin.t, twin.j):
        path = str(tmp_path / f"{p.name}.jsonl")
        monkeypatch.setenv("HYPERSPACE_TRACE_FILE", path)
        out = _q2()(p).collect()
        monkeypatch.delenv("HYPERSPACE_TRACE_FILE")
        spans = _jsonl(path)
        _check_jsonl_schema(spans)
        assert len({sp["query_id"] for sp in spans}) == 1
        names = {sp["name"] for sp in spans}
        assert {"query:collect", "plan", "rule:JoinIndexRule", "op:HashAggregate", "join:stages"} <= names
        for stage in ("join:pad", "join:probe", "join:verify", "join:gather"):
            assert stage in names, sorted(names)
        roots = [sp for sp in spans if sp["parent_id"] is None]
        assert len(roots) == 1 and roots[0]["name"] == "query:collect"
        assert roots[0]["attrs"]["rows_out"] == out.num_rows
        rule = next(sp for sp in spans if sp["name"] == "rule:JoinIndexRule")
        assert any(d["applied"] and d.get("star_dims") == 2 for d in rule["attrs"]["decisions"])
        exported.append(spans)
    assert _edges(exported[0]) == _edges(exported[1])


def test_explain_analyze_annotates_the_warm_tree(tmp_path):
    twin = Twin(tmp_path, buckets=8)
    rng = np.random.RandomState(7)
    twin.write("li", {"lk": rng.randint(0, 300, 8000).astype(np.int64), "v": rng.randint(1, 99, 8000).astype(np.int64)})
    twin.write("orders", {"ok": np.arange(300, dtype=np.int64), "w": rng.randint(1, 9, 300).astype(np.int64)})
    p = twin.t
    p.index("li", "liIdx", ["lk"], ["v"])
    p.index("orders", "orIdx", ["ok"], ["w"])
    p.on(p.s)

    def q():
        c = p.col
        return (p.read("li").join(p.read("orders"), c("lk") == c("ok")).with_column("rev", c("v") * c("w"))
                .group_by("lk").agg(total=("rev", "sum")))

    q().collect()
    s = q().explain(analyze=True)
    assert "EXPLAIN ANALYZE" in s and "query_id=" in s and "wall=" in s
    assert "HashAggregate" in s and "SortMergeJoin" in s and "rows=300" in s
    assert "JoinIndexRule: applied" in s and "liIdx" in s and "orIdx" in s
    assert "bucketed_cache=hit" in s and "Cache/metric deltas" in s
    captured = []
    assert q().explain(analyze=True, redirect=captured.append) is None
    assert captured and "EXPLAIN ANALYZE" in captured[0]


def test_explain_analyze_plain_query(tmp_path):
    twin = Twin(tmp_path)
    twin.write("t", {"k": np.arange(100, dtype=np.int64), "v": np.arange(100, dtype=np.int64)})
    texts = twin.both(lambda p: p.read("t").filter(p.col("k") < 50).group_by("k").agg(total=("v", "sum"))
                      .explain(analyze=True))
    for s in texts:
        assert "HashAggregate" in s and "Filter" in s and "Scan" in s and "rows=50" in s
    df = twin.t.read("t")
    assert df.explain() == df.explain_string()


def test_tracing_disabled_records_nothing(tmp_path):
    twin = Twin(tmp_path)
    twin.write("t", {"k": np.arange(10, dtype=np.int64)})
    before = len(tracing.recent_traces())
    twin.t.read("t").collect()
    assert len(tracing.recent_traces()) == before
    with tracing.query_span("query:off") as sp:
        assert sp is tracing.NOOP_SPAN
    with tracing.span("stray") as sp:
        assert sp is tracing.NOOP_SPAN


def test_span_concurrency_and_error_status():
    """Child spans from many pool threads under one root all register; a
    crashing worker's span closes with error status."""
    n_tasks = 200
    with tracing.capture() as cap:
        with tracing.query_span("query:hammer") as root:

            def work(i):
                if i == 137:
                    with pytest.raises(RuntimeError):
                        with tracing.span(f"w{i}", parent=root):
                            raise RuntimeError("worker died")
                    return
                with tracing.span(f"w{i}", parent=root) as sp:
                    sp.set_attr("i", i)

            with ThreadPoolExecutor(max_workers=8) as pool:
                list(pool.map(work, range(n_tasks)))
    trace = cap.trace
    workers = [s for s in trace.spans if s.name.startswith("w")]
    assert len(workers) == n_tasks
    assert all(s.parent_id == trace.root.span_id and s.duration_s >= 0 for s in workers)
    crashed = [s for s in workers if s.name == "w137"]
    assert len(crashed) == 1 and crashed[0].status == "error" and "worker died" in crashed[0].attrs["error"]
    assert all(s.status == "ok" for s in workers if s.name != "w137")


def test_metric_increments_lose_nothing_under_threads():
    c = metrics.counter("test.hammer.counter")
    h = metrics.histogram("test.hammer.hist")
    start, n_threads, n_inc = c.value, 16, 500

    def work(_):
        for _i in range(n_inc):
            c.inc()
            h.observe(0.5)

    with ThreadPoolExecutor(max_workers=n_threads) as pool:
        list(pool.map(work, range(n_threads)))
    assert c.value - start == n_threads * n_inc
    snap = metrics.snapshot()
    assert snap["counters"]["test.hammer.counter"] == c.value
    assert snap["histograms"]["test.hammer.hist"]["count"] >= n_threads * n_inc
    assert json.dumps(snap)


def test_snapshot_hit_rates_derive_from_counter_pairs():
    metrics.counter("test.rate.hits").inc(3)
    metrics.counter("test.rate.misses").inc(1)
    metrics.counter("test.rate.peek_hits").inc(5)
    snap = metrics.snapshot()
    assert snap["rates"]["test.rate"] == 0.75
    assert "test.rate.peek" not in snap["rates"]


def test_trace_history_is_bounded(monkeypatch):
    monkeypatch.setenv(tracing.ENV_TRACING, "1")
    for i in range(tracing._RECENT.maxlen + 5):
        with tracing.query_span(f"query:bounded{i}"):
            pass
    recent = tracing.recent_traces()
    assert len(recent) == tracing._RECENT.maxlen == 16
    assert recent[-1].root.name == f"query:bounded{tracing._RECENT.maxlen + 4}"


def test_nested_collect_stays_one_query(tmp_path, monkeypatch):
    monkeypatch.setenv(tracing.ENV_TRACING, "1")
    twin = Twin(tmp_path)
    twin.write("t", {"k": np.arange(20, dtype=np.int64)})
    for mod, p in ((tracing, twin.t), (jax_tracing, twin.j)):
        with mod.capture() as cap:
            with mod.query_span("query:outer"):
                p.read("t").collect()
        trace = cap.trace
        assert trace.root.name == "query:outer"
        inner = trace.find("query:collect")
        assert len(inner) == 1 and inner[0].parent_id == trace.root.span_id


def _multi_file(base, files=3, rows=1000):
    rng = np.random.RandomState(3)
    for i in range(files):
        engine_io.write_parquet(
            Table.from_pydict({"g": rng.randint(0, 5, rows).astype(np.int64),
                               "x": rng.randint(0, 100, rows).astype(np.int64)}, "cpu"),
            os.path.join(base, "multi", f"part-{i:05d}.parquet"),
        )


def test_stage_spans_ride_streaming_scan_aggregate(tmp_path, monkeypatch):
    """A streamed multi-file scan aggregate records `query:stages` and its
    stage spans under its HashAggregate span, in both packages."""
    monkeypatch.setenv("HYPERSPACE_QUERY_STREAMING", "1")
    twin = Twin(tmp_path)
    _multi_file(twin.base)
    for mod, p in ((tracing, twin.t), (jax_tracing, twin.j)):
        with mod.capture() as cap:
            p.read("multi").group_by("g").agg(total=("x", "sum")).collect()
        by_id = {s.span_id: s for s in cap.trace.spans}
        stages = [s for s in cap.trace.spans if s.name == "query:stages"]
        assert len(stages) == 1, sorted(s.name for s in cap.trace.spans)
        assert by_id[stages[0].parent_id].name == "op:HashAggregate"
        assert any(s.name.startswith("query:") and s.parent_id == stages[0].span_id for s in cap.trace.spans)


def test_launch_counts_attach_to_the_operation_summaries():
    """A kernel launch during an operation is on that operation's stage
    summary as a per-operation delta (the port's counterpart of the JAX
    package's Pallas-fallback delta); a clean operation after it carries no
    `launches` key."""
    label = compile_log.LABELS["K2"]
    compile_log.launch_counter(label).inc(3)
    with compile_log._lock:
        compile_log._programs[label]["launches"] += 3
    st = profiling.StageTimings(mode="t")
    st.add("probe", 0.1)
    with compile_log.observed_launch(label):
        pass
    with compile_log.observed_launch(label):
        pass
    profiling.record_join_stages(st.summary())
    assert profiling.last_join_stages()["launches"] == {label: 2}
    clean = profiling.StageTimings(mode="t")
    clean.add("eval", 0.1)
    profiling.record_query_stages(clean.summary())
    assert "launches" not in profiling.last_query_stages()


def test_event_logger_bad_path_falls_back_to_noop():
    from hyperspace_tpu_torch.telemetry.event_logging import EventLoggerFactory, NoOpEventLogger
    from hyperspace_tpu_torch.telemetry.events import HyperspaceEvent

    EventLoggerFactory.reset()
    try:
        logger = EventLoggerFactory.get_logger("no.such.module.NoSuchLogger")
        assert isinstance(logger, NoOpEventLogger)
        logger.log_event(HyperspaceEvent(message="must not raise"))
        assert EventLoggerFactory.get_logger("no.such.module.NoSuchLogger") is logger
        assert isinstance(EventLoggerFactory.get_logger("hyperspace_tpu_torch.telemetry.NoSuchAttr"), NoOpEventLogger)
    finally:
        EventLoggerFactory.reset()


def test_rule_skip_reasons_recorded(tmp_path):
    """A pattern that matched with no covering index records a skipped
    decision with its reason, the same in both packages."""
    twin = Twin(tmp_path)
    twin.write("t", {"a": np.arange(50, dtype=np.int64), "b": np.arange(50, dtype=np.int64),
                     "c": np.arange(50, dtype=np.int64)})
    got = []
    for mod, p in ((tracing, twin.t), (jax_tracing, twin.j)):
        p.index("t", "abIdx", ["a"], ["b"])
        p.on(p.s)
        df = p.read("t").filter(p.col("c") > 10).select("c")
        with mod.capture() as cap:
            with mod.query_span("query:skip"):
                p.s.optimize(df.plan)
        got.append(cap.trace.find("rule:FilterIndexRule")[0].attrs.get("decisions", []))
    # transform_up meets the pattern twice: at Filter > Scan, then at
    # Project > Filter > Scan.
    assert got[0] == got[1] == [{"rule": "FilterIndexRule", "applied": False, "reason": "not-covering",
                                 "candidates": ["abIdx"]}] * 2


def test_traced_query_equals_untraced(tmp_path, monkeypatch):
    fact, dims = _star2()
    twin = make_star(tmp_path / "lake", fact, dims)
    plain = _q2()(twin.t).collect().rows()
    monkeypatch.setenv("HYPERSPACE_TRACE_FILE", str(tmp_path / "t.jsonl"))
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()
    assert _q2()(twin.t).collect().rows() == plain


def test_span_cap_drops_surface_on_root_and_counter(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS_PER_TRACE", 8)
    before = metrics.counter("trace.spans.dropped").value
    with tracing.capture() as cap:
        with tracing.query_span("query:overflow") as root:
            for i in range(20):
                with tracing.span(f"w{i}", parent=root):
                    pass
    trace = cap.trace
    assert trace.dropped == 13
    assert trace.root.attrs["spans_dropped"] == trace.dropped
    assert metrics.counter("trace.spans.dropped").value == before + trace.dropped


@pytest.mark.parametrize("name", ["build:create_index", "build:refresh_index", "build:optimize_index"])
def test_index_actions_open_root_spans(tmp_path, name):
    """create, refresh and optimize each run under a root span of their name
    carrying the index name (`hyperspace.py:49, :82, :97`)."""
    twin = Twin(tmp_path)
    twin.write("t", {"k": np.arange(40, dtype=np.int64), "v": np.arange(40, dtype=np.int64)})
    p = twin.t
    if name != "build:create_index":
        p.index("t", "spanIdx", ["k"], ["v"])
        twin.write("t", {"k": np.arange(40, 60, dtype=np.int64), "v": np.arange(20, dtype=np.int64)},
                   "part-00001.parquet")
        if name == "build:optimize_index":  # two index versions: something to compact
            p.hs.refresh_index("spanIdx", "incremental")
    with tracing.capture() as cap:
        if name == "build:create_index":
            p.index("t", "spanIdx", ["k"], ["v"])
        elif name == "build:refresh_index":
            p.hs.refresh_index("spanIdx", "full")
        else:
            p.hs.optimize_index("spanIdx", "full")
    assert cap.trace.root.name == name and cap.trace.root.attrs["index_name"] == "spanIdx"


# -- threads, CPU time, waits and operator steps (the port's own) ---------------


def _spin(seconds):
    t0 = time.thread_time()
    while time.thread_time() - t0 < seconds:
        pass


@pytest.mark.parametrize("work, busy", [(_spin, True), (time.sleep, False)], ids=["busy", "sleep"])
def test_a_span_records_its_thread_and_its_cpu_time(work, busy):
    """A span's `cpu_s` is its thread's CPU over it: around 0.05 s of CPU
    work at least that (all of its wall on an idle host), around a sleep
    near 0, and within the thread's CPU read just inside and just outside
    it; `tid` is the opening thread's native id."""
    with tracing.capture() as cap:
        with tracing.query_span("query:clock"):
            outer = time.thread_time()
            with tracing.span("work") as sp:
                inner = time.thread_time()
                work(0.05)
                inner = time.thread_time() - inner
            outer = time.thread_time() - outer
    sp = cap.trace.find("work")[0]
    assert sp.attrs["tid"] == cap.trace.root.attrs["tid"] == threading.get_native_id()
    cpu, wall = sp.attrs["cpu_s"], sp.duration_s
    assert wall >= 0.05 and inner <= cpu <= outer <= wall + 0.01, (inner, cpu, outer, wall)
    if busy:
        assert cpu >= 0.05
    else:
        assert cpu < 0.02, (cpu, wall)
    assert sp.to_json()["attrs"]["cpu_s"] == cpu


def test_spans_that_do_not_end_on_their_thread_carry_no_cpu_time(tmp_path, monkeypatch):
    """A span ended on another thread, one left open until the export closes
    it as `unclosed`, and a synthesized stage span keep their `tid` and have
    no `cpu_s`."""
    path = str(tmp_path / "t.jsonl")
    monkeypatch.setenv("HYPERSPACE_TRACE_FILE", path)
    with tracing.query_span("query:handoff") as root:
        moved = tracing.Span(root.trace, "moved", root.span_id)
        th = threading.Thread(target=moved.end)
        th.start()
        th.join(10)
        assert not th.is_alive()
        tracing.Span(root.trace, "left_open", root.span_id)
        tracing.record_stage_spans("query", {"wall_s": 0.01, "eval_s": 0.005})
    spans = {sp["name"]: sp for sp in _jsonl(path)}
    me = threading.get_native_id()
    assert spans["moved"]["status"] == "ok" and spans["left_open"]["status"] == "unclosed"
    for name in ("moved", "left_open", "query:stages", "query:eval"):
        assert spans[name]["attrs"]["tid"] == me and "cpu_s" not in spans[name]["attrs"], name
    assert spans["query:handoff"]["attrs"]["cpu_s"] >= 0


def test_a_single_flight_wait_is_an_attribute_of_the_ambient_span():
    """A follower's blocked seconds land in its ambient span's `wait_s`, and
    the wait opens no span of its own."""
    key = ("test", "tracing", "wait_s")
    claimed = threading.Event()

    def leader():
        led, _ = singleflight.claim((key,))
        claimed.set()
        deadline = time.monotonic() + 10
        while led[key].waiters == 0 and time.monotonic() < deadline:
            time.sleep(0.001)
        time.sleep(0.03)
        singleflight.finish(led, led.keys())

    th = threading.Thread(target=leader)
    th.start()
    assert claimed.wait(10)
    with tracing.capture() as cap:
        with tracing.query_span("query:follow"):
            with tracing.span("op:Wait"):
                _, followed = singleflight.claim((key,))
                assert singleflight.follow(followed[key])
    th.join(10)
    assert not th.is_alive()
    assert sorted(s.name for s in cap.trace.spans) == ["op:Wait", "query:follow"]
    op = cap.trace.find("op:Wait")[0]
    assert 0.03 <= op.attrs["wait_s"] <= op.duration_s
    assert "wait_s" not in cap.trace.root.attrs


def test_a_steps_kernel_launches_show_on_its_operators_analyzed_line():
    """explain(analyze=True) reads an operator's launches and builds off its
    steps too: a launch inside `join.probe` is the join's."""
    from hyperspace_tpu_torch.plananalysis.analyze import _node_annotation

    with tracing.capture() as cap:
        with tracing.query_span("query:launch"):
            with tracing.span("op:SortMergeJoin", node_id=1) as op:
                op.inc_attr("launches.cuda_sort.sort_rows", 1)
                with tracing.step("join.pairs"):
                    with tracing.step("join.probe") as sp:
                        sp.inc_attr("launches.cuda_probe.range_probe", 2)
                        sp.inc_attr("xla_compiles", 1)
                        sp.inc_attr("xla_compile_s", 0.5)
    op = cap.trace.find("op:SortMergeJoin")[0]
    line = _node_annotation(op, cap.trace.spans_by_parent(), {1})
    assert "launches=cuda_probe.range_probe:2,cuda_sort.sort_rows:1" in line
    assert "compiles=1(+500.0ms)" in line


#: Each step of the Q3 plan and the operator it belongs to.
Q3_STEPS = {
    "filter.key": "op:Filter", "filter.cache_get": "op:Filter", "filter.predicate": "op:Filter",
    "filter.compact": "op:Filter", "filter.cache_put": "op:Filter",
    "join.keys": "op:SortMergeJoin", "join.pairs": "op:SortMergeJoin", "join.layout": "op:SortMergeJoin",
    "join.probe": "op:SortMergeJoin", "join.expand": "op:SortMergeJoin", "join.verify": "op:SortMergeJoin",
    "join.hash": "op:SortMergeJoin", "join.sort": "op:SortMergeJoin", "join.merge": "op:SortMergeJoin",
    "join.gather": "op:SortMergeJoin",
    "agg.keys": "op:HashAggregate", "agg.reduce": "op:HashAggregate", "agg.assemble": "op:HashAggregate",
    "collect.to_host": "query:collect",
}


@pytest.fixture(scope="module")
def q3_lake(tmp_path_factory):
    """TPC-H Q3's tables at a tiny scale with its two covering indexes."""
    base = str(tmp_path_factory.mktemp("q3_steps"))
    chip_smoke.write_sources(chip_smoke.tpch(0.002, 0), base)
    s = hst.HyperspaceSession(warehouse=os.path.join(base, "wh"), device="cpu")
    s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, 4)
    hs = hst.Hyperspace(s)
    for src, name, indexed, included in chip_smoke.Q3_INDEXES:
        hs.create_index(s.read.parquet(os.path.join(base, "src", src)), hst.IndexConfig(name, indexed, included))
    hst.enable_hyperspace(s)
    return lambda: chip_smoke.q3_query(lambda t: s.read.parquet(os.path.join(base, "src", t)), hst.col)


def _op_of(span, by_id):
    """The nearest operator (or root) span above a step."""
    parent = by_id[span.parent_id]
    while parent.parent_id is not None and not parent.name.startswith("op:"):
        parent = by_id[parent.parent_id]
    return parent


def test_a_co_bucketed_q3_records_its_steps_under_their_operators(q3_lake):
    """Every step of Q3's filters, both joins and the aggregate sits under
    its operator, on the query's thread, with its CPU time; the co-bucketed
    join runs layout, probe and expansion, the general join hash, sort and
    merge; no step wraps an operator."""
    plain = q3_lake().collect().rows()
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()
    with tracing.capture() as cap:
        assert q3_lake().collect().rows() == plain
    trace = cap.trace
    by_id = {s.span_id: s for s in trace.spans}
    steps = [s for s in trace.spans if _is_step(s.name)]
    assert {s.name for s in steps} == set(Q3_STEPS)
    tid = trace.root.attrs["tid"]
    for s in steps:
        assert _op_of(s, by_id).name == Q3_STEPS[s.name], s.name
        assert s.attrs["tid"] == tid and s.attrs["cpu_s"] >= 0 and s.status == "ok", s.name
    for s in trace.spans:
        if s.name.startswith("op:"):
            assert not _is_step(by_id[s.parent_id].name), s.name
    joins = [{st.name for st in steps if _op_of(st, by_id) is j} for j in trace.find("op:SortMergeJoin")]
    assert sorted(sorted(j) for j in joins) == sorted([
        ["join.expand", "join.gather", "join.keys", "join.layout", "join.pairs", "join.probe", "join.verify"],
        ["join.gather", "join.hash", "join.keys", "join.merge", "join.pairs", "join.sort", "join.verify"],
    ])
    assert len(trace.spans) < 100 and trace.dropped == 0


def test_with_tracing_off_a_step_site_is_one_predicate(q3_lake, monkeypatch):
    """Tracing off, the same query records no span, every step hook hands
    back `NOOP_SPAN`, and nothing reads a clock or builds a span; a step
    site allocates nothing."""
    plain = q3_lake().collect().rows()
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()
    handed = []
    real_step = tracing.step

    def spy(name):
        out = real_step(name)
        handed.append((name, out))
        return out

    class NoClock:
        def __getattr__(self, name):
            raise AssertionError(f"a clock read with tracing off: time.{name}")

    def no_span(*args, **kwargs):
        raise AssertionError("a span built with tracing off")

    n_traces = len(tracing.recent_traces())
    with monkeypatch.context() as m:
        m.setattr(tracing, "step", spy)
        m.setattr(tracing, "time", NoClock())
        m.setattr(tracing, "Span", no_span)
        assert q3_lake().collect().rows() == plain
    assert len(tracing.recent_traces()) == n_traces
    assert {name for name, _ in handed} == set(Q3_STEPS)
    assert all(out is tracing.NOOP_SPAN for _, out in handed)

    def site(n):
        for _ in n:
            with tracing.step("filter.key"):
                pass

    site(itertools.repeat(None, 10))
    grown = []
    for _ in range(5):  # another thread's allocation may land in one window
        n = itertools.repeat(None, 10_000)
        tracemalloc.start()
        try:
            tracemalloc.reset_peak()
            base = tracemalloc.get_traced_memory()[0]
            site(n)
            grown.append(tracemalloc.get_traced_memory()[1] - base)
        finally:
            tracemalloc.stop()
    assert min(grown) == 0, grown


# -- the registry: tests/test_observability.py :49-121 ----------------------------


def test_histogram_summary_keeps_legacy_fields_and_adds_quantiles():
    got = []
    for mod in (metrics, jax_metrics):
        h = mod.Histogram("t")
        for v in (0.001, 0.01, 0.1, 1.0):
            h.observe(v)
        got.append(h.summary())
    s = got[0]
    assert s == got[1]
    assert s["count"] == 4 and s["total"] == pytest.approx(1.111, abs=1e-6)
    assert s["min"] == 0.001 and s["max"] == 1.0
    assert all(s["min"] <= s[k] <= s["max"] for k in ("p50", "p90", "p99"))


def test_histogram_quantiles_within_bucket_tolerance():
    vals = np.random.RandomState(11).uniform(0.001, 1.0, 20000)
    h, jh = metrics.Histogram("t"), jax_metrics.Histogram("t")
    for v in vals:
        h.observe(v)
        jh.observe(v)
    for q in (0.5, 0.9, 0.99):
        true = float(np.quantile(vals, q))
        assert true / 2 <= h.quantile(q) <= true * 2
        assert h.quantile(q) == jh.quantile(q)
    assert h.bucket_counts() == jh.bucket_counts()
    empty = metrics.Histogram("e")
    assert empty.quantile(0.5) is None and "p50" not in empty.summary() and empty.bucket_counts() == []
    one = metrics.Histogram("o")
    one.observe(0.25)
    assert one.quantile(0.5) == 0.25 and one.bucket_counts()[-1] == (float("inf"), 1)
    assert metrics.BUCKET_BOUNDS == jax_metrics.BUCKET_BOUNDS


def test_histogram_concurrent_observe_loses_nothing():
    h = metrics.histogram("test.obs.hammer")
    h.reset()
    n_threads, n_obs = 16, 500
    vals = [0.001 * (i + 1) for i in range(n_threads)]

    def work(i):
        for _ in range(n_obs):
            h.observe(vals[i])

    with ThreadPoolExecutor(max_workers=n_threads) as pool:
        list(pool.map(work, range(n_threads)))
    s = h.summary()
    assert s["count"] == n_threads * n_obs and s["min"] == vals[0] and s["max"] == vals[-1]
    assert s["total"] == pytest.approx(sum(vals) * n_obs, rel=1e-9)
    assert h.bucket_counts()[-1][1] == n_threads * n_obs


def test_gauge_add_and_high_water_mark():
    g = metrics.Gauge("t")
    g.inc(3)
    g.dec()
    assert g.value == 2
    g.set_max(10)
    g.set_max(5)
    assert g.value == 10


def test_counters_delta_is_each_packages_own():
    """Both registries in one process: each package's delta over the same
    query is its own, and the two agree on the scan counters."""
    before = (metrics.snapshot(), jax_metrics.snapshot())
    metrics.counter("test.delta.only_torch").inc(2)
    after = (metrics.snapshot(), jax_metrics.snapshot())
    assert metrics.counters_delta(before[0], after[0]) == {"test.delta.only_torch": 2}
    assert jax_metrics.counters_delta(before[1], after[1]) == {}

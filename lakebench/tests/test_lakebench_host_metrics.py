"""The host and operator readers (`query_cpu_ms`, `offcpu_ms`,
`filter_cpu_ms`, `join_cpu_ms`, `agg_cpu_ms`) on hand-built span lists."""

import types

import pytest

from lakebench import spec

READERS = ("query_cpu_ms", "offcpu_ms", "filter_cpu_ms", "join_cpu_ms", "agg_cpu_ms")


def span(i, parent, name, tid, start, dur, cpu=None, **attrs):
    a = dict(attrs, tid=tid)
    if cpu is not None:
        a["cpu_s"] = cpu
    return {"query_id": "q", "span_id": i, "parent_id": parent, "name": name, "start_s": start, "duration_s": dur,
            "status": "ok", "attrs": a}


def q3_trace(cpu=True):
    """A Q3-shaped trace on thread 1: a join over a filter, with steps, and a
    decode worker on thread 2 under the filter's scan."""
    c = (lambda v: v) if cpu else (lambda v: None)
    return [
        span(0, None, "query:collect", 1, 0.0, 1.0, c(0.6)),
        span(1, 0, "op:HashAggregate", 1, 0.1, 0.8, c(0.5)),
        span(2, 1, "agg.keys", 1, 0.7, 0.1, c(0.05)),
        span(3, 1, "op:SortMergeJoin", 1, 0.1, 0.6, c(0.4)),
        span(4, 3, "join.pairs", 1, 0.5, 0.1, c(0.08), wait_s=0.05),
        span(5, 3, "op:Filter", 1, 0.1, 0.4, c(0.25)),
        span(6, 5, "filter.predicate", 1, 0.1, 0.1, c(0.1)),
        span(7, 5, "op:BucketedIndexScan", 1, 0.3, 0.1, c(0.05)),
        span(8, 7, "decode:file", 2, 0.31, 0.05, c(0.04)),
        span(9, 8, "decode:inner", 2, 0.32, 0.02, c(0.02)),
        span(10, 3, "op:Filter", 2, 0.55, 0.05, c(0.03)),
        span(11, 5, "filter.wait", 1, 0.2, 0.05, c(0.0), wait_s=0.01),
    ]


def fake_run(traces):
    queries = [types.SimpleNamespace(id=i) for i in range(len(traces))]
    return types.SimpleNamespace(completed=lambda: queries, trace_of=lambda q: traces[q.id])


def read(name, run):
    return spec.module("metrics", name).read(run)


def test_self_cpu_subtracts_only_operator_children_on_the_same_thread():
    run = fake_run([q3_trace()])
    # Filter 5: 0.25 - its scan 0.05 (steps are its own); filter 10 on thread 2: 0.03.
    assert read("filter_cpu_ms", run) == pytest.approx(1e3 * (0.25 - 0.05 + 0.03))
    # The join: 0.4 - filter 5 (0.25); filter 10 ran on another thread.
    assert read("join_cpu_ms", run) == pytest.approx(1e3 * (0.4 - 0.25))
    assert read("agg_cpu_ms", run) == pytest.approx(1e3 * (0.5 - 0.4))


def test_query_cpu_adds_each_other_threads_outermost_spans():
    # The root 0.6, thread 2's decode 0.04 (its inner span is inside it) and filter 10 0.03.
    assert read("query_cpu_ms", fake_run([q3_trace()])) == pytest.approx(1e3 * (0.6 + 0.04 + 0.03))


def test_offcpu_subtracts_the_waits_on_the_query_thread():
    assert read("offcpu_ms", fake_run([q3_trace()])) == pytest.approx(1e3 * (1.0 - 0.6 - 0.05 - 0.01))


def test_the_mean_is_over_the_queries_whose_traces_say():
    fast = q3_trace()
    fast[0]["attrs"]["cpu_s"] = 0.2
    slow = q3_trace()
    slow[0]["attrs"]["cpu_s"] = 0.9
    run = fake_run([fast, q3_trace(), slow, [], q3_trace(cpu=False)])
    assert read("query_cpu_ms", run) == pytest.approx(1e3 * (0.27 + 0.67 + 0.97) / 3)


@pytest.mark.parametrize("name", READERS)
def test_a_trace_without_cpu_time_reads_none_not_zero(name):
    assert read(name, fake_run([q3_trace(cpu=False)])) is None
    assert read(name, fake_run([])) is None


def test_an_operator_whose_child_lacks_cpu_time_reads_none():
    t = q3_trace()
    del t[7]["attrs"]["cpu_s"]  # the scan under filter 5, closed as unclosed
    assert read("filter_cpu_ms", fake_run([t])) is None
    assert read("agg_cpu_ms", fake_run([t])) == pytest.approx(1e3 * 0.1)


def test_a_tiny_traced_run_reads_all_five_and_names_the_steps(tmp_path, monkeypatch):
    """Through the port on the CPU: the five read, and the idle attribution
    can name the operators' steps (a CPU run's stretch is all idle)."""
    from conftest import TPCH
    from test_lakebench_rehearsal import rehearse

    from lakebench import devtrace

    run = rehearse(tmp_path, TPCH, trace=True, monkeypatch=monkeypatch)
    layers = run.per_layer()
    for name in READERS:
        assert layers[name]["value"] >= 0 or name == "offcpu_ms", (name, layers.get(name))
    assert layers["query_cpu_ms"]["value"] >= layers["filter_cpu_ms"]["value"] > 0
    names = {n for _, _, n, _ in run.stretch.host}
    assert {"filter.predicate", "filter.compact", "join.pairs", "agg.keys", "collect.to_host"} <= names
    assert any("." in n for n, _ in devtrace.breakdown(run.stretch)["idle_gaps"])

"""The idle union, the breakdown and the roofline arithmetic on synthetic
events."""

import math
import types

import pytest

from lakebench import devtrace, kernelwork, peaks
from lakebench.metrics import device_idle_share, k1_roofline, k2_roofline


def stretch():
    # t in ns: kernels overlap on two streams; a copy; one event past the end.
    dev = [(100, 300, "sort_tiles<1024>"), (200, 400, "windowed_probe<long, 2>"), (600, 700, "Memcpy DtoH"),
           (950, 1200, "merge_runs")]
    host = [(0, 1000, "query:collect", 0), (450, 560, "op:Filter", 1), (700, 1000, "op:SortMergeJoin", 1)]
    return devtrace.Stretch(0, 1000, dev, host)


def test_busy_time_is_the_union_of_intervals_within_the_stretch():
    st = stretch()
    assert devtrace.union([(a, b) for a, b, _ in st.device], 0, 1000) == [(100, 400), (600, 700), (950, 1000)]
    assert devtrace.busy_seconds(st) == pytest.approx(450e-9)
    assert devtrace.gaps(st) == [(0, 100), (400, 600), (700, 950)]


def test_idle_gaps_are_named_by_the_innermost_span_and_ops_by_name():
    b = devtrace.breakdown(stretch())
    idle = dict(b["idle_gaps"])
    assert idle == pytest.approx({"query:collect": 100e-9, "op:Filter": 200e-9, "op:SortMergeJoin": 250e-9})
    ops = dict(b["device_ops"])
    assert ops["merge_runs"] == pytest.approx(50e-9)  # clipped to the stretch
    assert b["device_ops"][0][0] in ("sort_tiles<1024>", "windowed_probe<long, 2>")


def test_kernel_seconds_match_names_inside_templated_names():
    st = stretch()
    assert devtrace.kernel_seconds(st, ("sort_tiles", "merge_runs")) == pytest.approx(450e-9)
    assert devtrace.kernel_seconds(st, ("windowed_probe",)) == pytest.approx(200e-9)


def test_host_spans_are_shifted_onto_the_profiler_clock_with_their_depth():
    spans = [{"query_id": "q", "span_id": 0, "parent_id": None, "name": "query:collect", "start_s": 1.0,
              "duration_s": 2.0},
             {"query_id": "q", "span_id": 1, "parent_id": 0, "name": "plan", "start_s": 1.5, "duration_s": 0.1}]
    out = devtrace.host_spans(spans, 0, 10**10, offset_ns=5)
    assert out == [(10**9 + 5, 3 * 10**9 + 5, "query:collect", 0), (1_500_000_005, 1_600_000_005, "plan", 1)]


def test_the_bound_is_the_larger_of_bytes_and_compares():
    t, by = peaks.bound_seconds(3.35e12, 1.0)
    assert (t, by) == (1.0, "bytes")
    t, by = peaks.bound_seconds(1.0, 134e12)
    assert (t, by) == (2.0, "operations")
    assert peaks.roofline_share(1.0, 4.0) == 25.0 and peaks.roofline_share(1.0, 0.0) is None


def test_kernel_work_counts_each_byte_once():
    assert kernelwork.k1_sort(1000, 10) == (20_000.0, 1000 * math.log2(100))
    b, o = kernelwork.k2_probe(800, 200, 10)
    assert b == 8 * 200 + 8 * 800 + 8 * 200 and o == 2 * 200 * math.log2(80)
    b, o = kernelwork.k2_probe(10**7, 10, 100)  # a few keys probe a large side: a few searches' keys read
    assert b == 8 * 10 + 8 * 10 * math.log2(10**5) + 8 * 10


def _run(spans_by_query, queries, ref):
    run = types.SimpleNamespace()
    run.stretch = stretch()
    run.stretch_queries = queries
    run.cell = types.SimpleNamespace(config={"num_buckets": 10})
    run.refs = {"q": (ref, None)}
    run.trace_of = lambda q: spans_by_query[q.id]
    return run


def test_the_star_counts_only_dimensions_whose_memo_missed():
    ref = types.SimpleNamespace(STAR="fact", join_rows=lambda st, p: {"fact": 1000, "d1": 100, "d2": 50})
    spans = [{"name": "query:collect", "parent_id": None, "attrs": {}},
             {"name": "join:stages", "parent_id": 0, "attrs": {"star_dims": [
                 {"index": "d1", "memo": "miss"}, {"index": "d2", "memo": "hit"}]}}]
    q = types.SimpleNamespace(id=0, query="q", params={})
    run = _run({0: spans}, [q], ref)
    k1 = kernelwork.stretch_work(run, "K1")
    assert k1[0] == 20.0 * 1100
    assert kernelwork.stretch_work(run, "K2") == kernelwork.k2_probe(1000, 100, 10)
    share = k1_roofline.read(run)
    assert share == pytest.approx(100 * peaks.bound_seconds(*k1)[0] / 450e-9)


def test_a_pair_counts_only_when_the_query_laid_its_pads():
    ref = types.SimpleNamespace(PAIRS=[("a", "b")], join_rows=lambda st, p: {"a": 400, "b": 100})
    ran = [{"name": "query:collect", "parent_id": None, "attrs": {"ledger": {"pad_bytes_payload": 8}}}]
    memo = [{"name": "query:collect", "parent_id": None, "attrs": {"ledger": {"pad_bytes_payload": 0}}}]
    qs = [types.SimpleNamespace(id=i, query="q", params={}) for i in range(2)]
    run = _run({0: ran, 1: memo}, qs, ref)
    assert kernelwork.stretch_work(run, "K2") == kernelwork.k2_probe(400, 100, 10)
    assert kernelwork.stretch_work(run, "K1") == (0.0, 0.0)
    assert k1_roofline.read(run) is None
    assert k2_roofline.read(run) == pytest.approx(
        100 * peaks.bound_seconds(*kernelwork.k2_probe(400, 100, 10))[0] / 200e-9)


def test_idle_share_reads_the_stretch():
    run = types.SimpleNamespace(stretch=stretch())
    assert device_idle_share.read(run) == pytest.approx(55.0)
    assert device_idle_share.read(types.SimpleNamespace(stretch=None)) is None

"""The port's query ledger, stage ledger, device observatory, kernel
observatory and plan fingerprints against the JAX package.

Counterparts of `tests/test_observability.py` :124-253 and :417-431 (the
ledger and the decode pool), `tests/test_stage_attribution.py` :94-201 and
:351-446 (stage scopes, reconciliation, zero cost off, the Chrome trace) and
`tests/test_device_observatory.py` :60-378 (probes, pads, transfers, the
memory sample and pool adoption). Where a case runs a query, both packages
run it over the same parquet files and their ledgers must agree on
`rows_produced`, `decode_files` and `bytes_decoded`, exactly.

The device-time probes run here on the CPU with fake events (the kernels
only launch on the card): `device_observatory._make_event` is replaced by an
event whose elapsed time is the host's. `tests/test_torch_cuda.py` holds the
cases with real CUDA events and real launches.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

from hyperspace_tpu.telemetry import accounting as jax_accounting
from hyperspace_tpu_torch import resilience
from hyperspace_tpu_torch.engine import io as engine_io
from hyperspace_tpu_torch.engine import physical, scan_cache
from hyperspace_tpu_torch.engine.table import Table
from hyperspace_tpu_torch.exceptions import CompileTimeoutError, TransientError
from hyperspace_tpu_torch.ops import _kernels, cuda_comp_sort, cuda_packed_probe, cuda_packed_sort, cuda_probe, cuda_sort
from hyperspace_tpu_torch.plananalysis import attribution, costmodel, fingerprint
from hyperspace_tpu_torch.telemetry import accounting, compile_log, faults, metrics, stage_ledger, tracing
from hyperspace_tpu_torch.telemetry import device_observatory as dv
from test_torch_udf_setops import Twin

CLEAN = ("HYPERSPACE_TRACE_FILE", "HYPERSPACE_TRACING", "HYPERSPACE_TIMELINE_DIR", "HYPERSPACE_ACCOUNTING",
         "HYPERSPACE_DEVICE_TIMING", "HYPERSPACE_DEVICE_TIMING_INTERVAL_S", "HYPERSPACE_STAGE_ATTRIBUTION",
         "HYPERSPACE_COMPILE_TIMEOUT_S", "HYPERSPACE_QUERY_STREAMING", "HYPERSPACE_BUILD_DECODE_THREADS",
         "HYPERSPACE_PLANNER_DIR", "HYPERSPACE_HISTORY")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    monkeypatch.setenv("HYPERSPACE_FORCE_DEVICE_OPS", "1")
    for k in CLEAN:
        monkeypatch.delenv(k, raising=False)
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()
    dv.reset()
    accounting.reset()
    yield
    dv.reset()


class FakeEvent:
    """A CUDA event stand-in: recorded at the host's clock."""

    def __init__(self, device=None):
        self.t = time.monotonic()
        self.synced = False

    def synchronize(self):
        self.synced = True

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


@pytest.fixture()
def fake_events(monkeypatch):
    made = []

    def make(device):
        ev = FakeEvent(device)
        made.append(ev)
        return ev

    monkeypatch.setattr(dv, "_make_event", make)
    return made


def _launch(label="cuda_probe.range_probe", seconds=0.0):
    with compile_log.observed_launch(label):
        if seconds:
            time.sleep(seconds)


def write_sorted(twin, name="t", n=4000, parts=1):
    """Key-sorted files of 4 row groups each: an equality filter on `k`
    prunes 3 of 4 groups, so pruned decodes (the ledger's bytes_decoded)
    happen."""
    for j in range(parts):
        engine_io.write_parquet(
            Table.from_pydict({"k": np.arange(n, dtype=np.int64) + j * n, "v": np.arange(n, dtype=np.float64)},
                              "cpu"),
            os.path.join(twin.base, name, f"part-{j:05d}.parquet"), row_group_rows=n // 4,
        )


# -- the query ledger (tests/test_observability.py :124-253) ----------------------


def test_ledger_attributes_decodes_and_reconciles_bytes_like_the_jax_package(tmp_path, monkeypatch):
    monkeypatch.setenv("HYPERSPACE_ACCOUNTING", "1")
    twin = Twin(tmp_path)
    write_sorted(twin)
    got = []
    for p, acc in ((twin.t, accounting), (twin.j, jax_accounting)):
        before = metrics.counter("io.pruning.bytes_decoded").value
        assert p.read("t").filter(p.col("k") == 7).collect().num_rows == 1
        d = acc.recent_ledgers()[-1].to_dict()
        assert d["name"] == "query:collect" and d["wall_s"] > 0 and d["decode_task_s"] > 0
        if p is twin.t:
            assert d["bytes_decoded"] == metrics.counter("io.pruning.bytes_decoded").value - before > 0
            assert d["bytes_skipped"] > 0
        got.append((d["rows_produced"], d["decode_files"], d["bytes_decoded"]))
    assert got[0] == got[1]


def test_ledger_interleaved_queries_attribute_separately(tmp_path, monkeypatch):
    """Two queries on two threads: each one's pool decodes land on its own
    ledger."""
    monkeypatch.setenv("HYPERSPACE_ACCOUNTING", "1")
    twin = Twin(tmp_path)
    for i, n_files in enumerate((3, 5)):
        for j in range(n_files):
            engine_io.write_parquet(Table.from_pydict({"k": np.arange(500, dtype=np.int64) + 1000 * i + j}, "cpu"),
                                    os.path.join(twin.base, f"t{i}", f"part-{j:05d}.parquet"))
    barrier = threading.Barrier(2)
    results = {}

    def run(i):
        df = twin.t.read(f"t{i}")
        barrier.wait()
        results[i] = df.collect().num_rows

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results == {0: 1500, 1: 2500}
    by_rows = {d["rows_produced"]: d for d in (led.to_dict() for led in accounting.recent_ledgers())}
    assert by_rows[1500]["decode_files"] == 3 and by_rows[2500]["decode_files"] == 5
    assert by_rows[1500]["query_id"] != by_rows[2500]["query_id"]


def test_ledger_rides_root_span_and_explain_analyze(tmp_path):
    twin = Twin(tmp_path)
    write_sorted(twin)
    df = twin.t.read("t").filter(twin.t.col("k") < 100)
    with tracing.capture() as cap:
        df.collect()
    led = cap.trace.root.attrs.get("ledger")
    assert led is not None and led["query_id"] == cap.trace.query_id and led["rows_produced"] == 100
    s = df.explain(analyze=True)
    assert "Resource ledger (this query):" in s and "rows_produced: 100" in s


def test_nested_collect_reports_root_rows_only(tmp_path, monkeypatch):
    monkeypatch.setenv("HYPERSPACE_ACCOUNTING", "1")
    twin = Twin(tmp_path)
    twin.write("t", {"k": np.arange(500, dtype=np.int64)})
    with tracing.capture():
        with tracing.query_span("query:outer"):
            assert twin.t.read("t").collect().num_rows == 500
            accounting.set_value("rows_produced", 7)
    led = accounting.recent_ledgers()[-1].to_dict()
    assert led["name"] == "query:outer" and led["rows_produced"] == 7 and led["decode_files"] >= 1


def test_no_ledger_when_everything_off(tmp_path):
    twin = Twin(tmp_path)
    twin.write("t", {"k": np.arange(10, dtype=np.int64)})
    before = len(accounting.recent_ledgers())
    twin.t.read("t").collect()
    assert len(accounting.recent_ledgers()) == before


def test_decode_in_flight_gauge_returns_to_zero(tmp_path, monkeypatch):
    monkeypatch.setenv("HYPERSPACE_BUILD_DECODE_THREADS", "4")
    twin = Twin(tmp_path)
    for j in range(6):
        engine_io.write_parquet(Table.from_pydict({"k": np.arange(200, dtype=np.int64) + j}, "cpu"),
                                os.path.join(twin.base, "multi", f"part-{j:05d}.parquet"))
    peak0 = metrics.gauge("io.decode.in_flight_peak").value
    metrics.gauge("io.decode.in_flight_peak").set(0)
    twin.t.read("multi").collect()
    assert metrics.gauge("io.decode.in_flight").value == 0
    assert metrics.gauge("io.decode.in_flight_peak").value >= 1
    metrics.gauge("io.decode.in_flight_peak").set_max(peak0)


def test_tenant_scope_labels_ledgers_and_rolls_up(tmp_path):
    twin = Twin(tmp_path)
    twin.write("t", {"k": np.arange(30, dtype=np.int64)})
    with accounting.tenant_scope("acme"):
        twin.t.read("t").collect()
        twin.t.read("t").collect()
    roll = accounting.tenant_rollup()["acme"]
    assert roll["queries"] == 2 and roll["rows_produced"] == 60
    assert accounting.recent_ledgers()[-1].tenant == "acme"


def test_retries_and_injected_faults_charge_the_ledger(tmp_path, monkeypatch):
    monkeypatch.setenv("HYPERSPACE_ACCOUNTING", "1")
    monkeypatch.setenv("HYPERSPACE_RETRY_BACKOFF_S", "0.001")
    twin = Twin(tmp_path)
    twin.write("t", {"k": np.arange(30, dtype=np.int64)})
    faults.reset_counters()
    with faults.inject("io.decode", rate=1.0, limit=1):
        assert twin.t.read("t").collect().num_rows == 30
    d = accounting.recent_ledgers()[-1].to_dict()
    assert d["faults_injected"] == 1 and d["io_retries"] == 1
    rel = resilience.reliability_rollup()
    assert rel["faults_injected"] == 1 and rel["io_retries"] >= 1
    faults.reset_counters()


# -- the stage ledger (tests/test_stage_attribution.py :94-201, :351-446) ---------


def test_stage_scope_banks_walls_on_query_scope():
    with resilience.query_scope("q-walls"):
        assert stage_ledger.query_stage_walls() is None
        with stage_ledger.stage_scope("probe"):
            assert stage_ledger.current_stage() == "probe"
            time.sleep(0.01)
        with stage_ledger.stage_scope("pad"):
            pass
        walls = stage_ledger.query_stage_walls()
        assert set(walls) == {"probe", "pad"} and walls["probe"] >= 0.01
    assert stage_ledger.current_stage() is None


def test_stage_scope_nested_innermost_wins():
    with resilience.query_scope("q-nest"):
        with stage_ledger.stage_scope("outer"):
            with stage_ledger.stage_scope("inner"):
                assert stage_ledger.current_stage() == "inner"
            assert stage_ledger.current_stage() == "outer"
        assert set(stage_ledger.query_stage_walls()) == {"outer", "inner"}


def test_no_scope_means_no_walls():
    with stage_ledger.stage_scope("orphan"):
        pass
    assert stage_ledger.query_stage_walls() is None


def _pruned_multi_file(twin, parts=4, rows=400):
    write_sorted(twin, "p", n=rows, parts=parts)
    return lambda p: p.read("p").filter(p.col("k").isin([j * rows + 7 for j in range(parts)]))


def test_threaded_decode_workers_bill_decode_stage(tmp_path, monkeypatch):
    """The decode pool's workers charge the calling query's ledger and its
    `decode` stage; the JAX package's ledger agrees on rows, files and
    bytes."""
    monkeypatch.setenv("HYPERSPACE_ACCOUNTING", "1")
    monkeypatch.setenv("HYPERSPACE_BUILD_DECODE_THREADS", "2")
    monkeypatch.setenv("HYPERSPACE_QUERY_STREAMING", "1")
    twin = Twin(tmp_path)
    q = _pruned_multi_file(twin)
    workers = []
    real = engine_io._decode_into_cache

    def spy(*a, **k):
        workers.append((threading.current_thread() is threading.main_thread(), accounting.current_ledger(),
                        stage_ledger.current_stage()))
        return real(*a, **k)

    monkeypatch.setattr(engine_io, "_decode_into_cache", spy)
    got = []
    for p, acc in ((twin.t, accounting), (twin.j, jax_accounting)):
        assert p.read("p").filter(p.col("k").isin([7, 407, 807, 1207])).group_by("k").agg(
            n=("*", "count")).collect().num_rows == 4
        d = acc.recent_ledgers()[-1].to_dict()
        got.append((d["rows_produced"], d["decode_files"], d["bytes_decoded"]))
        if p is twin.t:
            stages = d["stages"]
            assert stages["decode"]["bytes_decoded"] == d["bytes_decoded"] > 0
            assert stages["decode"]["wall_s"] > 0
            off_main = [w for w in workers if not w[0]]
            assert off_main and all(led is not None and led.query_id == d["query_id"] and st == "decode"
                                    for _, led, st in off_main)
    assert got[0] == got[1]
    assert q(twin.t).collect().num_rows == 4


def test_stage_totals_reconcile_with_ledger_counters(tmp_path, monkeypatch, fake_events):
    monkeypatch.setenv("HYPERSPACE_ACCOUNTING", "1")
    twin = Twin(tmp_path)
    q = _pruned_multi_file(twin)
    monkeypatch.setenv("HYPERSPACE_DEVICE_TIMING", "all")
    with resilience.query_scope("query:collect"):
        with accounting.ledger_scope("qid-rec", "query:collect"):
            q(twin.t).collect()
            with stage_ledger.stage_scope("probe"):
                _launch()
            _launch()
            dv.record_pad("site_r", 100, 28)
    d = accounting.ledger_for("qid-rec").to_dict()
    stages = d["stages"]
    for counter_key, field in stage_ledger._COUNTER_VECTOR.items():
        total = d.get(counter_key) or 0
        if total:
            assert sum(vec.get(field, 0) for vec in stages.values()) == pytest.approx(total, rel=1e-6), counter_key
    assert d["bytes_decoded"] > 0 and stages["probe"]["device_s"] > 0 and stages["<unlabeled>"]["device_s"] > 0


def test_attribution_off_is_zero_cost_and_byte_identical(tmp_path, monkeypatch):
    monkeypatch.setenv("HYPERSPACE_ACCOUNTING", "1")
    monkeypatch.setenv("HYPERSPACE_QUERY_STREAMING", "1")
    twin = Twin(tmp_path)
    write_sorted(twin, "s", n=400, parts=4)
    calls = []
    real = stage_ledger._scope_ledger

    def counting(create):
        calls.append(create)
        return real(create)

    monkeypatch.setattr(stage_ledger, "_scope_ledger", counting)

    def q():
        return twin.t.read("s").group_by("k").agg(total=("v", "sum")).collect().rows()

    monkeypatch.setenv("HYPERSPACE_STAGE_ATTRIBUTION", "0")
    rows_off = q()
    assert calls == []
    assert "stages" not in accounting.recent_ledgers()[-1].to_dict()
    monkeypatch.setenv("HYPERSPACE_STAGE_ATTRIBUTION", "1")
    assert q() == rows_off and calls


def test_knob_stage_seconds_subtotals_and_fallback():
    walls = {"pad": 0.01, "probe": 0.02, "verify": 0.03, "decode": 9.0}
    assert attribution.knob_stage_seconds("join_size_classes", walls) == pytest.approx(0.06)
    assert attribution.knob_stage_seconds("pushdown", walls) == pytest.approx(9.0)
    assert attribution.knob_stage_seconds("join_size_classes", None) is None
    assert attribution.knob_stage_seconds("no_such_knob", walls) is None
    assert attribution.knob_stage_seconds("packed_codes", {"decode": 1.0}) is None
    assert set(attribution.KNOB_STAGES) == set(costmodel.KNOBS)


def _span(name, span_id, parent, start, dur):
    return {"query_id": "q-trace", "span_id": span_id, "parent_id": parent, "name": name, "start_s": start,
            "duration_s": dur, "status": "ok", "attrs": {}}


def test_chrome_trace_gives_each_stage_its_own_lane():
    from hyperspace_tpu.telemetry import stage_ledger as jax_stage_ledger

    spans = [_span("query:collect", "r", None, 0.0, 1.0), _span("join:stages", "s", "r", 0.1, 0.8),
             _span("join:pad", "p1", "s", 0.1, 0.2), _span("join:probe", "p2", "s", 0.3, 0.3),
             _span("join:verify", "p3", "s", 0.6, 0.2), _span("op:scan", "o1", "r", 0.0, 0.1),
             _span("worker:decode", "w1", "r", 0.0, 0.05)]
    doc = stage_ledger.chrome_trace(spans)
    assert doc == jax_stage_ledger.chrome_trace(spans)
    lanes = doc["otherData"]["lanes"]
    assert sorted(ln for ln in lanes if ln.startswith("stage:")) == ["stage:pad", "stage:probe", "stage:verify"]
    assert {"query", "ops", "workers"} <= set(lanes)
    xs = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    assert len({xs[n]["tid"] for n in ("join:pad", "join:probe", "join:verify")}) == 3
    assert xs["join:probe"]["ts"] == pytest.approx(0.3e6) and json.dumps(doc)


def test_live_timeline_capture_writes_per_query_file(tmp_path, monkeypatch):
    tdir = str(tmp_path / "timelines")
    monkeypatch.setenv("HYPERSPACE_TIMELINE_DIR", tdir)
    monkeypatch.setenv("HYPERSPACE_QUERY_STREAMING", "1")
    twin = Twin(tmp_path / "lake")
    write_sorted(twin, "s", n=400, parts=2)
    with tracing.capture() as cap:
        twin.t.read("s").group_by("k").agg(total=("v", "sum")).collect()
    with open(os.path.join(tdir, f"timeline-{cap.trace.query_id}.json")) as fh:
        doc = json.load(fh)
    assert doc["otherData"]["query_id"] == cap.trace.query_id
    assert any(e["ph"] == "X" for e in doc["traceEvents"])
    assert any(ln.startswith("stage:") for ln in doc["otherData"]["lanes"])


def test_explain_analyze_renders_attribution_section(tmp_path, monkeypatch):
    monkeypatch.setenv("HYPERSPACE_ACCOUNTING", "1")
    monkeypatch.setenv("HYPERSPACE_QUERY_STREAMING", "1")
    twin = Twin(tmp_path)
    write_sorted(twin, "s", n=400, parts=4)

    def q():
        return twin.t.read("s").group_by("k").agg(total=("v", "sum"))

    txt = q().explain(analyze=True)
    assert "Attribution (per-stage cost vectors):" in txt and "[knobs:" in txt
    monkeypatch.setenv("HYPERSPACE_STAGE_ATTRIBUTION", "0")
    txt_off = q().explain(analyze=True)
    assert "Attribution (per-stage cost vectors):" not in txt_off and "Resource ledger (this query):" in txt_off


# -- the device observatory (tests/test_device_observatory.py :60-378) -----------


def test_no_probe_no_event_no_sync_by_default(monkeypatch):
    """Timing off: a launch is one env read, no CUDA event is made and no
    synchronization is added (`TestZeroCostOff`)."""
    import torch

    def forbidden(*a, **k):
        raise AssertionError("no CUDA call on the off path")

    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    monkeypatch.setattr(torch.cuda, "synchronize", forbidden)
    calls = {"n": 0}
    real = dv.timing_mode

    def counted():
        calls["n"] += 1
        return real()

    monkeypatch.setattr(dv, "timing_mode", counted)
    hists = {n: h["count"] for n, h in metrics.snapshot().get("histograms", {}).items()}
    for _ in range(5):
        _launch()
    assert calls["n"] == 5
    assert dv.probe_start("anything") is None and dv.device_summary() == {}
    assert {n: h["count"] for n, h in metrics.snapshot().get("histograms", {}).items()} == hists


def test_rows_identical_with_timing_tracing_and_accounting_on(tmp_path, monkeypatch):
    twin = Twin(tmp_path)
    twin.write("t", {"k": np.arange(400, dtype=np.int64), "grp": np.arange(400) % 7,
                     "v": np.arange(400, dtype=np.float64)})

    def q():
        return (twin.t.read("t").filter(twin.t.col("k") > 50).group_by("grp")
                .agg(s=("v", "sum"), n=("*", "count")).collect().rows())

    off = q()
    for env, value in (("HYPERSPACE_DEVICE_TIMING", "all"), ("HYPERSPACE_TRACING", "1"),
                       ("HYPERSPACE_ACCOUNTING", "1")):
        monkeypatch.setenv(env, value)
        assert q() == off


def test_all_mode_bills_every_launch_per_label(monkeypatch, fake_events):
    monkeypatch.setenv("HYPERSPACE_DEVICE_TIMING", "all")
    for _ in range(2):
        _launch("cuda_sort.sort_rows", 0.002)
    summ = dv.device_summary()["cuda_sort.sort_rows"]
    assert summ["calls"] == 2 and summ["device_s"] >= 0.004
    assert metrics.snapshot()["histograms"]["latency.device.cuda_sort.sort_rows"]["count"] >= 2
    assert all(ev.synced for ev in fake_events[1::2])


def test_sampled_mode_one_probe_per_interval(monkeypatch, fake_events):
    monkeypatch.setenv("HYPERSPACE_DEVICE_TIMING", "1")
    monkeypatch.setenv("HYPERSPACE_DEVICE_TIMING_INTERVAL_S", "9999")
    for _ in range(5):
        _launch("cuda_probe.range_probe")
    assert dv.device_summary()["cuda_probe.range_probe"]["calls"] == 1
    assert len(fake_events) == 2


def test_ledger_gets_device_host_split_read_at_close(monkeypatch, fake_events):
    monkeypatch.setenv("HYPERSPACE_DEVICE_TIMING", "all")
    with accounting.ledger_scope("qid-devsplit", "query:test") as led:
        _launch(seconds=0.002)
        _launch(seconds=0.002)
        assert len(led.probes) == 2 and not any(ev.synced for ev in fake_events)
    d = accounting.ledger_for("qid-devsplit").to_dict()
    assert d["device_time_s"] >= 0.004 and 0.0 <= d["host_time_s"] <= d["wall_s"]
    assert all(ev.synced for ev in fake_events[1::2])


def test_record_pad_sites_and_ratio():
    c0 = metrics.counter("pad.bytes_padded").value
    dv.record_pad("site_x", 300, 100)
    dv.record_pad("site_x", 100, 0)
    assert dv.pad_summary()["site_x"] == {"bytes_payload": 400, "bytes_padded": 100, "pad_ratio": 0.2}
    assert metrics.counter("pad.bytes_padded").value == c0 + 100


def test_the_join_records_its_bucket_pads(tmp_path):
    twin = Twin(tmp_path, buckets=4)
    rng = np.random.RandomState(2)
    twin.write("l", {"k": rng.randint(0, 40, 900).astype(np.int64), "q": np.arange(900, dtype=np.int64)})
    twin.write("r", {"k2": np.arange(40, dtype=np.int64), "w": np.arange(40, dtype=np.int64)})
    p = twin.t
    p.index("l", "padL", ["k"], ["q"])
    p.index("r", "padR", ["k2"], ["w"])
    p.on(p.s)
    with accounting.ledger_scope("qid-pad", "query:test"):
        p.read("l").join(p.read("r"), p.col("k") == p.col("k2")).collect()
    d = accounting.ledger_for("qid-pad").to_dict()
    assert d["pad_bytes_payload"] > 0 and 0 <= d["pad_ratio"] < 1
    assert "join_class" in dv.pad_summary()


def test_to_host_is_passthrough_on_the_cpu_and_counts_device_copies():
    import torch

    t = torch.arange(8)
    assert dv.to_host(t) is t
    before = dv.transfer_summary()["d2h"]["bytes"]
    dv.record_d2h(4096)
    assert dv.transfer_summary()["d2h"]["bytes"] == before + 4096
    assert "seconds" not in dv.transfer_summary()["d2h"]
    dv.record_d2h(1024, 0.001)
    assert dv.transfer_summary()["d2h"]["gb_per_s"] > 0


def test_encoded_stage_split_on_the_registry_and_the_ledger():
    from hyperspace_tpu.telemetry import device_observatory as jax_dv

    with accounting.ledger_scope("qid-enc", "query:test"):
        dv.record_encoded_stage("site_e", 4000, 1000, packed_bytes=500)
        dv.record_encoded_stage("site_e", 400, 400)
    jax_dv.reset()
    jax_dv.record_encoded_stage("site_e", 4000, 1000, packed_bytes=500)
    jax_dv.record_encoded_stage("site_e", 400, 400)
    assert dv.encoded_stage_summary() == jax_dv.encoded_stage_summary()
    assert dv.encoded_stage_summary()["site_e"] == {"bytes_flat": 4400, "bytes_staged": 1400, "count": 2,
                                                    "saved_ratio": 0.6818, "bytes_packed": 500}
    d = accounting.ledger_for("qid-enc").to_dict()
    assert (d["device_code_bytes_flat"], d["device_code_bytes_staged"], d["device_code_bytes_packed"]) == (
        4400, 1400, 500)
    jax_dv.reset()


def test_ledger_pad_ratio_and_transfer_bytes():
    with accounting.ledger_scope("qid-padratio", "query:test"):
        dv.record_pad("site_y", 300, 100)
        dv.record_d2h(64)
    d = accounting.ledger_for("qid-padratio").to_dict()
    assert (d["pad_bytes_payload"], d["pad_bytes_padded"], d["pad_ratio"], d["d2h_bytes"]) == (300, 100, 0.25, 64)


def test_device_live_bytes_sample_is_none_for_a_cpu_session(monkeypatch):
    monkeypatch.setattr(accounting, "_device_sample", [-1e18, None, None])
    assert accounting.device_live_bytes_sample("cpu") == (None, None)
    assert accounting.device_live_bytes_sample(None) == (None, None)
    with accounting.ledger_scope("qid-age", "query:test"):
        accounting.note_device("cpu")
    d = accounting.ledger_for("qid-age").to_dict()
    assert "device_live_bytes" not in d and "device_live_bytes_age_s" not in d


def test_memo_footprint_gauge_registered(tmp_path):
    twin = Twin(tmp_path, buckets=4)
    twin.write("l", {"k": np.arange(100, dtype=np.int64) % 13})
    twin.write("r", {"k2": np.arange(13, dtype=np.int64)})
    p = twin.t
    p.index("l", "gL", ["k"], [])
    p.index("r", "gR", ["k2"], [])
    p.on(p.s)
    p.read("l").join(p.read("r"), p.col("k") == p.col("k2")).collect()
    g = metrics.snapshot()["gauges"]
    assert g["memo.device_cache.bytes_peak"] >= g["memo.device_cache.bytes"] > 0


def test_stream_pool_workers_adopt_the_query_ledger(tmp_path, monkeypatch):
    """The streamed read's pool workers see the submitting query's ledger
    (`TestPoolLedgerAdoption`; the port's streamed pool is the scan's)."""
    monkeypatch.setenv("HYPERSPACE_ACCOUNTING", "1")
    monkeypatch.setenv("HYPERSPACE_QUERY_STREAMING", "1")
    twin = Twin(tmp_path)
    write_sorted(twin, "s", n=400, parts=4)
    seen = []
    real = engine_io.decode_files

    def spy(*a, **k):
        seen.append((threading.current_thread() is threading.main_thread(), accounting.current_ledger()))
        return real(*a, **k)

    monkeypatch.setattr(engine_io, "decode_files", spy)
    rows = twin.t.read("s").group_by("k").agg(total=("v", "sum")).collect().sorted_rows()
    workers = [led for main, led in seen if not main]
    assert workers and all(led is not None for led in workers)
    assert {led.query_id for led in workers} <= {led.query_id for led in accounting.recent_ledgers()}
    monkeypatch.setenv("HYPERSPACE_QUERY_STREAMING", "0")
    scan_cache.clear_scan_caches()
    assert twin.t.read("s").group_by("k").agg(total=("v", "sum")).collect().sorted_rows() == rows


# -- the kernel observatory (compile_log) -------------------------------------------


def test_launch_views_read_the_registry_and_are_read_only():
    mods = (cuda_sort, cuda_probe, cuda_comp_sort, cuda_packed_sort, cuda_packed_probe)
    assert [m.LABEL for m in mods] == [compile_log.LABELS[k] for k in ("K1", "K2", "K3", "K4", "K5")]
    compile_log.reset_launches()
    _launch(cuda_probe.LABEL)
    assert cuda_probe.launches == 1 == metrics.counter(f"kernel.launches.{cuda_probe.LABEL}").value
    assert compile_log.program_summary()[cuda_probe.LABEL]["launches"] == 1
    with pytest.raises(AttributeError):
        cuda_probe.launches = 0
    compile_log.reset_launches(cuda_probe.LABEL)
    assert cuda_probe.launches == 0


def test_a_launch_inside_a_span_is_counted_on_it(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_TRACING", "1")
    with tracing.capture() as cap:
        with tracing.query_span("query:launch"):
            with tracing.span("op:Probe"):
                _launch(cuda_probe.LABEL)
                _launch(cuda_probe.LABEL)
    assert cap.trace.find("op:Probe")[0].attrs[f"launches.{cuda_probe.LABEL}"] == 2


def test_a_raising_launch_is_not_counted():
    compile_log.reset_launches(cuda_sort.LABEL)
    with pytest.raises(RuntimeError):
        with compile_log.observed_launch(cuda_sort.LABEL):
            raise RuntimeError("launch failed")
    assert cuda_sort.launches == 0


def test_the_library_build_is_observed_and_hits_the_fault_point():
    before = compile_log.program_summary().get(compile_log.LIBRARY_LABEL, {}).get("compiles", 0)
    c0 = metrics.counter("xla.compiles.count").value
    with accounting.ledger_scope("qid-build", "build:test"):
        assert compile_log.observed_build(lambda x: x + 1, 1) == 2
    d = accounting.ledger_for("qid-build").to_dict()
    assert d["xla_compiles"] == 1 and d["xla_compile_s"] >= 0
    assert compile_log.program_summary()[compile_log.LIBRARY_LABEL]["compiles"] == before + 1
    assert metrics.counter("xla.compiles.count").value == c0 + 1
    faults.reset_counters()
    with faults.inject("device.compile", rate=1.0, limit=1):
        with pytest.raises(TransientError):
            compile_log.observed_build(lambda: None)
    assert faults.injected_count("device.compile") == 1
    faults.reset_counters()


def test_compile_timeout_kills_the_compiler(tmp_path, monkeypatch):
    """`HYPERSPACE_COMPILE_TIMEOUT_S` bounds the `nvcc` processes: a compiler
    that hangs is killed and the build raises `CompileTimeoutError`."""
    cuda = tmp_path / "cuda" / "bin"
    cuda.mkdir(parents=True)
    nvcc = cuda / "nvcc"
    nvcc.write_text("#!/bin/sh\nsleep 30\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("HYPERSPACE_COMPILE_TIMEOUT_S", "0.5")
    monkeypatch.setattr(_kernels, "_BUILD_DIR", str(tmp_path / "build"))
    before = metrics.counter("xla.compiles.deadline_exceeded").value
    t0 = time.monotonic()
    with pytest.raises(CompileTimeoutError, match="HYPERSPACE_COMPILE_TIMEOUT_S"):
        _kernels._build(str(tmp_path / "build" / "lib.so"))
    assert time.monotonic() - t0 < 10
    assert metrics.counter("xla.compiles.deadline_exceeded").value == before + 1


# -- plan fingerprints ------------------------------------------------------------


def test_fingerprint_abstracts_literals_and_tracks_posture(tmp_path, monkeypatch):
    twin = Twin(tmp_path)
    twin.write("t", {"k": np.arange(40, dtype=np.int64), "v": np.arange(40, dtype=np.int64)})
    got = []
    from hyperspace_tpu.plananalysis import fingerprint as jax_fingerprint

    for p, fp in ((twin.t, fingerprint), (twin.j, jax_fingerprint)):
        a = fp.plan_fingerprint(p.read("t").filter(p.col("k") == 7).physical_plan())
        b = fp.plan_fingerprint(p.read("t").filter(p.col("k") == 12).physical_plan())
        c = fp.plan_fingerprint(p.read("t").filter(p.col("v") == 7).physical_plan())
        monkeypatch.setenv("HYPERSPACE_QUERY_STREAMING", "0")
        d = fp.plan_fingerprint(p.read("t").filter(p.col("k") == 7).physical_plan())
        monkeypatch.delenv("HYPERSPACE_QUERY_STREAMING")
        assert a == b and a != c and a != d and len(a) == 16
        got.append((a, c, d))
    assert got[0] == got[1]
    assert fingerprint.FLAG_KEYS == jax_fingerprint.FLAG_KEYS


def test_fingerprint_is_computed_only_for_a_consumer(tmp_path, monkeypatch):
    twin = Twin(tmp_path)
    twin.write("t", {"k": np.arange(10, dtype=np.int64)})
    calls = []
    real = fingerprint.plan_fingerprint
    monkeypatch.setattr(fingerprint, "plan_fingerprint", lambda *a, **k: calls.append(1) or real(*a, **k))
    assert not fingerprint.fingerprint_wanted()
    twin.t.read("t").collect()
    assert calls == []
    monkeypatch.setenv("HYPERSPACE_ACCOUNTING", "1")
    twin.t.read("t").collect()
    assert calls and accounting.recent_ledgers()[-1].to_dict()["plan_fingerprint"] == real(
        twin.t.read("t").physical_plan())

"""The port's metrics exporter and profile capture against the JAX
package's.

Counterparts of `tests/test_observability.py` :316-402 (frames and their
schema, a clean stop with its final frame, start and stop from the env,
rows unchanged while the exporter runs, the Prometheus text) and
`tests/test_device_observatory.py` :384-437 (profile capture with the
profiler window stubbed: the manifest, the rate limit, keep-N rotation,
the overlap guard, a capture that cannot raise). Both packages run each
case on the same inputs (a seeded, key-sorted parquet file of four row
groups); their frames' ledgers, keys and Prometheus lines are held equal.
Beyond the reference: the port's real `torch.profiler` window on the CPU,
an anomaly that captures end to end, the import-time start in a fresh
process, and the SIGTERM chain. Card cases (`device_live_bytes`, a window
naming a K2 launch) are in `tests/test_torch_cuda.py`.
"""

import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest

import hyperspace_tpu_torch as hst
from hyperspace_tpu.engine import HyperspaceSession as JaxSession
from hyperspace_tpu.engine import col as jax_col
from hyperspace_tpu.telemetry import accounting as jax_accounting
from hyperspace_tpu.telemetry import device_observatory as jax_dv
from hyperspace_tpu.telemetry import exporter as jax_exporter
from hyperspace_tpu.telemetry import history as jax_history
from hyperspace_tpu.telemetry import metrics as jax_metrics
from hyperspace_tpu.telemetry import slo as jax_slo
from hyperspace_tpu_torch.engine import physical, scan_cache
from hyperspace_tpu_torch.telemetry import accounting, exporter, history, metrics, slo, tracing
from hyperspace_tpu_torch.telemetry import device_observatory as dv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = (("torch", exporter, accounting, metrics), ("jax", jax_exporter, jax_accounting, jax_metrics))
#: Frame keys the JAX package writes that the port does not on the CPU: the
#: compile cache, a live-bytes sample (the port reads one only from a CUDA
#: context) and the device rollups (a CPU session copies nothing to a
#: device). Both write `replica_id`; neither writes `slo` with no lane run.
JAX_ONLY_KEYS = {"compile_cache", "device_live_bytes", "device_live_bytes_age_s", "device"}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in (exporter.ENV_METRICS_FILE, exporter.ENV_METRICS_INTERVAL, "HYPERSPACE_ACCOUNTING",
              tracing.ENV_TRACE_FILE, dv.ENV_PROFILE_DIR, dv.ENV_PROFILE_MIN_INTERVAL_S, dv.ENV_PROFILE_KEEP,
              dv.ENV_PROFILE_WINDOW_S, dv.ENV_DEVICE_TIMING, "HYPERSPACE_HISTORY", "HYPERSPACE_HISTORY_DIR"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()
    for mod in (dv, jax_dv, slo, jax_slo):
        mod.reset()
    for acc in (accounting, jax_accounting):
        acc.reset_tenant_rollup()
    yield
    for mod in (exporter, jax_exporter):
        mod.stop()
    for mod in (history, jax_history):
        mod.reset_stores()
    for mod in (dv, jax_dv):
        mod.reset()


def _sorted_table(tmp_path, n=4000, seed=3):
    """A key-sorted file of four row groups: `k == 3` prunes three."""
    src = str(tmp_path / "t")
    t = hst.HyperspaceSession(warehouse=str(tmp_path), device="cpu")
    t.write_parquet({"k": np.arange(n, dtype=np.int64), "v": np.random.RandomState(seed).randint(0, 1000, n)},
                    src, row_group_rows=n // 4)
    return {"torch": (t, hst.col), "jax": (JaxSession(warehouse=str(tmp_path)), jax_col)}, src


def _frames(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_exporter_frames_schema_and_clean_shutdown(tmp_path, monkeypatch):
    sessions, src = _sorted_table(tmp_path)
    monkeypatch.setenv("HYPERSPACE_ACCOUNTING", "1")
    got = {}
    for name, mod, acc, _m in PKGS:
        s, col = sessions[name]
        path = str(tmp_path / f"{name}.jsonl")
        acc.drain_pending()  # earlier tests' ledgers must not ride these frames
        ex = mod.MetricsExporter(path, interval_s=0.05).start()
        try:
            assert s.read.parquet(src).filter(col("k") == 3).collect().num_rows == 1
            ex._write_frame()
        finally:
            ex.stop()
        assert not ex.running
        frames = _frames(path)
        assert len(frames) >= 2 and frames[-1]["final"] is True
        for fr in frames:
            assert {"ts", "seq", "interval_s", "snapshot"} <= set(fr) and "counters" in fr["snapshot"]
            assert isinstance(fr["ledgers"], list) and isinstance(fr["compile_programs"], dict)
        assert [fr["seq"] for fr in frames] == sorted(fr["seq"] for fr in frames)
        mine = [led for fr in frames for led in fr["ledgers"] if led.get("rows_produced") == 1]
        assert len(mine) == 1 and mine[0]["bytes_decoded"] > 0
        hists = frames[-1]["snapshot"]["histograms"]
        lat = [k for k in hists if k.startswith("latency.query.")]
        assert lat and hists[lat[0]]["p50"] is not None and hists[lat[0]]["p99"] is not None
        got[name] = (mine[0], set().union(*(set(fr) for fr in frames)))
    for f in ("rows_produced", "decode_files", "bytes_decoded", "plan_fingerprint"):
        assert got["torch"][0].get(f) == got["jax"][0].get(f), f
    assert got["torch"][1] <= got["jax"][1] and got["jax"][1] - got["torch"][1] <= JAX_ONLY_KEYS


def test_exporter_env_start_stop_roundtrip(tmp_path, monkeypatch):
    for name, mod, _acc, _m in PKGS:
        path = str(tmp_path / f"{name}.jsonl")
        monkeypatch.setenv(mod.ENV_METRICS_FILE, path)
        monkeypatch.setenv(mod.ENV_METRICS_INTERVAL, "0.05")
        assert mod.start() is True and mod.running()
        assert mod.start() is True  # a running exporter wins
        mod.stop()
        assert not mod.running()
        mod.stop()  # repeat-safe
        frames = _frames(path)
        assert frames and frames[-1]["final"] is True
        monkeypatch.delenv(mod.ENV_METRICS_FILE)
    assert exporter.start() is False  # no path anywhere
    assert exporter.running() is False and accounting.enabled() is False


def test_traced_rows_identical_with_exporter_running(tmp_path, monkeypatch):
    sessions, src = _sorted_table(tmp_path)
    t, col = sessions["torch"]
    df = t.read.parquet(src).filter(col("k") < 50)
    plain = sorted(map(tuple, df.collect().rows()))
    j, jcol = sessions["jax"]
    assert plain == sorted(map(tuple, j.read.parquet(src).filter(jcol("k") < 50).collect().rows()))
    accounting.drain_pending()
    ex = exporter.MetricsExporter(str(tmp_path / "m.jsonl"), interval_s=0.05).start()
    try:
        assert accounting.enabled() is False  # a direct exporter is not the process's
        assert exporter.start(str(tmp_path / "m2.jsonl")) and accounting.enabled()
        monkeypatch.setenv(tracing.ENV_TRACE_FILE, str(tmp_path / "tr.jsonl"))
        observed = sorted(map(tuple, df.collect().rows()))
    finally:
        ex.stop()
        exporter.stop()
    assert observed == plain
    # The two streams drain one process queue: the ledger rides one of them.
    frames = _frames(str(tmp_path / "m.jsonl")) + _frames(str(tmp_path / "m2.jsonl"))
    assert [led["rows_produced"] for fr in frames for led in fr["ledgers"]] == [len(plain)]


def test_prometheus_text_renders_counters_and_histograms():
    texts = {}
    for name, mod, _acc, m in PKGS:
        m.counter("test.prom.hits").inc(4)
        m.histogram("test.prom.lat").observe(0.02)
        text = mod.prometheus_text()
        assert "# TYPE hyperspace_test_prom_hits counter" in text
        assert "# TYPE hyperspace_test_prom_lat histogram" in text
        assert 'hyperspace_test_prom_lat_bucket{le="+Inf"}' in text
        texts[name] = [ln for ln in text.splitlines() if "test_prom" in ln]
        m.counter("test.prom.hits").reset()
        m.histogram("test.prom.lat").reset()
    assert texts["torch"] == texts["jax"]
    assert "hyperspace_test_prom_hits 4" in texts["torch"] and "hyperspace_test_prom_lat_count 1" in texts["torch"]


def test_prometheus_names_the_kernel_launch_counters():
    from hyperspace_tpu_torch.telemetry import compile_log

    for label in (compile_log.LABELS["K1"], compile_log.LABELS["K2"]):
        compile_log.launch_counter(label)
    text = exporter.prometheus_text()
    assert "# TYPE hyperspace_kernel_launches_cuda_sort_sort_rows counter" in text
    assert "# TYPE hyperspace_kernel_launches_cuda_probe_range_probe counter" in text
    assert exporter._prom_name("kernel.launches.cuda_sort.sort_rows") == jax_exporter._prom_name(
        "kernel.launches.cuda_sort.sort_rows")


def test_tenant_series_escape_labels(tmp_path):
    sessions, src = _sorted_table(tmp_path)
    t, col = sessions["torch"]
    accounting.reset_tenant_rollup()
    try:
        with accounting.tenant_scope('a"b\nc'):
            t.read.parquet(src).filter(col("k") == 3).collect()
        text = exporter.prometheus_text()
    finally:
        accounting.reset_tenant_rollup()
    assert '# TYPE hyperspace_tenant_queries counter' in text
    assert 'hyperspace_tenant_queries{tenant="a\\"b\\nc"} 1' in text


def test_live_bytes_read_only_from_an_existing_cuda_context(tmp_path, monkeypatch):
    """On the CPU the exporter never asks torch.cuda for memory: it reads a
    sample only once a CUDA context exists (faked here)."""
    import torch

    calls = []
    monkeypatch.setattr(accounting, "device_live_bytes_sample", lambda device=None: calls.append(device) or (123, 0.0))
    frame = exporter.MetricsExporter(str(tmp_path / "m.jsonl"), 1.0)._frame()
    assert "device_live_bytes" not in frame and calls == []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    frame = exporter.MetricsExporter(str(tmp_path / "m.jsonl"), 1.0)._frame()
    assert frame["device_live_bytes"] == 123 and calls == ["cuda"]


_IMPORT_CHILD = """
import os, sys
sys.path.insert(0, {repo!r})
import hyperspace_tpu_torch  # the exporter starts here
from hyperspace_tpu_torch.telemetry import exporter
assert exporter.running()
assert not any(m == "jax" or m.startswith(("jax.", "hyperspace_tpu.")) or m == "hyperspace_tpu" for m in sys.modules)
print("READY", flush=True)
if sys.argv[1] == "signal":
    sys.stdin.readline()  # SIGTERM lands here
"""


def _child(tmp_path, mode):
    env = dict(os.environ, HYPERSPACE_METRICS_FILE=str(tmp_path / f"{mode}.jsonl"),
               HYPERSPACE_METRICS_INTERVAL_S="30")
    return subprocess.Popen([sys.executable, "-c", _IMPORT_CHILD.format(repo=REPO), mode], env=env,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _ready(p, timeout=120):
    out = []
    reader = threading.Thread(target=lambda: out.append(p.stdout.readline()), daemon=True)
    reader.start()
    reader.join(timeout)
    if out != ["READY\n"]:
        p.kill()
        raise AssertionError(f"child said {out!r}: {p.stderr.read()[-2000:]}")


def test_import_starts_the_exporter_and_exit_writes_the_final_frame(tmp_path):
    p = _child(tmp_path, "exit")
    try:
        _ready(p)
        _out, err = p.communicate(timeout=120)
    finally:
        if p.poll() is None:
            p.kill()
    assert p.returncode == 0, err
    frames = _frames(str(tmp_path / "exit.jsonl"))
    assert [fr["final"] for fr in frames if "final" in fr] == [True] and frames[-1]["final"] is True


def test_sigterm_still_writes_the_final_frame(tmp_path):
    p = _child(tmp_path, "signal")
    try:
        _ready(p)
        p.send_signal(signal.SIGTERM)
        p.wait(timeout=120)
    finally:
        if p.poll() is None:
            p.kill()
    for pipe in (p.stdin, p.stdout, p.stderr):
        pipe.close()
    assert p.returncode == -signal.SIGTERM  # the death stays visible
    assert _frames(str(tmp_path / "signal.jsonl"))[-1]["final"] is True


# -- profile capture (tests/test_device_observatory.py :379-437) ----------------


@pytest.fixture()
def stub_trace(monkeypatch):
    """Both packages' profiler windows replaced by a recording stub."""
    windows = {"torch": [], "jax": []}
    for name, mod in (("torch", dv), ("jax", jax_dv)):
        def stub(cap_dir, window_s, _mod=mod, _w=windows[name]):
            _w.append(cap_dir)
            try:
                with open(os.path.join(cap_dir, "trace.json"), "w") as f:
                    json.dump({"window_s": window_s, "trace": True, "stub": True}, f)
            finally:
                _mod._trace_in_flight.clear()

        monkeypatch.setattr(mod, "_trace_window", stub)
    return windows


DVS = (("torch", dv, metrics), ("jax", jax_dv, jax_metrics))


def test_capture_disabled_without_env():
    for _name, mod, _m in DVS:
        assert mod.maybe_capture("anomaly") is None


def test_manifest_parses_and_rate_limit(tmp_path, monkeypatch, stub_trace):
    monkeypatch.setenv(dv.ENV_PROFILE_MIN_INTERVAL_S, "60")
    manifests = {}
    for name, mod, m in DVS:
        monkeypatch.setenv(dv.ENV_PROFILE_DIR, str(tmp_path / name))
        c0 = m.counter("profiler.captures_suppressed").value
        d1 = mod.maybe_capture("anomaly", {"sigma": 4.2})
        assert d1 is not None
        with open(os.path.join(d1, "capture.json")) as f:
            manifests[name] = json.load(f)
        assert mod.maybe_capture("anomaly") is None  # suppressed
        assert m.counter("profiler.captures_suppressed").value == c0 + 1
    for man in manifests.values():
        assert man["schema_version"] == 1 and man["reason"] == "anomaly" and man["detail"] == {"sigma": 4.2}
    assert set(manifests["torch"]) == set(manifests["jax"])


def test_keep_n_rotation(tmp_path, monkeypatch, stub_trace):
    monkeypatch.setenv(dv.ENV_PROFILE_MIN_INTERVAL_S, "0")
    monkeypatch.setenv(dv.ENV_PROFILE_KEEP, "2")
    listings = {}
    for name, mod, _m in DVS:
        monkeypatch.setenv(dv.ENV_PROFILE_DIR, str(tmp_path / name))
        for i in range(4):
            assert mod.maybe_capture("slo_fast_burn", {"i": i}) is not None
        listings[name] = sorted(os.listdir(str(tmp_path / name)))
        with open(str(tmp_path / name / "capture" / "capture.json")) as f:
            assert json.load(f)["detail"] == {"i": 3}
    assert listings["torch"] == listings["jax"] == ["capture", "capture.1", "capture.2"]


def test_overlap_guard_skips_trace_not_manifest(tmp_path, monkeypatch, stub_trace):
    monkeypatch.setenv(dv.ENV_PROFILE_MIN_INTERVAL_S, "0")
    for name, mod, _m in DVS:
        monkeypatch.setenv(dv.ENV_PROFILE_DIR, str(tmp_path / name))
        mod._trace_in_flight.set()  # a window is running
        try:
            d1 = mod.maybe_capture("anomaly")
            assert d1 is not None
            with open(os.path.join(d1, "trace.json")) as f:
                t = json.load(f)
            assert t["trace"] is False and "in flight" in t["error"]
            assert stub_trace[name] == []
        finally:
            mod._trace_in_flight.clear()
        d2 = mod.maybe_capture("anomaly")
        assert stub_trace[name] == [d2]


def test_anomaly_hook_never_raises(monkeypatch):
    monkeypatch.setenv(dv.ENV_PROFILE_DIR, "/dev/null/not-a-dir")
    monkeypatch.setenv(dv.ENV_PROFILE_MIN_INTERVAL_S, "0")
    for _name, mod, _m in DVS:
        assert mod.maybe_capture("anomaly") is None


def test_a_real_cpu_profiler_window_lands_a_chrome_trace(tmp_path, monkeypatch):
    """The port's window is a `torch.profiler` session: CPU only here (no
    CUDA context), its Chrome trace beside its status."""
    monkeypatch.setenv(dv.ENV_PROFILE_DIR, str(tmp_path / "prof"))
    monkeypatch.setenv(dv.ENV_PROFILE_WINDOW_S, "0.2")
    monkeypatch.setenv(dv.ENV_PROFILE_MIN_INTERVAL_S, "0")
    cap = dv.maybe_capture("anomaly", {"why": "test"})
    assert cap is not None and os.path.exists(os.path.join(cap, "capture.json"))
    dv._trace_thread[0].join(timeout=60)
    assert not dv._trace_thread[0].is_alive()
    with open(os.path.join(cap, "trace.json")) as f:
        status = json.load(f)
    assert status["trace"] is True and status["activities"] == ["CPU"] and "error" not in status
    assert dv._trace_started.is_set() and status["started_after_s"] >= 0
    with open(os.path.join(cap, status["chrome_trace"])) as f:
        assert "traceEvents" in json.load(f)
    assert not dv._trace_in_flight.is_set()


def test_an_anomalous_query_captures_and_names_itself(tmp_path, monkeypatch, stub_trace):
    """End to end on the CPU: the history store's Nσ verdict asks for a
    capture; its manifest names the query and the frame names the anomaly."""
    monkeypatch.setenv("HYPERSPACE_HISTORY", "1")
    monkeypatch.setenv("HYPERSPACE_HISTORY_DIR", str(tmp_path / "hist"))
    monkeypatch.setenv(dv.ENV_PROFILE_DIR, str(tmp_path / "prof"))
    monkeypatch.setenv(dv.ENV_PROFILE_MIN_INTERVAL_S, "0")
    captures0 = metrics.counter("profiler.captures").value
    for i in range(10):
        history.land({"query_id": f"q{i}", "name": "query:collect", "wall_s": 0.02, "plan_fingerprint": "fp-c"})
    with pytest.warns(RuntimeWarning):
        verdict = history.land({"query_id": "slow", "name": "query:collect", "wall_s": 1.0,
                                "plan_fingerprint": "fp-c"})
    assert verdict["query_id"] == "slow" and metrics.counter("profiler.captures").value == captures0 + 1
    with open(str(tmp_path / "prof" / "capture" / "capture.json")) as f:
        man = json.load(f)
    assert man["reason"] == "anomaly" and man["detail"]["query_id"] == "slow"
    assert len(stub_trace["torch"]) == 1
    frame = exporter.MetricsExporter(str(tmp_path / "m.jsonl"), 1.0)._frame()
    assert frame["history"]["anomalies"][0]["query_id"] == "slow"

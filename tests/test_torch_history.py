"""The port's workload history store and sink rotation against the JAX
package's.

Counterparts of `tests/test_history.py`: `TestHistoryStore` (:166),
`TestAnomalies` (:467), `TestConcurrentAppends` (:550), `TestZeroCostOff`
(:629) and `TestSinkRotation` (:673). A store case feeds both packages'
stores the same ledgers (walls drawn from a seeded `numpy` generator) and
holds the port's folds, verdicts and counters to the JAX package's; a
query case runs both packages over the same parquet files, each into its
own directory, and holds the deterministic ledger fields (`rows_produced`,
`decode_files`, `bytes_decoded`) and the fingerprints equal. Cross-reading:
each package's readers fold the other's directory to the same baselines,
and `tools/hsreport.py` renders a directory the port wrote.

The two-process case is steadied: its children open their stores, report,
and wait for the parent's go on stdin, so all three writers are alive while
any writes (no writer's segment is compacted before the count); every
child is joined under a timeout. Its SIGKILL twin kills a child that has
flushed a torn line and waits on stdin: no sleep decides an outcome.
"""

import glob
import importlib.util
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import pytest

import hyperspace_tpu_torch as hst
from hyperspace_tpu.engine import HyperspaceSession as JaxSession
from hyperspace_tpu.engine import col as jax_col
from hyperspace_tpu.plananalysis import planner as jax_planner
from hyperspace_tpu.telemetry import history as jax_history
from hyperspace_tpu.telemetry import metrics as jax_metrics
from hyperspace_tpu_torch.engine import physical, scan_cache
from hyperspace_tpu_torch.plananalysis import fingerprint, planner
from hyperspace_tpu_torch.telemetry import accounting, exporter, history, metrics, rotation, tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = (("torch", history, metrics), ("jax", jax_history, jax_metrics))
DETERMINISTIC = ("rows_produced", "decode_files", "bytes_decoded")
ENVS = (history.ENV_HISTORY, history.ENV_HISTORY_DIR, history.ENV_SEGMENT_MB, history.ENV_TTL_S,
        history.ENV_ANOMALY_SIGMA, "HYPERSPACE_ACCOUNTING", tracing.ENV_TRACE_FILE, tracing.ENV_TRACING,
        "HYPERSPACE_TIMELINE_DIR", "HYPERSPACE_PLANNER_DIR", "HYPERSPACE_PROFILE_DIR", exporter.ENV_METRICS_FILE,
        rotation.ENV_TRACE_MAX_MB, rotation.ENV_METRICS_MAX_MB, rotation.ENV_SINK_KEEP)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in ENVS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    for mod in (history, jax_history):
        mod.reset_stores()
    planner.reset()
    jax_planner.reset()
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()
    yield
    for mod in (history, jax_history):
        mod.reset_stores()
    planner.reset()
    jax_planner.reset()


def _walls(seed: int, n: int, mean: float = 0.02, jitter: float = 0.002) -> list:
    return [round(float(w), 6) for w in mean + jitter * np.random.RandomState(seed).rand(n)]


def _ledger(wall=0.02, qid="q", name="query:collect", **fields):
    d = {"query_id": qid, "name": name, "wall_s": wall, "rows_produced": 10}
    d.update(fields)
    return d


def _record(fp, ledger):
    return {"schema_version": 1, "kind": "ledger", "ts": 1.0, "fingerprint": fp, "ledger": ledger}


def _write_segment(path, fp, walls, prefix="d"):
    with open(path, "w") as f:
        for i, w in enumerate(walls):
            f.write(json.dumps(_record(fp, _ledger(wall=w, qid=f"{prefix}{i}"))) + "\n")


def _dead_segment(hd):
    """A segment of a provably dead writer on this host (a pid above any
    default pid_max)."""
    return os.path.join(hd, f"seg-{socket.gethostname()}-4199303-deadbeef.jsonl")


def _jsonl(path) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def _folded(mod, hd) -> dict:
    return {fp: bl.summary() for fp, bl in mod.fold_baselines(mod.iter_records(hd)).items()}


# -- TestHistoryStore ------------------------------------------------------------


def _lake(tmp_path, seed=7, n=400):
    rng = np.random.RandomState(seed)
    src = str(tmp_path / "t")
    t = hst.HyperspaceSession(warehouse=str(tmp_path), device="cpu")
    t.write_parquet({"k": np.arange(n, dtype=np.int64), "grp": rng.randint(0, 5, n).astype(np.int64),
                     "v": rng.rand(n)}, src)
    return t, JaxSession(warehouse=str(tmp_path)), src


def _queries(s, col, src):
    df = s.read.parquet(src)
    return [df.filter(col("k") == 3), df.group_by("grp").agg(x=("v", "sum"))]


def _run_history(tmp_path, monkeypatch, runs=3):
    """Both packages run the same queries `runs` times, each into its own
    history directory; {package: (dir, rows per query)}."""
    t, j, src = _lake(tmp_path)
    out = {}
    for name, s, col in (("torch", t, hst.col), ("jax", j, jax_col)):
        hd = str(tmp_path / f"hist-{name}")
        monkeypatch.setenv(history.ENV_HISTORY, "1")
        monkeypatch.setenv(history.ENV_HISTORY_DIR, hd)
        rows = []
        for _ in range(runs):
            rows.append([sorted(map(tuple, q.collect().rows())) for q in _queries(s, col, src)])
        monkeypatch.delenv(history.ENV_HISTORY)
        out[name] = (hd, rows)
    history.reset_stores()
    jax_history.reset_stores()
    return out


def test_query_ledgers_land_in_segments(tmp_path, monkeypatch):
    runs = _run_history(tmp_path, monkeypatch)
    assert runs["torch"][1] == runs["jax"][1]
    by_pkg = {}
    for name, (hd, _rows) in runs.items():
        segs = glob.glob(os.path.join(hd, "seg-*.jsonl"))
        assert len(segs) == 1  # one writer, one owned segment
        recs = _jsonl(segs[0])
        assert len(recs) == 6 and len({r["fingerprint"] for r in recs}) == 2
        for r in recs:
            assert r["schema_version"] == history.SCHEMA_VERSION and r["kind"] == "ledger"
            assert r["ledger"]["wall_s"] > 0 and r["ledger"]["plan_fingerprint"] == r["fingerprint"]
        by_pkg[name] = [(r["fingerprint"], [r["ledger"].get(f) for f in DETERMINISTIC]) for r in recs]
    assert by_pkg["torch"] == by_pkg["jax"]
    assert metrics.counter("history.records").value >= 6


def test_baselines_survive_restart(tmp_path):
    walls = _walls(1, 10, jitter=0.01)
    got = {}
    for name, mod, _m in PKGS:
        hd = str(tmp_path / name)
        st = mod.HistoryStore(hd)
        for i, w in enumerate(walls):
            st.record("fp-a", _ledger(wall=w, qid=f"q{i}"))
        st.close()
        mod.reset_stores()
        st2 = mod.HistoryStore(hd)  # what a restarted process does
        assert st2.baseline_for("fp-a").count == 10
        got[name] = st2.baselines()["fp-a"]
        st2.close()
    assert got["torch"] == got["jax"] and got["torch"]["n"] == 10
    # Each package folds the other's directory to the same baseline.
    assert _folded(jax_history, str(tmp_path / "torch")) == _folded(history, str(tmp_path / "jax"))


def test_segment_rotation_bounds_size(tmp_path, monkeypatch):
    monkeypatch.setenv(history.ENV_SEGMENT_MB, "0.000001")  # the floor: 4096 bytes
    for name, mod, m in PKGS:
        hd = str(tmp_path / name)
        r0 = m.counter("history.segments_rotated").value
        st = mod.HistoryStore(hd)
        for i in range(60):
            st.record("fp-a", _ledger(qid=f"q{i}"))
        st.close()
        segs = glob.glob(os.path.join(hd, "seg-*.jsonl"))
        assert len(segs) >= 2 and all(os.path.getsize(p) < 3 * 4096 for p in segs)
        assert len(list(mod.iter_records(hd))) == 60  # rotation loses nothing
        assert m.counter("history.segments_rotated").value > r0
    assert _folded(history, str(tmp_path / "jax"))["fp-a"]["n"] == 60


def test_compaction_folds_dead_writer_segments(tmp_path):
    walls = _walls(2, 12)
    for name, mod, _m in PKGS:
        hd = str(tmp_path / name)
        os.makedirs(hd)
        _write_segment(_dead_segment(hd), "fp-dead", walls)
        before = _folded(mod, hd)["fp-dead"]
        st = mod.HistoryStore(hd)
        assert st.compact() >= 0  # may have compacted at open already
        assert not glob.glob(os.path.join(hd, "seg-*.jsonl")) and glob.glob(os.path.join(hd, "compact-*.jsonl"))
        after = _folded(mod, hd)["fp-dead"]
        assert after["n"] == before["n"] == 12 and after["wall_p50_s"] == before["wall_p50_s"]
        assert after["wall_total_s"] == pytest.approx(before["wall_total_s"], rel=1e-6)
    # The checkpoints each package committed fold alike in either package.
    for reader in (history, jax_history):
        assert _folded(reader, str(tmp_path / "torch")) == _folded(reader, str(tmp_path / "jax"))


def test_live_writer_segments_never_claimed_even_past_ttl(tmp_path, monkeypatch):
    monkeypatch.setenv(history.ENV_TTL_S, "1")
    for name, mod, _m in PKGS:
        hd = str(tmp_path / name)
        os.makedirs(hd)
        live = os.path.join(hd, f"seg-{socket.gethostname()}-{os.getpid()}-aaaaaaaa.jsonl")
        _write_segment(live, "fp-live", [0.02])
        old = time.time() - 3600
        os.utime(live, (old, old))
        assert mod.HistoryStore(hd).compact() == 0
        assert os.path.exists(live)


def test_failed_compact_commit_releases_claims(tmp_path, monkeypatch):
    for name, mod, _m in PKGS:
        hd = str(tmp_path / name)
        os.makedirs(hd)
        dead = _dead_segment(hd)
        _write_segment(dead, "fp-d", [0.02])
        st = mod.HistoryStore(hd, load=False, compact_on_open=False)

        def boom(src, dst):
            raise OSError("disk full")

        with monkeypatch.context() as m:
            m.setattr(mod.os, "replace", boom)
            assert st.compact() == 0
        assert os.path.exists(dead)  # released, still visible
        assert len(list(mod.iter_records(hd))) == 1
        assert st.compact() == 1


def test_compactor_crash_after_commit_never_double_counts(tmp_path):
    for name, mod, _m in PKGS:
        hd = str(tmp_path / name)
        os.makedirs(hd)
        seg = _dead_segment(hd)
        _write_segment(seg, "fp-m", _walls(3, 10), prefix="m")
        backup = str(tmp_path / f"{name}-backup.jsonl")
        shutil.copy(seg, backup)
        st = mod.HistoryStore(hd, load=False, compact_on_open=False)
        assert st.compact() == 1
        assert _folded(mod, hd)["fp-m"]["n"] == 10
        # The compactor died between commit and unlink: its claim is back,
        # with a dead claimant; the manifest already counts it.
        stale = os.path.join(hd, f"{mod.CLAIMED_PREFIX}{socket.gethostname()}~4199303~{os.path.basename(seg)}")
        shutil.copy(backup, stale)
        assert _folded(mod, hd)["fp-m"]["n"] == 10
        assert st.compact() >= 1 and not os.path.exists(stale)
        assert _folded(mod, hd)["fp-m"]["n"] == 10


def test_foreign_host_claims_use_ttl_not_local_pids(tmp_path, monkeypatch):
    for name, mod, _m in PKGS:
        hd = str(tmp_path / name)
        os.makedirs(hd)
        # Claimant pid 1 lives here, but the claim is another host's.
        claim = os.path.join(hd, f"{mod.CLAIMED_PREFIX}otherhost~1~seg-otherhost-1-x.jsonl")
        _write_segment(claim, "fp-f", [0.02])
        monkeypatch.delenv(history.ENV_TTL_S, raising=False)
        assert _folded(mod, hd) == {}
        monkeypatch.setenv(history.ENV_TTL_S, "1")
        old = time.time() - 3600
        os.utime(claim, (old, old))
        assert _folded(mod, hd)["fp-f"]["n"] == 1
        assert mod.HistoryStore(hd, load=False, compact_on_open=False).compact() == 1


def test_merge_state_malformed_fields_no_raise_no_partial_merge():
    for _name, _mod, m in PKGS:
        h = m.Histogram("fc")
        h.observe(0.01)
        snap = h.summary()
        h.merge_state({"count": 1, "total": 0.1, "min": "oops", "max": 2})
        assert h.count == 2 and h.total == pytest.approx(0.11)
        h2 = m.Histogram("fc2")
        h2.observe(0.01)
        h2.merge_state({"count": 5, "total": "bad", "buckets": {"3": 5}})
        assert h2.summary() == snap
        h2.merge_state("not-a-dict")
        assert h2.summary() == snap
        h3 = m.Histogram("fc3")
        h3.merge_state({"count": 5, "total": 1.0, "buckets": {"10": 5}})
        assert h3.quantile(0.5) is not None and h3.summary()["p99"] is not None


def test_histogram_state_roundtrip_preserves_summary():
    values = (0.001 * (1 + np.random.RandomState(4).rand(200) * 200)).tolist()
    h = metrics.Histogram("rt")
    for v in values:
        h.observe(v)
    want = jax_metrics.Histogram("rt")
    for v in values:
        want.observe(v)
    assert h.dump_state() == want.dump_state()
    clone = jax_metrics.Histogram("rt2")  # the port's state in the JAX package
    clone.merge_state(json.loads(json.dumps(h.dump_state())))
    assert clone.summary() == h.summary()
    halves = metrics.Histogram("m")
    for part in (values[:100], values[100:]):
        a = metrics.Histogram("a")
        for v in part:
            a.observe(v)
        halves.merge_state(a.dump_state())
    assert halves.summary() == h.summary()


def test_torn_trailing_line_is_skipped(tmp_path):
    for name, mod, m in PKGS:
        hd = str(tmp_path / name)
        os.makedirs(hd)
        seg = os.path.join(hd, "seg-h-1-x.jsonl")
        _write_segment(seg, "fp", [0.02, 0.02])
        with open(seg, "a") as f:
            f.write('{"schema_version": 1, "kind": "led')  # killed mid-append
        torn0 = m.counter("history.torn_lines").value
        assert len(list(mod.iter_file_records(seg))) == 2
        assert m.counter("history.torn_lines").value == torn0  # a plain read counts nothing
        mod.HistoryStore(hd, compact_on_open=False).close()
        assert m.counter("history.torn_lines").value == torn0 + 1


def test_forward_compat_unknown_keys_and_kinds(tmp_path):
    for name, mod, _m in PKGS:
        hd = str(tmp_path / name)
        os.makedirs(hd)
        with open(os.path.join(hd, "seg-h-1-x.jsonl"), "w") as f:
            f.write(json.dumps({"schema_version": 99, "kind": "hologram", "fingerprint": "fp-x",
                                "novel_key": {"deep": [1, 2]}}) + "\n")
            f.write(json.dumps({"schema_version": 99, "kind": "ledger", "fingerprint": "fp-x", "future_field": True,
                                "ledger": dict(_ledger(wall=0.05), exotic=123)}) + "\n")
        folded = _folded(mod, hd)
        assert folded["fp-x"]["n"] == 1 and folded["fp-x"]["wall_total_s"] == pytest.approx(0.05)


# -- TestAnomalies ---------------------------------------------------------------


def test_nsigma_flagging_counter_and_warn_once(tmp_path):
    walls = [0.02 + 0.001 * (i % 3) for i in range(10)]
    verdicts = {}
    for name, mod, m in PKGS:
        st = mod.HistoryStore(str(tmp_path / name))
        assert all(st.record("fp-a", _ledger(wall=w)) is None for w in walls)
        n0 = m.counter("history.anomalies").value
        with pytest.warns(RuntimeWarning, match="over its baseline"):
            verdict = st.record("fp-a", _ledger(wall=1.0, qid="slow"))
        assert verdict["wall_s"] == 1.0 and verdict["baseline_n"] == 10
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # the second anomaly is silent
            assert st.record("fp-a", _ledger(wall=1.2)) is not None
        assert m.counter("history.anomalies").value == n0 + 2
        verdicts[name] = verdict
        st.close()
    assert verdicts["torch"] == verdicts["jax"]


def test_young_or_fast_classes_never_flag(tmp_path):
    for name, mod, _m in PKGS:
        st = mod.HistoryStore(str(tmp_path / name))
        for _ in range(mod.ANOMALY_MIN_SAMPLES - 1):
            st.record("fp-y", _ledger(wall=0.02))
        assert st.record("fp-y", _ledger(wall=5.0)) is None  # too young
        for _ in range(20):
            st.record("fp-z", _ledger(wall=0.0001))
        assert st.record("fp-z", _ledger(wall=0.004)) is None  # under the floor
        st.close()
    assert history.ANOMALY_MIN_SAMPLES == jax_history.ANOMALY_MIN_SAMPLES


class FakeRoot:
    def __init__(self):
        self.attrs = {}

    def set_attr(self, k, v):
        self.attrs[k] = v


def test_anomaly_rides_root_attr_and_exporter_frame(tmp_path, monkeypatch):
    monkeypatch.setenv(history.ENV_HISTORY, "1")
    frames = {}
    for name, mod, _m in PKGS:
        monkeypatch.setenv(history.ENV_HISTORY_DIR, str(tmp_path / name))
        root = FakeRoot()
        for i in range(10):
            mod.land(_ledger(wall=0.02, qid=f"q{i}", plan_fingerprint="fp-e"), root)
        assert "history_anomaly" not in root.attrs
        with pytest.warns(RuntimeWarning):
            mod.land(_ledger(wall=2.0, qid="slow", plan_fingerprint="fp-e"), root)
        assert root.attrs["history_anomaly"]["fingerprint"] == "fp-e"
        frames[name] = mod.frame_summary()
        assert frames[name]["records_written"] == 11 and frames[name]["anomalies_total"] >= 1
        assert "anomalies" not in (mod.frame_summary() or {})  # drained
    assert frames["torch"]["anomalies"] == frames["jax"]["anomalies"]
    history.land(_ledger(wall=2.5, qid="slower", plan_fingerprint="fp-e"), FakeRoot())
    frame = exporter.MetricsExporter(str(tmp_path / "m.jsonl"), 1.0)._frame()
    assert [a["query_id"] for a in frame["history"]["anomalies"]] == ["slower"]


# -- TestConcurrentAppends -------------------------------------------------------


_WRITER_CHILD = """
import os, sys
sys.path.insert(0, {repo!r})
os.environ["HYPERSPACE_HISTORY"] = "1"
os.environ["HYPERSPACE_HISTORY_DIR"] = {hd!r}
from hyperspace_tpu_torch.telemetry import history
st = history.get_store()
print("OPEN", flush=True)
sys.stdin.readline()  # the parent's go: every writer is alive by then
n = int(sys.argv[1])
for i in range(n):
    st.record("fp-proc", {{"query_id": f"{{os.getpid()}}-{{i}}", "name": "query:collect", "wall_s": 0.02,
                           "rows_produced": 1}})
if sys.argv[2] == "tear":
    with open(st._seg_path, "a") as f:
        f.write('{{"schema_version": 1, "kind": "led')
        f.flush()
    print("TORN", flush=True)
    sys.stdin.readline()  # killed here
print("WROTE", n, flush=True)
"""


def _child(hd, n, mode="done"):
    script = _WRITER_CHILD.format(repo=REPO, hd=hd)
    p = subprocess.Popen([sys.executable, "-c", script, str(n), mode], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
    return p


def _expect(p, word, timeout=120):
    """The child's next stdout line, which must start with `word`; a child
    that dies or stalls fails the test, bounded by `timeout`."""
    out = []
    reader = threading.Thread(target=lambda: out.append(p.stdout.readline()), daemon=True)
    reader.start()
    reader.join(timeout)
    if not out or not out[0].startswith(word):
        p.kill()
        raise AssertionError(f"child said {out!r}, stderr {p.stderr.read()[-2000:]}")


def test_threads_lose_nothing(tmp_path):
    for name, mod, _m in PKGS:
        st = mod.HistoryStore(str(tmp_path / name))
        n_threads, per = 8, 50
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=lambda ti=ti: [st.record("fp-t", _ledger(qid=f"t{ti}-{i}"))
                                                               for i in range(per)]) for ti in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
        finally:
            sys.setswitchinterval(old)
        assert st.records_written == n_threads * per
        st.close()
        qids = [r["ledger"]["query_id"] for r in mod.iter_records(st.dir) if r.get("kind") == "ledger"]
        assert len(qids) == len(set(qids)) == n_threads * per


def test_two_processes_one_dir_occ_consistent(tmp_path):
    hd = str(tmp_path / "hist")
    procs = [_child(hd, 40) for _ in range(2)]
    try:
        for p in procs:
            _expect(p, "OPEN")
        st = history.get_store(hd)  # this process writes concurrently too
        for p in procs:
            p.stdin.write("go\n")
            p.stdin.flush()
        for i in range(40):
            st.record("fp-proc", _ledger(qid=f"parent-{i}"))
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            assert "WROTE 40" in out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    qids = [r["ledger"]["query_id"] for r in history.iter_records(hd) if r.get("kind") == "ledger"]
    assert len(qids) == len(set(qids)) == 120
    owners = {os.path.basename(p).rsplit("-", 2)[1] for p in glob.glob(os.path.join(hd, "seg-*.jsonl"))}
    assert len(owners) == 3
    history.reset_stores()
    # Both packages fold the same finished directory to the same count.
    assert _folded(history, hd)["fp-proc"]["n"] == _folded(jax_history, hd)["fp-proc"]["n"] == 120


def test_two_packages_in_one_process_never_claim_each_others_segments(tmp_path):
    """Both packages' writers share this pid: each compactor must leave the
    other's live segment alone (the uuid and the live-pid rule)."""
    hd = str(tmp_path / "hist")
    mine, theirs = history.get_store(hd), jax_history.get_store(hd)
    for i in range(10):
        mine.record("fp-2", _ledger(qid=f"t{i}"))
        theirs.record("fp-2", _ledger(qid=f"j{i}"))
    assert mine._seg_path != theirs._seg_path
    for mod in (history, jax_history):
        assert mod.HistoryStore(hd).compact() == 0  # a new store of either package
    assert os.path.exists(mine._seg_path) and os.path.exists(theirs._seg_path)
    mine.record("fp-2", _ledger(qid="t-after"))
    theirs.record("fp-2", _ledger(qid="j-after"))
    qids = {r["ledger"]["query_id"] for r in history.iter_records(hd) if r.get("kind") == "ledger"}
    assert len(qids) == 22 and _folded(jax_history, hd)["fp-2"]["n"] == 22


def test_sigkill_mid_append_keeps_segments_parseable(tmp_path):
    hd = str(tmp_path / "hist")
    p = _child(hd, 60, "tear")
    try:
        _expect(p, "OPEN")
        p.stdin.write("go\n")
        p.stdin.flush()
        _expect(p, "TORN")
        os.kill(p.pid, signal.SIGKILL)  # a torn last line, no cleanup
        p.wait(timeout=30)
    finally:
        if p.poll() is None:
            p.kill()
        for pipe in (p.stdin, p.stdout, p.stderr):
            pipe.close()
    recs = [r for r in history.iter_records(hd) if r.get("kind") == "ledger"]
    assert len(recs) == 60  # every committed record survived
    st = history.HistoryStore(hd)  # the dead writer's segment compacts
    assert not glob.glob(os.path.join(hd, "seg-*.jsonl"))
    assert _folded(history, hd)["fp-proc"]["n"] == _folded(jax_history, hd)["fp-proc"]["n"] == 60
    st.close()


# -- TestZeroCostOff -------------------------------------------------------------


def test_no_fingerprint_no_files_when_everything_off(tmp_path, monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("plan_fingerprint computed with every sink off")

    t, j, src = _lake(tmp_path)
    want = [sorted(map(tuple, q.collect().rows())) for q in _queries(j, jax_col, src)]
    monkeypatch.setattr(fingerprint, "plan_fingerprint", boom)
    before = {led.query_id for led in accounting.recent_ledgers()}
    accounting.drain_pending()
    got = [sorted(map(tuple, q.collect().rows())) for q in _queries(t, hst.col, src)]
    assert got == want
    assert {led.query_id for led in accounting.recent_ledgers()} == before
    assert accounting.drain_pending() == []
    assert sorted(os.listdir(str(tmp_path))) == ["t"]  # no history, planner or profile directory


def test_history_flag_alone_enables_ledgers(tmp_path, monkeypatch):
    hd = str(tmp_path / "hist")
    monkeypatch.setenv(history.ENV_HISTORY, "1")
    monkeypatch.setenv(history.ENV_HISTORY_DIR, hd)
    t, _j, src = _lake(tmp_path)
    before = {led.query_id for led in accounting.recent_ledgers()}
    assert t.read.parquet(src).filter(hst.col("k") == 3).collect().num_rows == 1
    assert accounting.recent_ledgers()[-1].query_id not in before
    assert glob.glob(os.path.join(hd, "seg-*.jsonl"))


def test_default_history_dir_is_the_sessions_warehouse(tmp_path, monkeypatch):
    monkeypatch.setenv(history.ENV_HISTORY, "1")
    t, _j, src = _lake(tmp_path)
    hst.HyperspaceSession(warehouse=str(tmp_path / "wh2"), device="cpu")
    assert history.history_dir() == os.path.join(str(tmp_path / "wh2"), ".hyperspace_history")
    t.read.parquet(src).count()
    assert glob.glob(str(tmp_path / "wh2" / ".hyperspace_history" / "seg-*.jsonl"))


# -- TestSinkRotation ------------------------------------------------------------


def test_trace_file_rotates_and_every_file_parses(tmp_path, monkeypatch):
    path = str(tmp_path / "trace.jsonl")
    monkeypatch.setenv(tracing.ENV_TRACE_FILE, path)
    monkeypatch.setenv(rotation.ENV_TRACE_MAX_MB, "0.002")  # 2 kB
    t, _j, src = _lake(tmp_path)
    r0 = metrics.counter("telemetry.sink.rotations").value
    df = t.read.parquet(src)
    for _ in range(6):
        df.filter(hst.col("k") == 3).collect()
    assert metrics.counter("telemetry.sink.rotations").value > r0
    rotated = sorted(glob.glob(path + ".*"))
    assert rotated and not os.path.exists(path + ".4")  # keep 3
    for p in [path] + rotated:
        spans = _jsonl(p)
        assert spans and all("query_id" in s for s in spans)
        assert len({s["query_id"] for s in spans if s["parent_id"] is None}) >= 1


def test_metrics_rotation_keeps_final_frame(tmp_path, monkeypatch):
    path = str(tmp_path / "m.jsonl")
    monkeypatch.setenv(rotation.ENV_METRICS_MAX_MB, "0.01")  # 10 kB
    monkeypatch.setenv(rotation.ENV_SINK_KEEP, "2")
    ex = exporter.MetricsExporter(path, interval_s=0.01)
    for _ in range(40):  # frames written in this thread: no timing decides it
        ex._write_frame()
    ex.start()
    ex.stop()
    assert glob.glob(path + ".*"), "no rotation happened"
    frames = _jsonl(path)
    assert frames[-1]["final"] is True and frames[-1]["schema_version"] == exporter.SCHEMA_VERSION
    assert not os.path.exists(path + ".3")
    for p in glob.glob(path + ".*"):
        assert all(_jsonl(p))


# -- cross-reading and the tools -------------------------------------------------


def test_each_package_folds_the_others_query_history(tmp_path, monkeypatch):
    runs = _run_history(tmp_path, monkeypatch, runs=4)
    folds = {(reader, writer): _folded(mod, runs[writer][0])
             for reader, mod in (("torch", history), ("jax", jax_history)) for writer in runs}
    want = folds[("jax", "jax")]
    assert len(want) == 2 and all(b["n"] == 4 for b in want.values())
    for key, got in folds.items():
        assert set(got) == set(want), key
        for fp, b in got.items():
            assert b["n"] == want[fp]["n"], key
            assert [b.get(f) for f in DETERMINISTIC] == [want[fp].get(f) for f in DETERMINISTIC], key
    # And the record splits the tools start from agree.
    raw_t, cp_t = jax_history.split_records(jax_history.iter_records(runs["torch"][0]))
    raw_j, cp_j = history.split_records(history.iter_records(runs["jax"][0]))
    assert {fp: len(v) for fp, v in raw_t.items()} == {fp: len(v) for fp, v in raw_j.items()} and cp_t == cp_j == {}


def _tool(name):
    path = os.path.join(REPO, "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_test_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_hsreport_renders_a_port_written_directory(tmp_path, monkeypatch, capsys):
    hs = _tool("hsreport")
    hd = str(tmp_path / "seeded")
    st = history.HistoryStore(hd, compact_on_open=False)
    for i, w in enumerate(_walls(5, 12)):
        st.record("fp-tool", _ledger(wall=w, qid=f"f{i}", lane="interactive", bytes_decoded=1000, xla_compiles=2,
                                     io_retries=1))
    st.close()
    assert hs.main([hd]) == 0
    out = capsys.readouterr().out
    for section in ("top plan classes by total cost", "SLO compliance", "compile-storm hotspots",
                    "io-retry hotspots", "fp-tool"):
        assert section in out
    monkeypatch.setenv("HYPERSPACE_ACCOUNTING", "1")
    runs = _run_history(tmp_path, monkeypatch, runs=6)
    report = hs.build_report(runs["torch"][0], top=10, recent_k=2)
    assert report["fingerprints"] == 2 and report["ledger_records"] == 12
    assert report["drift"] and report["planner"]
    assert {"fingerprint", "knob", "arm", "n", "mean_wall_s", "drift_x"} <= set(report["planner"][0])
    text = hs.render(report)
    assert "expected vs actual" in text and "planner decisions" in text
    # The compare gate reads both packages' directories: pass or regression
    # by the walls of this host, never 2 (a directory it cannot read).
    assert hs.main([runs["torch"][0], "--compare", runs["jax"][0]]) in (0, 1)

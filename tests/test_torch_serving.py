"""The port's serving layer against the JAX package's (`tests/test_serving.py`
run on both packages where a leg compares them).

- Concurrent traffic through `hyperspace_tpu_torch.QueryServer` returns the
  rows, in order, of serial single-caller execution, and of the JAX
  package's `QueryServer` on the same lake (rows are exact: tolerance 0).
- `HYPERSPACE_SERVING=0` runs submissions inline: the future is resolved
  before `submit` returns and no worker exists.
- Admission: the same submission sequence gets the same classified
  rejections (`reason`, `tenant`) and the same counter deltas in both
  packages; the `serve.admit` fault point fires on the same calls under the
  same seed.
- Single flight: N identical cold scans decode each file once; a failed or
  timed-out leader neither poisons nor blocks its followers; distinct
  row-group selections never share a flight; two queries whose batches cross
  (each leads one file and follows the other's) both finish, and decode each
  file once also when one claims its second file after the other's flight
  for it has ended.
- Tenant and lane labels ride the root span, the ledger, the tenant rollup,
  the exporter frame and the Prometheus text.
- A mixed workload on 8 workers finishes (no deadlock), and under injected
  decode faults returns the clean serial rows.

A small lake: 4 parquet files of 200 rows (or an index of 4 buckets).
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import hyperspace_tpu_torch as hst
from hyperspace_tpu.engine.expr import col as jax_col
from hyperspace_tpu.engine.session import HyperspaceSession as JaxSession
from hyperspace_tpu.exceptions import AdmissionRejectedError as JaxAdmissionRejectedError
from hyperspace_tpu.serve import QueryServer as JaxQueryServer
from hyperspace_tpu.telemetry import accounting as jax_accounting
from hyperspace_tpu.telemetry import faults as jax_faults
from hyperspace_tpu.telemetry import metrics as jax_metrics
from hyperspace_tpu.telemetry import slo as jax_slo
from hyperspace_tpu_torch import resilience
from hyperspace_tpu_torch.engine import io as engine_io
from hyperspace_tpu_torch.engine import physical, scan_cache
from hyperspace_tpu_torch.engine.table import Table
from hyperspace_tpu_torch.exceptions import (
    AdmissionRejectedError,
    HyperspaceException,
    QueryTimeoutError,
    TransientError,
    is_transient,
)
from hyperspace_tpu_torch.serve import QueryServer, serving_enabled
from hyperspace_tpu_torch.serve import scheduler
from hyperspace_tpu_torch.serve import singleflight as sf
from hyperspace_tpu_torch.telemetry import accounting, exporter, faults, metrics, slo, tracing


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    for k in ("HYPERSPACE_FAULTS", "HYPERSPACE_QUERY_TIMEOUT_S", "HYPERSPACE_SERVING", "HYPERSPACE_FAULTS_SEED",
              "HYPERSPACE_TRACING", "HYPERSPACE_METRICS_FILE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HYPERSPACE_RETRY_BACKOFF_S", "0.001")
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    for f in (faults, jax_faults):
        f.clear()
        f.reset_counters()
    accounting.reset_tenant_rollup()
    slo.reset()
    yield
    for f in (faults, jax_faults):
        f.clear()
        f.reset_counters()
    # Served queries' tenants and lanes, in both packages, must not ride a
    # later test's frames.
    for acc in (accounting, jax_accounting):
        acc.reset_tenant_rollup()
        acc.drain_pending()
    for mod in (slo, jax_slo):
        mod.reset()


def _clear_caches():
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()


def _clear_jax_caches():
    from hyperspace_tpu.engine.physical import clear_device_memos
    from hyperspace_tpu.engine.scan_cache import (
        global_bucketed_cache,
        global_concat_cache,
        global_filtered_cache,
        global_scan_cache,
    )

    for c in (global_scan_cache(), global_concat_cache(), global_bucketed_cache(), global_filtered_cache()):
        c.clear()
    clear_device_memos()


def _lake(tmp_path, n_files=4, rows_per_file=200):
    """4 files of `k` (distinct) and `v` = k % 7; a port session and a JAX
    session over them."""
    src = str(tmp_path / "src")
    for i in range(n_files):
        k = np.arange(i * rows_per_file, (i + 1) * rows_per_file, dtype=np.int64)
        engine_io.write_parquet(Table.from_pydict({"k": k, "v": k % 7}, "cpu"),
                                os.path.join(src, f"part-{i:05d}.parquet"))
    return hst.HyperspaceSession(warehouse=str(tmp_path), device="cpu"), JaxSession(warehouse=str(tmp_path)), src


def _workload(s, c, src):
    return {
        "scan": lambda: s.read.parquet(src).collect(),
        "agg": lambda: s.read.parquet(src).group_by("v").agg(n=("k", "count"), m=("k", "max")).collect(),
        "point": lambda: s.read.parquet(src).filter(c("k") == 137).collect(),
    }


def _hold_reads_until_a_follower_waits(monkeypatch):
    """Make every file read wait (at most 5 s) until some flight has a
    follower, so that concurrent identical queries really overlap whatever
    the host's load."""
    real_read = engine_io._read_arrow

    def read(*args, **kwargs):
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            with sf._lock:
                if any(fl.waiters > 0 for fl in sf._flights.values()):
                    break
            time.sleep(0.001)
        return real_read(*args, **kwargs)

    monkeypatch.setattr(engine_io, "_read_arrow", read)


def _counters(reg=metrics):
    return dict(reg.snapshot()["counters"])


def _delta(before, reg=metrics):
    after = _counters(reg)
    return {k: after.get(k, 0) - before.get(k, 0) for k in set(after) | set(before)}


# ---------------------------------------------------------------------------
# The scheduler and the HYPERSPACE_SERVING=0 fallback
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["scan", "agg", "point"])
def test_concurrent_results_equal_serial_and_the_jax_server(tmp_path, name):
    s, j, src = _lake(tmp_path)
    port_q, jax_q = _workload(s, hst.col, src)[name], _workload(j, jax_col, src)[name]
    serial = port_q().rows()
    _clear_caches()
    _clear_jax_caches()
    with QueryServer(max_concurrent=4) as srv:
        futs = [srv.submit(port_q, tenant=f"t{i % 3}") for i in range(6)]
        got = [f.result(60).rows() for f in futs]
    with JaxQueryServer(max_concurrent=4) as jsrv:
        jfuts = [jsrv.submit(jax_q, tenant=f"t{i % 3}") for i in range(6)]
        jgot = [f.result(120).rows() for f in jfuts]
    assert all(rows == serial for rows in got)
    assert all(rows == serial for rows in jgot)


@pytest.mark.parametrize("how", ["inner", "agg"])
def test_served_indexed_joins_equal_serial_and_the_jax_server(tmp_path, how):
    """l (3 files, 300 rows each) joined to r (1 file) over covering indexes
    of 4 buckets on both sides: the co-bucketed join (K1/K2's plain twins
    on the CPU), alone or under a grouped aggregate."""
    from hyperspace_tpu import IndexConfig as JaxIndexConfig
    from hyperspace_tpu import IndexConstants as JaxIndexConstants
    from hyperspace_tpu.hyperspace import Hyperspace as JaxHyperspace
    from hyperspace_tpu.hyperspace import enable_hyperspace as jax_enable

    rng = np.random.RandomState(9)
    src = str(tmp_path / "src")
    for i in range(3):
        engine_io.write_parquet(Table.from_pydict({"k": rng.randint(0, 60, 300).astype(np.int64),
                                                   "q": rng.randint(0, 100, 300).astype(np.int64)}, "cpu"),
                                os.path.join(src, "l", f"part-{i:05d}.parquet"))
    engine_io.write_parquet(Table.from_pydict({"k2": np.arange(50, dtype=np.int64),
                                               "w": np.arange(50, dtype=np.int64) % 5}, "cpu"),
                            os.path.join(src, "r", "part-00000.parquet"))
    s = hst.HyperspaceSession(warehouse=str(tmp_path / "torch"), device="cpu")
    j = JaxSession(warehouse=str(tmp_path / "jax"))
    s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, 4)
    j.conf.set(JaxIndexConstants.INDEX_NUM_BUCKETS, 4)
    for sess, hs, cfg in ((s, hst.Hyperspace(s), hst.IndexConfig), (j, JaxHyperspace(j), JaxIndexConfig)):
        hs.create_index(sess.read.parquet(os.path.join(src, "l")), cfg("lIdx", ["k"], ["q"]))
        hs.create_index(sess.read.parquet(os.path.join(src, "r")), cfg("rIdx", ["k2"], ["w"]))
    hst.enable_hyperspace(s)
    jax_enable(j)

    def query(sess, c):
        df = sess.read.parquet(os.path.join(src, "l")).join(sess.read.parquet(os.path.join(src, "r")),
                                                            c("k") == c("k2"))
        return df.select("k", "q", "w") if how == "inner" else df.group_by("w").agg(n=("*", "count"), t=("q", "sum"))

    q, jq = (lambda: query(s, hst.col).collect()), (lambda: query(j, jax_col).collect())
    assert "BucketedIndexScan" in query(s, hst.col).explain_string()
    serial = q().rows()
    _clear_caches()
    _clear_jax_caches()
    with QueryServer(max_concurrent=4) as srv:
        got = [f.result(60).rows() for f in [srv.submit(q, tenant=f"t{i % 2}") for i in range(6)]]
    with JaxQueryServer(max_concurrent=4) as jsrv:
        jgot = [f.result(120).rows() for f in [jsrv.submit(jq, tenant=f"t{i % 2}") for i in range(4)]]
    assert all(rows == serial for rows in got)
    # The JAX package orders an aggregate's groups as the port does only on
    # its device path (HYPERSPACE_FORCE_DEVICE_OPS): groups compare as sets.
    assert all((rows if how == "inner" else sorted(rows)) == (serial if how == "inner" else sorted(serial))
               for rows in jgot)


def test_mixed_concurrent_results_equal_serial(tmp_path):
    s, _, src = _lake(tmp_path)
    work = _workload(s, hst.col, src)
    serial = {n: q().rows() for n, q in work.items()}
    _clear_caches()
    with QueryServer(max_concurrent=4) as srv:
        futs = [(n, srv.submit(q, tenant=f"t{i % 3}")) for i, (n, q) in enumerate(list(work.items()) * 3)]
        for n, f in futs:
            assert f.result(60).rows() == serial[n], n


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_serving_off_runs_inline(tmp_path, monkeypatch, pkg):
    s, j, src = _lake(tmp_path)
    sess, server = (s, QueryServer) if pkg == "torch" else (j, JaxQueryServer)
    on_rows = sess.read.parquet(src).collect().rows()
    monkeypatch.setenv("HYPERSPACE_SERVING", "0")
    assert not serving_enabled()
    srv = server(max_concurrent=4)
    fut = srv.submit(lambda: sess.read.parquet(src).collect(), tenant="a")
    assert fut.done() and fut.result().rows() == on_rows
    assert srv.stats()["workers"] == 0 and srv.stats()["serving_enabled"] is False
    srv.close()


def test_serving_off_takes_no_flight_and_propagates_exceptions(tmp_path, monkeypatch):
    monkeypatch.setenv("HYPERSPACE_SERVING", "0")
    s, _, src = _lake(tmp_path, n_files=2)
    _clear_caches()
    before = _counters()
    assert s.read.parquet(src).collect().num_rows == 400
    assert _delta(before).get("serve.singleflight.leaders", 0) == 0
    srv = QueryServer()

    def boom():
        raise ValueError("inline failure")

    fut = srv.submit(boom)
    assert fut.done()
    with pytest.raises(ValueError, match="inline failure"):
        fut.result()
    srv.close()


def test_run_lane_validation_and_closed_server():
    with QueryServer(max_concurrent=1) as srv:
        assert srv.run(lambda: 41 + 1) == 42
        with pytest.raises(HyperspaceException, match="lane"):
            srv.submit(lambda: 1, lane="turbo")
    with pytest.raises(HyperspaceException, match="closed"):
        srv.submit(lambda: 1)


def test_workers_spawn_lazily_and_install_the_yield_hook(monkeypatch):
    monkeypatch.setattr(resilience, "_yield_hook", None)
    srv = QueryServer(max_concurrent=3)
    assert srv.stats()["workers"] == 0 and resilience._yield_hook is None
    assert srv.run(lambda: 5, lane="interactive") == 5
    assert srv.stats()["workers"] == 3 and resilience._yield_hook is scheduler._yield_to_interactive
    names = sorted(t.name for t in srv._workers)
    assert names[0] == "hyperspace-serve-0-interactive"
    srv.close()


def test_the_first_spawn_frees_garbage_before_it_freezes_the_heap(monkeypatch):
    """The first worker spawn freezes the heap out of full collections; a
    garbage cycle alive then (a dead query's device tables, here a plain
    cycle) is collected first, not frozen for the process's life."""
    import gc
    import weakref

    class Node:
        pass

    monkeypatch.delenv("HYPERSPACE_SERVE_GC_TUNE", raising=False)
    gc.disable()
    try:
        a, b = Node(), Node()
        a.peer, b.peer = b, a
        ref = weakref.ref(a)
        del a, b
        with QueryServer(max_concurrent=2) as srv:
            assert srv.run(lambda: 1) == 1
        assert ref() is None
    finally:
        gc.enable()
        gc.unfreeze()


def test_interactive_lane_jumps_the_batch_queue():
    order = []
    started, release = threading.Event(), threading.Event()
    with QueryServer(max_concurrent=1) as srv:
        srv.submit(lambda: (started.set(), release.wait(10), order.append("b0")))
        assert started.wait(10)
        f1 = srv.submit(lambda: order.append("b1"), lane="batch")
        f2 = srv.submit(lambda: order.append("b2"), lane="batch")
        fi = srv.submit(lambda: order.append("i"), lane="interactive")
        release.set()
        for f in (f1, f2, fi):
            f.result(30)
    assert order == ["b0", "i", "b1", "b2"]


def test_the_reserved_worker_serves_interactive_while_batch_is_saturated():
    release = threading.Event()
    with QueryServer(max_concurrent=2) as srv:
        busy = srv.submit(lambda: release.wait(10) and "batch", lane="batch")
        queued = srv.submit(lambda: "queued batch", lane="batch")
        t0 = time.monotonic()
        assert srv.submit(lambda: "fast", lane="interactive").result(5) == "fast"
        assert time.monotonic() - t0 < 5 and not queued.done()
        release.set()
        assert busy.result(10) == "batch" and queued.result(10) == "queued batch"


def test_a_worker_exception_resolves_its_future_and_releases_its_token():
    with QueryServer(max_concurrent=1, tenant_budget=1) as srv:

        def boom():
            raise RuntimeError("worker failure")

        with pytest.raises(RuntimeError, match="worker failure"):
            srv.submit(boom, tenant="t").result(30)
        assert srv.run(lambda: 7, tenant="t") == 7
        assert srv.stats()["in_flight"] == 0


def test_the_facade_and_the_package_export_the_server(tmp_path):
    s, _, src = _lake(tmp_path, n_files=1)
    hs = hst.Hyperspace(s)
    with hs.server(max_concurrent=2, queue_depth=8, tenant_budget=2) as srv:
        assert isinstance(srv, hst.QueryServer) and hst.QueryServer is QueryServer
        assert srv.run(lambda: s.read.parquet(src).count()) == 200
        st = srv.stats()
        assert (st["max_concurrent"], st["queue_depth"], st["tenant_budget"]) == (2, 8, 2)


def test_the_lane_rides_the_scope_into_pool_workers():
    seen = []
    with resilience.lane_scope("batch"), resilience.query_scope("query:collect") as sc:
        assert sc.lane == "batch" and resilience.current_lane() == "batch"
        sub = engine_io.submitter()

        def worker():
            with engine_io.adopt(*sub):
                seen.append(resilience.current_lane())

        t = threading.Thread(target=worker)
        t.start()
        t.join(10)
    assert seen == ["batch"] and resilience.current_lane() is None


def test_a_batch_scope_yields_while_interactive_work_is_pending(monkeypatch):
    monkeypatch.setattr(resilience, "_yield_hook", scheduler._yield_to_interactive)
    monkeypatch.setattr(scheduler, "_interactive_pending", 1)
    with resilience.lane_scope("batch"), resilience.query_scope("query:collect"):
        t0 = time.monotonic()
        resilience.check_deadline("test")
        paused = time.monotonic() - t0
        # A leader someone waits on never pauses (priority inversion).
        led, _ = sf.claim([("test", "yield")])
        fl = led[("test", "yield")]
        fl.waiters = 1
        t1 = time.monotonic()
        resilience.check_deadline("test")
        leading = time.monotonic() - t1
        sf.finish(led, ())
    with resilience.lane_scope("interactive"), resilience.query_scope("query:collect"):
        t2 = time.monotonic()
        resilience.check_deadline("test")
        interactive = time.monotonic() - t2
    assert paused >= scheduler._YIELD_MAX_S * 0.9
    assert leading < scheduler._YIELD_MAX_S / 2 and interactive < scheduler._YIELD_MAX_S / 2


def test_a_pool_worker_of_a_leader_someone_waits_on_never_pauses(monkeypatch):
    """The port claims a batch's file flights on the query's thread and reads
    the files on pool workers: a worker adopting its submitter's flights
    does not pause while an interactive query waits on them (that would be
    priority inversion); a worker of a submitter with no follower pauses."""
    monkeypatch.setattr(resilience, "_yield_hook", scheduler._yield_to_interactive)
    monkeypatch.setattr(scheduler, "_interactive_pending", 1)
    paused = {}

    def worker(tag, sub):
        with engine_io.adopt(*sub):
            t0 = time.monotonic()
            resilience.check_deadline("test")
            paused[tag] = time.monotonic() - t0

    with resilience.lane_scope("batch"), resilience.query_scope("query:collect"):
        led, _ = sf.claim([("test", "pool-lead")])
        led[("test", "pool-lead")].waiters = 1
        for tag in ("leader", "plain"):
            sub = engine_io.submitter()
            if tag == "plain":
                sub = sub[:3] + (None,)
            t = threading.Thread(target=worker, args=(tag, sub))
            t.start()
            t.join(10)
        sf.finish(led, ())
    assert paused["leader"] < scheduler._YIELD_MAX_S / 2
    assert paused["plain"] >= scheduler._YIELD_MAX_S * 0.9


def test_four_threads_meeting_a_new_dictionary_hash_it_once(monkeypatch):
    """Concurrent queries share the dictionary-hash memo: one blake2b pass,
    one tensor for all, equal to a lone hash (the card's twin is in
    `tests/test_torch_cuda.py`)."""
    from hyperspace_tpu_torch.ops import hashing

    calls = []
    real = hashing._hash_strings

    def slow_hash(d, seed):
        calls.append(seed)
        time.sleep(0.05)  # wide enough for every thread to miss at once
        return real(d, seed)

    monkeypatch.setattr(hashing, "_hash_strings", slow_hash)
    dictionary = np.array([f"name-{i}" for i in range(300)])
    start, out = threading.Barrier(4), []

    def first_use():
        start.wait(10)
        out.append(hashing.host_hash_dictionary(dictionary, 11))

    threads = [threading.Thread(target=first_use) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert len(out) == 4 and calls == [11] and all(h is out[0] for h in out)
    assert torch.equal(out[0], real(dictionary, 11))


# ---------------------------------------------------------------------------
# Admission against the JAX package
# ---------------------------------------------------------------------------


ADMISSION_COUNTERS = ("serve.admitted", "serve.rejected.queue_depth", "serve.rejected.tenant_budget")


def _admission_sequence(server_cls, exc, reg):
    """Hold 2 queries (tenants a, a) in a server of 1 worker, queue depth 3
    and tenant budget 2, then submit a, b, b, c: the classes of each."""
    before = _counters(reg)
    release, started = threading.Event(), threading.Event()
    outcomes = []
    with server_cls(max_concurrent=1, queue_depth=3, tenant_budget=2) as srv:
        held = [srv.submit(lambda: (started.set(), release.wait(10), 1)[2], tenant="a")]
        assert started.wait(10)
        held.append(srv.submit(lambda: 2, tenant="a"))
        for tenant in ("a", "b", "b", "c"):
            try:
                held.append(srv.submit(lambda: 3, tenant=tenant))
                outcomes.append(("admitted", tenant))
            except exc as e:
                outcomes.append((e.reason, e.tenant))
        release.set()
        results = [f.result(30) for f in held]
    return outcomes, results, {k: _delta(before, reg).get(k, 0) for k in ADMISSION_COUNTERS}


def test_admission_classes_and_counters_equal_the_jax_package():
    got = _admission_sequence(QueryServer, AdmissionRejectedError, metrics)
    want = _admission_sequence(JaxQueryServer, JaxAdmissionRejectedError, jax_metrics)
    assert got == want
    assert got[0] == [("tenant_budget", "a"), ("admitted", "b"), ("queue_depth", "b"), ("queue_depth", "c")]


def test_a_rejection_is_permanent_and_other_tenants_flow():
    release, started = threading.Event(), threading.Event()
    with QueryServer(max_concurrent=1, tenant_budget=1) as srv:
        f1 = srv.submit(lambda: (started.set(), release.wait(10), 1)[2], tenant="hog")
        assert started.wait(10)
        with pytest.raises(AdmissionRejectedError) as ei:
            srv.submit(lambda: 2, tenant="hog")
        assert ei.value.reason == "tenant_budget" and not is_transient(ei.value)
        f2 = srv.submit(lambda: 42, tenant="quiet")
        release.set()
        assert f1.result(30) == 1 and f2.result(30) == 42


@pytest.mark.parametrize("seed", ["0", "5"])
def test_the_serve_admit_fault_point_fires_on_the_jax_packages_calls(monkeypatch, seed):
    monkeypatch.setenv("HYPERSPACE_FAULTS_SEED", seed)
    fired = {}
    for name, server_cls, mod in (("torch", QueryServer, faults), ("jax", JaxQueryServer, jax_faults)):
        mod.reset_counters()
        decisions = []
        with server_cls(max_concurrent=1) as srv:
            with mod.inject("serve.admit", rate=0.4, kind="transient"):
                for i in range(24):
                    try:
                        srv.submit(lambda: 1, tenant="a").result(10)
                        decisions.append(".")
                    except Exception as e:
                        assert "serve.admit" in str(e) and type(e).__name__ == "TransientError"
                        decisions.append("X")
        fired[name] = ("".join(decisions), mod.call_count("serve.admit"), mod.injected_count("serve.admit"))
    assert fired["torch"] == fired["jax"]
    assert "X" in fired["torch"][0] and "." in fired["torch"][0]


# ---------------------------------------------------------------------------
# Single flight
# ---------------------------------------------------------------------------


def test_two_identical_cold_scans_decode_once(tmp_path, monkeypatch):
    s, _, src = _lake(tmp_path)
    _clear_caches()
    _hold_reads_until_a_follower_waits(monkeypatch)
    before = _counters()
    barrier = threading.Barrier(2)

    def scan():
        barrier.wait(10)
        return s.read.parquet(src).collect()

    with QueryServer(max_concurrent=3) as srv:
        f1, f2 = srv.submit(scan, tenant="a"), srv.submit(scan, tenant="b")
        r1, r2 = f1.result(60), f2.result(60)
    assert r1.rows() == r2.rows()
    d = _delta(before)
    assert d.get("io.decode.files", 0) == 4, d
    assert d.get("serve.singleflight.dedup_hits", 0) == 1, d
    assert d.get("cache.scan.misses", 0) == 4, d
    assert d.get("cache.concat.misses", 0) == 2 and d.get("cache.concat.hits", 0) == 1, d


def test_eight_identical_cold_scans_stress_decode_once_a_round(tmp_path):
    s, _, src = _lake(tmp_path)
    expected = s.read.parquet(src).collect().rows()
    for round_i in range(3):
        _clear_caches()
        before = _counters()
        barrier = threading.Barrier(8)
        out, errs = [], []

        def scan():
            try:
                barrier.wait(10)
                out.append(s.read.parquet(src).collect().rows())
            except BaseException as e:  # pragma: no cover - diagnostic
                errs.append(e)

        threads = [threading.Thread(target=scan) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not errs and len(out) == 8 and all(rows == expected for rows in out)
        d = _delta(before)
        assert d.get("io.decode.files", 0) == 4 and d.get("cache.scan.misses", 0) == 4, (round_i, d)


def test_a_footer_is_parsed_once_under_concurrency(tmp_path):
    _lake(tmp_path, n_files=1)
    path = str(tmp_path / "src" / "part-00000.parquet")
    _clear_caches()
    barrier = threading.Barrier(4)
    out = []

    def probe():
        barrier.wait(10)
        out.append(engine_io.footer_metadata(path))

    with faults.inject("io.footer", rate=0.0):
        threads = [threading.Thread(target=probe) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
    assert len(out) == 4 and all(m is not None and m.num_rows == 200 for m in out)
    assert faults.call_count("io.footer") == 1


def test_a_failed_leader_does_not_poison_its_followers():
    key = ("test", "leader-fail")
    leader_started, release = threading.Event(), threading.Event()
    cached, errors, results = {}, [], []

    def boom():
        raise TransientError("leader died")

    def leader():
        try:
            sf.shared(key, lambda: (leader_started.set(), release.wait(10), boom())[-1], lambda: cached.get("v"))
        except TransientError as e:
            errors.append(e)

    def follower():
        def attempt():
            cached["v"] = 42
            return 42

        results.append(sf.shared(key, attempt, lambda: cached.get("v")))

    t1 = threading.Thread(target=leader)
    t1.start()
    assert leader_started.wait(10)
    t2 = threading.Thread(target=follower)
    t2.start()
    time.sleep(0.1)  # the follower parks on the flight
    release.set()
    t1.join(10), t2.join(10)
    assert len(errors) == 1 and results == [42] and sf.in_flight_count() == 0


def test_a_timed_out_leader_unblocks_its_followers():
    key = ("test", "leader-timeout")
    leader_started, release = threading.Event(), threading.Event()
    errors, results = [], []

    def leader():
        def attempt():
            leader_started.set()
            release.wait(10)
            raise QueryTimeoutError("leader deadline", 0.1, 0.1)

        try:
            sf.shared(key, attempt, lambda: None)
        except QueryTimeoutError as e:
            errors.append(e)

    t1 = threading.Thread(target=leader)
    t1.start()
    assert leader_started.wait(10)
    t2 = threading.Thread(target=lambda: results.append(sf.shared(key, lambda: "recovered", lambda: None)))
    t2.start()
    release.set()
    t1.join(10), t2.join(10)
    assert len(errors) == 1 and results == ["recovered"]


def test_a_followers_wait_is_bounded_by_its_own_deadline(monkeypatch):
    key = ("test", "hung-leader")
    leader_started, release = threading.Event(), threading.Event()
    follower_err = []

    def follower():
        try:
            with resilience.query_scope("query:test"):
                sf.shared(key, lambda: 2, lambda: None)
        except QueryTimeoutError as e:
            follower_err.append(e)

    t1 = threading.Thread(target=lambda: sf.shared(key, lambda: (leader_started.set(), release.wait(30), 1)[2]))
    t1.start()
    assert leader_started.wait(10)
    monkeypatch.setenv("HYPERSPACE_QUERY_TIMEOUT_S", "0.3")
    t2 = threading.Thread(target=follower)
    t2.start()
    t2.join(10)
    assert follower_err, "the follower did not honor its deadline"
    release.set()
    t1.join(10)


def _rg_file(tmp_path):
    path = str(tmp_path / "rg" / "part-00000.parquet")
    engine_io.write_parquet(Table.from_pydict({"k": np.arange(400, dtype=np.int64)}, "cpu"), path, row_group_rows=100)
    meta = engine_io.footer_metadata(path)
    assert meta is not None and meta.num_row_groups == 4
    return path, meta


def test_selection_keys_never_alias(tmp_path, monkeypatch):
    path, meta = _rg_file(tmp_path)
    _clear_caches()
    meta = engine_io.footer_metadata(path)
    results = {}

    def read(sel, tag):
        barrier.wait(10)
        results[tag] = engine_io.decode_files([(path, ["k"], meta, sel)], "cpu")[0]

    barrier = threading.Barrier(2)
    before = _counters()
    t1, t2 = threading.Thread(target=read, args=((0,), "a")), threading.Thread(target=read, args=((1,), "b"))
    t1.start(), t2.start(), t1.join(10), t2.join(10)
    assert results["a"].num_rows == results["b"].num_rows == 100
    assert results["a"].rows()[0] == (0,) and results["b"].rows()[0] == (100,)
    d = _delta(before)
    assert d.get("io.decode.files", 0) == 2 and d.get("serve.singleflight.dedup_hits", 0) == 0, d

    # The same selection twice, overlapping for sure.
    _hold_reads_until_a_follower_waits(monkeypatch)
    barrier = threading.Barrier(2)
    before = _counters()
    t3, t4 = threading.Thread(target=read, args=((2, 3), "c")), threading.Thread(target=read, args=((2, 3), "d"))
    t3.start(), t4.start(), t3.join(10), t4.join(10)
    assert results["c"].rows() == results["d"].rows() and results["c"].num_rows == 200
    d = _delta(before)
    assert d.get("io.decode.files", 0) == 1 and d.get("serve.singleflight.dedup_hits", 0) == 1, d


def test_crossed_batches_both_finish_and_decode_each_file_once(tmp_path, monkeypatch):
    """Query A's batch is [f0, f1], query B's [f1, f0]; each takes its first
    file's flight, then both meet, then each finds its second file's flight
    taken: each leads one file and follows the other's. Both finish."""
    _, _, src = _lake(tmp_path, n_files=2)
    files = [os.path.join(src, f"part-{i:05d}.parquet") for i in range(2)]
    _clear_caches()
    real_claim = sf.claim
    meet = threading.Barrier(2)

    def claim_in_list_order(keys):
        keys = list(keys)
        led, followed = {}, {}
        for i, k in enumerate(keys):
            lk, fk = real_claim([k])
            led.update(lk)
            followed.update(fk)
            if i == 0 and len(keys) == 2:
                meet.wait(10)
        return led, followed

    monkeypatch.setattr(sf, "claim", claim_in_list_order)
    before = _counters()
    out, errs = {}, []

    def query(tag, order):
        try:
            out[tag] = engine_io.decode_files([(f, ["k", "v"], None, None) for f in order], "cpu")
        except BaseException as e:  # pragma: no cover - diagnostic
            errs.append(e)

    ta = threading.Thread(target=query, args=("a", files))
    tb = threading.Thread(target=query, args=("b", files[::-1]))
    ta.start(), tb.start()
    ta.join(20), tb.join(20)
    assert not ta.is_alive() and not tb.is_alive(), "crossed batches deadlocked"
    assert not errs
    assert [t.rows() for t in out["a"]] == [t.rows() for t in out["b"][::-1]]
    assert out["a"][0].rows()[0] == (0, 0) and out["a"][1].rows()[0] == (200, 4)
    d = _delta(before)
    assert d.get("io.decode.files", 0) == 2 and d.get("serve.singleflight.dedup_hits", 0) == 2, d
    assert sf.in_flight_count() == 0


def test_a_late_claim_takes_what_a_finished_leader_cached(tmp_path, monkeypatch):
    """The crossed batches of the test above, with query A held between its
    two claims until query B has decoded f1 and ended its flight: A then
    leads f1 but finds it cached, so each file still decodes once and each
    query takes one file from the other's work."""
    _, _, src = _lake(tmp_path, n_files=2)
    files = [os.path.join(src, f"part-{i:05d}.parquet") for i in range(2)]
    _clear_caches()
    real_claim, real_finish = sf.claim, sf.finish
    a_holds_f0, b_ended_f1 = threading.Event(), threading.Event()

    def claim(keys):
        keys = list(keys)
        me = threading.current_thread().name
        if me == "a" and len(keys) == 2:
            led, followed = real_claim(keys[:1])
            a_holds_f0.set()
            assert b_ended_f1.wait(20)
            led1, followed1 = real_claim(keys[1:])
            return {**led, **led1}, {**followed, **followed1}
        if me == "b" and len(keys) == 2:
            assert a_holds_f0.wait(20)
        return real_claim(keys)

    def finish(led, ok):
        real_finish(led, ok)
        if threading.current_thread().name == "b" and any(k[0] == "file" and k[1] == files[1] for k in led):
            b_ended_f1.set()

    monkeypatch.setattr(sf, "claim", claim)
    monkeypatch.setattr(sf, "finish", finish)
    before = _counters()
    out, errs = {}, []

    def query(tag, order):
        try:
            out[tag] = engine_io.decode_files([(f, ["k", "v"], None, None) for f in order], "cpu")
        except BaseException as e:  # pragma: no cover - diagnostic
            errs.append(e)

    ta = threading.Thread(target=query, args=("a", files), name="a")
    tb = threading.Thread(target=query, args=("b", files[::-1]), name="b")
    ta.start(), tb.start()
    ta.join(30), tb.join(30)
    assert not ta.is_alive() and not tb.is_alive() and not errs, errs
    assert b_ended_f1.is_set()
    assert [t.rows() for t in out["a"]] == [t.rows() for t in out["b"][::-1]]
    d = _delta(before)
    assert d.get("io.decode.files", 0) == 2 and d.get("serve.singleflight.dedup_hits", 0) == 2, d
    assert sf.in_flight_count() == 0


def test_bucketed_concats_are_assembled_once_for_competing_indexed_queries(tmp_path):
    s, _, src = _lake(tmp_path, n_files=2)
    s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, 4)
    hs = hst.Hyperspace(s)
    hs.create_index(s.read.parquet(src), hst.IndexConfig("srvIdx", ["v"], ["k"]))
    hst.enable_hyperspace(s)
    q = lambda: s.read.parquet(src).filter(hst.col("v") == 3).collect()
    expected = q().sorted_rows()
    _clear_caches()
    before = _counters()
    barrier = threading.Barrier(4)
    out, errs = [], []

    def run():
        try:
            barrier.wait(10)
            out.append(q().sorted_rows())
        except BaseException as e:  # pragma: no cover - diagnostic
            errs.append(e)

    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errs and len(out) == 4 and all(rows == expected for rows in out)
    d = _delta(before)
    assert d.get("serve.singleflight.leaders", 0) >= 1 and d.get("io.decode.files", 0) == 1, d


# ---------------------------------------------------------------------------
# Tenant and lane labels end to end
# ---------------------------------------------------------------------------


def test_tenant_and_lane_ride_span_ledger_rollup_frame_and_prometheus(tmp_path, monkeypatch):
    from hyperspace_tpu.telemetry import tracing as jax_tracing

    monkeypatch.setenv("HYPERSPACE_TRACING", "1")
    s, j, src = _lake(tmp_path, n_files=2)
    path = str(tmp_path / "frames.jsonl")
    accounting.drain_pending()
    exp = exporter.MetricsExporter(path, 60.0).start()
    try:
        with QueryServer(max_concurrent=2) as srv:
            srv.submit(lambda: s.read.parquet(src).collect(), tenant="alice", lane="interactive").result(60)
        with JaxQueryServer(max_concurrent=2) as jsrv:
            jsrv.submit(lambda: j.read.parquet(src).collect(), tenant="alice", lane="interactive").result(120)
    finally:
        exp.stop()
    root = tracing.last_trace().root
    assert root.attrs.get("tenant") == jax_tracing.last_trace().root.attrs.get("tenant") == "alice"
    led = root.attrs["ledger"]
    jled = jax_tracing.last_trace().root.attrs["ledger"]
    assert (led["tenant"], led["lane"]) == (jled["tenant"], jled["lane"]) == ("alice", "interactive")
    assert accounting.tenant_rollup()["alice"]["queries"] == 1
    assert accounting.tenant_rollup()["alice"]["rows_produced"] == 400
    assert jax_accounting.tenant_rollup()["alice"]["rows_produced"] == 400
    frames = [json.loads(line) for line in open(path)]
    last = frames[-1]
    assert last["final"] is True and last["tenants"]["alice"]["queries"] == 1
    assert last["slo"]["interactive"]["tenants"]["alice"]["total"] == 1
    assert [(x["tenant"], x["lane"]) for fr in frames for x in fr["ledgers"]] == [("alice", "interactive")]
    text = exporter.prometheus_text()
    assert 'hyperspace_tenant_queries{tenant="alice"} 1' in text
    assert 'hyperspace_slo_total{lane="interactive"} 1' in text


def test_a_tenant_label_alone_opens_a_ledger_and_unlabeled_queries_stay_out(tmp_path):
    s, _, src = _lake(tmp_path, n_files=1)
    s.read.parquet(src).count()
    assert accounting.tenant_rollup() == {}
    with QueryServer(max_concurrent=1) as srv:
        srv.submit(lambda: s.read.parquet(src).count(), tenant="bob").result(60)
    assert accounting.tenant_rollup()["bob"]["queries"] == 1


def test_refresh_and_optimize_run_in_the_batch_lane(tmp_path, monkeypatch):
    s, _, src = _lake(tmp_path, n_files=2)
    s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, 4)
    hs = hst.Hyperspace(s)
    hs.create_index(s.read.parquet(src), hst.IndexConfig("laneIdx", ["k"], ["v"]))
    lanes = []
    real = hs._manager.refresh

    def spy(name, mode="full"):
        lanes.append(resilience.current_lane())
        return real(name, mode)

    monkeypatch.setattr(hs._manager, "refresh", spy)
    hs.refresh_index("laneIdx")
    assert lanes == ["batch"] and resilience.current_lane() is None


# ---------------------------------------------------------------------------
# The mixed workload: chaos and no deadlock
# ---------------------------------------------------------------------------


def test_mixed_workload_under_decode_faults_returns_the_clean_rows(tmp_path, monkeypatch):
    monkeypatch.setenv("HYPERSPACE_IO_RETRIES", "6")
    s, j, src = _lake(tmp_path)
    work = _workload(s, hst.col, src)
    clean = {n: q().rows() for n, q in work.items()}
    jclean = {n: q().rows() for n, q in _workload(j, jax_col, src).items()}
    assert clean == jclean
    _clear_caches()
    before = _counters()
    with faults.inject("io.decode", rate=0.3, kind="transient"):
        with QueryServer(max_concurrent=4) as srv:
            futs = {(n, t): srv.submit(q, tenant=t) for t in ("t1", "t2", "t3") for n, q in work.items()}
            got = {k: f.result(120).rows() for k, f in futs.items()}
    for (n, t), rows in got.items():
        assert rows == clean[n], f"{n}/{t} diverged under faults"
    d = _delta(before)
    assert d.get("faults.injected", 0) > 0 and d.get("io.retries.attempts", 0) > 0, d


def test_eight_workers_finish_a_mixed_workload_with_no_deadlock(tmp_path, monkeypatch):
    monkeypatch.setenv("HYPERSPACE_QUERY_TIMEOUT_S", "60")
    s, _, src = _lake(tmp_path)
    work = _workload(s, hst.col, src)
    serial = {n: q().rows() for n, q in work.items()}
    _clear_caches()
    before = _counters()
    barrier = threading.Barrier(2)
    _hold_reads_until_a_follower_waits(monkeypatch)

    def cold_scan():
        barrier.wait(30)
        return s.read.parquet(src).collect()

    names = list(work) * 8
    with QueryServer(max_concurrent=8) as srv:
        futs = [srv.submit(cold_scan, tenant="cold") for _ in range(2)]
        futs += [srv.submit(work[n], tenant=f"t{i % 4}", lane="interactive" if n == "point" else "batch")
                 for i, n in enumerate(names)]
        got = [f.result(120).rows() for f in futs]
    assert got[0] == got[1] == serial["scan"]
    for n, rows in zip(names, got[2:]):
        assert rows == serial[n]
    d = _delta(before)
    assert d.get("serve.singleflight.dedup_hits", 0) > 0 and d.get("serve.completed", 0) == len(names) + 2, d


def test_serving_on_and_off_give_identical_rows(tmp_path, monkeypatch):
    s, _, src = _lake(tmp_path)
    work = _workload(s, hst.col, src)
    _clear_caches()
    with QueryServer(max_concurrent=4) as srv:
        futs = {n: srv.submit(q, tenant="x") for n, q in work.items()}
        on = {n: f.result(60).rows() for n, f in futs.items()}
    monkeypatch.setenv("HYPERSPACE_SERVING", "0")
    _clear_caches()
    srv2 = QueryServer()
    off = {n: srv2.submit(q, tenant="x").result().rows() for n, q in work.items()}
    srv2.close()
    assert on == off

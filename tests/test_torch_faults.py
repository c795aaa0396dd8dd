"""Fault injection, retries, deadlines and the corruption quarantine in the
port against the JAX package.

The registry, taxonomy, chaos, log-write, quarantine and deadline cases of
`tests/test_faults.py`, and the four fault cases of
`tests/test_live_tables.py` (:386 `refresh.merge`, :405 `compact.commit`,
:424 Hybrid Scan under decode faults, :463 the compactor losing its race to
a refresh), run in both packages over the same parquet files. Tolerance 0:
the rows, the classified exception, the quarantine state, and under one
`HYPERSPACE_FAULTS` spec and seed the per-point call and injection counts
(`faults._decide` is the JAX package's draw bit for bit, so both inject at
the same call indices).

Every chaos case runs serially (`HYPERSPACE_BUILD_DECODE_THREADS=1`,
`HYPERSPACE_BUILD_WRITERS=1`), so the call order is fixed. The reference's
chaos build (`test_build_identical_under_faults`, seed "0") is not copied:
under seed "0" the decisions of `storage.write` calls 1, 2 and 3 all fire,
while `retry_io` allows 2 retries, so a threaded write order can exhaust a
write (ROADMAP Queue 3). The port's build case runs under seed "8", whose
decisions for calls 0-39 at rate 0.3 are
`XX...X.X....X..X.X.X...X.X...X.X........`: never three fires in a row.
"""

import hashlib
import os
import threading
import time
import warnings

import numpy as np
import pytest

import hyperspace_tpu_torch as hst
from hyperspace_tpu import IndexConfig as JaxIndexConfig
from hyperspace_tpu import resilience as jax_resilience
from hyperspace_tpu.engine import HyperspaceSession as JaxSession
from hyperspace_tpu.engine import col as jax_col
from hyperspace_tpu.engine import io as jax_io
from hyperspace_tpu.engine.physical import clear_device_memos as jax_clear_memos
from hyperspace_tpu.engine.scan_cache import global_bucketed_cache as jax_bucketed_cache
from hyperspace_tpu.engine.scan_cache import global_concat_cache as jax_concat_cache
from hyperspace_tpu.engine.scan_cache import global_scan_cache as jax_scan_cache
from hyperspace_tpu.engine.table import Table as JaxTable
from hyperspace_tpu import exceptions as jax_exceptions
from hyperspace_tpu.hyperspace import Hyperspace as JaxHyperspace
from hyperspace_tpu.hyperspace import enable_hyperspace as jax_enable
from hyperspace_tpu.index import quarantine as jax_quarantine
from hyperspace_tpu.index.staging import STAGING_PREFIX
from hyperspace_tpu.telemetry import faults as jax_faults
from hyperspace_tpu_torch import exceptions, resilience
from hyperspace_tpu_torch.engine import io as engine_io
from hyperspace_tpu_torch.engine import physical, scan_cache
from hyperspace_tpu_torch.engine.table import Table
from hyperspace_tpu_torch.index import quarantine
from hyperspace_tpu_torch.telemetry import faults

FAULT_ENVS = ("HYPERSPACE_FAULTS", "HYPERSPACE_FAULTS_SEED", "HYPERSPACE_QUERY_TIMEOUT_S", "HYPERSPACE_IO_RETRIES",
              "HYPERSPACE_QUERY_RETRY_BUDGET", "HYPERSPACE_BUILD_DECODE_THREADS", "HYPERSPACE_BUILD_WRITERS",
              "HYPERSPACE_QUERY_STREAMING", "HYPERSPACE_REFRESH_WARM_HANDOFF")


def _reset_state():
    for f, q in ((faults, quarantine), (jax_faults, jax_quarantine)):
        f.clear()
        f.reset_counters()
        q.clear()


@pytest.fixture(autouse=True)
def _clean_fault_state(monkeypatch):
    """Injection off, zeroed per-point counters, a fast backoff and an empty
    quarantine in both packages, before and after each case."""
    for k in FAULT_ENVS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HYPERSPACE_RETRY_BACKOFF_S", "0.001")
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    _reset_state()
    _clear_caches()
    yield
    _reset_state()


def _clear_caches():
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()
    jax_scan_cache().clear()
    jax_concat_cache().clear()
    jax_bucketed_cache().clear()
    jax_clear_memos()


class Side:
    """One package: its session over the shared source, facade, `col`,
    fault registry, quarantine and exception classes."""

    def __init__(self, base: str, name: str, buckets: int, lineage: bool):
        self.name = name
        self.idx = os.path.join(base, name, "indexes")
        if name == "torch":
            self.s = hst.HyperspaceSession(warehouse=os.path.join(base, name), device="cpu")
            self.hs, self.cfg, self.col, self.enable = hst.Hyperspace(self.s), hst.IndexConfig, hst.col, hst.enable_hyperspace
            self.faults, self.quarantine, self.exc, self.resilience = faults, quarantine, exceptions, resilience
        else:
            self.s = JaxSession(warehouse=os.path.join(base, name))
            self.hs, self.cfg, self.col, self.enable = JaxHyperspace(self.s), JaxIndexConfig, jax_col, jax_enable
            self.faults, self.quarantine, self.exc, self.resilience = jax_faults, jax_quarantine, jax_exceptions, jax_resilience
        self.s.conf.set("hyperspace.system.path", self.idx)
        self.s.conf.set("hyperspace.index.num.buckets", buckets)
        if lineage:
            self.s.conf.set("hyperspace.index.lineage.enabled", "true")

    def files(self, index: str) -> dict:
        """Every data file of the index's stable entry: basename → sha256."""
        entry = [e for e in self.hs._manager.get_indexes() if e.name == index][0]
        return {os.path.basename(p): hashlib.sha256(open(p, "rb").read()).hexdigest() for p in entry.content.files()}

    def state(self, index: str) -> str:
        return [e for e in self.hs._manager.get_indexes() if e.name == index][0].state


class Pair:
    def __init__(self, base, n_files=4, rows_per_file=200, buckets=4, lineage=False):
        self.base = str(base)
        self.src = os.path.join(self.base, "src")
        for i in range(n_files):
            lo = i * rows_per_file
            k = np.arange(lo, lo + rows_per_file, dtype=np.int64)
            engine_io.write_parquet(Table.from_pydict({"k": k, "v": k % 7}, "cpu"),
                                    os.path.join(self.src, f"part-{i:05d}.parquet"))
        self.t = Side(self.base, "torch", buckets, lineage)
        self.j = Side(self.base, "jax", buckets, lineage)
        self.sides = (self.t, self.j)

    def read(self, side):
        return side.s.read.parquet(self.src)


def _serial(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_BUILD_DECODE_THREADS", "1")
    monkeypatch.setenv("HYPERSPACE_BUILD_WRITERS", "1")


def _counts(side, *points):
    return {p: (side.faults.call_count(p), side.faults.injected_count(p)) for p in points}


# -- tests/test_faults.py: TestFaultRegistry ------------------------------------


def test_env_spec_grammar(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_FAULTS", "io.decode:0.5, log.write:1.0:permanent:3:2")
    for f in (faults, jax_faults):
        specs = f._active_specs()
        assert (specs["io.decode"].rate, specs["io.decode"].kind) == (0.5, "transient")
        assert (specs["log.write"].kind, specs["log.write"].limit, specs["log.write"].after) == ("permanent", 3, 2)


def test_every_point_of_the_reference_is_declared():
    assert faults.FAULT_POINTS == jax_faults.FAULT_POINTS
    with pytest.raises(ValueError, match="Unknown fault point"):
        faults.FaultSpec("io.bogus", 1.0)
    spec = faults.FaultSpec("storage.write", 1.0, "hang2.5")
    assert spec.kind == "hang" and spec.hang_s == 2.5


@pytest.mark.parametrize("seed", ["0", "8", "42", "43"])
def test_decisions_are_the_jax_packages_bit_for_bit(seed, monkeypatch):
    monkeypatch.setenv("HYPERSPACE_FAULTS_SEED", seed)
    for point in faults.FAULT_POINTS:
        for rate in (0.05, 0.3, 0.4):
            got = [faults._decide(point, n, rate) for n in range(200)]
            assert got == [jax_faults._decide(point, n, rate) for n in range(200)]
            assert any(got) and not all(got)


def test_inject_scope_counts_and_restores():
    with faults.inject("io.decode", rate=1.0, kind="transient"):
        with pytest.raises(exceptions.TransientError, match="injected"):
            faults.check("io.decode")
    faults.check("io.decode")  # off again after the scope
    assert faults.injected_count("io.decode") == 1 and faults.call_count("io.decode") == 1


def test_limit_and_after():
    with faults.inject("io.footer", rate=1.0, limit=1, after=2):
        faults.check("io.footer")
        faults.check("io.footer")
        with pytest.raises(exceptions.TransientError):
            faults.check("io.footer")
        faults.check("io.footer")  # the limit is reached
    assert faults.call_count("io.footer") == 4 and faults.injected_count() == 1


def test_malformed_fault_spec_is_classified(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_FAULTS", "io.decode")  # no rate
    with pytest.raises(exceptions.HyperspaceException, match="Bad HYPERSPACE_FAULTS"):
        faults.check("io.decode")


# -- tests/test_faults.py: TestTaxonomy -----------------------------------------


def test_is_transient_matches_the_jax_package():
    import pyarrow as pa

    cases = [ConnectionError("x"), OSError("flaky nfs"), TimeoutError(), FileNotFoundError("x"), PermissionError(),
             ValueError("corrupt parquet"), TypeError("bug"), pa.lib.ArrowInvalid("magic"), EOFError()]
    for e in cases:
        assert exceptions.is_transient(e) == jax_exceptions.is_transient(e), e
    for name in ("TransientError", "PermanentError", "HyperspaceException", "QueryTimeoutError",
                 "RetryBudgetExceededError"):
        assert exceptions.is_transient(getattr(exceptions, name)("x")) == jax_exceptions.is_transient(
            getattr(jax_exceptions, name)("x"))
    assert exceptions.is_transient(exceptions.CorruptIndexError("x", "idx", "/p")) is False
    assert issubclass(exceptions.CorruptIndexError, exceptions.PermanentError)
    assert issubclass(exceptions.RetryBudgetExceededError, exceptions.PermanentError)


def test_retry_io_retries_transient_and_fails_fast_on_permanent():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise exceptions.TransientError("blip")
        return "ok"

    before = resilience.counters().get("io.retries.attempts", 0)
    assert resilience.retry_io("io.decode", flaky) == "ok" and len(calls) == 3
    assert resilience.counters()["io.retries.attempts"] == before + 2

    def broken():
        calls.append(1)
        raise exceptions.PermanentError("gone")

    with pytest.raises(exceptions.PermanentError):
        resilience.retry_io("io.decode", broken)
    assert len(calls) == 4 and resilience.counters()["io.retries.attempts"] == before + 2


# -- tests/test_faults.py: TestChaosOracle --------------------------------------


def test_collect_identical_under_decode_faults(tmp_path, monkeypatch):
    _serial(monkeypatch)
    monkeypatch.setenv("HYPERSPACE_IO_RETRIES", "6")
    pair = Pair(tmp_path)
    clean = pair.read(pair.t).collect().sorted_rows()
    assert clean == pair.read(pair.j).collect().sorted_rows()
    for side in pair.sides:
        with side.faults.inject("io.decode", rate=0.4, kind="transient"):
            for _ in range(3):
                _clear_caches()
                assert pair.read(side).collect().sorted_rows() == clean
    assert faults.injected_count("io.decode") > 0
    assert _counts(pair.t, "io.decode") == _counts(pair.j, "io.decode")


def test_streamed_aggregate_identical_under_faults(tmp_path, monkeypatch):
    _serial(monkeypatch)
    monkeypatch.setenv("HYPERSPACE_QUERY_STREAMING", "1")
    pair = Pair(tmp_path)

    def q(side):
        return pair.read(side).group_by("v").agg(total=("k", "sum"), n=("*", "count")).collect().sorted_rows()

    clean = q(pair.t)
    for side in pair.sides:
        with side.faults.inject("io.decode", rate=0.4, kind="transient"):
            _clear_caches()
            assert q(side) == clean
    assert faults.injected_count() > 0
    assert _counts(pair.t, "io.decode") == _counts(pair.j, "io.decode")


def test_exhausted_retries_fail_classified(tmp_path, monkeypatch):
    _serial(monkeypatch)
    pair = Pair(tmp_path)
    before = resilience.counters().get("io.retries.exhausted", 0)
    for side in pair.sides:
        with side.faults.inject("io.decode", rate=1.0, kind="transient"):
            with pytest.raises(side.exc.TransientError, match="injected"):
                pair.read(side).collect()
    assert resilience.counters()["io.retries.exhausted"] > before
    assert _counts(pair.t, "io.decode") == _counts(pair.j, "io.decode") == {"io.decode": (3, 3)}
    _clear_caches()  # nothing poisoned
    assert pair.read(pair.t).count() == pair.read(pair.j).count() == 800
    assert pair.read(pair.t).collect().num_rows == 800


def test_permanent_fault_not_retried(tmp_path, monkeypatch):
    _serial(monkeypatch)
    pair = Pair(tmp_path)
    before = resilience.counters().get("io.retries.attempts", 0)
    for side in pair.sides:
        with side.faults.inject("io.decode", rate=1.0, kind="permanent"):
            with pytest.raises(side.exc.PermanentError):
                pair.read(side).collect()
    assert resilience.counters().get("io.retries.attempts", 0) == before
    assert _counts(pair.t, "io.decode") == _counts(pair.j, "io.decode") == {"io.decode": (1, 1)}


def test_retry_budget_exceeded(tmp_path, monkeypatch):
    _serial(monkeypatch)
    monkeypatch.setenv("HYPERSPACE_QUERY_RETRY_BUDGET", "1")
    pair = Pair(tmp_path)
    for side in pair.sides:
        with side.faults.inject("io.decode", rate=1.0, kind="transient"):
            with pytest.raises(side.exc.RetryBudgetExceededError, match="retry budget"):
                pair.read(side).collect()
    assert _counts(pair.t, "io.decode") == _counts(pair.j, "io.decode")


def test_build_identical_under_write_faults(tmp_path, monkeypatch):
    """An index built under `storage.write` faults at rate 0.3 (seed "8",
    serial) has a clean build's bytes, the JAX package's bytes, and the
    JAX package's call and injection counts."""
    _serial(monkeypatch)
    monkeypatch.setenv("HYPERSPACE_FAULTS_SEED", "8")
    pair = Pair(tmp_path)
    clean = {}
    for side in pair.sides:
        side.hs.create_index(pair.read(side), side.cfg("clean", ["k"], ["v"]))
        clean[side.name] = side.files("clean")
        _clear_caches()
        with side.faults.inject("storage.write", rate=0.3, kind="transient"):
            side.hs.create_index(pair.read(side), side.cfg("chaos", ["k"], ["v"]))
        assert side.files("chaos") == clean[side.name]
    assert clean["torch"] == clean["jax"]
    # Calls 0 and 1 fire on bucket 0's write, call 5 on bucket 3's.
    assert _counts(pair.t, "storage.write") == _counts(pair.j, "storage.write") == {"storage.write": (7, 3)}


def test_an_env_spec_injects_at_the_same_calls_in_an_indexed_join(tmp_path, monkeypatch):
    """`HYPERSPACE_FAULTS=io.decode:0.3:transient`: a covering-index join
    (both sides indexed, value mode) gives the clean rows in both packages,
    which draw the same calls and injections."""
    _serial(monkeypatch)
    monkeypatch.setenv("HYPERSPACE_IO_RETRIES", "6")
    monkeypatch.setenv("HYPERSPACE_FAULTS_SEED", "3")  # io.decode: ..X..X.X.....X..X...
    pair = Pair(tmp_path)
    rng = np.random.RandomState(4)
    right = os.path.join(pair.base, "right")
    engine_io.write_parquet(Table.from_pydict({"k2": rng.permutation(900).astype(np.int64),
                                               "w": rng.randint(0, 50, 900).astype(np.int64)}, "cpu"),
                            os.path.join(right, "part-00000.parquet"))
    rows = {}
    for side in pair.sides:
        side.hs.create_index(pair.read(side), side.cfg("li", ["k"], ["v"]))
        side.hs.create_index(side.s.read.parquet(right), side.cfg("ri", ["k2"], ["w"]))
        side.enable(side.s)

        def q():
            return (pair.read(side).join(side.s.read.parquet(right), side.col("k") == side.col("k2"))
                    .select("k", "v", "w").collect().sorted_rows())

        _clear_caches()
        clean = q()
        assert "BucketedIndexScan" in pair.read(side).join(
            side.s.read.parquet(right), side.col("k") == side.col("k2")).explain_string()
        _clear_caches()
        side.faults.reset_counters()
        monkeypatch.setenv("HYPERSPACE_FAULTS", "io.decode:0.3:transient")
        assert q() == clean
        monkeypatch.delenv("HYPERSPACE_FAULTS")
        rows[side.name] = clean
    assert rows["torch"] == rows["jax"] and len(rows["torch"]) == 800
    assert faults.injected_count("io.decode") > 0
    assert _counts(pair.t, "io.decode") == _counts(pair.j, "io.decode")


# -- tests/test_faults.py: TestLogWriteClassification ---------------------------


def test_transient_log_fault_retried_to_success(tmp_path, monkeypatch):
    _serial(monkeypatch)
    pair = Pair(tmp_path, n_files=2, rows_per_file=50, buckets=2)
    before = resilience.counters().get("io.retries.log.write", 0)
    for side in pair.sides:
        with side.faults.inject("log.write", rate=1.0, kind="transient", limit=1):
            side.hs.create_index(pair.read(side), side.cfg("idx", ["k"], ["v"]))
        assert side.state("idx") == "ACTIVE"
    assert resilience.counters()["io.retries.log.write"] == before + 1
    assert _counts(pair.t, "log.write") == _counts(pair.j, "log.write") == {"log.write": (4, 1)}
    assert pair.t.files("idx") == pair.j.files("idx")


@pytest.mark.parametrize("failure", ["false", "raises"])
def test_failed_stable_pointer_raises_classified(tmp_path, failure):
    """A failed latestStable refresh raises `LogCommitError`; the numbered
    final entry is committed all the same."""
    from hyperspace_tpu_torch.actions.create import CreateAction
    from hyperspace_tpu_torch.index.builder import CoveringIndexBuilder
    from hyperspace_tpu_torch.index.log_manager import IndexLogManagerImpl

    class PointerLoss(IndexLogManagerImpl):
        def create_latest_stable_log(self, log_id):
            super().create_latest_stable_log(log_id)
            if failure == "raises":
                raise OSError("pointer write lost")
            return False

    pair = Pair(tmp_path, n_files=1, rows_per_file=20, buckets=2)
    mgr = PointerLoss(os.path.join(pair.base, "idx"))
    action = CreateAction(pair.read(pair.t), hst.IndexConfig("idx", ["k"], ["v"]), CoveringIndexBuilder(pair.t.s),
                          mgr, os.path.join(pair.base, "idx"), os.path.join(pair.base, "idx", "v__=0"))
    with pytest.raises(exceptions.LogCommitError, match="latestStable"):
        action.run()
    assert mgr.get_log(1).state == "ACTIVE"


def test_occ_conflict_is_concurrent_write_error(tmp_path):
    from hyperspace_tpu_torch.actions.lifecycle import DeleteAction
    from hyperspace_tpu_torch.index.log_manager import IndexLogManagerImpl

    pair = Pair(tmp_path, n_files=1, rows_per_file=20, buckets=2)
    pair.t.hs.create_index(pair.read(pair.t), pair.t.cfg("idx", ["k"], ["v"]))
    mgr = IndexLogManagerImpl(os.path.join(pair.t.idx, "idx"))
    action = DeleteAction(mgr)
    action._base_id = 0  # a stale base: log id 1 is taken
    with pytest.raises(exceptions.ConcurrentWriteError, match="in progress"):
        action.begin()


# -- tests/test_faults.py: TestQuarantine ---------------------------------------


def _indexed(tmp_path, monkeypatch):
    _serial(monkeypatch)
    pair = Pair(tmp_path, n_files=2, rows_per_file=100, buckets=3)
    for side in pair.sides:
        side.hs.create_index(pair.read(side), side.cfg("fidx", ["k"], ["v"]))
        side.enable(side.s)
    return pair


def _corrupt_one_bucket(side, index="fidx"):
    vdir = os.path.join(side.idx, index, "v__=0")
    victim = sorted(os.listdir(vdir))[0]
    with open(os.path.join(vdir, victim), "wb") as f:
        f.write(b"not a parquet file")


def _range_query(pair, side):
    return pair.read(side).filter(side.col("k") > 42).select("k", "v")


@pytest.mark.parametrize("action", ["collect", "count"])
def test_corrupt_bucket_file_quarantines_and_falls_back(tmp_path, monkeypatch, action):
    pair = _indexed(tmp_path, monkeypatch)
    answers = {}
    for side in pair.sides:
        clean = _range_query(pair, side).collect().sorted_rows()
        _corrupt_one_bucket(side)
        _clear_caches()
        with pytest.warns(RuntimeWarning, match="quarantined"):
            got = _range_query(pair, side).collect().sorted_rows() if action == "collect" else \
                _range_query(pair, side).count()
        assert got == (clean if action == "collect" else len(clean))
        assert sorted(side.quarantine.snapshot()) == ["fidx"]
        answers[side.name] = got
        # Later queries skip the index at candidate selection: no warning,
        # the source plan, the same answer.
        _clear_caches()
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert _range_query(pair, side).collect().sorted_rows() == clean
        assert "fidx" not in _range_query(pair, side).explain_string()
    assert answers["torch"] == answers["jax"]
    assert quarantine.stats() == {"events": quarantine.stats()["events"], "active": 1}


def test_the_fallback_never_reads_the_quarantined_files_again(tmp_path, monkeypatch):
    pair = _indexed(tmp_path, monkeypatch)
    _corrupt_one_bucket(pair.t)
    _clear_caches()
    index_dir = os.path.join(pair.t.idx, "fidx")
    reads = []
    real = engine_io._read_arrow

    def spy(path, *a, **k):
        reads.append(path)
        return real(path, *a, **k)

    monkeypatch.setattr(engine_io, "_read_arrow", spy)
    with pytest.warns(RuntimeWarning, match="quarantined"):
        rows = _range_query(pair, pair.t).collect().sorted_rows()
    first_source = next(i for i, p in enumerate(reads) if not p.startswith(index_dir))
    assert all(p.startswith(index_dir) for p in reads[:first_source])
    assert not any(p.startswith(index_dir) for p in reads[first_source:])
    assert len(rows) == 157


def test_a_repeated_mark_propagates(tmp_path, monkeypatch):
    """Each round quarantines a new index: when the mark finds the index
    already quarantined, the corruption error propagates."""
    pair = _indexed(tmp_path, monkeypatch)
    _corrupt_one_bucket(pair.t)
    _clear_caches()
    quarantine.mark("fidx", reason="earlier")
    from hyperspace_tpu_torch.rules import rule_utils

    monkeypatch.setattr(rule_utils.quarantine, "is_quarantined", lambda name: False)
    with pytest.raises(exceptions.CorruptIndexError, match="fidx") as err:
        _range_query(pair, pair.t).collect()
    assert err.value.index_name == "fidx"


def test_refresh_lifts_quarantine(tmp_path, monkeypatch):
    pair = _indexed(tmp_path, monkeypatch)
    for side in pair.sides:
        side.quarantine.mark("fidx", reason="test")
        side.hs.refresh_index("fidx", mode="full")
        assert not side.quarantine.is_quarantined("fidx")
    assert pair.t.files("fidx") == pair.j.files("fidx")


def test_engine_bug_never_quarantines(tmp_path, monkeypatch):
    """The guard is typed to the decode layer: a TypeError surfaces raw."""
    pair = _indexed(tmp_path, monkeypatch)
    _clear_caches()

    def boom(*a, **k):
        raise TypeError("engine bug, not corruption")

    monkeypatch.setattr(engine_io, "_read_arrow", boom)
    monkeypatch.setattr(jax_io, "_read_one", boom)
    for side in pair.sides:
        with pytest.raises(TypeError, match="engine bug"):
            _range_query(pair, side).collect()
        assert not side.quarantine.is_quarantined("fidx")


def test_transient_faults_never_quarantine(tmp_path, monkeypatch):
    pair = _indexed(tmp_path, monkeypatch)
    _clear_caches()
    for side in pair.sides:
        with side.faults.inject("io.decode", rate=1.0, kind="transient"):
            with pytest.raises(side.exc.TransientError):
                _range_query(pair, side).collect()
        assert not side.quarantine.is_quarantined("fidx")
    assert _counts(pair.t, "io.decode") == _counts(pair.j, "io.decode")


def test_a_corrupt_dimension_quarantines_the_dimension_not_the_fact(tmp_path, monkeypatch):
    """A star join over two indexed dimensions with a corrupt bucket file of
    one: the port's guard names that dimension's index, which is
    quarantined, and the query answers from the source. The JAX package's
    star stream declines on any `HyperspaceException` of a dimension read
    (`streaming.py:600`) and answers from its cascade without quarantining
    anything (ROADMAP Queue 3). The rows are the same."""
    _serial(monkeypatch)
    rng = np.random.RandomState(23)
    base = str(tmp_path)
    fact = os.path.join(base, "fact")
    for i in range(2):
        engine_io.write_parquet(Table.from_pydict({
            "k1": rng.randint(0, 20, 200).astype(np.int64), "k2": rng.randint(0, 10, 200).astype(np.int64),
            "v": rng.randint(0, 9, 200).astype(np.int64)}, "cpu"), os.path.join(fact, f"part-{i:05d}.parquet"))
    for name, n in (("dim1", 20), ("dim2", 10)):
        engine_io.write_parquet(Table.from_pydict({f"d{name[-1]}": np.arange(n, dtype=np.int64),
                                                   f"g{name[-1]}": np.arange(n, dtype=np.int64) % 4}, "cpu"),
                                os.path.join(base, name, "part-00000.parquet"))
    answers = {}
    for side in (Side(base, "torch", 4, False), Side(base, "jax", 4, False)):
        r = side.s.read.parquet
        side.hs.create_index(r(os.path.join(base, "dim1")), side.cfg("mk1", ["d1"], ["g1"]))
        side.hs.create_index(r(os.path.join(base, "dim2")), side.cfg("mk2", ["d2"], ["g2"]))
        side.enable(side.s)

        def q():
            return (r(fact).join(r(os.path.join(base, "dim1")), side.col("k1") == side.col("d1"))
                    .join(r(os.path.join(base, "dim2")), side.col("k2") == side.col("d2"))
                    .group_by("g1").agg(t=("v", "sum"), c=("*", "count")))

        assert "MultiwayJoin (2 dims: mk1, mk2)" in q().explain_string()
        clean = q().collect().sorted_rows()
        _corrupt_one_bucket(side, "mk1")
        _clear_caches()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            assert q().collect().sorted_rows() == clean
        said = [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]
        if side.name == "torch":
            assert len(said) == 1 and "index 'mk1' quarantined" in said[0]
            assert sorted(side.quarantine.snapshot()) == ["mk1"]
            assert "mk1" not in q().explain_string()
        else:
            assert said == [] and side.quarantine.snapshot() == {}
        answers[side.name] = clean
    assert answers["torch"] == answers["jax"]


# -- tests/test_faults.py: TestDeadlines ----------------------------------------


def _scan_entries():
    """Decoded columns in the per-file cache and tables in the others."""
    st = scan_cache.stats()
    return st["scan"]["columns"] + sum(st[k]["entries"] for k in ("bucketed_concat", "concat", "filtered"))


def test_query_timeout_classified_and_clean(tmp_path, monkeypatch):
    _serial(monkeypatch)
    pair = Pair(tmp_path)
    monkeypatch.setenv("HYPERSPACE_QUERY_TIMEOUT_S", "0.1")
    before = resilience.counters().get("query.timeouts", 0)
    entries = _scan_entries()
    for side in pair.sides:
        with side.faults.inject("io.decode", rate=1.0, kind="hang0.06"):
            with pytest.raises(side.exc.QueryTimeoutError, match="HYPERSPACE_QUERY_TIMEOUT_S"):
                pair.read(side).collect()
    assert resilience.counters()["query.timeouts"] == before + 1
    assert _scan_entries() == entries  # the timed-out read cached nothing
    assert _counts(pair.t, "io.decode") == _counts(pair.j, "io.decode")
    monkeypatch.delenv("HYPERSPACE_QUERY_TIMEOUT_S")
    assert pair.read(pair.t).collect().sorted_rows() == pair.read(pair.j).collect().sorted_rows()
    assert pair.read(pair.t).collect().num_rows == 800


def test_streamed_aggregate_timeout(tmp_path, monkeypatch):
    _serial(monkeypatch)
    monkeypatch.setenv("HYPERSPACE_QUERY_STREAMING", "1")
    pair = Pair(tmp_path)
    monkeypatch.setenv("HYPERSPACE_QUERY_TIMEOUT_S", "0.1")
    for side in pair.sides:
        with side.faults.inject("io.decode", rate=1.0, kind="hang0.06"):
            with pytest.raises(side.exc.QueryTimeoutError):
                pair.read(side).group_by("v").agg(total=("k", "sum")).collect()
    monkeypatch.delenv("HYPERSPACE_QUERY_TIMEOUT_S")
    _clear_caches()
    got = pair.read(pair.t).group_by("v").agg(total=("k", "sum")).collect()
    assert got.num_rows == 7
    assert got.sorted_rows() == pair.read(pair.j).group_by("v").agg(total=("k", "sum")).collect().sorted_rows()


def test_a_build_past_its_deadline_commits_nothing(tmp_path, monkeypatch):
    _serial(monkeypatch)
    pair = Pair(tmp_path)
    monkeypatch.setenv("HYPERSPACE_QUERY_TIMEOUT_S", "0.1")
    with faults.inject("io.decode", rate=1.0, kind="hang0.06"):
        with pytest.raises(exceptions.QueryTimeoutError):
            pair.t.hs.create_index(pair.read(pair.t), pair.t.cfg("late", ["k"], ["v"]))
    index_dir = os.path.join(pair.t.idx, "late")
    assert not [n for n in os.listdir(index_dir) if n.startswith("v__=") or n.startswith(STAGING_PREFIX)]


def test_no_scope_no_deadline_and_nested_scopes_share_one(monkeypatch):
    resilience.check_deadline("anywhere")
    assert resilience.remaining_s() is None
    monkeypatch.setenv("HYPERSPACE_QUERY_TIMEOUT_S", "60")
    with resilience.query_scope("outer") as outer:
        with resilience.query_scope("inner") as inner:
            assert inner is outer and 0 < resilience.remaining_s() <= 60


# -- tests/test_faults.py: TestCrashRecoveryInProcess, TestReliabilitySurfaces --


def test_dead_staging_dir_reclaimed(tmp_path, monkeypatch):
    import socket
    import subprocess

    _serial(monkeypatch)
    pair = Pair(tmp_path, n_files=2, rows_per_file=50, buckets=2)
    idx_path = os.path.join(pair.t.idx, "idx")
    os.makedirs(idx_path)
    proc = subprocess.Popen(["true"])
    proc.wait()  # a real pid, dead
    orphan = os.path.join(idx_path, f"{STAGING_PREFIX}v__=0~{socket.gethostname()}~{proc.pid}~deadbeef")
    os.makedirs(orphan)
    open(os.path.join(orphan, "part-00000.parquet"), "wb").write(b"partial")
    foreign = os.path.join(idx_path, f"{STAGING_PREFIX}v__=0~otherhost~12345~cafef00d")
    os.makedirs(foreign)
    pair.t.hs.create_index(pair.read(pair.t), pair.t.cfg("idx", ["k"], ["v"]))
    assert [n for n in os.listdir(idx_path) if n.startswith(STAGING_PREFIX)] == [os.path.basename(foreign)]
    from hyperspace_tpu_torch.util.procs import pid_alive

    assert pid_alive(os.getpid()) and not pid_alive(proc.pid) and not pid_alive(0)


def test_reliability_rollup(tmp_path, monkeypatch):
    quarantine.mark("brokenidx", reason="test")
    with faults.inject("io.decode", rate=1.0, limit=1):
        with pytest.raises(exceptions.TransientError):
            faults.check("io.decode")
    rel = resilience.reliability_rollup()
    assert rel["quarantined"] == ["brokenidx"] and rel["faults_injected"] == 1
    assert {"io_retries", "retries_exhausted", "query_timeouts", "quarantine_events"} <= set(rel)


# -- tests/test_live_tables.py: TestChaos and the compaction race ---------------


def _append(src, name, keys, vals):
    tmp = os.path.join(src, name + ".tmp")
    engine_io.write_parquet(Table.from_pydict({"k": keys, "v": vals}, "cpu"), tmp)
    os.replace(tmp, os.path.join(src, name))


class Live:
    """`tests/test_live_tables.py`'s lake: two files of string payloads, two
    buckets, lineage on, one source per package (a refresh sees its own
    appends only)."""

    def __init__(self, base):
        self.base = str(base)
        self.sides = {}
        for name in ("torch", "jax"):
            src = os.path.join(self.base, f"src_{name}")
            _append(src, "part-00000.parquet", [1, 2, 3, 4], ["a", "b", "c", "d"])
            _append(src, "part-00001.parquet", [5, 6], ["e", "f"])
            side = Side(self.base, name, 2, True)
            side.src = src
            self.sides[name] = side

    def oracle(self, src) -> dict:
        """A from-scratch rebuild of `src` by the JAX package."""
        side = Side(os.path.join(self.base, "oracle_" + os.path.basename(src)), "jax", 2, True)
        side.hs.create_index(side.s.read.parquet(src), side.cfg("oracle", ["k"], ["v"]))
        return side.files("oracle")


def _lookup(side, key):
    return side.s.read.parquet(side.src).filter(side.col("k") == key).select("v").collect().rows()


def test_refresh_merge_fault_fails_clean(tmp_path):
    live = Live(tmp_path)
    for side in live.sides.values():
        side.hs.create_index(side.s.read.parquet(side.src), side.cfg("rm", ["k"], ["v"]))
        _append(side.src, "part-00002.parquet", [7], ["g"])
        with side.faults.inject("refresh.merge", kind="transient"):
            with pytest.raises(side.exc.TransientError):
                side.hs.refresh_index("rm", mode="incremental")
        side.enable(side.s)
        _clear_caches()
        assert _lookup(side, 1) == [("a",)]
        side.hs.refresh_index("rm", mode="incremental")
        assert side.state("rm") == "ACTIVE"
        _clear_caches()
        assert _lookup(side, 7) == [("g",)]
    assert _counts(live.sides["torch"], "refresh.merge") == _counts(live.sides["jax"], "refresh.merge")


def test_compact_commit_fault_aborts_staging_clean(tmp_path):
    live = Live(tmp_path)
    for side in live.sides.values():
        side.hs.create_index(side.s.read.parquet(side.src), side.cfg("cc", ["k"], ["v"]))
        _append(side.src, "part-00002.parquet", [7, 8], ["g", "h"])
        side.hs.refresh_index("cc", mode="incremental")
        with side.faults.inject("compact.commit", kind="transient"):
            with pytest.raises(side.exc.TransientError):
                side.hs.optimize_index("cc")
        assert not [n for n in os.listdir(os.path.join(side.idx, "cc")) if n.startswith(STAGING_PREFIX)]
        side.hs.optimize_index("cc")
        assert side.state("cc") == "ACTIVE"
        # Each side's lineage column holds its own source's paths: each
        # equals the JAX package's rebuild of that source.
        assert side.files("cc") == live.oracle(side.src)


def test_hybrid_scan_appended_rows_survive_decode_chaos(tmp_path, monkeypatch):
    _serial(monkeypatch)
    monkeypatch.setenv("HYPERSPACE_IO_RETRIES", "6")
    live = Live(tmp_path)
    answers = {}
    for side in live.sides.values():
        side.s.conf.set("hyperspace.index.hybridscan.enabled", "true")
        right = os.path.join(live.base, f"r_{side.name}")
        side.s.write_parquet({"k2": [1, 5, 7], "w": [10, 50, 70]}, right)
        side.hs.create_index(side.s.read.parquet(side.src), side.cfg("hyb", ["k"], ["v"]))
        side.hs.create_index(side.s.read.parquet(right), side.cfg("hybr", ["k2"], ["w"]))
        _append(side.src, "part-00002.parquet", [7], ["g"])  # not refreshed: merged by Hybrid Scan
        side.enable(side.s)

        def run_queries():
            join = sorted(side.s.read.parquet(side.src).join(side.s.read.parquet(right), side.col("k") == side.col("k2"))
                          .select("k", "v", "w").collect().rows())
            return join, _lookup(side, 7)

        _clear_caches()
        clean = run_queries()
        assert clean[1] == [("g",)]
        _clear_caches()
        r0 = side.resilience.counters().get("io.retries.attempts", 0) if side.name == "torch" else None
        with side.faults.inject("io.decode", rate=0.4, kind="transient"):
            assert run_queries() == clean
        if r0 is not None:
            assert resilience.counters().get("io.retries.attempts", 0) > r0
        answers[side.name] = clean
    assert answers["torch"] == answers["jax"]
    assert faults.injected_count("io.decode") > 0


def test_compactor_loses_occ_race_to_refresher(tmp_path):
    """The compactor hangs in its commit window while a full refresh lands:
    it aborts with `ConcurrentWriteError`, leaves no staging directory, and
    readers see the refresh's generation, a rebuild's bytes."""
    live = Live(tmp_path)
    side = live.sides["torch"]
    side.hs.create_index(side.s.read.parquet(side.src), side.cfg("race", ["k"], ["v"]))
    _append(side.src, "part-00002.parquet", [7, 8], ["g", "h"])
    side.hs.refresh_index("race", mode="incremental")
    errs = []

    def compact():
        try:
            hst.Hyperspace(side.s).optimize_index("race")
        except Exception as e:  # noqa: BLE001 - recorded for the assert
            errs.append(e)

    calls0 = faults.call_count("compact.commit")
    with faults.inject("compact.commit", kind="hang2.0"):
        t = threading.Thread(target=compact)
        t.start()
        deadline = time.monotonic() + 30
        while faults.call_count("compact.commit") == calls0:
            assert time.monotonic() < deadline, "compactor never reached commit"
            time.sleep(0.02)
        side.hs.refresh_index("race", mode="full")
        t.join(timeout=60)
    assert not t.is_alive()
    assert len(errs) == 1 and isinstance(errs[0], exceptions.ConcurrentWriteError), errs
    assert not [n for n in os.listdir(os.path.join(side.idx, "race")) if n.startswith(STAGING_PREFIX)]
    side.hs._manager.clear_cache()
    assert side.state("race") == "ACTIVE"
    assert side.files("race") == live.oracle(side.src)
    side.enable(side.s)
    _clear_caches()
    assert _lookup(side, 7) == [("g",)]

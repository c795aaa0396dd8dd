"""The planner in the port against the JAX package.

The cases of `tests/test_planner.py` (`TestDecisions` :84,
`TestZeroCostOff` :149, `TestSelfCorrection` :258, `TestCostModel` :451,
`TestPruneSelectivity` :509, `TestMultiwayKnob` :599) run in both packages
over the same parquet files: each knob's arm and source, the plan
statistics, and, with `HYPERSPACE_PLANNER_MEMCPY_GBPS` pinning the
bandwidth, each arm's predicted seconds (rtol 1e-12). The self-correction
cases feed both packages the same synthetic walls: both flip at the same
query to the same arm, and an outcome store written by either re-folds in
the other to the same `outcome_summary()`. The JAX package's decisions are
read from `planner.decide` directly, the port's also from
`planner.last_decisions()` after a query.

`test_a_warm_aggregate_streams_the_jax_packages_chunks` is the ROADMAP
Queue 3 probe: 2 files of 600,000 rows (`RandomState(11)`; `g` in 0..99,
`p` = rand × 1000, 18 float64 fillers), `group_by("g").agg(s=("p","sum"),
c=("*","count"))` at default flags, cold then warm. Once every footer is
warm the planner shapes the chunk to pow2(64 MiB / bytes a row) = 524,288
rows, so both packages stream 2 chunks cold and 4 warm, and their float
sums agree bit for bit (tolerance 0); the warm sums differ from the cold
ones in the last bits, as the reference's do.
"""

import glob
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu_torch as hst
from hyperspace_tpu.engine import HyperspaceSession as JaxSession
from hyperspace_tpu.engine import col as jax_col
from hyperspace_tpu.engine.scan_cache import global_bucketed_cache as jax_bucketed_cache
from hyperspace_tpu.engine.scan_cache import global_concat_cache as jax_concat_cache
from hyperspace_tpu.engine.scan_cache import global_scan_cache as jax_scan_cache
from hyperspace_tpu.plananalysis import costmodel as jax_costmodel
from hyperspace_tpu.plananalysis import planner as jax_planner
from hyperspace_tpu.telemetry import history as jax_history
from hyperspace_tpu.telemetry.profiling import last_query_stages as jax_last_query_stages
from hyperspace_tpu_torch.engine import io as engine_io
from hyperspace_tpu_torch.engine import physical, scan_cache, streaming
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.plananalysis import costmodel, planner
from hyperspace_tpu_torch.telemetry import history
from hyperspace_tpu_torch.telemetry.profiling import last_query_stages
from test_torch_aggregate import assert_same

PLANNER_ENVS = (
    planner.ENV_PLANNER, planner.ENV_PLANNER_DIR, planner.ENV_MIN_SAMPLES, planner.ENV_DRIFT_X,
    costmodel.ENV_MEMCPY_GBPS, "HYPERSPACE_HISTORY", "HYPERSPACE_HISTORY_DIR", "HYPERSPACE_ACCOUNTING",
    "HYPERSPACE_FORCE_DEVICE_OPS",
)


def _clear_caches():
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()
    jax_scan_cache().clear()
    jax_concat_cache().clear()
    jax_bucketed_cache().clear()


@pytest.fixture(autouse=True)
def _clean_planner(monkeypatch):
    for k in PLANNER_ENVS + tuple(costmodel.KNOB_ENV.values()):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    planner.reset()
    jax_planner.reset()
    _clear_caches()
    yield
    planner.reset()
    jax_planner.reset()
    history.reset_stores()
    jax_history.reset_stores()


class Pair:
    """Both packages' sessions over one warehouse."""

    def __init__(self, base):
        self.base = str(base)
        self.t = hst.HyperspaceSession(warehouse=self.base, device="cpu")
        self.j = JaxSession(warehouse=self.base)

    def source(self, rows=600, name="t") -> str:
        src = os.path.join(self.base, name)
        self.t.write_parquet(
            {"k": [i % 7 for i in range(rows)], "grp": [f"g{i % 5}" for i in range(rows)],
             "v": [float(i) for i in range(rows)]},
            src,
        )
        return src


@pytest.fixture()
def pair(tmp_path):
    return Pair(tmp_path)


def _agg(session, src):
    return session.read.parquet(src).group_by("k").agg(total=("v", "sum"))


def _same_decisions(got, want, predictions=True):
    """Every knob's arm, alternative and source equal; predicted seconds
    within rtol 1e-12 when the bandwidth is pinned."""
    g, w = got.to_ledger(), want.to_ledger()
    assert set(g) == set(w) == set(costmodel.KNOBS)
    for knob in costmodel.KNOBS:
        for field in ("arm", "alt", "source"):
            assert g[knob][field] == w[knob][field], (knob, field, g[knob], w[knob])
        if predictions:
            for field in ("predicted_s", "predicted_alt_s"):
                assert g[knob][field] == pytest.approx(w[knob][field], rel=1e-12, abs=0), (knob, field)


def _same_stats(got, want):
    for f in ("n_scans", "n_files", "warm_files", "file_bytes", "rows", "decoded_bytes", "dict_cols",
              "dict_col_bytes", "row_shapes", "has_agg", "has_join", "has_filter", "star_dims"):
        assert getattr(got, f) == getattr(want, f), f


# -- tests/test_planner.py: TestDecisions ---------------------------------------


def test_model_arms_match_todays_defaults(pair, monkeypatch):
    """No history: the model's arms are the flags' defaults, cold and warm,
    in both packages, with equal predictions under a pinned bandwidth."""
    monkeypatch.setenv(costmodel.ENV_MEMCPY_GBPS, "12.5")
    src = pair.source()
    for _ in range(2):  # cold, then warm footers
        got = planner.decide(_agg(pair.t, src).physical_plan(), None, pair.t.device)
        want = jax_planner.decide(_agg(pair.j, src).physical_plan(), None)
        _same_decisions(got, want)
        assert got.calibration_source == want.calibration_source == "env"
        # Group order is the JAX package's device program's only under
        # HYPERSPACE_FORCE_DEVICE_OPS, which would also turn its
        # hash-quantize arm on: compare the rows as a multiset here.
        assert_same(_agg(pair.t, src).collect(), _agg(pair.j, src).collect(), ordered=False)
        last = planner.last_decisions().to_ledger()
        assert last == got.to_ledger()
    p = last
    for knob in ("streaming", "encoded_exec", "packed_codes", "pushdown", "join_size_classes", "multiway"):
        assert p[knob]["arm"] == "on"
    assert p["chunk_rows"]["arm"] == "4000000"
    assert p["hash_quantize"]["arm"] == "off"  # a CPU session
    assert all(d["source"] == "model" for d in p.values())


def test_explicit_flag_pins_and_gate_skips_planner(pair, monkeypatch):
    """A set flag wins at the gate without asking the planner, and the
    decision is reported as pinned, as in the JAX package."""
    src = pair.source()
    expect = _agg(pair.t, src).collect().to_pydict()
    for knob, env in costmodel.KNOB_ENV.items():
        monkeypatch.setenv(env, "4096" if knob in costmodel.INT_KNOBS else "1")

    def boom(knob):
        raise AssertionError(f"gate consulted planner for pinned {knob}")

    with monkeypatch.context() as m:
        m.setattr(planner, "decided_value", boom)
        assert _agg(pair.t, src).collect().to_pydict() == expect
    p = planner.last_decisions()
    assert all(d.source == "pinned" for d in p.decisions.values())
    assert p.to_ledger()["chunk_rows"]["arm"] == "4096"
    assert all(p.value(k) is None for k in costmodel.KNOBS)
    _same_decisions(p, jax_planner.decide(_agg(pair.j, src).physical_plan(), None), predictions=False)


def test_pinned_zero_disables_through_gate(pair, monkeypatch):
    src = pair.source()
    expect = _agg(pair.t, src).collect().sorted_rows()
    monkeypatch.setenv("HYPERSPACE_QUERY_STREAMING", "0")
    monkeypatch.setenv("HYPERSPACE_ENCODED_EXEC", "0")
    got = _agg(pair.t, src).collect()
    assert got.sorted_rows() == expect
    assert got.sorted_rows() == _agg(pair.j, src).collect().sorted_rows()


def test_gates_follow_the_decisions_in_scope(pair):
    """Inside `decisions_scope` every unset gate reads the decided value,
    on this thread and through the adopted query scope on another."""
    import threading

    from hyperspace_tpu_torch import resilience
    from hyperspace_tpu_torch.engine import encoding, packed_codes, pushdown, streaming
    from hyperspace_tpu_torch.ops import bucket_join

    gates = {
        "streaming": streaming.streaming_enabled, "multiway": streaming.multiway_enabled,
        "pushdown": pushdown.pushdown_enabled, "encoded_exec": encoding.encoded_exec_enabled,
        "packed_codes": packed_codes.packed_codes_enabled, "join_size_classes": bucket_join.size_classes_enabled,
    }
    pd = planner.PlanDecisions(None, {k: planner.Decision(k, False, True, 0.0, 0.0, "model") for k in gates})
    pd.decisions["chunk_rows"] = planner.Decision("chunk_rows", 4096, 4_000_000, 0.0, 0.0, "model")
    assert all(g() for g in gates.values()) and streaming.query_chunk_rows() == 4_000_000
    with resilience.query_scope("t") as sc, planner.decisions_scope(pd):
        assert not any(g() for g in gates.values()) and streaming.query_chunk_rows() == 4096
        seen = []

        def worker():
            with resilience.use_scope(sc):
                seen.append((streaming.streaming_enabled(), streaming.query_chunk_rows()))

        th = threading.Thread(target=worker)
        th.start()
        th.join()
        assert seen == [(False, 4096)]
    assert all(g() for g in gates.values())


def test_the_outcome_store_learns_under_both_settings(pair, monkeypatch, tmp_path):
    """With `HYPERSPACE_PLANNER_DIR` set, or history on (its `planner/`
    beside the session's `.hyperspace_history`), the port answers and lands
    one outcome record per query, as the JAX planner does."""
    src = pair.source()
    homes = (("HYPERSPACE_PLANNER_DIR", str(tmp_path / "p"), str(tmp_path / "p")),
             ("HYPERSPACE_HISTORY", "1", os.path.join(pair.base, ".hyperspace_history", "planner")))
    for env, value, home in homes:
        with monkeypatch.context() as m:
            m.setenv(env, value)
            assert planner.outcome_dir() == home
            for _ in range(2):
                assert _agg(pair.t, src).collect().num_rows == 7
            recs = [r for f in glob.glob(os.path.join(home, "planner-*.jsonl"))
                    for r in history.iter_file_records(f)]
            assert len(recs) == 2 and {r["kind"] for r in recs} == {"planner_outcome"}
            fps = {r["fingerprint"] for r in recs}
            assert len(fps) == 1 and set(recs[0]["outcomes"]) == set(costmodel.KNOBS)
            summary = planner.outcome_summary()
            assert {k[0] for k in summary} == fps and all(v["n"] == 2 for v in summary.values())
        planner.reset()
        history.reset_stores()


# -- tests/test_planner.py: TestZeroCostOff -------------------------------------


def test_off_runs_no_model_and_no_stat_reads(pair, monkeypatch):
    src = pair.source()
    monkeypatch.setenv(planner.ENV_PLANNER, "0")
    calls = {"stats": 0, "cal": 0}
    monkeypatch.setattr(costmodel, "collect_stats", lambda phys: calls.__setitem__("stats", calls["stats"] + 1))
    monkeypatch.setattr(costmodel, "current_calibration", lambda device=None: calls.__setitem__("cal", calls["cal"] + 1))
    assert _agg(pair.t, src).collect().num_rows == 7
    assert calls == {"stats": 0, "cal": 0}
    assert planner.last_decisions() is None and planner.activity_summary() == {}


def test_off_bounded_env_reads(pair, monkeypatch):
    """Off, the planner costs its `planner_enabled()` reads at plan time,
    never one per gate or per row."""
    src = pair.source()
    monkeypatch.setenv(planner.ENV_PLANNER, "0")
    _agg(pair.t, src).collect()
    calls = {"n": 0}
    real = planner.planner_enabled

    def counted():
        calls["n"] += 1
        return real()

    monkeypatch.setattr(planner, "planner_enabled", counted)
    n_queries = 4
    for _ in range(n_queries):
        _agg(pair.t, src).collect()
    assert 0 < calls["n"] <= 2 * n_queries


def test_rows_byte_identical_on_vs_off(pair, monkeypatch):
    src = pair.source()
    on = _agg(pair.t, src).collect()
    monkeypatch.setenv(planner.ENV_PLANNER, "0")
    off = _agg(pair.t, src).collect()
    assert_same(on, off)
    assert_same(off, _agg(pair.j, src).collect(), ordered=False)


# -- tests/test_planner.py: TestCostModel ---------------------------------------


def test_calibration_env_override(monkeypatch):
    monkeypatch.setenv(costmodel.ENV_MEMCPY_GBPS, "12.5")
    cal = costmodel.current_calibration()
    want = jax_costmodel.current_calibration()
    assert cal.memcpy_gbps == want.memcpy_gbps == 12.5 and cal.source == want.source == "env"


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_calibration_device_and_source(device, monkeypatch):
    """A CUDA session's calibration is a device's (compile seconds, the
    hash-quantize arm); with no copy to a card measured the rate stays the
    default, as in the JAX CPU oracle."""
    import torch

    engine_io.reset_io_stats()
    cal = costmodel.current_calibration(torch.device(device))
    assert cal.device is (device == "cuda")
    assert cal.compile_s == (costmodel._DEVICE_COMPILE_S if device == "cuda" else costmodel._HOST_COMPILE_S)
    assert cal.source == "default" and cal.memcpy_gbps == jax_costmodel.current_calibration().memcpy_gbps


def test_measured_copy_rate_calibrates(monkeypatch):
    """The host-to-device rate the scans measured replaces the default."""
    engine_io.reset_io_stats()
    with engine_io._stats_lock:
        engine_io._H2D["bytes"], engine_io._H2D["seconds"] = 5_000_000_000, 0.25
    try:
        cal = costmodel.current_calibration()
        assert cal.source == "measured" and cal.memcpy_gbps == pytest.approx(20.0, rel=1e-12)
    finally:
        engine_io.reset_io_stats()


def test_quantize_arms_follow_backend():
    st = dict(has_agg=True, rows=100_000, n_files=1, warm_files=1, decoded_bytes=10 << 20)
    for device, compile_s in ((False, 0.03), (True, 0.5)):
        got = costmodel.estimate(costmodel.PlanStats(**st), costmodel.Calibration(device=device, compile_s=compile_s))
        want = jax_costmodel.estimate(jax_costmodel.PlanStats(**st),
                                      jax_costmodel.Calibration(device=device, compile_s=compile_s))
        assert got == want
        q = got["hash_quantize"]
        assert q[0] is device
        assert (q[2] == 0.0) if not device else (q[3] >= 0.5)


@pytest.mark.parametrize("stats", [
    dict(has_agg=True, n_files=1, warm_files=1, rows=10_000, decoded_bytes=1 << 20),
    dict(has_agg=True, n_files=1, warm_files=1, rows=16_000_000, decoded_bytes=8 << 30),
    dict(has_agg=True, n_files=2, warm_files=1, rows=16_000_000, decoded_bytes=8 << 30),
    dict(has_agg=True, n_files=2, warm_files=2, rows=1_200_000, decoded_bytes=192_000_000),
    dict(has_agg=False, n_files=2, warm_files=2, rows=16_000_000, decoded_bytes=8 << 30),
], ids=["small", "big-warm", "big-cold", "probe-shape", "no-aggregate"])
def test_chunk_shaping_requires_warm_large_scans(stats):
    cal = costmodel.Calibration()
    got = costmodel.estimate(costmodel.PlanStats(**stats), cal)
    assert got == jax_costmodel.estimate(jax_costmodel.PlanStats(**stats), jax_costmodel.Calibration())
    shaped = got["chunk_rows"][0]
    if stats["has_agg"] and stats["warm_files"] == stats["n_files"] and stats["rows"] >= 1_000_000:
        assert costmodel._MIN_CHUNK_ROWS <= shaped < 4_000_000
    else:
        assert shaped == 4_000_000


def test_collect_stats_walks_plan_without_io(pair, monkeypatch):
    src = pair.source()
    df = _agg(pair.t, src)
    phys = df.physical_plan()

    def no_io(*a, **k):
        raise AssertionError("collect_stats must not parse footers")

    with monkeypatch.context() as m:
        m.setattr(engine_io, "footer_metadata", no_io)
        st = costmodel.collect_stats(phys)
    assert st.n_files == 1 and st.warm_files == 0 and st.has_agg
    _same_stats(st, jax_costmodel.collect_stats(_agg(pair.j, src).physical_plan()))
    df.collect()
    _agg(pair.j, src).collect()
    st2 = costmodel.collect_stats(phys)
    assert st2.warm_files == st2.n_files and st2.rows == 600
    _same_stats(st2, jax_costmodel.collect_stats(_agg(pair.j, src).physical_plan()))


def test_estimate_covers_every_knob():
    kw = dict(has_agg=True, has_join=True, has_filter=True, n_files=1, warm_files=1, rows=1000, decoded_bytes=1 << 20,
              dict_cols=2, dict_col_bytes=4096, row_shapes={1000})
    est = costmodel.estimate(costmodel.PlanStats(**kw), costmodel.Calibration())
    assert set(est) == set(costmodel.KNOBS)
    assert est == jax_costmodel.estimate(jax_costmodel.PlanStats(**kw), jax_costmodel.Calibration())
    for _model_v, _alt_v, pm, pa_ in est.values():
        assert pm >= 0.0 and pa_ >= 0.0


def test_learned_selectivity_prices_the_pushdown_arm():
    """`TestPruneSelectivity`'s model half: a scanned fraction replaces the
    half-prune prior, clamped to [0, 1] (the store that learns it waits)."""
    kw = dict(has_agg=True, has_filter=True, n_files=1, warm_files=1, rows=1000, decoded_bytes=1 << 20)
    cal, jcal = costmodel.Calibration(), jax_costmodel.Calibration()
    for sel in (None, 0.1, 1.0, 7.5):
        got = costmodel.estimate(costmodel.PlanStats(**kw), cal, prune_selectivity=sel)["pushdown"]
        assert got == jax_costmodel.estimate(jax_costmodel.PlanStats(**kw), jcal, prune_selectivity=sel)["pushdown"]
    sharp = costmodel.estimate(costmodel.PlanStats(**kw), cal, prune_selectivity=0.1)["pushdown"]
    static = costmodel.estimate(costmodel.PlanStats(**kw), cal)["pushdown"]
    assert sharp[2] < static[2] and sharp[3] == static[3]


# -- tests/test_planner.py: TestPruneSelectivity (the store's half) --------------


def test_store_folds_and_refolds_pruning_counters(tmp_path, monkeypatch):
    monkeypatch.setenv(planner.ENV_PLANNER_DIR, str(tmp_path / "ps"))
    store = planner._outcome_store()
    assert store.prune_selectivity("fp-sel") is None
    outcomes = {"pushdown": {"arm": "on", "wall_s": 0.01, "predicted_s": 0.01}}
    store.observe("fp-sel", outcomes, pruning=(2, 8))
    store.observe("fp-sel", outcomes, pruning=(0, 10))
    assert store.prune_selectivity("fp-sel") == pytest.approx(0.1)
    planner.reset()  # a restart re-folds the records
    store2 = planner._outcome_store()
    assert store2.prune_selectivity("fp-sel") == pytest.approx(0.1)
    assert jax_planner._outcome_store().prune_selectivity("fp-sel") == pytest.approx(0.1)
    store2.observe("fp-sel", outcomes, pruning=("x", None))  # ignored, never fatal
    assert store2.prune_selectivity("fp-sel") == pytest.approx(0.1)


def test_prune_counters_delta_clamped():
    base = planner.prune_counters()
    assert base is not None and len(base) == 2
    assert planner.prune_counters(base) == (0, 0)
    assert planner.prune_counters((10**12, 10**12)) == (0, 0)
    assert planner.prune_counters(("x",)) is None


def test_decided_query_records_pruning_delta(pair, tmp_path, monkeypatch):
    """A decided, filtered query lands its row-group delta in the store, and
    both packages learn the same selectivity of the same class."""
    src = os.path.join(pair.base, "pruned")
    pair.t.write_parquet({"k": [i % 7 for i in range(600)], "v": [float(i) for i in range(600)]}, src,
                         row_group_rows=100)
    learned = {}
    for name, s, mod, col in (("torch", pair.t, planner, hst.col), ("jax", pair.j, jax_planner, jax_col)):
        monkeypatch.setenv(planner.ENV_PLANNER_DIR, str(tmp_path / f"pe-{name}"))

        def q():
            return s.read.parquet(src).filter(col("v") < 150.0).group_by("k").agg(t=("v", "sum"))

        q().collect()  # cold: warms the footers
        q().collect()  # warm zone maps prune
        store = mod._outcome_store()
        learned[name] = {fp: store.prune_selectivity(fp) for fp, _k, _a in store.summary()}
    assert learned["torch"] == learned["jax"]
    sels = [v for v in learned["torch"].values() if v is not None]
    assert sels and all(0.0 < v < 1.0 for v in sels)


# -- tests/test_planner.py: TestSelfCorrection ----------------------------------


def _bad_chunk_estimate(stats, cal, prune_selectivity=None):
    """A measurably wrong model arm: tiny chunks, priced cheap."""
    est = {k: (True, False, 0.0, 0.0) for k in costmodel.KNOBS}
    est["chunk_rows"] = (512, 4_000_000, 0.006, 0.006)
    est["hash_quantize"] = (False, True, 0.0, 0.0)
    return est


def _self_correct(mod, phys, n, walls, fp="fp-selfcorrect"):
    """Decide and observe `n` queries of one class, the wall set by the
    chosen chunk arm; the (value, source) of each."""
    log = []
    for _ in range(n):
        pd = mod.decide(phys, fp)
        d = pd.decisions["chunk_rows"]
        log.append((d.value, d.source))
        mod.observe(pd, walls[d.value])
    return log


def _summary_of(mod) -> dict:
    return {k: {f: v[f] for f in ("n", "mean_wall_s", "mean_predicted_s")} for k, v in mod.outcome_summary().items()}


def test_wrong_arm_flips_at_the_jax_packages_query_and_survives_restart(pair, tmp_path, monkeypatch):
    src = pair.source()
    monkeypatch.setenv(planner.ENV_MIN_SAMPLES, "2")
    monkeypatch.setenv(planner.ENV_DRIFT_X, "1.0")
    monkeypatch.setattr(costmodel, "estimate", _bad_chunk_estimate)
    monkeypatch.setattr(jax_costmodel, "estimate", _bad_chunk_estimate)
    walls = {512: 0.2, 4_000_000: 0.05}
    logs, dirs = {}, {}
    for name, s, mod in (("torch", pair.t, planner), ("jax", pair.j, jax_planner)):
        dirs[name] = str(tmp_path / f"store-{name}")
        monkeypatch.setenv(planner.ENV_PLANNER_DIR, dirs[name])
        logs[name] = _self_correct(mod, _agg(s, src).physical_plan(), 6, walls)
    assert logs["torch"] == logs["jax"]
    log = logs["torch"]
    assert log[0] == (512, "model") and "explore" in {src_ for _, src_ in log}
    assert log[-1] == (4_000_000, "measured")
    monkeypatch.setenv(planner.ENV_PLANNER_DIR, dirs["torch"])
    phys = _agg(pair.t, src).physical_plan()
    with planner.decisions_scope(planner.decide(phys, "fp-selfcorrect")):
        assert streaming.query_chunk_rows() == 4_000_000  # the gate runs the flipped arm
    act = planner.activity_summary()["chunk_rows"]
    assert act["explorations"] >= 1 and act["measured_flips"] >= 1
    planner.reset()  # restart: the flip re-folds from disk
    assert glob.glob(os.path.join(dirs["torch"], "planner-*.jsonl"))
    assert _self_correct(planner, phys, 1, walls) == [(4_000_000, "measured")]


def test_a_store_written_by_either_package_refolds_in_the_other(pair, tmp_path, monkeypatch):
    src = pair.source()
    monkeypatch.setenv(planner.ENV_MIN_SAMPLES, "2")
    monkeypatch.setenv(planner.ENV_DRIFT_X, "1.0")
    monkeypatch.setattr(costmodel, "estimate", _bad_chunk_estimate)
    monkeypatch.setattr(jax_costmodel, "estimate", _bad_chunk_estimate)
    walls = {512: 0.2, 4_000_000: 0.05}
    for writer, s, mod, reader in (("torch", pair.t, planner, jax_planner), ("jax", pair.j, jax_planner, planner)):
        monkeypatch.setenv(planner.ENV_PLANNER_DIR, str(tmp_path / f"by-{writer}"))
        _self_correct(mod, _agg(s, src).physical_plan(), 5, walls)
        written = _summary_of(mod)
        reader.reset()
        assert written and _summary_of(reader) == written
        planner.reset()
        jax_planner.reset()


def test_no_learning_without_persistent_home(pair, tmp_path, monkeypatch):
    src = pair.source()
    monkeypatch.setattr(costmodel, "estimate", _bad_chunk_estimate)
    log = _self_correct(planner, _agg(pair.t, src).physical_plan(), 5, {512: 0.2, 4_000_000: 0.05})
    assert all(v == 512 and s == "model" for v, s in log)
    assert planner.outcome_summary() == {} and not glob.glob(str(tmp_path / "**" / "planner-*.jsonl"),
                                                             recursive=True)


def test_history_dir_sidecar_default(pair, tmp_path, monkeypatch):
    hdir = str(tmp_path / "hist")
    monkeypatch.setenv("HYPERSPACE_HISTORY", "1")
    monkeypatch.setenv("HYPERSPACE_HISTORY_DIR", hdir)
    assert planner.outcome_dir() == jax_planner.outcome_dir() == os.path.join(hdir, "planner")
    planner.observe(planner.decide(_agg(pair.t, pair.source()).physical_plan(), "fp-sidecar"), 0.01)
    assert glob.glob(os.path.join(hdir, "planner", "planner-*.jsonl"))


def test_outcome_persistence_is_bounded(tmp_path, monkeypatch):
    store_dir = str(tmp_path / "store")
    monkeypatch.setenv(planner.ENV_PLANNER_DIR, store_dir)
    store = planner._outcome_store()
    for _ in range(planner._PERSIST_CAP + 20):
        store.observe("fp-cap", {"streaming": {"arm": "on", "wall_s": 0.01, "predicted_s": 0.0}})
    lines = []
    for f in glob.glob(os.path.join(store_dir, "planner-*.jsonl")):
        with open(f) as fh:
            lines += fh.read().splitlines()
    assert len(lines) == planner._PERSIST_CAP == jax_planner._PERSIST_CAP
    assert store.stat("fp-cap", "streaming", "on").n == planner._PERSIST_CAP + 20
    assert jax_planner._outcome_store().stat("fp-cap", "streaming", "on").n == planner._PERSIST_CAP


def test_explores_one_knob_at_a_time(pair, tmp_path, monkeypatch):
    src = pair.source()
    monkeypatch.setenv(planner.ENV_PLANNER_DIR, str(tmp_path / "s"))
    monkeypatch.setenv(planner.ENV_MIN_SAMPLES, "1")
    monkeypatch.setenv(planner.ENV_DRIFT_X, "1.0")

    def two_drifting(stats, cal, prune_selectivity=None):
        est = {k: (True, False, 0.0, 0.0) for k in costmodel.KNOBS}
        est["streaming"] = (True, False, 0.01, 0.01)
        est["pushdown"] = (True, False, 0.01, 0.01)
        est["chunk_rows"] = (4_000_000, 4_000_000, 0.0, 0.0)
        est["hash_quantize"] = (False, True, 0.0, 0.0)
        return est

    monkeypatch.setattr(costmodel, "estimate", two_drifting)
    phys = _agg(pair.t, src).physical_plan()
    planner.observe(planner.decide(phys, "fp-onekn"), 0.5)  # both knobs drift far
    exploring = [k for k, d in planner.decide(phys, "fp-onekn").decisions.items() if d.source == "explore"]
    assert len(exploring) == 1


def test_annotate_close_joins_the_history_baseline(pair, tmp_path, monkeypatch):
    """With history on the ledger's planner dict carries the class's
    `baseline_mean_s` and `vs_baseline_x` from the second query on."""
    from hyperspace_tpu_torch.telemetry import accounting

    monkeypatch.setenv("HYPERSPACE_HISTORY", "1")
    monkeypatch.setenv("HYPERSPACE_HISTORY_DIR", str(tmp_path / "hist"))
    src = pair.source()
    _agg(pair.t, src).collect()
    assert "baseline_mean_s" not in accounting.recent_ledgers()[-1].to_dict()["planner"]
    _agg(pair.t, src).collect()
    p = accounting.recent_ledgers()[-1].to_dict()["planner"]
    assert p["baseline_mean_s"] > 0 and p["vs_baseline_x"] > 0


# -- tests/test_planner.py: TestMultiwayKnob ------------------------------------


def test_estimate_prices_star_plans():
    cal = costmodel.Calibration()
    assert costmodel.estimate(costmodel.PlanStats(has_join=True), cal)["multiway"] == (True, False, 0.0, 0.0)
    kw = dict(has_join=True, rows=1_000_000, decoded_bytes=50_000_000, star_dims=3)
    star = costmodel.estimate(costmodel.PlanStats(**kw), cal)["multiway"]
    assert star == jax_costmodel.estimate(jax_costmodel.PlanStats(**kw), jax_costmodel.Calibration())["multiway"]
    assert star[0] is True and 0.0 < star[2] < star[3]


def test_collect_stats_sees_star_and_dedupes_relations(pair):
    rng = np.random.RandomState(23)
    base = pair.base
    pair.t.write_parquet({"k1": rng.randint(0, 20, 400).astype(np.int64), "k2": rng.randint(0, 10, 400).astype(np.int64),
                          "v": rng.randint(0, 9, 400).astype(np.int64)}, os.path.join(base, "fact"))
    pair.t.write_parquet({"d1": np.arange(20, dtype=np.int64), "g1": np.arange(20, dtype=np.int64)},
                         os.path.join(base, "dim1"))
    pair.t.write_parquet({"d2": np.arange(10, dtype=np.int64), "g2": np.arange(10, dtype=np.int64)},
                         os.path.join(base, "dim2"))
    from hyperspace_tpu import IndexConfig as JaxIndexConfig
    from hyperspace_tpu.engine import col as jax_col
    from hyperspace_tpu.engine import physical as jax_physical
    from hyperspace_tpu.hyperspace import Hyperspace as JaxHyperspace
    from hyperspace_tpu.hyperspace import enable_hyperspace as jax_enable

    plans = []
    for s, hs_cls, cfg, col, enable in ((pair.t, hst.Hyperspace, hst.IndexConfig, hst.col, hst.enable_hyperspace),
                                        (pair.j, JaxHyperspace, JaxIndexConfig, jax_col, jax_enable)):
        s.conf.set("hyperspace.system.path", os.path.join(base, type(s).__module__.split(".")[0], "idx"))
        s.conf.set("hyperspace.index.num.buckets", 4)
        hs = hs_cls(s)
        hs.create_index(s.read.parquet(os.path.join(base, "dim1")), cfg("mk1", ["d1"], ["g1"]))
        hs.create_index(s.read.parquet(os.path.join(base, "dim2")), cfg("mk2", ["d2"], ["g2"]))
        enable(s)
        f, d1, d2 = (s.read.parquet(os.path.join(base, n)) for n in ("fact", "dim1", "dim2"))
        plans.append(f.join(d1, col("k1") == col("d1")).join(d2, col("k2") == col("d2"))
                     .group_by("g1").agg(t=("v", "sum")).physical_plan())
    plan, jplan = plans
    assert any(isinstance(n, physical.MultiwayJoinExec) for n in plan.collect_nodes())
    assert any(isinstance(n, jax_physical.MultiwayJoinExec) for n in jplan.collect_nodes())
    st = costmodel.collect_stats(plan)
    assert st.has_join and st.star_dims == 2
    n_rels = len({id(n.relation) for n in plan.collect_nodes() if getattr(n, "relation", None) is not None})
    assert st.n_scans == n_rels
    _same_stats(st, jax_costmodel.collect_stats(jplan))


def test_multiway_env_pin_reported_not_decided(pair, monkeypatch):
    src = pair.source()
    monkeypatch.setenv("HYPERSPACE_MULTIWAY", "0")
    pd = planner.decide(_agg(pair.t, src).physical_plan(), "fp-mw")
    assert pd.decisions["multiway"].source == "pinned"
    assert pd.value("multiway") is None
    assert jax_planner.decide(_agg(pair.j, src).physical_plan(), "fp-mw").decisions["multiway"].source == "pinned"


def test_decide_never_raises(pair, monkeypatch):
    """A broken model never breaks the query: decide gives None, the gates
    answer their defaults and the rows stand."""
    src = pair.source()

    def broken(phys):
        raise HyperspaceException("model bug")

    monkeypatch.setattr(costmodel, "collect_stats", broken)
    assert planner.decide(_agg(pair.t, src).physical_plan(), None) is None
    assert _agg(pair.t, src).collect().sorted_rows() == _agg(pair.j, src).collect().sorted_rows()


def test_activity_counts_decided_knobs(pair, monkeypatch):
    src = pair.source()
    monkeypatch.setenv("HYPERSPACE_MULTIWAY", "1")
    _agg(pair.t, src).collect()
    _agg(pair.t, src).count()
    act = planner.activity_summary()
    assert set(act) == set(costmodel.KNOBS) - {"multiway"}
    assert all(a == {"decisions": 2, "explorations": 0, "measured_flips": 0} for a in act.values())


# -- ROADMAP Queue 3: the warm streamed aggregate -------------------------------


def test_a_warm_aggregate_streams_the_jax_packages_chunks(tmp_path, monkeypatch):
    monkeypatch.setenv("HYPERSPACE_FORCE_DEVICE_OPS", "1")  # the JAX device program's group order
    rng = np.random.RandomState(11)
    src = str(tmp_path / "src")
    os.makedirs(src)
    rows = 600_000
    for i in range(2):
        cols = {"g": rng.randint(0, 100, rows).astype(np.int64), "p": rng.rand(rows) * 1000}
        for j in range(18):
            cols[f"f{j:02d}"] = rng.rand(rows)
        pq.write_table(pa.table(cols), os.path.join(src, f"part-{i:05d}.parquet"))
    pair = Pair(tmp_path)
    _clear_caches()
    runs = {}
    for name, s, stages in (("torch", pair.t, last_query_stages), ("jax", pair.j, jax_last_query_stages)):
        runs[name] = []
        for _ in range(2):  # cold, then warm
            out = s.read.parquet(src).group_by("g").agg(s=("p", "sum"), c=("*", "count")).collect()
            runs[name].append((stages()["chunks"], out))
    assert [c for c, _ in runs["torch"]] == [c for c, _ in runs["jax"]] == [2, 4]
    for (_, got), (_, want) in zip(runs["torch"], runs["jax"]):
        assert_same(got, want)  # float sums bit for bit
    chunk = planner.last_decisions().decisions["chunk_rows"]
    assert chunk.value == 524_288 and chunk.source == "model"
    cold, warm = (r.to_pydict() for _, r in runs["torch"])
    assert cold["c"] == warm["c"] and sum(c for c in cold["c"]) == 2 * rows
    assert sum(a != b for a, b in zip(cold["s"], warm["s"])) > 0  # the re-chunk moves float sums


# -- the size-classes knob runs the layout it names -----------------------------


def _join_lake(base):
    """A port session over two sources under covering indexes on their keys,
    and a co-bucketed join of them (value mode)."""
    rng = np.random.RandomState(5)
    paths = {t: os.path.join(str(base), t) for t in ("l", "r")}
    s = hst.HyperspaceSession(warehouse=str(base), device="cpu")
    s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, 4)
    s.write_parquet({"k": rng.randint(0, 50, 800).astype(np.int64), "v": rng.randint(0, 9, 800)}, paths["l"])
    s.write_parquet({"k2": np.arange(50, dtype=np.int64), "w": rng.rand(50)}, paths["r"])
    hs = hst.Hyperspace(s)
    hs.create_index(s.read.parquet(paths["l"]), hst.IndexConfig("pL", ["k"], ["v"]))
    hs.create_index(s.read.parquet(paths["r"]), hst.IndexConfig("pR", ["k2"], ["w"]))
    hst.enable_hyperspace(s)
    return s, lambda: s.read.parquet(paths["l"]).join(s.read.parquet(paths["r"]), hst.col("k") == hst.col("k2"))


def _pad_growth(run) -> dict:
    """Bytes each join layout's pad site recorded while `run()` ran, with the
    join memos emptied first."""
    from hyperspace_tpu_torch.telemetry import metrics

    def pads():
        return {site: sum(metrics.counter(f"pad.{site}.bytes_{p}").value for p in ("payload", "padded"))
                for site in ("join_buckets", "join_class")}

    _clear_caches()
    before = pads()
    run()
    return {site: n - before[site] for site, n in pads().items()}


def test_a_decision_against_size_classes_runs_the_dense_layout(tmp_path):
    """Inside `decisions_scope`, `join_size_classes = False` pads the dense
    layout ("join_buckets") and not the classes ("join_class"); with the
    flag unset and no decision in scope, the classes run."""
    s, q = _join_lake(tmp_path)
    expect = q().sorted_rows()
    pd = planner.PlanDecisions(None, {"join_size_classes": planner.Decision(
        "join_size_classes", False, True, 0.0, 0.0, "model")})
    got = {}

    def in_scope():
        with planner.decisions_scope(pd):
            phys = q().physical_plan()
            got["rows"] = phys.execute(physical.ExecContext(s)).sorted_rows()
            got["count"] = phys.execute_count(physical.ExecContext(s))

    grown = _pad_growth(in_scope)
    assert grown["join_buckets"] > 0 and grown["join_class"] == 0
    assert got["rows"] == expect and got["count"] == len(expect)
    grown = _pad_growth(lambda: got.update(rows=q().sorted_rows()))
    assert grown["join_class"] > 0 and grown["join_buckets"] == 0
    assert got["rows"] == expect
    assert planner.last_decisions().decisions["join_size_classes"].value is True


def test_measured_stage_subtotals_flip_the_join_to_the_dense_layout(tmp_path, monkeypatch):
    """The outcome store's stage subtotals (the knob's pad, probe and verify
    stages) measure the classes' arm 4x dearer at equal walls: the planner
    flips `join_size_classes` off for this plan's class, and the query then
    runs the dense layout (tests/test_stage_attribution.py:285-323)."""
    from hyperspace_tpu_torch.plananalysis import fingerprint

    s, q = _join_lake(tmp_path)
    expect = q().sorted_rows()
    monkeypatch.setenv(planner.ENV_MIN_SAMPLES, "2")
    monkeypatch.setenv(planner.ENV_PLANNER_DIR, str(tmp_path / "store"))
    planner.reset()
    fp = fingerprint.plan_fingerprint(q().physical_plan())
    store = planner._outcome_store()
    for _ in range(2):
        store.observe(fp, {"join_size_classes": {"arm": "on", "wall_s": 1.0, "predicted_s": 0.01, "stage_s": 0.08}})
        store.observe(fp, {"join_size_classes": {"arm": "off", "wall_s": 1.0, "predicted_s": 0.02, "stage_s": 0.02}})
    got = {}
    grown = _pad_growth(lambda: got.update(rows=q().sorted_rows()))
    d = planner.last_decisions().decisions["join_size_classes"]
    assert (d.value, d.source) == (False, "measured") and planner.last_decisions().fingerprint == fp
    assert grown["join_buckets"] > 0 and grown["join_class"] == 0
    assert got["rows"] == expect

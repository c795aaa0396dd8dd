"""The port's SLO monitor against the JAX package's
(`hyperspace_tpu/telemetry/slo.py`).

The same observations, at the same clock readings (both modules read a fake
monotonic clock here), give equal `summary()` dicts, equal `burn_rate`s and
equal `compliance_over` verdicts; floats are rounded by both modules the same
way and compared exactly. The env knobs give the same objectives and target.
The serving layer feeds the monitor at every completion, in the concurrent
and the `HYPERSPACE_SERVING=0` paths, a failure as a violation; a fast burn
ticks `slo.fast_burn_alerts`, warns once and asks for a profile capture.
"""

import types
import warnings

import numpy as np
import pytest

from hyperspace_tpu.telemetry import slo as jax_slo
from hyperspace_tpu_torch.serve import QueryServer
from hyperspace_tpu_torch.telemetry import device_observatory as dv
from hyperspace_tpu_torch.telemetry import exporter, metrics, slo

SLO_ENVS = ("HYPERSPACE_SLO_TARGET", "HYPERSPACE_SLO_INTERACTIVE_P99_MS", "HYPERSPACE_SLO_BATCH_P99_MS",
            "HYPERSPACE_SLO_REPORT_P99_MS", "HYPERSPACE_SERVING")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in SLO_ENVS:
        monkeypatch.delenv(k, raising=False)
    slo.reset()
    yield
    slo.reset()


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def monotonic(self):
        return self.t


@pytest.fixture()
def clock(monkeypatch):
    """One fake monotonic clock for both modules."""
    c = Clock()
    fake = types.SimpleNamespace(monotonic=c.monotonic, time=c.monotonic)
    monkeypatch.setattr(slo, "time", fake)
    monkeypatch.setattr(jax_slo, "time", fake)
    return c


def _observations(seed, n=300):
    """(dt, lane, wall_s, tenant, failed): two lanes, four tenants, walls
    around each lane's objective, a few failures, spread over ~2 hours so
    both windows cut."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lane = ("interactive", "batch", "report")[rng.randint(0, 3)]
        scale = {"interactive": 0.25, "batch": 5.0, "report": 5.0}[lane]
        out.append((float(rng.exponential(25.0)), lane, float(rng.rand() * 1.6 * scale),
                    None if rng.rand() < 0.1 else f"t{rng.randint(0, 4)}", bool(rng.rand() < 0.03)))
    return out


def _feed(monitors, obs, clock):
    for dt, lane, wall, tenant, failed in obs:
        clock.t += dt
        for m in monitors:
            m.observe(lane, wall, tenant, failed=failed)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_same_observations_give_the_jax_packages_summary_and_burn_rates(clock, seed):
    mine, theirs = slo.SLOMonitor(), jax_slo.SLOMonitor()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        _feed((mine, theirs), _observations(seed), clock)
    got, want = mine.summary(), theirs.summary()
    assert got == want and set(got) == {"interactive", "batch", "report"}
    for lane in got:
        assert got[lane]["total"] == sum(t["total"] for t in got[lane]["tenants"].values()) + sum(
            1 for _, ln, _, tn, _ in _observations(seed) if ln == lane and tn is None)
        for window_s, _ in slo.WINDOWS:
            assert mine.burn_rate(lane, window_s) == theirs.burn_rate(lane, window_s)
    assert mine.burn_rate("nothing", 300.0) is None and theirs.burn_rate("nothing", 300.0) is None


def test_a_window_older_than_its_span_reads_none(clock):
    mine, theirs = slo.SLOMonitor(), jax_slo.SLOMonitor()
    _feed((mine, theirs), [(0.0, "interactive", 0.1, "a", False)], clock)
    clock.t += 4000.0
    assert mine.burn_rate("interactive", 300.0) is None and theirs.burn_rate("interactive", 300.0) is None
    got = mine.summary()
    assert got == theirs.summary() and "burn_5m" not in got["interactive"] and got["interactive"]["total"] == 1


@pytest.mark.parametrize("env", [{}, {"HYPERSPACE_SLO_TARGET": "0.95"},
                                 {"HYPERSPACE_SLO_INTERACTIVE_P99_MS": "40", "HYPERSPACE_SLO_REPORT_P99_MS": "900"},
                                 {"HYPERSPACE_SLO_TARGET": "2", "HYPERSPACE_SLO_BATCH_P99_MS": "-3"}])
def test_objectives_and_target_follow_the_same_knobs(clock, monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for lane in ("interactive", "batch", "report", "custom"):
        assert slo.objective_ms(lane) == jax_slo.objective_ms(lane)
    assert slo.target() == jax_slo.target()
    mine, theirs = slo.SLOMonitor(), jax_slo.SLOMonitor()
    _feed((mine, theirs), _observations(7, n=80), clock)
    assert mine.summary() == theirs.summary()


@pytest.mark.parametrize("seed", [0, 3])
def test_compliance_over_stored_ledgers_equals_the_jax_packages(seed):
    rng = np.random.RandomState(seed)
    records = []
    for i in range(200):
        led = {"lane": ("interactive", "batch", None)[rng.randint(0, 3)], "wall_s": float(rng.rand() * 0.5)}
        if rng.rand() < 0.05:
            led["status"] = "error"
        if rng.rand() < 0.05:
            led["wall_s"] = "n/a"
        records.append(led)
    got = slo.compliance_over(records)
    assert got == jax_slo.compliance_over(records) and set(got) == {"interactive", "batch"}
    assert slo.compliance_over([]) == jax_slo.compliance_over([]) == {}


def test_a_fast_burn_alerts_warns_once_and_asks_for_a_capture(clock, monkeypatch):
    captures = []
    monkeypatch.setattr(dv, "maybe_capture", lambda reason, detail=None: captures.append((reason, detail)))
    mine = slo.SLOMonitor()
    before = metrics.counter("slo.fast_burn_alerts").value
    with pytest.warns(RuntimeWarning, match="fast-burning") as rec:
        for _ in range(45):
            clock.t += 0.01
            mine.observe("interactive", 0.01, "t", failed=True)
    assert len([w for w in rec if "fast-burning" in str(w.message)]) == 1
    assert metrics.counter("slo.fast_burn_alerts").value - before == 2  # at the 20th and 40th completions
    assert [c[0] for c in captures] == ["slo_fast_burn", "slo_fast_burn"]
    assert captures[0][1] == {"lane": "interactive", "burn": 100.0, "window": "5m"}
    assert mine.summary()["interactive"]["fast_burn"] is True


def test_the_server_feeds_each_completion_to_the_monitor(monkeypatch):
    # Objectives no loaded host can miss: the one violation is the failure.
    monkeypatch.setenv("HYPERSPACE_SLO_INTERACTIVE_P99_MS", "600000")
    monkeypatch.setenv("HYPERSPACE_SLO_BATCH_P99_MS", "600000")
    with QueryServer(max_concurrent=2) as srv:
        assert srv.run(lambda: 1, tenant="a", lane="interactive") == 1
        assert srv.run(lambda: 2, tenant="b") == 2

        def boom():
            raise RuntimeError("failed query")

        with pytest.raises(RuntimeError):
            srv.submit(boom, tenant="a", lane="interactive").result(10)
    monkeypatch.setenv("HYPERSPACE_SERVING", "0")
    srv = QueryServer()
    srv.submit(lambda: 3, tenant="c", lane="interactive")
    srv.close()
    got = slo.summary()
    assert (got["interactive"]["total"], got["interactive"]["violations"]) == (3, 1)
    assert got["interactive"]["tenants"] == {
        "a": {"total": 2, "violations": 1, "compliance": 0.5},
        "c": {"total": 1, "violations": 0, "compliance": 1.0},
    }
    assert got["batch"]["total"] == 1 and got["batch"]["tenants"]["b"]["violations"] == 0
    text = exporter.prometheus_text()
    assert 'hyperspace_slo_total{lane="interactive"} 3' in text
    assert 'hyperspace_slo_violations{lane="interactive"} 1' in text
    assert 'hyperspace_slo_objective_ms{lane="batch"} 600000.0' in text
    frame = exporter.MetricsExporter("unused.jsonl", 60.0)._frame()
    assert {lane: (v["total"], v["violations"], v["tenants"]) for lane, v in frame["slo"].items()} == {
        lane: (v["total"], v["violations"], v["tenants"]) for lane, v in got.items()}

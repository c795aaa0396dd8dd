"""A CPU rehearsal of each cell at a tiny scale through the port's own
session and server, judged by the harness as on the card; then the same run
with its timed path broken underneath, which must come out not correct, and
the control, which must too."""

import numpy as np
import pytest
from conftest import CELLS, SEED, TPCDS, TPCH, tiny_cell

from lakebench import run as run_cmd
from lakebench.control import control_run
from lakebench.harness import Run


def rehearse(tmp_path, name, trace=False, fault=None, monkeypatch=None, seconds=1.5):
    cell = tiny_cell(name)
    cell.mix = dict(cell.mix, warmup_rounds=1)
    if trace:
        monkeypatch.setenv("HYPERSPACE_TRACING", "1")
        monkeypatch.setenv("HYPERSPACE_TRACE_FILE", str(tmp_path / "spans.jsonl"))
    run = Run(cell, SEED, seconds, trace, str(tmp_path / "run"), "cpu")
    run.setup()
    if fault == "plan":
        import hyperspace_tpu_torch as hst

        hst.disable_hyperspace(run.session)
    elif fault is not None:
        from hyperspace_tpu_torch.engine.session import DataFrame

        real = DataFrame.collect
        monkeypatch.setattr(DataFrame, "collect", lambda self: _Broken(real(self), fault))
    run.measure()
    run.release()
    run.check_plans()
    run.judge()
    if trace:
        run.load_spans(str(tmp_path / "spans.jsonl"))
    return run


class _Broken:
    """A collected table whose rows are altered where the query produced
    them."""

    def __init__(self, table, fault):
        self.table, self.fault = table, fault

    def to_numpy(self):
        out = self.table.to_numpy()
        n = len(next(iter(out.values())))
        if self.fault == "half" and n > 1:
            return {k: v[: n // 2] for k, v in out.items()}
        if self.fault == "answer" and n:
            measure = list(out)[-1] if "revenue" not in out else "revenue"
            v = np.array(out[measure], copy=True)
            v[0] = v[0] * (1 + 1e-6) if v.dtype.kind == "f" else v[0] + 1
            out[measure] = v
        return out


@pytest.mark.parametrize("name", CELLS)
def test_a_tiny_run_through_the_port_is_correct(tmp_path, name, monkeypatch):
    run = rehearse(tmp_path, name, trace=True, monkeypatch=monkeypatch)
    assert run.correct(), run.checks()
    assert len(run.queries) >= 3 and run.failed() == 0
    e2e = run.end_to_end()
    assert {"qps", "p50_ms", "setup_s"} <= set(e2e) and e2e["qps"]["value"] > 0
    layers = run.per_layer()
    assert {"plan_ms", "decode_files_per_query", "index_build_s", "device_idle_share"} <= set(layers)
    assert layers["device_idle_share"]["value"] == 100.0  # a CPU run launches nothing on a card
    assert run.stretch_queries and all(run.trace_of(q) for q in run.stretch_queries)
    line = run_cmd.result_line(run, "cpu")
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes", "busy_s", "window_s"}
    for key in ("device_ops", "idle_gaps"):
        assert len(line["breakdown"][key]) <= 10
        assert all(isinstance(n, str) and isinstance(s, float) for n, s in line["breakdown"][key])
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault,reading", [("answer", None), ("half", "wrong_answers"), ("plan", "plan_misses")])
def test_a_broken_timed_path_is_not_correct(tmp_path, name, fault, reading, monkeypatch):
    run = rehearse(tmp_path, name, fault=fault, monkeypatch=monkeypatch, seconds=1.0)
    assert not run.correct()
    checks = run.checks()
    if reading is None:  # an altered sum: the measure's error passes its limit, or the rows reorder
        assert (checks["measure_rel_err"]["value"] > checks["measure_rel_err"]["limit"]
                or checks["wrong_answers"]["value"] > 0)
    else:
        assert checks[reading]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """The reference one precision down, in the program's place, at a size
    whose sums pass float32's exact range."""
    cell = tiny_cell(name, ss_rows=3_000_000)
    if name == TPCH:
        cell.config["scale_factor"] = 0.05
    run = control_run(cell, SEED, 150)
    assert not run.correct()
    assert run.checks()["measure_rel_err"]["value"] > run.checks()["measure_rel_err"]["limit"]


def test_a_trace_0_line_carries_the_end_to_end_metrics(tmp_path, monkeypatch):
    run = rehearse(tmp_path, TPCDS, monkeypatch=monkeypatch, seconds=1.0)
    line = run_cmd.result_line(run, "cpu")
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["metrics"]) == {m["name"] for m in run.cell.end_to_end}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())

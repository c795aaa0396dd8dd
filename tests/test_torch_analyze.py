"""`explain(analyze=True)` in the port against the JAX package.

The same lakes (parquet files written once, each package building its own
covering indexes) go through both packages' `DataFrame.explain(analyze=True)`,
cold and then warm, on an indexed filter, an indexed join under a grouped
aggregate and a two-dimension star join. The JAX package runs its device
program (`HYPERSPACE_FORCE_DEVICE_OPS=1`, `HYPERSPACE_DISTRIBUTED=0`), whose
operator structure the port keeps. Each run must give, in both packages:

- the same annotated tree, line for line, once every measured time (and the
  overlap ratio, a ratio of two times) is a placeholder, the index paths are
  the system path's, and the JAX package's XLA compile bill
  (`compiles=N(+t)`, a compile of a traced shape that the port's prebuilt
  kernels never do) is dropped;
- the same rule decisions (rule, applied, reason, indexes and the rest);
- the same `plan_fingerprint`, on the ledger and computed from the plan;
- the same `op:` spans with the same parent spans;
- the same ledger `rows_produced`, `decode_files` and `bytes_decoded`;
- the same cache verdicts (`bucketed_cache`, `pairs_memo`) on the same
  operators.

Tolerance: exact, after the masking above.
"""

import os
import re
from collections import Counter

import numpy as np
import pytest

from hyperspace_tpu.engine import physical as jax_physical
from hyperspace_tpu.engine import scan_cache as jax_scan_cache
from hyperspace_tpu.plananalysis import fingerprint as jax_fingerprint
from hyperspace_tpu.telemetry import accounting as jax_accounting
from hyperspace_tpu.telemetry import tracing as jax_tracing
from hyperspace_tpu_torch.engine import physical, scan_cache
from hyperspace_tpu_torch.plananalysis import fingerprint
from hyperspace_tpu_torch.telemetry import accounting, metrics, tracing
from test_torch_star_join import _q2, _star2, make_star
from test_torch_udf_setops import Twin

SINK_ENVS = ("HYPERSPACE_TRACE_FILE", "HYPERSPACE_TRACING", "HYPERSPACE_TIMELINE_DIR", "HYPERSPACE_ACCOUNTING",
             "HYPERSPACE_DEVICE_TIMING", "HYPERSPACE_STAGE_ATTRIBUTION", "HYPERSPACE_HISTORY",
             "HYPERSPACE_PLANNER_DIR", "HYPERSPACE_METRICS_FILE")


def clear_caches():
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()
    for cache in (jax_scan_cache.global_scan_cache, jax_scan_cache.global_bucketed_cache,
                  jax_scan_cache.global_concat_cache, jax_scan_cache.global_filtered_cache):
        cache().clear()
    jax_physical.clear_device_memos()


@pytest.fixture(autouse=True)
def _reference_path(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    monkeypatch.setenv("HYPERSPACE_FORCE_DEVICE_OPS", "1")
    for k in SINK_ENVS + ("HYPERSPACE_QUERY_STREAMING", "HYPERSPACE_MULTIWAY"):
        monkeypatch.delenv(k, raising=False)
    clear_caches()
    tracing.reset()
    accounting.reset()


def mask(text: str, p) -> str:
    text = text.replace(p.idx, "<indexes>")
    text = re.sub(r", compiles=\d+\(\+[^)]*\)", "", text)
    text = re.sub(r"\d+(\.\d+)?(ms|s)\b", "<t>", text)
    text = re.sub(r"overlap=[\d.]+", "overlap=<r>", text)
    return re.sub(r"query_id=\w+", "query_id=<q>", text)


def tree_lines(text: str, p):
    return mask(text.split("\nRule decisions:")[0], p).splitlines()


class Run:
    """One package's analyzed run: its text, trace and closed ledger."""

    def __init__(self, p, df):
        self.p = p
        self.text = df.explain(analyze=True)
        mods = (tracing, accounting) if p.name == "torch" else (jax_tracing, jax_accounting)
        self.trace = mods[0].last_trace()
        self.ledger = mods[1].ledger_for(self.trace.query_id).to_dict()
        self.fp = (fingerprint if p.name == "torch" else jax_fingerprint).plan_fingerprint(df.physical_plan())

    def decisions(self):
        return [d for s in self.trace.spans if s.name.startswith("rule:") for d in s.attrs.get("decisions", ())]

    def op_edges(self):
        by_id = {s.span_id: s for s in self.trace.spans}
        return Counter((s.name, by_id[s.parent_id].name) for s in self.trace.spans if s.name.startswith("op:"))

    def verdicts(self):
        return Counter((s.name, k, s.attrs[k]) for s in self.trace.spans for k in ("bucketed_cache", "pairs_memo")
                       if k in s.attrs)


def check_same(twin, q):
    """Both packages' analyzed runs of `q` agree; returns the port's run."""
    t, j = Run(twin.t, q(twin.t)), Run(twin.j, q(twin.j))
    assert tree_lines(t.text, twin.t) == tree_lines(j.text, twin.j)
    assert t.decisions() == j.decisions()
    assert t.ledger["plan_fingerprint"] == j.ledger["plan_fingerprint"] == t.fp == j.fp
    assert t.op_edges() == j.op_edges()
    for key in ("rows_produced", "decode_files", "bytes_decoded"):
        assert t.ledger.get(key, 0) == j.ledger.get(key, 0), key
    assert t.verdicts() == j.verdicts()
    return t


def indexed_lake(tmp_path, parts=2):
    twin = Twin(tmp_path, buckets=4)
    rng = np.random.RandomState(4)
    for i in range(parts):
        twin.write("l", {"k": rng.randint(0, 40, 3000).astype(np.int64),
                         "qty": rng.randint(1, 9, 3000).astype(np.int64)}, f"part-{i:05d}.parquet")
    twin.write("r", {"k2": np.arange(40, dtype=np.int64), "w": np.arange(40, dtype=np.int64) % 7})
    for p in (twin.t, twin.j):
        p.index("l", "li", ["k"], ["qty"])
        p.index("r", "ri", ["k2"], ["w"])
        p.on(p.s)
    return twin


def q_filter(p):
    return p.read("l").filter(p.col("k") == 5).select("k", "qty")


def q_join_agg(p):
    return p.read("l").join(p.read("r"), p.col("k") == p.col("k2")).group_by("w").agg(s=("qty", "sum"))


@pytest.mark.parametrize("q", [q_filter, q_join_agg], ids=["indexed_filter", "indexed_join_agg"])
def test_analyzed_runs_equal_the_jax_package_cold_and_warm(tmp_path, q):
    twin = indexed_lake(tmp_path)
    cold = check_same(twin, q)
    assert cold.ledger["rows_produced"] == q(twin.t).count() > 0
    warm = check_same(twin, q)
    assert warm.ledger.get("decode_files", 0) == 0
    assert "[not executed" not in "\n".join(tree_lines(cold.text, twin.t)[6:7])


def test_join_agg_tree_marks_the_fused_join_and_reports_cache_verdicts(tmp_path):
    twin = indexed_lake(tmp_path)
    lines = tree_lines(check_same(twin, q_join_agg).text, twin.t)
    join = next(ln for ln in lines if "SortMergeJoin" in ln)
    assert "[not executed" in join
    assert sum("bucketed_cache=miss" in ln for ln in lines) == 2
    lines = tree_lines(check_same(twin, q_join_agg).text, twin.t)
    assert sum("bucketed_cache=hit" in ln for ln in lines) == 2


def test_star_runs_equal_the_jax_package_and_render_per_dimension_walls(tmp_path):
    fact, dims = _star2()
    twin = make_star(tmp_path, fact, dims)
    run = check_same(twin, _q2())
    lines = tree_lines(run.text, twin.t)
    star = next(ln for ln in lines if "MultiwayJoin" in ln)
    assert "[not executed" in star
    assert "mode=star-stream" in "\n".join(lines)
    assert sum(ln.strip().startswith("dim[") for ln in lines) == 2
    assert all("memo=miss" in ln for ln in lines if ln.strip().startswith("dim["))
    cascade = [ln for ln in lines if "SortMergeJoin" in ln]
    assert cascade and all("[not executed" in ln for ln in cascade)
    warm = tree_lines(check_same(twin, _q2()).text, twin.t)
    assert all("memo=hit" in ln for ln in warm if ln.strip().startswith("dim["))


def test_analyze_sections_and_rows_equal_collect(tmp_path):
    twin = indexed_lake(tmp_path)
    p = twin.t
    text = q_join_agg(p).explain(analyze=True)
    for section in ("Rule decisions:", "Planner:", "Resource ledger (this query):", "Device cost (this query):",
                    "Kernel launches (this query):", "Cache/metric deltas (process-wide during this query):"):
        assert section in text
    n = q_join_agg(p).collect().num_rows
    assert f"rows={n}" in text.splitlines()[3]
    assert "JoinIndexRule: applied" in text
    assert "(none — no CUDA kernel ran" in text


def test_explain_analyze_leaves_the_default_path_untraced(tmp_path):
    """A later collect, with no sink, records no trace and no ledger."""
    twin = indexed_lake(tmp_path)
    p = twin.t
    q_filter(p).explain(analyze=True)
    n_traces, n_ledgers = len(tracing.recent_traces()), len(accounting.recent_ledgers())
    rows = q_filter(p).collect().sorted_rows()
    assert (len(tracing.recent_traces()), len(accounting.recent_ledgers())) == (n_traces, n_ledgers)
    assert rows == q_filter(twin.j).collect().sorted_rows()


def test_rule_failure_is_a_skipped_decision_and_an_event(tmp_path, monkeypatch):
    """A rule that raises: the query keeps its plan, the failure is a
    skipped decision on the analyzed tree and a `HyperspaceRuleFailureEvent`
    through the configured logger, in both packages."""
    from hyperspace_tpu.rules import filter_index_rule as jax_rule
    from hyperspace_tpu.telemetry.event_logging import EventLoggerFactory as JaxFactory
    from hyperspace_tpu_torch.rules import filter_index_rule
    from hyperspace_tpu_torch.telemetry.event_logging import EventLoggerFactory

    twin = indexed_lake(tmp_path)

    def boom(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(filter_index_rule, "get_candidate_indexes", boom)
    monkeypatch.setattr(jax_rule, "get_candidate_indexes", boom)
    key = "hyperspace.eventLoggerClass"
    twin.t.s.conf.set(key, "hyperspace_tpu_torch.telemetry.event_logging.RecordingEventLogger")
    twin.j.s.conf.set(key, "hyperspace_tpu.telemetry.event_logging.RecordingEventLogger")
    EventLoggerFactory.reset()
    JaxFactory.reset()
    decisions = []
    for p, factory, mod, pkg in ((twin.t, EventLoggerFactory, tracing, "hyperspace_tpu_torch"),
                                 (twin.j, JaxFactory, jax_tracing, "hyperspace_tpu")):
        q_filter(p).explain(analyze=True)
        decisions.append([d for s in mod.last_trace().spans if s.name.startswith("rule:")
                          for d in s.attrs.get("decisions", ())])
        events = factory.get_logger(f"{pkg}.telemetry.event_logging.RecordingEventLogger").events
        assert [(e.name, e.rule_name) for e in events] == [("HyperspaceRuleFailureEvent", "FilterIndexRule")]
    assert decisions[0] == decisions[1] == [
        {"rule": "FilterIndexRule", "applied": False, "reason": "error: RuntimeError: boom"}]
    assert q_filter(twin.t).collect().sorted_rows() == q_filter(twin.j).collect().sorted_rows()
    EventLoggerFactory.reset()
    JaxFactory.reset()


def test_usage_and_crud_events_match_the_jax_package(tmp_path):
    """Create logs its start and success; an applied rewrite one usage
    event naming its indexes; a bad logger path falls back to the no-op
    logger; in both packages alike."""
    from hyperspace_tpu.telemetry.event_logging import EventLoggerFactory as JaxFactory
    from hyperspace_tpu_torch.telemetry.event_logging import EventLoggerFactory, NoOpEventLogger

    twin = Twin(tmp_path, buckets=4)
    twin.write("l", {"k": np.arange(50, dtype=np.int64), "qty": np.arange(50, dtype=np.int64)})
    key = "hyperspace.eventLoggerClass"
    got = []
    for p, pkg, factory in ((twin.t, "hyperspace_tpu_torch", EventLoggerFactory), (twin.j, "hyperspace_tpu", JaxFactory)):
        factory.reset()
        path = f"{pkg}.telemetry.event_logging.RecordingEventLogger"
        p.s.conf.set(key, path)
        p.index("l", "ev", ["k"], ["qty"])
        p.on(p.s)
        q_filter(p).collect()
        got.append([(e.name, getattr(e, "index_name", None), getattr(e, "index_names", None), e.message)
                    for e in factory.get_logger(path).events])
        factory.reset()
    assert got[0] == got[1]
    assert [g[0] for g in got[0]] == ["CreateActionEvent"] * 2 + ["HyperspaceIndexUsageEvent"]
    assert isinstance(EventLoggerFactory.get_logger("no.such.Logger"), NoOpEventLogger)
    EventLoggerFactory.reset()


def test_metrics_rule_counters_tick_per_decision(tmp_path):
    twin = indexed_lake(tmp_path)
    before = metrics.snapshot()
    q_filter(twin.t).collect()
    delta = metrics.counters_delta(before, metrics.snapshot())
    assert delta.get("rule.FilterIndexRule.applied") == 1

"""Row-group pushdown in the port against the JAX package.

The shapes of `tests/test_scan_pushdown.py`, through both packages over the
same files (written once by the port): the zone decision of every conjunct
shape, the row groups each file keeps, and the rows a filtered scan returns
with `HYPERSPACE_SCAN_PUSHDOWN` on and off. Each run starts cold (every scan
cache and memo cleared), so the pushdown run really decodes the kept row
groups only. Nothing is computed on the values: the tolerance is 0, and rows
must come in the same order.
"""

import itertools
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu_torch as hst
from hyperspace_tpu import IndexConfig as JaxIndexConfig
from hyperspace_tpu import IndexConstants as JaxIndexConstants
from hyperspace_tpu.engine import HyperspaceSession as JaxSession
from hyperspace_tpu.engine import col as jax_col
from hyperspace_tpu.engine import io as jax_io
from hyperspace_tpu.engine import pushdown as jax_pushdown
from hyperspace_tpu.hyperspace import Hyperspace as JaxHyperspace
from hyperspace_tpu.hyperspace import enable_hyperspace as jax_enable
from hyperspace_tpu.telemetry import metrics as jax_metrics
from hyperspace_tpu_torch.engine import io as torch_io
from hyperspace_tpu_torch.engine import physical as torch_physical
from hyperspace_tpu_torch.engine import pushdown as torch_pushdown
from hyperspace_tpu_torch.engine import scan_cache as torch_scan_cache
from hyperspace_tpu_torch.engine.table import Table

ENV = "HYPERSPACE_SCAN_PUSHDOWN"


def clear_all():
    """Every scan cache and memo of both packages."""
    from hyperspace_tpu.engine.physical import clear_device_memos
    from hyperspace_tpu.engine.scan_cache import (
        global_bucketed_cache,
        global_concat_cache,
        global_filtered_cache,
        global_scan_cache,
    )

    for c in (global_scan_cache(), global_concat_cache(), global_filtered_cache(), global_bucketed_cache()):
        c.clear()
    clear_device_memos()
    torch_scan_cache.clear_scan_caches()
    torch_physical.clear_device_memos()


def rows(t) -> list:
    cols = [np.asarray(c.decode_objects(), dtype=object) for c in t.columns.values()]
    return list(zip(*cols))


def _pruning():
    s = torch_io.io_stats()
    return {k: s[k] for k in ("row_groups_scanned", "row_groups_skipped", "footer_misses", "footer_hits")}


def _jax_pruning():
    return {
        "row_groups_scanned": jax_metrics.counter("io.pruning.row_groups_scanned").value,
        "row_groups_skipped": jax_metrics.counter("io.pruning.row_groups_skipped").value,
    }


def _delta(after, before):
    return {k: after[k] - before[k] for k in before}


def _write_clustered(base, name, n=4000, files=2, row_groups_per_file=8):
    """Ascending-ts multi-row-group files with int, float, string and
    nullable payloads, so every filter type has tight zones."""
    per = n // files
    for i in range(files):
        ts = np.arange(i * per, (i + 1) * per, dtype=np.int64)
        nv = np.asarray([int(v) if v % 5 else None for v in ts], dtype=object)
        torch_io.write_parquet(
            Table.from_pydict({"ts": ts, "fv": ts / 10.0, "sv": np.array([f"s{v:06d}" for v in ts]), "nv": nv}, "cpu"),
            os.path.join(base, name, f"part-{i:05d}.parquet"),
            row_group_rows=per // row_groups_per_file,
        )
    return os.path.join(base, name)


@pytest.fixture()
def sessions(tmp_path):
    ts = hst.HyperspaceSession(warehouse=str(tmp_path / "torch"), device="cpu")
    ts.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, 4)
    js = JaxSession(warehouse=str(tmp_path / "jax"))
    js.conf.set(JaxIndexConstants.INDEX_NUM_BUCKETS, 4)
    return ts, js


def on_off(monkeypatch, make):
    """(rows with pushdown, rows without, the pushdown run's pruning counts),
    each run cold."""
    monkeypatch.setenv(ENV, "1")
    clear_all()
    before = _pruning()
    on = rows(make().collect())
    delta = _delta(_pruning(), before)
    monkeypatch.setenv(ENV, "0")
    clear_all()
    off = rows(make().collect())
    monkeypatch.setenv(ENV, "1")
    return on, off, delta


# ---------------------------------------------------------------------------
# The zone decision
# ---------------------------------------------------------------------------

ZONES = [
    (0, 10, True, 0), (5, 5, True, 0), (0.0, 10.0, True, 0), (1.5, 2.5, True, 2), ("a", "m", True, 0),
    (None, None, False, 0), (None, None, False, None), (0, 10, True, None), (None, None, False, 8),
    (0, 10, True, 8), (True, True, True, 0),
]
VALUES = [5, 11, -1, 5.0, 2.0, float("nan"), "c", "z", True, None, [5, 11], [], ["c", 3]]
OPS = ["==", "!=", "<", "<=", ">", ">=", "in", "isnull", "isnotnull"]


def test_zone_keeps_equals_the_reference_on_every_shape():
    """NaN, floats against ints, missing min/max, unknown and all-null null
    counts (a zone of 8 rows), constant zones, strings, bools."""
    checked = 0
    for (mn, mx, has, nulls), value, op in itertools.product(ZONES, VALUES, OPS):
        if (op == "in") != isinstance(value, list):
            continue
        got = torch_pushdown.zone_keeps(op, value, torch_pushdown.ZoneStats(mn, mx, has, nulls), 8)
        want = jax_pushdown.zone_keeps(op, value, jax_pushdown.ZoneStats(mn, mx, has, nulls), 8)
        assert got == want, (op, value, mn, mx, has, nulls)
        checked += 1
    assert checked > 300


CASES = {
    "int_range": lambda c: (c("ts") >= 700) & (c("ts") < 780),
    "float_lt": lambda c: c("fv") < 12.5,
    "float_ge": lambda c: c("fv") >= 399.9,
    "string_eq": lambda c: c("sv") == "s001234",
    "string_range": lambda c: (c("sv") > "s0030") & (c("sv") <= "s003210"),
    "not_null_and_lt": lambda c: c("nv").is_not_null() & (c("nv") < 40),
    "is_null": lambda c: c("nv").is_null() & (c("ts") > 3500),
    "ne_and_lt": lambda c: (c("ts") != 3) & (c("ts") < 9),
    "isin": lambda c: c("ts").isin([17, 2801, 9999]),
    "float_literal_on_int": lambda c: c("ts") < 250.5,
    "flipped_literal": lambda c: 3990 <= c("ts"),
    "or_prunes_nothing": lambda c: (c("ts") < 5) | (c("ts") > 3995),
    "all_pruned": lambda c: c("ts") >= 10_000_000,
    "none_pruned": lambda c: c("ts") != -1,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kept_row_groups_and_rows_equal_the_reference(sessions, tmp_path, monkeypatch, case):
    ts, js = sessions
    src = _write_clustered(str(tmp_path), "src")
    files = sorted(os.path.join(src, f) for f in os.listdir(src))
    cond_t, cond_j = CASES[case](hst.col), CASES[case](jax_col)
    pred_t = torch_pushdown.ScanPredicate.from_condition(cond_t)
    pred_j = jax_pushdown.ScanPredicate.from_condition(cond_j)
    assert (pred_t is None) == (pred_j is None)
    if pred_t is not None:
        kept_t = [pred_t.select_row_groups(torch_io.footer_metadata(f)) for f in files]
        kept_j = [pred_j.select_row_groups(jax_io.footer_metadata(f)) for f in files]
        assert kept_t == kept_j
    on, off, delta = on_off(monkeypatch, lambda: ts.read.parquet(src).filter(cond_t))
    j0 = _jax_pruning()
    want = rows(js.read.parquet(src).filter(cond_j).collect())
    assert on == off == want
    assert delta["row_groups_skipped"] == _delta(_jax_pruning(), j0)["row_groups_skipped"]
    if case == "all_pruned":
        assert on == [] and delta["row_groups_scanned"] == 0 and delta["row_groups_skipped"] == 16
    if case in ("none_pruned", "or_prunes_nothing"):
        assert delta["row_groups_scanned"] == delta["row_groups_skipped"] == 0
    if case == "int_range":
        assert len(on) == 80 and delta["row_groups_skipped"] == 14  # [500, 750) and [750, 1000) kept


def test_grouped_aggregate_group_order_is_the_same_on_and_off(sessions, tmp_path, monkeypatch):
    ts, js = sessions
    src = _write_clustered(str(tmp_path), "src")

    def q():
        return ts.read.parquet(src).filter(hst.col("ts") < 900).group_by("sv").agg(
            n=("ts", "count"), sm=("ts", "sum"))

    on, off, delta = on_off(monkeypatch, q)
    assert on == off and len(on) == 900 and delta["row_groups_skipped"] > 0


def test_single_row_group_files(sessions, tmp_path, monkeypatch):
    ts, js = sessions
    for i in range(4):
        torch_io.write_parquet(
            Table.from_pydict({"ts": np.arange(i * 500, (i + 1) * 500, dtype=np.int64)}, "cpu"),
            os.path.join(str(tmp_path), "one_rg", f"part-{i:05d}.parquet"),
        )
    src = os.path.join(str(tmp_path), "one_rg")
    on, off, delta = on_off(monkeypatch, lambda: ts.read.parquet(src).filter((hst.col("ts") >= 600) & (hst.col("ts") < 640)))
    assert on == off == rows(js.read.parquet(src).filter((jax_col("ts") >= 600) & (jax_col("ts") < 640)).collect())
    assert len(on) == 40 and delta["row_groups_scanned"] == 1 and delta["row_groups_skipped"] == 3


def test_an_all_pruned_file_keeps_the_type_promotion(sessions, tmp_path, monkeypatch):
    ts, js = sessions
    d = str(tmp_path / "mixed")
    os.makedirs(d)
    pq.write_table(pa.table({"k": pa.array(np.arange(100, dtype=np.int32))}), os.path.join(d, "part-00000.parquet"))
    pq.write_table(pa.table({"k": pa.array(np.arange(1000, 1100, dtype=np.int64))}), os.path.join(d, "part-00001.parquet"))
    monkeypatch.setenv(ENV, "1")
    clear_all()
    t_on = ts.read.parquet(d).filter(hst.col("k") >= 1000).collect()
    monkeypatch.setenv(ENV, "0")
    clear_all()
    t_off = ts.read.parquet(d).filter(hst.col("k") >= 1000).collect()
    assert rows(t_on) == rows(t_off) and t_on.column("k").dtype == t_off.column("k").dtype == "int64"
    assert rows(t_on) == rows(js.read.parquet(d).filter(jax_col("k") >= 1000).collect())


def test_a_footer_is_parsed_once_per_file(sessions, tmp_path, monkeypatch):
    ts, _ = sessions
    src = _write_clustered(str(tmp_path), "src")
    monkeypatch.setenv(ENV, "1")
    clear_all()
    c0 = _pruning()
    ts.read.parquet(src).filter(hst.col("ts") < 100).collect()
    c1 = _pruning()
    assert c1["footer_misses"] - c0["footer_misses"] == 2
    ts.read.parquet(src).filter(hst.col("ts") < 100).collect()
    ts.read.parquet(src).filter(hst.col("ts") < 200).collect()
    c2 = _pruning()
    assert c2["footer_misses"] == c1["footer_misses"] and c2["footer_hits"] > c1["footer_hits"]


def test_a_pruned_decode_never_serves_a_whole_file_read(sessions, tmp_path, monkeypatch):
    ts, _ = sessions
    src = _write_clustered(str(tmp_path), "src")
    monkeypatch.setenv(ENV, "1")
    clear_all()
    assert ts.read.parquet(src).filter(hst.col("ts") < 100).collect().num_rows == 100
    assert ts.read.parquet(src).collect().num_rows == 4000


def test_a_fault_mid_scan_leaves_no_partial_entry(sessions, tmp_path, monkeypatch):
    ts, _ = sessions
    src = _write_clustered(str(tmp_path), "src")
    monkeypatch.setenv(ENV, "1")
    clear_all()
    real = torch_io._read_arrow
    boom = {}

    def failing(path, columns, sel=None, base=None):
        if sel is not None:  # fail the first pruned decode
            boom.setdefault("path", path)
            if path == boom["path"]:
                raise OSError("injected decode fault")
        return real(path, columns, sel, base)

    monkeypatch.setattr(torch_io, "_read_arrow", failing)
    with pytest.raises(OSError, match="injected"):
        ts.read.parquet(src).filter(hst.col("ts") < 900).collect()
    names = ["ts", "fv", "sv", "nv"]
    assert torch_scan_cache.global_scan_cache().missing_columns(boom["path"], names, sel=(0, 1)) == names
    monkeypatch.setattr(torch_io, "_read_arrow", real)
    assert ts.read.parquet(src).filter(hst.col("ts") < 900).collect().num_rows == 900


def _indexed(ts, js, tmp_path, monkeypatch, rg_rows):
    monkeypatch.setenv("HYPERSPACE_INDEX_ROW_GROUP_ROWS", str(rg_rows))
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    n = 3000
    torch_io.write_parquet(
        Table.from_pydict({"okey": np.arange(n, dtype=np.int64), "qty": np.arange(n) % 9 + 1}, "cpu"),
        str(tmp_path / "li" / "part-00000.parquet"),
    )
    torch_io.write_parquet(
        Table.from_pydict({"okey2": np.arange(n, dtype=np.int64), "cust": np.arange(n) % 17}, "cpu"),
        str(tmp_path / "ord" / "part-00000.parquet"),
    )
    for s, h, cfg, enable in ((ts, hst.Hyperspace(ts), hst.IndexConfig, hst.enable_hyperspace),
                              (js, JaxHyperspace(js), JaxIndexConfig, jax_enable)):
        h.create_index(s.read.parquet(str(tmp_path / "li")), cfg("rpLi", ["okey"], ["qty"]))
        h.create_index(s.read.parquet(str(tmp_path / "ord")), cfg("rpOrd", ["okey2"], ["cust"]))
        enable(s)


def test_a_point_lookup_prunes_inside_its_bucket_file(sessions, tmp_path, monkeypatch):
    ts, js = sessions
    _indexed(ts, js, tmp_path, monkeypatch, 128)

    def q(s, c):
        return s.read.parquet(str(tmp_path / "li")).filter(c("okey") == 1234).select("qty")

    assert "rpLi" in q(ts, hst.col).explain_string()
    on, off, delta = on_off(monkeypatch, lambda: q(ts, hst.col))
    assert on == off == rows(q(js, jax_col).collect()) == [(1234 % 9 + 1,)]
    assert delta["row_groups_skipped"] > 0


def test_a_filtered_bucketed_join_reads_only_the_kept_row_groups(sessions, tmp_path, monkeypatch):
    ts, js = sessions
    _indexed(ts, js, tmp_path, monkeypatch, 256)

    def q(s, c):
        li, od = s.read.parquet(str(tmp_path / "li")), s.read.parquet(str(tmp_path / "ord"))
        return li.filter((c("okey") >= 500) & (c("okey") < 620)).join(od, c("okey") == c("okey2")).select("qty", "cust")

    plan = q(ts, hst.col).physical_plan()
    assert any(isinstance(n, torch_physical.SortMergeJoinExec) for n in plan.collect_nodes())
    on, off, delta = on_off(monkeypatch, lambda: q(ts, hst.col))
    assert on == off == rows(q(js, jax_col).collect()) and len(on) == 120
    assert delta["row_groups_skipped"] > 0

"""The general inner join in the port against the JAX package.

A join that is not two compatible covering-index scans merges the two sides'
key64 hashes whole (`ops.join.merge_join_pairs`) and verifies every candidate
pair exactly. The same seeded source files go through both packages; the JAX
package runs its single-device path (`HYPERSPACE_DISTRIBUTED=0`), and the
port must return its rows in its order with its schema: left rows in stable
sorted-key order, each with its right matches in stable sorted-key order.
Nothing is computed on the payload, so the tolerance is 0.
"""

import os

import numpy as np
import pytest
import torch

import hyperspace_tpu_torch as hst
from hyperspace_tpu import IndexConfig as JaxIndexConfig
from hyperspace_tpu import IndexConstants as JaxIndexConstants
from hyperspace_tpu.engine import HyperspaceSession as JaxSession
from hyperspace_tpu.engine import col as jax_col
from hyperspace_tpu.hyperspace import Hyperspace as JaxHyperspace
from hyperspace_tpu.hyperspace import enable_hyperspace as jax_enable
from hyperspace_tpu.ops import join as jax_join
from hyperspace_tpu_torch.engine import physical, scan_cache
from hyperspace_tpu_torch.engine.physical import (
    BucketedIndexScanExec,
    ShuffleExchangeExec,
    SortExec,
    SortMergeJoinExec,
)
from hyperspace_tpu_torch.engine.table import Table
from hyperspace_tpu_torch.ops import join as torch_join
from test_torch_aggregate import assert_same


@pytest.fixture(autouse=True)
def _single_device(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()


def _write(path, cols, parts=1):
    """`cols` as `parts` parquet files of consecutive row slices."""
    n = len(next(iter(cols.values())))
    bounds = np.linspace(0, n, parts + 1).astype(int)
    for i in range(parts):
        t = Table.from_pydict({k: v[bounds[i]: bounds[i + 1]] for k, v in cols.items()}, "cpu")
        hst.engine.io.write_parquet(t, os.path.join(path, f"part-{i:05d}.parquet"))


def _sources(seed=5, n=4000):
    rng = np.random.RandomState(seed)
    k = rng.randint(0, 400, n).astype(np.int64)
    k[: n // 10] = 7  # duplicate keys: one hot key on both sides
    r = rng.randint(0, 450, 900).astype(np.int64)
    r[:40] = 7
    return {
        "fact": {
            "k": k,
            "k32": (k % 300).astype(np.int32),
            "g": rng.randint(0, 6, n).astype(np.int64),
            "x": np.round(rng.rand(n) * 100, 3),
        },
        "dim": {
            "d": r,
            "d64": (r % 300).astype(np.int64),
            "df": r.astype(np.float64),
            "h": rng.randint(0, 6, 900).astype(np.int64),
            "y": np.round(rng.rand(900) * 10, 3),
        },
        "third": {
            "t": np.arange(0, 500, dtype=np.int64),
            "z": rng.rand(500),
        },
    }


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    base = tmp_path_factory.mktemp("general")
    out = {}
    for name, cols in _sources().items():
        out[name] = str(base / name)
        _write(out[name], cols, parts={"fact": 3, "dim": 2}.get(name, 1))
    out["base"] = str(base)
    return out


def _sessions(paths, tmp_path):
    ts = hst.HyperspaceSession(warehouse=str(tmp_path / "torch"), device="cpu")
    js = JaxSession(warehouse=str(tmp_path / "jax"))
    return ts, js


QUERIES = {
    "one_key": lambda rd, c: rd("fact").join(rd("dim"), c("k") == c("d")).select("k", "x", "y"),
    "two_keys": lambda rd, c: rd("fact").join(rd("dim"), (c("k") == c("d")) & (c("g") == c("h"))).select(
        "k", "g", "x", "y"
    ),
    "int32_int64": lambda rd, c: rd("fact").join(rd("dim"), c("k32") == c("d64")).select("k32", "d64", "x"),
    "int64_float64": lambda rd, c: rd("fact").join(rd("dim"), c("k") == c("df")).select("k", "df", "x"),
    "float64_int64": lambda rd, c: rd("dim").join(rd("fact"), c("df") == c("k")).select("df", "k", "y"),
    "join_of_a_join": lambda rd, c: rd("fact").join(rd("dim"), c("k") == c("d")).join(
        rd("third"), c("h") == c("t")
    ).select("k", "h", "x", "z"),
    "join_onto_a_join": lambda rd, c: rd("third").join(
        rd("fact").join(rd("dim"), c("k") == c("d")), c("t") == c("g")
    ).select("t", "z", "k", "y"),
    "filtered_sides": lambda rd, c: rd("fact").filter(c("x") > 50.0).join(
        rd("dim").filter(c("h") < 3), c("k") == c("d")
    ).select("k", "x", "h"),
    "empty_side": lambda rd, c: rd("fact").join(rd("dim").filter(c("h") > 100), c("k") == c("d")).select(
        "k", "x", "y"
    ),
    "all_columns": lambda rd, c: rd("fact").join(rd("third"), c("g") == c("t")),
}


def _run(paths, tmp_path, name):
    ts, js = _sessions(paths, tmp_path)
    tq = QUERIES[name](lambda n: ts.read.parquet(paths[n]), hst.col)
    jq = QUERIES[name](lambda n: js.read.parquet(paths[n]), jax_col)
    return tq, jq


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_general_join_equals_jax_rows_in_order(paths, tmp_path, name):
    tq, jq = _run(paths, tmp_path, name)
    joins = [n for n in tq.physical_plan().collect_nodes() if isinstance(n, SortMergeJoinExec)]
    assert joins and not any(j.bucketed for j in joins)
    got, want = tq.collect(), jq.collect()
    assert_same(got, want)
    if name == "empty_side":
        assert got.num_rows == 0
    else:
        assert got.num_rows > 0


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_general_join_count_equals_jax(paths, tmp_path, name):
    tq, jq = _run(paths, tmp_path, name)
    assert tq.count() == jq.count() == tq.collect().num_rows


def test_the_plan_has_exchange_and_sort_markers(paths, tmp_path):
    tq, _ = _run(paths, tmp_path, "one_key")
    join = next(n for n in tq.physical_plan().collect_nodes() if isinstance(n, SortMergeJoinExec))
    for side, keys in ((join.left, ["k"]), (join.right, ["d"])):
        assert isinstance(side, SortExec) and side.keys == keys
        assert isinstance(side.child, ShuffleExchangeExec) and side.child.keys == keys
    assert "bucketed" not in join.simple_string()


def test_cached_equals_uncached_and_the_pairs_memo_hits(paths, tmp_path):
    tq, _ = _run(paths, tmp_path, "one_key")
    cold = tq.collect()
    before = physical.memo_stats()["pairs"]
    warm = tq.collect()
    after = physical.memo_stats()["pairs"]
    assert after["hits"] == before["hits"] + 1 and after["misses"] == before["misses"]
    assert_same(warm, cold)
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()
    assert_same(tq.collect(), cold)


def test_a_rewritten_file_misses_the_general_pairs_memo(tmp_path):
    src = _sources(seed=9, n=1200)
    fact, dim = str(tmp_path / "fact"), str(tmp_path / "dim")
    _write(fact, src["fact"], parts=2)
    _write(dim, src["dim"], parts=2)
    ts = hst.HyperspaceSession(warehouse=str(tmp_path / "torch"), device="cpu")

    def q():
        return ts.read.parquet(fact).join(ts.read.parquet(dim), hst.col("k") == hst.col("d")).select("k", "y")

    hits = physical.memo_stats()["pairs"]["hits"]
    first = q().collect()
    assert physical.memo_stats()["pairs"]["hits"] == hits
    q().collect()
    assert physical.memo_stats()["pairs"]["hits"] == hits + 1
    changed = dict(src["dim"], d=src["dim"]["d"] + 1)
    _write(dim, changed, parts=2)
    for f in sorted(os.listdir(dim)):  # a distinct mtime whatever the clock's grain
        os.utime(os.path.join(dim, f), ns=(2_000_000_000_000_000_000, 2_000_000_000_000_000_000))
    misses = physical.memo_stats()["pairs"]["misses"]
    second = q().collect()
    assert physical.memo_stats()["pairs"]["misses"] == misses + 1
    rk = changed["d"]
    expect = int((src["fact"]["k"][:, None] == rk[None, :]).sum())
    assert second.num_rows == expect != first.num_rows


@pytest.mark.parametrize("dtypes", [("int64", "float64"), ("float64", "int64")])
def test_mixed_kind_covering_indexes_take_the_general_join(tmp_path, monkeypatch, dtypes):
    """Two covering indexes whose key kinds differ (int vs float) do not
    co-locate their buckets: the planner falls through to the general join,
    over the index files, as the JAX package does."""
    rng = np.random.RandomState(13)
    a = rng.randint(0, 200, 3000)
    b = rng.randint(0, 220, 600)
    src = {"l": {"a": a.astype(dtypes[0]), "x": rng.rand(3000)}, "r": {"b": b.astype(dtypes[1]), "y": rng.rand(600)}}
    for name, cols in src.items():
        _write(str(tmp_path / name), cols)
    ts = hst.HyperspaceSession(warehouse=str(tmp_path / "torch"), device="cpu")
    ts.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, 8)
    js = JaxSession(warehouse=str(tmp_path / "jax"))
    js.conf.set(JaxIndexConstants.INDEX_NUM_BUCKETS, 8)
    th, jh = hst.Hyperspace(ts), JaxHyperspace(js)
    for s, h, cfg in ((ts, th, hst.IndexConfig), (js, jh, JaxIndexConfig)):
        h.create_index(s.read.parquet(str(tmp_path / "l")), cfg("lIdx", ["a"], ["x"]))
        h.create_index(s.read.parquet(str(tmp_path / "r")), cfg("rIdx", ["b"], ["y"]))
    hst.enable_hyperspace(ts)
    jax_enable(js)

    def q(s, c):
        return s.read.parquet(str(tmp_path / "l")).join(s.read.parquet(str(tmp_path / "r")), c("a") == c("b")).select(
            "a", "x", "y"
        )

    tq, jq = q(ts, hst.col), q(js, jax_col)
    plan = tq.physical_plan()
    join = next(n for n in plan.collect_nodes() if isinstance(n, SortMergeJoinExec))
    assert not join.bucketed
    assert not any(isinstance(n, BucketedIndexScanExec) for n in plan.collect_nodes())
    assert {n.relation.index_name for n in plan.collect_nodes() if hasattr(n, "relation") and n.name == "Scan"} == {
        "lIdx", "rIdx"
    }
    got = tq.collect()
    assert_same(got, jq.collect())
    assert got.num_rows == int((a[:, None] == b[None, :]).sum()) > 0


MERGE_CASES = {
    "dups": (lambda r: r.randint(0, 50, 3000), lambda r: r.randint(0, 60, 500)),
    "disjoint": (lambda r: r.randint(0, 50, 300), lambda r: r.randint(100, 150, 300)),
    "extremes": (
        lambda r: np.array([np.iinfo(np.int64).min, -1, 0, np.iinfo(np.int64).max] * 50),
        lambda r: np.array([np.iinfo(np.int64).max, 0, np.iinfo(np.int64).min, 5] * 7),
    ),
    "one_row": (lambda r: np.array([3]), lambda r: r.randint(0, 5, 400)),
    "empty_left": (lambda r: np.empty(0), lambda r: r.randint(0, 5, 40)),
    "empty_right": (lambda r: r.randint(0, 5, 40), lambda r: np.empty(0)),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_join_pairs_equals_the_jax_merge_in_order(case):
    rng = np.random.RandomState(21)
    lk = MERGE_CASES[case][0](rng).astype(np.int64)
    rk = MERGE_CASES[case][1](rng).astype(np.int64)
    li, ri = torch_join.merge_join_pairs(torch.from_numpy(lk), torch.from_numpy(rk))
    jli, jri = jax_join.host_merge_pairs(lk, rk)
    dli, dri = jax_join.merge_join_pairs(lk, rk)
    hli, hri = torch_join.host_merge_pairs(lk, rk)
    for want in ((jli, jri), (np.asarray(dli), np.asarray(dri)), (hli, hri)):
        np.testing.assert_array_equal(li.numpy(), want[0])
        np.testing.assert_array_equal(ri.numpy(), want[1])
    assert li.dtype == ri.dtype == torch.int64


# ---------------------------------------------------------------------------
# `_general_count_fast`: the general join's count() without its pairs.
# ---------------------------------------------------------------------------

I64 = np.iinfo(np.int64)


def _count_sources(seed=31, n=3000):
    """Single-key shapes of the value-direct branch: int32 ⋈ int64, float
    keys with NaN and ±0.0 on both sides, float32 ⋈ int64, int64 extremes."""
    rng = np.random.RandomState(seed)
    pool = np.array([np.nan, -0.0, 0.0, 1.5, -1.5, np.inf, -np.inf, 2.0])
    lf = np.where(rng.rand(n) < 0.3, pool[rng.randint(0, 8, n)], rng.randint(0, 60, n).astype(np.float64))
    rf = np.where(rng.rand(400) < 0.3, pool[rng.randint(0, 8, 400)], rng.randint(0, 60, 400).astype(np.float64))
    ext = np.array([I64.min, I64.min + 1, -1, 0, 1, I64.max - 1, I64.max])
    return {
        "cl": {
            "a32": rng.randint(-50, 50, n).astype(np.int32),
            "f": lf,
            "f32": rng.randint(0, 60, n).astype(np.float32),
            "e": ext[rng.randint(0, 7, n)],
        },
        "cr": {
            "b64": rng.randint(-60, 40, 400).astype(np.int64),
            "g": rf,
            "i64": rng.randint(0, 70, 400).astype(np.int64),
            "e2": ext[rng.randint(0, 7, 400)],
        },
    }


VALUE_COUNTS = {"int32_int64": ("a32", "b64"), "float_nan": ("f", "g"), "float32_int64": ("f32", "i64"),
                "int64_extremes": ("e", "e2")}


@pytest.fixture(scope="module")
def count_paths(tmp_path_factory):
    base = tmp_path_factory.mktemp("counts")
    out = {}
    for name, cols in _count_sources().items():
        out[name] = str(base / name)
        _write(out[name], cols)
    return out


def _spy(monkeypatch, name):
    calls = []
    fn = getattr(physical, name)

    def spy(*args):
        calls.append(1)
        return fn(*args)

    monkeypatch.setattr(physical, name, spy)
    return calls


@pytest.mark.parametrize("case", sorted(VALUE_COUNTS))
def test_the_value_direct_count_equals_jax(count_paths, tmp_path, monkeypatch, case):
    """An inner join on one null-free numeric key pair counts on the values:
    numpy's promotion, NaN matching nothing, ±0.0 equal, int64 extremes."""
    lk, rk = VALUE_COUNTS[case]
    ts, js = _sessions(count_paths, tmp_path)

    def q(s, c):
        return s.read.parquet(count_paths["cl"]).join(s.read.parquet(count_paths["cr"]), c(lk) == c(rk))

    value, hashed = _spy(monkeypatch, "_value_inner_count"), _spy(monkeypatch, "_verified_keep")
    n = q(ts, hst.col).count()
    assert value and not hashed
    assert n == q(js, jax_col).count() == q(ts, hst.col).collect().num_rows > 0


@pytest.mark.parametrize("how", ["inner", "left", "right", "full", "left_semi", "left_anti"])
@pytest.mark.parametrize("name", ["two_keys", "int64_float64", "filtered_sides"])
def test_the_general_count_of_every_type_equals_jax(paths, tmp_path, monkeypatch, name, how):
    """Any general join but an inner one on one null-free numeric key pair
    counts by the key64 merge, verification and the scatter-max match
    stats."""
    ts, js = _sessions(paths, tmp_path)

    def q(rd, c):
        j = QUERIES[name](rd, c)
        while type(j.plan).__name__ != "JoinNode":
            j = type(j)(j.session, j.plan.child)
        return type(j)(j.session, type(j.plan)(j.plan.left, j.plan.right, j.plan.condition, how))

    tq = q(lambda n: ts.read.parquet(paths[n]), hst.col)
    jq = q(lambda n: js.read.parquet(paths[n]), jax_col)
    assert _join(tq).how == how and not _join(tq).bucketed
    value, stats = _spy(monkeypatch, "_value_inner_count"), _spy(monkeypatch, "_verified_match_counts")
    n = tq.count()
    by_value = how == "inner" and name != "two_keys"
    assert (bool(value), bool(stats)) == (by_value, not by_value)
    assert n == jq.count() == tq.collect().num_rows > 0


def _join(df):
    return next(n for n in df.physical_plan().collect_nodes() if isinstance(n, SortMergeJoinExec))


@pytest.mark.parametrize("how", ["inner", "left", "full", "left_anti"])
@pytest.mark.parametrize("name", ["one_key", "two_keys"])
def test_a_count_leaves_the_pairs_memo_alone(paths, tmp_path, name, how):
    """The count neither reads nor fills the pairs memo: a later collect
    builds its pairs as it would have (one miss), and a repeated count adds
    no hit."""
    ts, _ = _sessions(paths, tmp_path)
    rd = lambda n: ts.read.parquet(paths[n])  # noqa: E731
    base = QUERIES[name](rd, hst.col)
    while type(base.plan).__name__ != "JoinNode":
        base = type(base)(base.session, base.plan.child)
    tq = type(base)(base.session, type(base.plan)(base.plan.left, base.plan.right, base.plan.condition, how))
    before = physical.memo_stats()["pairs"]
    n = tq.count()
    tq.count()
    mid = physical.memo_stats()["pairs"]
    assert mid == before
    assert tq.collect().num_rows == n
    after = physical.memo_stats()["pairs"]
    assert after["misses"] == mid["misses"] + 1 and after["hits"] == mid["hits"]

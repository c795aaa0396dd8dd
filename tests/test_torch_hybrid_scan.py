"""Hybrid Scan in the port against the JAX package, on the same lakes.

Each test drives both packages over ONE source directory, each with its own
index warehouse (`Twin` of `test_torch_refresh.py`), with
`hyperspace.index.hybridscan.enabled` set in both: indexes are built, source
files are appended or deleted with no refresh, and the filter and join
queries must use the stale index in both packages and give the same rows in
the same order, the same `count()`, and the rows of the query with
Hyperspace disabled. The shapes are `tests/test_extensions.py`'s
`TestHybridScan` :44-108, `TestHybridScanDeleteTolerance` :367-458 and
`TestPairCacheFreshness` :492-, plus seeded joins at 4 buckets over int,
float, nullable and short string keys (the last through K3's plain twin,
as the appended rows' bucketize takes it). Nothing is computed on the rows,
so the tolerance is 0. The JAX package runs its single-device serial build
(`HYPERSPACE_DISTRIBUTED=0`, `HYPERSPACE_BUILD_DECODE_THREADS=1`).
"""

import os

import numpy as np
import pytest

import hyperspace_tpu_torch as hst
from hyperspace_tpu import IndexConstants as JaxIndexConstants
from hyperspace_tpu.index import quarantine as jax_quarantine
from hyperspace_tpu_torch.engine import physical, scan_cache
from hyperspace_tpu_torch.engine.physical import BucketedIndexScanExec, ExecContext, SortMergeJoinExec
from hyperspace_tpu_torch.index import quarantine
from hyperspace_tpu_torch.ops import bucket_join, partition

from test_torch_refresh import Twin, _host, write


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    monkeypatch.setenv("HYPERSPACE_BUILD_DECODE_THREADS", "1")
    quarantine.clear()
    jax_quarantine.clear()
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()
    yield
    quarantine.clear()
    jax_quarantine.clear()
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()


def hybrid_twin(base, lineage=False, num_buckets=8):
    tw = Twin(base, num_buckets=num_buckets, lineage=lineage)
    tw.t.conf.set(hst.IndexConstants.INDEX_HYBRID_SCAN_ENABLED, "true")
    tw.j.conf.set(JaxIndexConstants.INDEX_HYBRID_SCAN_ENABLED, "true")
    return tw


def plans(tw, build):
    """(port physical plan, JAX physical plan) of `build(read, col)`."""
    from hyperspace_tpu.engine import col as jax_col

    return (
        build(lambda p: tw.t.read.parquet(p), hst.col).physical_plan(),
        build(lambda p: tw.j.read.parquet(p), jax_col).physical_plan(),
    )


def scanned(plan):
    return {n.relation.index_name for n in plan.collect_nodes()
            if getattr(n, "relation", None) is not None and n.relation.index_name}


def op_names(plan):
    return [n.name for n in plan.collect_nodes()]


def assert_scans(tw, build, indexes):
    """Both packages' plans scan exactly `indexes`, with no exchange."""
    t, j = plans(tw, build)
    assert scanned(t) == scanned(j) == set(indexes), (t.tree_string(), j.tree_string())
    assert "ShuffleExchange" not in op_names(t) and "ShuffleExchange" not in op_names(j)
    return t


def disabled_rows(tw, build):
    """The port's rows with Hyperspace disabled, as sorted tuples."""
    hst.disable_hyperspace(tw.t)
    try:
        rows = _host(build(lambda p: tw.t.read.parquet(p), hst.col).collect())
    finally:
        hst.enable_hyperspace(tw.t)
    return sorted(zip(*rows.values()))


def as_tuples(rows):
    return sorted(zip(*rows.values()))


# ---------------------------------------------------------------------------
# test_extensions.py TestHybridScan
# ---------------------------------------------------------------------------


def test_filter_unions_the_index_with_appended_files(tmp_path):
    src, tw = str(tmp_path / "t"), hybrid_twin(tmp_path)
    write(src, "part-00000.parquet", {"k": np.array([1, 2, 3]), "v": np.array(["a", "b", "c"])})
    tw.create(src, "h1", ["k"], ["v"])
    write(src, "appended.parquet", {"k": np.array([1, 9]), "v": np.array(["x", "y"])})

    def q(rd, c):
        return rd(src).filter(c("k") == 1).select("v")

    for s in (tw.t, tw.j):  # without Hybrid Scan the stale index sits out
        s.conf.set("hyperspace.index.hybridscan.enabled", "false")
    t, j = plans(tw, q)
    assert scanned(t) == scanned(j) == set()
    for s in (tw.t, tw.j):
        s.conf.set("hyperspace.index.hybridscan.enabled", "true")
    t = assert_scans(tw, q, {"h1"})
    assert "Union" in op_names(t)
    rows = tw.query(q, "h1")
    assert rows == {"v": ["a", "x"]}
    assert as_tuples(rows) == disabled_rows(tw, q)


def test_join_merges_appended_rows_into_the_buckets(tmp_path):
    l, r, tw = str(tmp_path / "l"), str(tmp_path / "r"), hybrid_twin(tmp_path)
    write(l, "part-00000.parquet", {"k": np.array([1, 2, 3, 4]), "v": np.array([10, 20, 30, 40])})
    write(r, "part-00000.parquet", {"k2": np.array([1, 2, 3, 4, 5]), "w": np.array([100, 200, 300, 400, 500])})
    tw.create(l, "hl", ["k"], ["v"])
    tw.create(r, "hr", ["k2"], ["w"])
    write(l, "appended.parquet", {"k": np.array([5, 5]), "v": np.array([55, 56])})

    def q(rd, c):
        return rd(l).join(rd(r), c("k") == c("k2")).select("v", "w")

    t = assert_scans(tw, q, {"hl", "hr"})
    join = next(n for n in t.collect_nodes() if isinstance(n, SortMergeJoinExec))
    assert join.bucketed
    rows = tw.query(q, "hl")
    assert (55, 500) in as_tuples(rows)
    assert as_tuples(rows) == disabled_rows(tw, q)


def test_a_file_changed_in_place_disqualifies_the_index(tmp_path):
    src, tw = str(tmp_path / "t"), hybrid_twin(tmp_path)
    write(src, "part-00000.parquet", {"k": np.array([1]), "v": np.array(["a"])})
    tw.create(src, "h2", ["k"], ["v"])
    write(src, "part-00000.parquet", {"k": np.array([1, 2]), "v": np.array(["zz", "ww"])})

    def q(rd, c):
        return rd(src).filter(c("k") == 1).select("v")

    t, j = plans(tw, q)
    assert scanned(t) == scanned(j) == set()
    assert tw.query(q) == {"v": ["zz"]}


def test_the_exact_index_outranks_the_hybrid_one(tmp_path):
    """Two covering indexes on one source: after an append, only a refreshed
    one matches exactly, and the filter rule picks it over the stale one."""
    src, tw = str(tmp_path / "t"), hybrid_twin(tmp_path)
    write(src, "part-00000.parquet", {"k": np.array([1, 2, 3]), "v": np.array(["a", "b", "c"])})
    tw.create(src, "stale", ["k"], ["v"])
    tw.create(src, "fresh", ["k"], ["v"])
    write(src, "appended.parquet", {"k": np.array([1]), "v": np.array(["x"])})
    tw.refresh("fresh", "incremental")

    def q(rd, c):
        return rd(src).filter(c("k") == 1).select("v")

    t = assert_scans(tw, q, {"fresh"})
    assert "Union" not in op_names(t)
    assert tw.query(q, "fresh") == {"v": ["a", "x"]}


# ---------------------------------------------------------------------------
# test_extensions.py TestHybridScanDeleteTolerance
# ---------------------------------------------------------------------------


def _two_files(d, a, b):
    write(d, "part-a.parquet", a)
    write(d, "part-b.parquet", b)
    return d


def test_filter_prunes_a_deleted_file_through_lineage(tmp_path):
    tw = hybrid_twin(tmp_path, lineage=True)
    d = _two_files(str(tmp_path / "t"), {"k": np.array([1, 2, 3]), "v": np.array(["a", "b", "c"])},
                   {"k": np.array([1, 4]), "v": np.array(["x", "y"])})
    tw.create(d, "dt1", ["k"], ["v"])
    os.remove(os.path.join(d, "part-b.parquet"))

    def q(rd, c):
        return rd(d).filter(c("k") == 1).select("v")

    assert_scans(tw, q, {"dt1"})
    assert tw.query(q, "dt1") == {"v": ["a"]}
    assert disabled_rows(tw, q) == [("a",)]


def test_a_deleted_file_without_lineage_disqualifies_the_index(tmp_path):
    tw = hybrid_twin(tmp_path)
    d = _two_files(str(tmp_path / "t0"), {"k": np.array([1, 2]), "v": np.array(["a", "b"])},
                   {"k": np.array([3]), "v": np.array(["c"])})
    tw.create(d, "dt0", ["k"], ["v"])
    os.remove(os.path.join(d, "part-b.parquet"))

    def q(rd, c):
        return rd(d).filter(c("k") == 1).select("v")

    t, j = plans(tw, q)
    assert scanned(t) == scanned(j) == set()
    assert tw.query(q) == {"v": ["a"]}


def test_join_survives_a_delete_and_an_append(tmp_path):
    tw = hybrid_twin(tmp_path, lineage=True)
    dl = _two_files(str(tmp_path / "l"), {"k": np.array([1, 2, 3, 4]), "v": np.array([10, 20, 30, 40])},
                    {"k": np.array([5, 6]), "v": np.array([50, 60])})
    r = str(tmp_path / "r")
    write(r, "part-00000.parquet", {"k2": np.arange(1, 8), "w": np.arange(100, 800, 100)})
    tw.create(dl, "djl", ["k"], ["v"])
    tw.create(r, "djr", ["k2"], ["w"])
    os.remove(os.path.join(dl, "part-b.parquet"))  # k=5,6 vanish
    write(dl, "appended.parquet", {"k": np.array([7, 7]), "v": np.array([70, 71])})

    def q(rd, c):
        return rd(dl).join(rd(r), c("k") == c("k2")).select("v", "w")

    assert_scans(tw, q, {"djl", "djr"})
    rows = tw.query(q, "djl")
    assert (70, 700) in as_tuples(rows) and (50, 500) not in as_tuples(rows)
    assert as_tuples(rows) == disabled_rows(tw, q)


# ---------------------------------------------------------------------------
# test_extensions.py TestPairCacheFreshness
# ---------------------------------------------------------------------------


@pytest.fixture()
def probe_calls(monkeypatch):
    """Calls of the co-bucketed join's probe, so that a memo hit or miss is
    asserted, not assumed."""
    calls = []
    real = bucket_join.probe_classed

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(bucket_join, "probe_classed", spy)
    return calls


def test_a_join_count_sees_an_append_after_cached_pairs(tmp_path, probe_calls):
    l, r, tw = str(tmp_path / "l"), str(tmp_path / "r"), hybrid_twin(tmp_path)
    write(l, "part-00000.parquet", {"k": np.array([1, 2, 3, 4]), "v": np.array([10, 20, 30, 40])})
    write(r, "part-00000.parquet", {"rk": np.array([1, 2, 3, 4, 9])})
    tw.create(l, "pf_l", ["k"], ["v"])
    tw.create(r, "pf_r", ["rk"], [])

    def q(rd, c):
        return rd(l).join(rd(r), c("k") == c("rk")).select("v")

    assert_scans(tw, q, {"pf_l", "pf_r"})
    port = lambda: q(lambda p: tw.t.read.parquet(p), hst.col)  # noqa: E731
    assert port().count() == 4
    n_first = len(probe_calls)
    assert n_first >= 1
    assert port().count() == 4  # served by the memo
    assert len(probe_calls) == n_first
    write(l, "appended.parquet", {"k": np.array([9, 9]), "v": np.array([90, 91])})
    assert_scans(tw, q, {"pf_l", "pf_r"})
    assert port().count() == 6
    assert len(probe_calls) > n_first  # the appended inventory re-keyed the memo
    rows = tw.query(q, "pf_l")
    assert sorted(rows["v"]) == [10, 20, 30, 40, 90, 91]
    assert as_tuples(rows) == disabled_rows(tw, q)


def test_a_join_count_sees_a_delete_after_cached_pairs(tmp_path):
    tw = hybrid_twin(tmp_path, lineage=True)
    d = _two_files(str(tmp_path / "dl"), {"k": np.array([1, 2]), "v": np.array([10, 20])},
                   {"k": np.array([3, 4]), "v": np.array([30, 40])})
    r = str(tmp_path / "dr")
    write(r, "part-00000.parquet", {"rk": np.array([1, 2, 3, 4])})
    tw.create(d, "dfl", ["k"], ["v"])
    tw.create(r, "dfr", ["rk"], [])

    def q(rd, c):
        return rd(d).join(rd(r), c("k") == c("rk")).select("v")

    port = lambda: q(lambda p: tw.t.read.parquet(p), hst.col)  # noqa: E731
    assert port().count() == 4
    os.remove(os.path.join(d, "part-b.parquet"))
    assert_scans(tw, q, {"dfl", "dfr"})
    assert port().count() == 2
    assert sorted(tw.query(q, "dfl")["v"]) == [10, 20]
    assert disabled_rows(tw, q) == [(10,), (20,)]


# ---------------------------------------------------------------------------
# Seeded joins at 4 buckets over each key kind, merged buckets in hash mode
# ---------------------------------------------------------------------------


def _keys(rng, kind, n):
    if kind == "int":
        return rng.randint(0, 60, n).astype(np.int64)
    if kind == "float":
        pool = np.array([np.nan, -0.0, 0.0, 1.5, -2.25, 3.0, np.inf, 7.75])
        return pool[rng.randint(0, len(pool), n)]
    if kind == "nullable":
        v = rng.randint(0, 40, n).astype(object)
        v[rng.rand(n) < 0.15] = None
        return v
    return np.array(["MAIL", "SHIP", "AIR", "RAIL", "TRUCK", "FOB", "REG AIR"])[rng.randint(0, 7, n)]


@pytest.mark.parametrize("kind", ["int", "float", "nullable", "string"])
def test_seeded_hybrid_join_equals_jax(tmp_path, kind, monkeypatch):
    rng = np.random.RandomState(11)
    l, r, tw = str(tmp_path / "l"), str(tmp_path / "r"), hybrid_twin(tmp_path, lineage=True, num_buckets=4)
    for i in range(3):
        write(l, f"part-{i:05d}.parquet", {"k": _keys(rng, kind, 300), "v": rng.randint(0, 1000, 300)})
    write(r, "part-00000.parquet", {"k2": _keys(rng, kind, 200), "w": rng.rand(200)})
    tw.create(l, "sl", ["k"], ["v"])
    tw.create(r, "sr", ["k2"], ["w"])
    write(l, "part-00003.parquet", {"k": _keys(rng, kind, 250), "v": rng.randint(0, 1000, 250)})
    os.remove(os.path.join(l, "part-00001.parquet"))
    comp_sorts = []
    real = partition.sort_comp_rows
    monkeypatch.setattr(partition, "sort_comp_rows", lambda *a: comp_sorts.append(1) or real(*a))

    def q(rd, c):
        return rd(l).join(rd(r), c("k") == c("k2")).select("k", "v", "w")

    t = assert_scans(tw, q, {"sl", "sr"})
    scan = next(n for n in t.collect_nodes() if isinstance(n, BucketedIndexScanExec) and n.relation.index_name == "sl")
    assert len(scan.relation.hybrid_append.files) == 1
    rows = tw.query(q, "sl")
    assert as_tuples(rows) == disabled_rows(tw, q)
    join = next(n for n in t.collect_nodes() if isinstance(n, SortMergeJoinExec))
    ctx = ExecContext(tw.t)
    left, right, ls, rs, subkey, rows_key = join._sides(ctx)
    assert join._plan_and_ranges(left, right, ls, rs, subkey, rows_key)[0].mode == "hash"
    # A short string key's appended rows bucketize through K3's plain twin.
    assert bool(comp_sorts) == (kind == "string")


def test_a_demoted_hybrid_scan_still_merges(tmp_path):
    """An int key joined to a float key cannot co-locate (other hash kinds):
    the planner demotes both index scans to the general join, and the stale
    side's appended rows still come in."""
    l, r, tw = str(tmp_path / "l"), str(tmp_path / "r"), hybrid_twin(tmp_path, num_buckets=4)
    write(l, "part-00000.parquet", {"k": np.arange(6, dtype=np.int64), "v": np.arange(6) * 10})
    write(r, "part-00000.parquet", {"k2": np.arange(9, dtype=np.float64), "w": np.arange(9) * 1.5})
    tw.create(l, "gl", ["k"], ["v"])
    tw.create(r, "gr", ["k2"], ["w"])
    write(l, "appended.parquet", {"k": np.array([7, 8, 8]), "v": np.array([70, 80, 81])})

    def q(rd, c):
        return rd(l).join(rd(r), c("k") == c("k2")).select("k", "v", "w")

    t, _ = plans(tw, q)
    join = next(n for n in t.collect_nodes() if isinstance(n, SortMergeJoinExec))
    assert not join.bucketed and scanned(t) == {"gl", "gr"}
    rows = tw.query(q, "gl")
    assert (8, 81, 12.0) in as_tuples(rows)
    assert as_tuples(rows) == disabled_rows(tw, q)

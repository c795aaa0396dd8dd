"""The port's scan caches and join memos.

- A cached run returns exactly what an uncached run does (torch.equal on
  every column, equal dictionaries), for joins, a filtered join, lookups and
  the Q3-shaped join → aggregate, and the JAX package's rows besides.
- Rewriting a file (a new size or mtime) misses in every cache and memo, and
  so does a refreshed index: appended files change the bucketed scan's file
  list, folded deletes the lineage prune condition.
- The scan cache's byte budget evicts in LRU order (the shape of
  `tests/test_engine.py::test_scan_cache_stats_and_capacity_clamp`); the
  memos evict in one LRU order across their tags and die with their tables.
- Cached tensors are shared between queries, and no operator writes into
  them: their values and `tensor._version` are unchanged after queries.
- Memo entries whose tables live until interpreter exit die quietly: the
  eviction callbacks do nothing while the interpreter finalizes, so a
  child process that keeps them to the end writes nothing on stderr.
Nothing here computes on floats except the aggregate's sums, which must be
identical between cached and uncached runs (tolerance 0) and equal the JAX
package's at rtol 1e-9.
"""

import gc
import os
import subprocess
import sys
import time
import weakref

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
from hyperspace_tpu_torch.engine import io as torch_io
from hyperspace_tpu_torch.engine import physical
from hyperspace_tpu_torch.engine import scan_cache
from hyperspace_tpu_torch.engine.table import Table

NUM_BUCKETS = 8


def clear():
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()


def _data(seed=4, n_orders=600):
    rng = np.random.RandomState(seed)
    okey = np.arange(n_orders, dtype=np.int64) * 4 + 1
    lines = rng.randint(1, 8, n_orders)
    n = int(lines.sum())
    return {
        "lineitem": {
            "l_orderkey": np.repeat(okey, lines),
            "l_partkey": rng.randint(1, 200, n).astype(np.int64),
            "l_suppkey": rng.randint(1, 5, n).astype(np.int64),
            "l_extendedprice": np.round(rng.rand(n) * 1e4, 2),
            "l_discount": rng.randint(0, 11, n) / 100.0,
            "l_shipmode": np.array(["AIR", "MAIL", "SHIP", "TRUCK"])[rng.randint(0, 4, n)],
        },
        "orders": {
            "o_orderkey": okey,
            "o_custkey": rng.randint(1, 90, n_orders).astype(np.int64),
            "o_totalprice": np.round(rng.rand(n_orders) * 1e5, 2),
        },
        "partsupp": {
            "ps_partkey": np.repeat(np.arange(1, 200, dtype=np.int64), 4),
            "ps_suppkey": np.tile(np.arange(1, 5, dtype=np.int64), 199),
            "ps_supplycost": np.round(rng.rand(796) * 100, 2),
        },
    }


INDEXES = [
    ("lineitem", "liOrd", ["l_orderkey"], ["l_extendedprice", "l_discount"]),
    ("orders", "ordIdx", ["o_orderkey"], ["o_custkey", "o_totalprice"]),
    ("lineitem", "liPs", ["l_partkey", "l_suppkey"], ["l_extendedprice"]),
    ("partsupp", "psIdx", ["ps_partkey", "ps_suppkey"], ["ps_supplycost"]),
    ("lineitem", "liShip", ["l_shipmode"], ["l_orderkey", "l_extendedprice"]),
]


def queries(s, src, c):
    def rd(name):
        return s.read.parquet(os.path.join(src, name))

    li, od, ps = rd("lineitem"), rd("orders"), rd("partsupp")
    return {
        "q_ord": li.join(od, c("l_orderkey") == c("o_orderkey")).select("l_extendedprice", "o_custkey"),
        "q_ps": li.join(ps, (c("l_partkey") == c("ps_partkey")) & (c("l_suppkey") == c("ps_suppkey"))).select(
            "l_extendedprice", "ps_supplycost"),
        "q_filtered_join": li.filter(c("l_orderkey") < 800).join(od, c("l_orderkey") == c("o_orderkey")).select(
            "l_extendedprice", "o_totalprice"),
        "q3_agg": li.join(od, c("l_orderkey") == c("o_orderkey"))
        .with_column("revenue", c("l_extendedprice") * (1 - c("l_discount")))
        .group_by("o_custkey")
        .agg(revenue=("revenue", "sum"), orders=("l_orderkey", "count_distinct"), lines=("*", "count"),
             top=("o_totalprice", "max")),
        "q12_range": li.filter(c("l_shipmode").isin("MAIL", "SHIP") & (c("l_orderkey") < 500)).select(
            "l_orderkey", "l_shipmode", "l_extendedprice"),
    }


@pytest.fixture(scope="module")
def lake(tmp_path_factory):
    base = tmp_path_factory.mktemp("cache")
    mp = pytest.MonkeyPatch()
    mp.setenv("HYPERSPACE_DISTRIBUTED", "0")
    mp.setenv("HYPERSPACE_INDEX_ROW_GROUP_ROWS", "128")
    src = str(base / "src")
    for name, cols in _data().items():
        torch_io.write_parquet(Table.from_pydict(cols, "cpu"), os.path.join(src, name, "part-00000.parquet"))
    ts = hst.HyperspaceSession(warehouse=str(base / "torch"), device="cpu")
    ts.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    js = JaxSession(warehouse=str(base / "jax"))
    js.conf.set(JaxIndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    th, jh = hst.Hyperspace(ts), JaxHyperspace(js)
    for table, name, indexed, included in INDEXES:
        th.create_index(ts.read.parquet(os.path.join(src, table)), hst.IndexConfig(name, indexed, included))
        jh.create_index(js.read.parquet(os.path.join(src, table)), JaxIndexConfig(name, indexed, included))
    hst.enable_hyperspace(ts)
    jax_enable(js)
    yield ts, js, src
    mp.undo()


def assert_identical(a: Table, b: Table):
    assert a.column_names == b.column_names and a.num_rows == b.num_rows
    for n in a.column_names:
        ca, cb = a.column(n), b.column(n)
        assert ca.dtype == cb.dtype and torch.equal(ca.data, cb.data), n
        assert (ca.validity is None) == (cb.validity is None)
        assert ca.validity is None or torch.equal(ca.validity, cb.validity)
        assert ca.dictionary is None or np.array_equal(ca.dictionary, cb.dictionary)


def _host(t):
    return {n: np.asarray(c.decode_objects(), dtype=object) for n, c in t.columns.items()}


@pytest.mark.parametrize("name", ["q_ord", "q_ps", "q_filtered_join", "q3_agg", "q12_range"])
def test_cached_equals_uncached_and_the_reference(lake, monkeypatch, name):
    monkeypatch.setenv("HYPERSPACE_FORCE_DEVICE_OPS", "1")
    ts, js, src = lake
    df = queries(ts, src, hst.col)[name]
    clear()
    uncached, n_uncached = df.collect(), df.count()
    before = scan_cache.stats()
    cached, n_cached = df.collect(), df.count()
    after = scan_cache.stats()
    assert_identical(cached, uncached)
    assert n_cached == n_uncached == uncached.num_rows > 0
    hits = sum(after[c]["hits"] - before[c]["hits"] for c in after)
    misses = sum(after[c]["misses"] - before[c]["misses"] for c in after)
    assert hits > 0 and misses == 0
    want = _host(queries(js, src, jax_col)[name].collect())
    got = _host(cached)
    assert list(got) == list(want)
    for n in got:
        if n == "revenue":
            np.testing.assert_allclose(got[n].astype(float), want[n].astype(float), rtol=1e-9, atol=0)
        else:
            assert got[n].tolist() == want[n].tolist(), n


def test_the_join_plan_scans_indexes_and_the_lookup_prunes_inside_files(lake):
    ts, _, src = lake
    qs = queries(ts, src, hst.col)
    names = lambda df: sorted(n.relation.index_name for n in df.physical_plan().collect_nodes()
                              if isinstance(n, physical.BucketedIndexScanExec))
    assert names(qs["q3_agg"]) == ["liOrd", "ordIdx"]
    clear()
    before = torch_io.io_stats()["row_groups_skipped"]
    qs["q12_range"].collect()
    assert torch_io.io_stats()["row_groups_skipped"] > before


def test_memos_hit_on_a_repeated_join(lake):
    ts, _, src = lake
    df = queries(ts, src, hst.col)["q_ps"]
    clear()
    df.collect()
    before = physical.memo_stats()
    df.collect()
    df.count()
    after = physical.memo_stats()
    assert after["pairs"]["hits"] - before["pairs"]["hits"] == 2
    assert after["pairs"]["misses"] == before["pairs"]["misses"]
    assert physical.device_cache_stats()["bytes"] > 0


def test_cached_tensors_are_never_written(lake):
    """A filtered join and the aggregate run twice over one cache: every
    cached column keeps its values and its version counter."""
    ts, _, src = lake
    qs = queries(ts, src, hst.col)
    clear()
    for name in ("q_filtered_join", "q3_agg"):
        qs[name].collect()
    held = []
    for cache in (scan_cache.global_scan_cache(), scan_cache.global_bucketed_cache(), scan_cache.global_filtered_cache()):
        for ent in list(cache._entries.values()):
            tables = [ent[0]] if isinstance(ent[0], Table) else []
            cols = list(ent[0].columns.values()) if tables else [ent[0]] if hasattr(ent[0], "data") else []
            for c in cols:
                for t in (c.data, c.validity):
                    if t is not None:
                        held.append((t, t._version, t.clone()))
    assert len(held) > 10
    for _ in range(2):
        for name in ("q_filtered_join", "q3_agg"):
            qs[name].collect()
            qs[name].count()
    for t, version, copy in held:
        assert t._version == version and torch.equal(t, copy)


def test_a_rewritten_file_misses_every_cache_and_memo(tmp_path, monkeypatch):
    monkeypatch.setenv("HYPERSPACE_INDEX_ROW_GROUP_ROWS", "64")
    src = str(tmp_path / "src")
    data = _data(seed=8, n_orders=200)
    for name in ("lineitem", "orders", "partsupp"):
        torch_io.write_parquet(Table.from_pydict(data[name], "cpu"), os.path.join(src, name, "part-00000.parquet"))
    ts = hst.HyperspaceSession(warehouse=str(tmp_path / "wh"), device="cpu")
    ts.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, 4)
    hs = hst.Hyperspace(ts)
    for table, name, indexed, included in INDEXES[:2]:
        hs.create_index(ts.read.parquet(os.path.join(src, table)), hst.IndexConfig(name, indexed, included))
    hst.enable_hyperspace(ts)
    q = lambda: queries(ts, src, hst.col)["q_filtered_join"]  # noqa: E731
    first = q().collect()
    q().collect()
    # Rewrite one bucket file of the lineitem index with the same rows in
    # other row groups: a new size and mtime, the same content.
    scan = next(n for n in q().physical_plan().collect_nodes() if isinstance(n, physical.BucketedIndexScanExec))
    part = scan.relation.files[0].path
    time.sleep(0.01)
    torch_io.write_parquet(torch_io._arrow_to_table(torch_io._read_arrow(part, None)), part, row_group_rows=16)
    before, memo_before = scan_cache.stats(), physical.memo_stats()
    again = q().collect()
    after, memo_after = scan_cache.stats(), physical.memo_stats()
    assert_identical(again, first)
    assert after["scan"]["misses"] > before["scan"]["misses"]
    assert after["filtered"]["misses"] > before["filtered"]["misses"]
    assert memo_after["pairs"]["misses"] > memo_before["pairs"]["misses"]
    # The source file too: a plain scan of new content sees the new content.
    path = os.path.join(src, "orders", "part-00000.parquet")
    orders = ts.read.parquet(os.path.join(src, "orders")).collect()
    time.sleep(0.01)
    torch_io.write_parquet(orders.take(torch.arange(10)), path)
    assert ts.read.parquet(os.path.join(src, "orders")).collect().num_rows == 10


@pytest.mark.parametrize("change", ["append", "delete"])
def test_a_refreshed_index_never_serves_the_previous_generation(tmp_path, monkeypatch, change):
    """The rewritten-file case, for a refresh: an appended file and an
    incremental refresh change the bucketed scan's file list, so its concat
    cache misses; a deleted file and a deletes-only refresh keep the file list
    and change the lineage prune condition, so the filtered concat misses.
    Either way the join memos miss, and the cached run equals an uncached run
    of the new generation and the expected rows, never the old ones."""
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    data = _data(seed=9, n_orders=300)
    src = str(tmp_path / "src")
    li = data["lineitem"]
    n = len(li["l_orderkey"])
    for i, (a, b) in enumerate([(0, n // 3), (n // 3, 2 * n // 3)]):
        part = {k: v[a:b] for k, v in li.items()}
        torch_io.write_parquet(Table.from_pydict(part, "cpu"), os.path.join(src, "lineitem", f"part-{i:05d}.parquet"))
    for name in ("orders", "partsupp"):
        torch_io.write_parquet(Table.from_pydict(data[name], "cpu"), os.path.join(src, name, "part-00000.parquet"))
    ts = hst.HyperspaceSession(warehouse=str(tmp_path / "wh"), device="cpu")
    ts.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, 4)
    ts.conf.set(hst.IndexConstants.INDEX_LINEAGE_ENABLED, "true")
    hs = hst.Hyperspace(ts)
    for table, name, indexed, included in INDEXES[:2]:
        hs.create_index(ts.read.parquet(os.path.join(src, table)), hst.IndexConfig(name, indexed, included))
    hst.enable_hyperspace(ts)
    q = lambda: queries(ts, src, hst.col)["q_ord"]  # noqa: E731
    old = q().collect()
    q().collect()
    if change == "append":
        part = {k: v[2 * n // 3:] for k, v in li.items()}
        torch_io.write_parquet(Table.from_pydict(part, "cpu"), os.path.join(src, "lineitem", "part-00002.parquet"))
        hs.refresh_index("liOrd", "incremental")
        kept = np.arange(n)
    else:
        os.remove(os.path.join(src, "lineitem", "part-00000.parquet"))
        hs.refresh_index("liOrd", "incremental")
        kept = np.arange(n // 3, 2 * n // 3)
    before, memo_before = scan_cache.stats(), physical.memo_stats()
    new = q().collect()
    after, memo_after = scan_cache.stats(), physical.memo_stats()
    cache = "bucketed_concat" if change == "append" else "filtered"
    assert after[cache]["misses"] > before[cache]["misses"]
    assert memo_after["pairs"]["misses"] > memo_before["pairs"]["misses"]
    assert new.num_rows == len(kept) != old.num_rows
    want = np.sort(li["l_extendedprice"][kept])
    np.testing.assert_array_equal(np.sort(new.column("l_extendedprice").data.numpy()), want)
    assert_identical(q().collect(), new)  # cached
    clear()
    assert_identical(q().collect(), new)  # uncached


def test_the_scan_cache_budget_evicts_least_recently_used(tmp_path):
    c = scan_cache.ScanCache(capacity_bytes=1 << 30)
    paths = []
    for i in range(4):
        p = str(tmp_path / f"f{i}.parquet")
        torch_io.write_parquet(Table.from_pydict({"x": np.arange(1000, dtype=np.int64)}, "cpu"), p)
        paths.append(p)
        c.put(p, None, Table.from_pydict({"x": np.arange(1000, dtype=np.int64)}, "cpu"))
    s0 = c.stats()
    assert s0["evictions"] == 0 and s0["bytes"] == 4 * 8000
    assert c.get(paths[0], None) is not None  # now the most recently used
    c.set_capacity(s0["bytes"] // 2)
    s1 = c.stats()
    assert s1["evictions"] == 4 and s1["bytes"] <= s0["bytes"] // 2  # two files: names and column
    alive = [c.get(p, None) is not None for p in paths]
    assert alive == [True, False, False, True]
    meta = torch_io.footer_metadata(paths[0])
    c.put_meta(paths[0], meta, 100)
    assert c.get_meta(paths[0]) is meta


def test_memos_evict_across_tags_in_lru_order_and_die_with_their_tables():
    clear()
    saved = physical.device_cache_stats()["budget"]
    a = Table({"k": hst.engine.table.Column.from_values(np.arange(100, dtype=np.int64), "cpu")})
    b = Table({"k": hst.engine.table.Column.from_values(np.arange(100, dtype=np.int64), "cpu")})
    weakref.ref(a)  # tables take weak references
    try:
        physical.set_device_cache_budget(3 * 800)
        physical._cached_by_table("k64", a, ("k",), lambda: torch.zeros(100, dtype=torch.int64))
        physical._cached_two_table("pairs", a, b, ("x",), lambda: (torch.zeros(50, dtype=torch.int64),) * 2)
        physical._cached_by_table("k64", b, ("k",), lambda: torch.zeros(100, dtype=torch.int64))
        assert physical.device_cache_stats()["bytes"] == 3 * 800
        physical._cached_two_table("cpad", a, b, ("y",), lambda: torch.zeros(100, dtype=torch.int64))
        stats = physical.device_cache_stats()
        assert stats["bytes"] == 3 * 800 and stats["evictions"] >= 1
        assert list(physical._key64_cache) == [id(b)]  # a's key64, the oldest, went first
        del b
        gc.collect()
        assert physical._key64_cache == {} and physical._pairs_cache == {} and physical._classed_cache == {}
        assert physical.device_cache_stats()["bytes"] == 0
    finally:
        physical.set_device_cache_budget(saved)
        clear()


#: Tables and a dictionary held by the child's own globals, so that they die
#: while the interpreter clears its modules, after the engine's.
_EXIT_CHILD = """
import numpy as np
from hyperspace_tpu_torch.engine import physical
from hyperspace_tpu_torch.engine.table import Table
from hyperspace_tpu_torch.ops import hashing

TABLES = [Table.from_pydict({"k": np.arange(10 + i, dtype=np.int64),
                             "s": np.asarray(["a", "b"] * 5 + ["c"] * i)}, "cpu") for i in range(3)]
for t in TABLES:
    physical._table_key64(t, ["k"])
    physical._table_key64(t, ["s"])
    hashing.host_hash_dictionary(t.columns["s"].dictionary, 7)
PAIR = physical._cached_two_table("pairs", TABLES[0], TABLES[1], ("x",), lambda: np.zeros(3))
assert physical.device_cache_stats()["entries"] >= 4
print("alive")
"""


def test_memo_entries_alive_at_interpreter_exit_write_nothing_on_stderr():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _EXIT_CHILD], capture_output=True, text=True, cwd=repo,
                         env=dict(os.environ, PYTHONPATH=repo), timeout=300)
    assert out.returncode == 0 and out.stdout == "alive\n", out.stderr
    assert out.stderr == ""

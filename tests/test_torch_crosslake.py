"""A lake built by either package is queried by the other with equal answers.

Each package builds `test_torch_join.py`'s four indexes over the same source
files in its own warehouse. Then the OTHER package opens that warehouse and
runs q_ord (value-mode join), q_ps (hash-mode join), a range lookup through
`FilterIndexRule` whose row groups are pruned by the footer zone maps, a
join → group-by and the same ordered and limited, a join on a nullable
string key (two more indexes, `nameA` and `nameB`, hash mode), the same as a
left outer join, and an anti join of lineitem with filtered orders. Its rows must equal those of the package that built the
lake, in the same order, first uncached and then from its caches. The JAX
package runs its sort path (`HYPERSPACE_FORCE_DEVICE_OPS=1`), whose group
order is the port's. Tolerance: exact, except the aggregate's float sums
(rtol 1e-9).
"""

import os

import numpy as np
import pytest

import hyperspace_tpu_torch as hst
from hyperspace_tpu import IndexConfig as JaxIndexConfig
from hyperspace_tpu import IndexConstants as JaxIndexConstants
from hyperspace_tpu.engine import HyperspaceSession as JaxSession
from hyperspace_tpu.engine import col as jax_col
from hyperspace_tpu.engine.physical import clear_device_memos as jax_clear_memos
from hyperspace_tpu.engine.scan_cache import (
    global_bucketed_cache,
    global_concat_cache,
    global_filtered_cache,
    global_scan_cache,
)
from hyperspace_tpu.hyperspace import Hyperspace as JaxHyperspace
from hyperspace_tpu.hyperspace import enable_hyperspace as jax_enable
from hyperspace_tpu_torch.engine import io as torch_io
from hyperspace_tpu_torch.engine import physical, scan_cache
from hyperspace_tpu_torch.engine.table import Table
from test_torch_join import INDEXES, NUM_BUCKETS, _tables

FLOAT_SUMS = ("revenue",)


def clear_all():
    for c in (global_scan_cache(), global_concat_cache(), global_filtered_cache(), global_bucketed_cache()):
        c.clear()
    jax_clear_memos()
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()


def queries(s, src, c):
    def rd(name):
        return s.read.parquet(os.path.join(src, name))

    li = rd("lineitem")
    return {
        "q_ord": li.join(rd("orders"), c("l_orderkey") == c("o_orderkey")).select("l_extendedprice", "o_custkey"),
        "q_ps": li.join(rd("partsupp"), (c("l_partkey") == c("ps_partkey")) & (c("l_suppkey") == c("ps_suppkey")))
        .select("l_quantity", "ps_supplycost"),
        "lookup": li.filter((c("l_orderkey") >= 600) & (c("l_orderkey") < 1400)).select("l_orderkey", "l_quantity"),
        "join_group_by": li.join(rd("orders"), c("l_orderkey") == c("o_orderkey"))
        .with_column("revenue", c("l_extendedprice") * (1 - c("l_quantity") / 100))
        .group_by("o_custkey")
        .agg(revenue=("revenue", "sum"), orders=("l_orderkey", "count_distinct"), lines=("*", "count"),
             top=("o_totalprice", "max")),
        "join_order_limit": li.join(rd("orders"), c("l_orderkey") == c("o_orderkey"))
        .group_by("o_custkey")
        .agg(lines=("*", "count"), top=("o_totalprice", "max"))
        .order_by(("lines", False), "o_custkey")
        .limit(20),
        "string_key": rd("names_a").join(rd("names_b"), c("name") == c("nameb")).select("ida", "name", "w"),
        "left_outer": rd("names_a").join(rd("names_b"), c("name") == c("nameb"), "left").select("ida", "name", "w"),
        "anti": li.join(rd("orders").filter(c("o_custkey") < 150), c("l_orderkey") == c("o_orderkey"), "anti")
        .select("l_orderkey", "l_quantity"),
    }


def _name_tables(seed=17):
    """Two sources joined on a nullable string key with different
    dictionaries on each side."""
    rng = np.random.RandomState(seed)
    a = np.array([f"n-{i:04d}" for i in rng.randint(0, 300, 2000)], dtype=object)
    a[::13] = None
    b = np.array([f"n-{i:04d}" for i in rng.randint(100, 400, 300)], dtype=object)
    b[::17] = None
    return {
        "names_a": {"name": a, "ida": np.arange(2000, dtype=np.int64)},
        "names_b": {"nameb": b, "w": rng.rand(300)},
    }


STRING_INDEXES = [("names_a", "nameA", ["name"], ["ida"]), ("names_b", "nameB", ["nameb"], ["w"])]


def _session(pkg, warehouse):
    if pkg == "torch":
        s = hst.HyperspaceSession(warehouse=warehouse, device="cpu")
        s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
        return s, hst.Hyperspace(s), hst.IndexConfig, hst.enable_hyperspace, hst.col
    s = JaxSession(warehouse=warehouse)
    s.conf.set(JaxIndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    return s, JaxHyperspace(s), JaxIndexConfig, jax_enable, jax_col


@pytest.fixture(scope="module")
def lakes(tmp_path_factory):
    base = tmp_path_factory.mktemp("crosslake")
    mp = pytest.MonkeyPatch()
    mp.setenv("HYPERSPACE_DISTRIBUTED", "0")
    mp.setenv("HYPERSPACE_BUILD_DECODE_THREADS", "1")
    mp.setenv("HYPERSPACE_INDEX_ROW_GROUP_ROWS", "256")
    mp.setenv("HYPERSPACE_FORCE_DEVICE_OPS", "1")
    src = str(base / "src")
    for name, cols in dict(_tables(11, False), **_name_tables()).items():
        torch_io.write_parquet(Table.from_pydict(cols, "cpu"), os.path.join(src, name, "part-00000.parquet"))
    for pkg in ("torch", "jax"):
        s, hs, cfg, enable, _ = _session(pkg, str(base / pkg))
        for table, name, indexed, included in INDEXES + STRING_INDEXES:
            hs.create_index(s.read.parquet(os.path.join(src, table)), cfg(name, indexed, included))
    yield base, src
    mp.undo()


def _host(t):
    return {n: np.asarray(c.decode_objects(), dtype=object) for n, c in t.columns.items()}


def _equal(got, want):
    g, w = _host(got), _host(want)
    assert list(g) == list(w)
    for n in g:
        if n in FLOAT_SUMS:
            np.testing.assert_allclose(g[n].astype(float), w[n].astype(float), rtol=1e-9, atol=0)
        else:
            assert g[n].tolist() == w[n].tolist(), n


@pytest.mark.parametrize("owner,reader", [("jax", "torch"), ("torch", "jax")])
@pytest.mark.parametrize(
    "query", ["q_ord", "q_ps", "lookup", "join_group_by", "join_order_limit", "string_key", "left_outer", "anti"]
)
def test_a_lake_is_queried_by_the_other_package(lakes, owner, reader, query):
    base, src = lakes
    warehouse = str(base / owner)
    so, _, _, enable_o, co = _session(owner, warehouse)
    enable_o(so)
    want = queries(so, src, co)[query].collect()
    assert want.num_rows > 0
    sr, _, _, enable_r, cr = _session(reader, warehouse)
    enable_r(sr)
    df = queries(sr, src, cr)[query]
    plan = df.explain_string() if reader == "torch" else df.physical_plan().tree_string()
    index = {"q_ps": "liPs", "q_ord": "liOrd", "lookup": "liOrd", "join_group_by": "ordIdx",
             "join_order_limit": "ordIdx", "string_key": "nameB", "left_outer": "nameB", "anti": "ordIdx"}[query]
    assert f"index={index}" in plan, plan
    clear_all()
    before = torch_io.io_stats()["row_groups_skipped"]
    _equal(df.collect(), want)  # uncached
    if query == "lookup" and reader == "torch":
        assert torch_io.io_stats()["row_groups_skipped"] > before
    _equal(df.collect(), want)  # from the reader's caches


# ---------------------------------------------------------------------------
# The lifecycle across packages: each runs the next transition on the lake
# the other wrote, and both query it after every step.
# ---------------------------------------------------------------------------


def _lifecycle_session(pkg, warehouse):
    s, hs, cfg, enable, c = _session(pkg, warehouse)
    k = hst.IndexConstants if pkg == "torch" else JaxIndexConstants
    s.conf.set(k.INDEX_NUM_BUCKETS, 4)
    s.conf.set(k.INDEX_LINEAGE_ENABLED, "true")
    s.conf.set(k.INDEX_CACHE_EXPIRY_DURATION_SECONDS, 0)
    enable(s)
    return s, hs, cfg, c


def _write_file(src, name, cols):
    torch_io.write_parquet(Table.from_pydict(cols, "cpu"), os.path.join(src, name))


def _lifecycle_rows(s, c, src, r):
    """The join and a range lookup over the lake's current source."""
    li = s.read.parquet(src)
    return (
        li.join(s.read.parquet(r), c("k") == c("k2")).select("k", "s", "w").collect(),
        li.filter((c("k") >= 40) & (c("k") < 90)).select("k", "s").collect(),
    )


LIFECYCLE_STEPS = [
    ("append, incremental", "refresh_index", ("li", "incremental"), "ACTIVE"),
    ("delete a file, auto", "refresh_index", ("li", "auto"), "ACTIVE"),
    ("full", "refresh_index", ("li", "full"), "ACTIVE"),
    ("delete", "delete_index", ("li",), "DELETED"),
    ("restore", "restore_index", ("li",), "ACTIVE"),
    ("delete again", "delete_index", ("li",), "DELETED"),
    ("vacuum", "vacuum_index", ("li",), "DOESNOTEXIST"),
]


@pytest.mark.parametrize("owner", ["jax", "torch"])
def test_each_package_runs_the_next_transition_on_the_others_lake(tmp_path, monkeypatch, owner):
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    monkeypatch.setenv("HYPERSPACE_BUILD_DECODE_THREADS", "1")
    rng = np.random.RandomState(21)
    src, r = str(tmp_path / "l"), str(tmp_path / "r")

    def keyed(keys):
        return {"k": np.asarray(keys, np.int64), "s": np.array(["p", "q", "r"])[np.arange(len(keys)) % 3]}

    _write_file(src, "part-00000.parquet", keyed(rng.randint(0, 150, 400)))
    _write_file(src, "part-00001.parquet", keyed(rng.randint(0, 150, 300)))
    _write_file(r, "part-00000.parquet", {"k2": np.arange(0, 150, 2, dtype=np.int64), "w": rng.rand(75)})
    warehouse = str(tmp_path / "lake")
    sessions = {pkg: _lifecycle_session(pkg, warehouse) for pkg in ("torch", "jax")}
    s, hs, cfg, _ = sessions[owner]
    hs.create_index(s.read.parquet(src), cfg("li", ["k"], ["s"]))
    hs.create_index(s.read.parquet(r), cfg("ri", ["k2"], ["w"]))
    other = "torch" if owner == "jax" else "jax"
    for i, (label, method, args, state) in enumerate(LIFECYCLE_STEPS):
        if label.startswith("append"):
            _write_file(src, "part-00002.parquet", keyed(rng.randint(0, 150, 200)))
        if label.startswith("delete a file"):
            os.remove(os.path.join(src, "part-00000.parquet"))
        actor = other if i % 2 == 0 else owner
        getattr(sessions[actor][1], method)(*args)
        for pkg in ("torch", "jax"):
            states = {e.name: e.state for e in sessions[pkg][1]._manager.get_indexes()}
            assert states["li"] == state, (label, pkg, states)
        ts, _, _, tc = sessions["torch"]
        plan = ts.read.parquet(src).filter(tc("k") == 3).select("k", "s").explain_string()
        assert ("index=li" in plan) == (state == "ACTIVE"), (label, plan)
        clear_all()
        got = _lifecycle_rows(ts, tc, src, r)
        js, _, _, jc = sessions["jax"]
        want = _lifecycle_rows(js, jc, src, r)
        for g, w in zip(got, want):
            assert g.num_rows > 0, label
            _equal(g, w)

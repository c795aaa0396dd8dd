"""Explain, plan serialization, views and the index cache in the port against
the JAX package.

Every case of `tests/test_explain_serde.py` (display modes, `BufferStream`,
`Hyperspace.explain`, the plan round trips, the index cache and its factory),
the view cases of `tests/test_e2e_rules.py:500-561`, and a plan-text oracle:
for the queries of `tests/test_e2e_rules.py`, `explain_string()` and
`Hyperspace.explain(..., verbose=True)` equal the JAX package's text, the
index system path aside; each query's serialized plan equals the JAX
package's as decoded JSON; and each package runs the other's serialized
plan to the same rows in the same order. Tolerance 0.
"""

import base64
import json
import re
import time

import numpy as np
import pytest

import hyperspace_tpu_torch as hst
from hyperspace_tpu.config import SessionConf as JaxSessionConf
from hyperspace_tpu.engine.session import DataFrame as JaxDataFrame
from hyperspace_tpu.plananalysis import BufferStream as JaxBufferStream
from hyperspace_tpu.plananalysis import create_display_mode as jax_create_display_mode
from hyperspace_tpu.serde import deserialize_plan as jax_deserialize
from hyperspace_tpu.serde import serialize_plan as jax_serialize
from hyperspace_tpu_torch.config import IndexConstants, SessionConf
from hyperspace_tpu_torch.engine import physical, scan_cache
from hyperspace_tpu_torch.engine.physical import SortMergeJoinExec
from hyperspace_tpu_torch.engine.session import DataFrame
from hyperspace_tpu_torch.hyperspace import is_hyperspace_enabled
from hyperspace_tpu_torch.index.collection_manager import (
    CachingIndexCollectionManager,
    IndexCache,
    IndexCacheFactory,
)
from hyperspace_tpu_torch.plananalysis import (
    BufferStream,
    ConsoleMode,
    HTMLMode,
    PlainTextMode,
    create_display_mode,
)
from hyperspace_tpu_torch.serde import deserialize_plan, serialize_plan
from test_torch_aggregate import assert_same
from test_torch_udf_setops import Twin

SAMPLE = {
    "c1": np.array(["a", "b", "c", "d"]),
    "c2": np.array([1, 2, 3, 4]),
    "c3": np.array(["x", "x", "y", "y"]),
}


@pytest.fixture(autouse=True)
def _reference_path(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    monkeypatch.setenv("HYPERSPACE_FORCE_DEVICE_OPS", "1")
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()


def _explain(side, q, verbose=False) -> str:
    out = []
    side.hs.explain(q, verbose=verbose, redirect=out.append)
    return out[0].replace(side.idx, "<indexes>")


def _decoded(s: str) -> dict:
    return json.loads(base64.b64decode(s))


# -- tests/test_explain_serde.py: display modes ----------------------------------


def test_plaintext_default_tags():
    assert PlainTextMode(SessionConf()).highlight_tag == ("<----", "---->")


@pytest.mark.parametrize("mode", ["plaintext", "html", "console"])
def test_display_modes_write_the_jax_text(mode):
    texts = []
    for conf, make, stream in ((SessionConf(), create_display_mode, BufferStream),
                               (JaxSessionConf(), jax_create_display_mode, JaxBufferStream)):
        conf.set(IndexConstants.DISPLAY_MODE, mode)
        b = stream(make(conf))
        b.write_line("x").highlight("y").write("z").highlight_line("w")
        texts.append(b.to_string())
    assert texts[0] == texts[1]
    if mode == "html":
        assert isinstance(create_display_mode(SessionConf({IndexConstants.DISPLAY_MODE: "HTML"})), HTMLMode)
        assert texts[0].startswith('<pre>x<br/><b style="background: #ff9900">y</b>')


def test_tags_overridable_via_conf():
    conf = SessionConf()
    conf.set(IndexConstants.DISPLAY_MODE, "console")
    conf.set(IndexConstants.HIGHLIGHT_BEGIN_TAG, ">>")
    conf.set(IndexConstants.HIGHLIGHT_END_TAG, "<<")
    m = create_display_mode(conf)
    assert isinstance(m, ConsoleMode) and m.highlight_tag == (">>", "<<")
    conf.set(IndexConstants.DISPLAY_MODE, "pdf")
    with pytest.raises(hst.HyperspaceException, match="Display mode: pdf not supported"):
        create_display_mode(conf)


# -- tests/test_explain_serde.py: explain -----------------------------------------


def test_explain_shows_diff_and_indexes_used(tmp_path):
    twin = Twin(tmp_path, buckets=4)
    twin.write("t", SAMPLE)
    texts = []
    for p in (twin.t, twin.j):
        p.index("t", "exIdx", ["c3"], ["c2"])
        texts.append(_explain(p, p.read("t").filter(p.col("c3") == "x").select("c2"), verbose=True))
    s = texts[0]
    assert s == texts[1]
    for part in ("Plan with indexes:", "Plan without indexes:", "exIdx", "<----", "Physical operator stats:", "Scan"):
        assert part in s


def test_explain_join_counts_eliminated_exchanges(tmp_path):
    twin = Twin(tmp_path, buckets=4)
    twin.write("l", {"k": np.array([1, 2, 3]), "v": np.array([1, 2, 3])})
    twin.write("r", {"k2": np.array([1, 2, 3]), "w": np.array([4, 5, 6])})
    texts = []
    for p in (twin.t, twin.j):
        p.index("l", "lIdx", ["k"], ["v"])
        p.index("r", "rIdx", ["k2"], ["w"])
        texts.append(_explain(p, p.read("l").join(p.read("r"), p.col("k") == p.col("k2")).select("v", "w"), True))
    assert texts[0] == texts[1]
    assert re.search(r"ShuffleExchange\s*\|\s*2\|\s*0\|\s*-2", texts[0]), texts[0]


def test_explain_leaves_session_state(tmp_path):
    twin = Twin(tmp_path, buckets=4)
    twin.write("t", SAMPLE)
    p = twin.t
    p.index("t", "stIdx", ["c3"], ["c2"])
    q = p.read("t").filter(p.col("c3") == "x").select("c2")
    assert not is_hyperspace_enabled(p.s)
    p.hs.explain(q, redirect=lambda s: None)
    assert not is_hyperspace_enabled(p.s)
    p.on(p.s)
    p.hs.explain(q, redirect=lambda s: None)
    assert is_hyperspace_enabled(p.s)


def test_explain_prints_without_redirect_and_dataframe_explain(tmp_path, capsys):
    twin = Twin(tmp_path, buckets=4)
    twin.write("t", SAMPLE)
    p = twin.t
    q = p.read("t").filter(p.col("c3") == "x")
    p.hs.explain(q)
    assert "Plan with indexes:" in capsys.readouterr().out
    assert q.explain() == q.explain_string() == twin.j.read("t").filter(twin.j.col("c3") == "x").explain()
    got = []
    assert q.explain(redirect=got.append) is None and got == [q.explain_string()]
    analyzed = q.explain(analyze=True)
    tree = analyzed.split("Rule decisions:")[0]
    assert "EXPLAIN ANALYZE" in tree and "rows=" + str(q.count()) in tree
    assert q.explain_string().splitlines()[0] in tree
    got.clear()
    assert q.explain(analyze=True, redirect=got.append) is None and "Resource ledger (this query):" in got[0]


# -- tests/test_explain_serde.py: plan serialization -----------------------------


def test_roundtrip_filter_project(tmp_path):
    twin = Twin(tmp_path, buckets=4)
    twin.write("t", SAMPLE)
    tdf, jdf = twin.both(lambda p: p.read("t").filter((p.col("c2") > 1) & (p.col("c3") == "y")).select("c1", "c2"))
    restored = deserialize_plan(serialize_plan(tdf.plan))
    assert restored.tree_string() == tdf.plan.tree_string() == jdf.plan.tree_string()
    assert DataFrame(twin.t.s, restored).sorted_rows() == tdf.sorted_rows() == jdf.sorted_rows()


def test_roundtrip_join_with_bucketspec(tmp_path):
    twin = Twin(tmp_path, buckets=4)
    twin.write("l", {"k": np.array([1])})
    twin.write("r", {"k2": np.array([1])})
    j = twin.t.read("l").join(twin.t.read("r"), hst.col("k") == hst.col("k2"))
    assert deserialize_plan(serialize_plan(j.plan)).tree_string() == j.plan.tree_string()
    # An index relation's bucket spec survives the trip.
    twin.t.index("l", "bIdx", ["k"], [])
    twin.t.index("r", "bIdxR", ["k2"], [])
    twin.t.on(twin.t.s)
    opt = j.optimized_plan()
    back = deserialize_plan(serialize_plan(opt))
    assert back.tree_string() == opt.tree_string() and "index=bIdx" in back.tree_string()
    spec = [n.relation.bucket_spec for n in back.collect_nodes() if hasattr(n, "relation") and n.relation.index_name]
    assert spec and spec[0].num_buckets == 4 and spec[0].bucket_columns == ("k",)


def test_roundtrip_isnull_isin(tmp_path):
    twin = Twin(tmp_path, buckets=4)
    twin.write("t", SAMPLE)
    c = hst.col
    df = twin.t.read("t").filter(c("c1").is_null() | ~c("c2").is_null() | c("c2").isin(1, 2)).select("c1")
    assert deserialize_plan(serialize_plan(df.plan)).tree_string() == df.plan.tree_string()


def test_version_check():
    bad = base64.b64encode(json.dumps({"version": "99", "plan": {}}).encode()).decode()
    with pytest.raises(hst.HyperspaceException, match="version"):
        deserialize_plan(bad)


def test_union_plan_round_trip(tmp_path):
    twin = Twin(tmp_path, buckets=4)
    twin.write("t", {"k": np.array([1, 2, 3], dtype=np.int64)})
    tdf, jdf = twin.both(lambda p: p.read("t").filter(p.col("k") > 1).union(p.read("t")))
    assert deserialize_plan(serialize_plan(tdf.plan)).tree_string() == tdf.plan.tree_string()
    assert _decoded(serialize_plan(tdf.plan)) == _decoded(jax_serialize(jdf.plan))


# -- tests/test_explain_serde.py: the index cache --------------------------------


def test_ttl_and_mutation_clear(tmp_path):
    twin = Twin(tmp_path, buckets=4)
    twin.write("t", SAMPLE)
    s = twin.t.s
    mgr = CachingIndexCollectionManager(s)
    mgr.create(twin.t.read("t"), hst.IndexConfig("cIdx", ["c3"], ["c2"]))
    assert [e.name for e in mgr.get_indexes()] == ["cIdx"]
    mgr._cache.set([])
    assert mgr.get_indexes() == []
    mgr.delete("cIdx")
    assert [e.state for e in mgr.get_indexes()] == ["DELETED"]
    s.conf.set(IndexConstants.INDEX_CACHE_EXPIRY_DURATION_SECONDS, 0)
    mgr._cache.set([])
    time.sleep(0.01)
    assert [e.name for e in mgr.get_indexes()] == ["cIdx"]


def test_pluggable_cache_injected_via_factory(tmp_path):
    calls = {"get": 0, "set": 0, "clear": 0}

    class SpyCache(IndexCache):
        def __init__(self):
            self._entries = None

        def get(self):
            calls["get"] += 1
            return self._entries

        def set(self, entries):
            calls["set"] += 1
            self._entries = list(entries)

        def clear(self):
            calls["clear"] += 1
            self._entries = None

    twin = Twin(tmp_path, buckets=4)
    s = twin.t.s
    IndexCacheFactory.register("SPY", lambda session: SpyCache())
    s.conf.set(IndexConstants.INDEX_CACHE_TYPE, "spy")
    mgr = CachingIndexCollectionManager(s)
    mgr.get_indexes()
    assert calls["get"] == 1 and calls["set"] == 1
    mgr.get_indexes()
    assert calls["get"] == 2 and calls["set"] == 1
    twin.write("t", SAMPLE)
    mgr.create(twin.t.read("t"), hst.IndexConfig("cIdx", ["c3"], ["c2"]))
    assert calls["clear"] >= 1


def test_unknown_cache_type_raises(tmp_path):
    with pytest.raises(hst.HyperspaceException, match="cache type"):
        IndexCacheFactory.create("NOPE", Twin(tmp_path).t.s)


# -- tests/test_e2e_rules.py: views ----------------------------------------------


def _views_lake(twin):
    n = 40
    twin.write("lineitem", {"orderkey": np.arange(n) % 13, "qty": np.arange(n)})
    twin.write("orders", {"o_orderkey": np.arange(13), "o_custkey": np.arange(13) % 11})
    for p in (twin.t, twin.j):
        p.index("lineitem", "vLi", ["orderkey"], ["qty"])
        p.index("orders", "vOrd", ["o_orderkey"], ["o_custkey"])
        p.s.create_view("li_view", p.read("lineitem"))
        p.s.create_view("ord_view", p.read("orders"))


def _view_join(p, payload="o_custkey"):
    return p.s.read.view("li_view").join(p.s.read.view("ORD_VIEW"), p.col("orderkey") == p.col("o_orderkey")).select(
        "qty", payload)


def test_join_over_views_uses_bucketed_index_scans(tmp_path):
    twin = Twin(tmp_path)
    _views_lake(twin)
    for p in (twin.t, twin.j):
        p.off(p.s)
    expected = twin.same(_view_join).sorted_rows()
    for p in (twin.t, twin.j):
        p.on(p.s)
    got = twin.same(_view_join)
    assert got.sorted_rows() == expected
    tplan, jplan = twin.both(lambda p: p.plan(_view_join(p)))
    assert tplan == jplan and "index=vLi" in tplan and "index=vOrd" in tplan
    joins = [n for n in _view_join(twin.t).physical_plan().collect_nodes() if isinstance(n, SortMergeJoinExec)]
    assert joins and joins[0].bucketed


def test_view_crud(tmp_path):
    twin = Twin(tmp_path)
    twin.write("t", SAMPLE)
    for p in (twin.t, twin.j):
        df = p.read("t")
        p.s.create_view("v1", df)
        assert p.s.read.view("v1").count() == 4
        with pytest.raises(p.error, match="already exists"):
            p.s.create_view("V1", df.select("c2"), replace=False)
        p.s.create_view("v1", df.select("c2"))
        assert p.s.read.view("v1").schema.names == ["c2"]
        assert p.s.drop_view("v1") is True
        assert p.s.drop_view("v1") is False
        with pytest.raises(p.error, match="not found"):
            p.s.read.view("v1")


# -- the plan-text oracle over tests/test_e2e_rules.py's queries ----------------


E2E_SAMPLE = {
    "c1": np.array(["2017-09-03", "2017-09-03", "2018-09-03", "2019-10-03", "2019-10-03"]),
    "c2": np.array([412, 411, 362, 322, 322]),
    "c3": np.array(["facebook", "facebook", "donde", "facebook", "ibraco"]),
    "c4": np.array([1, 1, 3, 5, 7]),
    "c5": np.array(["productmanager", "areamanager", "areamanager", "productmanager", "areamanager"]),
}


def _e2e_queries():
    """name → query(side), over the sources and indexes `e2e_lake` builds
    (each test of `tests/test_e2e_rules.py` named by its first words)."""
    def join(l, r, a, b, cols, lf=None, rf=None):
        def q(p):
            lt, rt = p.read(l), p.read(r)
            if lf is not None:
                lt = lt.filter(lf(p.col))
            if rf is not None:
                rt = rt.filter(rf(p.col))
            return lt.join(rt, p.col(a) == p.col(b)).select(*cols)
        return q

    return {
        "point_lookup": lambda p: p.read("depts").filter(p.col("deptId") == 30).select("deptName"),
        "filter_without_project": lambda p: p.read("t").filter(p.col("c3") == "facebook"),
        "not_covering": lambda p: p.read("t").filter(p.col("c3") == "facebook").select("c1"),
        "not_head_column": lambda p: p.read("t").filter(p.col("c2") == 322).select("c1"),
        "case_insensitive": lambda p: p.read("t").filter(p.col("c3") == "facebook").select("C2"),
        "join_both_indexes": join("lineitem", "orders", "orderkey", "o_orderkey", ("qty", "o_status")),
        "join_filters_on_sides": join("lineitem", "orders", "orderkey", "o_orderkey", ("qty", "o_status"),
                                      lambda c: c("qty") > 10, lambda c: c("o_status") == "O"),
        "join_one_side_missing": join("lineitem_b", "orders_b", "orderkey", "o_orderkey", ("qty", "o_status")),
        "join_side_projection": lambda p: p.read("wide").select("orderkey", "qty").join(
            p.read("o2"), p.col("orderkey") == p.col("o_orderkey")).select("qty", "o_status"),
        "join_superset_index": join("l2", "r2", "a", "a2", ("v", "w")),
        "join_over_views": lambda p: _view_join(p, "o_status"),
        "intersect_of_joins": lambda p: join("lineitem", "orders", "orderkey", "o_orderkey", ("qty", "o_status"))(p)
        .intersect(join("lineitem", "orders", "orderkey", "o_orderkey", ("qty", "o_status"),
                        lambda c: c("qty") > 10)(p)).distinct(),
    }


E2E = _e2e_queries()


@pytest.fixture(scope="module")
def e2e_lake(tmp_path_factory):
    twin = Twin(tmp_path_factory.mktemp("e2e"))
    rng = np.random.RandomState(7)
    n = 50
    lineitem = {"orderkey": rng.randint(0, n, n * 4).astype(np.int64), "qty": rng.randint(1, 50, n * 4).astype(np.int64)}
    orders = {"o_orderkey": np.arange(n, dtype=np.int64), "o_status": np.array([["O", "F", "P"][i % 3] for i in range(n)])}
    twin.write("depts", {"deptId": np.array([10, 20, 30, 40, 50]),
                         "deptName": np.array(["Accounting", "Research", "Sales", "Operations", "Marketing"]),
                         "loc": np.array(["NY", "DL", "CH", "BO", "SF"])})
    twin.write("t", E2E_SAMPLE)
    for t in ("lineitem", "lineitem_b"):
        twin.write(t, lineitem)
    for t in ("orders", "orders_b"):
        twin.write(t, orders)
    twin.write("wide", {"orderkey": np.array([1, 2]), "qty": np.array([5, 6]), "extra1": np.array([0, 0]),
                        "extra2": np.array([0, 0])})
    twin.write("o2", {"o_orderkey": np.array([1, 2]), "o_status": np.array(["O", "F"])})
    twin.write("l2", {"a": np.array([1, 2]), "b": np.array([1, 2]), "v": np.array([5, 6])})
    twin.write("r2", {"a2": np.array([1, 2]), "w": np.array([7, 8])})
    indexes = [("depts", "deptIndex", ["deptId"], ["deptName"]), ("t", "idxAll", ["c3"], ["c1", "c2", "c4", "c5"]),
               ("t", "headidx", ["c3", "c2"], ["c1"]), ("t", "ciidx", ["C3"], ["c2"]),
               ("lineitem", "liIdx", ["orderkey"], ["qty"]), ("orders", "ordIdx", ["o_orderkey"], ["o_status"]),
               ("lineitem_b", "liIdxB", ["orderkey"], ["qty"]), ("orders_b", "ordIdxB", ["o_orderkey"], ["o_status"]),
               ("wide", "wideIdx", ["orderkey"], ["qty"]), ("o2", "o2Idx", ["o_orderkey"], ["o_status"]),
               ("l2", "two", ["a", "b"], ["v"]), ("r2", "one", ["a2"], ["w"])]
    mp = pytest.MonkeyPatch()
    mp.setenv("HYPERSPACE_DISTRIBUTED", "0")
    for p in (twin.t, twin.j):
        for table, name, indexed, included in indexes:
            p.index(table, name, indexed, included)
        p.hs.delete_index("ordIdxB")
    mp.undo()
    _views_lake_views(twin)
    for p in (twin.t, twin.j):
        p.on(p.s)
    yield twin
    physical.clear_device_memos()


def _views_lake_views(twin):
    """The views of `_view_join` over the lineitem and orders of `e2e_lake`."""
    for p in (twin.t, twin.j):
        p.s.create_view("li_view", p.read("lineitem"))
        p.s.create_view("ord_view", p.read("orders"))


@pytest.mark.parametrize("name", sorted(E2E))
def test_plan_text_equals_jax(e2e_lake, name):
    twin = e2e_lake
    q = E2E[name]
    tplan, jplan = twin.both(lambda p: p.plan(q(p)))
    assert tplan == jplan
    texts = twin.both(lambda p: _explain(p, q(p), verbose=True))
    assert texts[0] == texts[1]
    assert twin.t.s.extra_optimizations and twin.j.s.extra_optimizations  # explain restored the state
    twin.same(q)


@pytest.mark.parametrize("name", sorted(E2E))
def test_serialized_plans_equal_jax_and_run_in_the_other_package(e2e_lake, name):
    twin = e2e_lake
    q = E2E[name]
    tdf, jdf = twin.both(q)
    ts, js = serialize_plan(tdf.plan), jax_serialize(jdf.plan)
    assert _decoded(ts) == _decoded(js)
    want = tdf.collect()
    assert_same(DataFrame(twin.t.s, deserialize_plan(js)).collect(), want)
    assert_same(JaxDataFrame(twin.j.s, jax_deserialize(ts)).collect(), want)
    assert_same(DataFrame(twin.t.s, deserialize_plan(ts)).collect(), want)

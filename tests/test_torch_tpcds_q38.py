"""TPC-DS Q38 and Q87 in the port against the JAX package and numpy, with and
without their covering indexes.

`chip_smoke.py`'s generator makes the five tables at a small size
(`setops_tables`: a few thousand sales lines a channel over three months
around 2000-01, 300 customers with few names, a fifth of the year-2000 store
tickets repeated by a catalog and a web order). Its `q38_query` and
`q87_query` run in both packages on the same files: each channel's
sales ⋈ customer (co-bucketed over ssCust, csCust or wsCust and custIdx,
8 buckets, or a general join), a general join to date_dim's year 2000, the
distinct (c_last_name, c_first_name, d_date), then INTERSECT or EXCEPT. The
port must give the JAX package's rows in its order and its counts, numpy's
sets (`expected_setops`), and index files sha256-identical to the JAX
package's; the union, the views, the UDF, explain and the serialized plan
as phase setops runs them. Tolerance 0.
"""

import os

import numpy as np
import pytest

import chip_smoke
import hyperspace_tpu_torch as hst
from hyperspace_tpu.engine.session import DataFrame as JaxDataFrame
from hyperspace_tpu.serde import deserialize_plan as jax_deserialize
from hyperspace_tpu.serde import serialize_plan as jax_serialize
from hyperspace_tpu_torch.engine import physical, scan_cache
from hyperspace_tpu_torch.engine.physical import SortMergeJoinExec
from hyperspace_tpu_torch.engine.session import DataFrame
from hyperspace_tpu_torch.serde import deserialize_plan, serialize_plan
from test_torch_aggregate import assert_same
from test_torch_refresh import _sha
from test_torch_udf_setops import Twin

NUM_BUCKETS = 8
QUERIES = {"q38": chip_smoke.q38_query, "q87": chip_smoke.q87_query}
INDEX_NAMES = sorted(name for _, name, _, _ in chip_smoke.SETOPS_INDEXES)


@pytest.fixture(scope="module")
def lake(tmp_path_factory):
    rng = np.random.RandomState(5)
    tables = chip_smoke.setops_tables(rng, 4000, 2000, 1000, 300, 40, 60, chip_smoke.days("1999-12-01"),
                                      chip_smoke.days("2000-02-29"), plant_share=0.2)
    twin = Twin(tmp_path_factory.mktemp("q38"), buckets=NUM_BUCKETS)
    for t, cols in tables.items():
        twin.write(t, cols)
    mp = pytest.MonkeyPatch()
    mp.setenv("HYPERSPACE_DISTRIBUTED", "0")
    for p in (twin.t, twin.j):
        for table, name, indexed, included in chip_smoke.SETOPS_INDEXES:
            p.index(table, name, indexed, included)
    mp.undo()
    yield twin, tables, chip_smoke.expected_setops(tables)
    physical.clear_device_memos()


@pytest.fixture(autouse=True)
def _reference_path(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    monkeypatch.setenv("HYPERSPACE_FORCE_DEVICE_OPS", "1")
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()


def _indexed(twin, on: bool) -> None:
    for p in (twin.t, twin.j):
        (p.on if on else p.off)(p.s)


def test_the_lake_is_not_trivial(lake):
    _, _, want = lake
    assert 5 <= len(want["q38"]) < len(want["store_sales"])
    assert 5 <= len(want["q87"]) < len(want["store_sales"])
    assert any(None in row for row in want["store_sales"])


def test_the_index_files_equal_jax(lake):
    twin = lake[0]
    for name in INDEX_NAMES:
        shas = []
        for p in (twin.t, twin.j):
            d = os.path.join(p.idx, name, "v__=0")
            shas.append({f: _sha(os.path.join(d, f)) for f in sorted(os.listdir(d))})
        assert shas[0] == shas[1] and len(shas[0]) == NUM_BUCKETS


@pytest.mark.parametrize("query", sorted(QUERIES))
@pytest.mark.parametrize("indexed", [True, False], ids=["indexed", "disabled"])
def test_rows_and_counts_equal_jax_and_numpy(lake, query, indexed):
    twin, _, want = lake
    _indexed(twin, indexed)
    make = QUERIES[query]
    got = twin.same(lambda p: make(p.read, p.col))
    assert set(chip_smoke.row_set(got)) == want[query]
    store = chip_smoke.row_set(chip_smoke.channel_branch(twin.t.read, hst.col, "store_sales").collect())
    chip_smoke.check_setop_rows(query, chip_smoke.row_set(got), want[query], store)
    assert twin.both(lambda p: make(p.read, p.col).count()) == (len(want[query]),) * 2
    q = make(twin.t.read, hst.col)
    joins = sorted(j.bucketed for j in q.physical_plan().collect_nodes() if isinstance(j, SortMergeJoinExec))
    assert joins == ([False, False, False, True, True, True] if indexed else [False] * 6)
    assert sorted(set(chip_smoke.scanned_indexes(q))) == (INDEX_NAMES if indexed else [])


def test_union_distinct_views_and_udf_equal_jax_and_numpy(lake):
    twin, _, want = lake
    _indexed(twin, True)

    def union(p):
        store, catalog, web = (chip_smoke.channel_branch(p.read, p.col, t) for t in chip_smoke.CHANNELS)
        return store.union(catalog).union(web).distinct()

    assert set(chip_smoke.row_set(twin.same(union))) == want["union"]

    def via_views(p):
        for t in chip_smoke.CHANNELS:
            p.s.create_view(f"{t}_branch", chip_smoke.channel_branch(p.read, p.col, t))
        v = p.s.read.view
        return v("store_sales_branch").intersect(v("CATALOG_SALES_BRANCH")).intersect(v("web_sales_branch"))

    assert set(chip_smoke.row_set(twin.same(via_views))) == want["q38"]
    assert sorted(set(chip_smoke.scanned_indexes(via_views(twin.t)))) == INDEX_NAMES

    def by_initial(p):
        f = p.udf(chip_smoke.last_initial, "string")
        q = chip_smoke.q38_query(p.read, p.col)
        return q.with_column("initial", f(p.col("c_last_name"))).group_by("initial").agg(n=("*", "count"))

    got = twin.same(by_initial).to_numpy()
    counts = {}
    for last, _, _ in want["q38"]:
        counts[chip_smoke.last_initial(last)] = counts.get(chip_smoke.last_initial(last), 0) + 1
    assert dict(zip(got["initial"].tolist(), got["n"].tolist())) == counts
    scalars = twin.both(lambda p: chip_smoke.q38_query(p.read, p.col).group_by().agg(n=("d_date", "count")).scalar())
    assert scalars == (len(want["q38"]),) * 2


def test_explain_and_serde_equal_jax(lake):
    twin, _, want = lake
    _indexed(twin, True)
    texts, plans = [], []
    for p in (twin.t, twin.j):
        out = []
        q = chip_smoke.q38_query(p.read, p.col)
        p.hs.explain(q, verbose=True, redirect=out.append)
        texts.append(out[0].replace(p.idx, "<indexes>"))
        plans.append(q.plan)
    assert texts[0] == texts[1]
    assert "ShuffleExchange" in texts[0] and all(f"{n}:<indexes>" in texts[0] for n in INDEX_NAMES)
    back = DataFrame(twin.t.s, deserialize_plan(jax_serialize(plans[1])))
    assert back.count() == len(want["q38"])
    assert back.explain_string() == chip_smoke.q38_query(twin.t.read, hst.col).explain_string()
    assert_same(JaxDataFrame(twin.j.s, jax_deserialize(serialize_plan(plans[0]))).collect(), back.collect())

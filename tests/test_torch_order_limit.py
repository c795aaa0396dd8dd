"""ORDER BY and LIMIT in the port against the JAX package.

The cases of `tests/test_aggregate.py:212-237` (nulls first ascending, last
descending; strings by dictionary order) and of `tests/test_engine.py:429-462`
(a limit over a multi-file plain scan decodes only the files it needs), plus
the float keys a device sort could split: NaN (all NaNs tie, after +inf) and
±0.0 (they tie), under ascending and descending keys, with a row id beside
them that shows the stable order. The same files go through both packages
and the port must return the JAX package's rows in its order with its
schema. Tolerance 0.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu_torch as hst
from hyperspace_tpu.engine import HyperspaceSession as JaxSession
from hyperspace_tpu.engine import col as jax_col
from hyperspace_tpu_torch.engine import physical, scan_cache
from hyperspace_tpu_torch.engine.physical import LimitExec, OrderByExec
from hyperspace_tpu_torch.engine.table import Table
from test_torch_aggregate import assert_same, host_rows


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()


def _sessions(tmp_path):
    return (
        hst.HyperspaceSession(warehouse=str(tmp_path / "torch"), device="cpu"),
        JaxSession(warehouse=str(tmp_path / "jax")),
    )


@pytest.fixture()
def sales(tmp_path):
    """tests/test_aggregate.py:22 — seven rows with null regions and amounts."""
    os.makedirs(tmp_path / "sales")
    pq.write_table(
        pa.table({
            "region": pa.array(["east", "west", "east", None, "west", "east", None]),
            "item": pa.array([1, 2, 1, 3, 2, 2, 3], type=pa.int64()),
            "amount": pa.array([10, 20, None, 40, 50, 60, None], type=pa.int64()),
            "price": pa.array([1.5, 2.0, 2.5, None, 4.0, 5.5, 6.0]),
        }),
        str(tmp_path / "sales" / "part-00000.parquet"),
    )
    ts, js = _sessions(tmp_path)
    path = str(tmp_path / "sales")
    return ts.read.parquet(path), js.read.parquet(path)


SALES = {
    "item_then_amount_desc": (lambda df: df.order_by("item", ("amount", False)).select("item", "amount"),
                              [(1, 10), (1, None), (2, 60), (2, 50), (2, 20), (3, 40), (3, None)]),
    "amount_nulls_first": (lambda df: df.order_by("amount").select("amount"),
                           [(None,), (None,), (10,), (20,), (40,), (50,), (60,)]),
    "region_strings": (lambda df: df.order_by("region").select("region"),
                       [(None,), (None,), ("east",), ("east",), ("east",), ("west",), ("west",)]),
    "region_desc_price": (lambda df: df.order_by(("region", False), "price").select("region", "price"), None),
    "price_desc_keyword": (lambda df: df.order_by("price", ascending=False).select("price", "item"), None),
    "limit_after_desc": (lambda df: df.order_by(("amount", False)).limit(2).select("amount"), [(60,), (50,)]),
    "all_columns": (lambda df: df.sort("item", ("price", False)), None),
    "limit_then_order": (lambda df: df.limit(4).orderBy("price"), None),
}


@pytest.mark.parametrize("name", sorted(SALES))
def test_sales_order_by_equals_jax_in_order(sales, name):
    t_df, j_df = sales
    build, expect = SALES[name]
    got, want = build(t_df).collect(), build(j_df).collect()
    assert_same(got, want)
    if expect is not None:
        rows = host_rows(got)
        assert list(zip(*rows.values())) == expect


@pytest.mark.parametrize("n, expect", [(3, 3), (0, 0), (100, 7)])
def test_limit_counts(sales, n, expect):
    t_df, j_df = sales
    assert t_df.limit(n).count() == j_df.limit(n).count() == expect
    assert t_df.limit(n).collect().num_rows == expect


def _floats(seed=4, n=400, dtype=np.float64):
    rng = np.random.RandomState(seed)
    pool = np.array([np.nan, -np.nan, 0.0, -0.0, 1.5, -1.5, np.inf, -np.inf, 2.0, -2.0], dtype=dtype)
    f = pool[rng.randint(0, len(pool), n)]
    g = rng.randint(0, 3, n).astype(np.int64)
    nullable = f.astype(object)
    nullable[rng.rand(n) < 0.1] = None
    return {
        "f": f,
        "fn": nullable,
        "g": g,
        "big": rng.choice(np.array([np.iinfo(np.int64).min, -1, 0, 1, np.iinfo(np.int64).max]), n),
        "flag": rng.rand(n) < 0.5,
        "s": np.array(["b", "a", "c", None], dtype=object)[rng.randint(0, 4, n)],
        "row": np.arange(n, dtype=np.int64),
    }


FLOAT_ORDERS = {
    "f_asc": ["f"],
    "f_desc": [("f", False)],
    "f_desc_g_asc": [("f", False), "g"],
    "g_asc_f_desc": ["g", ("f", False)],
    "nullable_asc": ["fn"],
    "nullable_desc": [("fn", False)],
    "int64_extremes_desc": [("big", False), "f"],
    "bool_desc_string_asc": [("flag", False), "s"],
    "string_desc": [("s", False)],
}


@pytest.fixture(params=["float64", "float32"])
def floats(request, tmp_path):
    cols = _floats(dtype=np.dtype(request.param))
    t = Table.from_pydict(cols, "cpu")
    if request.param == "float32":
        assert t.column("f").dtype == "float32"
    hst.engine.io.write_parquet(t, str(tmp_path / "fl" / "part-00000.parquet"))
    ts, js = _sessions(tmp_path)
    return ts.read.parquet(str(tmp_path / "fl")), js.read.parquet(str(tmp_path / "fl")), cols


@pytest.mark.parametrize("name", sorted(FLOAT_ORDERS))
def test_nan_and_signed_zero_orders_equal_jax(floats, name):
    t_df, j_df, cols = floats
    keys = FLOAT_ORDERS[name]
    got, want = t_df.order_by(*keys).collect(), j_df.order_by(*keys).collect()
    assert_same(got, want)
    if name == "f_asc":
        # np.lexsort's stable order: -0.0 and +0.0 tie, every NaN ties, after +inf.
        f = cols["f"]
        np.testing.assert_array_equal(got.column("row").numpy(), np.argsort(f, kind="stable"))


def test_order_by_lanes_equal_np_lexsort(floats):
    """The device lanes (`OrderByExec.order`) against `np.lexsort` of the
    JAX package's own lanes on the same columns."""
    t_df, _, cols = floats
    table = t_df.collect()
    f = cols["f"]
    for keys, lanes in (
        ([("f", True)], [f]),
        ([("g", True), ("f", False)], [-np.unique(f, return_inverse=True)[1].reshape(-1), cols["g"]]),
    ):
        perm = OrderByExec(keys, None).order(table)
        np.testing.assert_array_equal(perm.numpy(), np.lexsort(tuple(lanes)))


def test_order_by_over_a_general_join_then_limit(tmp_path):
    rng = np.random.RandomState(2)
    left = {"k": rng.randint(0, 50, 600).astype(np.int64), "x": np.round(rng.rand(600) * 4, 1)}
    right = {"k2": rng.randint(0, 60, 80).astype(np.int64), "s": np.array(["p", "q", "r", "t"])[rng.randint(0, 4, 80)]}
    for name, cols in (("l", left), ("r", right)):
        hst.engine.io.write_parquet(Table.from_pydict(cols, "cpu"), str(tmp_path / name / "part-00000.parquet"))
    ts, js = _sessions(tmp_path)

    def q(s, c):
        return (
            s.read.parquet(str(tmp_path / "l")).join(s.read.parquet(str(tmp_path / "r")), c("k") == c("k2"))
            .order_by(("x", False), "s").limit(25).select("k", "x", "s")
        )

    got, want = q(ts, hst.col).collect(), q(js, jax_col).collect()
    assert_same(got, want)
    assert got.num_rows == 25
    assert q(ts, hst.col).count() == q(js, jax_col).count() == 25


def _multifile(tmp_path, files=6, rows=100, with_y=False):
    d = tmp_path / "t"
    d.mkdir()
    for i in range(files):
        cols = {"x": pa.array(range(i * rows, i * rows + rows), type=pa.int64())}
        if with_y:
            cols["y"] = pa.array([i] * rows, type=pa.int64())
        pq.write_table(pa.table(cols), str(d / f"part-{i:05d}.parquet"))
    return str(d)


def test_limit_over_a_multifile_scan_reads_only_its_prefix(tmp_path):
    """tests/test_engine.py:429: 150 rows of six 100-row files decode two."""
    path = _multifile(tmp_path)
    ts, js = _sessions(tmp_path)
    df = ts.read.parquet(path)
    cache = scan_cache.global_scan_cache()
    m0 = cache.misses
    got = df.limit(150).collect()
    assert got.num_rows == 150
    assert cache.misses - m0 <= 2
    assert got.column("x").numpy()[:3].tolist() == [0, 1, 2]
    assert_same(got, js.read.parquet(path).limit(150).collect())
    assert df.count() == 600
    assert df.limit(10_000).collect().num_rows == 600
    plan = df.limit(150).physical_plan()
    assert isinstance(plan, LimitExec) and plan._scan_prefix(physical.ExecContext(ts)) is not None


def test_limit_prefix_through_a_projection(tmp_path):
    """tests/test_engine.py:450: the projection's column order is kept."""
    path = _multifile(tmp_path, files=5, rows=50, with_y=True)
    ts, js = _sessions(tmp_path)
    cache = scan_cache.global_scan_cache()
    m0 = cache.misses
    got = ts.read.parquet(path).select("y", "x").limit(60).collect()
    assert got.num_rows == 60 and got.column_names == ["y", "x"]
    assert cache.misses - m0 <= 2
    assert_same(got, js.read.parquet(path).select("y", "x").limit(60).collect())


@pytest.mark.parametrize("n", [0, 1, 99, 100, 101, 599, 600, 601])
def test_the_prefix_read_equals_the_generic_path(tmp_path, n):
    """The rows the prefix read returns are the whole read's first n."""
    path = _multifile(tmp_path)
    ts, _ = _sessions(tmp_path)
    plan = ts.read.parquet(path).limit(n).physical_plan()
    ctx = physical.ExecContext(ts)
    whole = plan.child.execute(ctx)
    got = plan.execute(ctx)
    assert got.num_rows == min(n, 600)
    assert torch.equal(got.column("x").data, whole.column("x").data[: min(n, 600)])

"""The grouped aggregate and computed columns in the port against the JAX package.

The same seeded source files go through `group_by(...).agg(...)`,
`agg(...)` and `with_column(...)` in both packages. The JAX package runs its
sort path, `HYPERSPACE_FORCE_DEVICE_OPS=1` (groups in the stable key64
order, the port's order), and results must be equal in order. Against its
default CPU path (whose direct-address shortcut orders groups differently)
they must be equal as multisets. Tolerances: exact for keys, counts, min,
max, integer sums and computed columns; rtol 1e-9 for float sums and
averages (the order of additions may differ). One exception, in
`test_a_literal_divisor_is_ieee_division`: the JAX package evaluates computed
columns in a compiled XLA program, which rewrites `x / literal` as a product
by the reciprocal and fuses multiply-adds; the port divides as IEEE 754 does.
There the port equals numpy exactly and the JAX package within 2 units in the
last place of float32 (rtol 2.4e-7).
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu_torch as hst
from hyperspace_tpu import HyperspaceException as JaxHyperspaceException
from hyperspace_tpu.engine import HyperspaceSession as JaxSession
from hyperspace_tpu.engine import col as jax_col
from hyperspace_tpu.engine.table import Table as JaxTable
from hyperspace_tpu.ops import aggregate as jax_aggregate
from hyperspace_tpu_torch.engine.table import Table
from hyperspace_tpu_torch.ops import aggregate as torch_aggregate

RTOL = 1e-9
FLOAT_SUMS = ("sum", "avg")


def host_rows(t) -> dict:
    """Either package's table as host object arrays, None at nulls."""
    return {n: np.asarray(c.decode_objects(), dtype=object) for n, c in t.columns.items()}


def _same_values(a, b, approx: bool) -> bool:
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x is None or y is None:
            if x is not y:
                return False
        elif isinstance(x, (float, np.floating)) and np.isnan(x):
            if not (isinstance(y, (float, np.floating)) and np.isnan(y)):
                return False
        elif approx and isinstance(x, (float, np.floating)):
            if not np.isclose(x, y, rtol=RTOL, atol=0):
                return False
        elif x != y:
            return False
    return True


def assert_same(got, want, approx_cols=(), ordered=True):
    g, w = host_rows(got), host_rows(want)
    assert list(g) == list(w)
    if not ordered:
        def key(rows):
            return sorted(range(len(next(iter(rows.values())))), key=lambda i: tuple(
                (rows[n][i] is None, str(rows[n][i])) for n in rows if n not in approx_cols))
        gi, wi = key(g), key(w)
        g = {n: v[gi] for n, v in g.items()}
        w = {n: v[wi] for n, v in w.items()}
    for n in g:
        assert _same_values(g[n], w[n], n in approx_cols), (n, g[n][:8], w[n][:8])
    assert got.schema.to_json_string() == want.schema.to_json_string()


def _sales(seed=3, n=3000):
    rng = np.random.RandomState(seed)
    region = np.array(["east", "west", "north", "south"])[rng.randint(0, 4, n)].astype(object)
    region[rng.rand(n) < 0.1] = None
    amount = rng.randint(-50, 500, n).astype(object)
    amount[rng.rand(n) < 0.1] = None
    price = np.round(rng.rand(n) * 100, 2).astype(object)
    price[rng.rand(n) < 0.05] = None
    return {
        "region": region,
        "item": rng.randint(0, 40, n).astype(np.int64),
        "small": rng.randint(0, 9, n).astype(np.int32),
        "amount": amount,
        "price": price,
        "qty": rng.randint(1, 50, n).astype(np.float32),
        "flag": rng.rand(n) < 0.5,
    }


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    base = tmp_path_factory.mktemp("agg")
    path = str(base / "sales")
    hst.engine.io.write_parquet(Table.from_pydict(_sales(), "cpu"), os.path.join(path, "part-00000.parquet"))
    ts = hst.HyperspaceSession(warehouse=str(base / "torch"), device="cpu")
    js = JaxSession(warehouse=str(base / "jax"))
    return ts.read.parquet(path), js.read.parquet(path)


QUERIES = {
    "sum_count_rows": (("region",), dict(total=("amount", "sum"), n=("amount", "count"), rows=("*", "count"))),
    "min_max_avg": (("region",), dict(lo=("amount", "min"), hi=("amount", "max"), mean=("price", "avg"))),
    "two_keys": (("region", "item"), dict(n=("*", "count"), s=("price", "sum"))),
    "int32_key_float32_sums": (("small",), dict(q=("qty", "sum"), a=("qty", "avg"), hi=("qty", "max"))),
    "string_min_max": (("item",), dict(first=("region", "min"), last=("region", "max"))),
    "bool_key_and_minmax": (("flag",), dict(lo=("flag", "min"), hi=("flag", "max"), n=("small", "count"))),
    "count_distinct": (("region",), dict(d_item=("item", "count_distinct"), d_price=("price", "count_distinct"))),
    "float_key": (("price",), dict(n=("*", "count"))),
}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_grouped_aggregate_equals_the_jax_sort_path_in_order(both, monkeypatch, name):
    monkeypatch.setenv("HYPERSPACE_FORCE_DEVICE_OPS", "1")
    tdf, jdf = both
    keys, aggs = QUERIES[name]
    approx = [o for o, (_, fn) in aggs.items() if fn in FLOAT_SUMS]
    got = tdf.group_by(*keys).agg(**aggs).collect()
    want = jdf.group_by(*keys).agg(**aggs).collect()
    assert got.num_rows > 1
    assert_same(got, want, approx)


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_grouped_aggregate_equals_the_jax_default_path_as_a_multiset(both, name):
    tdf, jdf = both
    keys, aggs = QUERIES[name]
    approx = [o for o, (_, fn) in aggs.items() if fn in FLOAT_SUMS]
    assert_same(tdf.group_by(*keys).agg(**aggs).collect(), jdf.group_by(*keys).agg(**aggs).collect(),
                approx, ordered=False)


@pytest.mark.parametrize("where", [None, 99])
def test_global_aggregate(both, where):
    tdf, jdf = both
    if where is not None:  # an empty input: count 0, NULL sum and avg
        tdf, jdf = tdf.filter(hst.col("item") == where), jdf.filter(jax_col("item") == where)
    aggs = dict(total=("amount", "sum"), rows=("*", "count"), navg=("price", "avg"), d=("region", "count_distinct"),
                lo=("region", "min"), n=("price", "count"))
    assert_same(tdf.agg(**aggs).collect(), jdf.agg(**aggs).collect(), ["navg"])


def test_grouped_aggregate_of_an_empty_input(both):
    tdf, jdf = both
    q = dict(n=("*", "count"), s=("price", "sum"))
    got = tdf.filter(hst.col("item") == 99).group_by("region").agg(**q).collect()
    assert got.num_rows == 0
    assert_same(got, jdf.filter(jax_col("item") == 99).group_by("region").agg(**q).collect())


def test_filter_over_an_aggregate(both, monkeypatch):
    monkeypatch.setenv("HYPERSPACE_FORCE_DEVICE_OPS", "1")
    tdf, jdf = both
    got = tdf.group_by("item").agg(n=("*", "count")).filter(hst.col("n") > 75).collect()
    want = jdf.group_by("item").agg(n=("*", "count")).filter(jax_col("n") > 75).collect()
    assert 0 < got.num_rows < 40
    assert_same(got, want)


def test_grouped_dataframe_shorthands(both, monkeypatch):
    monkeypatch.setenv("HYPERSPACE_FORCE_DEVICE_OPS", "1")
    tdf, jdf = both
    for fn in ("count", "sum", "min", "max", "avg"):
        args = () if fn == "count" else ("price",)
        got = getattr(tdf.group_by("region"), fn)(*args).collect()
        want = getattr(jdf.group_by("region"), fn)(*args).collect()
        assert_same(got, want, [n for n in got.column_names if fn in ("sum", "avg") and n != "region"])


def _random_table(seed: int, n: int):
    rng = np.random.RandomState(seed)
    return {
        "k": rng.randint(0, 500, n).astype(np.int64),
        "k2": rng.randint(0, 3, n).astype(np.int32),
        "v": rng.randint(-100, 100, n).astype(np.int64),
        "f": rng.rand(n) * 1e3,
    }


AGGS = [("s", "sum", "v"), ("n", "count", "v"), ("lo", "min", "f"), ("hi", "max", "f"), ("m", "avg", "f"),
        ("fs", "sum", "f"), ("d", "count_distinct", "v"), ("rows", "count", None)]


def test_hash_aggregate_equals_the_jax_sort_path_at_20000_rows(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_FORCE_DEVICE_OPS", "1")
    data = _random_table(7, 20_000)
    got = torch_aggregate.hash_aggregate(Table.from_pydict(data, "cpu"), ["k", "k2"], AGGS)
    want = jax_aggregate.hash_aggregate(JaxTable.from_pydict(data), ["k", "k2"], AGGS)
    assert got.num_rows > 1000
    assert_same(got, want, ["m", "fs"])


def test_a_forced_key64_collision_takes_the_exact_repair(monkeypatch):
    """Every key hashes to 0: the sorted run interleaves the tuples, the
    representatives repeat, and both packages recompute exactly on the host
    (groups in first-occurrence order)."""
    monkeypatch.setenv("HYPERSPACE_FORCE_DEVICE_OPS", "1")
    data = _random_table(9, 2000)
    data["k"] = data["k"] % 13
    monkeypatch.setattr(torch_aggregate, "key64", lambda cols: torch.zeros(len(cols[0]), dtype=torch.int64))
    monkeypatch.setattr(jax_aggregate, "key64", lambda cols, arrs=None, *a: np.zeros(len(cols[0]), np.int64))
    repaired = []
    real = torch_aggregate._host_aggregate
    monkeypatch.setattr(torch_aggregate, "_host_aggregate", lambda *a: repaired.append(1) or real(*a))
    got = torch_aggregate.hash_aggregate(Table.from_pydict(data, "cpu"), ["k"], AGGS)
    want = jax_aggregate.hash_aggregate(JaxTable.from_pydict(data), ["k"], AGGS)
    assert repaired == [1] and got.num_rows == 13
    assert_same(got, want, ["m", "fs"])


def test_count_distinct_counts_nan_once_and_minus_zero_as_zero():
    data = {"g": np.array([1, 1, 1, 2], np.int64), "x": np.array([np.nan, np.nan, 1.0, -0.0])}
    aggs = [("d", "count_distinct", "x")]
    got = torch_aggregate.hash_aggregate(Table.from_pydict(data, "cpu"), ["g"], aggs)
    assert host_rows(got)["d"].tolist() == [2, 1] or sorted(host_rows(got)["d"].tolist()) == [1, 2]
    assert host_rows(torch_aggregate.hash_aggregate(Table.from_pydict(data, "cpu"), [], aggs))["d"].tolist() == [3]
    assert host_rows(torch_aggregate._host_aggregate(Table.from_pydict(data, "cpu"), ["g"], aggs))["d"].tolist() == [2, 1]


def test_sum_of_a_string_and_a_duplicate_output_name_raise(both):
    tdf, jdf = both
    with pytest.raises(hst.HyperspaceException, match="sum"):
        tdf.group_by("item").agg(x=("region", "sum"))
    with pytest.raises(JaxHyperspaceException, match="sum"):
        jdf.group_by("item").agg(x=("region", "sum"))
    with pytest.raises(hst.HyperspaceException, match="Duplicate"):
        tdf.group_by("item").agg(item=("*", "count"))


# ---------------------------------------------------------------------------
# Computed columns (the shapes of tests/test_with_column.py)
# ---------------------------------------------------------------------------

COMPUTED = {
    "revenue": lambda c: c("price") * (1 - c("qty")),
    "int_plus_int_literal": lambda c: c("small") + 3,
    "int_times_float_literal": lambda c: c("item") * 1.5,
    "int32_divided_by_int32": lambda c: c("small") / c("small"),
    "int64_divided_by_literal": lambda c: c("item") / 4,
    "literal_minus_column": lambda c: 100 - c("amount"),
    "nullable_product": lambda c: c("amount") * c("price"),
    "division_by_a_column_with_zeros": lambda c: c("price") / c("small"),
    "literal_arithmetic": lambda c: hst.lit(2) * 3 if c is hst.col else _jax_lit(2) * 3,
    "comparison": lambda c: c("price") > 50,
    "replace_in_place": lambda c: c("qty") * 2,
}


def _jax_lit(v):
    from hyperspace_tpu.engine.expr import lit

    return lit(v)


@pytest.mark.parametrize("name", sorted(COMPUTED))
def test_with_column_equals_the_jax_package(both, name):
    tdf, jdf = both
    target = "qty" if name == "replace_in_place" else "z"
    got = tdf.with_column(target, COMPUTED[name](hst.col)).collect()
    want = jdf.with_column(target, COMPUTED[name](jax_col)).collect()
    assert_same(got, want)


def test_arithmetic_in_a_filter_and_a_computed_column_feeding_an_aggregate(both, monkeypatch):
    monkeypatch.setenv("HYPERSPACE_FORCE_DEVICE_OPS", "1")
    tdf, jdf = both
    got = (tdf.filter((hst.col("item") + 1) * 2 > 30).with_column("rev", hst.col("price") * (1 - hst.col("qty")))
           .group_by("region").agg(r=("rev", "sum"), n=("*", "count")).collect())
    want = (jdf.filter((jax_col("item") + 1) * 2 > 30).with_column("rev", jax_col("price") * (1 - jax_col("qty")))
            .group_by("region").agg(r=("rev", "sum"), n=("*", "count")).collect())
    assert_same(got, want, ["r"])


def test_a_literal_divisor_is_ieee_division(both):
    tdf, jdf = both
    got = tdf.with_column("z", hst.col("price") * (1 - hst.col("qty") / 100)).collect()
    want = jdf.with_column("z", jax_col("price") * (1 - jax_col("qty") / 100)).collect()
    data = _sales()
    price = np.array([np.nan if v is None else v for v in data["price"]])
    ieee = price * (np.float32(1) - data["qty"] / np.float32(100))
    z, zj = host_rows(got)["z"], host_rows(want)["z"]
    known = np.array([v is not None for v in z])
    assert np.array_equal(known, ~np.isnan(price)) and np.array_equal(known, [v is not None for v in zj])
    assert np.array_equal(z[known].astype(np.float64), ieee[known])
    np.testing.assert_allclose(z[known].astype(np.float64), zj[known].astype(np.float64), rtol=2.4e-7, atol=0)


def test_a_computed_column_pruned_above_is_not_evaluated(both):
    tdf, _ = both
    plan = tdf.with_column("z", hst.col("item") * 2).select("item").physical_plan()
    assert "WithColumn" not in plan.tree_string()
    plan = tdf.with_column("z", hst.col("item") * 2).group_by("region").agg(s=("z", "sum")).physical_plan()
    assert [n.name for n in plan.collect_nodes()] == ["HashAggregate", "WithColumn", "Scan"]
    assert plan.collect_nodes()[-1].columns == ["region", "item"]


def test_arithmetic_on_a_string_raises(both):
    tdf, _ = both
    with pytest.raises(hst.HyperspaceException, match="Arithmetic"):
        tdf.with_column("z", hst.col("region") + 1)


def test_float_literal_against_nullable_columns_keeps_nulls(tmp_path):
    at = pa.table({"a": pa.array([1, None, 3], pa.int64()), "b": pa.array([2.0, 4.0, None])})
    pq.write_table(at, str(tmp_path / "part-00000.parquet"))
    ts = hst.HyperspaceSession(warehouse=str(tmp_path / "t"), device="cpu")
    js = JaxSession(warehouse=str(tmp_path / "j"))
    got = ts.read.parquet(str(tmp_path)).with_column("c", hst.col("a") / hst.col("b")).collect()
    want = js.read.parquet(str(tmp_path)).with_column("c", jax_col("a") / jax_col("b")).collect()
    assert host_rows(got)["c"].tolist() == [0.5, None, None]
    assert_same(got, want)

"""User functions and the set operations in the port against the JAX package.

Every case of `tests/test_udf_setops.py`, the DataFrame cases of
`tests/test_engine.py` (:249 distinct, :257 show, :468 union and drop, :506
a union's types), `tests/test_outer_joins.py:227` (a union and an intersect
over a delete-pruned indexed join), the reference's answers on NaN, ±0.0 and
null, string columns whose two sides have unequal dictionaries, and seeded
multi-column tables. Both packages read the same parquet files, each
building its own indexes; the JAX package runs its single-device sort path
(`HYPERSPACE_DISTRIBUTED=0`, `HYPERSPACE_FORCE_DEVICE_OPS=1`), whose group
order the port keeps. The port must give the JAX package's rows in its
order, its schema, its counts and its text; nothing is computed on the
values beyond what a UDF returns, so the tolerance is 0.
"""

import os

import numpy as np
import pytest

import hyperspace_tpu_torch as hst
from hyperspace_tpu import HyperspaceException as JaxHyperspaceException
from hyperspace_tpu import IndexConfig as JaxIndexConfig
from hyperspace_tpu import IndexConstants as JaxIndexConstants
from hyperspace_tpu.engine import HyperspaceSession as JaxSession
from hyperspace_tpu.engine import col as jax_col
from hyperspace_tpu.engine import lit as jax_lit
from hyperspace_tpu.engine import udf as jax_udf
from hyperspace_tpu.engine.session import DataFrame as JaxDataFrame
from hyperspace_tpu.hyperspace import Hyperspace as JaxHyperspace
from hyperspace_tpu.hyperspace import disable_hyperspace as jax_disable
from hyperspace_tpu.hyperspace import enable_hyperspace as jax_enable
from hyperspace_tpu.serde.plan_serde import deserialize_plan as jax_deserialize
from hyperspace_tpu.serde.plan_serde import serialize_plan as jax_serialize
from hyperspace_tpu_torch.engine import io as engine_io
from hyperspace_tpu_torch.engine import physical, scan_cache
from hyperspace_tpu_torch.engine.session import DataFrame
from hyperspace_tpu_torch.engine.table import Table
from hyperspace_tpu_torch.serde.plan_serde import deserialize_plan, serialize_plan
from test_torch_aggregate import assert_same


class Side:
    """One package's session over a shared lake: its `col`, `lit`, `udf`,
    facade, enable/disable and index system path."""

    def __init__(self, base: str, name: str, buckets: int, conf: dict):
        self.name, self.base = name, base
        self.idx = os.path.join(base, name, "indexes")
        if name == "torch":
            self.s = hst.HyperspaceSession(warehouse=os.path.join(base, name), device="cpu")
            k = hst.IndexConstants
            self.col, self.lit, self.udf = hst.col, hst.lit, hst.udf
            self.hs, self.cfg = hst.Hyperspace(self.s), hst.IndexConfig
            self.on, self.off = hst.enable_hyperspace, hst.disable_hyperspace
            self.error = hst.HyperspaceException
            self.serialize, self.deserialize = serialize_plan, deserialize_plan
        else:
            self.s = JaxSession(warehouse=os.path.join(base, name))
            k = JaxIndexConstants
            self.col, self.lit, self.udf = jax_col, jax_lit, jax_udf
            self.hs, self.cfg = JaxHyperspace(self.s), JaxIndexConfig
            self.on, self.off = jax_enable, jax_disable
            self.error = JaxHyperspaceException
            self.serialize, self.deserialize = jax_serialize, jax_deserialize
        self.s.conf.set(k.INDEX_SYSTEM_PATH, self.idx)
        self.s.conf.set(k.INDEX_NUM_BUCKETS, buckets)
        for key, value in conf.items():
            self.s.conf.set(getattr(k, key), value)

    def read(self, table: str):
        return self.s.read.parquet(os.path.join(self.base, table))

    def index(self, table: str, name: str, indexed, included) -> None:
        self.hs.create_index(self.read(table), self.cfg(name, indexed, included))

    def plan(self, df) -> str:
        return df.explain_string().replace(self.idx, "<indexes>")


class Twin:
    """Both packages over one lake of parquet sources under `base`."""

    def __init__(self, base, buckets: int = 8, **conf):
        self.base = str(base)
        self.t = Side(self.base, "torch", buckets, conf)
        self.j = Side(self.base, "jax", buckets, conf)

    def write(self, table: str, cols: dict, name: str = "part-00000.parquet") -> None:
        engine_io.write_parquet(Table.from_pydict(cols, "cpu"), os.path.join(self.base, table, name))

    def both(self, fn):
        return fn(self.t), fn(self.j)

    def same(self, fn):
        """`fn(side)` collected in both packages: the same rows, order and schema."""
        got, want = self.both(lambda p: fn(p).collect())
        assert_same(got, want)
        return got


@pytest.fixture(autouse=True)
def _reference_path(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    monkeypatch.setenv("HYPERSPACE_FORCE_DEVICE_OPS", "1")
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()


@pytest.fixture()
def twin(tmp_path):
    return Twin(tmp_path)


# Module scope, so that a serialized plan imports it again.
def double_plus_one(x):
    return None if x is None else 2 * x + 1


def tier_of(q):
    return "big" if q is not None and q > 5 else "small"


def _objects(values):
    return np.array(values, dtype=object)


# -- tests/test_udf_setops.py: TestUdf ------------------------------------------


def test_with_column_udf_numeric_and_nulls(twin):
    twin.write("t", {"k": np.array([1, 2, 3]), "q": _objects([1, None, 7])})
    got = twin.same(lambda p: p.read("t").with_column("d", p.udf(double_plus_one, "int64")(p.col("q")))
                    .select("k", "q", "d"))
    assert {r[0]: r[2] for r in got.rows()} == {1: 3, 2: None, 3: 15}


def test_udf_string_result_and_filter(twin):
    twin.write("t", {"q": np.array([1, 9, 3, 8])})
    got = twin.same(lambda p: p.read("t").with_column("tier", p.udf(tier_of, "string")(p.col("q")))
                    .filter(p.col("tier") == "big").select("q"))
    assert sorted(r[0] for r in got.rows()) == [8, 9]


def test_a_udf_filter_evaluates_row_wise_and_is_never_pushed_into_zone_maps(twin):
    """A UDF in a filter over a plain scan: no row group is skipped for it
    (`engine/pushdown.py` takes only column-literal conjuncts)."""
    twin.write("t", {"q": np.arange(40, dtype=np.int64)})
    big = lambda p: p.udf(tier_of, "string")(p.col("q")) == "big"  # noqa: E731
    got = twin.same(lambda p: p.read("t").filter(big(p)))
    assert got.num_rows == 34
    from hyperspace_tpu_torch.engine.pushdown import ScanPredicate

    assert ScanPredicate.from_condition(big(twin.t)) is None


def test_index_still_fires_under_udf_projection(twin):
    rng = np.random.RandomState(4)
    twin.write("l", {"k": rng.randint(0, 40, 3000).astype(np.int64), "qty": rng.randint(1, 9, 3000).astype(np.int64)})
    twin.write("r", {"k2": np.arange(40, dtype=np.int64), "w": np.arange(40, dtype=np.int64)})
    for p in (twin.t, twin.j):
        p.index("l", "ul", ["k"], ["qty"])
        p.index("r", "ur", ["k2"], ["w"])

    def q(p):
        f = p.udf(double_plus_one, "int64")
        return p.read("l").join(p.read("r"), p.col("k") == p.col("k2")).with_column("dq", f(p.col("qty"))).select("dq", "w")

    for p in (twin.t, twin.j):
        p.off(p.s)
    expected = twin.same(q).sorted_rows()
    for p in (twin.t, twin.j):
        p.on(p.s)
    tplan, jplan = twin.both(lambda p: p.plan(q(p)))
    assert "ul" in tplan and tplan == jplan
    assert twin.same(q).sorted_rows() == expected


def test_udf_serde_round_trip(twin):
    twin.write("t", {"q": np.array([1, 2])})
    tdf, jdf = twin.both(lambda p: p.read("t").with_column("d", p.udf(double_plus_one, "int64")(p.col("q"))))
    back = deserialize_plan(serialize_plan(tdf.plan))
    assert "udf:double_plus_one" in back.tree_string()
    assert DataFrame(twin.t.s, back).collect().rows() == tdf.collect().rows()
    # Each package runs the other's serialized plan.
    assert_same(DataFrame(twin.t.s, deserialize_plan(jax_serialize(jdf.plan))).collect(), jdf.collect())
    assert_same(JaxDataFrame(twin.j.s, jax_deserialize(serialize_plan(tdf.plan))).collect(), tdf.collect())


def test_udf_lambda_serde_fails_loudly(twin):
    twin.write("t", {"q": np.array([1])})
    for p in (twin.t, twin.j):
        df = p.read("t").with_column("d", p.udf(lambda x: x, "int64")(p.col("q")))
        with pytest.raises(p.error, match="cannot round-trip"):
            p.deserialize(p.serialize(df.plan))


# -- tests/test_udf_setops.py: TestSetOps ---------------------------------------


def _two(twin):
    twin.write("l", {"k": _objects([1, 2, 2, 3, None]), "v": np.array(["a", "b", "b", "c", "d"])})
    twin.write("r", {"k": _objects([2, 3, 4, None]), "v": np.array(["b", "zzz", "e", "d"])})


def _by_str(rows):
    return sorted(rows, key=lambda t: tuple(str(x) for x in t))


def test_intersect_distinct_null_aware(twin):
    _two(twin)
    got = twin.same(lambda p: p.read("l").intersect(p.read("r")))
    assert got.sorted_rows() == _by_str([(2, "b"), (None, "d")])


def test_except_distinct(twin):
    _two(twin)
    got = twin.same(lambda p: p.read("l").subtract(p.read("r")))
    assert got.sorted_rows() == _by_str([(1, "a"), (3, "c")])
    assert twin.both(lambda p: p.read("l").subtract(p.read("l")).count()) == (0, 0)


def test_setop_schema_mismatch_raises(twin):
    _two(twin)
    twin.write("other", {"x": np.array([1])})
    for p in (twin.t, twin.j):
        with pytest.raises(ValueError, match="differ"):
            p.read("l").intersect(p.read("other"))


def test_setop_serde_round_trip(twin):
    _two(twin)
    for op in ("intersect", "subtract"):
        tdf, jdf = twin.both(lambda p: getattr(p.read("l"), op)(p.read("r")))
        assert DataFrame(twin.t.s, deserialize_plan(serialize_plan(tdf.plan))).sorted_rows() == tdf.sorted_rows()
        assert_same(DataFrame(twin.t.s, deserialize_plan(jax_serialize(jdf.plan))).collect(), jdf.collect())


def test_setop_composes_with_index_rewrites(twin):
    twin.write("a", {"name": np.array([f"n{i:02d}" for i in range(50)]), "v": np.arange(50)})
    twin.write("b", {"name": np.array([f"n{i:02d}" for i in range(0, 50, 2)]), "v": np.arange(0, 50, 2)})
    for p in (twin.t, twin.j):
        p.index("a", "sa", ["name"], ["v"])

    def q(p):
        a = p.read("a").filter(p.col("name") < "n10")
        return a.select("name", "v").intersect(p.read("b").select("name", "v"))

    for p in (twin.t, twin.j):
        p.off(p.s)
    expected = twin.same(q).sorted_rows()
    for p in (twin.t, twin.j):
        p.on(p.s)
    tplan, jplan = twin.both(lambda p: p.plan(q(p)))
    assert "sa" in tplan and tplan == jplan
    assert twin.same(q).sorted_rows() == expected and len(expected) == 5


def test_string_udf_over_zero_rows(twin):
    twin.write("t", {"q": np.array([1, 2, 3])})
    got = twin.same(lambda p: p.read("t").filter(p.col("q") > 100).with_column("tier", p.udf(tier_of, "string")(p.col("q"))))
    assert got.rows() == [] and got.column_names == ["q", "tier"]


def test_udf_scalar_literal_argument(twin):
    twin.write("t", {"q": np.array([1, 2, 3])})
    got = twin.same(lambda p: p.read("t").with_column("z", p.udf(lambda a, b: a + b, "int64")(p.col("q"), p.lit(2) + p.lit(3)))
                    .select("q", "z"))
    assert [r[1] for r in got.rows()] == [6, 7, 8]


def test_scalar_subquery_pattern(twin):
    twin.write("t", {"x": np.array([1, 5, 9, 3])})
    for p in (twin.t, twin.j):
        df = p.read("t")
        assert df.group_by().agg(m=("x", "max")).scalar() == 9
        above = df.filter(p.col("x") > df.group_by().agg(a=("x", "avg")).scalar())
        assert sorted(r[0] for r in above.collect().rows()) == [5, 9]
        with pytest.raises(p.error, match="1x1"):
            df.scalar()


def test_udf_of_ufunc_and_distinct_lambdas(twin):
    twin.write("t", {"q": np.array([1.0, 4.0, 9.0])})
    got = twin.same(lambda p: p.read("t").with_column("r", p.udf(np.sqrt, "float64")(p.col("q"))).select("q", "r"))
    assert [r[1] for r in got.rows()] == [1.0, 2.0, 3.0]
    f1, f2 = hst.udf(lambda x: x + 1, "int64"), hst.udf(lambda x: x + 2, "int64")
    assert repr(f1(hst.col("q"))) != repr(f2(hst.col("q")))


# -- tests/test_engine.py -------------------------------------------------------


def test_distinct(twin):
    twin.write("d", {"a": np.array([1, 1, 2, 2, 2]), "b": np.array(["x", "x", "y", "y", "z"])})
    got = twin.same(lambda p: p.read("d").distinct())
    assert got.sorted_rows() == [(1, "x"), (2, "y"), (2, "z")]
    assert twin.both(lambda p: p.read("d").select("a").distinct().count()) == (2, 2)


@pytest.mark.parametrize("n", [1, 3, 5, 20])
def test_show_formats_and_truncates_as_jax(twin, n):
    twin.write("t", {"k": np.arange(5), "s": _objects(["aa", None, "ccc", "aa", "b"]), "f": np.array([0.5, -0.0, 1e20, 2.0, 3.25])})
    texts = []
    for p in (twin.t, twin.j):
        out = []
        p.read("t").show(n, redirect=out.append)
        texts.append(out[0])
    assert texts[0] == texts[1]
    assert ("only showing top 3 rows" in texts[0]) == (n == 3)
    assert texts[0].count("\n") >= min(n, 5) + 3


def test_dataframe_union_and_drop(twin):
    for name, lo in (("a", 0), ("b", 100)):
        twin.write(name, {"k": np.arange(lo, lo + 10, dtype=np.int64), "v": np.array([name] * 10)})
    got = twin.same(lambda p: p.read("a").union(p.read("b")))
    assert got.num_rows == 20
    assert twin.both(lambda p: p.read("a").unionAll(p.read("a")).distinct().count()) == (10, 10)
    for p in (twin.t, twin.j):
        da = p.read("a")
        assert da.drop("v").schema.names == ["k"]
        assert da.drop("nosuch").schema.names == ["k", "v"]
        assert da.drop("V").schema.names == ["k"]  # case-insensitive by default
        with pytest.raises(p.error):
            da.drop("k", "v")
        with pytest.raises(ValueError):
            da.union(p.read("b").select("k"))


def test_drop_honours_case_sensitive_resolution(tmp_path):
    twin = Twin(tmp_path, RESOLUTION_CASE_SENSITIVE="true")
    twin.write("a", {"k": np.arange(3), "v": np.arange(3)})
    assert twin.both(lambda p: p.read("a").drop("V").schema.names) == (["k", "v"], ["k", "v"])


def test_union_dtype_mismatch_raises(twin):
    twin.write("n", {"k": np.arange(3, dtype=np.int64)})
    twin.write("s", {"k": np.array(["a", "b"])})
    twin.write("n32", {"k": np.arange(3, dtype=np.int32)})
    for p in (twin.t, twin.j):
        with pytest.raises(ValueError, match="type mismatch"):
            p.read("n").union(p.read("s"))
        with pytest.raises(ValueError, match="type mismatch"):
            p.read("s").intersect(p.read("n"))
    got = twin.same(lambda p: p.read("n32").union(p.read("n")))
    assert got.num_rows == 6 and got.schema.field("k").dtype == "int64"
    twin.same(lambda p: p.read("n32").intersect(p.read("n")))


# -- tests/test_outer_joins.py:227 ----------------------------------------------


def test_union_over_delete_pruned_indexed_join(tmp_path):
    twin = Twin(tmp_path, buckets=4, INDEX_LINEAGE_ENABLED="true", INDEX_HYBRID_SCAN_ENABLED="true")
    twin.write("L", {"k": np.arange(6, dtype=np.int64), "v": np.arange(6, dtype=np.int64)}, "p0.parquet")
    twin.write("L", {"k": np.arange(6, 12, dtype=np.int64), "v": np.arange(6, 12, dtype=np.int64)}, "p1.parquet")
    twin.write("R", {"rk": np.arange(12, dtype=np.int64), "w": np.arange(12, dtype=np.int64)})
    for p in (twin.t, twin.j):
        p.index("L", "upl", ["k"], ["v"])
        p.index("R", "upr", ["rk"], ["w"])
    os.remove(os.path.join(twin.base, "L", "p1.parquet"))  # the delete prune
    one = np.array([100], dtype=np.int64)
    twin.write("other", {"k": one, "v": one, "rk": one, "w": one})
    for p in (twin.t, twin.j):
        p.on(p.s)
    for how in ("inner", "left"):
        def j(p):
            return p.read("L").join(p.read("R"), p.col("k") == p.col("rk"), how)

        tplan, jplan = twin.both(lambda p: p.plan(j(p)))
        assert "upl" in tplan and tplan == jplan
        got = twin.same(lambda p: j(p).union(p.read("other")))
        assert got.column_names == ["k", "v", "rk", "w"]
        for p in (twin.t, twin.j):
            p.off(p.s)
        expected = twin.same(lambda p: j(p).union(p.read("other"))).sorted_rows()
        for p in (twin.t, twin.j):
            p.on(p.s)
        assert got.sorted_rows() == expected
        counts = twin.both(lambda p: (j(p).intersect(j(p)).count(), j(p).distinct().count()))
        assert counts[0] == counts[1] and counts[0][0] == counts[0][1]


# -- the reference's set-operation semantics --------------------------------------


NAN_A = [1.0, float("nan"), -0.0, 0.0, float("nan"), 2.0, None]
NAN_B = [float("nan"), 0.0, 2.0, None]


@pytest.mark.parametrize("op,want", [
    ("intersect", [-0.0, 2.0, None]),
    ("subtract", [1.0, "nan", "nan"]),
    ("distinct", [-0.0, None, "nan", "nan", 2.0, 1.0]),
    ("union", NAN_A + NAN_B),
])
def test_nan_signed_zero_and_null_equal_the_jax_answers(twin, op, want):
    """NaN never equals NaN, -0.0 equals 0.0, null equals null; the left
    side's first occurrence, in left order (a difference from Spark, whose
    NaN equals NaN, kept for parity)."""
    twin.write("a", {"x": _objects(NAN_A)})
    twin.write("b", {"x": _objects(NAN_B)})

    def q(p):
        a, b = p.read("a"), p.read("b")
        return a.distinct() if op == "distinct" else getattr(a, op)(b)

    got = twin.same(q)
    values = got.to_pydict()["x"]

    def norm(vs):
        return [("nan" if isinstance(v, float) and np.isnan(v) else v) for v in vs]

    assert norm(values) == norm(want)
    zeros = [np.signbit(v) for v in values if v == 0.0]
    assert zeros == [np.signbit(v) for v in want if isinstance(v, float) and v == 0.0]


@pytest.mark.parametrize("op", ["intersect", "subtract"])
def test_strings_over_unequal_dictionaries(twin, op):
    """The two sides' dictionaries differ: rows compare by value, the output
    keeps the left side's dictionary."""
    twin.write("l", {"s": _objects(["pear", "apple", None, "kiwi", "pear", "fig"]), "n": np.array([1, 2, 3, 4, 1, 6])})
    twin.write("r", {"s": _objects(["kiwi", "zebra", "apple", None, "apple"]), "n": np.array([4, 0, 2, 3, 9])})
    got = twin.same(lambda p: getattr(p.read("l"), op)(p.read("r")))
    want = [("apple", 2), (None, 3), ("kiwi", 4)] if op == "intersect" else [("pear", 1), ("fig", 6)]
    assert got.rows() == want
    left = twin.t.read("l").collect().column("s").dictionary
    assert list(got.column("s").dictionary) == list(left)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("op", ["intersect", "subtract", "distinct"])
def test_seeded_multi_column_tables_equal_jax(twin, seed, op):
    """Int, float (NaN, ±0.0), string and bool columns with nulls, drawn from
    few values so that rows repeat within and across the sides."""
    rng = np.random.RandomState(seed)

    def table(n):
        i = rng.randint(0, 3, n).astype(object)
        i[rng.rand(n) < 0.1] = None
        f = rng.choice([0.0, -0.0, 1.5, np.nan], n).astype(object)
        f[rng.rand(n) < 0.1] = None
        s = rng.choice(["a", "b", "c"], n).astype(object)
        s[rng.rand(n) < 0.1] = None
        return {"i": i, "f": f, "s": s, "b": rng.rand(n) < 0.5}

    twin.write("l", table(400))
    twin.write("r", table(300))

    def q(p):
        left = p.read("l")
        return left.distinct() if op == "distinct" else getattr(left, op)(p.read("r"))

    got = twin.same(q)
    assert 0 < got.num_rows < 400

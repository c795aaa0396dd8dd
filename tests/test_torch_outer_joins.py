"""Outer, semi and anti joins in the port against the JAX package.

The shapes of `tests/test_outer_joins.py` (left, right and full outer, semi
and anti joins, the join-type spellings, `count()` against the collected
rows with null keys, indexed non-inner joins equal to the disabled run, the
bare collect that must not show the lineage column), plus empty sides,
string and nullable keys, the null-filled side's string dictionaries, a
two-version index after an incremental refresh and an aggregate over an
outer join. The same seeded source files go through both packages; the JAX
package runs its single-device path (`HYPERSPACE_DISTRIBUTED=0`). The port
must give the JAX package's rows in its order, with its schema and its
`count()`. Nothing is computed on the rows, so the tolerance is 0.
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
from hyperspace_tpu.engine.logical import _JOIN_TYPES as JAX_JOIN_TYPES
from hyperspace_tpu.engine.logical import normalize_join_type as jax_normalize
from hyperspace_tpu.hyperspace import Hyperspace as JaxHyperspace
from hyperspace_tpu.hyperspace import disable_hyperspace as jax_disable
from hyperspace_tpu.hyperspace import enable_hyperspace as jax_enable
from hyperspace_tpu_torch.engine import physical, scan_cache
from hyperspace_tpu_torch.engine.logical import JoinNode, normalize_join_type
from hyperspace_tpu_torch.engine.physical import ExecContext, SortMergeJoinExec, _classed_plan
from hyperspace_tpu_torch.engine.table import Table
from test_torch_aggregate import assert_same, host_rows

HOWS = ["inner", "left", "right", "full", "left_semi", "left_anti"]
NON_INNER = HOWS[1:]


@pytest.fixture(autouse=True)
def _single_device(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()


def _write(path, cols, name="part-00000.parquet"):
    hst.engine.io.write_parquet(Table.from_pydict(cols, "cpu"), os.path.join(path, name))


def _objects(values, null_every=0, offset=0):
    out = np.asarray(values).astype(object)
    if null_every:
        out[offset::null_every] = None
    return out


def _lakes():
    """name → (left columns, right columns): the first column of each side
    is its join key, the second its payload."""
    rng = np.random.RandomState(4)
    rng7 = np.random.RandomState(7)
    rng8 = np.random.RandomState(8)
    words = np.array(["ant", "bee", "cat", "dog", "eel", "fox", "gnu", "hen"])
    k7 = rng7.randint(0, 100, 3000).astype(object)
    k7[::5] = None
    r7 = np.arange(100).astype(object)
    r7[::9] = None
    return {
        # tests/test_outer_joins.py:22 — null keys on both sides.
        "small": (
            {"k": np.array([1, 2, 3, None], dtype=object), "lv": np.array(["a", "b", "c", "d"])},
            {"k2": np.array([2, 3, 3, 5, None], dtype=object), "rv": np.array([20, 30, 31, 50, 99], np.int64)},
        ),
        # tests/test_outer_joins.py:119 — right keys some left key never meets.
        "wide": (
            {"k": rng.randint(0, 50, 4000).astype(np.int64), "v": rng.randint(0, 1000, 4000).astype(np.int64)},
            {"rk": np.arange(20, 70, dtype=np.int64), "w": np.arange(50, dtype=np.int64)},
        ),
        # tests/test_skewed_join.py:171 — nullable int keys on both sides.
        "null_ints": (
            {"k": k7, "v": rng7.randint(0, 100, 3000).astype(np.int64)},
            {"k2": r7, "w": _objects(words[rng7.randint(0, 8, 100)], 13)},
        ),
        # Nullable string keys over dictionaries that differ on each side.
        "null_strings": (
            {"s": _objects(words[rng8.randint(0, 6, 2500)], 7), "v": _objects(words[rng8.randint(0, 4, 2500)])},
            {"s2": _objects(words[rng8.randint(2, 8, 300)], 11, 3), "w": rng8.rand(300)},
        ),
    }


LAKES = _lakes()


class Lake:
    """One case's two sources and a covering index on each key, built by
    both packages in warehouses of their own."""

    def __init__(self, base, name, lineage=False, num_buckets=4, right_included=None):
        self.base = str(base)
        left, right = LAKES[name]
        _write(os.path.join(self.base, "l"), left)
        _write(os.path.join(self.base, "r"), right)
        (self.lk, self.lp), (self.rk, self.rp) = list(left), list(right)
        self.t = hst.HyperspaceSession(warehouse=os.path.join(self.base, "torch"), device="cpu")
        self.j = JaxSession(warehouse=os.path.join(self.base, "jax"))
        for s, k in ((self.t, hst.IndexConstants), (self.j, JaxIndexConstants)):
            s.conf.set(k.INDEX_NUM_BUCKETS, num_buckets)
            if lineage:
                s.conf.set(k.INDEX_LINEAGE_ENABLED, "true")
        for s, h, cfg in ((self.t, hst.Hyperspace(self.t), hst.IndexConfig),
                          (self.j, JaxHyperspace(self.j), JaxIndexConfig)):
            h.create_index(s.read.parquet(os.path.join(self.base, "l")), cfg("oL", [self.lk], [self.lp]))
            h.create_index(s.read.parquet(os.path.join(self.base, "r")),
                           cfg("oR", [self.rk], [self.rp] if right_included is None else right_included))

    def indexed(self, on: bool) -> None:
        (hst.enable_hyperspace if on else hst.disable_hyperspace)(self.t)
        (jax_enable if on else jax_disable)(self.j)

    def join(self, how, left_filter=None, right_filter=None):
        """(port DataFrame, JAX DataFrame) of left ⋈ right on the keys; a
        filter is `f(col)` → the condition over its side."""

        def q(s, c):
            lt = s.read.parquet(os.path.join(self.base, "l"))
            rt = s.read.parquet(os.path.join(self.base, "r"))
            if left_filter is not None:
                lt = lt.filter(left_filter(c))
            if right_filter is not None:
                rt = rt.filter(right_filter(c))
            return lt.join(rt, c(self.lk) == c(self.rk), how)

        return q(self.t, hst.col), q(self.j, jax_col)


@pytest.fixture(scope="module")
def lakes(tmp_path_factory):
    return {name: Lake(tmp_path_factory.mktemp(name), name) for name in LAKES}


def _join_node(df) -> SortMergeJoinExec:
    return next(n for n in df.physical_plan().collect_nodes() if isinstance(n, SortMergeJoinExec))


def _check(tq, jq):
    """Rows in the JAX package's order with its schema, and its count()."""
    got, want = tq.collect(), jq.collect()
    assert_same(got, want)
    assert tq.count() == jq.count() == got.num_rows
    return got


@pytest.mark.parametrize("indexed", [True, False], ids=["indexed", "plain"])
@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("lake", ["small", "wide"])
def test_every_join_type_equals_jax_rows_in_order(lakes, lake, how, indexed):
    case = lakes[lake]
    case.indexed(indexed)
    tq, jq = case.join(how)
    join = _join_node(tq)
    assert join.bucketed == indexed and join.how == how
    got = _check(tq, jq)
    assert got.num_rows > 0
    if how in ("left_semi", "left_anti"):
        assert got.column_names == [case.lk, case.lp]


def test_the_small_lake_gives_the_reference_rows(lakes):
    """tests/test_outer_joins.py:58-90, as multisets of (lv, rv)."""
    case = lakes["small"]
    case.indexed(False)

    def key(row):
        return tuple(str(x) for x in row)

    def rows(how, cols):
        t = host_rows(case.join(how)[0].select(*cols).collect())
        return sorted(zip(*(t[c].tolist() for c in cols)), key=key)

    assert rows("left", ["lv", "rv"]) == sorted([("a", None), ("b", 20), ("c", 30), ("c", 31), ("d", None)], key=key)
    assert rows("right", ["lv", "rv"]) == sorted([("b", 20), ("c", 30), ("c", 31), (None, 50), (None, 99)], key=key)
    assert len(rows("full", ["lv", "rv"])) == 7
    assert rows("semi", ["lv"]) == [("b",), ("c",)]
    assert rows("anti", ["lv"]) == [("a",), ("d",)]


SPELLINGS = sorted(JAX_JOIN_TYPES) + ["LEFT_OUTER", " Left Outer ", "FULL OUTER", "Left Semi", "CROSS"]


@pytest.mark.parametrize("spelling", SPELLINGS)
def test_every_spelling_normalizes_as_in_jax(spelling):
    assert normalize_join_type(spelling) == jax_normalize(spelling)
    assert JoinNode(None, None, None, spelling).how == jax_normalize(spelling)


@pytest.mark.parametrize("spelling", ["lefty", "inner join", "semi_left", ""])
def test_an_unknown_spelling_raises_in_both(spelling):
    with pytest.raises(hst.HyperspaceException, match="Unsupported join type"):
        normalize_join_type(spelling)
    with pytest.raises(JaxHyperspaceException, match="Unsupported join type"):
        jax_normalize(spelling)


def test_spellings_of_one_type_give_the_same_rows(lakes):
    case = lakes["small"]
    case.indexed(False)
    first = case.join("leftouter")[0].collect()
    for spelling in ("LEFT_OUTER", "left", "Left Outer"):
        assert_same(case.join(spelling)[0].collect(), first)


@pytest.mark.parametrize("how", NON_INNER)
def test_indexed_equals_disabled_with_the_plan_markers(lakes, how):
    """The join rule rewrites every equi-join type (`JoinIndexRule.scala:60`
    matches any type): the bucketed, exchange-free plan, the same rows as
    without the indexes, and the JAX package's count()."""
    case = lakes["wide"]
    case.indexed(False)
    tq, jq = case.join(how)
    plain, plain_count = tq.collect(), tq.count()
    assert "ShuffleExchange" in tq.explain_string()
    case.indexed(True)
    tq, jq = case.join(how)
    plan = tq.explain_string()
    assert "oL" in plan and "oR" in plan and "bucketed, no exchange" in plan and "ShuffleExchange" not in plan
    assert f"SortMergeJoin {how} [k=rk] (bucketed, no exchange)" in plan
    assert tq.count() == plain_count == jq.count()
    assert_same(tq.collect(), plain, ordered=False)


@pytest.mark.parametrize("how", HOWS)
def test_a_right_index_of_the_key_alone_serves_semi_and_anti_joins(tmp_path, how):
    """A semi or anti join outputs the left side alone, so the rule asks the
    right index to cover only the keys (JAX `join_index_rule.py:449`); every
    other type outputs the right payload, which that index lacks."""
    case = Lake(tmp_path, "wide", right_included=[])
    case.indexed(True)
    tq, jq = case.join(how)
    join = _join_node(tq)
    assert join.bucketed == (how in ("left_semi", "left_anti"))
    assert (join.how, jq.physical_plan().tree_string().count("bucketed, no exchange")) == (how, int(join.bucketed))
    _check(tq, jq)


def test_an_inner_join_shows_no_type(lakes):
    case = lakes["wide"]
    case.indexed(True)
    assert "SortMergeJoin [k=rk] (bucketed, no exchange)" in case.join("inner")[0].explain_string()


@pytest.mark.parametrize("how", HOWS)
def test_a_bare_collect_never_shows_the_lineage_column(tmp_path, how):
    """tests/test_outer_joins.py:187 for every type: with lineage on, an
    unprojected collect over the indexed join shows the source schema."""
    case = Lake(tmp_path, "wide", lineage=True)
    case.indexed(True)
    tq, jq = case.join(how)
    assert "oL" in tq.explain_string()
    got = _check(tq, jq)
    want = ["k", "v"] if how in ("left_semi", "left_anti") else ["k", "v", "rk", "w"]
    assert got.column_names == want


@pytest.mark.parametrize("indexed", [True, False], ids=["indexed", "plain"])
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("how", HOWS)
def test_an_empty_side_equals_jax(lakes, how, side, indexed):
    """The other side's rows are still the answer of an outer or anti join;
    count() takes the same arithmetic at all-zero match stats."""
    case = lakes["wide"]
    case.indexed(indexed)
    empty = {"left_filter": lambda c: c("v") > 10**6} if side == "left" else {"right_filter": lambda c: c("w") < 0}
    tq, jq = case.join(how, **empty)
    assert _join_node(tq).bucketed == indexed
    got = _check(tq, jq)
    keeps_left = side == "right" and how in ("left", "full", "left_anti")
    keeps_right = side == "left" and how in ("right", "full")
    n = {"left": 4000, "right": 50}
    assert got.num_rows == (n["left"] if keeps_left else n["right"] if keeps_right else 0)


@pytest.mark.parametrize("indexed", [True, False], ids=["indexed", "plain"])
@pytest.mark.parametrize("how", NON_INNER)
@pytest.mark.parametrize("lake", ["null_ints", "null_strings"])
def test_nullable_and_string_keys_equal_jax(lakes, lake, how, indexed):
    """A null key matches nothing, so its row is unmatched: kept by left,
    right, full and anti joins, dropped by semi."""
    case = lakes[lake]
    case.indexed(indexed)
    tq, jq = case.join(how)
    got = _check(tq, jq)
    left, right = LAKES[lake]
    null_left = int(sum(v is None for v in left[case.lk]))
    if how in ("left", "full", "left_anti"):
        assert int((~got.column(case.lk).validity).sum()) >= null_left > 0
    if how == "left_semi":
        assert got.column(case.lk).validity is None


@pytest.mark.parametrize("how", ["left", "right", "full"])
def test_the_null_filled_side_keeps_the_jax_dictionary(lakes, how):
    """A string column of the side that takes all-null rows keeps its
    dictionary, so the concatenation's union dictionary is the JAX
    package's."""
    case = lakes["null_ints"]
    case.indexed(False)
    tq, jq = case.join(how, left_filter=lambda c: c("v") < 50)
    got, want = tq.collect(), jq.collect()
    assert_same(got, want)
    np.testing.assert_array_equal(got.column("w").dictionary, want.column("w").dictionary)
    assert got.column("w").dictionary.dtype == want.column("w").dictionary.dtype


@pytest.mark.parametrize("how", ["left", "full"])
def test_an_empty_dictionary_fills_with_the_empty_string(tmp_path, how):
    """A 0-row side's string column has no dictionary: its null rows take
    [""], as the JAX package's do."""
    case = Lake(tmp_path, "small")
    _write(os.path.join(case.base, "r0"), {"k2": np.empty(0, np.int64), "rs": np.empty(0, dtype="<U1")})
    got_want = []
    for s, c in ((case.t, hst.col), (case.j, jax_col)):
        q = s.read.parquet(os.path.join(case.base, "l")).join(s.read.parquet(os.path.join(case.base, "r0")),
                                                               c("k") == c("k2"), how)
        got_want.append(q.collect())
    got, want = got_want
    assert_same(got, want)
    np.testing.assert_array_equal(got.column("rs").dictionary, want.column("rs").dictionary)
    assert list(got.column("rs").dictionary) == [""]


@pytest.mark.parametrize("how", ["left", "full", "left_anti"])
def test_an_outer_join_over_a_two_version_index(tmp_path, monkeypatch, how):
    """An appended source file and an incremental refresh leave a second
    version directory whose keys fall inside each bucket's range: the
    bucketed join runs in hash mode and its outer rows are the JAX
    package's."""
    monkeypatch.setenv("HYPERSPACE_BUILD_DECODE_THREADS", "1")
    case = Lake(tmp_path, "wide", lineage=True)
    rng = np.random.RandomState(11)
    _write(os.path.join(case.base, "l"), {"k": rng.randint(0, 80, 500).astype(np.int64),
                                          "v": rng.randint(0, 1000, 500).astype(np.int64)}, "part-00001.parquet")
    for s, h in ((case.t, hst.Hyperspace(case.t)), (case.j, JaxHyperspace(case.j))):
        h.refresh_index("oL", "incremental")
    case.indexed(True)
    tq, jq = case.join(how)
    join = _join_node(tq)
    assert join.bucketed and len({os.path.dirname(f.path) for f in join.left.relation.files}) == 2
    ctx = ExecContext(case.t)
    left, l_starts = join.left.execute_concat(ctx)
    right, r_starts = join.right.execute_concat(ctx)
    assert _classed_plan(left, right, join.left_keys, join.right_keys, l_starts, r_starts).mode == "hash"
    got = _check(tq, jq)
    case.indexed(False)
    assert_same(case.join(how)[0].collect(), got, ordered=False)


@pytest.mark.parametrize("indexed", [True, False], ids=["indexed", "plain"])
@pytest.mark.parametrize("how", ["left", "right", "full"])
def test_an_aggregate_over_an_outer_join_skips_the_filled_nulls(lakes, monkeypatch, how, indexed):
    """count(col) counts the matched rows of each group and count(*) every
    row, filled or not; the JAX package runs its sort path, the port's group
    order."""
    monkeypatch.setenv("HYPERSPACE_FORCE_DEVICE_OPS", "1")
    case = lakes["wide"]
    case.indexed(indexed)
    tq, jq = (q.group_by("k").agg(n=("w", "count"), rows=("*", "count"), top=("w", "max"))
              for q in case.join(how))
    got = _check(tq, jq)
    left, right = LAKES["wide"]
    matches = np.isin(left["k"], right["rk"])
    rows = host_rows(got)
    by_key = dict(zip(rows["k"].tolist(), rows["n"].tolist()))
    for key in (0, 19, 20, 49):
        assert by_key.get(key, 0) == int((left["k"] == key).sum()) * int(key in right["rk"])
    # Unmatched right rows form the null-key group, their w counted.
    unmatched_right = int((~np.isin(right["rk"], left["k"])).sum()) if how != "left" else 0
    assert int(got.column("n").data.sum()) == int(matches.sum()) + unmatched_right
    assert int(got.column("rows").data.sum()) == case.join(how)[0].count()
    keys = np.unique(left["k"]) if how != "right" else np.intersect1d(left["k"], right["rk"])
    assert got.num_rows == len(keys) + (how != "left")


def test_a_column_taken_apart_concatenates_without_a_union():
    """The outer assembly's concatenation: parts that share one dictionary
    object keep it and their codes, equal to the union path's result over
    copies of the dictionary."""
    import torch

    from hyperspace_tpu_torch.engine.physical import _null_table_like
    from hyperspace_tpu_torch.engine.table import Column

    t = Table({"s": Column.from_values(np.array(["eel", "ant", "cat", None, "ant"], dtype=object), "cpu"),
               "n": Column.from_values(np.arange(5, dtype=np.int64), "cpu")})
    parts = [t.take(torch.tensor([0, 2])), _null_table_like(t, 2, "cpu"), t.take(torch.tensor([1, 3, 4]))]
    same = Table.concat(parts)
    assert same.column("s").dictionary is t.column("s").dictionary
    copies = [Table({n: Column(c.dtype, c.data, None if c.dictionary is None else c.dictionary.copy(), c.validity)
                     for n, c in p.columns.items()}) for p in parts]
    union = Table.concat(copies)
    assert_same(same, union)
    assert torch.equal(same.column("s").data, union.column("s").data)
    np.testing.assert_array_equal(same.column("s").dictionary, union.column("s").dictionary)
    assert host_rows(same)["s"].tolist() == ["eel", "cat", None, None, "ant", None, "ant"]

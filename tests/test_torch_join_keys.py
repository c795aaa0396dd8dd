"""String and nullable join keys in the port against the JAX package.

The string and null shapes of `tests/test_skewed_join.py` (a hot string key,
nullable int keys) and `tests/test_nulls.py` (null never equals null), plus
nullable string keys and string keys over two different dictionaries. Each
runs indexed (both sides on covering indexes: the co-bucketed join in hash
mode, K1 then K2) and not indexed (the general join), in the port and in the
JAX package on the same source files, single-device
(`HYPERSPACE_DISTRIBUTED=0`). The port must return the JAX package's rows in
its order with its schema; no output row has a null key; indexed and
non-indexed rows are the same multiset. Tolerance 0.
"""

import os

import numpy as np
import pytest
import torch

import hyperspace_tpu_torch as hst
from hyperspace_tpu import HyperspaceException as JaxHyperspaceException
from hyperspace_tpu import IndexConfig as JaxIndexConfig
from hyperspace_tpu import IndexConstants as JaxIndexConstants
from hyperspace_tpu.engine import HyperspaceSession as JaxSession
from hyperspace_tpu.engine import col as jax_col
from hyperspace_tpu.engine import physical as jax_physical
from hyperspace_tpu.engine.table import Table as JaxTable
from hyperspace_tpu.hyperspace import Hyperspace as JaxHyperspace
from hyperspace_tpu.hyperspace import enable_hyperspace as jax_enable
from hyperspace_tpu_torch.engine import physical, scan_cache
from hyperspace_tpu_torch.engine.physical import (
    BucketedIndexScanExec,
    ExecContext,
    SortMergeJoinExec,
    _classed_plan,
    _value_mode_column,
    _verify_pairs,
)
from hyperspace_tpu_torch.engine.table import Table
from test_torch_aggregate import assert_same, host_rows

NUM_BUCKETS = 8


def _objects(values, null_every=0, offset=0):
    out = np.asarray(values).astype(object)
    if null_every:
        out[offset::null_every] = None
    return out


def _cases():
    rng = np.random.RandomState(6)
    n = 4000
    hot = np.array([f"sku-{i:04d}" for i in rng.randint(0, 200, n)], dtype=object)
    hot[: n // 2] = "sku-HOT"
    rng7 = np.random.RandomState(7)
    k = rng7.randint(0, 100, 3000).astype(object)
    k[::5] = None
    k2 = np.arange(100).astype(object)
    k2[::9] = None
    rng8 = np.random.RandomState(8)
    words = np.array(["ant", "bee", "cat", "dog", "eel", "fox", "gnu", "hen"])
    return {
        # tests/test_skewed_join.py:157 — a hot string key.
        "string_hot": (
            {"k": hot, "v": rng.randint(0, 100, n).astype(np.int64)},
            {"k2": np.array([f"sku-{i:04d}" for i in range(200)] + ["sku-HOT"], dtype=object),
             "w": rng.randint(0, 10, 201).astype(np.int64)},
        ),
        # tests/test_skewed_join.py:171 — nullable int keys on both sides.
        "null_ints": (
            {"k": k, "v": rng7.randint(0, 100, 3000).astype(np.int64)},
            {"k2": k2, "w": rng7.randint(0, 10, 100).astype(np.int64)},
        ),
        # tests/test_nulls.py:26 — users ⋈ orders, nulls on both key sides.
        "users_orders": (
            {"uid": np.array([1, 2, None, 4, 5, None, 7, 8], dtype=object),
             "city": np.array(["a", None, "b", "a", None, "c", "b", "a"], dtype=object)},
            {"ouid": np.array([1, None, 4, 4, 8, 9], dtype=object),
             "amount": np.array([10, 20, 30, 40, 50, 60], dtype=np.int64)},
        ),
        # Nullable strings over dictionaries that differ on each side.
        "null_strings": (
            {"s": _objects(words[rng8.randint(0, 6, 2500)], 7), "v": rng8.rand(2500)},
            {"s2": _objects(words[rng8.randint(2, 8, 300)], 11, 3), "w": rng8.rand(300)},
        ),
    }


CASES = _cases()


def _write(base, name, cols):
    hst.engine.io.write_parquet(Table.from_pydict(cols, "cpu"), os.path.join(base, name, "part-00000.parquet"))


@pytest.fixture()
def both(tmp_path, monkeypatch):
    """Builds the case's two sources and a covering index on each key, in
    both packages; returns a query factory per package."""
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()

    def build(case):
        left, right = CASES[case]
        _write(str(tmp_path), "l", left)
        _write(str(tmp_path), "r", right)
        lk, rk = list(left)[0], list(right)[0]
        lp, rp = list(left)[1], list(right)[1]
        ts = hst.HyperspaceSession(warehouse=str(tmp_path / "torch"), device="cpu")
        ts.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
        js = JaxSession(warehouse=str(tmp_path / "jax"))
        js.conf.set(JaxIndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
        th, jh = hst.Hyperspace(ts), JaxHyperspace(js)
        for s, h, cfg in ((ts, th, hst.IndexConfig), (js, jh, JaxIndexConfig)):
            h.create_index(s.read.parquet(str(tmp_path / "l")), cfg("kl", [lk], [lp]))
            h.create_index(s.read.parquet(str(tmp_path / "r")), cfg("kr", [rk], [rp]))

        def q(s, c):
            return s.read.parquet(str(tmp_path / "l")).join(s.read.parquet(str(tmp_path / "r")), c(lk) == c(rk)).select(
                lk, lp, rk, rp
            )

        return ts, js, (lambda: q(ts, hst.col)), (lambda: q(js, jax_col)), (lk, rk)

    return build


def _bucketed_join(df) -> bool:
    plan = df.physical_plan()
    join = next(n for n in plan.collect_nodes() if isinstance(n, SortMergeJoinExec))
    scans = [n for n in plan.collect_nodes() if isinstance(n, BucketedIndexScanExec)]
    return join.bucketed and len(scans) == 2


def _no_null_keys(t, keys):
    for k in keys:
        assert t.column(k).validity is None or bool(t.column(k).validity.all())


@pytest.mark.parametrize("indexed", [True, False], ids=["indexed", "plain"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_join_keys_equal_jax_rows_in_order(both, case, indexed):
    ts, js, tq, jq, keys = both(case)
    if indexed:
        hst.enable_hyperspace(ts)
        jax_enable(js)
    assert _bucketed_join(tq()) == indexed
    got, want = tq().collect(), jq().collect()
    assert_same(got, want)
    assert got.num_rows > 0
    _no_null_keys(got, keys)
    assert tq().count() == jq().count() == got.num_rows


@pytest.mark.parametrize("case", sorted(CASES))
def test_indexed_equals_plain_and_null_keys_never_match(both, case):
    ts, _, tq, _, keys = both(case)
    plain = tq().collect()
    hst.enable_hyperspace(ts)
    indexed = tq().collect()
    assert_same(indexed, plain, ordered=False)
    left, right = CASES[case]
    lk, rk = keys
    lv = [v for v in left[lk] if v is not None]
    rv = [v for v in right[rk] if v is not None]
    expect = sum(int(np.sum(np.asarray(rv, dtype=object) == v)) for v in lv)
    assert plain.num_rows == expect


def test_users_orders_pairs(both):
    """tests/test_nulls.py:100 — expected matches 1→10, 4→30, 4→40, 8→50."""
    ts, _, tq, _, _ = both("users_orders")
    for on in (False, True):
        (hst.enable_hyperspace if on else hst.disable_hyperspace)(ts)
        rows = host_rows(tq().select("uid", "amount").collect())
        assert sorted(zip(rows["uid"], rows["amount"])) == [(1, 10), (4, 30), (4, 40), (8, 50)]


@pytest.mark.parametrize("case", ["null_ints", "users_orders"])
def test_a_nullable_key_never_goes_value_mode(both, case):
    ts, _, tq, _, _ = both(case)
    hst.enable_hyperspace(ts)
    join = next(n for n in tq().physical_plan().collect_nodes() if isinstance(n, SortMergeJoinExec))
    ctx = ExecContext(ts)
    left, l_starts = join.left.execute_concat(ctx)
    right, r_starts = join.right.execute_concat(ctx)
    assert left.column(join.left_keys[0]).validity is not None
    assert _value_mode_column(left, join.left_keys) is None
    plan = _classed_plan(left, right, join.left_keys, join.right_keys, l_starts, r_starts)
    assert plan.mode == "hash"


def test_string_keys_verify_through_the_ver_memo(both):
    ts, _, tq, _, _ = both("null_strings")
    hst.enable_hyperspace(ts)
    before = physical.memo_stats()["ver"]
    first = tq().collect()
    mid = physical.memo_stats()["ver"]
    assert mid["misses"] == before["misses"] + 1
    physical._pairs_cache.clear()  # the pairs memo would skip verification
    second = tq().collect()
    after = physical.memo_stats()["ver"]
    assert after["hits"] == mid["hits"] + 1 and after["misses"] == mid["misses"]
    assert_same(second, first)
    assert physical.device_cache_stats()["bytes"] > 0


def test_the_ver_memo_dies_with_its_tables(both):
    ts, _, tq, _, _ = both("string_hot")
    hst.enable_hyperspace(ts)
    tq().collect()
    assert physical._verify_cache
    scan_cache.clear_scan_caches()
    import gc

    gc.collect()
    assert not physical._verify_cache


def _key_tables(pkg):
    s = np.array(["x", "y", "z"], dtype=object)
    n = np.array([1, 2, 3], dtype=np.int64)
    if pkg == "torch":
        return Table.from_pydict({"s": s}, "cpu"), Table.from_pydict({"n": n}, "cpu"), torch.tensor([0, 1])
    return JaxTable.from_pydict({"s": s}), JaxTable.from_pydict({"n": n}), np.array([0, 1])


def test_a_string_key_against_a_numeric_key_raises_in_both_packages():
    left, right, idx = _key_tables("torch")
    with pytest.raises(hst.HyperspaceException, match="string vs numeric"):
        _verify_pairs(left, right, ["s"], ["n"], idx, idx)
    jleft, jright, jidx = _key_tables("jax")
    with pytest.raises(JaxHyperspaceException, match="string vs numeric"):
        jax_physical._verify_pairs(jleft, jright, ["s"], ["n"], jidx, jidx)


def test_verification_drops_null_pairs_and_collisions():
    """Candidate pairs a hash would produce for equal fills (null slots) and
    for unequal values: verification keeps only equal, valid keys."""
    left = Table.from_pydict({"k": np.array([1, None, 3, None, 5], dtype=object)}, "cpu")
    right = Table.from_pydict({"k": np.array([None, 1, 3, 4, 5], dtype=object)}, "cpu")
    li = torch.tensor([0, 1, 3, 2, 4, 4, 1])
    ri = torch.tensor([1, 0, 0, 2, 4, 3, 3])
    kl, kr = _verify_pairs(left, right, ["k"], ["k"], li, ri)
    assert kl.tolist() == [0, 2, 4] and kr.tolist() == [1, 2, 4]
    jl, jr = jax_physical._verify_pairs(
        JaxTable.from_pydict({"k": np.array([1, None, 3, None, 5], dtype=object)}),
        JaxTable.from_pydict({"k": np.array([None, 1, 3, 4, 5], dtype=object)}),
        ["k"], ["k"], li.numpy(), ri.numpy(),
    )
    assert jl.tolist() == kl.tolist() and jr.tolist() == kr.tolist()


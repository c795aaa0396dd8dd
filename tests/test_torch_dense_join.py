"""The co-bucketed join's dense layout in the port against the JAX package.

Under `HYPERSPACE_JOIN_SIZE_CLASSES=0` both packages pad every bucket of a
side to the side's largest bucket, one [B, cap] matrix a side, and probe the
smaller capacity into the larger for all buckets at once
(`ops/bucket_join.py` `pad_buckets_by_value`, `pad_buckets_by_hash`,
`probe_padded`; `engine/physical.py` `_padded_rep`, `_reconciled_reps`,
`_probe_ranges_cached`). Both packages read the same seeded parquet files,
each building its own covering indexes, and the JAX package runs its device
program on the CPU (`HYPERSPACE_FORCE_DEVICE_OPS=1`,
`HYPERSPACE_DISTRIBUTED=0`). The port must give:

- the reps of the JAX package's ops (keys, order, lengths, pairs), the
  swapped orientation, NaN, -0.0, an unsorted bucket and int64's max among
  them;
- for the six skew shapes of `tests/test_skewed_join.py:114-200`, and one
  whose probe orientation differs between the layouts, the JAX package's
  count, `collect()` rows in its order and grouped aggregate (integers
  exact, float sums at rtol 1e-9, the aggregate oracles' tolerance), and
  its own size-classed answer as sorted rows;
- every join type on int, float and string keys, rows in order;
- a mixed pair after a Hybrid Scan append reconciled to hash mode;
- right answers across a flip of the flag 1 -> 0 -> 1 on the same tables.

The dense layout is told from the classed one by the pad counters each
records (`pad.join_buckets.*` and `pad.join_class.*`).
"""

import os

import numpy as np
import pytest
import torch

import hyperspace_tpu_torch as hst
from hyperspace_tpu import IndexConfig as JaxIndexConfig
from hyperspace_tpu import IndexConstants as JaxIndexConstants
from hyperspace_tpu.engine import HyperspaceSession as JaxSession
from hyperspace_tpu.engine import col as jax_col
from hyperspace_tpu.engine import physical as jax_physical
from hyperspace_tpu.hyperspace import Hyperspace as JaxHyperspace
from hyperspace_tpu.hyperspace import enable_hyperspace as jax_enable
from hyperspace_tpu.ops import bucket_join as jax_bucket_join
from hyperspace_tpu_torch.engine import io as engine_io
from hyperspace_tpu_torch.engine import physical, scan_cache
from hyperspace_tpu_torch.engine.physical import ExecContext, SortMergeJoinExec
from hyperspace_tpu_torch.engine.table import Table
from hyperspace_tpu_torch.ops import bucket_join
from hyperspace_tpu_torch.telemetry import metrics
from test_torch_aggregate import assert_same

NUM_BUCKETS = 8
HOWS = ["inner", "left", "right", "full", "left_semi", "left_anti"]
FLAGS = ("HYPERSPACE_JOIN_SIZE_CLASSES", "HYPERSPACE_JOIN_OUTLIER_FACTOR", "HYPERSPACE_QUERY_STREAMING",
         "HYPERSPACE_MULTIWAY")


@pytest.fixture(autouse=True)
def _reference_path(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    monkeypatch.setenv("HYPERSPACE_FORCE_DEVICE_OPS", "1")
    for flag in FLAGS:
        monkeypatch.delenv(flag, raising=False)
    monkeypatch.setenv("HYPERSPACE_JOIN_SIZE_CLASSES", "0")
    _clear()


def _clear():
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()
    jax_physical.clear_device_memos()


def pad_bytes(site: str) -> int:
    """The payload and padded bytes the port has recorded at a pad site."""
    return sum(metrics.counter(f"pad.{site}.bytes_{part}").value for part in ("payload", "padded"))


class Lake:
    """Two sources `l` and `r` (the first column of each is its join key) and
    a covering index on each key, built by both packages."""

    def __init__(self, base, left: dict, right: dict, num_buckets=NUM_BUCKETS, hybrid=False):
        self.base = str(base)
        self.write("l", left)
        self.write("r", right)
        self.lk, self.rk = next(iter(left)), next(iter(right))
        self.cols = list(left) + [c for c in right if c != self.rk]
        self.t = hst.HyperspaceSession(warehouse=os.path.join(self.base, "torch"), device="cpu")
        self.j = JaxSession(warehouse=os.path.join(self.base, "jax"))
        for s, k in ((self.t, hst.IndexConstants), (self.j, JaxIndexConstants)):
            s.conf.set(k.INDEX_NUM_BUCKETS, num_buckets)
            if hybrid:
                s.conf.set(k.INDEX_HYBRID_SCAN_ENABLED, "true")
        for s, h, cfg in ((self.t, hst.Hyperspace(self.t), hst.IndexConfig),
                          (self.j, JaxHyperspace(self.j), JaxIndexConfig)):
            h.create_index(s.read.parquet(os.path.join(self.base, "l")),
                           cfg("dL", [self.lk], [c for c in left if c != self.lk]))
            h.create_index(s.read.parquet(os.path.join(self.base, "r")),
                           cfg("dR", [self.rk], [c for c in right if c != self.rk]))
        hst.enable_hyperspace(self.t)
        jax_enable(self.j)

    def write(self, table: str, cols: dict, name: str = "part-00000.parquet") -> None:
        engine_io.write_parquet(Table.from_pydict(cols, "cpu"), os.path.join(self.base, table, name))

    def join(self, how="inner"):
        """(port DataFrame, JAX DataFrame) of l ⋈ r on the keys."""

        def q(s, c):
            rd = lambda t: s.read.parquet(os.path.join(self.base, t))  # noqa: E731
            return rd("l").join(rd("r"), c(self.lk) == c(self.rk), how)

        return q(self.t, hst.col), q(self.j, jax_col)

    def rows(self):
        """The inner join's payload columns, in both packages."""
        tq, jq = self.join()
        return tq.select(*self.cols), jq.select(*self.cols)

    def agg(self, group: str, value: str):
        """A grouped aggregate over the inner join: integer sum, count and
        max, and a float sum of a computed column (the fused join aggregate)."""

        def q(df, c):
            return (df.with_column("f", c(value) * 0.37).group_by(group)
                    .agg(t=(value, "sum"), c=(value, "count"), m=(value, "max"), fs=("f", "sum")))

        tq, jq = self.join()
        return q(tq, hst.col), q(jq, jax_col)

    def join_node(self, df) -> SortMergeJoinExec:
        return next(n for n in df.physical_plan().collect_nodes() if isinstance(n, SortMergeJoinExec))


def sorted_rows(t):
    return sorted(tuple(repr(v) for v in r) for r in t.rows())


# -- the ops against the JAX package's ------------------------------------------


def _jax_rep_arrays(rep):
    return (np.asarray(rep.keys), np.asarray(rep.lengths), None if rep.order is None else np.asarray(rep.order))


def _same_rep(got, want):
    assert got is not None and want is not None
    assert got.mode == want.mode
    gk, gl, go = got.keys.numpy(), got.lengths.numpy(), None if got.order is None else got.order.numpy()
    wk, wl, wo = _jax_rep_arrays(want)
    assert gk.dtype == wk.dtype and gk.shape == wk.shape
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gl, wl)
    assert (go is None) == (wo is None)
    if go is not None:
        np.testing.assert_array_equal(go.astype(np.int64), wo.astype(np.int64))
    np.testing.assert_array_equal(got.starts, want.starts)


def _bucketed(rng, lens, dtype, distinct, sort=True):
    """Values of consecutive buckets of `lens` rows, each sorted when `sort`,
    and the bucket offsets."""
    parts = []
    for n in lens:
        v = rng.randint(0, distinct, n).astype(dtype)
        parts.append(np.sort(v) if sort else v)
    starts = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    return np.concatenate(parts) if parts else np.empty(0, dtype), starts


VALUE_CASES = {
    "int64": (np.int64, [5, 0, 9, 3, 16, 1]),
    "int32": (np.int32, [7, 2, 0, 4]),
    "float64": (np.float64, [3, 8, 8, 1, 0]),
    "one_bucket": (np.int64, [33]),
}


@pytest.mark.parametrize("case", list(VALUE_CASES))
def test_pad_buckets_by_value_equals_jax(case):
    dtype, lens = VALUE_CASES[case]
    vals, starts = _bucketed(np.random.RandomState(1), lens, dtype, 12)
    if dtype == np.float64:
        vals = np.where(vals == 0, -0.0, vals - 5.5)
        vals = np.concatenate([np.sort(vals[s:e]) for s, e in zip(starts[:-1], starts[1:])])
    got = bucket_join.pad_buckets_by_value(torch.from_numpy(vals), starts)
    want = jax_bucket_join.pad_buckets_by_value(vals, starts)
    _same_rep(got, want)
    assert got.order is None and got.mode == "value"
    if dtype == np.float64:  # -0.0 is stored as +0.0, the pad is the float max
        assert not np.signbit(got.keys.numpy()[got.keys.numpy() == 0]).any()
        assert got.keys.numpy()[-1, -1] == np.finfo(np.float64).max


@pytest.mark.parametrize("case", ["nan", "singleton_nan", "unsorted", "empty"])
def test_value_reps_decline_where_jax_declines(case):
    """A NaN key (even a singleton bucket's), an unsorted bucket or no rows:
    no value rep in either package."""
    if case == "empty":
        vals, starts = np.empty(0, np.int64), np.zeros(4, np.int64)
    elif case == "unsorted":
        vals, starts = np.array([1, 2, 3, 9, 4, 5], np.int64), np.array([0, 3, 6], np.int64)
    else:
        vals = np.array([1.0, 2.0, np.nan, 4.0, 5.0]) if case == "nan" else np.array([1.0, 2.0, np.nan, 4.0])
        starts = np.array([0, 2, 5], np.int64) if case == "nan" else np.array([0, 2, 3, 4], np.int64)
    assert bucket_join.pad_buckets_by_value(torch.from_numpy(vals), starts) is None
    assert jax_bucket_join.pad_buckets_by_value(vals, starts) is None


@pytest.mark.parametrize("lens", [[5, 0, 9, 3, 16, 1], [1], [0, 0, 7], [64, 64, 2]])
def test_pad_buckets_by_hash_equals_jax(lens):
    rng = np.random.RandomState(len(lens))
    k64, starts = _bucketed(rng, lens, np.int64, 10, sort=False)
    k64 = k64 * (2**59 + 12345) - 2**61  # spread over int64, duplicate runs kept
    k64[:3] = np.iinfo(np.int64).max  # nudged below the pad
    got = bucket_join.pad_buckets_by_hash(torch.from_numpy(k64), starts)
    want = jax_bucket_join.pad_buckets_by_hash(k64, starts)
    _same_rep(got, want)
    assert got.keys.shape[1] == bucket_join._cap_pow2(max(lens))


def _pair_reps(pkg, mode, l_vals, l_starts, r_vals, r_starts):
    as_in = torch.from_numpy if pkg is bucket_join else (lambda a: a)
    pad = pkg.pad_buckets_by_value if mode == "value" else pkg.pad_buckets_by_hash
    return pad(as_in(l_vals), l_starts), pad(as_in(r_vals), r_starts)


PROBE_CASES = {
    # (mode, left lens, right lens, left dtype, right dtype): the left cap
    # above the right's swaps the orientation; equal caps keep it.
    "value_left_probes": ("value", [3, 5, 0, 2], [9, 16, 4, 12], np.int64, np.int64),
    "value_swapped": ("value", [30, 17, 9, 2], [3, 5, 1, 4], np.int64, np.int64),
    "value_equal_caps": ("value", [7, 8, 3], [8, 5, 6], np.int64, np.int64),
    "value_int64_by_float32": ("value", [6, 9, 4], [20, 3, 11], np.int64, np.float32),
    "value_int32_by_int64_swapped": ("value", [12, 3], [4, 6], np.int32, np.int64),
    "hash_left_probes": ("hash", [3, 5, 0, 2], [9, 16, 4, 12], np.int64, np.int64),
    "hash_swapped": ("hash", [40, 3, 9, 2], [3, 5, 1, 4], np.int64, np.int64),
}


@pytest.mark.parametrize("case", list(PROBE_CASES))
def test_probe_padded_equals_jax(case):
    mode, l_lens, r_lens, l_dtype, r_dtype = PROBE_CASES[case]
    rng = np.random.RandomState(7)
    l_vals, l_starts = _bucketed(rng, l_lens, l_dtype, 9)
    r_vals, r_starts = _bucketed(rng, r_lens, r_dtype, 9)
    if case == "value_left_probes":  # a real key at int64's max, the value rep's pad
        l_vals[l_starts[1] - 1] = r_vals[r_starts[1] - 1] = np.iinfo(np.int64).max
    got = _pair_reps(bucket_join, mode, l_vals, l_starts, r_vals, r_starts)
    want = _pair_reps(jax_bucket_join, mode, l_vals, l_starts, r_vals, r_starts)
    for g, w in zip(got, want):
        _same_rep(g, w)
    swapped = bucket_join.probe_orientation(*got)[2]
    assert swapped == jax_bucket_join.probe_orientation(*want)[2] == ("swapped" in case)
    gli, gri = bucket_join.probe_padded(*got)
    wli, wri = jax_bucket_join.probe_padded(*want)
    assert len(gli) > 0
    np.testing.assert_array_equal(gli.numpy(), np.asarray(wli))
    np.testing.assert_array_equal(gri.numpy(), np.asarray(wri))
    if case == "value_left_probes":
        pairs = set(zip(gli.tolist(), gri.tolist()))
        assert (int(l_starts[1] - 1), int(r_starts[1] - 1)) in pairs


def test_probe_padded_refuses_mixed_modes():
    vals, starts = _bucketed(np.random.RandomState(2), [4, 3], np.int64, 5)
    v = bucket_join.pad_buckets_by_value(torch.from_numpy(vals), starts)
    h = bucket_join.pad_buckets_by_hash(torch.from_numpy(vals), starts)
    with pytest.raises(ValueError, match="mixed padded modes"):
        bucket_join.probe_padded(v, h)


# -- the skew shapes of tests/test_skewed_join.py:114-200 ----------------------


def _skew_shapes():
    """name -> (left columns, right columns, outlier factor or None)."""
    out = {}
    rng = np.random.RandomState(3)
    n = 8000
    k = rng.randint(0, 400, n).astype(np.int64)
    k[: int(n * 0.4)] = 7
    out["one_hot_key_with_outliers"] = (
        {"k": k, "v": rng.randint(0, 100, n).astype(np.int64)},
        {"k2": np.arange(400, dtype=np.int64), "w": rng.randint(0, 10, 400).astype(np.int64)}, "2")
    rng = np.random.RandomState(4)
    out["all_rows_one_bucket"] = (
        {"k": np.full(300, 42, np.int64), "v": rng.randint(0, 9, 300).astype(np.int64)},
        {"k2": np.full(40, 42, np.int64), "w": rng.randint(0, 9, 40).astype(np.int64)}, None)
    rng = np.random.RandomState(5)
    out["empty_buckets"] = (
        {"k": rng.choice(np.asarray([1, 50, 999], np.int64), 2000), "v": rng.randint(0, 100, 2000).astype(np.int64)},
        {"k2": np.asarray([1, 999, 1234], np.int64), "w": np.asarray([5, 6, 7], np.int64)}, None)
    rng = np.random.RandomState(6)
    n = 4000
    k = np.array([f"sku-{i:04d}" for i in rng.randint(0, 200, n)], dtype=object)
    k[: n // 2] = "sku-HOT"
    out["string_keys_hot"] = (
        {"k": k, "v": rng.randint(0, 100, n).astype(np.int64)},
        {"k2": np.array([f"sku-{i:04d}" for i in range(200)] + ["sku-HOT"], dtype=object),
         "w": rng.randint(0, 10, 201).astype(np.int64)}, None)
    rng = np.random.RandomState(7)
    n = 3000
    k = rng.randint(0, 100, n).astype(object)
    k[::5] = None
    k2 = np.arange(100).astype(object)
    k2[::9] = None
    out["null_keys"] = (
        {"k": k, "v": rng.randint(0, 100, n).astype(np.int64)},
        {"k2": k2, "w": rng.randint(0, 10, 100).astype(np.int64)}, None)
    rng = np.random.RandomState(8)
    n = 2000
    k = (rng.randint(0, 50, n) * 0.5).astype(np.float64)
    k[::17] = -0.0
    out["float_keys_value_mode"] = (
        {"k": k, "v": rng.randint(0, 100, n).astype(np.int64)},
        {"k2": np.concatenate([np.arange(50) * 0.5, [0.0]]).astype(np.float64),
         "w": rng.randint(0, 10, 51).astype(np.int64)}, None)
    # One hot left bucket sets the left side's global capacity above the
    # right's, so the dense layout probes right into left for every bucket
    # while the classed layout probes left into right in every other class:
    # the two layouts order those buckets' rows differently.
    rng = np.random.RandomState(9)
    k = np.concatenate([np.arange(400), np.full(3000, 7)]).astype(np.int64)
    out["orientation_flips"] = (
        {"k": k, "v": rng.randint(0, 100, len(k)).astype(np.int64)},
        {"k2": np.repeat(np.arange(400, dtype=np.int64), 5), "w": rng.randint(0, 10, 2000).astype(np.int64)}, None)
    return out


SKEW = _skew_shapes()


@pytest.mark.parametrize("shape", list(SKEW))
def test_skew_shapes_give_the_jax_dense_answers(tmp_path, monkeypatch, shape):
    left, right, factor = SKEW[shape]
    if factor is not None:
        monkeypatch.setenv("HYPERSPACE_JOIN_OUTLIER_FACTOR", factor)
    lake = Lake(tmp_path, left, right)
    tq, jq = lake.rows()
    assert lake.join_node(tq).bucketed
    dense0, class0 = pad_bytes("join_buckets"), pad_bytes("join_class")
    n = tq.count()
    assert n == jq.count() > 0
    got = tq.collect()
    assert_same(got, jq.collect())
    assert got.num_rows == n
    ta, ja = lake.agg("k", "v")
    assert_same(ta.collect(), ja.collect(), approx_cols=("fs",))
    # The port ran the dense layout, and its classed layout agrees as rows.
    assert pad_bytes("join_buckets") > dense0 and pad_bytes("join_class") == class0
    monkeypatch.setenv("HYPERSPACE_JOIN_SIZE_CLASSES", "1")
    _clear()
    classed = lake.rows()[0]
    assert classed.count() == n
    classed_rows = classed.collect().rows()
    assert sorted_rows(classed.collect()) == sorted_rows(got)
    assert pad_bytes("join_class") > class0
    assert (classed_rows != got.rows()) == (shape == "orientation_flips")


# -- every join type, on int, float and string keys ----------------------------


def _kind_lake(tmp_path, kind):
    rng = np.random.RandomState({"int": 11, "float": 12, "string": 13}[kind])
    lk = rng.randint(0, 60, 1500)
    rk = rng.randint(20, 90, 200)
    if kind == "float":
        lk, rk = lk * 0.25 - 3.0, rk * 0.25 - 3.0
        lk[::23] = -0.0
    elif kind == "string":
        lk = np.array([f"c{x:03d}" for x in lk], dtype=object)
        rk = np.array([f"c{x:03d}" for x in rk], dtype=object)
    left = {"k": lk, "v": rng.randint(0, 1000, 1500).astype(np.int64)}
    right = {"k2": rk, "w": rng.rand(200)}
    return Lake(tmp_path, left, right)


@pytest.fixture(scope="module")
def kind_lakes(tmp_path_factory):
    return {kind: _kind_lake(tmp_path_factory.mktemp(kind), kind) for kind in ("int", "float", "string")}


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("kind", ["int", "float", "string"])
def test_every_join_type_equals_jax_rows_in_order(kind_lakes, kind, how):
    lake = kind_lakes[kind]
    tq, jq = lake.join(how)
    join = lake.join_node(tq)
    assert join.bucketed and join.how == how
    dense0 = pad_bytes("join_buckets")
    got = tq.collect()
    assert_same(got, jq.collect())
    assert tq.count() == jq.count() == got.num_rows > 0
    assert pad_bytes("join_buckets") > dense0
    ctx = ExecContext(lake.t)
    left, right, ls, rs, _, _ = join._sides(ctx)
    modes = {r.mode for r in join._reconciled_reps(left, right, ls, rs)}
    assert modes == {"hash" if kind == "string" else "value"}


def test_a_rep_past_the_device_cache_budget_still_answers(kind_lakes):
    """Every dense rep is larger than a 1-byte budget: each insert evicts
    the others but keeps itself, and the join answers as the JAX package's."""
    lake = kind_lakes["int"]
    before = physical.device_cache_stats()
    physical.set_device_cache_budget(1)
    try:
        tq, jq = lake.rows()
        got = tq.collect()
        assert_same(got, jq.collect())
        assert tq.count() == jq.count() == got.num_rows > 0
        stats = physical.device_cache_stats()
        assert stats["evictions"] > before["evictions"] and stats["entries"] >= 1
    finally:
        physical.set_device_cache_budget(before["budget"])


# -- a mixed pair, and a flip of the flag ---------------------------------------


def test_a_hybrid_append_reconciles_both_sides_to_hash(tmp_path):
    """Left's buckets unsorted by an appended file under Hybrid Scan: the
    left rep goes by hash, so the right's is derived by hash too."""
    rng = np.random.RandomState(21)
    left = {"k": rng.randint(0, 80, 900).astype(np.int64), "v": rng.randint(0, 100, 900).astype(np.int64)}
    right = {"k2": np.arange(0, 80, dtype=np.int64), "w": rng.rand(80)}
    lake = Lake(tmp_path, left, right, num_buckets=4, hybrid=True)
    lake.write("l", {"k": rng.randint(0, 80, 300).astype(np.int64), "v": rng.randint(0, 100, 300).astype(np.int64)},
               "part-00001.parquet")
    tq, jq = lake.rows()
    join = lake.join_node(tq)
    assert join.bucketed and "appended" in tq.explain_string()
    got = tq.collect()
    assert_same(got, jq.collect())
    assert tq.count() == jq.count() == got.num_rows
    left_t, right_t, ls, rs, _, _ = join._sides(ExecContext(lake.t))
    assert physical._padded_rep(left_t, ls, ["k"]).mode == "hash"
    assert physical._padded_rep(right_t, rs, ["k2"]).mode == "value"
    l_rep, r_rep = join._reconciled_reps(left_t, right_t, ls, rs)
    assert (l_rep.mode, r_rep.mode) == ("hash", "hash")
    ta, ja = lake.agg("k", "v")
    assert_same(ta.collect(), ja.collect(), approx_cols=("fs",))


def test_a_flip_of_the_flag_mid_session_keeps_counts_and_rows(tmp_path, monkeypatch):
    """1 -> 0 -> 1 on the same tables, caches kept. Value-mode counts run on
    each layout's own ranges (the classed ("cprobe", mode) and the dense
    ("probe", mode) memo keys), so neither is handed the other's; then a
    collect under each flag. Every step equals the JAX package doing the
    same, count and rows in order, and numpy's count."""
    left, right, _ = SKEW["one_hot_key_with_outliers"]
    lake = Lake(tmp_path, left, right)
    want_n = int((left["k"][:, None] == right["k2"][None, :]).sum())
    steps = [("1", "count"), ("0", "count"), ("1", "count"), ("0", "collect"), ("1", "collect")]
    rows = []
    for flag, what in steps:
        monkeypatch.setenv("HYPERSPACE_JOIN_SIZE_CLASSES", flag)
        tq, jq = lake.rows()
        assert tq.count() == jq.count() == want_n
        if what == "collect":
            got = tq.collect()
            assert_same(got, jq.collect())
            rows.append(sorted_rows(got))
        markers = {k[-4] for k in physical._pairs_cache if len(k) >= 4 and k[-4] in ("probe", "cprobe")}
        assert markers == ({"cprobe"} if len(markers) == 1 else {"probe", "cprobe"})
    assert markers == {"probe", "cprobe"}
    assert rows[0] == rows[1] and len(rows[0]) == want_n

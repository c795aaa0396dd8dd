"""The multiway star join in the port against the JAX package.

Every case of `tests/test_star_join.py` runs in both packages over the same
parquet files, each building its own covering indexes (one per dimension,
on its first column). The JAX package runs its device program
(`HYPERSPACE_FORCE_DEVICE_OPS=1`, `HYPERSPACE_DISTRIBUTED=0`). For each
star query:

- both packages plan one `MultiwayJoinExec` over the same dimensions, with
  the same plan text (the index system path aside);
- the streamed star aggregate (`join_mode == "star"` in each package's
  `last_join_stages()`) gives the JAX package's rows in its order with its
  schema, and the same per-dimension pair counts and memo outcomes;
- under `HYPERSPACE_MULTIWAY=0` neither plans the star, and the port's
  cascade gives the JAX package's cascade;
- with Hyperspace disabled the port's rows equal the star's as a multiset.

Tolerance: exact everywhere, float sums included. The port reproduces the
JAX device program's fold order (each cell's rows added in row order under
the direct-cells hint, each group's states in chunk order otherwise), so
its float sums equal the reference's bit for bit on these inputs; a star's
float sum against the disabled query's is compared at rtol 1e-9, the
streaming contract (the fold orders differ).

`test_star_float_sum_groups_in_cell_order` is the probe of the port's old
default: the JAX device program streams this star by direct cells (groups
g1 = 0, 1, 2, ... and group 0's float sum 20546.631228430888), while its
cascade, which the port used to run, orders groups by key64 (0, 6, 1, 5,
...) and sums to 20546.631228430884.
"""

import os
import re

import numpy as np
import pytest

from hyperspace_tpu.engine import physical as jax_physical
from hyperspace_tpu.telemetry.profiling import last_join_stages as jax_last_join_stages
from hyperspace_tpu_torch.engine import physical, scan_cache
from hyperspace_tpu_torch.ops.aggregate import StreamAggregator
from hyperspace_tpu_torch.telemetry.profiling import last_join_stages
from test_torch_udf_setops import Twin

NUM_BUCKETS = 8
FLAGS = ("HYPERSPACE_QUERY_STREAMING", "HYPERSPACE_MULTIWAY", "HYPERSPACE_JOIN_SIZE_CLASSES",
         "HYPERSPACE_JOIN_CHUNK_ROWS")


@pytest.fixture(autouse=True)
def _reference_path(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    monkeypatch.setenv("HYPERSPACE_FORCE_DEVICE_OPS", "1")
    for flag in FLAGS:
        monkeypatch.delenv(flag, raising=False)
    _clear()


def _clear():
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()
    jax_physical.clear_device_memos()


def _phys(p):
    return physical if p.name == "torch" else jax_physical


def _last(p):
    return (last_join_stages if p.name == "torch" else jax_last_join_stages)()


def _stars(p, df):
    return [n for n in df.physical_plan().collect_nodes() if isinstance(n, _phys(p).MultiwayJoinExec)]


def _write_parts(twin, name, data, parts):
    n = len(next(iter(data.values())))
    cut = [int(round(i * n / parts)) for i in range(parts + 1)]
    for i in range(parts):
        twin.write(name, {k: np.asarray(v)[cut[i]:cut[i + 1]] for k, v in data.items()}, f"part-{i:05d}.parquet")


def make_star(tmp_path, fact, dims, fact_parts=2, dim_parts=1, **conf):
    """Both packages over one fact and N dimensions, each dimension indexed
    on its first column and covering the rest."""
    twin = Twin(tmp_path, buckets=NUM_BUCKETS, **conf)
    _write_parts(twin, "fact", fact, fact_parts)
    for name, d in dims:
        _write_parts(twin, name, d, dim_parts)
    for p in (twin.t, twin.j):
        for name, d in dims:
            k = list(d)[0]
            p.index(name, f"star_{name}", [k], [c for c in d if c != k])
        p.on(p.s)
    return twin


def _star2(seed=3, n=8000, hot=True):
    """The canonical star of one fact and two dimensions, a hot key on dim1."""
    rng = np.random.RandomState(seed)
    k1 = rng.randint(0, 200, n).astype(np.int64)
    if hot:
        k1[: n // 3] = 7
    fact = {
        "k1": k1,
        "k2": rng.randint(0, 50, n).astype(np.int64),
        "v": rng.randint(0, 100, n).astype(np.int64),
    }
    dim1 = {"d1": np.arange(200, dtype=np.int64), "g1": rng.randint(0, 10, 200).astype(np.int64)}
    dim2 = {"d2": np.arange(50, dtype=np.int64), "g2": rng.randint(0, 5, 50).astype(np.int64)}
    return fact, [("dim1", dim1), ("dim2", dim2)]


def _q2(group="g1", agg_col="v"):
    def q(p):
        c = p.col
        return (
            p.read("fact").join(p.read("dim1"), c("k1") == c("d1")).join(p.read("dim2"), c("k2") == c("d2"))
            .group_by(group).agg(t=(agg_col, "sum"), c=(agg_col, "count"), m=(agg_col, "max"))
        )

    return q


def _same_floats(a, b, rtol=1e-9):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            if isinstance(x, (float, np.floating)):
                assert np.isclose(x, y, rtol=rtol, atol=0), (ra, rb)
            else:
                assert x == y, (ra, rb)


def _plan(p, q):
    """The plan text; the port's line of a Hybrid Scan index scan names its
    appended files (" (+N appended)"), the JAX package's does not."""
    return re.sub(r" \(\+\d+ appended\)", "", p.plan(q(p)))


def check_star(twin, q, monkeypatch, expect_dims=2, float_cols=()):
    """The shared harness (`test_star_join._check_star`), each step in both
    packages; returns the star's rows."""
    for p in (twin.t, twin.j):
        nodes = _stars(p, q(p))
        assert len(nodes) == 1 and len(nodes[0].dims) == expect_dims, p.plan(q(p))
    tplan, jplan = twin.both(lambda p: _plan(p, q))
    assert tplan == jplan

    monkeypatch.setenv("HYPERSPACE_QUERY_STREAMING", "1")
    _clear()
    star = twin.same(q)
    ts, js = twin.both(_last)
    assert ts is not None and ts["join_mode"] == "star" == js["join_mode"]
    assert len(ts["star_dims"]) == expect_dims
    assert ([(d["index"], d["buckets"], d["pairs"], d["memo"]) for d in ts["star_dims"]]
            == [(d["index"], d["buckets"], d["pairs"], d["memo"]) for d in js["star_dims"]])
    assert (ts["chunks"], ts["pairs"], ts["groups"], ts["direct_cells"]) == (
        js["chunks"], js["pairs"], js["groups"], js["direct_cells"])

    monkeypatch.setenv("HYPERSPACE_MULTIWAY", "0")
    _clear()
    for p in (twin.t, twin.j):
        assert not _stars(p, q(p))
    tplan, jplan = twin.both(lambda p: _plan(p, q))
    assert tplan == jplan
    cascade = twin.same(q)
    monkeypatch.delenv("HYPERSPACE_MULTIWAY")

    twin.t.off(twin.t.s)
    oracle = q(twin.t).collect()
    twin.t.on(twin.t.s)
    star_rows = sorted(star.rows(), key=lambda r: tuple(str(x) for x in r if not isinstance(x, float)))
    oracle_rows = sorted(oracle.rows(), key=lambda r: tuple(str(x) for x in r if not isinstance(x, float)))
    if float_cols:
        _same_floats(star_rows, oracle_rows)
        cascade_rows = sorted(cascade.rows(), key=lambda r: tuple(str(x) for x in r if not isinstance(x, float)))
        _same_floats(cascade_rows, star_rows)
    else:
        assert star_rows == oracle_rows
        assert sorted(cascade.sorted_rows()) == sorted(star.sorted_rows())
    return star


# -- TestStarOracle ---------------------------------------------------------------


def test_int_keys_hot_fk(tmp_path, monkeypatch):
    fact, dims = _star2(hot=True)
    check_star(make_star(tmp_path, fact, dims), _q2(), monkeypatch)


def test_group_by_fact_column(tmp_path, monkeypatch):
    """A fact group key: the direct-cells hint over a column no dimension
    gathers."""
    fact, dims = _star2(seed=5)
    fact["gf"] = (np.asarray(fact["v"]) % 7).astype(np.int64)
    check_star(make_star(tmp_path, fact, dims), _q2(group="gf"), monkeypatch)


def test_three_dimensions(tmp_path, monkeypatch):
    rng = np.random.RandomState(9)
    n = 6000
    fact = {
        "k1": rng.randint(0, 100, n).astype(np.int64),
        "k2": rng.randint(0, 40, n).astype(np.int64),
        "k3": rng.randint(0, 20, n).astype(np.int64),
        "v": rng.randint(0, 100, n).astype(np.int64),
    }
    fact["k1"][: n // 2] = 11
    dims = [
        ("dim1", {"d1": np.arange(100, dtype=np.int64), "g1": rng.randint(0, 10, 100).astype(np.int64)}),
        ("dim2", {"d2": np.arange(40, dtype=np.int64), "g2": rng.randint(0, 5, 40).astype(np.int64)}),
        ("dim3", {"d3": np.arange(20, dtype=np.int64), "g3": rng.randint(0, 4, 20).astype(np.int64)}),
    ]
    twin = make_star(tmp_path, fact, dims)

    def q(p):
        c = p.col
        return (
            p.read("fact").join(p.read("dim1"), c("k1") == c("d1")).join(p.read("dim2"), c("k2") == c("d2"))
            .join(p.read("dim3"), c("k3") == c("d3")).group_by("g1").agg(t=("v", "sum"), c=("v", "count"))
        )

    check_star(twin, q, monkeypatch, expect_dims=3)


def test_string_keys(tmp_path, monkeypatch):
    rng = np.random.RandomState(6)
    n = 4000
    k1 = np.array([f"sku-{i:03d}" for i in rng.randint(0, 60, n)], dtype=object)
    k1[: n // 2] = "sku-HOT"
    fact = {"k1": k1, "k2": rng.randint(0, 30, n).astype(np.int64), "v": rng.randint(0, 100, n).astype(np.int64)}
    dims = [
        ("dim1", {"d1": np.array([f"sku-{i:03d}" for i in range(60)] + ["sku-HOT"], dtype=object),
                  "g1": rng.randint(0, 8, 61).astype(np.int64)}),
        ("dim2", {"d2": np.arange(30, dtype=np.int64), "g2": rng.randint(0, 5, 30).astype(np.int64)}),
    ]
    check_star(make_star(tmp_path, fact, dims), _q2(), monkeypatch)


def test_null_keys_match_nothing(tmp_path, monkeypatch):
    rng = np.random.RandomState(7)
    n = 3000
    k1 = rng.randint(0, 80, n).astype(object)
    k1[::5] = None
    d1k = np.arange(80).astype(object)
    d1k[::9] = None
    fact = {"k1": k1, "k2": rng.randint(0, 25, n).astype(np.int64), "v": rng.randint(0, 100, n).astype(np.int64)}
    dims = [
        ("dim1", {"d1": d1k, "g1": rng.randint(0, 6, 80).astype(np.int64)}),
        ("dim2", {"d2": np.arange(25, dtype=np.int64), "g2": rng.randint(0, 5, 25).astype(np.int64)}),
    ]
    check_star(make_star(tmp_path, fact, dims), _q2(), monkeypatch)


def test_shared_payload_name_collision_suffix(tmp_path, monkeypatch):
    """Two dimensions with one payload name: the cascade's `w_r` suffix."""
    rng = np.random.RandomState(8)
    n = 3000
    fact = {"k1": rng.randint(0, 50, n).astype(np.int64), "k2": rng.randint(0, 20, n).astype(np.int64),
            "v": rng.randint(0, 100, n).astype(np.int64)}
    dims = [
        ("dim1", {"d1": np.arange(50, dtype=np.int64), "w": rng.randint(0, 9, 50).astype(np.int64)}),
        ("dim2", {"d2": np.arange(20, dtype=np.int64), "w": rng.randint(0, 9, 20).astype(np.int64)}),
    ]
    twin = make_star(tmp_path, fact, dims)

    def q(p):
        c = p.col
        return (
            p.read("fact").join(p.read("dim1"), c("k1") == c("d1")).join(p.read("dim2"), c("k2") == c("d2"))
            .group_by("w").agg(t=("v", "sum"), c=("v", "count"))
        )

    check_star(twin, q, monkeypatch)


def test_multi_chunk_stream(tmp_path, monkeypatch):
    monkeypatch.setenv("HYPERSPACE_JOIN_CHUNK_ROWS", "2000")
    fact, dims = _star2(seed=12)
    twin = make_star(tmp_path, fact, dims)
    check_star(twin, _q2(), monkeypatch)
    monkeypatch.setenv("HYPERSPACE_QUERY_STREAMING", "1")
    _clear()
    twin.same(_q2())
    ts, js = twin.both(_last)
    assert ts["join_mode"] == "star" and ts["chunks"] > 1 and ts["chunks"] == js["chunks"]


def test_star_float_sum_groups_in_cell_order(tmp_path, monkeypatch):
    """The default-answer probe: sum, count and a float sum (no max, so the
    direct-cells hint applies) stream by cell in the JAX device program:
    groups in g1 order, group 0's float sum 20546.631228430888; the cascade
    orders by key64 and sums to 20546.631228430884."""
    rng = np.random.RandomState(3)
    n = 8000
    k1 = rng.randint(0, 200, n).astype(np.int64)
    k1[: n // 3] = 7
    fact = {"k1": k1, "k2": rng.randint(0, 50, n).astype(np.int64), "v": rng.randint(0, 100, n).astype(np.int64),
            "p": rng.rand(n) * 100}
    dims = [("dim1", {"d1": np.arange(200, dtype=np.int64), "g1": rng.randint(0, 10, 200).astype(np.int64)}),
            ("dim2", {"d2": np.arange(50, dtype=np.int64), "g2": rng.randint(0, 5, 50).astype(np.int64)})]
    twin = make_star(tmp_path, fact, dims)

    def q(p):
        c = p.col
        return (
            p.read("fact").join(p.read("dim1"), c("k1") == c("d1")).join(p.read("dim2"), c("k2") == c("d2"))
            .group_by("g1").agg(t=("v", "sum"), c=("v", "count"), fp=("p", "sum"))
        )

    star = check_star(twin, q, monkeypatch, float_cols=("fp",)).rows()
    assert [r[0] for r in star] == list(range(10))
    assert star[0][3] == 20546.631228430888
    monkeypatch.setenv("HYPERSPACE_QUERY_STREAMING", "1")
    _clear()
    assert last_join_stages()["direct_cells"] is True
    monkeypatch.setenv("HYPERSPACE_MULTIWAY", "0")
    cascade = twin.same(q).rows()
    assert [r[0] for r in cascade][:4] == [0, 6, 1, 5]
    assert cascade[0][3] == 20546.631228430884


def test_star_with_a_computed_column_and_filters(tmp_path, monkeypatch):
    """Filters on the dimensions, a computed float column over the join and
    a two-key group: the WithColumn/Project chain runs per chunk."""
    fact, dims = _star2(seed=4)
    fact["p"] = np.round(np.random.RandomState(4).rand(len(fact["v"])) * 100, 2)
    twin = make_star(tmp_path, fact, dims)

    def q(p):
        c = p.col
        return (
            p.read("fact")
            .join(p.read("dim1").filter(c("g1") < 7), c("k1") == c("d1"))
            .join(p.read("dim2").filter(c("g2") != 2), c("k2") == c("d2"))
            .with_column("rev", c("p") * c("v"))
            .group_by("g1", "g2").agg(r=("rev", "sum"), n=("*", "count"))
        )

    check_star(twin, q, monkeypatch, float_cols=("r",))


def test_a_nullable_group_key_keeps_its_groups_in_one_chunk(tmp_path, monkeypatch):
    """A filtered fact (its table states no row identity, so the pair memo
    keys on the table) and a dimension group key with nulls (no direct
    cells: the record-merge carry). A null hashes as its fill value 0, so
    null and 0 rows interleave in a chunk's key64 sort and its partial
    repeats those keys. The JAX package keeps a lone partial as it is and
    splits the groups (1441 rows here, against 6); the port merges even a
    lone partial by records and equals the disabled query (ROADMAP.md
    Queue 3). Over several chunks both packages merge and agree."""
    fact, dims = _star2(seed=24)
    g2 = dims[1][1]["g2"].astype(object)
    g2[::4] = None
    dims[1][1]["g2"] = g2
    twin = make_star(tmp_path, fact, dims)

    def q(p):
        c = p.col
        return (
            p.read("fact").filter(c("v") > 10).join(p.read("dim1"), c("k1") == c("d1"))
            .join(p.read("dim2"), c("k2") == c("d2")).group_by("g2").agg(t=("v", "sum"), n=("*", "count"))
        )

    tplan, jplan = twin.both(lambda p: _plan(p, q))
    assert tplan == jplan and "MultiwayJoin" in tplan
    star, jax_star = twin.both(lambda p: q(p).collect().rows())
    assert last_join_stages()["join_mode"] == "star" and last_join_stages()["direct_cells"] is False
    twin.t.off(twin.t.s)
    oracle = q(twin.t).collect().rows()
    twin.t.on(twin.t.s)
    assert sorted(star, key=str) == sorted(oracle, key=str) and len(star) == 6
    assert len(jax_star) == 1441 and len({r[0] for r in jax_star}) == 6  # the reference's split groups

    monkeypatch.setenv("HYPERSPACE_JOIN_CHUNK_ROWS", "2000")
    _clear()
    chunked = twin.same(q).rows()
    assert last_join_stages()["chunks"] > 1
    assert sorted(chunked, key=str) == sorted(oracle, key=str)


def test_a_float_sum_without_the_hint_runs_the_cascade(tmp_path, monkeypatch):
    """A float sum beside a max has no direct-cells hint: the star stream
    declines in both packages and the cascade answers (`_star_float_fold_free`)."""
    fact, dims = _star2(seed=25)
    fact["p"] = np.random.RandomState(25).rand(len(fact["v"])) * 100
    twin = make_star(tmp_path, fact, dims)
    monkeypatch.setenv("HYPERSPACE_QUERY_STREAMING", "1")
    before = twin.both(_last)
    for p in (twin.t, twin.j):
        assert len(_stars(p, _q2(agg_col="p")(p))) == 1
    twin.same(_q2(agg_col="p"))
    assert twin.both(_last) == before


def test_an_empty_dimension_falls_back_to_the_cascade(tmp_path, monkeypatch):
    """A dimension filtered to nothing: the stream declines, the cascade
    gives the empty result in both packages."""
    fact, dims = _star2(seed=26, n=2000)
    twin = make_star(tmp_path, fact, dims)
    monkeypatch.setenv("HYPERSPACE_QUERY_STREAMING", "1")
    before = twin.both(_last)

    def q(p):
        c = p.col
        return (
            p.read("fact").join(p.read("dim1").filter(c("g1") > 100), c("k1") == c("d1"))
            .join(p.read("dim2"), c("k2") == c("d2")).group_by("g1").agg(t=("v", "sum"))
        )

    for p in (twin.t, twin.j):
        assert len(_stars(p, q(p))) == 1
    assert twin.same(q).num_rows == 0
    assert twin.both(_last) == before


# -- TestStarFlagAmbients ---------------------------------------------------------


@pytest.mark.parametrize(
    "ambient",
    [
        {"HYPERSPACE_ENCODED_DEVICE": "0"},
        {"HYPERSPACE_ENCODED_DEVICE": "1"},
        {"HYPERSPACE_ENCODED_DEVICE": "1", "HYPERSPACE_PACKED_CODES": "1"},
    ],
    ids=["encoded-off", "encoded-on", "encoded+packed"],
)
def test_encoded_packed_states(tmp_path, monkeypatch, ambient):
    for k, v in ambient.items():
        monkeypatch.setenv(k, v)
    rng = np.random.RandomState(21)
    n = 3000
    fact = {"k1": np.array([f"c-{i:02d}" for i in rng.randint(0, 40, n)], dtype=object),
            "k2": rng.randint(0, 16, n).astype(np.int64), "v": rng.randint(0, 50, n).astype(np.int64)}
    dims = [
        ("dim1", {"d1": np.array([f"c-{i:02d}" for i in range(40)], dtype=object),
                  "g1": np.array([f"grp-{i % 5}" for i in range(40)], dtype=object)}),
        ("dim2", {"d2": np.arange(16, dtype=np.int64), "g2": rng.randint(0, 4, 16).astype(np.int64)}),
    ]
    check_star(make_star(tmp_path, fact, dims), _q2(), monkeypatch)


# -- TestStarShapeNegatives -------------------------------------------------------


def _small(tmp_path):
    fact, dims = _star2(seed=14, n=2000, hot=False)
    return make_star(tmp_path, fact, dims)


def _no_star_in_either(twin, q):
    for p in (twin.t, twin.j):
        assert not _stars(p, q(p))
    tplan, jplan = twin.both(lambda p: p.plan(q(p)))
    assert tplan == jplan


def test_single_join_is_not_a_star(tmp_path):
    twin = _small(tmp_path)
    _no_star_in_either(twin, lambda p: p.read("fact").join(p.read("dim1"), p.col("k1") == p.col("d1"))
                       .group_by("g1").agg(t=("v", "sum")))


def test_outer_join_is_not_a_star(tmp_path):
    twin = _small(tmp_path)

    def q(p):
        c = p.col
        return (p.read("fact").join(p.read("dim1"), c("k1") == c("d1"), how="left")
                .join(p.read("dim2"), c("k2") == c("d2")).group_by("g1").agg(t=("v", "sum")))

    _no_star_in_either(twin, q)
    twin.same(q)


def test_a_shared_key_name_is_not_a_star(tmp_path):
    """A fact key named in another dimension would resolve otherwise in the
    cascade: no star."""
    rng = np.random.RandomState(15)
    n = 2000
    fact = {"k1": rng.randint(0, 50, n).astype(np.int64), "k2": rng.randint(0, 20, n).astype(np.int64),
            "v": rng.randint(0, 100, n).astype(np.int64)}
    dims = [("dim1", {"d1": np.arange(50, dtype=np.int64), "g1": rng.randint(0, 9, 50).astype(np.int64)}),
            ("dim2", {"d2": np.arange(20, dtype=np.int64), "k1": rng.randint(0, 9, 20).astype(np.int64)})]
    twin = make_star(tmp_path, fact, dims)
    _no_star_in_either(twin, lambda p: p.read("fact").join(p.read("dim1"), p.col("k1") == p.col("d1"))
                       .join(p.read("dim2"), p.col("k2") == p.col("d2")).group_by("g1").agg(t=("v", "sum")))


def test_env_zero_never_plans_star(tmp_path, monkeypatch):
    twin = _small(tmp_path)
    monkeypatch.setenv("HYPERSPACE_MULTIWAY", "0")
    _no_star_in_either(twin, _q2())


def test_size_classes_off_runs_the_cascade(tmp_path, monkeypatch):
    """`HYPERSPACE_JOIN_SIZE_CLASSES=0` closes the star stream's gate: the
    star is planned and its cascade answers."""
    twin = _small(tmp_path)
    monkeypatch.setenv("HYPERSPACE_JOIN_SIZE_CLASSES", "0")
    before = last_join_stages()
    for p in (twin.t, twin.j):
        assert len(_stars(p, _q2()(p))) == 1
    twin.same(_q2())
    assert last_join_stages() == before


def test_non_aggregate_star_rides_the_cascade(tmp_path, monkeypatch):
    """A star-shaped plain join plans the wrapper and runs its cascade."""
    twin = _small(tmp_path)

    def q(p):
        c = p.col
        return (p.read("fact").join(p.read("dim1"), c("k1") == c("d1")).join(p.read("dim2"), c("k2") == c("d2"))
                .select("v", "g1", "g2"))

    for p in (twin.t, twin.j):
        assert len(_stars(p, q(p))) == 1
    rows = twin.same(q).sorted_rows()
    cnt = q(twin.t).count()
    assert cnt == q(twin.j).count() == len(rows)
    monkeypatch.setenv("HYPERSPACE_MULTIWAY", "0")
    _clear()
    assert q(twin.t).collect().sorted_rows() == rows
    assert q(twin.t).count() == cnt


# -- Explain ------------------------------------------------------------------------


def test_explain_shows_the_multiway_join_as_the_jax_package(tmp_path):
    twin = _small(tmp_path)
    texts = []
    for p in (twin.t, twin.j):
        out = []
        p.hs.explain(_q2()(p), verbose=True, redirect=out.append)
        texts.append(out[0].replace(p.idx, "<indexes>"))
    assert texts[0] == texts[1]
    assert "MultiwayJoin (2 dims: star_dim1, star_dim2)" in texts[0]
    assert _q2()(twin.t).explain_string().replace(twin.t.idx, "") == _q2()(twin.j).explain_string().replace(
        twin.j.idx, "")


# -- Hybrid Scan ------------------------------------------------------------------


def test_hybrid_scan_dimension_with_appended_and_deleted_files(tmp_path, monkeypatch):
    """A dimension whose source gained a file carries it as a HybridAppend
    (its rows merged into the index's buckets), and one that lost a file the
    lineage prune filter: the star still plans, streams and answers as the
    JAX package and the disabled query do."""
    rng = np.random.RandomState(23)
    n = 6000
    fact = {"k1": rng.randint(0, 240, n).astype(np.int64), "k2": rng.randint(0, 50, n).astype(np.int64),
            "v": rng.randint(0, 100, n).astype(np.int64)}
    dim1 = {"d1": np.arange(200, dtype=np.int64), "g1": rng.randint(0, 10, 200).astype(np.int64)}
    dim2 = {"d2": np.arange(50, dtype=np.int64), "g2": rng.randint(0, 5, 50).astype(np.int64)}
    twin = make_star(tmp_path, fact, [("dim1", dim1), ("dim2", dim2)], dim_parts=2,
                     INDEX_HYBRID_SCAN_ENABLED="true", INDEX_LINEAGE_ENABLED="true")
    twin.write("dim1", {"d1": np.arange(200, 240, dtype=np.int64), "g1": rng.randint(0, 10, 40).astype(np.int64)},
               "part-00002.parquet")
    os.remove(os.path.join(twin.base, "dim2", "part-00000.parquet"))

    def q(p):
        c = p.col
        return (p.read("fact").join(p.read("dim1"), c("k1") == c("d1")).join(p.read("dim2"), c("k2") == c("d2"))
                .group_by("g1").agg(t=("v", "sum"), c=("*", "count")))

    plan = twin.t.plan(q(twin.t))
    assert "(+1 appended)" in plan and "_data_file_name" in plan
    check_star(twin, q, monkeypatch)


# -- TestStarFaultsAndMemos -------------------------------------------------------


def test_mid_stream_fault_leaves_no_partial_memo(tmp_path, monkeypatch):
    """A fault between star chunks (here the aggregator's second fold)
    fails the query cleanly and leaves no ("star", ...) pair memo; the retry
    equals the cascade."""
    monkeypatch.setenv("HYPERSPACE_JOIN_CHUNK_ROWS", "2000")
    fact, dims = _star2(seed=17)
    twin = make_star(tmp_path, fact, dims)
    monkeypatch.setenv("HYPERSPACE_QUERY_STREAMING", "1")
    real = StreamAggregator.add_chunk
    calls = []

    def boom(self, t):
        calls.append(1)
        if len(calls) >= 2:
            raise RuntimeError("injected star fault")
        return real(self, t)

    monkeypatch.setattr(StreamAggregator, "add_chunk", boom)
    with pytest.raises(RuntimeError, match="injected"):
        _q2()(twin.t).collect()
    assert len(calls) >= 2
    assert not [k for k in physical._pairs_cache if "star" in k]
    assert len(physical._pairs_cache) == 0
    monkeypatch.setattr(StreamAggregator, "add_chunk", real)
    streamed = _q2()(twin.t).collect().rows()
    assert last_join_stages()["join_mode"] == "star"
    assert streamed == _q2()(twin.j).collect().rows()
    monkeypatch.setenv("HYPERSPACE_MULTIWAY", "0")
    _clear()
    assert _q2()(twin.t).collect().rows() == streamed


def test_warm_star_hits_per_dimension_memos(tmp_path, monkeypatch):
    """A multi-file fact keeps its concatenation's identity, so the second
    star query serves every dimension from the verified-pairs memo."""
    fact, dims = _star2(seed=19)
    twin = make_star(tmp_path, fact, dims, fact_parts=2)
    monkeypatch.setenv("HYPERSPACE_QUERY_STREAMING", "1")
    cold = twin.same(_q2()).rows()
    ts, js = twin.both(_last)
    assert [d["memo"] for d in ts["star_dims"]] == ["miss", "miss"] == [d["memo"] for d in js["star_dims"]]
    assert len(physical._pairs_cache) == 2
    warm = twin.same(_q2()).rows()
    ts, js = twin.both(_last)
    assert [d["memo"] for d in ts["star_dims"]] == ["hit", "hit"] == [d["memo"] for d in js["star_dims"]]
    assert warm == cold


def test_nan_float_group_keys_stream_no_phantom_groups(tmp_path, monkeypatch):
    """ROADMAP Queue 3's star probe: a fact of 600 rows in 2 files grouped by
    its float column `f` (drawn from [NaN, 1.5, 2.0] by `RandomState(5)`,
    NaN at each file's first row), joined to two indexed int dimensions, at
    default flags. The port's star stream equals both packages' answers with
    streaming off and the disabled query. The JAX package's star stream
    pads its chunk by repeating the first row, and a NaN first key makes
    each pad row a phantom group of count 0; the port folds real rows only."""
    rng = np.random.RandomState(5)
    f = rng.choice(np.array([np.nan, 1.5, 2.0]), 600)
    f[0] = f[300] = np.nan
    fact = {"k1": rng.randint(0, 20, 600).astype(np.int64), "k2": rng.randint(0, 10, 600).astype(np.int64),
            "f": f, "v": rng.randint(0, 100, 600).astype(np.int64)}
    dims = [("dim1", {"d1": np.arange(20, dtype=np.int64), "g1": np.arange(20, dtype=np.int64) % 3}),
            ("dim2", {"d2": np.arange(10, dtype=np.int64), "g2": np.arange(10, dtype=np.int64) % 2})]
    twin = make_star(tmp_path, fact, dims)

    def q(p):
        c = p.col
        return (p.read("fact").join(p.read("dim1"), c("k1") == c("d1")).join(p.read("dim2"), c("k2") == c("d2"))
                .group_by("f").agg(c=("*", "count"), s=("v", "sum")))

    assert len(_stars(twin.t, q(twin.t))) == len(_stars(twin.j, q(twin.j))) == 1
    streamed, jax_streamed = twin.both(lambda p: q(p).collect().rows())
    assert last_join_stages()["join_mode"] == "star"
    def reprs(rows):  # a NaN key never equals another NaN in a list
        return sorted(repr(tuple(x.item() if hasattr(x, "item") else x for x in r)) for r in rows)

    monkeypatch.setenv("HYPERSPACE_QUERY_STREAMING", "0")
    _clear()
    one_pass, jax_one_pass = twin.both(lambda p: q(p).collect().rows())
    monkeypatch.delenv("HYPERSPACE_QUERY_STREAMING")
    twin.t.off(twin.t.s)
    disabled = q(twin.t).collect().rows()
    assert reprs(streamed) == reprs(one_pass) == reprs(jax_one_pass) == reprs(disabled)
    assert len(streamed) == int(np.isnan(f).sum()) + 2 and all(r[1] > 0 for r in streamed)
    phantoms = [r for r in jax_streamed if r[1] == 0]
    assert phantoms and reprs(r for r in jax_streamed if r[1] > 0) == reprs(streamed)

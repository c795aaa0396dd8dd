"""Data-skipping indexes in the port against the JAX package, on the same lakes.

Each test drives both packages over ONE source directory, each with its own
index warehouse (`Twin` of `test_torch_refresh.py`): MinMax (file and
row-group granularity) and bloom sketches are built, and filters run with
Hyperspace on in both. They must agree on

- the sketch file (sha256) and the latest log entry (normalized as in
  `Twin.assert_same`);
- the scan's kept files and its `pruned_by`;
- the rows, in the same order, and `count()`, which also equal the query's
  with Hyperspace disabled.

The shapes are `tests/test_extensions.py`'s `TestDataSkipping` :110-211 and
`test_data_skipping_survives_deleted_file` :460, and
`tests/test_dataskip_mutations.py` over its 3 seeds. Then the cases where the
JAX package's sketch is unsound, held against the non-indexed query alone: a
float column with a NaN, whose JAX sketch prunes the file holding the match,
and a string MinMax, which the JAX package refuses at `create_index`. Nothing
is computed on the rows, so the tolerance is 0.
"""

import os

import numpy as np
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu_torch as hst
from hyperspace_tpu import IndexConstants as JaxIndexConstants
from hyperspace_tpu.engine import col as jax_col
from hyperspace_tpu.hyperspace import disable_hyperspace as jax_disable
from hyperspace_tpu.hyperspace import enable_hyperspace as jax_enable
from hyperspace_tpu.index import dataskipping as jax_ds
from hyperspace_tpu.index import quarantine as jax_quarantine
from hyperspace_tpu_torch.engine import physical, scan_cache
from hyperspace_tpu_torch.index import dataskipping as torch_ds
from hyperspace_tpu_torch.index import quarantine

from test_torch_refresh import Twin, _host, write


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    quarantine.clear()
    jax_quarantine.clear()
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()
    yield
    quarantine.clear()
    jax_quarantine.clear()
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()


def sketches(mod, spec):
    """One package's sketch objects of `spec`: ("minmax", col[, granularity])
    or ("bloom", col, num_bits, num_hashes)."""
    out = []
    for s in spec:
        if s[0] == "minmax":
            out.append(mod.MinMaxSketch(*s[1:]))
        else:
            out.append(mod.BloomFilterSketch(*s[1:]))
    return out


class DsTwin(Twin):
    """`Twin` with data-skipping indexes, over parquet or delta sources."""

    def __init__(self, base, fmt="parquet", lineage=False):
        super().__init__(base, num_buckets=2, lineage=lineage)
        self.fmt = fmt

    def read(self, pkg, path):
        s = self.t if pkg == "torch" else self.j
        return getattr(s.read, self.fmt)(path)

    def create_ds(self, src, name, spec):
        self.th.create_index(self.read("torch", src), torch_ds.DataSkippingIndexConfig(name, sketches(torch_ds, spec)))
        self.jh.create_index(self.read("jax", src), jax_ds.DataSkippingIndexConfig(name, sketches(jax_ds, spec)))

    def hybrid(self, on=True):
        self.t.conf.set(hst.IndexConstants.INDEX_HYBRID_SCAN_ENABLED, "true" if on else "false")
        self.j.conf.set(JaxIndexConstants.INDEX_HYBRID_SCAN_ENABLED, "true" if on else "false")

    def check(self, src, build, files=None, pruned_by=None):
        """Both packages' `build(df, col)` over the source: the same kept
        files (`files` of them when given) and `pruned_by`, the same rows in
        order and counts, equal to the port's disabled query. Returns the
        port's rows."""
        tq, jq = build(self.read("torch", src), hst.col), build(self.read("jax", src), jax_col)
        t_scan, j_scan = scan_of(tq), scan_of(jq)
        assert [f.path for f in t_scan.files] == [f.path for f in j_scan.files]
        assert t_scan.pruned_by == j_scan.pruned_by
        if files is not None:
            assert len(t_scan.files) == files
        if pruned_by is not None:
            assert t_scan.pruned_by == pruned_by
        got, want = _host(tq.collect()), _host(jq.collect())
        assert got == want
        assert tq.count() == jq.count() == len(next(iter(want.values())))
        assert got == self.disabled(src, build)
        return got

    def disabled(self, src, build):
        """The port's rows with Hyperspace off (the oracle)."""
        hst.disable_hyperspace(self.t)
        try:
            return _host(build(self.read("torch", src), hst.col).collect())
        finally:
            hst.enable_hyperspace(self.t)


def scan_of(df):
    """The source relation of the optimized plan's one scan."""
    scans = [n for n in df.optimized_plan().collect_nodes() if type(n).__name__ == "ScanNode"]
    assert len(scans) == 1
    return scans[0].relation


def _three_files(tmp_path):
    """TestDataSkipping's source: three files of disjoint k ranges."""
    src = str(tmp_path / "ds")
    for i, word in enumerate(["alpha", "beta", "gamma"]):
        write(src, f"f{i}.parquet", {"k": np.arange(i * 100, i * 100 + 100), "c3": np.array([word] * 100)})
    return src


def test_minmax_prunes_files(tmp_path):
    src, tw = _three_files(tmp_path), DsTwin(tmp_path)
    tw.create_ds(src, "mmIdx", [("minmax", "k")])
    tw.assert_same("mmIdx")
    got = tw.check(src, lambda d, c: d.filter(c("k") == 150).select("k", "c3"), files=1, pruned_by=["mmIdx"])
    assert got == {"k": [150], "c3": ["beta"]}
    got = tw.check(src, lambda d, c: d.filter(c("k") >= 250).select("c3"), files=1)
    assert set(got["c3"]) == {"gamma"}
    for build in (
        lambda d, c: d.filter(c("k") < 100).select("k"),
        lambda d, c: d.filter((c("k") > 120) & (c("k") <= 130)).select("k"),
        lambda d, c: d.filter(c("k").isin(5, 250)).select("k"),  # MinMax takes no IN: nothing pruned
        lambda d, c: d.filter(c("k") == 5000).select("k"),
    ):
        tw.check(src, build)


def test_bloom_prunes_files(tmp_path):
    src, tw = _three_files(tmp_path), DsTwin(tmp_path)
    tw.create_ds(src, "bfIdx", [("bloom", "c3", 256, 4)])
    tw.assert_same("bfIdx")
    got = tw.check(src, lambda d, c: d.filter(c("c3") == "beta").select("k"), files=1, pruned_by=["bfIdx"])
    assert len(got["k"]) == 100
    tw.check(src, lambda d, c: d.filter(c("c3") == "nope").select("k"), files=0)
    tw.check(src, lambda d, c: d.filter(c("c3").isin("alpha", "gamma", "nope")).select("k"), files=2)
    tw.check(src, lambda d, c: d.filter(c("c3") == 7).select("k"), files=3)  # a type mismatch keeps


def test_bloom_probe_int_float_literals(tmp_path):
    """A float literal equal to an int column entry must not prune its file;
    a literal no int equals (5.5) keeps as the JAX package keeps it."""
    src = str(tmp_path / "bf2")
    write(src, "f0.parquet", {"k": np.array([5, 6])})
    write(src, "f1.parquet", {"k": np.array([7, 8])})
    tw = DsTwin(tmp_path)
    tw.create_ds(src, "bfT", [("bloom", "k", 128, 4)])
    tw.assert_same("bfT")
    assert tw.check(src, lambda d, c: d.filter(c("k") == 5.0).select("k"), files=1) == {"k": [5]}
    tw.check(src, lambda d, c: d.filter(c("k") == 5.5).select("k"))
    tw.check(src, lambda d, c: d.filter(c("k").isin(6, 8.0)).select("k"), files=2)
    tw.check(src, lambda d, c: d.filter(c("k").isin(2**40, 99)).select("k"))


def test_skipping_index_stale_after_change(tmp_path):
    src, tw = _three_files(tmp_path), DsTwin(tmp_path)
    tw.create_ds(src, "stIdx", [("minmax", "k")])
    write(src, "f3.parquet", {"k": np.array([5000]), "c3": np.array(["delta"])})
    q = lambda d, c: d.filter(c("k") == 5000).select("c3")  # noqa: E731
    assert tw.check(src, q, files=4, pruned_by=[]) == {"c3": ["delta"]}  # stale: no pruning
    tw.hybrid()
    assert tw.check(src, q, files=1, pruned_by=["stIdx"]) == {"c3": ["delta"]}  # the appended file kept


@pytest.mark.parametrize("mode", ["full", "incremental", "auto"])
def test_refresh_data_skipping_index(tmp_path, mode):
    src, tw = _three_files(tmp_path), DsTwin(tmp_path)
    tw.create_ds(src, "rfIdx", [("minmax", "k"), ("bloom", "c3", 512, 3)])
    tw.check(src, lambda d, c: d.filter(c("k") == 400).select("c3"), files=0)
    write(src, "f3.parquet", {"k": np.array([400]), "c3": np.array(["delta"])})
    assert tw.refresh("rfIdx", mode) is None
    tw.assert_same("rfIdx")
    assert tw.check(src, lambda d, c: d.filter(c("k") == 400).select("c3"), files=1) == {"c3": ["delta"]}
    tw.check(src, lambda d, c: d.filter(c("c3") == "delta").select("k"), files=1)
    # A stale sketch never prunes a file appended after the refresh.
    write(src, "f4.parquet", {"k": np.array([150]), "c3": np.array(["beta"])})
    tw.hybrid()
    assert tw.check(src, lambda d, c: d.filter(c("k") == 150).select("k"), files=2) == {"k": [150, 150]}


def test_data_skipping_survives_deleted_file(tmp_path):
    """Sketches are per source file: deleting one keeps the index usable
    WITHOUT lineage under Hybrid Scan; the survivors still prune."""
    d = str(tmp_path / "ds")
    for i in range(4):
        write(d, f"part-{i}.parquet", {"ts": np.arange(i * 100, i * 100 + 100), "val": np.arange(100)})
    tw = DsTwin(tmp_path)
    tw.create_ds(d, "dsd", [("minmax", "ts")])
    os.remove(os.path.join(d, "part-3.parquet"))
    tw.hybrid()
    q = lambda df, c: df.filter(c("ts") == 150).select("val")  # noqa: E731
    assert "pruned by dsd" in q(tw.read("torch", d), hst.col).explain_string()
    assert tw.check(d, q, files=1, pruned_by=["dsd"]) == {"val": [50]}
    tw.hybrid(False)
    assert tw.check(d, q, files=3, pruned_by=[]) == {"val": [50]}  # the signature no longer matches


@pytest.mark.parametrize("seed", range(3))
def test_dataskip_mutation_differential(tmp_path, seed):
    """`tests/test_dataskip_mutations.py`: random layouts and cut points,
    a delete (no lineage, no Hybrid Scan: the index sits out) and an append."""
    rng = np.random.RandomState(3000 + seed)
    d = str(tmp_path / "T")
    nf = int(rng.randint(4, 10))
    for i in range(nf):
        n = int(rng.randint(50, 300))
        write(d, f"part-{i}.parquet", {"x": rng.randint(i * 100, i * 100 + 100, n).astype(np.int64),
                                       "v": rng.randint(0, 1000, n).astype(np.int64)})
    tw = DsTwin(tmp_path)
    tw.create_ds(d, f"sk{seed}", [("minmax", "x")])
    tw.assert_same(f"sk{seed}")

    def check():
        cut = int(rng.randint(0, nf * 100))
        tw.check(d, lambda df, c: df.filter(c("x") < cut))

    check()
    check()
    files = sorted(p for p in os.listdir(d) if p.endswith(".parquet"))
    os.remove(os.path.join(d, files[int(rng.randint(len(files)))]))
    check()
    write(d, "appended.parquet", {"x": rng.randint(0, nf * 100, 80).astype(np.int64),
                                  "v": rng.randint(0, 1000, 80).astype(np.int64)})
    check()
    check()


def test_rowgroup_zones_prune_a_straddling_file(tmp_path):
    """A file whose range straddles the literal, but no row group of it does:
    the row-group MinMax prunes it, the file-level one cannot."""
    src = str(tmp_path / "rg")
    os.makedirs(src)
    for i, keys in enumerate([np.r_[0:100, 200:300], np.r_[100:200, 300:400]]):
        tmp = os.path.join(src, f"f{i}.tmp")
        hst.HyperspaceSession(warehouse=str(tmp_path), device="cpu").write_parquet(
            {"k": keys.astype(np.int64), "v": keys * 2}, tmp, row_group_rows=100)
        os.replace(os.path.join(tmp, "part-00000.parquet"), os.path.join(src, f"f{i}.parquet"))
        os.rmdir(tmp)
    assert pq.ParquetFile(os.path.join(src, "f0.parquet")).metadata.num_row_groups == 2
    tw = DsTwin(tmp_path)
    tw.create_ds(src, "rgIdx", [("minmax", "k", "rowgroup")])
    tw.create_ds(src, "fileIdx", [("minmax", "v")])
    tw.assert_same("rgIdx")
    tw.assert_same("fileIdx")
    got = tw.check(src, lambda d, c: d.filter(c("k") == 150).select("k", "v"), files=1, pruned_by=["rgIdx"])
    assert got == {"k": [150], "v": [300]}
    tw.check(src, lambda d, c: d.filter(c("v") == 300).select("k"), files=2, pruned_by=[])
    # Each conjunct is decided alone: every zone of f0 keeps one of them.
    tw.check(src, lambda d, c: d.filter((c("k") > 120) & (c("k") < 180)).select("k"), files=2)
    tw.check(src, lambda d, c: d.filter(c("k") >= 399).select("k"), files=1)


def test_nullable_int_sketch_equals_the_jax_bytes(tmp_path):
    """A nullable int column's fill 0 enters the min in both packages (loose,
    never wrong); nulls hash their fill into the bloom."""
    src = str(tmp_path / "n")
    write(src, "f0.parquet", {"x": np.array([None, 7], dtype=object)})
    write(src, "f1.parquet", {"x": np.array([3, 4])})
    tw = DsTwin(tmp_path)
    tw.create_ds(src, "nIdx", [("minmax", "x"), ("bloom", "x", 64, 3)])
    tw.assert_same("nIdx")
    t = pq.read_table(_sketch_file(tw, "torch", "nIdx"))
    assert t.column("min_x").to_pylist() == [0, 3]
    tw.check(src, lambda d, c: d.filter(c("x") == 7).select("x"), files=1)
    tw.check(src, lambda d, c: d.filter(c("x") == 0).select("x"))


def _sketch_file(tw, pkg, name):
    files = []
    for root, _, names in os.walk(os.path.join(tw.root(pkg), name)):
        files += [os.path.join(root, n) for n in names if n.endswith(".parquet")]
    assert len(files) == 1
    return files[0]


def _keeps_as_disabled(tw, src, build, files):
    """The port's scan keeps `files` files and its rows and count equal the
    disabled query's (the oracle where the JAX package's sketch is unsound)."""
    q = build(tw.read("torch", src), hst.col)
    assert len(scan_of(q).files) == files
    want = tw.disabled(src, build)
    assert _host(q.collect()) == want
    assert q.count() == len(next(iter(want.values())))


def test_float_nan_never_prunes_a_matching_file(tmp_path):
    """The JAX package's MinMax over [5.0, NaN] records NaN bounds, and
    `x == 5.0` then prunes the file that holds the match (0 rows indexed, 1
    disabled). The port's bounds leave NaN out; an all-NaN file and a NaN
    literal always keep."""
    src = str(tmp_path / "f")
    write(src, "f0.parquet", {"x": np.array([5.0, np.nan])})
    write(src, "f1.parquet", {"x": np.array([100.0, 101.0])})
    write(src, "f2.parquet", {"x": np.array([np.nan, np.nan])})
    tw = DsTwin(tmp_path)
    tw.create_ds(src, "nanIdx", [("minmax", "x")])
    t = pq.read_table(_sketch_file(tw, "torch", "nanIdx")).to_pydict()
    assert t["min_x"][:2] == [5.0, 100.0] and np.isnan(t["min_x"][2]) and np.isnan(t["max_x"][2])
    _keeps_as_disabled(tw, src, lambda d, c: d.filter(c("x") == 5.0).select("x"), files=2)
    _keeps_as_disabled(tw, src, lambda d, c: d.filter(c("x") > 100.5).select("x"), files=2)
    _keeps_as_disabled(tw, src, lambda d, c: d.filter(c("x") == float("nan")).select("x"), files=3)
    # The JAX package's fault, as found: its indexed query loses the row.
    jq = tw.read("jax", src).filter(jax_col("x") == 5.0).select("x")
    assert jq.count() == 0
    jax_disable(tw.j)
    assert tw.read("jax", src).filter(jax_col("x") == 5.0).select("x").count() == 1
    jax_enable(tw.j)


def test_string_minmax_prunes_soundly(tmp_path):
    """The JAX package raises at `create_index` on a string MinMax; the port
    records the smallest and largest present value (nulls excluded, an
    all-null file null) and prunes as the non-indexed query allows."""
    src = str(tmp_path / "s")
    write(src, "f0.parquet", {"s": np.array(["apple", "banana", None], dtype=object), "v": np.arange(3)})
    write(src, "f1.parquet", {"s": np.array(["cherry", "date"]), "v": np.arange(2)})
    write(src, "f2.parquet", {"s": np.array([None, None], dtype=object), "v": np.arange(2)})
    tw = DsTwin(tmp_path)
    with pytest.raises(Exception, match="minimum"):
        tw.jh.create_index(tw.read("jax", src), jax_ds.DataSkippingIndexConfig("sIdx", [jax_ds.MinMaxSketch("s")]))
    tw.th.create_index(tw.read("torch", src), torch_ds.DataSkippingIndexConfig("sIdx", [torch_ds.MinMaxSketch("s")]))
    t = pq.read_table(_sketch_file(tw, "torch", "sIdx")).to_pydict()
    assert t["min_s"] == ["apple", "cherry", None] and t["max_s"] == ["banana", "date", None]
    _keeps_as_disabled(tw, src, lambda d, c: d.filter(c("s") == "banana").select("v"), files=2)
    _keeps_as_disabled(tw, src, lambda d, c: d.filter(c("s") > "c").select("s"), files=2)
    _keeps_as_disabled(tw, src, lambda d, c: d.filter(c("s") == "zebra").select("v"), files=1)


def test_lifecycle_and_listing_of_a_data_skipping_index(tmp_path):
    """delete, restore, vacuum and `indexes()` as the JAX package does them;
    optimize refuses with the JAX package's message."""
    src, tw = _three_files(tmp_path), DsTwin(tmp_path)
    tw.create_ds(src, "lcIdx", [("minmax", "k")])
    q = lambda d, c: d.filter(c("k") == 150).select("k")  # noqa: E731
    err = tw.both("optimize_index", "lcIdx")
    assert err is not None and "Optimize is only supported for CoveringIndex" in err[1]
    assert tw.both("delete_index", "lcIdx") is None
    tw.assert_same("lcIdx")
    tw.check(src, q, files=3, pruned_by=[])
    assert tw.both("restore_index", "lcIdx") is None
    tw.check(src, q, files=1, pruned_by=["lcIdx"])
    t_rows, j_rows = tw.th.indexes().to_numpy(), tw.jh.indexes().to_pydict()
    assert {k: list(v) for k, v in t_rows.items() if k != "indexLocation"} == {
        k: v for k, v in j_rows.items() if k != "indexLocation"}
    assert tw.both("delete_index", "lcIdx") is None
    assert tw.both("vacuum_index", "lcIdx") is None
    tw.assert_same("lcIdx")
    assert tw.th.indexes().num_rows == 0

"""Hive-partitioned sources in the port against the JAX package, on one lake.

Each case of `tests/test_partitioned.py` runs in both packages over the same
`root/key=value/.../file.parquet` lake (made with numpy from a seed), each
package with its own index warehouse (`PTwin`, after `test_torch_refresh.Twin`),
and the port must give the JAX package's schema (names and types), rows in
the same order and counts; a built index must have sha256-identical files
and a field-equal log entry. Then what only the port's layout must get
right: lineage index files over a lake with string, int and null
partitions; a compacted partitioned index against a from-scratch rebuild
(index version directories are themselves `v__=N` directories, which no
read of index files may take for a partition column); pushdown with a
partition-column conjunct; one package reading the other's lake. Nothing is
computed on the rows, so the tolerance is 0. The JAX package runs its
single-device serial build (`HYPERSPACE_DISTRIBUTED=0`,
`HYPERSPACE_BUILD_DECODE_THREADS=1`) and its device group order
(`HYPERSPACE_FORCE_DEVICE_OPS=1`).
"""

import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu_torch as hst
from hyperspace_tpu import HyperspaceException as JaxHyperspaceException
from hyperspace_tpu import IndexConfig as JaxIndexConfig
from hyperspace_tpu import IndexConstants as JaxIndexConstants
from hyperspace_tpu.engine import HyperspaceSession as JaxSession
from hyperspace_tpu.engine import col as jax_col
from hyperspace_tpu.index import dataskipping as jax_ds
from hyperspace_tpu.index import quarantine as jax_quarantine
from hyperspace_tpu_torch.engine import io as torch_io
from hyperspace_tpu_torch.engine.logical import ScanNode
from hyperspace_tpu_torch.index import dataskipping as torch_ds
from hyperspace_tpu_torch.index import quarantine
from test_torch_refresh import Twin, _content_files, _host, _sha


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    monkeypatch.setenv("HYPERSPACE_BUILD_DECODE_THREADS", "1")
    monkeypatch.setenv("HYPERSPACE_FORCE_DEVICE_OPS", "1")
    quarantine.clear()
    jax_quarantine.clear()
    yield
    quarantine.clear()
    jax_quarantine.clear()


class PTwin(Twin):
    """`Twin` over a source of any format (`fmt`), four buckets."""

    def __init__(self, base, fmt="parquet", lineage=False, num_buckets=4):
        super().__init__(base, num_buckets=num_buckets, lineage=lineage)
        self.fmt = fmt

    def read(self, pkg, path):
        return getattr((self.t if pkg == "torch" else self.j).read, self.fmt)(path)

    def create(self, src, name, indexed, included):
        self.th.create_index(self.read("torch", src), hst.IndexConfig(name, indexed, included))
        self.jh.create_index(self.read("jax", src), JaxIndexConfig(name, indexed, included))

    def hybrid(self, on=True):
        self.t.conf.set(hst.IndexConstants.INDEX_HYBRID_SCAN_ENABLED, "true" if on else "false")
        self.j.conf.set(JaxIndexConstants.INDEX_HYBRID_SCAN_ENABLED, "true" if on else "false")

    def query(self, build, index=None, src=None):
        """Both packages' rows of `build(read, col)`: the same schema (names
        and types), the same rows in order and `count()`; the port's plan
        scans `index` when one is named. Returns the port's rows."""
        tq = build(lambda p: self.read("torch", p), hst.col)
        jq = build(lambda p: self.read("jax", p), jax_col)
        if index is not None:
            assert f"index={index}" in tq.explain_string(), tq.explain_string()
        assert [(f.name, f.dtype) for f in tq.schema.fields] == [(f.name, f.dtype) for f in jq.schema.fields]
        got, want = _host(tq.collect()), _host(jq.collect())
        assert got == want
        assert tq.count() == jq.count() == len(next(iter(want.values())))
        return got

    def disabled(self, build):
        """The port's rows with Hyperspace off."""
        hst.disable_hyperspace(self.t)
        try:
            return _host(build(lambda p: self.read("torch", p), hst.col).collect())
        finally:
            hst.enable_hyperspace(self.t)


def write_file(path, table):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pq.write_table(pa.table(table), path)


def events(base, seed=5):
    """`test_partitioned.py`'s lake: year × country, 50 rows a file."""
    rng = np.random.RandomState(seed)
    root = os.path.join(str(base), "events")
    for year in (2023, 2024):
        for country in ("us", "de"):
            write_file(os.path.join(root, f"year={year}", f"country={country}", "part-00000.parquet"), {
                "uid": rng.randint(0, 40, 50).astype(np.int64),
                "value": rng.randint(0, 1000, 50).astype(np.int64),
            })
    return root


def mixed(base, seed=11, empty=False):
    """A lake with an int partition holding a null, a string partition
    holding a null and a URL-quoted value, files of unequal sizes (one of
    them empty with `empty`), a string payload with nulls and several files
    a partition."""
    rng = np.random.RandomState(seed)
    root = os.path.join(str(base), "mixed")
    layout = [("7", "a%2Fb"), ("7", "zz"), ("12", "__HIVE_DEFAULT_PARTITION__"),
              ("__HIVE_DEFAULT_PARTITION__", "zz"), ("3", "a%2Fb")]
    for i, (d, r) in enumerate(layout):
        for j in range(1 + i % 2):
            n = int(rng.randint(5, 40))
            n = 0 if empty and (i, j) == (2, 0) else n
            tag = rng.choice(np.array(["x", "y", "w"]), n).astype(object)
            tag[rng.rand(n) < 0.2] = None
            write_file(os.path.join(root, f"d={d}", f"region={r}", f"part-{j:05d}.parquet"), {
                "k": pa.array(rng.randint(0, 25, n).astype(np.int64)),
                "v": pa.array(rng.rand(n)),
                "tag": pa.array(list(tag), type=pa.string()),
            })
    return root


# ---------------------------------------------------------------------------
# The cases of tests/test_partitioned.py, each in both packages
# ---------------------------------------------------------------------------


def test_partition_columns_materialize(tmp_path):
    root, tw = events(tmp_path), PTwin(tmp_path)
    tw.query(lambda rd, c: rd(root))
    assert tw.read("torch", root).schema.names == ["uid", "value", "year", "country"]
    assert tw.query(lambda rd, c: rd(root).filter(c("year") == 2023))["year"] == [2023] * 100
    tw.query(lambda rd, c: rd(root).filter((c("country") == "us") & (c("year") == 2024)))
    got = tw.query(lambda rd, c: rd(root).group_by("country").agg(n=("*", "count")))
    assert sorted(zip(got["country"], got["n"])) == [("de", 100), ("us", 100)]


def test_partition_value_types_and_nulls(tmp_path):
    root = os.path.join(str(tmp_path), "t2")
    for seg, vals in (("k=12", [1]), ("k=__HIVE_DEFAULT_PARTITION__", [2]), ("k=7", [3])):
        write_file(os.path.join(root, seg, "f.parquet"), {"x": pa.array(vals, type=pa.int64())})
    tw = PTwin(tmp_path)
    got = tw.query(lambda rd, c: rd(root).select("x", "k"))
    assert sorted(zip(got["x"], got["k"])) == [(1, 12), (2, None), (3, 7)]
    assert tw.query(lambda rd, c: rd(root).filter(c("k").is_null()))["x"] == [2]
    assert tw.read("torch", root).schema.field("k").dtype == "int64"


def test_partition_clash_with_data_column_rejected(tmp_path):
    root = os.path.join(str(tmp_path), "t3")
    write_file(os.path.join(root, "x=1", "f.parquet"), {"x": pa.array([1], type=pa.int64())})
    tw = PTwin(tmp_path)
    with pytest.raises(hst.HyperspaceException, match="Partition column") as te:
        tw.read("torch", root)
    with pytest.raises(JaxHyperspaceException) as je:
        tw.read("jax", root)
    assert str(te.value) == str(je.value)


def test_filter_index_over_partitioned_source(tmp_path):
    root, tw = events(tmp_path), PTwin(tmp_path)
    tw.create(root, "pfIdx", ["country"], ["uid", "value", "year"])
    tw.assert_same("pfIdx")

    def q(rd, c):
        return rd(root).filter(c("country") == "de").select("uid", "value", "year")

    got = tw.query(q, index="pfIdx")
    assert len(got["uid"]) == 100 and got == tw.disabled(q)


def test_join_index_over_partitioned_source(tmp_path):
    root, tw = events(tmp_path), PTwin(tmp_path)
    users = os.path.join(str(tmp_path), "users")
    write_file(os.path.join(users, "part-00000.parquet"), {
        "userId": np.arange(40, dtype=np.int64), "name": np.array([f"u{i}" for i in range(40)]),
    })
    tw.create(root, "evIdx", ["uid"], ["value", "year"])
    tw.create(users, "uIdx", ["userId"], ["name"])
    tw.assert_same("evIdx")

    def q(rd, c):
        return rd(root).join(rd(users), c("uid") == c("userId")).select("name", "value", "year")

    tq = q(lambda p: tw.read("torch", p), hst.col)
    assert "bucketed, no exchange" in tq.explain_string()
    got = tw.query(q)
    assert len(got["name"]) == 200 and sorted(zip(*got.values())) == sorted(zip(*tw.disabled(q).values()))


def test_lineage_pulls_missing_partition_columns(tmp_path):
    root, tw = events(tmp_path), PTwin(tmp_path, lineage=True)
    tw.create(root, "linIdx", ["uid"], ["value"])
    entry = tw.assert_same("linIdx")
    f = os.path.join(tw.root("torch"), "linIdx", "v__=0", "part-00000.parquet")
    assert pq.read_schema(f).names == ["uid", "value", "year", "country", "_data_file_name"]
    schema = json.loads(entry["derivedDataset"]["properties"]["schemaJson"])
    assert [c["name"] for c in schema["fields"]] == ["uid", "value", "year", "country", "_data_file_name"]


def test_incremental_refresh_partitioned(tmp_path):
    root, tw = events(tmp_path), PTwin(tmp_path)
    tw.create(root, "incIdx", ["uid"], ["value", "country"])
    rng = np.random.RandomState(9)
    write_file(os.path.join(root, "year=2025", "country=fr", "part-00000.parquet"), {
        "uid": rng.randint(0, 40, 30).astype(np.int64), "value": rng.randint(0, 1000, 30).astype(np.int64),
    })
    assert tw.refresh("incIdx", "incremental") is None
    tw.assert_same("incIdx")

    def q(rd, c):
        return rd(root).filter(c("uid") == 3).select("uid", "value", "country")

    assert tw.query(q, index="incIdx") == tw.disabled(q)


def test_hybrid_scan_partitioned_append(tmp_path):
    root, tw = events(tmp_path), PTwin(tmp_path)
    tw.hybrid()
    tw.create(root, "hyIdx", ["country"], ["uid", "value", "year"])
    write_file(os.path.join(root, "year=2025", "country=us", "part-00000.parquet"), {
        "uid": pa.array([1, 2], type=pa.int64()), "value": pa.array([11, 22], type=pa.int64()),
    })

    def q(rd, c):
        return rd(root).filter(c("country") == "us").select("uid", "value", "year")

    got = tw.query(q, index="hyIdx")
    assert len(got["uid"]) == 102 and got["year"][-2:] == [2025, 2025]
    assert sorted(zip(*got.values())) == sorted(zip(*tw.disabled(q).values()))


def test_relative_path_read_discovers_partitions(tmp_path, monkeypatch):
    root, tw = events(tmp_path), PTwin(tmp_path)
    monkeypatch.chdir(str(tmp_path))
    rel = tw.query(lambda rd, c: rd("events"))
    assert rel == tw.query(lambda rd, c: rd(root))
    assert tw.read("torch", "events").plan.relation.root_paths == [root]


def test_dataskipping_sketch_on_partition_column(tmp_path):
    root, tw = events(tmp_path), PTwin(tmp_path)
    tw.th.create_index(tw.read("torch", root),
                       torch_ds.DataSkippingIndexConfig("dsYear", [torch_ds.MinMaxSketch("year")]))
    tw.jh.create_index(tw.read("jax", root), jax_ds.DataSkippingIndexConfig("dsYear", [jax_ds.MinMaxSketch("year")]))
    tw.assert_same("dsYear")

    def q(rd, c):
        return rd(root).filter(c("year") == 2023).select("uid", "value")

    tq = q(lambda p: tw.read("torch", p), hst.col)
    (scan,) = [n for n in tq.optimized_plan().collect_nodes() if isinstance(n, ScanNode)]
    assert len(scan.relation.files) == 2 and "files pruned by dsYear" in tq.explain_string()
    got = tw.query(q)
    assert len(got["uid"]) == 100 and got == tw.disabled(q)


def test_concat_cache_partition_aware(tmp_path):
    root, tw = events(tmp_path), PTwin(tmp_path)
    whole = tw.query(lambda rd, c: rd(root))
    sub = os.path.join(root, "year=2023")
    part = tw.query(lambda rd, c: rd(sub))
    assert list(part) == ["uid", "value", "country"] and len(part["uid"]) == 100
    assert tw.query(lambda rd, c: rd(root)) == whole


# ---------------------------------------------------------------------------
# What the port's own layout must get right
# ---------------------------------------------------------------------------


def test_a_lineage_index_over_null_and_string_partitions_equals_jax(tmp_path):
    root, tw = mixed(tmp_path), PTwin(tmp_path, lineage=True)
    tw.query(lambda rd, c: rd(root))
    tw.create(root, "mixIdx", ["k"], ["tag"])
    tw.assert_same("mixIdx")
    tw.create(root, "regIdx", ["region"], ["k"])
    tw.assert_same("regIdx")
    assert tw.query(lambda rd, c: rd(root).filter(c("region").is_null()).select("k", "d"))["d"] == [12] * len(
        tw.disabled(lambda rd, c: rd(root).filter(c("region").is_null()).select("k"))["k"])
    for cond in (lambda c: c("region") == "a/b", lambda c: c("d").is_null(), lambda c: c("k") == 4):
        def q(rd, c, cond=cond):
            return rd(root).filter(cond(c)).select("k", "tag", "d", "region")

        assert tw.query(q) == tw.disabled(q)


def test_only_partition_columns_read_one_file_column_for_the_row_count(tmp_path):
    root, tw = mixed(tmp_path), PTwin(tmp_path)
    got = tw.query(lambda rd, c: rd(root).select("region", "d"))
    assert len(got["d"]) == tw.read("torch", root).count()
    torch_io.reset_io_stats()
    from hyperspace_tpu_torch.engine import scan_cache

    scan_cache.clear_scan_caches()
    tw.read("torch", root).select("d").collect()
    cached = [k for k in scan_cache.global_scan_cache()._entries if k[-1][0] == "col"]
    assert {k[-1][1] for k in cached} == {"k"}


def test_a_partition_conjunct_never_prunes_a_row_group(tmp_path, monkeypatch):
    root, tw = mixed(tmp_path), PTwin(tmp_path)
    monkeypatch.setenv("HYPERSPACE_SCAN_PUSHDOWN", "1")
    for cond in (lambda c: c("d") == 7, lambda c: (c("d") >= 7) & (c("k") < 10), lambda c: c("region") == "zz"):
        def q(rd, c, cond=cond):
            return rd(root).filter(cond(c)).select("k", "d", "region")

        assert tw.query(q) == tw.disabled(q)


def test_a_compacted_partitioned_lineage_index_equals_a_rebuild(tmp_path):
    """Two versions (`v__=0`, `v__=1`) compacted into one: the files equal a
    from-scratch build's, byte for byte; no `v__` column appears."""
    root, tw = mixed(tmp_path), PTwin(tmp_path, lineage=True)
    tw.create(root, "cIdx", ["k"], ["v"])
    write_file(os.path.join(root, "d=9", "region=new", "part-00000.parquet"), {
        "k": pa.array([3, 4, 99], type=pa.int64()), "v": pa.array([0.5, 1.5, 2.5]),
        "tag": pa.array(["x", None, "y"]),
    })
    tw.refresh("cIdx", "incremental")
    tw.both("optimize_index", "cIdx", "full")
    entry = tw.assert_same("cIdx")
    files = [p for p in _content_files(entry["content"]["root"]) if p.endswith(".parquet")]
    assert all("v__" not in pq.read_schema(p).names for p in files)
    rebuild = PTwin(tmp_path / "rebuild", lineage=True)
    rebuild.create(root, "cIdx", ["k"], ["v"])
    rentry = rebuild.assert_same("cIdx")
    rfiles = [p for p in _content_files(rentry["content"]["root"]) if p.endswith(".parquet")]
    assert sorted((os.path.basename(p), _sha(p)) for p in files) == sorted(
        (os.path.basename(p), _sha(p)) for p in rfiles)

    def q(rd, c):
        return rd(root).filter(c("k") == 3).select("k", "v")

    assert tw.query(q, index="cIdx") == tw.disabled(q)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_a_partitioned_lake_written_by_one_package_reads_in_the_other(tmp_path, writer):
    rng = np.random.RandomState(3)
    root = os.path.join(str(tmp_path), "lake")
    s = hst.HyperspaceSession(warehouse=str(tmp_path), device="cpu") if writer == "torch" \
        else JaxSession(warehouse=str(tmp_path))
    for day in (20, 21, "__HIVE_DEFAULT_PARTITION__"):
        n = int(rng.randint(3, 30))
        name = np.array(["ab", "c", None], dtype=object)[rng.randint(0, 3, n)]
        s.write_parquet({"k": rng.randint(0, 9, n).astype(np.int64), "name": name, "x": rng.rand(n)},
                        os.path.join(root, f"day={day}"))
    tw = PTwin(tmp_path)
    got = tw.query(lambda rd, c: rd(root))
    assert list(got) == ["k", "name", "x", "day"] and None in got["day"]
    tw.create(root, "lakeIdx", ["day"], ["k", "name"])
    tw.assert_same("lakeIdx")
    assert tw.query(lambda rd, c: rd(root).filter(c("day") == 21).select("k", "name"), index="lakeIdx")["k"]


def test_an_empty_source_file_keeps_the_lineage_column_a_string(tmp_path):
    """A standing difference of the JAX package: an empty source file's
    lineage part is `Table.from_pydict({name: []})`, a float64 column, and
    the concatenation writes `_data_file_name` as float64 0.0 in every row
    (and a compaction of it raises TypeError). The port's lineage column is the
    paths, as over a lake without the empty file; its rows equal the
    non-indexed query's."""
    root, tw = mixed(tmp_path, empty=True), PTwin(tmp_path, lineage=True)
    tw.th.create_index(tw.read("torch", root), hst.IndexConfig("eIdx", ["k"], ["tag"]))
    tw.jh.create_index(tw.read("jax", root), JaxIndexConfig("eIdx", ["k"], ["tag"]))
    t_file, j_file = (os.path.join(tw.root(p), "eIdx", "v__=0", "part-00000.parquet") for p in ("torch", "jax"))
    assert pq.read_schema(j_file).field("_data_file_name").type == pa.float64()
    lineage = pq.read_table(t_file).column("_data_file_name").to_pylist()
    assert all(p.startswith(root) for p in lineage)

    def q(rd, c):
        return rd(root).filter(c("k") == 12).select("k", "tag")

    tq = q(lambda p: tw.read("torch", p), hst.col)
    assert "index=eIdx" in tq.explain_string()
    assert _host(tq.collect()) == tw.disabled(q)


def test_a_null_partition_value_never_joins(tmp_path):
    """`d` is null in one partition: the join on it (indexed on both sides,
    then the general join) drops those rows in both packages, and a left
    join keeps them beside nulls."""
    root, tw = mixed(tmp_path), PTwin(tmp_path)
    dim = os.path.join(str(tmp_path), "dim")
    write_file(os.path.join(dim, "part-00000.parquet"), {
        "d_id": pa.array([3, 7, 12, 99], type=pa.int64()), "label": ["three", "seven", "twelve", "none"]})
    tw.create(root, "dIdx", ["d"], ["k", "region"])
    tw.create(dim, "dimIdx", ["d_id"], ["label"])
    for how in ("inner", "left"):
        def q(rd, c, how=how):
            return rd(root).join(rd(dim), c("d") == c("d_id"), how).select("k", "region", "label")

        tq = q(lambda p: tw.read("torch", p), hst.col)
        assert "bucketed, no exchange" in tq.explain_string()
        got = tw.query(q)
        assert sorted(map(repr, zip(*got.values()))) == sorted(map(repr, zip(*tw.disabled(q).values())))
        nulls = tw.disabled(lambda rd, c: rd(root).filter(c("d").is_null()).select("k"))["k"]
        assert len(got["k"]) == tw.read("torch", root).count() - (len(nulls) if how == "inner" else 0)


def test_the_partitioning_api_equals_jax():
    """`values_for`, `constant_columns` / `append_partition_columns` (one
    file's constants) and the spec's JSON, against the JAX package's."""
    from hyperspace_tpu.engine import partitioning as jp
    from hyperspace_tpu.engine.table import Table as JaxTable
    from hyperspace_tpu_torch.engine import partitioning as tp
    from hyperspace_tpu_torch.engine.table import Table

    roots = ["/lake/t"]
    paths = ["/lake/t/d=7/r=a%2Fb/f.parquet", "/lake/t/d=__HIVE_DEFAULT_PARTITION__/r=zz/f.parquet",
             "/lake/t/d=12/r=__HIVE_DEFAULT_PARTITION__/f.parquet"]
    spec = tp.discover(roots, paths)
    assert spec == tp.PartitionSpec.from_json(jp.discover(roots, paths).to_json())
    assert tp.PartitionSpec.from_json(spec.to_json()) == spec and [f.name for f in spec.fields] == ["d", "r"]
    for p in paths:
        assert tp.values_for(spec, roots, p) == jp.values_for(jp.discover(roots, paths), roots, p)
        got = tp.append_partition_columns(Table.from_pydict({"k": np.arange(3)}, "cpu"), spec, roots, p)
        want = jp.append_partition_columns(JaxTable.from_pydict({"k": np.arange(3)}), jp.discover(roots, paths),
                                           roots, p)
        assert _host(got) == _host(want)
        for (n, c), (jn, jc) in zip(tp.constant_columns(spec, tp.values_for(spec, roots, p), 2, ["r"]),
                                    jp.constant_columns(jp.discover(roots, paths), tp.values_for(spec, roots, p), 2,
                                                        ["r"])):
            assert n == jn and list(c.dictionary) == list(jc.dictionary) and c.dtype == jc.dtype
    with pytest.raises(hst.HyperspaceException, match="does not match partition layout"):
        tp.values_for(spec, roots, "/lake/t/d=1/f.parquet")

"""CSV, JSON lines and ORC sources in the port against the JAX package.

Both packages read one source of each format (made with numpy from a seed:
ints with a null, floats, strings with nulls, an ISO date column, and a CSV
written by hand with an empty cell) and must give the same schema, the same
rows in order and the same counts; a covering index over the source must be
sha256-identical with a field-equal log entry, before and after a refresh;
each package reads the files the other writes; a Hive-partitioned lake of
each format reads as in the JAX package. Nothing is computed on the rows,
so the tolerance is 0.
"""

import os

import numpy as np
import pytest

import hyperspace_tpu_torch as hst
from hyperspace_tpu.engine import HyperspaceSession as JaxSession
from test_torch_partitioned import PTwin, _pinned  # noqa: F401  (the autouse fixture)
from test_torch_refresh import _host

FORMATS = ["csv", "json", "orc"]


def rows(seed, n=60, first=0):
    rng = np.random.RandomState(seed)
    k = rng.randint(0, 20, n).astype(object)
    k[rng.rand(n) < 0.1] = None
    name = np.array(["alpha", "beta", "gamma", "delta"], dtype=object)[rng.randint(0, 4, n)]
    name[rng.rand(n) < 0.15] = None
    day = (np.datetime64("2001-01-01") + rng.randint(0, 400, n)).astype(str)
    return {"id": np.arange(first, first + n, dtype=np.int64), "k": k, "x": np.round(rng.rand(n) * 100, 3),
            "name": name, "d": day}


def write(pkg, fmt, data, path):
    s = hst.HyperspaceSession(warehouse=path, device="cpu") if pkg == "torch" else JaxSession(warehouse=path)
    getattr(s, f"write_{fmt}")(data, path)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_a_source_reads_as_in_jax_whoever_wrote_it(tmp_path, fmt, writer):
    src = str(tmp_path / "src")
    write(writer, fmt, rows(1), src)
    tw = PTwin(tmp_path, fmt=fmt)
    got = tw.query(lambda rd, c: rd(src))
    schema = tw.read("torch", src).schema
    assert [(f.name, f.dtype) for f in schema.fields] == [
        ("id", "int64"), ("k", "int64"), ("x", "float64"), ("name", "string"), ("d", "string")]
    assert got["d"][0] == rows(1)["d"][0] and None in got["k"] and None in got["name"]
    tw.query(lambda rd, c: rd(src).filter(c("name").is_null() | (c("k") == 3)).select("id", "d"))
    tw.query(lambda rd, c: rd(src).filter(c("d") >= "2001-06-01").select("id", "x"))


def test_an_empty_csv_cell_is_null_and_an_iso_date_a_string(tmp_path):
    src = str(tmp_path / "src")
    os.makedirs(src)
    with open(os.path.join(src, "a.csv"), "w") as f:
        f.write("id,k,name,d\n1,5,,2001-01-02\n2,,bob,2001-02-03\n3,7,\"\",1999-12-31\n")
    tw = PTwin(tmp_path, fmt="csv")
    got = tw.query(lambda rd, c: rd(src))
    assert got == {"id": [1, 2, 3], "k": [5, None, 7], "name": [None, "bob", None],
                   "d": ["2001-01-02", "2001-02-03", "1999-12-31"]}
    assert tw.query(lambda rd, c: rd(src).filter(c("name").is_null()))["id"] == [1, 3]


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("lineage", [False, True])
def test_a_covering_index_and_its_refreshes_equal_jax(tmp_path, fmt, lineage):
    src = str(tmp_path / "src")
    write("torch", fmt, rows(2), src)
    tw = PTwin(tmp_path, fmt=fmt, lineage=lineage)
    tw.create(src, "fIdx", ["k"], ["name", "d"])
    tw.assert_same("fIdx")

    def q(rd, c):
        return rd(src).filter(c("k") == 4).select("k", "name", "d")

    assert tw.query(q, index="fIdx") == tw.disabled(q)
    ext = {"csv": "csv", "json": "json", "orc": "orc"}[fmt]
    more = str(tmp_path / "more")
    write("torch", fmt, rows(3, 25, first=60), more)
    os.replace(os.path.join(more, f"part-00000.{ext}"), os.path.join(src, f"part-00001.{ext}"))
    assert tw.refresh("fIdx", "incremental") is None
    tw.assert_same("fIdx")
    assert tw.query(q, index="fIdx") == tw.disabled(q)
    assert tw.refresh("fIdx", "full") is None
    tw.assert_same("fIdx")
    assert tw.query(q, index="fIdx") == tw.disabled(q)


@pytest.mark.parametrize("fmt", FORMATS)
def test_a_join_over_indexes_of_two_formats_equals_jax(tmp_path, fmt):
    left, right = str(tmp_path / "l"), str(tmp_path / "r")
    write("torch", fmt, rows(4), left)
    write("torch", "parquet", {"kk": np.arange(20, dtype=np.int64), "label": np.arange(20) * 1.5}, right)
    tw = PTwin(tmp_path, fmt=fmt)
    tw.create(left, "lIdx", ["k"], ["id"])
    tw.th.create_index(tw.t.read.parquet(right), hst.IndexConfig("rIdx", ["kk"], ["label"]))
    from hyperspace_tpu import IndexConfig as JaxIndexConfig

    tw.jh.create_index(tw.j.read.parquet(right), JaxIndexConfig("rIdx", ["kk"], ["label"]))

    def q(rd, c):
        r = tw.t.read.parquet(right) if c is hst.col else tw.j.read.parquet(right)
        return rd(left).join(r, c("k") == c("kk")).select("id", "label")

    tq = q(lambda p: tw.read("torch", p), hst.col)
    assert "bucketed, no exchange" in tq.explain_string()
    got = tw.query(q)
    assert sorted(zip(*got.values())) == sorted(zip(*tw.disabled(q).values()))


@pytest.mark.parametrize("fmt", FORMATS)
def test_the_writer_round_trips(tmp_path, fmt):
    data = rows(5)
    src = str(tmp_path / "src")
    write("torch", fmt, data, src)
    s = hst.HyperspaceSession(warehouse=str(tmp_path), device="cpu")
    got = _host(getattr(s.read, fmt)(src).collect())
    want = {n: [None if v is None else v for v in np.asarray(a, dtype=object).tolist()] for n, a in data.items()}
    assert got == want


@pytest.mark.parametrize("fmt", FORMATS + ["parquet"])
def test_a_partitioned_lake_of_each_format_reads_as_in_jax(tmp_path, fmt, monkeypatch):
    """`root/day=<v>/region=<r>/part-00000.<ext>` with a null day and a
    string region: the schema, rows in order, a filter on each partition
    column and an index over the lake equal the JAX package's; a relative
    root reads as the absolute one."""
    root = str(tmp_path / "lake")
    for i, (day, region) in enumerate([(3, "n"), (3, "s"), ("__HIVE_DEFAULT_PARTITION__", "n"), (12, "s")]):
        data = rows(10 + i, n=15 + 5 * i, first=100 * i)
        part = os.path.join(root, f"day={day}", f"region={region}")
        write("torch", fmt, {n: data[n] for n in ("id", "k", "name")}, part)
    tw = PTwin(tmp_path, fmt=fmt)
    got = tw.query(lambda rd, c: rd(root))
    assert list(got)[-2:] == ["day", "region"] and None in got["day"]
    tw.query(lambda rd, c: rd(root).filter(c("day").is_null() | (c("region") == "s")).select("id", "day", "region"))
    tw.create(root, "pIdx", ["region"], ["id", "day"])
    tw.assert_same("pIdx")
    tw.query(lambda rd, c: rd(root).filter(c("region") == "n").select("id", "day"), index="pIdx")
    monkeypatch.chdir(str(tmp_path))
    assert tw.query(lambda rd, c: rd("lake")) == got

"""Delta tables in the port against the JAX package, on the same tables.

A delta table is parquet data files plus a `_delta_log` of `add` / `remove`
commits (`storage/delta.py` in both packages). Each test drives both
packages over ONE table, each with its own index warehouse (`DsTwin` of
`test_torch_dataskipping.py`, reading with `read.delta`), and requires

- the same snapshot: rows in the same order and `count()`;
- covering and data-skipping indexes over the table whose log entries and
  files equal the JAX package's (`Twin.assert_same`) through create,
  incremental, auto and full refresh and optimize, and whose compacted files
  equal a from-scratch build's;
- a file that a `remove` commit dropped, left on disk, read by no path:
  the reader, the scan caches, the signature, Hybrid Scan and a refresh;
- a table written by either package read, indexed and refreshed by the
  other.

The shapes are `tests/test_extensions.py`'s `TestDeltaSource` :328-365, plus
the cases above. Nothing is computed on the rows, so the tolerance is 0.
"""

import os

import numpy as np
import pytest

import hyperspace_tpu_torch as hst
from hyperspace_tpu import IndexConfig as JaxIndexConfig
from hyperspace_tpu.engine import col as jax_col
from hyperspace_tpu.storage import delta as jax_delta
from hyperspace_tpu_torch.storage import delta as torch_delta

from test_torch_dataskipping import DsTwin, _pinned, scan_of  # noqa: F401  (the autouse fixture)
from test_torch_refresh import _content_files, _host, _sha


def _rows(df):
    return _host(df.collect())


def create_covering(tw, src, name, indexed, included):
    tw.th.create_index(tw.read("torch", src), hst.IndexConfig(name, indexed, included))
    tw.jh.create_index(tw.read("jax", src), JaxIndexConfig(name, indexed, included))


def query(tw, src, build, index=None):
    """Both packages' rows of `build(df, col)` over the table, equal, in
    order, with the port's count; the port's plan scans `index` if named."""
    tq, jq = build(tw.read("torch", src), hst.col), build(tw.read("jax", src), jax_col)
    if index is not None:
        assert f"index={index}" in tq.explain_string(), tq.explain_string()
    got, want = _rows(tq), _rows(jq)
    assert got == want
    assert tq.count() == len(next(iter(want.values())))
    return got


def point(k):
    return lambda d, c: d.filter(c("k") == k).select("k", "v")


def scan_all(d, c):
    return d.filter(c("k") >= 0).select("k", "v")


def test_snapshot_read_and_overwrite(tmp_path):
    p = str(tmp_path / "dtable")
    tw = DsTwin(tmp_path, fmt="delta")
    tw.t.write_delta({"k": np.array([1, 2]), "v": np.array(["a", "b"])}, p)
    tw.t.write_delta({"k": np.array([3]), "v": np.array(["c"])}, p, mode="append")
    assert query(tw, p, lambda d, c: d) == {"k": [1, 2, 3], "v": ["a", "b", "c"]}
    tw.t.write_delta({"k": np.array([9]), "v": np.array(["z"])}, p, mode="overwrite")
    assert query(tw, p, lambda d, c: d) == {"k": [9], "v": ["z"]}
    assert [f.path for f in torch_delta.active_files(p)] == [f.path for f in jax_delta.active_files(p)]
    with pytest.raises(hst.HyperspaceException, match="Unsupported delta write mode"):
        tw.t.write_delta({"k": np.array([1])}, p, mode="merge")


def test_index_over_delta_source(tmp_path):
    p = str(tmp_path / "dtable")
    tw = DsTwin(tmp_path, fmt="delta")
    tw.t.write_delta({"k": np.array([1, 2, 3]), "v": np.array(["a", "b", "c"])}, p)
    create_covering(tw, p, "dIdx", ["k"], ["v"])
    e = tw.assert_same("dIdx")
    assert e["source"]["plan"]["properties"]["relations"][0]["fileFormat"] == "delta"
    assert query(tw, p, point(2), index="dIdx") == {"k": [2], "v": ["b"]}
    # An append commit changes the snapshot: the index is stale until refreshed.
    tw.t.write_delta({"k": np.array([4]), "v": np.array(["d"])}, p, mode="append")
    assert "index=" not in point(4)(tw.read("torch", p), hst.col).explain_string()
    assert query(tw, p, point(4)) == {"k": [4], "v": ["d"]}
    assert tw.refresh("dIdx", "incremental") is None
    tw.assert_same("dIdx")
    assert query(tw, p, point(4), index="dIdx") == {"k": [4], "v": ["d"]}
    query(tw, p, scan_all, index="dIdx")
    # Overwrite, then a full refresh: one version directory over the new snapshot.
    tw.t.write_delta({"k": np.array([7, 8]), "v": np.array(["x", "y"])}, p, mode="overwrite")
    assert tw.refresh("dIdx", "full") is None
    tw.assert_same("dIdx")
    assert query(tw, p, scan_all, index="dIdx") == {"k": [7, 8], "v": ["x", "y"]}


def test_remove_commit_leaves_the_file_on_disk_and_unread(tmp_path):
    """A `remove` drops the file from the snapshot, not from the disk: the
    reader, the warm scan caches, an auto refresh (which folds the delete
    through lineage) and optimize (equal to a rebuild) all take the snapshot."""
    p = str(tmp_path / "dtable")
    tw = DsTwin(tmp_path, fmt="delta", lineage=True)
    for i in range(3):
        keys = np.arange(i * 10, i * 10 + 10)
        tw.t.write_delta({"k": keys, "v": np.array([f"s{x}" for x in keys])}, p)
    create_covering(tw, p, "rmIdx", ["k"], ["v"])
    q = lambda d, c: d.filter(c("k") < 100).select("k")  # noqa: E731
    hst.disable_hyperspace(tw.t)
    assert len(_rows(q(tw.read("torch", p), hst.col))["k"]) == 30  # warms the scan caches
    hst.enable_hyperspace(tw.t)
    first = torch_delta.active_files(p)[0]
    torch_delta.remove_file(p, os.path.relpath(first.path, p))
    assert os.path.exists(first.path)
    assert first.path not in [f.path for f in scan_of(tw.read("torch", p)).files]
    tw.hybrid()
    got = query(tw, p, q, index="rmIdx")  # lineage prunes the removed file's rows
    assert sorted(got["k"]) == list(range(10, 30))
    tw.hybrid(False)
    assert "index=" not in q(tw.read("torch", p), hst.col).explain_string()
    assert tw.refresh("rmIdx", "auto") is None
    e = tw.assert_same("rmIdx")
    assert e["extra"]["deletedSourceFiles"] == [first.path]
    assert sorted(query(tw, p, q, index="rmIdx")["k"]) == list(range(10, 30))
    assert tw.both("optimize_index", "rmIdx") is None
    e = tw.assert_same("rmIdx")
    assert "deletedSourceFiles" not in e["extra"]
    query(tw, p, q, index="rmIdx")
    # The compaction oracle: the optimized files equal a from-scratch build's.
    rebuild = DsTwin(tmp_path / "rebuild", fmt="delta", lineage=True)
    create_covering(rebuild, p, "rmIdx", ["k"], ["v"])
    rebuild.assert_same("rmIdx")
    shas = [sorted(_sha(f) for f in _content_files(t.entries("rmIdx")[0]["content"]["root"])) for t in (tw, rebuild)]
    assert shas[0] == shas[1]


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_a_table_written_by_either_package_is_read_indexed_and_refreshed_by_the_other(tmp_path, writer):
    """The writer makes the table (two appends, a remove); the other package
    reads it and both index and refresh it. The data files each package
    writes for the same rows are byte-identical."""
    p = str(tmp_path / "dtable")
    tw = DsTwin(tmp_path, fmt="delta", lineage=True)
    w = tw.t if writer == "torch" else tw.j
    rng = np.random.RandomState(7)
    for _ in range(2):
        keys = rng.randint(0, 50, 20)
        w.write_delta({"k": keys, "v": np.array([f"s{x % 7}" for x in keys])}, p)
    create_covering(tw, p, "xIdx", ["k"], ["v"])
    tw.assert_same("xIdx")
    query(tw, p, scan_all, index="xIdx")
    keys = rng.randint(0, 50, 20)
    w.write_delta({"k": keys, "v": np.array([f"s{x % 7}" for x in keys])}, p)
    mod = torch_delta if writer == "torch" else jax_delta
    mod.remove_file(p, os.path.relpath(mod.active_files(p)[0].path, p))
    assert tw.refresh("xIdx", "incremental") is None
    tw.assert_same("xIdx")
    query(tw, p, scan_all, index="xIdx")
    query(tw, p, point(int(keys[0])), index="xIdx")
    # The other package writes the same rows to a table of its own.
    other, copy = (tw.j if writer == "torch" else tw.t), str(tmp_path / "other")
    for f in torch_delta.active_files(p):
        t = tw.t.read.parquet(f.path).collect()
        other.write_delta({n: t.column(n).decode() for n in t.column_names}, copy)
    theirs, ours = torch_delta.active_files(p), torch_delta.active_files(copy)
    assert [_sha(f.path) for f in theirs] == [_sha(f.path) for f in ours]
    assert query(tw, copy, lambda d, c: d) == query(tw, p, lambda d, c: d)


def test_data_skipping_over_a_delta_table(tmp_path):
    """A MinMax and a bloom sketch over commits of disjoint key ranges; the
    file a `remove` dropped is not in the snapshot and is never read."""
    p = str(tmp_path / "dtable")
    tw = DsTwin(tmp_path, fmt="delta")
    for i in range(4):
        keys = np.arange(i * 100, i * 100 + 50)
        tw.t.write_delta({"k": keys, "v": keys % 13}, p)
    tw.create_ds(p, "dsDelta", [("minmax", "k"), ("bloom", "v", 256, 3)])
    tw.assert_same("dsDelta")
    tw.check(p, lambda d, c: d.filter(c("k") == 210).select("k", "v"), files=1, pruned_by=["dsDelta"])
    tw.check(p, lambda d, c: (d.filter((c("k") >= 120) & (c("k") < 140)).select("k")), files=1)
    tw.check(p, lambda d, c: d.filter(c("v") == 99).select("k"), files=0)
    first = torch_delta.active_files(p)[0]
    torch_delta.remove_file(p, os.path.relpath(first.path, p))
    tw.hybrid()
    got = tw.check(p, lambda d, c: d.filter(c("k") < 250).select("k"), files=2, pruned_by=["dsDelta"])
    assert first.path not in [f.path for f in scan_of(tw.read("torch", p).filter(hst.col("k") < 250)).files]
    assert got["k"] == list(range(100, 150)) + list(range(200, 250))
    assert tw.refresh("dsDelta", "full") is None
    tw.assert_same("dsDelta")
    tw.check(p, lambda d, c: d.filter(c("k") == 5).select("k"), files=0)


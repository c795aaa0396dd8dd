"""`optimize_index` (compaction) in the port against the JAX package.

Each test drives both packages over ONE source directory, each with its own
index warehouse (`Twin` of `test_torch_refresh.py`): create, incremental
refreshes that append and fold deletes, then `optimize_index` in quick or
full mode. After each step they must agree on the latest log entry (equal
apart from the timestamp, the warehouse prefix and the files' modification
times), the index files (sha256 by path below the warehouse), an error where
one is raised (class and message), and the rows of the queries in order.
The compacted files must also be sha256-identical to a from-scratch
`create_index` of the same source in another warehouse. The shapes are
`tests/test_extensions.py` `TestOptimize` :286-326 and
`tests/test_live_tables.py` `TestCompaction` :311-390, plus keys the build
sorts with care: floats with NaN and ±0.0, a nullable key and a string key.
Nothing is computed on the rows, so the tolerance is 0. The fault-point
cases of `test_live_tables.py` (:386, :405, :424, :463) wait for the port's
fault harness.
"""

import os

import numpy as np
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu_torch as hst
from hyperspace_tpu.actions.optimize import needs_compaction as jax_needs_compaction
from hyperspace_tpu.index import quarantine as jax_quarantine
from hyperspace_tpu_torch.actions.optimize import _version_rank, needs_compaction
from hyperspace_tpu_torch.engine import physical, scan_cache
from hyperspace_tpu_torch.index import quarantine

from test_torch_refresh import Twin, _content_files, _host, _sha, scan_all, version_dirs, write


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    monkeypatch.setenv("HYPERSPACE_BUILD_DECODE_THREADS", "1")
    quarantine.clear()
    jax_quarantine.clear()
    yield
    quarantine.clear()
    jax_quarantine.clear()
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()


def _kv(keys, vals):
    return {"k": np.asarray(keys), "v": np.asarray(vals)}


def _src(tmp_path, name="t"):
    """test_live_tables.py's two-file source."""
    src = str(tmp_path / name)
    write(src, "part-00000.parquet", _kv([1, 2, 3, 4], ["a", "b", "c", "d"]))
    write(src, "part-00001.parquet", _kv([5, 6], ["e", "f"]))
    return src


def entry_of(hs, name):
    return next(e for e in hs._manager.get_indexes() if e.name == name)


def rebuild_shas(tmp_path, src, indexed, included, num_buckets, lineage=True, name="oracle"):
    """The sha256 of each file of a from-scratch `create_index` of the
    current source in both packages' own warehouses (equal to each other)."""
    oracle = Twin(tmp_path / name, num_buckets=num_buckets, lineage=lineage)
    oracle.create(src, "idx", indexed, included)
    e = oracle.assert_same("idx")
    return sorted(_sha(p) for p in _content_files(e["content"]["root"]))


def same_rows(tw, build):
    """Both packages' rows of `build(read, col)`, equal and in order, floats
    compared by their repr (NaN equals NaN, -0.0 differs from 0.0); and the
    port's count."""
    from hyperspace_tpu.engine import col as jax_col

    tq = build(lambda p: tw.t.read.parquet(p), hst.col)
    jq = build(lambda p: tw.j.read.parquet(p), jax_col)
    got, want = (
        {n: [repr(x) for x in v] for n, v in _host(q.collect()).items()} for q in (tq, jq)
    )
    assert got == want
    assert tq.count() == len(next(iter(want.values())))
    return got


def shas(entry):
    return sorted(_sha(p) for p in _content_files(entry["content"]["root"]))


# ---------------------------------------------------------------------------
# test_extensions.py TestOptimize
# ---------------------------------------------------------------------------


def test_optimize_compacts_bucket_files(tmp_path):
    src, tw = _src(tmp_path), Twin(tmp_path, num_buckets=2, lineage=False)
    tw.create(src, "opt", ["k"], ["v"])
    for i in range(2):
        write(src, f"new{i}.parquet", _kv([10 + i], [f"x{i}"]))
        tw.refresh("opt", "incremental")
    assert len(_content_files(tw.assert_same("opt")["content"]["root"])) > 2
    assert tw.both("optimize_index", "opt") is None  # quick: every file is small
    e = tw.assert_same("opt")
    files = _content_files(e["content"]["root"])
    assert len(files) == len({os.path.basename(f) for f in files})  # one file a bucket
    assert tw.query(lambda rd, c: rd(src).filter(c("k") == 11).select("v"), "opt") == {"v": ["x1"]}
    kind, msg = tw.both("optimize_index", "opt")
    assert kind == "HyperspaceException" and "no optimizable" in msg


def test_optimize_unknown_mode_rejected(tmp_path):
    src, tw = _src(tmp_path), Twin(tmp_path)
    tw.create(src, "m", ["k"], ["v"])
    kind, msg = tw.both("optimize_index", "m", "turbo")
    assert kind == "HyperspaceException" and "mode" in msg
    kind, msg = tw.both("optimize_index", "nosuch")
    assert "could not be found" in msg


# ---------------------------------------------------------------------------
# test_live_tables.py TestCompaction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("encoded", ["0", "1"])
def test_compaction_is_byte_identical_to_a_full_rebuild(tmp_path, monkeypatch, encoded):
    monkeypatch.setenv("HYPERSPACE_ENCODED_EXEC", encoded)
    src, tw = _src(tmp_path), Twin(tmp_path)
    tw.create(src, "cmp", ["k"], ["v"])
    write(src, "part-00002.parquet", _kv([7, 8], ["g", "h"]))
    tw.refresh("cmp", "incremental")
    write(src, "part-00003.parquet", _kv([9, 10], ["i", "j"]))
    os.remove(os.path.join(src, "part-00001.parquet"))
    tw.refresh("cmp", "incremental")
    assert tw.assert_same("cmp")["extra"]["deletedSourceFiles"]
    tw.both("optimize_index", "cmp")
    e = tw.assert_same("cmp")
    assert "deletedSourceFiles" not in e["extra"]
    assert shas(e) == rebuild_shas(tmp_path, src, ["k"], ["v"], 2)
    rows = tw.query(scan_all(src), "cmp")
    assert sorted(zip(rows["k"], rows["v"])) == [
        (1, "a"), (2, "b"), (3, "c"), (4, "d"), (7, "g"), (8, "h"), (9, "i"), (10, "j")]


def test_compacted_files_carry_the_index_schema_only(tmp_path):
    src, tw = _src(tmp_path), Twin(tmp_path)
    tw.create(src, "schm", ["k"], ["v"])
    write(src, "part-00002.parquet", _kv([7, 8], ["g", "h"]))
    tw.refresh("schm", "incremental")
    tw.both("optimize_index", "schm")
    e = tw.assert_same("schm")
    for f in _content_files(e["content"]["root"]):
        assert pq.ParquetFile(f).schema_arrow.names == ["k", "v", "_data_file_name"]


def test_needs_compaction_trigger(tmp_path, monkeypatch):
    src, tw = _src(tmp_path), Twin(tmp_path)
    tw.create(src, "trig", ["k"], ["v"])

    def both_need():
        t, j = needs_compaction(entry_of(tw.th, "trig")), jax_needs_compaction(entry_of(tw.jh, "trig"))
        assert t == j
        return t

    assert not both_need()
    write(src, "part-00002.parquet", _kv([7, 8, 9, 10], ["g", "h", "i", "j"]))
    tw.refresh("trig", "incremental")
    assert both_need()
    monkeypatch.setenv("HYPERSPACE_COMPACT_TRIGGER_FILES", "9")
    assert not both_need()
    os.remove(os.path.join(src, "part-00002.parquet"))
    tw.refresh("trig", "incremental")
    assert both_need()  # a folded delete set triggers whatever the spread
    tw.both("optimize_index", "trig")
    monkeypatch.delenv("HYPERSPACE_COMPACT_TRIGGER_FILES")
    assert not both_need()
    tw.assert_same("trig")


# ---------------------------------------------------------------------------
# Modes, version order and the key kinds
# ---------------------------------------------------------------------------


def test_quick_mode_leaves_files_above_the_threshold(tmp_path):
    """A threshold between the small delta files and the large first build:
    quick merges only the buckets with two or more small files, full every
    bucket; the untouched files stay in the entry beside the compacted ones."""
    rng = np.random.RandomState(3)
    src, tw = str(tmp_path / "t"), Twin(tmp_path, num_buckets=4)
    write(src, "part-00000.parquet", _kv(rng.randint(0, 500, 4000), rng.randint(0, 9, 4000).astype(str)))
    tw.create(src, "q", ["k"], ["v"])
    for i in (1, 2):
        write(src, f"part-0000{i}.parquet", _kv(rng.randint(0, 500, 5), ["n"] * 5))
        tw.refresh("q", "incremental")
    sizes = [os.path.getsize(p) for p in _content_files(tw.assert_same("q")["content"]["root"])]
    threshold = (min(sizes) + max(sizes)) // 2
    for s, k in ((tw.t, "hyperspace.index.optimize.fileSizeThreshold"), (tw.j, "hyperspace.index.optimize.fileSizeThreshold")):
        s.conf.set(k, threshold)
    tw.both("optimize_index", "q")
    e = tw.assert_same("q")
    assert version_dirs(e)[0] == "0" and version_dirs(e)[-1] == "3"  # the large first-build files stay
    tw.query(scan_all(src), "q")
    tw.both("optimize_index", "q", "full")
    e = tw.assert_same("q")
    assert version_dirs(e)[-1] == "4"  # a bucket of one file stays as it is
    assert shas(e) == rebuild_shas(tmp_path, src, ["k"], ["v"], 4)


def test_versions_merge_in_numeric_order_without_lineage(tmp_path):
    """Eleven versions of one bucket (v__=10 sorts before v__=2 as a
    string): merged in numeric version order, as a rebuild orders them."""
    assert _version_rank("/x/v__=10/part-00000.parquet") == 10 and _version_rank("/x/part-00000.parquet") == -1
    src, tw = str(tmp_path / "t"), Twin(tmp_path, num_buckets=1, lineage=False)
    write(src, "part-00000.parquet", _kv([5, 5], ["a", "b"]))
    tw.create(src, "num", ["k"], ["v"])
    for i in range(1, 11):
        write(src, f"part-{i:05d}.parquet", _kv([5], [f"r{i}"]))
        tw.refresh("num", "incremental")
    tw.both("optimize_index", "num", "full")
    e = tw.assert_same("num")
    assert shas(e) == rebuild_shas(tmp_path, src, ["k"], ["v"], 1, lineage=False)
    rows = tw.query(lambda rd, c: rd(src).filter(c("k") == 5).select("v"), "num")
    assert rows["v"] == ["a", "b"] + [f"r{i}" for i in range(1, 11)]


def test_an_appended_file_that_sorts_first_keeps_a_rebuilds_tie_order(tmp_path):
    """With lineage, equal keys re-rank by the current inventory's path
    order: an appended file whose path sorts before the built ones puts its
    rows first among equal keys, as a rebuild reads it first."""
    src, tw = str(tmp_path / "t"), Twin(tmp_path, num_buckets=1)
    write(src, "part-00000.parquet", _kv([5, 5, 6], ["a", "b", "c"]))
    tw.create(src, "tie", ["k"], ["v"])
    write(src, "early.parquet", _kv([6, 5], ["x", "y"]))
    tw.refresh("tie", "incremental")
    tw.both("optimize_index", "tie")
    e = tw.assert_same("tie")
    assert shas(e) == rebuild_shas(tmp_path, src, ["k"], ["v"], 1)
    rows = tw.query(scan_all(src), "tie")
    assert rows == {"k": [5, 5, 5, 6, 6], "v": ["y", "a", "b", "x", "c"]}


def _keys(rng, kind, n):
    if kind == "float":
        pool = np.array([np.nan, -0.0, 0.0, 1.5, -2.25, 3.0, -np.inf, np.inf])
        return pool[rng.randint(0, len(pool), n)]
    if kind == "nullable":
        v = rng.randint(0, 30, n).astype(object)
        v[rng.rand(n) < 0.2] = None
        return v
    if kind == "string":
        return np.array(["MAIL", "SHIP", "AIR", "RAIL", "TRUCK"])[rng.randint(0, 5, n)]
    v = np.array([f"name{i:05d}" for i in rng.randint(0, 400, n)], dtype=object)
    if kind == "nullable_string":
        v[rng.rand(n) < 0.2] = None
    return v


@pytest.mark.parametrize("kind", ["float", "nullable", "string", "long_string", "nullable_string"])
@pytest.mark.parametrize("mode", ["quick", "full"])
def test_compaction_of_each_key_kind_equals_jax_and_a_rebuild(tmp_path, kind, mode):
    """Three source files appended over two incremental refreshes, one
    deleted: compaction folds the delete and re-sorts each bucket by a key
    whose sort must tie -0.0 with +0.0 and put NaN last (float), sort null
    slots by their fill (nullable, nullable_string), or run K3's plain twin
    (a string key of five values) or the sort chain (400 values)."""
    rng = np.random.RandomState(7)
    src, tw = str(tmp_path / "t"), Twin(tmp_path, num_buckets=4)

    def part(i, n):
        write(src, f"part-{i:05d}.parquet", {"k": _keys(rng, kind, n), "v": rng.randint(0, 100, n), "w": rng.rand(n)})

    part(0, 200)
    part(1, 150)
    tw.create(src, "kk", ["k"], ["v", "w"])
    part(2, 120)
    tw.refresh("kk", "incremental")
    part(3, 90)
    os.remove(os.path.join(src, "part-00000.parquet"))
    tw.refresh("kk", "incremental")
    tw.both("optimize_index", "kk", mode)
    e = tw.assert_same("kk")
    assert "deletedSourceFiles" not in e["extra"] and len(version_dirs(e)) == 1
    assert shas(e) == rebuild_shas(tmp_path, src, ["k"], ["v", "w"], 4)
    rows = same_rows(tw, lambda rd, c: rd(src).filter(c("v") >= 0).select("k", "v", "w"))
    assert len(rows["k"]) == 360


def test_a_compacted_index_answers_the_join_in_value_mode(tmp_path):
    """After an incremental refresh a bucket holds two sorted runs, so the
    join pads by hash; the compacted bucket is one sorted run again."""
    from hyperspace_tpu_torch.engine.physical import ExecContext, SortMergeJoinExec

    l, r = str(tmp_path / "l"), str(tmp_path / "r")
    tw = Twin(tmp_path, num_buckets=2)
    write(l, "part-00000.parquet", _kv(np.arange(0, 40, 2), np.arange(20).astype(str)))
    write(r, "part-00000.parquet", {"k2": np.arange(60), "w": np.arange(60) * 10})
    tw.create(l, "vl", ["k"], ["v"])
    tw.create(r, "vr", ["k2"], ["w"])
    write(l, "part-00001.parquet", _kv(np.arange(1, 40, 2), np.arange(20).astype(str)))
    tw.refresh("vl", "incremental")

    def q(rd, c):
        return rd(l).join(rd(r), c("k") == c("k2")).select("k", "v", "w")

    def mode():
        df = q(lambda p: tw.t.read.parquet(p), hst.col)
        join = next(n for n in df.physical_plan().collect_nodes() if isinstance(n, SortMergeJoinExec))
        left, right, ls, rs, subkey, rows_key = join._sides(ExecContext(tw.t))
        return join._plan_and_ranges(left, right, ls, rs, subkey, rows_key)[0].mode

    before = tw.query(q, "vl")
    assert mode() == "hash"
    tw.both("optimize_index", "vl")
    tw.assert_same("vl")
    assert mode() == "value"
    after = tw.query(q, "vl")
    assert sorted(zip(*before.values())) == sorted(zip(*after.values()))

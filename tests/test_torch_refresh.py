"""Refresh in the port against the JAX package, on the same lakes.

Every test drives both packages over ONE source directory, each with its own
index warehouse (`Twin`), through the same steps: create with lineage on,
append or delete source files, `refresh_index` full, incremental or auto.
After each step they must agree on

- the index files (sha256 by path below the warehouse),
- the latest log entry (equal apart from the timestamp, the warehouse prefix
  and the index files' modification times; the ids are equal),
- an error where one is raised (the same class name and message),
- the rows of filter and join queries, in the same order.

The shapes are those of `tests/test_live_tables.py` :116-:298 and :510-:580
without compaction, Hybrid Scan and fault injection, plus the reads only the
port's layout has to get right: a two-version index through the co-bucketed
join (value mode while every bucket stays sorted, hash mode as soon as one
bucket is not) and through the row-group-pruned bucketed scan. Nothing is
computed on the rows, so the tolerance is 0. The JAX package runs its
single-device serial build (`HYPERSPACE_DISTRIBUTED=0`,
`HYPERSPACE_BUILD_DECODE_THREADS=1`).
"""

import copy
import hashlib
import json
import os
import threading
import time

import numpy as np
import pytest

import hyperspace_tpu_torch as hst
from hyperspace_tpu import IndexConfig as JaxIndexConfig
from hyperspace_tpu import IndexConstants as JaxIndexConstants
from hyperspace_tpu.engine import HyperspaceSession as JaxSession
from hyperspace_tpu.engine import col as jax_col
from hyperspace_tpu.hyperspace import Hyperspace as JaxHyperspace
from hyperspace_tpu.hyperspace import enable_hyperspace as jax_enable
from hyperspace_tpu.index import quarantine as jax_quarantine
from hyperspace_tpu_torch.engine import io as torch_io
from hyperspace_tpu_torch.engine import physical, scan_cache
from hyperspace_tpu_torch.engine.physical import ExecContext, SortMergeJoinExec
from hyperspace_tpu_torch.engine.table import Table
from hyperspace_tpu_torch.index import quarantine
from hyperspace_tpu_torch.ops.bucket_join import value_mode_vals


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    monkeypatch.setenv("HYPERSPACE_BUILD_DECODE_THREADS", "1")
    quarantine.clear()
    jax_quarantine.clear()
    yield
    quarantine.clear()
    jax_quarantine.clear()


def write(src, name, table):
    """Write a source file by rename, so no reader sees it half written."""
    tmp = os.path.join(src, name + ".tmp")
    torch_io.write_parquet(Table.from_pydict(table, "cpu"), tmp)
    os.replace(tmp, os.path.join(src, name))


def _host(t):
    return {n: np.asarray(c.decode_objects(), dtype=object).tolist() for n, c in t.columns.items()}


class Twin:
    """Both packages over one source directory, each in its own warehouse.
    Metadata caches expire at once, so either package sees every commit."""

    def __init__(self, base, num_buckets=2, lineage=True):
        self.base = str(base)
        self.t = hst.HyperspaceSession(warehouse=os.path.join(self.base, "torch"), device="cpu")
        self.j = JaxSession(warehouse=os.path.join(self.base, "jax"))
        for s, k in ((self.t, hst.IndexConstants), (self.j, JaxIndexConstants)):
            s.conf.set(k.INDEX_NUM_BUCKETS, num_buckets)
            s.conf.set(k.INDEX_LINEAGE_ENABLED, "true" if lineage else "false")
            s.conf.set(k.INDEX_CACHE_EXPIRY_DURATION_SECONDS, 0)
        self.th, self.jh = hst.Hyperspace(self.t), JaxHyperspace(self.j)
        hst.enable_hyperspace(self.t)
        jax_enable(self.j)

    def create(self, src, name, indexed, included):
        self.th.create_index(self.t.read.parquet(src), hst.IndexConfig(name, indexed, included))
        self.jh.create_index(self.j.read.parquet(src), JaxIndexConfig(name, indexed, included))

    def both(self, method, *args):
        """Call a `Hyperspace` method in both packages: both succeed, or both
        raise the same error class with the same message (returned)."""
        errors = []
        for hs in (self.th, self.jh):
            try:
                getattr(hs, method)(*args)
                errors.append(None)
            except Exception as e:  # noqa: BLE001 - compared across packages
                errors.append((type(e).__name__, str(e)))
        assert errors[0] == errors[1], errors
        return errors[0]

    def refresh(self, name, mode):
        return self.both("refresh_index", name, mode)

    def root(self, pkg):
        return os.path.join(self.base, pkg, "indexes")

    def entries(self, name):
        """Each package's latest log entry of `name`, as written."""
        out = []
        for pkg in ("torch", "jax"):
            log = os.path.join(self.root(pkg), name, "_hyperspace_log")
            latest = max(int(n) for n in os.listdir(log) if n.isdigit())
            out.append(json.load(open(os.path.join(log, str(latest)))))
        return out

    def normalized(self, d, pkg):
        d = copy.deepcopy(d)
        d.pop("timestamp")
        stack = [d["content"]["root"]]
        while stack:
            node = stack.pop()
            for f in node["files"]:
                f["modifiedTime"] = 0
            if node["name"] == pkg:  # the warehouse's own directory in a merged tree
                node["name"] = "<warehouse>"
            stack.extend(node["subDirs"])
        return json.dumps(d, indent=1).replace(os.path.join(self.base, pkg), "<warehouse>")

    def assert_same(self, name):
        """Equal log entries and sha256-identical index files."""
        t, j = self.entries(name)
        assert list(t) == list(j)
        assert self.normalized(t, "torch") == self.normalized(j, "jax")
        shas = []
        for pkg, e in (("torch", t), ("jax", j)):
            files = _content_files(e["content"]["root"])
            # None: a vacuumed entry still lists the files it deleted.
            shas.append({os.path.relpath(p, self.root(pkg)): _sha(p) if os.path.exists(p) else None for p in files})
        assert shas[0] == shas[1]
        return t

    def query(self, build, index=None):
        """Both packages' rows of `build(read, col)`, equal and in order; the
        port's plan must scan `index` when one is named."""
        tq = build(lambda p: self.t.read.parquet(p), hst.col)
        jq = build(lambda p: self.j.read.parquet(p), jax_col)
        if index is not None:
            assert f"index={index}" in tq.explain_string(), tq.explain_string()
        got, want = _host(tq.collect()), _host(jq.collect())
        assert got == want
        assert tq.count() == len(next(iter(want.values())))
        return got


def _content_files(node, prefix=""):
    base = os.path.join(prefix, node["name"]) if prefix else node["name"]
    out = [os.path.join(base, f["name"]) for f in node["files"]]
    for d in node["subDirs"]:
        out += _content_files(d, base)
    return sorted(out)


def _sha(path):
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


def _src(tmp_path, name="t"):
    """test_live_tables.py's two-file source."""
    src = str(tmp_path / name)
    write(src, "part-00000.parquet", {"k": np.array([1, 2, 3, 4]), "v": np.array(["a", "b", "c", "d"])})
    write(src, "part-00001.parquet", {"k": np.array([5, 6]), "v": np.array(["e", "f"])})
    return src


def point(src, k):
    return lambda rd, c: rd(src).filter(c("k") == k).select("k", "v")


def scan_all(src):
    return lambda rd, c: rd(src).filter(c("k") >= 0).select("k", "v")


def version_dirs(entry):
    return sorted({p.split("v__=")[1].split(os.sep)[0] for p in _content_files(entry["content"]["root"])})


# ---------------------------------------------------------------------------
# test_live_tables.py TestDeleteFolding, each step in both packages
# ---------------------------------------------------------------------------


def test_incremental_folds_deletes_with_lineage(tmp_path):
    src, tw = _src(tmp_path), Twin(tmp_path)
    tw.create(src, "live", ["k"], ["v"])
    tw.assert_same("live")
    write(src, "part-00002.parquet", {"k": np.array([7, 8]), "v": np.array(["g", "h"])})
    os.remove(os.path.join(src, "part-00001.parquet"))
    assert tw.refresh("live", "incremental") is None
    e = tw.assert_same("live")
    assert e["extra"]["deletedSourceFiles"] == [os.path.join(src, "part-00001.parquet")]
    assert version_dirs(e) == ["0", "1"]
    rows = tw.query(scan_all(src), "live")
    assert sorted(zip(rows["k"], rows["v"])) == [(1, "a"), (2, "b"), (3, "c"), (4, "d"), (7, "g"), (8, "h")]
    assert tw.query(point(src, 5), "live") == {"k": [], "v": []}


def test_join_prunes_folded_deletes(tmp_path):
    src, tw = _src(tmp_path, "l"), Twin(tmp_path)
    r = str(tmp_path / "r")
    write(r, "part-00000.parquet", {"k2": np.array([1, 2, 5, 7]), "w": np.array([10, 20, 50, 70])})
    tw.create(src, "jl", ["k"], ["v"])
    tw.create(r, "jr", ["k2"], ["w"])
    write(src, "part-00002.parquet", {"k": np.array([7]), "v": np.array(["g"])})
    os.remove(os.path.join(src, "part-00001.parquet"))  # rows k=5,6
    tw.refresh("jl", "incremental")
    tw.assert_same("jl")
    rows = tw.query(lambda rd, c: rd(src).join(rd(r), c("k") == c("k2")).select("k", "v", "w"), "jl")
    assert sorted(zip(rows["k"], rows["v"], rows["w"])) == [(1, "a", 10), (2, "b", 20), (7, "g", 70)]


def test_deletes_only_is_metadata_only_refresh(tmp_path):
    src, tw = _src(tmp_path), Twin(tmp_path)
    tw.create(src, "del", ["k"], ["v"])
    before = _content_files(tw.entries("del")[0]["content"]["root"])
    os.remove(os.path.join(src, "part-00001.parquet"))
    tw.refresh("del", "incremental")
    e = tw.assert_same("del")
    assert _content_files(e["content"]["root"]) == before  # no new version directory
    assert not os.path.exists(os.path.join(tw.root("torch"), "del", "v__=1"))
    assert e["extra"]["deletedSourceFiles"] == [os.path.join(src, "part-00001.parquet")]
    assert tw.query(point(src, 5), "del") == {"k": [], "v": []}


def test_reappeared_deleted_path_rejects_as_modified(tmp_path):
    src, tw = _src(tmp_path), Twin(tmp_path)
    tw.create(src, "re", ["k"], ["v"])
    gone = os.path.join(src, "part-00001.parquet")
    os.remove(gone)
    tw.refresh("re", "incremental")
    write(src, "part-00001.parquet", {"k": np.array([11]), "v": np.array(["z"])})
    kind, msg = tw.refresh("re", "incremental")
    assert kind == "HyperspaceException" and "modified" in msg
    assert tw.refresh("re", "auto") is None  # falls back to full
    e = tw.assert_same("re")
    assert "deletedSourceFiles" not in e["extra"]
    assert tw.query(point(src, 11), "re") == {"k": [11], "v": ["z"]}
    assert tw.query(point(src, 5), "re") == {"k": [], "v": []}


def test_auto_mode_rebuilds_a_quarantined_fresh_index(tmp_path):
    src, tw = _src(tmp_path), Twin(tmp_path)
    tw.create(src, "qa", ["k"], ["v"])
    quarantine.mark("qa", reason="test corruption")
    jax_quarantine.mark("qa", reason="test corruption")
    id_before = tw.entries("qa")[0]["id"]
    # A quarantined index is no candidate: the query reads the source.
    assert "index=qa" not in tw.t.read.parquet(src).filter(hst.col("k") == 1).select("v").explain_string()
    tw.refresh("qa", "auto")
    assert not quarantine.is_quarantined("qa") and not jax_quarantine.is_quarantined("qa")
    assert tw.assert_same("qa")["id"] > id_before  # a rebuild, not a no-op
    tw.query(point(src, 1), "qa")


def test_rejects_deletes_without_lineage(tmp_path):
    src, tw = _src(tmp_path), Twin(tmp_path, lineage=False)
    tw.create(src, "nolin", ["k"], ["v"])
    os.remove(os.path.join(src, "part-00001.parquet"))
    kind, msg = tw.refresh("nolin", "incremental")
    assert "lineage" in msg
    assert tw.assert_same("nolin")["state"] == "ACTIVE"  # refused before begin()
    tw.refresh("nolin", "full")
    assert "deletedSourceFiles" not in tw.assert_same("nolin")["extra"]
    tw.query(scan_all(src), "nolin")


def test_full_refresh_clears_folded_set(tmp_path):
    src, tw = _src(tmp_path), Twin(tmp_path)
    tw.create(src, "fr", ["k"], ["v"])
    os.remove(os.path.join(src, "part-00001.parquet"))
    tw.refresh("fr", "incremental")
    assert tw.assert_same("fr")["extra"]["deletedSourceFiles"]
    tw.refresh("fr", "full")
    e = tw.assert_same("fr")
    assert "deletedSourceFiles" not in e["extra"] and version_dirs(e) == ["1"]
    # The rewrite equals a from-scratch build of the same source, file for file.
    oracle = Twin(tmp_path / "oracle")
    oracle.create(src, "fr", ["k"], ["v"])
    o = oracle.assert_same("fr")
    assert sorted(_sha(p) for p in _content_files(e["content"]["root"])) == sorted(
        _sha(p) for p in _content_files(o["content"]["root"]))


def test_missing_file_inventory_is_a_clear_error(tmp_path):
    src, tw = _src(tmp_path), Twin(tmp_path)
    tw.create(src, "nosig", ["k"], ["v"])
    for pkg in ("torch", "jax"):  # an older writer that recorded no inventory
        log = os.path.join(tw.root(pkg), "nosig", "_hyperspace_log")
        for name in ("1", "latestStable"):
            d = json.load(open(os.path.join(log, name)))
            root = d["source"]["plan"]["properties"]["relations"][0]["data"]["properties"]["content"]["root"]
            root["files"], root["subDirs"] = [], []
            json.dump(d, open(os.path.join(log, name), "w"))
    write(src, "part-00002.parquet", {"k": np.array([9]), "v": np.array(["i"])})
    kind, msg = tw.refresh("nosig", "incremental")
    assert "per-file source signatures" in msg


def test_modified_in_place_still_rejects(tmp_path):
    src, tw = _src(tmp_path), Twin(tmp_path)
    tw.create(src, "mod2", ["k"], ["v"])
    time.sleep(0.01)  # an mtime tick
    torch_io.write_parquet(
        Table.from_pydict({"k": np.array([1]), "v": np.array(["x"])}, "cpu"), os.path.join(src, "part-00000.parquet")
    )
    kind, msg = tw.refresh("mod2", "incremental")
    assert "modified" in msg


def test_auto_mode_routes(tmp_path):
    src, tw = _src(tmp_path), Twin(tmp_path)
    tw.create(src, "auto", ["k"], ["v"])
    id_before = tw.entries("auto")[0]["id"]
    tw.refresh("auto", "auto")  # fresh: nothing happens
    assert tw.assert_same("auto")["id"] == id_before
    write(src, "part-00002.parquet", {"k": np.array([9]), "v": np.array(["i"])})
    tw.refresh("auto", "auto")  # appended: incremental
    assert version_dirs(tw.assert_same("auto")) == ["0", "1"]
    time.sleep(0.01)
    torch_io.write_parquet(
        Table.from_pydict({"k": np.array([1, 2, 3, 4]), "v": np.array(["A", "b", "c", "d"])}, "cpu"),
        os.path.join(src, "part-00000.parquet"),
    )
    tw.refresh("auto", "auto")  # modified in place: full
    assert version_dirs(tw.assert_same("auto")) == ["2"]
    assert tw.query(point(src, 1), "auto") == {"k": [1], "v": ["A"]}


def test_refresh_mode_env_default(tmp_path, monkeypatch):
    src, tw = _src(tmp_path), Twin(tmp_path)
    tw.create(src, "envm", ["k"], ["v"])
    write(src, "part-00002.parquet", {"k": np.array([9]), "v": np.array(["i"])})
    monkeypatch.setenv("HYPERSPACE_REFRESH_MODE", "incremental")
    tw.both("refresh_index", "envm")  # mode None: the environment's
    assert version_dirs(tw.assert_same("envm")) == ["0", "1"]
    monkeypatch.delenv("HYPERSPACE_REFRESH_MODE")
    tw.both("refresh_index", "envm")  # unset: full
    assert version_dirs(tw.assert_same("envm")) == ["2"]
    assert tw.refresh("envm", "sideways")[0] == "HyperspaceException"


# ---------------------------------------------------------------------------
# test_live_tables.py TestRaces :510-:580, without compaction or faults
# ---------------------------------------------------------------------------


def test_readers_stay_correct_across_refresh_generations(tmp_path):
    src, tw = _src(tmp_path), Twin(tmp_path)
    tw.create(src, "rd", ["k"], ["v"])
    stop, failures = threading.Event(), []

    def read_loop():
        while not stop.is_set():
            try:
                rows = _host(tw.t.read.parquet(src).filter(hst.col("k") == 1).select("k", "v").collect())
                if rows != {"k": [1], "v": ["a"]}:
                    failures.append(rows)
            except Exception as e:  # noqa: BLE001
                failures.append(e)

    reader = threading.Thread(target=read_loop)
    reader.start()
    try:
        for i in range(3):
            write(src, f"part-1000{i}.parquet", {"k": np.array([100 + i]), "v": np.array([f"x{i}"])})
            tw.th.refresh_index("rd", "incremental")
        tw.th.refresh_index("rd", "full")
    finally:
        stop.set()
        reader.join(timeout=60)
    assert failures == []
    for i in range(3):
        tw.jh.refresh_index("rd", "incremental" if i == 0 else "full")
    tw.jh.refresh_index("rd", "full")  # the same number of log entries
    tw.query(scan_all(src), "rd")


def test_readers_keep_stable_generation_during_writer_window(tmp_path):
    """A refresh that died after begin() leaves a transient REFRESHING entry
    as the log's latest: readers ride the last committed generation."""
    from hyperspace_tpu.actions.refresh import RefreshIncrementalAction as JaxIncremental
    from hyperspace_tpu.index.builder import CoveringIndexBuilder as JaxBuilder
    from hyperspace_tpu.index.log_manager import IndexLogManagerImpl as JaxLog
    from hyperspace_tpu_torch.actions.refresh import RefreshIncrementalAction
    from hyperspace_tpu_torch.index.builder import CoveringIndexBuilder
    from hyperspace_tpu_torch.index.log_manager import IndexLogManagerImpl

    src, tw = _src(tmp_path), Twin(tmp_path)
    tw.create(src, "stab", ["k"], ["v"])
    os.remove(os.path.join(src, "part-00001.parquet"))
    tw.refresh("stab", "incremental")
    write(src, "part-00002.parquet", {"k": np.array([7]), "v": np.array(["g"])})
    for pkg, action, builder, log, s in (
        ("torch", RefreshIncrementalAction, CoveringIndexBuilder, IndexLogManagerImpl, tw.t),
        ("jax", JaxIncremental, JaxBuilder, JaxLog, tw.j),
    ):
        path = os.path.join(tw.root(pkg), "stab")
        action(builder(s), log(path), path, os.path.join(path, "v__=9")).begin()
    t, j = tw.entries("stab")
    assert t["state"] == j["state"] == "REFRESHING"
    assert tw.normalized(t, "torch") == tw.normalized(j, "jax")
    active = [e for e in tw.th._manager.get_indexes(["ACTIVE"]) if e.name == "stab"]
    assert len(active) == 1 and active[0].id == 3
    # The appended file makes the source stale, so no rule fires; the stable
    # generation still answers a query over the source it covers.
    os.remove(os.path.join(src, "part-00002.parquet"))
    assert tw.query(point(src, 1), "stab") == {"k": [1], "v": ["a"]}
    assert tw.query(point(src, 5), "stab") == {"k": [], "v": []}


def test_quarantine_clears_on_new_generation(tmp_path):
    src, tw = _src(tmp_path), Twin(tmp_path)
    tw.create(src, "qr", ["k"], ["v"])
    quarantine.mark("qr", reason="test corruption")
    assert quarantine.is_quarantined("qr") and quarantine.stats()["active"] == 1
    write(src, "part-00002.parquet", {"k": np.array([7]), "v": np.array(["g"])})
    tw.th.refresh_index("qr", "incremental")
    assert not quarantine.is_quarantined("qr")


# ---------------------------------------------------------------------------
# Reads of a two-version index
# ---------------------------------------------------------------------------


def _keyed(rng, keys):
    return {"k": np.asarray(keys, np.int64), "x": rng.rand(len(keys)), "s": np.array(["p", "q", "r"])[np.arange(len(keys)) % 3]}


def _join_lake(tmp_path, appended_keys, num_buckets=4, rg_rows=None, monkeypatch=None):
    """l: 600 rows of even keys 0..398 over two files, indexed; r: every key
    0..499, indexed; then `appended_keys` land in a third file of l and an
    incremental refresh gives l's index its second version."""
    if rg_rows is not None:
        monkeypatch.setenv("HYPERSPACE_INDEX_ROW_GROUP_ROWS", str(rg_rows))
    rng = np.random.RandomState(5)
    src, r = str(tmp_path / "l"), str(tmp_path / "r")
    keys = np.sort(np.repeat(np.arange(0, 400, 2), 3))
    write(src, "part-00000.parquet", _keyed(rng, keys[:300]))
    write(src, "part-00001.parquet", _keyed(rng, keys[300:]))
    write(r, "part-00000.parquet", {"k2": np.arange(500, dtype=np.int64), "w": rng.rand(500)})
    tw = Twin(tmp_path, num_buckets=num_buckets)
    tw.create(src, "li2", ["k"], ["x", "s"])
    tw.create(r, "ri2", ["k2"], ["w"])
    write(src, "part-00002.parquet", _keyed(rng, appended_keys))
    tw.refresh("li2", "incremental")
    tw.assert_same("li2")
    return tw, src, r


def _join_mode(session, df):
    join = next(n for n in df.physical_plan().collect_nodes() if isinstance(n, SortMergeJoinExec))
    if not join.bucketed:
        return "general"
    left, right, ls, rs, subkey, rows_key = join._sides(ExecContext(session))
    return join._plan_and_ranges(left, right, ls, rs, subkey, rows_key)[0].mode


def join_query(src, r):
    return lambda rd, c: rd(src).join(rd(r), c("k") == c("k2")).select("k", "x", "s", "w")


@pytest.mark.parametrize(
    "case,appended,mode",
    [
        ("above every key", [401, 403, 405, 407, 409, 411], "value"),
        ("one bucket out of order", [1], "hash"),
        ("every bucket", list(range(1, 400, 7)), "hash"),
    ],
)
def test_a_two_version_index_joins_in_value_mode_only_while_every_bucket_is_sorted(tmp_path, case, appended, mode):
    """Value mode needs each bucket sorted by the key (`value_mode_vals`); a
    second version appends its rows after the first's in every bucket it
    touches. Keys above every indexed key keep the buckets sorted; one key
    below them breaks one bucket, and then the side — and its partner —
    pads by key64 hash (K1, then K2)."""
    tw, src, r = _join_lake(tmp_path, appended)
    df = join_query(src, r)(lambda p: tw.t.read.parquet(p), hst.col)
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()
    rows = tw.query(join_query(src, r), "li2")
    assert len(rows["k"]) == 600 + sum(1 for k in appended if k < 500)
    assert _join_mode(tw.t, df) == mode
    scan = next(n for n in df.physical_plan().collect_nodes() if isinstance(n, physical.BucketedIndexScanExec)
                and n.relation.index_name == "li2")
    table, starts = scan.execute_concat(ExecContext(tw.t))
    per_bucket = [value_mode_vals(table.column("k").data[a:b], np.array([0, b - a]))
                  for a, b in zip(starts[:-1], starts[1:])]
    unsorted = sum(v is None for v in per_bucket)
    assert (unsorted == 0) == (mode == "value")
    if case == "one bucket out of order":
        assert unsorted == 1
    assert len({p.split("v__=")[1][0] for p in (f.path for f in scan.relation.files)}) == 2


def test_a_two_version_index_answers_filters_and_pruned_bucketed_scans(tmp_path, monkeypatch):
    """The filter rule's plain scan of both versions, and the filtered
    bucketed scan whose row groups the zone maps prune (16-row groups),
    equal the JAX package's rows in order; the pruned scan equals the scan
    with pushdown off and skips row groups."""
    tw, src, r = _join_lake(tmp_path, list(range(1, 400, 7)), rg_rows=16, monkeypatch=monkeypatch)
    tw.query(lambda rd, c: rd(src).filter(c("k").isin(1, 8, 50, 393)).select("k", "x", "s"), "li2")
    tw.query(lambda rd, c: rd(src).filter((c("k") >= 100) & (c("k") < 140)).select("k", "s"), "li2")
    pruned = lambda rd, c: (  # noqa: E731
        rd(src).filter(c("k") < 60).join(rd(r), c("k") == c("k2")).select("k", "x", "w"))
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()
    before = torch_io.io_stats()["row_groups_skipped"]
    rows = tw.query(pruned, "li2")
    assert torch_io.io_stats()["row_groups_skipped"] > before
    monkeypatch.setenv("HYPERSPACE_SCAN_PUSHDOWN", "0")
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()
    assert _host(pruned(lambda p: tw.t.read.parquet(p), hst.col).collect()) == rows


def test_folded_deletes_prune_the_two_version_join_in_hash_mode(tmp_path):
    """Step (d) of `chip_smoke.py` phase refresh at a small size: a deletes-
    only auto refresh over a two-version index; the join prunes the deleted
    file's rows through the lineage column, in hash mode, and equals numpy."""
    tw, src, r = _join_lake(tmp_path, list(range(1, 400, 7)))
    os.remove(os.path.join(src, "part-00000.parquet"))
    tw.refresh("li2", "auto")
    e = tw.assert_same("li2")
    assert e["extra"]["deletedSourceFiles"] == [os.path.join(src, "part-00000.parquet")]
    assert version_dirs(e) == ["0", "1"]
    rows = tw.query(join_query(src, r), "li2")
    kept = np.concatenate([np.sort(np.repeat(np.arange(0, 400, 2), 3))[300:], np.arange(1, 400, 7)])
    assert sorted(rows["k"]) == sorted(kept.tolist())
    assert _join_mode(tw.t, join_query(src, r)(lambda p: tw.t.read.parquet(p), hst.col)) == "hash"
    tw.refresh("li2", "full")
    assert _join_mode(tw.t, join_query(src, r)(lambda p: tw.t.read.parquet(p), hst.col)) == "value"
    tw.query(join_query(src, r), "li2")


@pytest.mark.parametrize("reader", ["torch", "jax"])
def test_merged_entries_round_trip_byte_for_byte_in_either_package(tmp_path, reader):
    """A two-version entry with folded deletes, as each package wrote it,
    parsed by `reader` and written again, is the same text: each package
    reads and rewrites the other's log without a byte changed."""
    from hyperspace_tpu.index.log_entry import LogEntry as JaxLogEntry
    from hyperspace_tpu.util import json_utils as jax_json
    from hyperspace_tpu_torch.index.log_entry import LogEntry
    from hyperspace_tpu_torch.util import json_utils

    src, tw = _src(tmp_path), Twin(tmp_path)
    tw.create(src, "rt", ["k"], ["v"])
    write(src, "part-00002.parquet", {"k": np.array([7]), "v": np.array(["g"])})
    os.remove(os.path.join(src, "part-00001.parquet"))
    tw.refresh("rt", "incremental")
    parse, dump = (LogEntry.from_json, json_utils.to_json) if reader == "torch" else (
        JaxLogEntry.from_json, jax_json.to_json)
    for pkg in ("torch", "jax"):
        log = os.path.join(tw.root(pkg), "rt", "_hyperspace_log")
        for name in ("2", "3", "latestStable"):
            text = open(os.path.join(log, name)).read()
            entry = parse(text)
            assert dump(entry.to_json()) == text, (pkg, name)
            assert entry.deleted_source_files() == [os.path.join(src, "part-00001.parquet")]
            assert entry.has_lineage()


@pytest.mark.parametrize("query", ["filter", "join"])
def test_the_rankers_prefer_the_index_with_fewer_folded_deletes(tmp_path, query):
    """Two covering indexes on `k`: `folded` (created first, a file deleted and
    folded since) and `fresh` (created after the delete). Both are exact
    candidates; the filter ranker and the join pair ranker pick `fresh` in
    both packages, as their name order alone would not."""
    src, tw = _src(tmp_path), Twin(tmp_path)
    r = str(tmp_path / "r")
    write(r, "part-00000.parquet", {"k2": np.array([1, 2, 3, 4, 5]), "w": np.array([10, 20, 30, 40, 50])})
    tw.create(r, "ri", ["k2"], ["w"])
    tw.create(src, "aFolded", ["k"], ["v"])
    os.remove(os.path.join(src, "part-00001.parquet"))
    tw.refresh("aFolded", "incremental")
    tw.create(src, "bFresh", ["k"], ["v"])
    build = point(src, 3) if query == "filter" else (
        lambda rd, c: rd(src).join(rd(r), c("k") == c("k2")).select("k", "v", "w"))
    rows = tw.query(build, "bFresh")
    assert rows["k"] == ([3] if query == "filter" else rows["k"]) and 5 not in rows["k"]


def test_a_file_gone_between_listing_and_stat_is_not_listed(tmp_path, monkeypatch):
    """A writer's temp file renamed away after `os.listdir` saw it: the
    listing leaves it out instead of failing the reader's query (the race of
    `test_readers_stay_correct_across_refresh_generations`)."""
    from hyperspace_tpu_torch.storage.filesystem import LocalFileSystem

    write(str(tmp_path), "part-00000.parquet", {"k": np.array([1])})
    listdir = os.listdir
    monkeypatch.setattr(os, "listdir", lambda p: listdir(p) + ["part-00001.parquet.tmp"])
    assert [os.path.basename(st.path) for st in LocalFileSystem().list_status(str(tmp_path))] == ["part-00000.parquet"]

"""The port's index build against the JAX package's build routes.

Counterpart of `tests/test_build_pipeline.py`. The port has one build route
(`index/builder.py`, then `index/build_pipeline.pipelined_write`); its sort
takes K1 on (bucket, key, row) composites for one integer key of at most
32,768 rows (`partition.composite_build_sort`), else K3 or the stable sort
chain, and its bucket writer prepares one arrow array per column of each
copy range and writes each bucket's zero-copy slices on the writer pool.
Source files are made with numpy from a seed and written once, by the
port's parquet writer: 5 files of 1,200 rows (two copy ranges), 8 buckets.
Each case builds one index eight ways and holds the index files' sha256 and
the log entries equal:

- the port: its build, the same with one decode worker
  (`HYPERSPACE_BUILD_DECODE_THREADS=1`), and the same with the composite
  sort declined (`partition.composite_build_sort` patched to return None),
  so that the stable sort chain orders the rows; the sort route each reports
  is checked too;
- the JAX package (`HYPERSPACE_DISTRIBUTED=0`): its serial route, its
  pipelined CPU route at its default decode pool and at
  `DECODE_THREADS=3` (chunks of 1,000 rows through
  `HYPERSPACE_BUILD_CHUNK_ROWS`), and its fused device program
  (`HYPERSPACE_FORCE_DEVICE_OPS=1`), the last with and without its Pallas
  composite sort in interpret mode (`HYPERSPACE_PALLAS_SORT=1`).

The cases cover integer, float, two and string keys, nullable number and
string columns, lineage, a Hive-partitioned source (with and without
lineage), an empty bucket, `HYPERSPACE_ENCODED_EXEC` on (the default) and
off, and `HYPERSPACE_BUILD_WRITERS` at 1 and at its default.

`composite_build_sort` is held to `sort_perm` and to the JAX package's
`pallas_composite_build_sort` in interpret mode (as
`tests/test_build_pipeline.py:161-189` runs it), and to its refusals.
"""

import hashlib
import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hyperspace_tpu_torch as hst
from hyperspace_tpu import IndexConfig as JaxIndexConfig
from hyperspace_tpu import IndexConstants as JaxIndexConstants
from hyperspace_tpu.engine import HyperspaceSession as JaxSession
from hyperspace_tpu.engine.scan_cache import global_concat_cache, global_scan_cache
from hyperspace_tpu.engine.table import Column as JaxColumn
from hyperspace_tpu.hyperspace import Hyperspace as JaxHyperspace
from hyperspace_tpu.ops.hashing import bucket_id as jax_bucket_id
from hyperspace_tpu.ops.partition import pallas_composite_build_sort
from hyperspace_tpu.telemetry.profiling import last_build_stages as jax_last_build_stages
from hyperspace_tpu_torch.engine import io as torch_io
from hyperspace_tpu_torch.engine import physical, scan_cache
from hyperspace_tpu_torch.engine.table import Table
from hyperspace_tpu_torch.index import build_pipeline
from hyperspace_tpu_torch.ops import partition
from hyperspace_tpu_torch.ops.cuda_sort import LABEL as K1_LABEL
from hyperspace_tpu_torch.ops.hashing import bucket_id
from hyperspace_tpu_torch.ops.partition import composite_build_sort, sort_perm
from hyperspace_tpu_torch.telemetry.profiling import build_stages_history, last_build_stages
from test_torch_build import _normalized

NUM_BUCKETS = 8
INCLUDED = ["v", "f"]


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    monkeypatch.setenv("HYPERSPACE_BUILD_CHUNK_ROWS", "1000")  # the JAX package's pipelined routes chunk
    for k in ("HYPERSPACE_BUILD_DECODE_THREADS", "HYPERSPACE_FORCE_DEVICE_OPS", "HYPERSPACE_PALLAS_SORT"):
        monkeypatch.delenv(k, raising=False)


def _fresh_caches():
    """Empty both packages' decode and concat caches: the next build is cold."""
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()
    global_scan_cache().clear()
    cc = global_concat_cache()
    budget = cc.stats()["budget"]
    cc.set_capacity(0)
    cc.set_capacity(budget)


def _write_source(src, n=6000, n_files=5, seed=3, strings=False, nulls=False, hive=False, k_range=(-100, 200)):
    """`n_files` files of keys with heavy duplicates: `k` (int64 in
    `k_range`, or strings, nullable with `nulls`), `k2` (a second int key),
    `kf` (floats with signed zeros and NaNs), `v` (int64, nullable with
    `nulls`) and `f` (float). With `hive`, file i lies under `p=<i % 2>/`."""
    rng = np.random.RandomState(seed)
    per = n // n_files
    for i in range(n_files):
        k = rng.randint(*k_range, per).astype(np.int64)
        if strings:
            k = np.array([f"key-{x:04d}" for x in k])
        kf = np.round(rng.randn(per) * 20, 1)
        kf[rng.rand(per) < 0.05] = np.nan
        kf[rng.rand(per) < 0.05] = -0.0
        d = {"k": k, "k2": rng.randint(-5, 5, per).astype(np.int64), "kf": kf,
             "v": rng.randint(0, 100, per).astype(np.int64), "f": rng.rand(per)}
        if nulls:
            for name in ("k", "v"):
                vals = d[name].astype(object)
                vals[rng.rand(per) < 0.1] = None
                d[name] = vals
        part = os.path.join(src, f"p={i % 2}") if hive else src
        torch_io.write_parquet(Table.from_pydict(d, "cpu"), os.path.join(part, f"part-{i:05d}.parquet"))


def _index_files(root, name="idx"):
    """sha256 of each index data file, by its path below the index."""
    idir = os.path.join(root, name)
    out = {}
    for d, _, fs in os.walk(idir):
        for f in fs:
            if f.endswith(".parquet"):
                p = os.path.join(d, f)
                out[os.path.relpath(p, idir)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def _log(root, name="idx"):
    """The committed log entry, normalized (ids, times and file paths)."""
    return _normalized(json.loads(open(os.path.join(root, name, "_hyperspace_log", "1")).read()), root)


def _port_build(tmp_path, src, tag, indexed, lineage=False, num_buckets=NUM_BUCKETS, included=INCLUDED):
    base = str(tmp_path / tag)
    s = hst.HyperspaceSession(warehouse=base, device="cpu")
    s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, num_buckets)
    if lineage:
        s.conf.set(hst.IndexConstants.INDEX_LINEAGE_ENABLED, "true")
    hst.Hyperspace(s).create_index(s.read.parquet(src), hst.IndexConfig("idx", indexed, included))
    root = os.path.join(base, "indexes")
    return _index_files(root), _log(root), last_build_stages()


def _jax_build(tmp_path, src, tag, indexed, lineage=False, included=INCLUDED):
    base = str(tmp_path / tag)
    s = JaxSession(warehouse=base)
    s.conf.set(JaxIndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    if lineage:
        s.conf.set(JaxIndexConstants.INDEX_LINEAGE_ENABLED, "true")
    JaxHyperspace(s).create_index(s.read.parquet(src), JaxIndexConfig("idx", indexed, included))
    root = os.path.join(base, "indexes")
    return _index_files(root), _log(root), jax_last_build_stages()


#: variant → (source options, indexed columns, lineage, the port's sort route,
#: included columns, environment)
VARIANTS = {
    "ints": ({}, ["k"], False, "composite", INCLUDED, {}),
    "strings": ({"strings": True}, ["k"], False, "chain", INCLUDED, {}),
    "nulls": ({"nulls": True}, ["k"], False, "composite", INCLUDED, {}),
    "lineage": ({}, ["k"], True, "composite", INCLUDED, {}),
    "two_keys": ({}, ["k2", "k"], False, "chain", INCLUDED, {}),
    "float_key": ({}, ["kf"], False, "chain", INCLUDED, {}),
    "null_strings": ({"strings": True, "nulls": True}, ["v"], False, "composite", ["k", "k2", "f"], {}),
    "null_string_key": ({"strings": True, "nulls": True}, ["k"], False, "chain", ["k2", "v", "f"], {}),
    "decoded_strings": ({"strings": True, "nulls": True}, ["k"], False, "chain", ["k2", "v", "f"],
                        {"HYPERSPACE_ENCODED_EXEC": "0"}),
    "decoded_lineage": ({"nulls": True}, ["k"], True, "composite", INCLUDED, {"HYPERSPACE_ENCODED_EXEC": "0"}),
    "hive": ({"hive": True}, ["k"], False, "composite", ["v", "p"], {}),
    "hive_lineage": ({"hive": True, "strings": True}, ["k"], True, "chain", INCLUDED, {}),
    "empty_bucket": ({"k_range": (0, 3)}, ["k"], False, "composite", INCLUDED, {}),
    "one_writer": ({"nulls": True}, ["k"], False, "composite", INCLUDED, {"HYPERSPACE_BUILD_WRITERS": "1"}),
}


def _no_composite(*_args):
    """`composite_build_sort` declining every build: the chain sorts."""
    return None


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_build_is_sha256_identical_to_every_route(tmp_path, monkeypatch, variant):
    opts, indexed, lineage, route, included, env0 = VARIANTS[variant]
    src = str(tmp_path / "src")
    _write_source(src, **opts)
    got = {}

    def run(tag, env, build, **patches):
        with monkeypatch.context() as m:
            for k, v in {**env0, **env}.items():
                m.setenv(k, v)
            for attr, fn in patches.items():
                m.setattr(partition, attr, fn)
            _fresh_caches()
            got[tag] = build(tmp_path, src, tag, indexed, lineage, included=included)

    run("port", {}, _port_build)
    run("port_one_decoder", {"HYPERSPACE_BUILD_DECODE_THREADS": "1"}, _port_build)
    run("port_chain", {}, _port_build, composite_build_sort=_no_composite)
    run("jax_serial", {"HYPERSPACE_BUILD_DECODE_THREADS": "1"}, _jax_build)
    run("jax_default", {}, _jax_build)
    run("jax_pipelined", {"HYPERSPACE_BUILD_DECODE_THREADS": "3"}, _jax_build)
    run("jax_device", {"HYPERSPACE_BUILD_DECODE_THREADS": "3", "HYPERSPACE_FORCE_DEVICE_OPS": "1"}, _jax_build)
    run("jax_device_pallas", {"HYPERSPACE_BUILD_DECODE_THREADS": "3", "HYPERSPACE_FORCE_DEVICE_OPS": "1",
                              "HYPERSPACE_PALLAS_SORT": "1"}, _jax_build)

    files, log, _ = got["jax_serial"]
    if variant == "empty_bucket":  # three key values: at most three files
        assert 0 < len(files) <= 3
    else:
        assert len(files) == NUM_BUCKETS
    for tag, (f, lg, _stages) in got.items():
        assert f == files, tag
        assert lg == log, tag
    port, chain = got["port"][2], got["port_chain"][2]
    assert (port["mode"], port["sort_route"], port["rows"], port["files"]) == ("pipelined-cpu", route, 6000, 5)
    assert port["ranges"] == 2 and port["writers"] == int(env0.get("HYPERSPACE_BUILD_WRITERS", 8))
    assert port["stage_counts"]["write"] == len(files)
    assert got["port_one_decoder"][2]["sort_route"] == route and chain["sort_route"] == "chain"
    assert got["jax_default"][2]["mode"] == "pipelined-cpu"
    assert got["jax_device"][2]["mode"] == "pipelined-device" and got["jax_device"][2]["chunks"] == 10
    assert K1_LABEL not in port.get("launches", {})  # K1's plain version on the CPU: no launch


def test_a_build_warms_the_concat_cache_and_a_warm_build_equals_the_cold(tmp_path):
    """A build reads through `engine_io.read_files`: its read fills the
    concat cache, so a query of the same projection decodes nothing, and a
    build over the warm cache writes the cold build's files."""
    src = str(tmp_path / "src")
    _write_source(src)
    _fresh_caches()
    cold, _, stages = _port_build(tmp_path, src, "cold", ["k"])
    assert stages["stage_counts"]["decode"] == 1 and stages["decode_s"] > 0
    assert (stages["mode"], stages["ranges"], stages["decode_threads"]) == ("pipelined-cpu", 2, 5)
    cc = scan_cache.global_concat_cache()
    hits = cc.stats()["hits"]
    torch_io.reset_io_stats()
    s = hst.HyperspaceSession(warehouse=str(tmp_path / "scan"), device="cpu")
    assert s.read.parquet(src).select("k", "v", "f").collect().num_rows == 6000  # the build's projection
    assert cc.stats()["hits"] > hits and torch_io.io_stats()["decode_files"] == 0
    warm, _, _ = _port_build(tmp_path, src, "warm", ["k"])
    assert warm == cold and torch_io.io_stats()["decode_files"] == 0


COMPOSITE_CASES = {
    "dups": (5000, lambda rng, n: rng.randint(0, 300, n).astype(np.int64)),
    "negative": (3000, lambda rng, n: rng.randint(-(2**40), -(2**40) + 900, n).astype(np.int64)),
    "int32": (2000, lambda rng, n: rng.randint(-(2**31), 2**31 - 1, n).astype(np.int32)),
    "n129": (129, lambda rng, n: rng.randint(0, 7, n).astype(np.int64)),
    "n32768": (32768, lambda rng, n: rng.randint(-500, 500, n).astype(np.int64)),
}


@pytest.mark.parametrize("case", list(COMPOSITE_CASES))
def test_composite_build_sort_equals_sort_perm_and_the_jax_kernel(monkeypatch, case):
    monkeypatch.setenv("HYPERSPACE_PALLAS_SORT", "1")
    n, make = COMPOSITE_CASES[case]
    nb = 16
    key_np = make(np.random.RandomState(7), n)
    key = torch.from_numpy(key_np)
    b = bucket_id([key], nb)
    perm, sorted_b = composite_build_sort(b, key, n, nb)
    ref = sort_perm(b, [key])
    np.testing.assert_array_equal(perm.numpy(), ref.numpy())
    np.testing.assert_array_equal(sorted_b.numpy(), b[ref].numpy())
    jb = jax_bucket_id([JaxColumn.from_values(key_np)], [jnp.asarray(key_np)], nb)
    np.testing.assert_array_equal(np.asarray(jb), b.numpy())
    jperm, jsorted_b = pallas_composite_build_sort(jb, jnp.asarray(key_np), n, nb)
    np.testing.assert_array_equal(perm.numpy(), jperm)
    np.testing.assert_array_equal(sorted_b.numpy(), jsorted_b)


@pytest.mark.parametrize("case", ["n32769", "float", "bool", "headroom", "empty"])
def test_composite_build_sort_declines_where_the_jax_package_does(monkeypatch, case):
    monkeypatch.setenv("HYPERSPACE_PALLAS_SORT", "1")
    rng = np.random.RandomState(5)
    n = {"n32769": 32769, "empty": 0}.get(case, 1000)
    key_np = {
        "float": rng.randn(n),
        "bool": rng.rand(n) < 0.5,
        "headroom": rng.randint(-(2**62), 2**62, n, dtype=np.int64),
    }.get(case, rng.randint(0, 50, n).astype(np.int64))
    key = torch.from_numpy(key_np)
    b = bucket_id([key], NUM_BUCKETS)
    assert composite_build_sort(b, key, n, NUM_BUCKETS) is None
    jb = jax_bucket_id([JaxColumn.from_values(key_np)], [jnp.asarray(key_np)], NUM_BUCKETS)
    assert pallas_composite_build_sort(jb, jnp.asarray(key_np), n, NUM_BUCKETS) is None


@pytest.mark.parametrize("rows, route", [(32768, "composite"), (32769, "chain")])
def test_small_integer_builds_sort_on_k1(tmp_path, monkeypatch, rows, route):
    """A one-integer-key build of at most 32,768 rows takes the composite
    sort, a larger one the stable sort chain; both write the chain's files."""
    src = str(tmp_path / "src")
    rng = np.random.RandomState(11)
    for i, part in enumerate(np.array_split(np.arange(rows), 3)):
        torch_io.write_parquet(Table.from_pydict({"k": rng.randint(0, 2000, len(part)).astype(np.int64),
                                                  "v": part.astype(np.int64), "f": rng.rand(len(part))}, "cpu"),
                               os.path.join(src, f"part-{i:05d}.parquet"))
    _fresh_caches()
    files, _, stages = _port_build(tmp_path, src, "port", ["k"], num_buckets=16)
    assert stages["sort_route"] == route and stages["rows"] == rows
    with monkeypatch.context() as m:
        m.setattr(partition, "composite_build_sort", _no_composite)
        _fresh_caches()
        chain, _, stages = _port_build(tmp_path, src, "chain", ["k"], num_buckets=16)
    assert stages["sort_route"] == "chain"
    assert files == chain and len(chain) == 16


def _build_threads():
    """The build's writer threads still alive."""
    return [t for t in threading.enumerate() if t.name.startswith("hs-build-")]


def _third_land_fails(real):
    """A copy whose third range fails to land (the first two were written or
    are being written), as a failed copy on the card raises at its event."""
    calls = []

    def land(self, r):
        calls.append(r)
        if len(calls) == 3:
            raise RuntimeError("copy down")
        return real(self, r)

    return land


def _prepare_fails_third(real):
    calls = []

    def prepare(self, host):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("prepare down")
        return real(self, host)

    return prepare


def _fails_on(real, path_part, what):
    def boom(*a, **k):
        if any(isinstance(x, str) and path_part in x for x in a):
            raise RuntimeError(f"{what} down")
        return real(*a, **k)

    return boom


#: stage → (owner, attribute, the replacement made from the real one, the error)
FAILURES = {
    "decode": (torch_io, "_read_arrow", lambda real: _fails_on(real, "part-00002", "_read_arrow"), "_read_arrow down"),
    "copy": (build_pipeline._HostCopy, "land", _third_land_fails, "copy down"),
    "prepare": (build_pipeline._BucketWriter, "prepare", _prepare_fails_third, "prepare down"),
    "write": (torch_io, "checked_write_table", lambda real: _fails_on(real, "part-00002", "checked_write_table"),
              "checked_write_table down"),
}


@pytest.mark.parametrize("stage", list(FAILURES), ids=list(FAILURES))
def test_a_failed_stage_leaves_no_index_file_and_no_log_entry(tmp_path, monkeypatch, stage):
    """A failure in the decode, a range's copy, a range's prepare or a
    bucket write (copy ranges of about 2,200 rows: the third range fails
    after earlier ranges' writes began) fails the build with no index file,
    no log entry and no writer thread left."""
    owner, attr, make, message = FAILURES[stage]
    src = str(tmp_path / "src")
    _write_source(src, n=20000)
    _fresh_caches()
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    base = str(tmp_path / "wh")
    s = hst.HyperspaceSession(warehouse=base, device="cpu")
    s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, 32)
    hs = hst.Hyperspace(s)
    with pytest.raises(Exception, match=message):
        hs.create_index(s.read.parquet(src), hst.IndexConfig("idx", ["k"], INCLUDED))
    idir = os.path.join(base, "indexes", "idx")
    leftovers = [f for _, _, fs in os.walk(idir) for f in fs if f.endswith(".parquet")]
    assert leftovers == []
    assert hs._manager.get_indexes(["ACTIVE"]) == []
    assert _build_threads() == []


def test_build_stages_carry_the_jax_packages_keys(tmp_path, monkeypatch):
    """The port's build summary has every key of the JAX package's serial
    route's summary, and of its default (pipelined) route's but the chunk
    count and the hash stage (the port hashes inside its sort stage and
    makes no chunks), under the default route's mode name and decode pool,
    plus its own."""
    src = str(tmp_path / "src")
    _write_source(src)
    monkeypatch.setenv("HYPERSPACE_BUILD_WRITERS", "2")
    _fresh_caches()
    _, _, port = _port_build(tmp_path, src, "port", ["k"])
    _fresh_caches()
    _, _, jax = _jax_build(tmp_path, src, "jax", ["k"])
    with monkeypatch.context() as m:
        m.setenv("HYPERSPACE_BUILD_DECODE_THREADS", "1")
        _fresh_caches()
        _, _, jax_serial = _jax_build(tmp_path, src, "jax_serial", ["k"])
    assert (jax["mode"], jax_serial["mode"]) == ("pipelined-cpu", "serial")
    assert set(jax_serial) - {"pallas_fallbacks"} <= set(port), set(jax_serial) - set(port)
    assert set(jax_serial["stage_counts"]) <= set(port["stage_counts"])
    assert set(jax) - {"pallas_fallbacks", "chunks", "hash_s"} <= set(port), set(jax) - set(port)
    assert set(jax["stage_counts"]) - {"hash"} <= set(port["stage_counts"])
    assert set(port["stage_counts"]) == {"decode", "sort", "take", "concat", "write"}
    assert (port["mode"], port["decode_threads"], port["writers"], port["rows"], port["files"]) == (
        jax["mode"], jax["decode_threads"], 2, 6000, 5)
    assert (port["sort_route"], port["ranges"], port["stage_counts"]["concat"]) == ("composite", 2, 2)
    assert port["stage_counts"]["take"] == 2  # the gather; the ranges' views
    assert port["stage_counts"]["write"] == NUM_BUCKETS and 0 < port["write_wall_s"] <= port["wall_s"]
    assert port == last_build_stages() == build_stages_history()[-1] and json.dumps(port)


@pytest.mark.parametrize("rows, writers, want", [(0, 8, [(0, 8)]), (6000, 8, [(0, 4), (4, 8)]),
                                                 (6000, 1, [(0, 4), (4, 8)]), (2047, 8, [(0, 8)]),
                                                 (80000, 8, None)])
def test_copy_ranges_cut_at_bucket_starts(rows, writers, want):
    """Ranges cover every bucket once, in order, at bucket starts: two for
    each writer, none under `RANGE_MIN_ROWS` rows but the last's rounding."""
    starts = np.linspace(0, rows, 9).astype(np.int64)
    ranges = build_pipeline.copy_ranges(starts, writers)
    if want is not None:
        assert ranges == want
    assert ranges[0][0] == 0 and ranges[-1][1] == 8
    assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(ranges, ranges[1:]))
    assert len(ranges) <= max(1, min(2 * writers, rows // build_pipeline.RANGE_MIN_ROWS))


def test_queries_over_a_composite_sorted_index_return_the_chain_sorted_rows(tmp_path, monkeypatch):
    """Queries over an index sorted on K1's composites return the rows of
    the same index sorted by the stable chain, and of the source."""
    src, dim = str(tmp_path / "src"), str(tmp_path / "dim")
    _write_source(src)
    torch_io.write_parquet(Table.from_pydict({"dk": np.arange(-100, 200, dtype=np.int64),
                                              "w": np.arange(300, dtype=np.int64) % 9}, "cpu"),
                           os.path.join(dim, "part-00000.parquet"))
    rows = {}
    for route in ("composite", "chain"):
        with monkeypatch.context() as m:
            if route == "chain":
                m.setattr(partition, "composite_build_sort", _no_composite)
            _fresh_caches()
            s = hst.HyperspaceSession(warehouse=str(tmp_path / route), device="cpu")
            s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
            hs = hst.Hyperspace(s)
            hs.create_index(s.read.parquet(src), hst.IndexConfig("liIdx", ["k"], ["v"]))
            assert last_build_stages()["sort_route"] == route
            hs.create_index(s.read.parquet(dim), hst.IndexConfig("dimIdx", ["dk"], ["w"]))
        q = s.read.parquet(src).join(s.read.parquet(dim), hst.col("k") == hst.col("dk")).select("v", "w")
        lookup = s.read.parquet(src).filter(hst.col("k") == 17).select("k", "v")
        hst.disable_hyperspace(s)
        rows["source"] = (sorted(q.collect().rows()), sorted(lookup.collect().rows()))
        hst.enable_hyperspace(s)
        assert "liIdx" in q.explain_string() and "liIdx" in lookup.explain_string()
        rows[route] = (q.collect().rows(), lookup.collect().rows())
    assert rows["composite"] == rows["chain"] and rows["composite"][0] and rows["composite"][1]
    assert (sorted(rows["chain"][0]), sorted(rows["chain"][1])) == rows["source"]

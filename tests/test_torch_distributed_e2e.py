"""The port's engine over a device mesh against the JAX package's, through
the public API.

Each case of `tests/test_distributed_e2e.py`, and the flag and traffic cases
of `tests/test_mesh_compile.py` :116-214 and :255-303,
`tests/test_encoded_device.py:286` and `tests/test_packed_codes.py:374`, runs
in both packages over one lake: the JAX package on the suite's 8 virtual CPU
devices, the port under `virtual_devices(8, "cpu")` (K1 and K2 in their plain
versions), both with `hyperspace.distributed.minRows` 0 and 16 buckets, as
`dist_session` sets them. The JAX package runs its device program
(`HYPERSPACE_FORCE_DEVICE_OPS=1`), whose group order the port shares.

- the index files are sha256-identical to the JAX package's mesh build and
  to the port's own single-device build, and the log entries are equal;
- joined rows equal the JAX package's in order (the mesh probe's pairs are
  bucket-major, each bucket in its left keys' hash order); float sums at
  rtol 1e-9 (`test_torch_aggregate.RTOL`), everything else exactly;
- the `parallel.exchange.*` counter deltas equal the JAX package's.

The JAX package's compile-once cases (`test_mesh_compile.py:70`, :216-253,
:305) have no counterpart: torch compiles no program.
"""

import glob
import hashlib
import json
import os
from collections import deque

import numpy as np
import pytest

import hyperspace_tpu_torch.parallel as tp
from hyperspace_tpu.engine import physical as jax_physical
from hyperspace_tpu.parallel import table_ops as jax_table_ops
from hyperspace_tpu.telemetry import metrics as jax_metrics
from hyperspace_tpu.telemetry import profiling as jax_profiling
from hyperspace_tpu.telemetry.profiling import last_build_stages as jax_last_build_stages
from hyperspace_tpu.telemetry.profiling import last_join_stages as jax_last_join_stages
from hyperspace_tpu_torch.engine import physical, scan_cache
from hyperspace_tpu_torch.parallel import table_ops
from hyperspace_tpu_torch.telemetry import metrics
from hyperspace_tpu_torch.telemetry import profiling as port_profiling
from hyperspace_tpu_torch.telemetry.profiling import last_build_stages, last_join_stages
from test_torch_aggregate import assert_same
from test_torch_star_join import _q2, _star2, make_star
from test_torch_udf_setops import Twin

#: The exchange's traffic counters, and the pad and code-staging ledgers'
#: entries of its site.
COUNTERS = {c: f"parallel.exchange.{c}" for c in ("rows", "bytes_payload", "bytes_moved", "count")}
COUNTERS.update({n: n for n in (
    "pad.mesh_exchange.bytes_payload", "pad.mesh_exchange.bytes_padded", "device.encoded.mesh_exchange.bytes_flat",
    "device.encoded.mesh_exchange.bytes_staged", "device.encoded.mesh_exchange.bytes_packed")})
WIRE_FLAGS = ("HYPERSPACE_ENCODED_DEVICE", "HYPERSPACE_PACKED_CODES")


@pytest.fixture(autouse=True)
def _on_the_mesh(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "1")
    monkeypatch.setenv("HYPERSPACE_FORCE_DEVICE_OPS", "1")
    for flag in WIRE_FLAGS + ("HYPERSPACE_JOIN_OUTLIER_FACTOR", "HYPERSPACE_MULTIWAY"):
        monkeypatch.delenv(flag, raising=False)
    _clear()
    with tp.virtual_devices(8, "cpu"):
        yield
    _clear()


def _clear():
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()
    jax_physical.clear_device_memos()


def mesh_twin(tmp_path, buckets=16, **conf):
    return Twin(tmp_path, buckets=buckets, DISTRIBUTED_MIN_ROWS=0, INDEX_CACHE_EXPIRY_DURATION_SECONDS=0, **conf)


def dept_emp(twin, n_dept=3000, n_emp=500):
    """`dist_session`'s lake (tests/test_distributed_e2e.py:27-56)."""
    rng = np.random.RandomState(3)
    twin.write("dept", {
        "deptId": rng.randint(0, 40, n_dept).astype(np.int64),
        "deptName": np.array([f"dept{i % 40}" for i in range(n_dept)]),
        "score": rng.rand(n_dept),
    })
    twin.write("emp", {"empId": np.arange(n_emp, dtype=np.int64),
                       "empDept": rng.randint(0, 40, n_emp).astype(np.int64)})


def join_q(p):
    return p.read("dept").join(p.read("emp"), p.col("deptId") == p.col("empDept")).select("deptName", "empId")


def index_both(twin, table, name, indexed, included):
    for p in (twin.t, twin.j):
        p.index(table, name, indexed, included)


def shas(p, name):
    """{path below the index directory: sha256} of an index's data files."""
    root = os.path.join(p.idx, name)
    return {os.path.relpath(f, root): hashlib.sha256(open(f, "rb").read()).hexdigest()
            for f in glob.glob(os.path.join(root, "**", "part-*.parquet"), recursive=True)}


def entry(p, name):
    """The index's latest log entry, its timestamp, warehouse and file
    times taken out (a two-version entry's tree names the warehouse)."""
    log = os.path.join(p.idx, name, "_hyperspace_log")
    d = json.load(open(os.path.join(log, str(max(int(n) for n in os.listdir(log) if n.isdigit())))))
    d.pop("timestamp")
    stack = [d["content"]["root"]]
    while stack:
        node = stack.pop()
        for f in node["files"]:
            f["modifiedTime"] = 0
        if node["name"] == p.name:  # the warehouse's own directory in a merged tree
            node["name"] = "<warehouse>"
        stack.extend(node["subDirs"])
    return json.dumps(d, sort_keys=True).replace(os.path.join(p.base, p.name), "<warehouse>")


def traffic(fn):
    """(fn(), the port's and the JAX package's deltas of `COUNTERS`)."""
    def snap(reg):
        return {c: reg.counter(name).value for c, name in COUNTERS.items()}

    t0, j0 = snap(metrics), snap(jax_metrics)
    out = fn()
    t1, j1 = snap(metrics), snap(jax_metrics)
    return out, {c: t1[c] - t0[c] for c in COUNTERS}, {c: j1[c] - j0[c] for c in COUNTERS}


def probes():
    return table_ops.DIST_JOIN_STATS["probes"], jax_table_ops.DIST_JOIN_STATS["probes"]


def single_device_shas(twin, monkeypatch, table, name, indexed, included):
    """The port's single-device build of the same index, in its own name."""
    with monkeypatch.context() as m:
        m.setenv("HYPERSPACE_DISTRIBUTED", "0")
        twin.t.index(table, name, indexed, included)
        assert last_build_stages()["mode"] == "pipelined-cpu"
    return shas(twin.t, name)


def key_source(kind, n, rng):
    if kind == "int":
        return rng.randint(0, 400, n).astype(np.int64)
    if kind == "float":
        v = np.round(rng.randn(n), 1)
        v[::13], v[::29], v[::37] = -0.0, 0.0, np.nan
        return v
    if kind == "string":
        return np.array([f"key{x:03d}" for x in rng.randint(0, 150, n)])
    v = rng.randint(0, 400, n).astype(object)
    v[rng.rand(n) < 0.1] = None
    return v


@pytest.mark.parametrize("kind", ["int", "float", "string", "nullable"])
def test_mesh_build_equals_jax_mesh_and_single_device(tmp_path, monkeypatch, kind):
    twin = mesh_twin(tmp_path)
    rng = np.random.RandomState(23)
    n = 6000
    twin.write("src", {"k": key_source(kind, n, rng), "v": np.arange(n, dtype=np.int64), "w": rng.rand(n)})
    (_, dt, dj) = traffic(lambda: index_both(twin, "src", "meshIdx", ["k"], ["v", "w"]))
    assert last_build_stages()["mode"] == jax_last_build_stages()["mode"] == "mesh"
    assert last_build_stages()["sort_route"] == "exchange"
    assert dt["rows"] == dj["rows"] == n and dt["count"] == dj["count"] == 1
    files = shas(twin.t, "meshIdx")
    assert files and files == shas(twin.j, "meshIdx")
    assert entry(twin.t, "meshIdx") == entry(twin.j, "meshIdx")
    assert single_device_shas(twin, monkeypatch, "src", "oneIdx", ["k"], ["v", "w"]) == files


def test_indexed_join_on_mesh_equals_jax(tmp_path, monkeypatch):
    twin = mesh_twin(tmp_path)
    dept_emp(twin)
    index_both(twin, "dept", "deptIdx", ["deptId"], ["deptName"])
    index_both(twin, "emp", "empIdx", ["empDept"], ["empId"])
    for p in (twin.t, twin.j):
        p.on(p.s)
    assert "bucketed, no exchange" in join_q(twin.t).explain_string()
    before = probes()
    got = twin.same(join_q)
    after = probes()
    assert got.num_rows > 0 and after[0] > before[0] and after[1] > before[1]
    assert join_q(twin.t).count() == join_q(twin.j).count() == got.num_rows
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    _clear()
    assert join_q(twin.t).collect().sorted_rows() == got.sorted_rows()


@pytest.mark.parametrize("wire", ["flat", "coded"])
def test_general_join_real_exchange_equals_jax(tmp_path, monkeypatch, wire):
    for flag in WIRE_FLAGS:
        monkeypatch.setenv(flag, "1" if wire == "coded" else "0")
    twin = mesh_twin(tmp_path)
    dept_emp(twin)
    assert "ShuffleExchange" in join_q(twin.t).explain_string()
    got, dt, dj = traffic(lambda: twin.same(join_q))
    assert got.num_rows > 0 and dt == dj and dt["count"] == 2
    assert join_q(twin.t).count() == join_q(twin.j).count() == got.num_rows
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    assert join_q(twin.t).collect().sorted_rows() == got.sorted_rows()


def test_filter_index_query_on_mesh(tmp_path):
    twin = mesh_twin(tmp_path)
    dept_emp(twin)
    index_both(twin, "dept", "fIdx", ["deptName"], ["deptId"])
    assert shas(twin.t, "fIdx") == shas(twin.j, "fIdx")

    def q(p):
        return p.read("dept").filter(p.col("deptName") == "dept7").select("deptId", "deptName")

    off = q(twin.t).collect().sorted_rows()
    for p in (twin.t, twin.j):
        p.on(p.s)
    assert "fIdx" in q(twin.t).explain_string()
    got = twin.same(q)
    assert got.num_rows > 0 and got.sorted_rows() == off


def test_mixed_mode_join_after_incremental_refresh(tmp_path):
    """One side's buckets become two files each: the mesh probe hashes both
    sides, and its rows equal the JAX package's."""
    twin = mesh_twin(tmp_path)
    dept_emp(twin)
    index_both(twin, "dept", "deptIdx", ["deptId"], ["deptName"])
    index_both(twin, "emp", "empIdx", ["empDept"], ["empId"])
    rng = np.random.RandomState(9)
    twin.write("emp", {"empId": np.arange(500, 800, dtype=np.int64),
                       "empDept": rng.randint(0, 40, 300).astype(np.int64)}, "part-00001.parquet")
    for p in (twin.t, twin.j):
        p.hs.refresh_index("empIdx", "incremental")
        p.hs.refresh_index("deptIdx", "full")
        p.on(p.s)
    assert shas(twin.t, "empIdx") == shas(twin.j, "empIdx")
    assert entry(twin.t, "empIdx") == entry(twin.j, "empIdx")
    assert "bucketed, no exchange" in join_q(twin.t).explain_string()
    got = twin.same(join_q)
    twin.t.off(twin.t.s)
    assert got.num_rows > 0 and join_q(twin.t).collect().sorted_rows() == got.sorted_rows()


def test_string_key_general_join_over_the_exchange(tmp_path, monkeypatch):
    twin = mesh_twin(tmp_path)
    dept_emp(twin)
    twin.write("budgets", {"deptName": np.array([f"dept{i % 50}" for i in range(200)]),
                           "budget": np.arange(200, dtype=np.int64)})

    def q(p):
        return p.read("dept").join(p.read("budgets"), p.col("deptName") == p.col("deptName")).select(
            "deptId", "budget")

    got, dt, dj = traffic(lambda: twin.same(q))
    assert got.num_rows > 0 and dt == dj and dt["count"] == 2
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    assert q(twin.t).collect().sorted_rows() == got.sorted_rows()


def test_nondivisible_bucket_count_takes_the_sharded_probe(tmp_path, monkeypatch):
    """20 buckets on 8 shards: padded with empty virtual buckets to 24."""
    twin = mesh_twin(tmp_path, buckets=20)
    dept_emp(twin)
    index_both(twin, "dept", "deptIdx20", ["deptId"], ["deptName"])
    index_both(twin, "emp", "empIdx20", ["empDept"], ["empId"])
    calls = {"n": 0, "none": 0}
    real = table_ops.probe_dist_blocks

    def spy(*a, **k):
        out = real(*a, **k)
        calls["n"] += 1
        calls["none"] += out is None
        return out

    monkeypatch.setattr(table_ops, "probe_dist_blocks", spy)
    for p in (twin.t, twin.j):
        p.on(p.s)
    got = twin.same(join_q)
    assert got.num_rows > 0 and calls["n"] > 0 and calls["none"] == 0
    assert all(shard["left"][0] == 3 for shard in table_ops.LAST_PROBE)


def test_steady_state_probes_without_rebuilding_blocks(tmp_path):
    twin = mesh_twin(tmp_path)
    dept_emp(twin)
    index_both(twin, "dept", "ssIdx1", ["deptId"], ["deptName"])
    index_both(twin, "emp", "ssIdx2", ["empDept"], ["empId"])
    twin.t.on(twin.t.s)
    stats = table_ops.DIST_JOIN_STATS
    pre = stats["probes"]
    expected = join_q(twin.t).count()
    b0, p0 = stats["block_builds"], stats["probes"]
    assert p0 > pre
    for _ in range(3):
        assert join_q(twin.t).count() == expected
    assert stats["block_builds"] == b0 and stats["probes"] == p0


def test_filtered_bucketed_join_on_mesh(tmp_path, monkeypatch):
    twin = mesh_twin(tmp_path)
    dept_emp(twin)
    index_both(twin, "dept", "dfDept", ["deptId"], ["deptName", "score"])
    index_both(twin, "emp", "dfEmp", ["empDept"], ["empId"])

    def q(p):
        return (p.read("dept").filter(p.col("score") > 0.5)
                .join(p.read("emp"), p.col("deptId") == p.col("empDept")).select("deptName", "empId"))

    for p in (twin.t, twin.j):
        p.on(p.s)
    joins = [n for n in q(twin.t).physical_plan().collect_nodes() if isinstance(n, physical.SortMergeJoinExec)]
    assert joins and joins[0].bucketed
    before = probes()[0]
    got = twin.same(q)
    assert got.num_rows > 0 and probes()[0] > before
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    _clear()
    assert q(twin.t).collect().sorted_rows() == got.sorted_rows()
    twin.t.off(twin.t.s)
    assert q(twin.t).collect().sorted_rows() == got.sorted_rows()


def test_distributed_flag_keeps_files_and_rows(tmp_path, monkeypatch):
    """HYPERSPACE_DISTRIBUTED=0 is the exact single-device fallback
    (tests/test_mesh_compile.py:139-214)."""
    twin = mesh_twin(tmp_path)
    dept_emp(twin)
    for name in ("meshIdx", "meshStr"):
        key, inc = (["deptId"], ["deptName"]) if name == "meshIdx" else (["deptName"], ["deptId"])
        twin.t.index("dept", name, key, inc)
        assert last_build_stages()["mode"] == "mesh"
        assert single_device_shas(twin, monkeypatch, "dept", name + "1", key, inc) == shas(twin.t, name)
    twin.t.index("emp", "empIdx", ["empDept"], ["empId"])
    twin.t.on(twin.t.s)

    def q():
        _clear()
        return join_q(twin.t).collect().sorted_rows()

    mesh_rows = q()
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    assert twin.t.s.mesh_for(10) is None
    assert q() == mesh_rows and len(mesh_rows) > 0
    twin.t.off(twin.t.s)
    assert q() == mesh_rows


def low_card(twin, n, card, seed):
    """A string key of `card` values and a payload (`_write_str_pair` and
    `_write_lowcard_pair` of the JAX package's tests)."""
    rng = np.random.RandomState(seed)
    twin.write(f"fact{card}", {"sk": np.array([f"k{v:03d}" for v in rng.randint(0, card, n)]),
                               "val": np.arange(n, dtype=np.int64)})


@pytest.mark.parametrize("encoded,packed", [("0", "0"), ("1", "0"), ("1", "1")], ids=["flat", "coded", "packed"])
def test_wire_flags_keep_files_and_traffic_equals_jax(tmp_path, monkeypatch, encoded, packed):
    monkeypatch.setenv("HYPERSPACE_ENCODED_DEVICE", encoded)
    monkeypatch.setenv("HYPERSPACE_PACKED_CODES", packed)
    twin = mesh_twin(tmp_path)
    low_card(twin, 3000, 12, 9)
    _, dt, dj = traffic(lambda: index_both(twin, "fact12", "pk", ["sk"], ["val"]))
    assert dt == dj and dt["bytes_moved"] >= dt["bytes_payload"] > 0
    files = shas(twin.t, "pk")
    assert files == shas(twin.j, "pk")
    with monkeypatch.context() as m:
        for flag in WIRE_FLAGS:
            m.setenv(flag, "0")
        assert single_device_shas(twin, monkeypatch, "fact12", "pk1", ["sk"], ["val"]) == files


def test_wire_flags_shrink_bytes_moved(tmp_path, monkeypatch):
    """The coded wire moves at least 2x fewer bytes than the flat one on a
    100-value key, and the packed wire at least 1.8x fewer than the coded
    one on a 12-value key (test_encoded_device.py:286, test_packed_codes.py:374)."""
    twin = mesh_twin(tmp_path)
    low_card(twin, 3000, 100, 9)
    low_card(twin, 3000, 12, 9)

    def moved(table, name, encoded, packed):
        monkeypatch.setenv("HYPERSPACE_ENCODED_DEVICE", encoded)
        monkeypatch.setenv("HYPERSPACE_PACKED_CODES", packed)
        _, dt, _ = traffic(lambda: twin.t.index(table, name, ["sk"], ["val"]))
        return dt["bytes_moved"]

    flat, coded = moved("fact100", "f", "0", "0"), moved("fact100", "c", "1", "0")
    assert flat / coded >= 2.0, (flat, coded)
    coded12, packed12 = moved("fact12", "c12", "1", "0"), moved("fact12", "p12", "1", "1")
    assert coded12 / packed12 >= 1.8, (coded12, packed12)
    assert shas(twin.t, "f") == shas(twin.t, "c") and shas(twin.t, "c12") == shas(twin.t, "p12")


def test_skewed_layout_stays_on_classed_executor(tmp_path, monkeypatch):
    """A 60%-hot key makes an outlier bucket: the sharded probe would pad
    every shard to it, so the join stays on the size-classed executor."""
    twin = mesh_twin(tmp_path)
    rng = np.random.RandomState(11)
    n = 4000
    keys = np.where(rng.rand(n) < 0.6, 7, rng.randint(0, 500, n)).astype(np.int64)
    twin.write("hotL", {"k": keys, "v": np.arange(n, dtype=np.int64)})
    twin.write("hotR", {"rk": keys[: n // 2], "w": np.arange(n // 2, dtype=np.int64)})
    index_both(twin, "hotL", "skL", ["k"], ["v"])
    index_both(twin, "hotR", "skR", ["rk"], ["w"])
    for p in (twin.t, twin.j):
        p.on(p.s)
    before = probes()

    def q(p):
        return p.read("hotL").join(p.read("hotR"), p.col("k") == p.col("rk")).select("v", "w")

    got = twin.same(q)
    assert got.num_rows > 0 and probes() == before


def test_star_query_on_mesh_runs_the_cascade(tmp_path, monkeypatch):
    """Under a mesh the star stream declines (streaming.py:605): both
    packages run the cascade of sharded co-bucketed joins, and the groups
    come in its key64 order. Each package's join-stage record starts empty,
    so that a star an earlier test of the process streamed is not read as
    this query's."""
    for mod in (port_profiling, jax_profiling):
        monkeypatch.setattr(mod, "_JOIN_STAGES", deque(maxlen=mod._JOIN_STAGES.maxlen))
    fact, dims = _star2()
    twin = make_star(tmp_path, fact, dims, DISTRIBUTED_MIN_ROWS=0)
    star = [n for n in _q2()(twin.t).physical_plan().collect_nodes() if isinstance(n, physical.MultiwayJoinExec)]
    assert star
    before = probes()
    got, want = twin.both(lambda p: _q2()(p).collect())
    assert_same(got, want)
    assert got.num_rows > 0 and probes()[0] > before[0] and probes()[1] > before[1]
    assert last_join_stages() is None or last_join_stages().get("join_mode") != "star"
    assert jax_last_join_stages() is None or jax_last_join_stages().get("join_mode") != "star"


def test_aggregate_over_bucketed_join_on_mesh(tmp_path):
    """The fused join aggregate declines under a mesh (physical.py:1386):
    the join's rows come from the sharded probe, and the groups and their
    float sums equal the JAX package's."""
    twin = mesh_twin(tmp_path)
    dept_emp(twin)
    index_both(twin, "dept", "aggDept", ["deptId"], ["deptName", "score"])
    index_both(twin, "emp", "aggEmp", ["empDept"], ["empId"])
    for p in (twin.t, twin.j):
        p.on(p.s)

    def q(p):
        return (p.read("dept").join(p.read("emp"), p.col("deptId") == p.col("empDept"))
                .with_column("s2", p.col("score") * 2)
                .group_by("deptName").agg(s=("s2", "sum"), c=("*", "count"), m=("empId", "max")))

    before = probes()[0]
    got, want = twin.both(lambda p: q(p).collect())
    assert_same(got, want, approx_cols=("s",))
    assert got.num_rows == 40 and probes()[0] > before


@pytest.mark.parametrize("kind,how", [("bucketed", "inner"), ("bucketed", "left"), ("general", "inner"),
                                      ("general", "full")])
def test_count_over_both_join_kinds(tmp_path, kind, how):
    """count() under a mesh: the bucketed join counts the sharded probe's
    pairs (physical.py:2716), the general one the exchange's (:2802)."""
    twin = mesh_twin(tmp_path)
    dept_emp(twin, n_emp=700)
    if kind == "bucketed":
        index_both(twin, "dept", "cDept", ["deptId"], ["deptName"])
        index_both(twin, "emp", "cEmp", ["empDept"], ["empId"])
        for p in (twin.t, twin.j):
            p.on(p.s)

    def q(p):
        return p.read("emp").join(p.read("dept"), p.col("empDept") == p.col("deptId"), how).select("empId")

    before = probes()
    (n_t, n_j), dt, dj = traffic(lambda: twin.both(lambda p: q(p).count()))
    assert n_t == n_j == q(twin.t).collect().num_rows > 0
    assert dt == dj and (dt["count"] == 2) == (kind == "general")
    assert (probes()[0] > before[0]) and (probes()[1] > before[1])

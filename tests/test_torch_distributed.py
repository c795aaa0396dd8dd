"""The port's device mesh (`hyperspace_tpu_torch.parallel`) against the JAX
package's, function by function.

The JAX side runs on the suite's 8 virtual CPU devices (`make_mesh(8)`), the
port under `virtual_devices(8, "cpu")` with kernels K1 and K2 in their plain
versions. The same seeded numpy inputs go through both: the count matrices,
every shard's valid rows slot by slot, the build permutations and starts
(also against the port's single-device `bucketize_table`), the probe's pairs
in order and the `parallel.exchange.*` counter deltas must be equal. Every
output is an integer, so the tolerance is 0. The JAX package's compile-once
cases (`tests/test_mesh_compile.py`) have no counterpart: torch compiles no
program.
"""

import numpy as np
import pytest
import torch

import hyperspace_tpu_torch.parallel as tp
from hyperspace_tpu import parallel as jp
from hyperspace_tpu.engine.table import Column as JColumn
from hyperspace_tpu.engine.table import Table as JTable
from hyperspace_tpu.ops.hashing import _SEED1, combined_hash_u32 as j_combined_hash
from hyperspace_tpu.parallel import table_ops as j_table_ops
from hyperspace_tpu.telemetry import metrics as j_metrics
from hyperspace_tpu_torch import resilience
from hyperspace_tpu_torch.engine.table import Column, Table
from hyperspace_tpu_torch.ops import (cuda_comp_sort, cuda_hash, cuda_packed_probe, cuda_packed_sort, cuda_probe,
                                      cuda_sort)
from hyperspace_tpu_torch.ops.hashing import combined_hash_u32
from hyperspace_tpu_torch.ops.partition import bucketize_table
from hyperspace_tpu_torch.parallel import table_ops
from hyperspace_tpu_torch.telemetry import metrics, stage_ledger

N_DEV = 8
#: The exchange's traffic counters, and the pad and code-staging ledgers'
#: entries of its site.
COUNTERS = {c: f"parallel.exchange.{c}" for c in ("rows", "bytes_payload", "bytes_moved", "count")}
COUNTERS.update({n: n for n in (
    "pad.mesh_exchange.bytes_payload", "pad.mesh_exchange.bytes_padded", "device.encoded.mesh_exchange.bytes_flat",
    "device.encoded.mesh_exchange.bytes_staged", "device.encoded.mesh_exchange.bytes_packed")})


@pytest.fixture(scope="module")
def jmesh():
    return jp.make_mesh(N_DEV)


@pytest.fixture()
def mesh():
    with tp.virtual_devices(N_DEV, "cpu"):
        yield tp.make_mesh(device="cpu")


def key_values(kind: str, n: int, rng) -> np.ndarray:
    """Seeded key values of one kind: int, float (with -0.0, 0.0 and NaN),
    string, or nullable int (object array with None)."""
    if kind == "int":
        return rng.randint(0, 5000, n).astype(np.int64)
    if kind == "float":
        v = np.round(rng.randn(n), 2)
        v[::17], v[::23], v[::31] = -0.0, 0.0, np.nan
        return v
    if kind == "string":
        return np.array([f"s{x:03d}" for x in rng.randint(0, 300, n)])
    v = rng.randint(0, 500, n).astype(object)
    v[rng.rand(n) < 0.1] = None
    return v


def both_tables(cols: dict):
    return (Table({n: Column.from_values(v, "cpu") for n, v in cols.items()}),
            JTable({n: JColumn.from_values(v) for n, v in cols.items()}))


def counter_deltas(fn):
    """(fn(), the port's and the JAX package's deltas of `COUNTERS`)."""
    def snap(reg):
        return {c: reg.counter(name).value for c, name in COUNTERS.items()}

    t0, j0 = snap(metrics), snap(j_metrics)
    out = fn()
    t1, j1 = snap(metrics), snap(j_metrics)
    return out, {c: t1[c] - t0[c] for c in COUNTERS}, {c: j1[c] - j0[c] for c in COUNTERS}


def per_shard(x, n_dev=N_DEV):
    """A JAX sharded output as one host array a shard."""
    return np.asarray(x).reshape(n_dev, -1)


@pytest.mark.parametrize("q", [None, "1", "3000"])
def test_quantum_helpers_equal(q, monkeypatch):
    if q is None:
        monkeypatch.delenv(tp.mesh.ENV_ROW_QUANTUM, raising=False)
    else:
        monkeypatch.setenv(tp.mesh.ENV_ROW_QUANTUM, q)
    from hyperspace_tpu.parallel import mesh as jm

    assert tp.mesh_row_quantum() == jm.mesh_row_quantum()
    for n in (0, 1, 999, 1025, 70000):
        assert tp.quantize_cap(n) == jm.quantize_cap(n)
        assert tp.quantized_rows(n, N_DEV) == jm.quantized_rows(n, N_DEV)


@pytest.mark.parametrize("num_buckets", [16, 200])
def test_exchange_counts_equal(mesh, jmesh, num_buckets):
    rng = np.random.RandomState(num_buckets)
    keys = rng.randint(0, 10**6, 8 * 1024).astype(np.int64)
    h1 = combined_hash_u32([torch.from_numpy(keys)])
    jh1 = j_combined_hash([JColumn.from_values(keys)], [keys], _SEED1)
    assert np.array_equal(np.asarray(jh1).astype(np.int64), h1.numpy())
    got = tp.exchange_counts(mesh, h1, num_buckets)
    want = np.asarray(jp.exchange_counts(jmesh, jh1, num_buckets))
    assert got.shape == (N_DEV, N_DEV) and np.array_equal(got, want)
    assert np.array_equal(tp.exchange_counts_coded(mesh, h1 % num_buckets, num_buckets), want)


@pytest.mark.parametrize("kind", ["int", "float", "string", "nullable"])
def test_distributed_bucketize_shards_equal(mesh, jmesh, kind):
    """The flat exchange: every shard's valid rows (bucket ids, payload row
    ids), slot by slot, and its valid count; the traffic counters."""
    import jax.numpy as jnp

    rng = np.random.RandomState(7)
    n, num_buckets = 6000, 32
    t, j = both_tables({"k": key_values(kind, n, rng)})
    tc, jc = t.column("k"), j.column("k")
    h1 = combined_hash_u32([tc])
    jh1 = j_combined_hash([jc], [jc.data], _SEED1)
    key_t = tc.data if tc.data.dtype != torch.bool else tc.data.to(torch.int32)
    rows = torch.arange(n, dtype=torch.int64)
    (b, v, (r,)), dt, _ = counter_deltas(
        lambda: tp.distributed_bucketize(mesh, h1, [rows], [key_t], num_buckets))
    (jb, jv, (jr,)), _, dj = counter_deltas(
        lambda: jp.distributed_bucketize(jmesh, jh1, [jnp.arange(n)], [jnp.asarray(jc.data)], num_buckets))
    assert dt == dj and dt["rows"] == n
    jb, jv, jr = per_shard(jb), per_shard(jv).astype(bool), per_shard(jr)
    for d in range(N_DEV):
        keep = v[d].bool()
        assert int(keep.sum()) == int(jv[d].sum())
        assert np.array_equal(b[d][keep].numpy(), jb[d][jv[d]])
        assert np.array_equal(r[d][keep].numpy(), jr[d][jv[d]])


@pytest.mark.parametrize("packed", ["0", "1"])
def test_distributed_bucketize_coded_shards_equal(mesh, jmesh, packed, monkeypatch):
    """The coded twin on narrow lanes (int8 bucket and validity, int32 row
    ids, int8 codes of a 12-value string key), packed across the wire when
    asked (4-bit buckets and codes, 1-bit validity, 16-bit row ids): the
    same rows as the JAX package's, and the same traffic."""
    import jax.numpy as jnp

    monkeypatch.setenv("HYPERSPACE_PACKED_CODES", packed)
    rng = np.random.RandomState(11)
    n, num_buckets = 5000, 16
    t, j = both_tables({"k": np.array([f"c{x:02d}" for x in rng.randint(0, 12, n)])})
    codes = t.column("k").data.to(torch.int8)
    jcodes = np.asarray(j.column("k").data).astype(np.int8)
    h1 = combined_hash_u32([t.column("k")])
    bucket = (h1 % num_buckets).to(torch.int8)
    n_pad = tp.quantized_rows(n, N_DEV)
    pad = n_pad - n
    valid = torch.cat([torch.ones(n, dtype=torch.int8), torch.zeros(pad, dtype=torch.int8)])
    rowid = torch.arange(n_pad, dtype=torch.int32)
    codes_p = torch.cat([codes, torch.zeros(pad, dtype=torch.int8)])
    bucket_p = torch.cat([bucket, torch.zeros(pad, dtype=torch.int8)])
    spec = ((4, 0), (1, 0), (16, 0), (4, 1)) if packed == "1" else ()

    def jax_run():
        jb = np.concatenate([bucket.numpy(), np.zeros(pad, np.int8)])
        jk = np.concatenate([jcodes, np.zeros(pad, np.int8)])
        return jp.distributed.distributed_bucketize_coded(
            jmesh, jnp.asarray(jb), [jnp.asarray(rowid.numpy())], [jnp.asarray(jk)], num_buckets,
            in_valid=jnp.asarray(valid.numpy()), n_valid=n, packed_spec=spec)

    (b, v, (r,)), dt, _ = counter_deltas(lambda: tp.distributed_bucketize_coded(
        mesh, bucket_p, [rowid], [codes_p], num_buckets, valid, n, packed_spec=spec,
        key_cards=[len(t.column("k").dictionary)]))
    (jb, jv, (jr,)), _, dj = counter_deltas(jax_run)
    assert dt == dj
    jb, jv, jr = per_shard(jb), per_shard(jv).astype(bool), per_shard(jr)
    for d in range(N_DEV):
        keep = v[d].bool()
        assert v[d].dtype == torch.int32 and r[d].dtype == torch.int32
        assert np.array_equal(b[d][keep].numpy(), jb[d][jv[d]])
        assert np.array_equal(r[d][keep].numpy(), jr[d][jv[d]])


def test_distributed_join_counts_equal(mesh, jmesh):
    rng = np.random.RandomState(5)
    B, cap = 16, 64
    pad = np.iinfo(np.int64).max
    ls = np.full((B, cap), pad, np.int64)
    rs = np.full((B, cap), pad, np.int64)
    l_len, r_len = rng.randint(0, cap, B), rng.randint(0, cap, B)
    for b in range(B):
        ls[b, : l_len[b]] = np.sort(rng.randint(0, 40, l_len[b]))
        rs[b, : r_len[b]] = np.sort(rng.randint(0, 40, r_len[b]))
    got = tp.distributed_bucketed_join_counts(
        mesh, torch.from_numpy(ls), torch.from_numpy(rs), torch.from_numpy(l_len), torch.from_numpy(r_len))
    want = jp.distributed_bucketed_join_counts(jmesh, ls, rs, l_len, r_len)
    assert np.array_equal(got.numpy(), np.asarray(want)) and int(got.sum()) > 0


@pytest.mark.parametrize("kind", ["int", "float", "string", "nullable", "two_keys"])
@pytest.mark.parametrize("encoded", ["0", "1"])
def test_bucketize_table_equals_jax_mesh_and_single_device(mesh, jmesh, kind, encoded, monkeypatch):
    """`distributed_bucketize_table` gives the JAX package's permutation and
    starts, which are the port's single-device `bucketize_table`'s too."""
    monkeypatch.setenv("HYPERSPACE_ENCODED_DEVICE", encoded)
    monkeypatch.setenv("HYPERSPACE_PACKED_CODES", encoded)
    rng = np.random.RandomState(13)
    n = 7000
    cols = {"k": key_values("int" if kind == "two_keys" else kind, n, rng), "row": np.arange(n)}
    if kind == "two_keys":
        cols["k2"] = key_values("string", n, rng)
    keys = ["k", "k2"] if kind == "two_keys" else ["k"]
    t, j = both_tables(cols)
    (got, starts), dt, _ = counter_deltas(lambda: tp.distributed_bucketize_table(mesh, t, keys, 16))
    (want, jstarts), _, dj = counter_deltas(lambda: j_table_ops.distributed_bucketize_table(jmesh, j, keys, 16))
    single, sstarts = bucketize_table(t, keys, 16)
    assert dt == dj and dt["count"] == 1
    assert np.array_equal(starts, jstarts) and np.array_equal(starts, sstarts)
    assert np.array_equal(got.column("row").data.numpy(), np.asarray(want.column("row").data))
    assert np.array_equal(got.column("row").data.numpy(), single.column("row").data.numpy())


@pytest.mark.parametrize("kind", ["int", "string"])
def test_exchange_table_equals_jax(mesh, jmesh, kind, monkeypatch):
    """The general join's exchange: the same reordered rows and partition
    starts as the JAX package's, and pairs from the exchanged blocks in the
    same order."""
    monkeypatch.setenv("HYPERSPACE_ENCODED_DEVICE", "1")
    rng = np.random.RandomState(17)
    lt, lj = both_tables({"k": key_values(kind, 4000, rng), "row": np.arange(4000)})
    rt, rj = both_tables({"k": key_values(kind, 900, rng), "row": np.arange(900)})
    outs = []
    for t, j in ((lt, lj), (rt, rj)):
        got, starts, blocks = tp.distributed_exchange_table(mesh, t, ["k"], 4)
        want, jstarts, jblocks = j_table_ops.distributed_exchange_table(jmesh, j, ["k"], 4)
        assert np.array_equal(starts, jstarts) and blocks.cap == jblocks.cap
        assert np.array_equal(got.column("row").data.numpy(), np.asarray(want.column("row").data))
        outs.append((blocks, jblocks))
    li, ri = tp.probe_dist_blocks(mesh, outs[0][0], outs[1][0])
    jli, jri = j_table_ops.probe_dist_blocks(jmesh, outs[0][1], outs[1][1])
    assert len(li) > 0 and np.array_equal(li.numpy(), jli) and np.array_equal(ri.numpy(), jri)


@pytest.mark.parametrize("swap", [False, True], ids=["left_probes", "right_probes"])
def test_bucketed_join_pairs_in_order_200_buckets(mesh, jmesh, swap):
    """200 buckets on 8 shards (208 with the virtual padding): pairs equal
    and in order, the larger capacity on either side."""
    rng = np.random.RandomState(19)
    B = 200

    def side(rows, dup):
        bucket = np.sort(rng.randint(0, B, rows))
        keys = rng.randint(0, rows // dup, rows).astype(np.int64) * 7919
        starts = np.searchsorted(bucket, np.arange(B + 1)).astype(np.int64)
        return keys, starts

    small, large = side(3000, 3), side(40000, 2)
    (lk, ls), (rk, rs) = (large, small) if swap else (small, large)
    li, ri = tp.distributed_bucketed_join_pairs(mesh, torch.from_numpy(lk), ls, torch.from_numpy(rk), rs)
    jli, jri = jp.distributed_bucketed_join_pairs(jmesh, lk, ls, rk, rs)
    assert len(li) > 0
    assert np.array_equal(li.numpy(), jli) and np.array_equal(ri.numpy(), jri)
    assert len(table_ops.LAST_PROBE) == N_DEV


def test_bucket_count_mismatch_returns_none(mesh):
    keys = torch.arange(10, dtype=torch.int64)
    assert tp.distributed_bucketed_join_pairs(
        mesh, keys, np.array([0, 5, 10]), keys, np.array([0, 3, 6, 10])) is None


def test_virtual_mesh_leaves_nothing_behind(tmp_path):
    import hyperspace_tpu_torch as hst

    s = hst.HyperspaceSession(warehouse=str(tmp_path), device="cpu")
    s.conf.set(hst.IndexConstants.DISTRIBUTED_MIN_ROWS, 0)
    assert s.mesh_for(10) is None
    with pytest.raises(RuntimeError):
        with tp.virtual_devices(4, "cpu"):
            mesh = s.mesh_for(10)
            assert mesh is not None and mesh.size == 4 and s.mesh_for(10) is mesh
            raise RuntimeError("leave the block by an error")
    assert s.mesh_for(10) is None
    assert hst.HyperspaceSession(warehouse=str(tmp_path), device="cpu").mesh_for(10) is None
    assert tp.visible_devices("cpu") == (torch.device("cpu"),)


def test_flag_off_disables_mesh(mesh, tmp_path, monkeypatch):
    import hyperspace_tpu_torch as hst

    s = hst.HyperspaceSession(warehouse=str(tmp_path), device="cpu")
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "1")
    assert s.mesh_for(10**6) is not None and s.mesh_for(10) is None  # minRows 65,536
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    assert s.mesh_for(10**6) is None
    monkeypatch.delenv("HYPERSPACE_DISTRIBUTED")
    s.conf.set(hst.IndexConstants.DISTRIBUTED_ENABLED, "false")
    assert s.mesh_for(10**6) is None


def test_mesh_exchange_bills_exchange_stage(mesh):
    """tests/test_stage_attribution.py:203: the exchange's wall goes to the
    `exchange` lane of the query's stage ledger."""
    rng = np.random.RandomState(5)
    keys = torch.from_numpy(rng.randint(0, 1000, size=512).astype(np.int64))
    h1 = combined_hash_u32([keys])
    with resilience.query_scope("q-mesh"):
        tp.distributed_bucketize(mesh, h1, [keys], [keys], 32)
        walls = stage_ledger.query_stage_walls()
    assert walls is not None and walls.get("exchange", 0) > 0


@pytest.mark.parametrize("call", [
    lambda t: cuda_sort.sort_rows(t.to(torch.int64).reshape(1, -1)),
    lambda t: cuda_probe.range_probe(t.reshape(1, -1), t.reshape(1, -1), t[:1], t[:1]),
    lambda t: cuda_comp_sort.sort_comp_rows(t.to(torch.int32).reshape(1, -1)),
    lambda t: cuda_packed_sort.sort_codes_packed(t.to(torch.int32).reshape(1, -1), 4),
    lambda t: cuda_packed_probe.probe_packed(t.to(torch.int32).reshape(1, -1), t.to(torch.int32).reshape(1, -1),
                                             4, t[:1], t[:1]),
    lambda t: cuda_hash.key64([t, t.to(torch.int32)]),
], ids=["K1", "K2", "K3", "K4", "K5", "K6"])
def test_kernel_wrappers_raise_off_cpu_and_cuda(call):
    """A wrapper takes its plain version only for a CPU tensor, launches its
    kernel for a CUDA one, and raises for any other device."""
    with pytest.raises(ValueError):
        call(torch.zeros(64, dtype=torch.int64, device="meta"))

"""The slice as a whole: build → JoinIndexRule rewrite → co-bucketed join, in
the port on the CPU and in the JAX package, from the same source files.

`q_ord` is TPC-H Q3's join (one int64 key: value mode, K2 only) and `q_ps` is
Q9's (a two-column key: hash mode, K1 then K2). On uniform data and on a
layout with one hot bucket (several capacity classes plus a host-merged
outlier bucket) both packages must return the same count and the same rows in
the same order. Nothing is computed on the join's payload, so the tolerance
is 0. The JAX package runs its single-device serial path.
"""

import numpy as np
import pytest

import hyperspace_tpu_torch as hst
from hyperspace_tpu import IndexConfig as JaxIndexConfig
from hyperspace_tpu import IndexConstants as JaxIndexConstants
from hyperspace_tpu.engine import HyperspaceSession as JaxSession
from hyperspace_tpu.engine import col as jax_col
from hyperspace_tpu.engine.physical import BucketedIndexScanExec as JaxBucketedScan
from hyperspace_tpu.hyperspace import Hyperspace as JaxHyperspace
from hyperspace_tpu.hyperspace import enable_hyperspace as jax_enable
from hyperspace_tpu_torch.engine.physical import BucketedIndexScanExec, ExecContext
from hyperspace_tpu_torch.engine.table import Table
from hyperspace_tpu_torch.ops.bucket_join import joint_partition

NUM_BUCKETS = 16
INDEXES = [
    ("lineitem", "liOrd", ["l_orderkey"], ["l_quantity", "l_extendedprice"]),
    ("orders", "ordIdx", ["o_orderkey"], ["o_custkey", "o_totalprice"]),
    ("lineitem", "liPs", ["l_partkey", "l_suppkey"], ["l_quantity", "l_extendedprice"]),
    ("partsupp", "psIdx", ["ps_partkey", "ps_suppkey"], ["ps_supplycost", "ps_availqty"]),
]


def _tables(seed: int, skewed: bool):
    """TPC-H-shaped tables (sparse order keys, 1-7 lines per order, 4
    suppliers per part by the spec's formula), under 30K rows in all."""
    rng = np.random.RandomState(seed)
    n_orders, n_part, n_supp = 2000, 1000, 40
    i = np.arange(n_orders, dtype=np.int64)
    o_orderkey = (i // 8) * 32 + (i % 8) + 1
    lines = rng.randint(1, 8, n_orders)
    if skewed:
        lines[17] = 6000  # one hot order: its bucket is an outlier
    n = int(lines.sum())
    l_partkey = rng.randint(1, n_part + 1, n).astype(np.int64)
    j = rng.randint(0, 4, n).astype(np.int64)
    if skewed:
        l_partkey[:6000], j[:6000] = 7, 1  # one hot (partkey, suppkey) pair

    def suppkey(p, j):
        return (p + j * (n_supp // 4 + (p - 1) // n_supp)) % n_supp + 1

    ps_partkey = np.repeat(np.arange(1, n_part + 1, dtype=np.int64), 4)
    return {
        "lineitem": {
            "l_orderkey": np.repeat(o_orderkey, lines),
            "l_partkey": l_partkey,
            "l_suppkey": suppkey(l_partkey, j),
            "l_quantity": rng.randint(1, 51, n).astype(np.float64),
            "l_extendedprice": np.round(rng.rand(n) * 1e5, 2),
        },
        "orders": {
            "o_orderkey": o_orderkey,
            "o_custkey": rng.randint(1, 300, n_orders).astype(np.int64),
            "o_totalprice": np.round(rng.rand(n_orders) * 1e5, 2),
        },
        "partsupp": {
            "ps_partkey": ps_partkey,
            "ps_suppkey": suppkey(ps_partkey, np.tile(np.arange(4, dtype=np.int64), n_part)),
            "ps_supplycost": np.round(rng.rand(4 * n_part) * 1000, 2),
            "ps_availqty": rng.randint(1, 10000, 4 * n_part).astype(np.int64),
        },
    }


def _queries(s, src, c):
    def rd(name):
        return s.read.parquet(str(src / name))

    return {
        "q_ord": rd("lineitem").join(rd("orders"), c("l_orderkey") == c("o_orderkey")).select(
            "l_extendedprice", "o_custkey"
        ),
        "q_ps": rd("lineitem").join(
            rd("partsupp"), (c("l_partkey") == c("ps_partkey")) & (c("l_suppkey") == c("ps_suppkey"))
        ).select("l_quantity", "ps_supplycost"),
    }


@pytest.fixture(params=["uniform", "skewed"])
def both(request, tmp_path, monkeypatch):
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    monkeypatch.setenv("HYPERSPACE_BUILD_DECODE_THREADS", "1")
    src = tmp_path / "src"
    for name, cols in _tables(11, request.param == "skewed").items():
        hst.engine.io.write_parquet(Table.from_pydict(cols, "cpu"), str(src / name / "part-00000.parquet"))
    ts = hst.HyperspaceSession(warehouse=str(tmp_path / "torch"), device="cpu")
    ts.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    js = JaxSession(warehouse=str(tmp_path / "jax"))
    js.conf.set(JaxIndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    th, jh = hst.Hyperspace(ts), JaxHyperspace(js)
    for table, name, indexed, included in INDEXES:
        th.create_index(ts.read.parquet(str(src / table)), hst.IndexConfig(name, indexed, included))
        jh.create_index(js.read.parquet(str(src / table)), JaxIndexConfig(name, indexed, included))
    hst.enable_hyperspace(ts)
    jax_enable(js)
    return request.param, ts, _queries(ts, src, hst.col), _queries(js, src, jax_col)


@pytest.mark.parametrize("query", ["q_ord", "q_ps"])
def test_port_equals_jax_rows_in_order(both, query):
    layout, ts, tq, jq = both
    t_df, j_df = tq[query], jq[query]
    t_plan, j_plan = t_df.physical_plan(), j_df.physical_plan()
    t_scans = [n for n in t_plan.collect_nodes() if isinstance(n, BucketedIndexScanExec)]
    j_scans = [n for n in j_plan.collect_nodes() if isinstance(n, JaxBucketedScan)]
    assert [n.relation.index_name for n in t_scans] == [n.relation.index_name for n in j_scans]
    assert len(t_scans) == 2
    if layout == "skewed":
        # The hot bucket leaves the padded layout, the rest split in classes.
        ctx = ExecContext(ts)
        starts = [scan.execute_concat(ctx)[1] for scan in t_scans]
        groups, outliers = joint_partition(*starts)
        assert len(outliers) >= 1 and len(groups) >= 2
    assert t_df.count() == j_df.count()
    got, want = t_df.collect(), j_df.collect()
    assert got.column_names == want.column_names
    assert got.num_rows == want.num_rows > 0
    for name in got.column_names:
        np.testing.assert_array_equal(got.column(name).numpy(), want.column(name).data)

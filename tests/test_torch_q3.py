"""TPC-H Q3 whole in the port against the JAX package, with and without its
covering indexes.

`chip_smoke.py`'s generator makes the tables at a small scale factor and its
`q3_query` runs in both packages on the same files: a co-bucketed join
(lineitem ⋈ orders on the Q3 indexes) or a general one, then a general join
with the BUILDING customers, the revenue column, the group-by, ORDER BY
revenue DESC, o_orderdate and LIMIT. The JAX package runs its single-device
sort path (`HYPERSPACE_DISTRIBUTED=0`, `HYPERSPACE_FORCE_DEVICE_OPS=1`). The
port must give its rows in its order with its schema, keys and dates exact
and revenue at rtol 1e-9 (sums may add in another order), and numpy's Q3.
"""

import os

import pytest

import chip_smoke
import hyperspace_tpu_torch as hst
from hyperspace_tpu import IndexConfig as JaxIndexConfig
from hyperspace_tpu import IndexConstants as JaxIndexConstants
from hyperspace_tpu.engine import HyperspaceSession as JaxSession
from hyperspace_tpu.engine import col as jax_col
from hyperspace_tpu.hyperspace import Hyperspace as JaxHyperspace
from hyperspace_tpu.hyperspace import disable_hyperspace as jax_disable
from hyperspace_tpu.hyperspace import enable_hyperspace as jax_enable
from hyperspace_tpu_torch.engine import physical, scan_cache
from hyperspace_tpu_torch.engine.physical import SortMergeJoinExec
from test_torch_aggregate import assert_same

SF = 0.01
NUM_BUCKETS = 16


@pytest.fixture(scope="module")
def lake(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("q3"))
    data = chip_smoke.tpch(SF, 0)
    chip_smoke.write_sources(data, base)
    ts = hst.HyperspaceSession(warehouse=os.path.join(base, "torch"), device="cpu")
    ts.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    js = JaxSession(warehouse=os.path.join(base, "jax"))
    js.conf.set(JaxIndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    th, jh = hst.Hyperspace(ts), JaxHyperspace(js)
    for src, name, indexed, included in chip_smoke.Q3_INDEXES:
        th.create_index(ts.read.parquet(os.path.join(base, "src", src)), hst.IndexConfig(name, indexed, included))
        jh.create_index(js.read.parquet(os.path.join(base, "src", src)), JaxIndexConfig(name, indexed, included))
    return base, data, ts, js


@pytest.fixture(autouse=True)
def _reference_path(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    monkeypatch.setenv("HYPERSPACE_FORCE_DEVICE_OPS", "1")
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()


def _queries(lake, indexed: bool, n: int = 10):
    base, _, ts, js = lake
    (hst.enable_hyperspace if indexed else hst.disable_hyperspace)(ts)
    (jax_enable if indexed else jax_disable)(js)

    def reader(s):
        return lambda t: s.read.parquet(os.path.join(base, "src", t))

    return chip_smoke.q3_query(reader(ts), hst.col, n), chip_smoke.q3_query(reader(js), jax_col, n)


@pytest.mark.parametrize("n", [10, 1000])
@pytest.mark.parametrize("indexed", [True, False], ids=["indexed", "disabled"])
def test_q3_equals_jax_rows_in_order(lake, indexed, n):
    """n = 1000 keeps every group: all of them in Q3's order."""
    tq, jq = _queries(lake, indexed, n)
    got, want = tq.collect(), jq.collect()
    groups = len(chip_smoke.expected_q3(lake[1])["l_orderkey"])
    assert groups > 10 and got.num_rows == min(n, groups)
    assert_same(got, want, approx_cols=("revenue",))


@pytest.mark.parametrize("indexed", [True, False], ids=["indexed", "disabled"])
def test_q3_equals_numpy(lake, indexed):
    tq, _ = _queries(lake, indexed)
    chip_smoke.check_q3("q3", tq.collect().to_numpy(), chip_smoke.expected_q3(lake[1]))
    assert tq.count() == 10


@pytest.mark.parametrize("indexed", [True, False], ids=["indexed", "disabled"])
def test_q3_plan(lake, indexed):
    tq, _ = _queries(lake, indexed)
    plan = tq.physical_plan()
    joins = [n for n in plan.collect_nodes() if isinstance(n, SortMergeJoinExec)]
    assert sorted(j.bucketed for j in joins) == ([False, True] if indexed else [False, False])
    assert [n.name for n in plan.collect_nodes()][:4] == ["Project", "Limit", "OrderBy", "HashAggregate"]


def test_q3_indexed_equals_disabled_and_cached_equals_uncached(lake):
    tq, _ = _queries(lake, True, 1000)
    indexed = tq.collect()
    again = tq.collect()
    assert_same(again, indexed)
    dq, _ = _queries(lake, False, 1000)
    assert_same(dq.collect(), indexed, approx_cols=("revenue",))
    assert_same(dq.collect(), dq.collect())

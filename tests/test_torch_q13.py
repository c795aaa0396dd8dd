"""TPC-H Q13 whole in the port against the JAX package and numpy, with and
without its covering indexes, and the other join types on its tables.

`chip_smoke.py`'s generator makes the tables at a small scale factor (every
third customer has no orders), `key_kind_sources` a copy of o_custkey with 1%
nulls, and its `q13_query` and `join_type_queries` run in both packages on
the same files: customer LEFT OUTER JOIN orders with two aggregates and an
ORDER BY (co-bucketed over custQ13 and ordQ13, or the general join), the
mirror right join, the semi and the anti join, and a full outer join on the
nullable key (ordNullQ13). The JAX package runs its single-device sort path
(`HYPERSPACE_DISTRIBUTED=0`, `HYPERSPACE_FORCE_DEVICE_OPS=1`). The port must
give its rows in its order with its schema and numpy's Q13 row for row; the
other types numpy's rows as a multiset. Everything is an integer: tolerance 0.
"""

import os

import numpy as np
import pytest
import torch

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
    base = str(tmp_path_factory.mktemp("q13"))
    data = chip_smoke.tpch(SF, 0)
    chip_smoke.write_sources(data, base)
    valid = chip_smoke.key_kind_sources(torch, data, base, 0)["o_custkey_n"]
    ts = hst.HyperspaceSession(warehouse=os.path.join(base, "torch"), device="cpu")
    ts.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    js = JaxSession(warehouse=os.path.join(base, "jax"))
    js.conf.set(JaxIndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    th, jh = hst.Hyperspace(ts), JaxHyperspace(js)
    for src, name, indexed, included in chip_smoke.Q13_INDEXES:
        th.create_index(ts.read.parquet(os.path.join(base, "src", src)), hst.IndexConfig(name, indexed, included))
        jh.create_index(js.read.parquet(os.path.join(base, "src", src)), JaxIndexConfig(name, indexed, included))
    return base, data, valid, ts, js


@pytest.fixture(autouse=True)
def _reference_path(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    monkeypatch.setenv("HYPERSPACE_FORCE_DEVICE_OPS", "1")
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()


def _readers(lake, indexed: bool):
    base, _, _, ts, js = lake
    (hst.enable_hyperspace if indexed else hst.disable_hyperspace)(ts)
    (jax_enable if indexed else jax_disable)(js)

    def reader(s):
        return lambda t: s.read.parquet(os.path.join(base, "src", t))

    return reader(ts), reader(js)


def _joins(df):
    return [n for n in df.physical_plan().collect_nodes() if isinstance(n, SortMergeJoinExec)]


@pytest.mark.parametrize("indexed", [True, False], ids=["indexed", "disabled"])
def test_q13_equals_jax_and_numpy(lake, indexed):
    tr, jr = _readers(lake, indexed)
    tq, jq = chip_smoke.q13_query(tr, hst.col), chip_smoke.q13_query(jr, jax_col)
    got = tq.collect()
    assert_same(got, jq.collect())
    want = chip_smoke.expected_q13(lake[1])
    chip_smoke.check_q13("q13", got.to_numpy(), want)
    assert tq.count() == jq.count() == got.num_rows == len(want["c_count"]) > 3
    assert int(want["custdist"][want["c_count"] == 0][0]) == int((chip_smoke.orders_per_customer(lake[1]) == 0).sum())


@pytest.mark.parametrize("indexed", [True, False], ids=["indexed", "disabled"])
def test_q13_plan(lake, indexed):
    tr, _ = _readers(lake, indexed)
    tq = chip_smoke.q13_query(tr, hst.col)
    assert [(j.bucketed, j.how) for j in _joins(tq)] == [(indexed, "left")]
    assert chip_smoke.scanned_indexes(tq) == (["custQ13", "ordQ13"] if indexed else [])
    assert [n.name for n in tq.physical_plan().collect_nodes()][:4] == [
        "OrderBy", "HashAggregate", "HashAggregate", "SortMergeJoin"
    ]


@pytest.mark.parametrize("indexed", [True, False], ids=["indexed", "disabled"])
def test_q13_outer_join_rows(lake, indexed):
    """Every order beside its customer, plus each customer with no order:
    orders + customers - the matched customers."""
    _, data, _, _, _ = lake
    tr, jr = _readers(lake, indexed)
    tq, jq = chip_smoke.q13_join(tr, hst.col), chip_smoke.q13_join(jr, jax_col)
    got = tq.collect()
    assert_same(got, jq.collect())
    n_cust, n_orders = len(data["customer"]["c_custkey"]), len(data["orders"]["o_orderkey"])
    matched = int((chip_smoke.orders_per_customer(data) > 0).sum())
    assert tq.count() == jq.count() == got.num_rows == n_orders + n_cust - matched
    assert int((~got.column("o_orderkey").validity).sum()) == n_cust - matched > 0


@pytest.mark.parametrize("indexed", [True, False], ids=["indexed", "disabled"])
@pytest.mark.parametrize("name", ["right", "semi", "anti", "full_nullable"])
def test_the_other_join_types_equal_jax_and_numpy(lake, name, indexed):
    _, data, valid, _, _ = lake
    tr, jr = _readers(lake, indexed)
    tq, jq = chip_smoke.join_type_queries(tr, hst.col)[name], chip_smoke.join_type_queries(jr, jax_col)[name]
    join = _joins(tq)[0]
    assert join.bucketed == indexed
    assert chip_smoke.scanned_indexes(tq) == (chip_smoke.JOIN_TYPE_INDEXES[name] if indexed else [])
    got = tq.collect()
    assert_same(got, jq.collect())
    want = chip_smoke.canonical(chip_smoke.expected_join_types(data, valid)[name])
    assert chip_smoke.same_multiset(chip_smoke.filled(got), want)
    assert tq.count() == jq.count() == got.num_rows == len(next(iter(want.values())))


def test_q13_indexed_equals_disabled_and_cached_equals_uncached(lake):
    tr, _ = _readers(lake, True)
    tq = chip_smoke.q13_query(tr, hst.col)
    indexed = tq.collect()
    assert_same(tq.collect(), indexed)
    dr, _ = _readers(lake, False)
    dq = chip_smoke.q13_query(dr, hst.col)
    assert_same(dq.collect(), indexed)
    assert_same(dq.collect(), dq.collect())
    np.testing.assert_array_equal(indexed.column("c_count").data.numpy(), chip_smoke.expected_q13(lake[1])["c_count"])

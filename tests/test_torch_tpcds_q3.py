"""TPC-DS Q3 over a date-partitioned store_sales in the port against the JAX
package, with and without its covering indexes.

`chip_smoke.py`'s generator makes the three tables at a small size
(`tpcds_tables`): store_sales partitioned by ss_sold_date_sk, one file a day
and one for the null dates; item as ORC; date_dim as CSV. Its `ds_q3_query`
runs in both packages on the same files: the co-bucketed store_sales ⋈ item
(ssItem and itemIdx, built with lineage on) or a general join, then a
general join to date_dim on the partition column (a null date matches
nothing), the group-by, ORDER BY and LIMIT. The port must give the JAX
package's rows in its order, keys exact and sums at rtol 1e-9, and numpy's
Q3; its index files must be sha256-identical to the JAX package's.
"""

import os

import numpy as np
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
from test_torch_refresh import _sha

NUM_BUCKETS = 8
READERS = {"store_sales": "parquet", "item": "orc", "date_dim": "csv"}


@pytest.fixture(scope="module")
def lake(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("dsq3"))
    rng = np.random.RandomState(3)
    tables = chip_smoke.tpcds_tables(rng, 30_000, chip_smoke.days("1998-09-01"), chip_smoke.days("1999-12-31"),
                                     items=240, null_share=0.02)
    tables["item"]["i_manufact_id"][::10] = 128  # Q3's manufacturer: a tenth of the items at this size
    chip_smoke.write_store_sales_partitioned(tables["store_sales"], os.path.join(base, "store_sales"))
    writer = hst.HyperspaceSession(warehouse=base, device="cpu")
    writer.write_orc(tables["item"], os.path.join(base, "item"))
    writer.write_csv(tables["date_dim"], os.path.join(base, "date_dim"))
    ts = hst.HyperspaceSession(warehouse=os.path.join(base, "torch"), device="cpu")
    js = JaxSession(warehouse=os.path.join(base, "jax"))
    for s, k in ((ts, hst.IndexConstants), (js, JaxIndexConstants)):
        s.conf.set(k.INDEX_NUM_BUCKETS, NUM_BUCKETS)
        s.conf.set(k.INDEX_LINEAGE_ENABLED, "true")
    th, jh = hst.Hyperspace(ts), JaxHyperspace(js)
    mp = pytest.MonkeyPatch()
    mp.setenv("HYPERSPACE_DISTRIBUTED", "0")
    mp.setenv("HYPERSPACE_BUILD_DECODE_THREADS", "1")
    for table, name, indexed, included in chip_smoke.DS_INDEXES:
        th.create_index(reader(ts, base)(table), hst.IndexConfig(name, indexed, included))
        jh.create_index(reader(js, base)(table), JaxIndexConfig(name, indexed, included))
    mp.undo()
    return base, tables, ts, js


def reader(s, base):
    return lambda t: getattr(s.read, READERS[t])(os.path.join(base, t))


@pytest.fixture(autouse=True)
def _reference_path(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    monkeypatch.setenv("HYPERSPACE_FORCE_DEVICE_OPS", "1")
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()


def _queries(lake, indexed: bool, n: int = 100):
    base, _, ts, js = lake
    (hst.enable_hyperspace if indexed else hst.disable_hyperspace)(ts)
    (jax_enable if indexed else jax_disable)(js)
    return chip_smoke.ds_q3_query(reader(ts, base), hst.col, n), chip_smoke.ds_q3_query(reader(js, base), jax_col, n)


def test_the_index_files_equal_jax(lake):
    base = lake[0]
    for _, name, _, _ in chip_smoke.DS_INDEXES:
        shas = []
        for pkg in ("torch", "jax"):
            d = os.path.join(base, pkg, "indexes", name, "v__=0")
            shas.append({f: _sha(os.path.join(d, f)) for f in sorted(os.listdir(d))})
        assert shas[0] == shas[1] and len(shas[0]) == NUM_BUCKETS


@pytest.mark.parametrize("n", [5, 100])
@pytest.mark.parametrize("indexed", [True, False], ids=["indexed", "disabled"])
def test_q3_equals_jax_rows_in_order(lake, indexed, n):
    tq, jq = _queries(lake, indexed, n)
    got, want = tq.collect(), jq.collect()
    groups = len(chip_smoke.expected_ds_q3(lake[1])["d_year"])
    assert groups > 5 and got.num_rows == min(n, groups)
    assert_same(got, want, approx_cols=("sum_agg",))


@pytest.mark.parametrize("indexed", [True, False], ids=["indexed", "disabled"])
def test_q3_equals_numpy_and_its_plan(lake, indexed):
    tq, _ = _queries(lake, indexed)
    chip_smoke.check_ds_q3("ds q3", tq.collect().to_numpy(), chip_smoke.expected_ds_q3(lake[1]))
    joins = [n for n in tq.physical_plan().collect_nodes() if isinstance(n, SortMergeJoinExec)]
    assert sorted(j.bucketed for j in joins) == ([False, True] if indexed else [False, False])
    assert tq.count() == tq.collect().num_rows

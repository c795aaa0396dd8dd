"""The frozen generators: repeatable by seed, TPC's shapes, parquet through
pyarrow."""

import numpy as np
import pyarrow.parquet as pq
import pytest
from conftest import SEED, TPCDS, TPCH, tiny_cell

from lakebench.gen import common, tpcds, tpch


def _same(a, b) -> bool:
    if isinstance(a, tuple):
        return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    return np.array_equal(a, b)


@pytest.mark.parametrize("name,gen", [(TPCH, tpch), (TPCDS, tpcds)])
@pytest.mark.parametrize("seed", [0, SEED, 2**40 + 3])
def test_a_seed_repeats_its_tables_and_another_seed_differs(name, gen, seed):
    conf = tiny_cell(name).config
    a, b, c = gen.generate(conf, seed), gen.generate(conf, seed), gen.generate(conf, seed + 1)
    for t in a:
        assert a[t].bounds == b[t].bounds
        for col in a[t].columns:
            assert _same(a[t].columns[col], b[t].columns[col]), (t, col)
    fact = "lineitem" if name == TPCH else "store_sales"
    key = "l_extendedprice" if name == TPCH else "ss_ext_sales_price"
    assert not np.array_equal(a[fact].columns[key], c[fact].columns[key])


def test_tpch_shapes():
    conf = tiny_cell(TPCH).config
    conf["tables"]["lineitem"]["columns"] = list(tpch.TABLES["lineitem"])
    t = tpch.generate(conf, 7)
    li, od, cu = (t[n].columns for n in ("lineitem", "orders", "customer"))
    assert len(od["o_orderkey"]) == 15_000 and len(cu["c_custkey"]) == 1_500
    assert 3.5 < len(li["l_orderkey"]) / 15_000 < 4.5
    assert np.all(od["o_orderkey"] % 32 <= 8) and np.all(od["o_custkey"] % 3 != 0)
    order_of = np.searchsorted(od["o_orderkey"], li["l_orderkey"])
    gap = li["l_shipdate"] - od["o_orderdate"][order_of]
    assert gap.min() >= 1 and gap.max() <= 121
    assert set(np.unique(li["l_discount"])) <= {k / 100 for k in range(11)}
    assert list(cu["c_mktsegment"][0]) == sorted(cu["c_mktsegment"][0])
    assert t["lineitem"].bounds == common.even_bounds(len(li["l_orderkey"]), 5)


def test_tpcds_shapes_and_monthly_files():
    t = tpcds.generate(tiny_cell(TPCDS).config, 7)
    ss, item = t["store_sales"], t["item"].columns
    assert ss.num_rows == 300_000 and len(ss.bounds) == 61
    days = ss.columns["ss_sold_date_sk"] - tpcds.SS_FIRST_DATE_SK + tpcds.FIRST_DAY
    months = days.astype("datetime64[D]").astype("datetime64[M]")
    for i in range(60):
        part = months[ss.bounds[i]:ss.bounds[i + 1]]
        assert len(part) and (part == part[0]).all()
    assert np.all(np.diff(days) >= 0)
    assert item["i_manager_id"].min() >= 1 and item["i_manager_id"].max() <= 100
    names, codes = item["i_brand"]
    assert list(names[codes]) == [f"brand #{b}" for b in item["i_brand_id"]]
    dd = t["date_dim"].columns
    assert dd["d_date_sk"][0] == 2415022 and len(dd["d_date_sk"]) == 73049


def test_written_files_read_back_equal(tmp_path):
    t = tpcds.generate(tiny_cell(TPCDS).config, 3)
    for name, gen in (("item", t["item"]), ("store_sales", t["store_sales"])):
        cols = list(gen.columns)
        paths = common.write_table(gen, str(tmp_path / name), cols, threads=2)
        assert len(paths) == len(gen.bounds) - 1
        back = pq.read_table(sorted(paths)).to_pydict() if len(paths) == 1 else None
        rows = sum(pq.ParquetFile(p).metadata.num_rows for p in paths)
        assert rows == gen.num_rows
        if back is not None:
            for c in cols:
                assert list(back[c]) == list(common.decoded(gen.columns[c])), c

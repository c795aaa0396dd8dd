"""Each plain reference against a brute-force answer at a tiny scale: every
row joined and filtered one by one, sums by Python dictionaries."""

from collections import defaultdict

import numpy as np
import pytest
from conftest import TPCDS, TPCH, tiny_cell

from lakebench import judge, spec, traffic
from lakebench.gen.common import decoded


def brute_q3(tables, p):
    li, od, cu = (tables[t].columns for t in ("lineitem", "orders", "customer"))
    seg = dict(zip(cu["c_custkey"].tolist(), decoded(cu["c_mktsegment"]).tolist()))
    orders = {}
    for k, c, d, pr in zip(od["o_orderkey"].tolist(), od["o_custkey"].tolist(), od["o_orderdate"].tolist(),
                           od["o_shippriority"].tolist()):
        if d < p["DATE"] and seg.get(c) == p["SEGMENT"]:
            orders[k] = (d, pr)
    rev = defaultdict(float)
    for k, ship, price, disc in zip(li["l_orderkey"].tolist(), li["l_shipdate"].tolist(),
                                    li["l_extendedprice"].tolist(), li["l_discount"].tolist()):
        if ship > p["DATE"] and k in orders:
            rev[k] += price * (1 - disc)
    rows = sorted(rev, key=lambda k: (-rev[k], orders[k][0], k))
    return {"l_orderkey": np.array(rows, np.int64), "revenue": np.array([rev[k] for k in rows]),
            "o_orderdate": np.array([orders[k][0] for k in rows]), "o_shippriority": np.array([orders[k][1] for k in rows])}


def brute_star(tables, p, q55: bool):
    ss, item, dd = (tables[t].columns for t in ("store_sales", "item", "date_dim"))
    brand = decoded(item["i_brand"])
    items = {}
    for i, sk in enumerate(item["i_item_sk"].tolist()):
        ok = item["i_manager_id"][i] == p["MANAGER"] if q55 else item["i_manufact_id"][i] == p["MANUFACT"]
        if ok:
            items[sk] = (int(item["i_brand_id"][i]), str(brand[i]))
    dates = {}
    for sk, y, m in zip(dd["d_date_sk"].tolist(), dd["d_year"].tolist(), dd["d_moy"].tolist()):
        if m == p["MONTH"] and (not q55 or y == p["YEAR"]):
            dates[sk] = y
    total = defaultdict(int)
    for it, d, price in zip(ss["ss_item_sk"].tolist(), ss["ss_sold_date_sk"].tolist(),
                            ss["ss_ext_sales_price"].tolist()):
        if it in items and d in dates:
            total[((dates[d],) if not q55 else ()) + items[it]] += price
    if q55:
        rows = sorted(total, key=lambda k: (-total[k], k[0]))
        return {"i_brand_id": np.array([k[0] for k in rows]), "i_brand": np.array([k[1] for k in rows]),
                "ext_price": np.array([total[k] for k in rows], np.int64)}
    rows = sorted(total, key=lambda k: (k[0], -total[k], k[1]))
    return {"d_year": np.array([k[0] for k in rows]), "i_brand_id": np.array([k[1] for k in rows]),
            "i_brand": np.array([k[2] for k in rows]), "sum_agg": np.array([total[k] for k in rows], np.int64)}


def _cases(name, n):
    cell = tiny_cell(name, ss_rows=60_000)
    tables = spec.module("gen", cell.config["generator"]).generate(cell.config, 11)
    stream = traffic.stream_queries(cell.mix, 11, 0)
    return cell, tables, [next(stream) for _ in range(n)]


@pytest.mark.parametrize("name", [TPCH, TPCDS])
def test_the_reference_equals_brute_force(name):
    cell, tables, cases = _cases(name, 6)
    shared = {}
    nonempty = 0
    for entry, p in cases:
        ref = spec.module("reference", entry["query"])
        state = ref.prepare(tables, entry["params"], shared)
        want = ref.answer(state, p)
        if entry["query"] == "tpch_q3":
            brute = brute_q3(tables, p)
        else:
            brute = brute_star(tables, p, entry["query"] == "tpcds_q55")
        nonempty += len(brute[ref.COLUMNS[0]]) > 0
        top = judge.top(brute, ref, np.arange(len(brute[ref.COLUMNS[0]])))
        got = {c: np.asarray(want[c])[:ref.LIMIT] for c in ref.COLUMNS}
        wrong, err, why = judge.compare(got, top, ref)
        assert not wrong, (p, why)
        assert err < 1e-12
    assert nonempty >= 3


@pytest.mark.parametrize("name", [TPCH, TPCDS])
def test_join_rows_count_the_filtered_inputs(name):
    cell, tables, cases = _cases(name, 4)
    for entry, p in cases:
        ref = spec.module("reference", entry["query"])
        rows = ref.join_rows(ref.prepare(tables, entry["params"], {}), p)
        if name == TPCH:
            assert rows == {"liQ3": int((tables["lineitem"].columns["l_shipdate"] > p["DATE"]).sum()),
                            "ordQ3": int((tables["orders"].columns["o_orderdate"] < p["DATE"]).sum())}
        else:
            item, dd = tables["item"].columns, tables["date_dim"].columns
            sel = item["i_manager_id"] == p["MANAGER"] if "MANAGER" in p else item["i_manufact_id"] == p["MANUFACT"]
            dsel = (dd["d_moy"] == p["MONTH"]) & ((dd["d_year"] == p["YEAR"]) if "YEAR" in p else True)
            assert rows == {"ssItem": tables["store_sales"].num_rows, "itemIdx": int(sel.sum()),
                            "dateIdx": int(dsel.sum())}


@pytest.mark.parametrize("name", [TPCH, TPCDS])
def test_the_control_precision_is_below_the_stated_one(name):
    cell = tiny_cell(name)
    for entry in cell.mix["queries"]:
        ref = spec.module("reference", entry["query"])
        assert np.dtype(ref.CONTROL_DTYPE).itemsize < np.dtype(ref.DTYPE).itemsize

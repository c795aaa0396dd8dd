"""TPC-H Q3 with numpy.

`prepare` joins once every line that ships after the mix's first DATE to its
order placed before the last DATE, with the order's customer's segment;
`answer` filters those pairs by one DATE and SEGMENT, sums the revenue per
order and sorts."""

from __future__ import annotations

import sys
from types import SimpleNamespace

import numpy as np

from ..gen.common import days
from ..judge import group_sum, top
from .common import count_le, lookup, np_join

COLUMNS = ["l_orderkey", "revenue", "o_orderdate", "o_shippriority"]
LIMIT = 10
ORDER = [("revenue", "desc"), ("o_orderdate", "asc")]
IDENT = ["l_orderkey"]
EXACT = ["o_orderdate", "o_shippriority"]
MEASURES = ["revenue"]
#: The co-bucketed pair the rewrite makes, by index name.
PAIRS = [("liQ3", "ordQ3")]
DTYPE = np.float64
CONTROL_DTYPE = np.float32


def prepare(tables: dict, space: dict, shared: dict):
    li, od, cu = (tables[t].columns for t in ("lineitem", "orders", "customer"))
    lo, hi = (days(d) for d in space["DATE"]["date_between"])
    lines = np.nonzero(li["l_shipdate"] > lo)[0]
    ords = np.nonzero(od["o_orderdate"] < hi)[0]
    a, b = np_join(li["l_orderkey"][lines], od["o_orderkey"][ords])
    a, b = lines[a], ords[b]
    c_order = np.argsort(cu["c_custkey"], kind="stable")
    pos, found = lookup(cu["c_custkey"][c_order], od["o_custkey"][b])
    a, b, cust = a[found], b[found], c_order[pos[found]]
    seg_dict, seg_codes = cu["c_mktsegment"]
    ship_counts = np.bincount(li["l_shipdate"] - li["l_shipdate"].min())
    date_counts = np.bincount(od["o_orderdate"] - od["o_orderdate"].min())
    return SimpleNamespace(
        okey=li["l_orderkey"][a], ship=li["l_shipdate"][a], price=li["l_extendedprice"][a],
        disc=li["l_discount"][a], odate=od["o_orderdate"][b], prio=od["o_shippriority"][b],
        seg=seg_codes[cust], seg_dict=seg_dict,
        ship_min=int(li["l_shipdate"].min()), ship_cum=np.cumsum(ship_counts),
        date_min=int(od["o_orderdate"].min()), date_cum=np.cumsum(date_counts),
    )


def answer(st, p: dict, dtype=DTYPE) -> dict:
    d = p["DATE"]
    code = np.nonzero(st.seg_dict == p["SEGMENT"])[0]
    keep = (st.ship > d) & (st.odate < d) & np.isin(st.seg, code)
    dtype = np.dtype(dtype)
    rev = st.price[keep].astype(dtype) * (dtype.type(1) - st.disc[keep].astype(dtype))
    keys, first, inv = np.unique(st.okey[keep], return_index=True, return_inverse=True)
    revenue = group_sum(inv.reshape(-1), rev, len(keys), dtype)
    odate, prio = st.odate[keep][first], st.prio[keep][first]
    order = np.lexsort((odate, -revenue))
    return top({"l_orderkey": keys, "revenue": revenue, "o_orderdate": odate, "o_shippriority": prio},
               sys.modules[__name__], order)


def join_rows(st, p: dict) -> dict:
    """The co-bucketed join's inputs by index: lines shipped after DATE and
    orders placed before it."""
    d = p["DATE"]
    return {"liQ3": int(st.ship_cum[-1]) - count_le(st.ship_cum, st.ship_min, d),
            "ordQ3": count_le(st.date_cum, st.date_min, d - 1)}

"""TPC-DS Q3 with numpy: the MANUFACT's items' sales in MONTH, summed
exactly (int64 cents) by year and brand."""

from __future__ import annotations

import sys

import numpy as np

from ..judge import group_sum, top
from . import star

COLUMNS = ["d_year", "i_brand_id", "i_brand", "sum_agg"]
LIMIT = 100
ORDER = [("d_year", "asc"), ("sum_agg", "desc"), ("i_brand_id", "asc")]
IDENT = ["d_year", "i_brand_id", "i_brand"]
EXACT = []
MEASURES = ["sum_agg"]
DTYPE = np.int64
CONTROL_DTYPE = np.float32
#: The star's fact, by index name; its dimensions are named by the program.
STAR = "ssItem"


def prepare(tables: dict, space: dict, shared: dict):
    return star.prepare(tables, shared)


def answer(st, p: dict, dtype=DTYPE) -> dict:
    rows, items = star.rows_of(st, st.item["i_manufact_id"] == p["MANUFACT"])
    dpos, found = star.dates_of(st, rows)
    keep = found & (st.d_moy[dpos] == p["MONTH"])
    rows, items, dpos = rows[keep], items[keep], dpos[keep]
    year, brand_id, brand = st.d_year[dpos], st.item["i_brand_id"][items], st.brand_codes[items]
    keys, inv = np.unique(np.stack([year, brand_id, brand]), axis=1, return_inverse=True)
    total = group_sum(inv.reshape(-1), st.price[rows], keys.shape[1], dtype)
    order = np.lexsort((keys[1], -total, keys[0]))
    return top({"d_year": keys[0], "i_brand_id": keys[1], "i_brand": st.brand_dict[keys[2]], "sum_agg": total},
               sys.modules[__name__], order)


def join_rows(st, p: dict) -> dict:
    """The star's inputs by index: every fact row, the selected items, the
    selected dates."""
    return {"ssItem": st.n_fact, "itemIdx": int((st.item["i_manufact_id"] == p["MANUFACT"]).sum()),
            "dateIdx": int((st.d_moy == p["MONTH"]).sum())}

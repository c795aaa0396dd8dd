"""TPC-DS Q55 with numpy: the MANAGER's items' sales in MONTH of YEAR,
summed exactly (int64 cents) by brand."""

from __future__ import annotations

import sys

import numpy as np

from ..judge import group_sum, top
from . import star

COLUMNS = ["i_brand_id", "i_brand", "ext_price"]
LIMIT = 100
ORDER = [("ext_price", "desc"), ("i_brand_id", "asc")]
IDENT = ["i_brand_id", "i_brand"]
EXACT = []
MEASURES = ["ext_price"]
DTYPE = np.int64
CONTROL_DTYPE = np.float32
#: The star's fact, by index name; its dimensions are named by the program.
STAR = "ssItem"


def prepare(tables: dict, space: dict, shared: dict):
    return star.prepare(tables, shared)


def answer(st, p: dict, dtype=DTYPE) -> dict:
    rows, items = star.rows_of(st, st.item["i_manager_id"] == p["MANAGER"])
    dpos, found = star.dates_of(st, rows)
    keep = found & (st.d_moy[dpos] == p["MONTH"]) & (st.d_year[dpos] == p["YEAR"])
    rows, items = rows[keep], items[keep]
    brand_id, brand = st.item["i_brand_id"][items], st.brand_codes[items]
    keys, inv = np.unique(np.stack([brand_id, brand]), axis=1, return_inverse=True)
    total = group_sum(inv.reshape(-1), st.price[rows], keys.shape[1], dtype)
    order = np.lexsort((keys[0], -total))
    return top({"i_brand_id": keys[0], "i_brand": st.brand_dict[keys[1]], "ext_price": total},
               sys.modules[__name__], order)


def join_rows(st, p: dict) -> dict:
    """The star's inputs by index: every fact row, the selected items, the
    selected dates."""
    return {"ssItem": st.n_fact, "itemIdx": int((st.item["i_manager_id"] == p["MANAGER"]).sum()),
            "dateIdx": int(((st.d_moy == p["MONTH"]) & (st.d_year == p["YEAR"])).sum())}

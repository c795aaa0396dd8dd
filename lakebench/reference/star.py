"""What the TPC-DS star references share: store_sales grouped by item once,
so that a query reads only its selected items' rows."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from .common import lookup, ranges


def prepare(tables: dict, shared: dict):
    """Made once a run: `shared` keeps it for the other star query."""
    if "star" not in shared:
        shared["star"] = _prepare(tables)
    return shared["star"]


def _prepare(tables: dict):
    ss, item, dd = (tables[t].columns for t in ("store_sales", "item", "date_dim"))
    by_item = np.argsort(ss["ss_item_sk"], kind="stable")
    item_sorted = ss["ss_item_sk"][by_item]
    starts = np.searchsorted(item_sorted, item["i_item_sk"], "left")
    ends = np.searchsorted(item_sorted, item["i_item_sk"], "right")
    d_order = np.argsort(dd["d_date_sk"], kind="stable")
    brand_dict, brand_codes = item["i_brand"]
    return SimpleNamespace(
        n_fact=len(by_item), item=item, starts=starts, ends=ends,
        date_sk=ss["ss_sold_date_sk"][by_item], price=ss["ss_ext_sales_price"][by_item],
        d_sk=dd["d_date_sk"][d_order], d_year=dd["d_year"][d_order], d_moy=dd["d_moy"][d_order],
        brand_dict=brand_dict, brand_codes=brand_codes,
    )


def rows_of(st, item_mask: np.ndarray):
    """(fact rows of the selected items, each row's item index)."""
    items = np.nonzero(item_mask)[0]
    rows = ranges(st.starts[items], st.ends[items])
    return rows, np.repeat(items, st.ends[items] - st.starts[items])


def dates_of(st, rows: np.ndarray):
    """(date_dim position, found) of each fact row's sale date."""
    return lookup(st.d_sk, st.date_sk[rows])

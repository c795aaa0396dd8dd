"""TPC-DS's store_sales, item and date_dim for the star queries, made with
numpy from a seed at the row counts the configuration states.

A frozen copy of the repository's `chip_smoke.star_tables` shapes:
store_sales in tickets of 8-16 rows of one sale date, the dates uniform over
1998-01-02..2002-12-31 and the rows in date order, one file a month; items
uniform; ss_ext_sales_price = ss_quantity * ss_sales_price in cents (TPC-DS's
decimal(7,2) held exactly as int64). item's brand and manufacturer ids are
uniform over 1..1000 (the brand named by its id) and its manager ids over
1..100; date_dim is TPC-DS's calendar from 1900-01-02.
"""

from __future__ import annotations

from functools import cached_property
from typing import Dict

import numpy as np

from .common import Generated, days, even_bounds, stream

FIRST_DAY, LAST_DAY = days("1998-01-02"), days("2002-12-31")
DD_FIRST_SK, DD_FIRST_DATE = 2415022, "1900-01-02"
SS_FIRST_DATE_SK = DD_FIRST_SK + FIRST_DAY - days(DD_FIRST_DATE)  # 2450816, d_date_sk of 1998-01-02


class _Tables:
    def __init__(self, rows: Dict[str, int], seed: int):
        self.seed = seed
        self.n_ss = int(rows["store_sales"])
        self.n_item = int(rows["item"])
        self.n_dd = int(rows["date_dim"])

    def rng(self, name: str) -> np.random.Generator:
        return stream(self.seed, name)

    # store_sales -------------------------------------------------------
    @cached_property
    def ticket_sizes(self) -> np.ndarray:
        sizes = self.rng("store_sales.tickets").integers(8, 17, self.n_ss // 8 + 1)
        n_t = int(np.searchsorted(np.cumsum(sizes), self.n_ss)) + 1
        sizes = sizes[:n_t].copy()
        sizes[-1] -= int(sizes.sum()) - self.n_ss
        return sizes

    @cached_property
    def day(self) -> np.ndarray:
        n_t = len(self.ticket_sizes)
        t_day = np.sort(self.rng("store_sales.ticket_day").integers(FIRST_DAY, LAST_DAY + 1, n_t))
        return np.repeat(t_day, self.ticket_sizes).astype(np.int64)

    @cached_property
    def month(self) -> np.ndarray:
        """Each row's month, 0 = 1998-01."""
        m = self.day.astype("datetime64[D]").astype("datetime64[M]").astype(np.int64)
        return m - np.datetime64("1998-01", "M").astype(np.int64)

    @cached_property
    def ss_sold_date_sk(self) -> np.ndarray:
        return SS_FIRST_DATE_SK + self.day - FIRST_DAY

    @cached_property
    def ss_item_sk(self) -> np.ndarray:
        return self.rng("store_sales.ss_item_sk").integers(1, self.n_item + 1, self.n_ss, dtype=np.int64)

    @cached_property
    def ss_quantity(self) -> np.ndarray:
        return self.rng("store_sales.ss_quantity").integers(1, 101, self.n_ss, dtype=np.int64)

    @cached_property
    def ss_sales_price(self) -> np.ndarray:
        """Cents."""
        return self.rng("store_sales.ss_sales_price").integers(100, 20_001, self.n_ss, dtype=np.int64)

    @cached_property
    def ss_ext_sales_price(self) -> np.ndarray:
        return self.ss_quantity * self.ss_sales_price

    # item --------------------------------------------------------------
    @cached_property
    def i_item_sk(self) -> np.ndarray:
        return np.arange(1, self.n_item + 1, dtype=np.int64)

    @cached_property
    def i_brand_id(self) -> np.ndarray:
        return self.rng("item.i_brand_id").integers(1, 1001, self.n_item, dtype=np.int64)

    @cached_property
    def i_brand(self):
        names = np.array([f"brand #{b}" for b in range(1, 1001)])
        order = np.argsort(names)
        rank = np.empty(1000, np.int32)
        rank[order] = np.arange(1000, dtype=np.int32)
        return names[order], rank[self.i_brand_id - 1]

    @cached_property
    def i_manufact_id(self) -> np.ndarray:
        return self.rng("item.i_manufact_id").integers(1, 1001, self.n_item, dtype=np.int64)

    @cached_property
    def i_manager_id(self) -> np.ndarray:
        return self.rng("item.i_manager_id").integers(1, 101, self.n_item, dtype=np.int64)

    # date_dim ----------------------------------------------------------
    @cached_property
    def _dates(self) -> np.ndarray:
        return np.datetime64(DD_FIRST_DATE) + np.arange(self.n_dd)

    @cached_property
    def d_date_sk(self) -> np.ndarray:
        return DD_FIRST_SK + np.arange(self.n_dd, dtype=np.int64)

    @cached_property
    def d_year(self) -> np.ndarray:
        return self._dates.astype("datetime64[Y]").astype(np.int64) + 1970

    @cached_property
    def d_moy(self) -> np.ndarray:
        return self._dates.astype("datetime64[M]").astype(np.int64) % 12 + 1


TABLES = {
    "store_sales": ("ss_sold_date_sk", "ss_item_sk", "ss_quantity", "ss_sales_price", "ss_ext_sales_price"),
    "item": ("i_item_sk", "i_brand_id", "i_brand", "i_manufact_id", "i_manager_id"),
    "date_dim": ("d_date_sk", "d_year", "d_moy"),
}


def generate(config: dict, seed: int) -> Dict[str, Generated]:
    """The configuration's tables at its `rows`; a table whose `files` is
    "month" gets one file per month of sales (store_sales only)."""
    t = _Tables(config["rows"], seed)
    out = {}
    for name, spec in config["tables"].items():
        unknown = [c for c in spec["columns"] if c not in TABLES.get(name, ())]
        if unknown:
            raise ValueError(f"tpcds: no generator for {name} columns {unknown}")
        gen = Generated({c: getattr(t, c) for c in spec["columns"]})
        files = spec.get("files", 1)
        if files == "month":
            if name != "store_sales":
                raise ValueError(f"tpcds: only store_sales splits by month, not {name}")
            gen.bounds = [int(b) for b in np.searchsorted(t.month, np.arange(int(t.month[-1]) + 2))]
        else:
            gen.bounds = even_bounds(gen.num_rows, int(files))
        out[name] = gen
    return out

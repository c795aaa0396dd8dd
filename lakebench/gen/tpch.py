"""TPC-H's lineitem, orders and customer (specification clause 4.2.3), made
with numpy from a seed and sized by the scale factor.

A frozen copy of the repository's `chip_smoke.tpch` shapes: orders keys
sparse (8 of every 32), every third customer without orders, 1-7 lines an
order, a line shipped 1-121 days after its order, prices from the part key,
segments uniform over the five of clause 4.2.2.13. Each column draws from a
stream of its own (`common.stream`), so only the columns a configuration
lists are made.
"""

from __future__ import annotations

from functools import cached_property
from typing import Dict

import numpy as np

from .common import Generated, days, even_bounds, stream

# Clause 4.2.2.13's list, sorted: dictionary order is value order.
SEGMENTS = np.array(sorted(["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]))
START_DATE, END_DATE = days("1992-01-01"), days("1998-12-31")


class _Tables:
    """The columns of one scale factor and seed, each made on first use."""

    def __init__(self, sf: float, seed: int):
        self.seed = seed
        self.n_orders = int(1_500_000 * sf)
        self.n_cust = int(150_000 * sf)
        self.n_part = int(200_000 * sf)

    def rng(self, name: str) -> np.random.Generator:
        return stream(self.seed, name)

    # orders ------------------------------------------------------------
    @cached_property
    def o_orderkey(self) -> np.ndarray:
        i = np.arange(self.n_orders, dtype=np.int64)
        return (i // 8) * 32 + (i % 8) + 1

    @cached_property
    def o_custkey(self) -> np.ndarray:
        k = self.rng("orders.o_custkey").integers(0, (2 * self.n_cust) // 3, self.n_orders, dtype=np.int64)
        return 3 * (k // 2) + (k % 2) + 1

    @cached_property
    def o_orderdate(self) -> np.ndarray:
        return self.rng("orders.o_orderdate").integers(START_DATE, END_DATE - 151 + 1, self.n_orders,
                                                       dtype=np.int32)

    @cached_property
    def o_shippriority(self) -> np.ndarray:
        return np.zeros(self.n_orders, dtype=np.int32)

    # lineitem ----------------------------------------------------------
    @cached_property
    def lines(self) -> np.ndarray:
        return self.rng("orders.lines").integers(1, 8, self.n_orders)

    @cached_property
    def n_lines(self) -> int:
        return int(self.lines.sum())

    @cached_property
    def l_orderkey(self) -> np.ndarray:
        return np.repeat(self.o_orderkey, self.lines)

    @cached_property
    def l_partkey(self) -> np.ndarray:
        return self.rng("lineitem.l_partkey").integers(1, self.n_part + 1, self.n_lines, dtype=np.int64)

    @cached_property
    def l_quantity(self) -> np.ndarray:
        return self.rng("lineitem.l_quantity").integers(1, 51, self.n_lines).astype(np.float64)

    @cached_property
    def l_extendedprice(self) -> np.ndarray:
        p = self.l_partkey
        retail = (90000 + (p // 10) % 20001 + 100 * (p % 1000)) / 100.0
        return np.round(self.l_quantity * retail, 2)

    @cached_property
    def l_discount(self) -> np.ndarray:
        return self.rng("lineitem.l_discount").integers(0, 11, self.n_lines) / 100.0

    @cached_property
    def l_tax(self) -> np.ndarray:
        return self.rng("lineitem.l_tax").integers(0, 9, self.n_lines) / 100.0

    @cached_property
    def l_shipdate(self) -> np.ndarray:
        after = self.rng("lineitem.l_shipdate").integers(1, 122, self.n_lines, dtype=np.int32)
        return np.repeat(self.o_orderdate, self.lines) + after

    # customer ----------------------------------------------------------
    @cached_property
    def c_custkey(self) -> np.ndarray:
        return np.arange(1, self.n_cust + 1, dtype=np.int64)

    @cached_property
    def c_mktsegment(self):
        codes = self.rng("customer.c_mktsegment").integers(0, len(SEGMENTS), self.n_cust, dtype=np.int32)
        return SEGMENTS, codes


TABLES = {
    "lineitem": ("l_orderkey", "l_partkey", "l_quantity", "l_extendedprice", "l_discount", "l_tax", "l_shipdate"),
    "orders": ("o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"),
    "customer": ("c_custkey", "c_mktsegment"),
}


def generate(config: dict, seed: int) -> Dict[str, Generated]:
    """The configuration's tables (`config["tables"]`: each its `columns` and
    `files`) at `config["scale_factor"]`."""
    t = _Tables(float(config["scale_factor"]), seed)
    out = {}
    for name, spec in config["tables"].items():
        unknown = [c for c in spec["columns"] if c not in TABLES.get(name, ())]
        if unknown:
            raise ValueError(f"tpch: no generator for {name} columns {unknown}")
        cols = {c: getattr(t, c) for c in spec["columns"]}
        gen = Generated(cols)
        gen.bounds = even_bounds(gen.num_rows, int(spec.get("files", 1)))
        out[name] = gen
    return out

"""Filters sink below computed columns in the port as in the JAX package.

The three pushdown cases of `tests/test_with_column.py` (a source-column
filter above two computed columns, a filter on the computed column that must
stay above it, and a source-column filter above a computed-column filter),
run in both packages over the same parquet file with a covering index built
by each: the same plan (the index system path aside), the same rows in the
same order, and a plain filter stack left in its order. Nothing is computed
beyond IEEE arithmetic on the same inputs, so the tolerance is 0.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu_torch as hst
from hyperspace_tpu import IndexConfig as JaxIndexConfig
from hyperspace_tpu import IndexConstants as JaxIndexConstants
from hyperspace_tpu.engine import HyperspaceSession as JaxSession
from hyperspace_tpu.engine import col as jax_col
from hyperspace_tpu.hyperspace import Hyperspace as JaxHyperspace
from hyperspace_tpu.hyperspace import disable_hyperspace as jax_disable
from hyperspace_tpu.hyperspace import enable_hyperspace as jax_enable
from test_torch_aggregate import assert_same


class Pkg:
    """One package's session over the shared source: its `col`, its
    Hyperspace facade and its index system path."""

    def __init__(self, base, name):
        self.name = name
        self.idx = os.path.join(base, name, "indexes")
        if name == "torch":
            self.s = hst.HyperspaceSession(warehouse=os.path.join(base, name), device="cpu")
            k, self.col = hst.IndexConstants, hst.col
            self.hs, self.cfg = hst.Hyperspace(self.s), hst.IndexConfig
            self.on, self.off = hst.enable_hyperspace, hst.disable_hyperspace
        else:
            self.s = JaxSession(warehouse=os.path.join(base, name))
            k, self.col = JaxIndexConstants, jax_col
            self.hs, self.cfg = JaxHyperspace(self.s), JaxIndexConfig
            self.on, self.off = jax_enable, jax_disable
        self.s.conf.set(k.INDEX_SYSTEM_PATH, self.idx)
        self.s.conf.set(k.INDEX_NUM_BUCKETS, 4)
        self.li = os.path.join(base, "li")

    def read(self):
        return self.s.read.parquet(self.li)

    def plan(self, df) -> str:
        return df.explain_string().replace(self.idx, "<indexes>")


@pytest.fixture()
def pkgs(tmp_path, monkeypatch):
    """The fixture of `tests/test_with_column.py:19` in both packages."""
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    os.makedirs(tmp_path / "li")
    pq.write_table(
        pa.table({
            "okey": pa.array([1, 1, 2, 3, 3], type=pa.int64()),
            "price": pa.array([10.0, 20.0, 30.0, 40.0, None]),
            "discount": pa.array([0.1, 0.0, 0.5, None, 0.2]),
        }),
        str(tmp_path / "li" / "part-00000.parquet"),
    )
    return [Pkg(str(tmp_path), "torch"), Pkg(str(tmp_path), "jax")]


def _both(pkgs, query, index=None):
    """(plans, collected tables) of `query(pkg)` in each package, indexed
    after `index` = (name, indexed, included) is built, and disabled."""
    out = {}
    for p in pkgs:
        if index is not None:
            name, indexed, included = index
            p.hs.create_index(p.read(), p.cfg(name, indexed, included))
        p.off(p.s)
        disabled = query(p).collect()
        p.on(p.s)
        q = query(p)
        out[p.name] = (p.plan(q), q.collect(), disabled)
    return out["torch"], out["jax"]


def test_filter_pushdown_enables_filter_index(pkgs):
    """`tests/test_with_column.py:231`: the filter on okey sinks below both
    computed columns and the filter index serves it."""

    def q(p):
        c = p.col
        return (
            p.read().with_column("revenue", c("price") * (1 - c("discount")))
            .with_column("double_rev", c("revenue") * 2)
            .filter(c("okey") == 1)
            .select("okey", "revenue", "double_rev")
        )

    (tplan, tout, toff), (jplan, jout, joff) = _both(pkgs, q, ("fwIdx", ["okey"], ["price", "discount"]))
    assert "index=fwIdx" in tplan and tplan == jplan
    assert tout.num_rows == 2
    assert_same(tout, jout)
    assert_same(toff, joff)
    assert sorted(map(repr, tout.rows())) == sorted(map(repr, toff.rows()))


def test_filter_on_computed_column_not_pushed(pkgs):
    """`tests/test_with_column.py:259`: a filter naming the computed column
    stays above it."""

    def q(p):
        c = p.col
        return (
            p.read().with_column("revenue", c("price") * (1 - c("discount")))
            .filter(c("revenue") > 10)
            .select("okey", "revenue")
        )

    (tplan, tout, _), (jplan, jout, _) = _both(pkgs, q)
    assert tplan == jplan
    assert tplan.index("Filter") < tplan.index("WithColumn")
    assert sorted(np.asarray(tout.column("okey").decode()).tolist()) == [1, 2]
    assert_same(tout, jout)


def test_filter_pushdown_through_filter_stack(pkgs):
    """`tests/test_with_column.py:273`: a source-column filter above a
    computed-column filter still reaches the scan; a plain filter stack keeps
    its order."""

    def q(p):
        c = p.col
        return (
            p.read().with_column("revenue", c("price") * (1 - c("discount")))
            .filter(c("revenue") > 10)
            .filter(c("okey") == 1)
            .select("okey", "revenue")
        )

    (tplan, tout, toff), (jplan, jout, joff) = _both(pkgs, q, ("stackIdx", ["okey"], ["price", "discount"]))
    assert "index=stackIdx" in tplan and tplan == jplan
    assert_same(tout, jout)
    assert_same(toff, joff)
    trees = []
    for p in pkgs:
        c = p.col
        stack = p.read().filter(c("okey") == 1).filter(c("price") > 5)
        trees.append(stack.optimized_plan().tree_string().replace(p.idx, "<indexes>"))
    assert trees[0] == trees[1]
    assert trees[0].index("price") < trees[0].index("okey")  # the outer filter stays outermost

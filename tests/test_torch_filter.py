"""FilterIndexRule and filter evaluation in the port against the JAX package.

Both packages index the same source files (written once, by the port) on a
dictionary-string head column and on a nullable integer head column, then
run the same filters with hyperspace enabled and disabled. They must make the
same rewrite decision, keep the same bucket files, and return the same rows
in the same order; the indexed rows must equal the non-indexed ones as a
multiset. Nothing is computed on the values, so the tolerance is 0.
"""

import os

import numpy as np
import pytest

import hyperspace_tpu_torch as hst
from hyperspace_tpu import IndexConfig as JaxIndexConfig
from hyperspace_tpu import IndexConstants as JaxIndexConstants
from hyperspace_tpu.engine import HyperspaceSession as JaxSession
from hyperspace_tpu.engine import col as jax_col
from hyperspace_tpu.engine.logical import ScanNode as JaxScanNode
from hyperspace_tpu.hyperspace import Hyperspace as JaxHyperspace
from hyperspace_tpu.hyperspace import disable_hyperspace as jax_disable
from hyperspace_tpu.hyperspace import enable_hyperspace as jax_enable
from hyperspace_tpu_torch.engine.logical import ScanNode
from hyperspace_tpu_torch.engine.table import Table

NUM_BUCKETS = 16
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]


def _source(seed=21, n=4000):
    rng = np.random.RandomState(seed)
    seg = np.array(SEGMENTS)[rng.randint(0, 5, n)].astype(object)
    seg[rng.rand(n) < 0.1] = None  # nulls in the head column
    nint = rng.randint(0, 40, n).astype(object)
    nint[rng.rand(n) < 0.15] = None
    return {
        "seg": seg,
        "name": np.array([f"Customer#{i:09d}" for i in rng.permutation(n)]),
        "nint": nint,
        "k": np.arange(n, dtype=np.int64),
        "bal": np.round(rng.randn(n) * 1000, 2),
    }


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    base = tmp_path_factory.mktemp("filter")
    mp = pytest.MonkeyPatch()
    mp.setenv("HYPERSPACE_DISTRIBUTED", "0")
    mp.setenv("HYPERSPACE_BUILD_DECODE_THREADS", "1")
    src = str(base / "src" / "c")
    hst.engine.io.write_parquet(Table.from_pydict(_source(), "cpu"), os.path.join(src, "part-00000.parquet"))
    rng = np.random.RandomState(5)
    orders = {"ok": rng.randint(0, 4000, 3000).astype(np.int64), "ov": rng.rand(3000)}
    hst.engine.io.write_parquet(Table.from_pydict(orders, "cpu"), str(base / "src" / "o" / "part-00000.parquet"))
    ts = hst.HyperspaceSession(warehouse=str(base / "torch"), device="cpu")
    ts.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    js = JaxSession(warehouse=str(base / "jax"))
    js.conf.set(JaxIndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    for hs, cfg, s in ((hst.Hyperspace(ts), hst.IndexConfig, ts), (JaxHyperspace(js), JaxIndexConfig, js)):
        hs.create_index(s.read.parquet(src), cfg("segIdx", ["seg"], ["k", "name", "nint"]))
        hs.create_index(s.read.parquet(src), cfg("intIdx", ["nint"], ["k", "bal"]))
        hs.create_index(s.read.parquet(src), cfg("kIdx", ["k"], ["seg", "nint"]))
        hs.create_index(s.read.parquet(str(base / "src" / "o")), cfg("okIdx", ["ok"], ["ov"]))
    yield ts, js, src
    mp.undo()


# name -> (condition over a `col` function, output columns)
QUERIES = {
    "eq": (lambda c: c("seg") == "BUILDING", ["k", "name", "seg"]),
    "eq-flipped": (lambda c: "MACHINERY" == c("seg"), ["k", "seg"]),
    "isin": (lambda c: c("seg").isin("MAIL", "AUTOMOBILE", "HOUSEHOLD"), ["k", "seg"]),
    "isin-null": (lambda c: ~c("seg").isin("BUILDING", None), ["k", "seg"]),
    "ne": (lambda c: c("seg") != "FURNITURE", ["k", "name"]),
    "range": (lambda c: (c("seg") >= "FURNITURE") & (c("seg") < "MACHINERY"), ["k", "seg"]),
    "range-or": (lambda c: (c("seg") <= "BUILDING") | (c("nint") > 30), ["k", "seg", "nint"]),
    "absent": (lambda c: c("seg") == "ZEBRA", ["k", "seg"]),
    "absent-range": (lambda c: c("seg") > "CAT", ["k"]),
    "is-null": (lambda c: c("seg").is_null(), ["k", "seg", "nint"]),
    "is-not-null": (lambda c: c("seg").is_not_null() & (c("nint") == 7), ["k", "seg"]),
    "int-eq": (lambda c: c("nint") == 12, ["k", "bal", "nint"]),
    "int-isin": (lambda c: c("nint").isin(3, 4.0, 39), ["k", "nint"]),
    "int-frac": (lambda c: c("nint") == 2.5, ["k"]),
    "int-null": (lambda c: c("nint").is_null(), ["k", "bal"]),
    "not-covered": (lambda c: c("seg") == "BUILDING", ["k", "bal"]),  # bal is not in segIdx
    "no-head": (lambda c: c("k") < 100, ["k", "seg"]),
}


def _scans(plan, scan_type):
    return [n.relation for n in plan.collect_nodes() if isinstance(n, scan_type)]


def _index_files(rel):
    return None if rel.index_name is None else sorted(os.path.basename(f.path) for f in rel.files)


def _rows(table_numpy, names):
    cols = [table_numpy[n] for n in names]
    return [tuple(None if c[i] is None else str(c[i]) for c in cols) for i in range(len(cols[0]))]


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_filter_index_rule_matches_the_jax_package(sessions, name):
    ts, js, src = sessions
    cond, out = QUERIES[name]
    hst.enable_hyperspace(ts)
    jax_enable(js)
    tq = ts.read.parquet(src).filter(cond(hst.col)).select(*out)
    jq = js.read.parquet(src).filter(cond(jax_col)).select(*out)
    # The same rewrite decision and the same pruned file list.
    t_rels, j_rels = _scans(tq.optimized_plan(), ScanNode), _scans(jq.optimized_plan(), JaxScanNode)
    assert [r.index_name for r in t_rels] == [r.index_name for r in j_rels]
    assert [_index_files(r) for r in t_rels] == [_index_files(r) for r in j_rels]
    assert [r.pruned_by for r in t_rels] == [r.pruned_by for r in j_rels]
    # The same rows in the same order, and the same count.
    indexed = _rows(tq.collect().to_numpy(), out)
    assert indexed == _rows(jq.collect().to_pydict(), out)
    assert tq.count() == jq.count() == len(indexed)
    # Indexed and non-indexed: the same rows.
    hst.disable_hyperspace(ts)
    jax_disable(js)
    plain = _rows(ts.read.parquet(src).filter(cond(hst.col)).select(*out).collect().to_numpy(), out)
    assert sorted(indexed) == sorted(plain)


def test_bucket_pruning_keeps_one_file_per_literal(sessions):
    ts, _js, src = sessions
    hst.enable_hyperspace(ts)
    q = ts.read.parquet(src).filter(hst.col("seg") == "BUILDING").select("k")
    (rel,) = _scans(q.optimized_plan(), ScanNode)
    assert rel.index_name == "segIdx" and len(rel.files) == 1
    assert rel.pruned_by == ["FilterIndexRule:bucket"]
    assert "files pruned by FilterIndexRule:bucket" in q.explain_string()
    ts.conf.set(hst.IndexConstants.INDEX_FILTER_BUCKET_PRUNING, "false")
    try:
        (rel,) = _scans(q.optimized_plan(), ScanNode)
        files = os.listdir(os.path.join(ts.warehouse, "indexes", "segIdx", "v__=0"))
        assert rel.pruned_by == [] and len(rel.files) == len([f for f in files if f.endswith(".parquet")]) > 1
    finally:
        ts.conf.set(hst.IndexConstants.INDEX_FILTER_BUCKET_PRUNING, "true")
        hst.disable_hyperspace(ts)


def test_a_filtered_join_side_keeps_its_buckets(sessions):
    """A filter under a co-bucketed join: both packages rewrite both sides to
    their bucketed indexes and return the same rows in the same order."""
    ts, js, src = sessions
    osrc = os.path.join(os.path.dirname(src), "o")
    hst.enable_hyperspace(ts)
    jax_enable(js)
    try:
        out = ["k", "seg", "ov"]
        tq = ts.read.parquet(src).filter(hst.col("seg").isin("BUILDING", "MACHINERY")).join(
            ts.read.parquet(osrc), hst.col("k") == hst.col("ok")).select(*out)
        jq = js.read.parquet(src).filter(jax_col("seg").isin("BUILDING", "MACHINERY")).join(
            js.read.parquet(osrc), jax_col("k") == jax_col("ok")).select(*out)
        assert "BucketedIndexScan" in tq.explain_string()
        rows = _rows(tq.collect().to_numpy(), out)
        assert rows == _rows(jq.collect().to_pydict(), out)
        assert tq.count() == jq.count() == len(rows) > 0
    finally:
        hst.disable_hyperspace(ts)
        jax_disable(js)


# A two-column index buckets rows by the hash of both columns. name ->
# (condition, number of index files kept; None = every file is scanned).
TWO_COLUMN_QUERIES = {
    "head-only-eq": (lambda c: c("seg") == "BUILDING", None),
    "head-only-isin": (lambda c: c("seg").isin("BUILDING", "MACHINERY"), None),
    "both-pinned": (lambda c: (c("seg") == "BUILDING") & (c("nint") == 12), 1),
    "both-isin": (lambda c: c("seg").isin("BUILDING", "MACHINERY") & c("nint").isin(3, 39), 4),
    "second-free": (lambda c: (c("seg") == "HOUSEHOLD") & (c("nint") > 20), None),
}


@pytest.fixture(scope="module")
def two_column_session(tmp_path_factory):
    base = tmp_path_factory.mktemp("filter2")
    src = str(base / "src" / "c")
    hst.engine.io.write_parquet(Table.from_pydict(_source(seed=23), "cpu"), os.path.join(src, "part-00000.parquet"))
    ts = hst.HyperspaceSession(warehouse=str(base / "torch"), device="cpu")
    ts.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    hst.Hyperspace(ts).create_index(ts.read.parquet(src), hst.IndexConfig("segNint", ["seg", "nint"], ["k"]))
    js = JaxSession(warehouse=str(base / "jax"))
    yield ts, js, src


@pytest.mark.parametrize("name", sorted(TWO_COLUMN_QUERIES))
def test_two_column_index_prunes_only_when_every_column_is_pinned(two_column_session, name):
    """Rows live in the bucket of their (seg, nint) tuple, so a filter that
    pins seg alone must scan every file; pinning both keeps one file per
    tuple's bucket. The indexed rows equal the rows of the same filter with
    hyperspace off, in the port and in the JAX package."""
    ts, js, src = two_column_session
    cond, n_files = TWO_COLUMN_QUERIES[name]
    out = ["k", "seg", "nint"]
    hst.enable_hyperspace(ts)
    try:
        q = ts.read.parquet(src).filter(cond(hst.col)).select(*out)
        (rel,) = _scans(q.optimized_plan(), ScanNode)
        all_files = [f for f in os.listdir(os.path.join(ts.warehouse, "indexes", "segNint", "v__=0"))
                     if f.endswith(".parquet")]
        assert rel.index_name == "segNint"
        if n_files is None:
            assert rel.pruned_by == [] and len(rel.files) == len(all_files)
        else:
            assert rel.pruned_by == ["FilterIndexRule:bucket"] and 1 <= len(rel.files) <= n_files
        indexed = _rows(q.collect().to_numpy(), out)
    finally:
        hst.disable_hyperspace(ts)
    plain = _rows(ts.read.parquet(src).filter(cond(hst.col)).select(*out).collect().to_numpy(), out)
    reference = _rows(js.read.parquet(src).filter(cond(jax_col)).select(*out).collect().to_pydict(), out)
    assert len(plain) > 0
    assert sorted(indexed) == sorted(plain) == sorted(reference)

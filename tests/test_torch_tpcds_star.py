"""TPC-DS Q3 and Q55 as star joins in the port against the JAX package and numpy.

`chip_smoke.star_tables` makes store_sales (not indexed), item and date_dim
at a small size (store_sales as 6 monthly-range files), and both packages
build the phase's covering indexes dateIdx and itemIdx over the same files
(`chip_smoke.STAR_INDEXES`). Each of phase star's steps (a) Q3, (b) Q55 and
(c) Q55 with a float sum of ss_net_paid runs each of its four ways: the star
stream (defaults), the cascade (`HYPERSPACE_MULTIWAY=0`), streaming off
(`HYPERSPACE_QUERY_STREAMING=0`) and disabled. In each, both packages plan a
`MultiwayJoinExec` or neither does (the first two ways of the indexed
query do), the star stream runs in both or in neither, and the port's rows
equal the JAX package's (its device program,
`HYPERSPACE_FORCE_DEVICE_OPS=1`) in order and schema and numpy's
(`chip_smoke.check_star_rows`). Tolerance: exact, float sums included (the
port reproduces the JAX device program's fold order); numpy's float sums at
rtol 1e-9.
"""

import os

import numpy as np
import pytest

import chip_smoke
import hyperspace_tpu_torch as hst
from hyperspace_tpu.engine import physical as jax_physical
from hyperspace_tpu.telemetry.profiling import last_join_stages as jax_last_join_stages
from hyperspace_tpu_torch.engine import physical, scan_cache
from hyperspace_tpu_torch.telemetry.profiling import last_join_stages
from test_torch_aggregate import assert_same
from test_torch_udf_setops import Twin

SS_ROWS = 80_000
FILES = 6
NUM_BUCKETS = 16


@pytest.fixture(scope="module")
def lake(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("tpcds_star"))
    tables = chip_smoke.star_tables(np.random.RandomState(19), SS_ROWS)
    writer = hst.HyperspaceSession(warehouse=os.path.join(base, "writer"), device="cpu")
    chip_smoke.write_star_tables(writer, tables, base, FILES)
    twin = Twin(base, buckets=NUM_BUCKETS)
    mp = pytest.MonkeyPatch()
    mp.setenv("HYPERSPACE_DISTRIBUTED", "0")
    for p in (twin.t, twin.j):
        for table, name, indexed, included in chip_smoke.STAR_INDEXES:
            p.index(table, name, indexed, included)
    mp.undo()
    return twin, tables


@pytest.fixture(autouse=True)
def _reference_path(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    monkeypatch.setenv("HYPERSPACE_FORCE_DEVICE_OPS", "1")
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()
    jax_physical.clear_device_memos()
    yield
    for flag in ("HYPERSPACE_MULTIWAY", "HYPERSPACE_QUERY_STREAMING"):
        os.environ.pop(flag, None)


def _stars(p, df):
    phys = physical if p.name == "torch" else jax_physical
    return [n for n in df.physical_plan().collect_nodes() if isinstance(n, phys.MultiwayJoinExec)]


@pytest.mark.parametrize("way", chip_smoke.STAR_WAYS)
@pytest.mark.parametrize("step", sorted(chip_smoke.STAR_QUERIES))
def test_star_query_equals_jax_and_numpy(lake, step, way):
    twin, tables = lake
    make, measure = chip_smoke.STAR_QUERIES[step]
    wants_star = chip_smoke.star_way(hst, twin.t.s, way)  # the flags are the process's: both packages read them
    (twin.j.off if way == "disabled" else twin.j.on)(twin.j.s)

    def q(p):
        return make(p.read, p.col, measure)

    stars = [len(_stars(p, q(p))) for p in (twin.t, twin.j)]
    assert stars == [int(wants_star)] * 2
    before = (last_join_stages(), jax_last_join_stages())
    got = twin.same(q)
    after = (last_join_stages(), jax_last_join_stages())
    streamed = [a is not None and a != b and a.get("join_mode") == "star" for a, b in zip(after, before)]
    assert streamed == [way == "star"] * 2
    if way == "star":
        assert after[0]["direct_cells"] == after[1]["direct_cells"] == (step != "a_q3")
        assert [d["pairs"] for d in after[0]["star_dims"]] == [d["pairs"] for d in after[1]["star_dims"]]
    want = chip_smoke.expected_star(tables, step)
    assert len(want[list(want)[-1]]) >= 3
    chip_smoke.check_star_rows(f"{step} {way}", got.to_numpy(), want)


def test_the_four_ways_agree(lake):
    """Within the port, the four ways give one answer per step (the float
    sums of the star and the one-pass paths within rtol 1e-9)."""
    twin, _ = lake
    for step, (make, measure) in chip_smoke.STAR_QUERIES.items():
        outs = []
        for way in chip_smoke.STAR_WAYS:
            chip_smoke.star_way(hst, twin.t.s, way)
            outs.append(make(twin.t.read, twin.t.col, measure).collect())
        for out in outs[1:]:
            assert_same(out, outs[0], approx_cols=("ext_price", "sum_agg") if measure == "ss_net_paid" else ())
    chip_smoke.star_way(hst, twin.t.s, "star")


def test_a_streamed_scan_aggregate_over_the_monthly_files(lake, monkeypatch):
    """Phase star's step (d): the store aggregate streams file by file and
    equals the JAX package's stream and numpy."""
    twin, tables = lake
    for p in (twin.t, twin.j):
        p.on(p.s)
    got = twin.same(lambda p: chip_smoke.star_store_query(p.read))
    chip_smoke.check_store_agg("d", got.to_numpy(), chip_smoke.expected_store_agg(tables["store_sales"]))

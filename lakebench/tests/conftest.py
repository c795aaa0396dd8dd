"""Shared fixtures of the benchmark's CPU tests: cells cut to a size the CPU
runs in seconds (the card runs the configurations as they are)."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TPCH = "tpch_sf10.q3_streams3"
TPCDS = "tpcds_sf10.q3q55_streams3"
CELLS = (TPCH, TPCDS)
#: Cells whose files are here and that BENCHMARK.json does not list yet:
#: (configuration file, traffic mix, per-layer metrics beyond the listed ones).
CANDIDATES = {TPCDS: ("lakebench/configs/tpcds_sf10.json", "q3q55_streams3",
                      [{"name": "k1_roofline", "unit": "%"}])}
SEED = 2**31 + 12345  # a seed beyond 32 signed bits


def tiny_config(config: dict, ss_rows: int = 300_000) -> dict:
    c = copy.deepcopy(config)
    if "scale_factor" in c:
        c["scale_factor"] = 0.01
    else:
        c["rows"] = {"store_sales": ss_rows, "item": 2000, "date_dim": 73049}
    c["num_buckets"] = 8
    return c


def tiny_cell(name: str, **kw):
    from lakebench import spec

    bench = spec.benchmark()
    if name in CANDIDATES:
        conf, traffic, extra = CANDIDATES[name]
        cell = spec.assemble(name, 1, conf, traffic, [m for m in bench["end_to_end"] if "workloads" not in m],
                             [m for m in bench["per_layer"] if m["name"] != "p95_ms.qps"] + extra)
    else:
        cell = spec.cell(name, bench)
    cell.config = tiny_config(cell.config, **kw)
    return cell


@pytest.fixture
def card():
    """Skips the test where no CUDA device is visible; decided here, never
    while a module is imported."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.cuda.get_device_name(0)

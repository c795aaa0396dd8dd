#!/usr/bin/env python3
"""Drive hyperspace_tpu_torch on one NVIDIA GPU and check what it computes.

    python3 chip_smoke.py                     # every phase
    python3 chip_smoke.py --phases env,kernels

Phases, each failing loudly:

1. env       the card's name and power limit, torch and CUDA versions; build
             the CUDA kernels from `hyperspace_tpu_torch/csrc` (timed).
2. kernels   K1 (in-bucket sort) and K2 (range probe) against their plain
             PyTorch versions at the slice's shapes and edge cases. Outputs
             are integers: tolerance 0. Times kernel, plain version, the
             library call computing the same function, and the bound.
3. main      TPC-H SF1-shaped data made with numpy from --seed (spec clause
             4.2.3 rules, numeric columns), four `create_index` calls, then
             Q3's join (value mode: K2) and Q9's join (hash mode: K1 + K2),
             count and collect, cold and a p50 of 3. Each plan must scan the
             indexes, each kernel must launch, and counts and rows must equal
             a numpy join computed straight from the generated arrays.
4. identity  the same slice at SF 0.05 with device="cpu" and device="cuda":
             identical index files, identical rows in identical order.

Prints one JSON line of per-kernel results, the card's `nvidia-smi` line,
and last `{"ok": true, "device": {...}}`. Exits non-zero without a result
when no CUDA device is visible or the package is missing.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
SCALAR_OPS_PER_S = 67e12  # H100 SXM non-tensor 32-bit rate (NVIDIA data sheet)
NUM_BUCKETS = 200
PAD = np.iinfo(np.int64).max


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds of `fn()` on the current stream, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wall(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def sort_case(rng, rows: int, cap: int, kind: str = "hash", fill=(0.0, 1.0)) -> np.ndarray:
    """A padded [rows, cap] int64 key matrix as the join builds it: a valid
    prefix per row (a `fill` fraction of cap), int64-max pads after it."""
    if kind == "dup":
        keys = np.full((rows, cap), 7, np.int64)
    elif kind == "extreme":
        keys = rng.choice(
            np.array([-(2**63), -(2**63) + 1, -1, 0, 1, 2**63 - 2], np.int64), size=(rows, cap)
        )
    else:
        keys = rng.randint(-(2**62), 2**62, size=(rows, cap), dtype=np.int64)
    lens = rng.randint(int(fill[0] * cap), int(fill[1] * cap) + 1, size=rows)
    if kind == "allpad":
        lens[:] = 0
    for b in range(rows):
        keys[b, lens[b]:] = PAD
    return keys


def probe_case(rng, rows: int, cap_l: int, cap_r: int, dtype=np.int64, distinct: int = 0,
               fill=(0.0, 1.0)):
    """Sorted padded left/right matrices and valid lengths (a `fill` fraction
    of each cap); keys drawn from `distinct` values so duplicate runs occur."""
    hi = distinct or 4 * cap_r
    l_len = rng.randint(int(fill[0] * cap_l), int(fill[1] * cap_l) + 1, size=rows)
    r_len = rng.randint(int(fill[0] * cap_r), int(fill[1] * cap_r) + 1, size=rows)
    ls = np.full((rows, cap_l), PAD, np.int64)
    rs = np.full((rows, cap_r), PAD, np.int64)
    for b in range(rows):
        ls[b, : l_len[b]] = np.sort(rng.randint(0, hi, l_len[b]))
        rs[b, : r_len[b]] = np.sort(rng.randint(0, hi, r_len[b]))
    if dtype == np.float64:
        ls = np.where(ls == PAD, np.finfo(np.float64).max, (ls - hi / 2) / 7.0)
        rs = np.where(rs == PAD, np.finfo(np.float64).max, (rs - hi / 2) / 7.0)
    return ls, rs, l_len.astype(np.int64), r_len.astype(np.int64)


def check_sort(torch, cuda_sort, keys_np) -> int:
    keys = torch.from_numpy(keys_np).cuda()
    got_k, got_o = cuda_sort.sort_rows(keys)
    ref_k, ref_o = cuda_sort.sort_rows_plain(keys)
    torch.cuda.synchronize()
    if not (torch.equal(got_k, ref_k) and torch.equal(got_o, ref_o)):
        raise AssertionError(f"K1 disagrees with its plain version at {keys_np.shape}")
    return 0


def check_probe(torch, cuda_probe, ls_np, rs_np, l_len_np, r_len_np) -> int:
    args = [torch.from_numpy(a).cuda() for a in (ls_np, rs_np, l_len_np, r_len_np)]
    got_lo, got_c = cuda_probe.range_probe(*args)
    ref_lo, ref_c = cuda_probe.range_probe_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(got_lo, ref_lo) and torch.equal(got_c, ref_c)):
        raise AssertionError(f"K2 disagrees with its plain version at {ls_np.shape} x {rs_np.shape}")
    return 0


def phase_kernels(torch, rng):
    from hyperspace_tpu_torch.ops import cuda_probe, cuda_sort

    # Edge cases first: exact equality, no timing.
    for rows, cap, kind in [
        (3, 1, "hash"), (5, 2, "hash"), (7, 256, "hash"), (4, 16384, "hash"),
        (4, 32768, "hash"), (3, 65536, "hash"), (6, 1024, "dup"), (6, 1024, "allpad"),
        (6, 4096, "extreme"), (9, 8, "hash"),
    ]:
        check_sort(torch, cuda_sort, sort_case(rng, rows, cap, kind))
    for rows, cap_l, cap_r, dtype, distinct in [
        (5, 1, 1, np.int64, 0), (5, 2, 256, np.int64, 0), (7, 256, 256, np.int64, 3),
        (6, 4096, 4096, np.int64, 0), (6, 1024, 8192, np.int64, 50), (6, 512, 512, np.float64, 40),
        (4, 2048, 32768, np.float64, 0),
    ]:
        check_probe(torch, cuda_probe, *probe_case(rng, rows, cap_l, cap_r, dtype, distinct))
    ls, rs, l_len, r_len = probe_case(rng, 4, 64, 64)
    r_len[0] = 0
    l_len[1] = 0
    check_probe(torch, cuda_probe, ls, rs, l_len, r_len)
    ext = np.array([[-(2**63), -5, 0, 2**63 - 2]], np.int64)
    check_probe(torch, cuda_probe, ext, ext.copy(), np.array([4]), np.array([4]))
    log("[kernels] edge cases: K1 and K2 equal their plain versions exactly")

    shapes = []
    # K1 at the slice's shapes: lineitem buckets (cap 32768) and partsupp (4096).
    # Buckets fill 88-96% of their pow2 cap at SF1 (lineitem ~30K of 32768).
    main_fill = (0.88, 0.96)
    for rows, cap in [(256, 32768), (256, 4096)]:
        keys_np = sort_case(rng, rows, cap, fill=main_fill)
        check_sort(torch, cuda_sort, keys_np)
        keys = torch.from_numpy(keys_np).cuda()
        n = rows * cap
        b_ms, b_by = bound(n * (8 + 8 + 4), rows * cap * np.log2(max(cap, 2)))
        shapes.append({
            "kernel": "K1", "shape": [rows, cap],
            "ms": cuda_ms(lambda: cuda_sort.sort_rows(keys)),
            "plain_ms": cuda_ms(lambda: cuda_sort.sort_rows_plain(keys)),
            "library_ms": cuda_ms(lambda: torch.sort(keys, dim=1, stable=True)),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0,
        })
    # K2: orders (8192) into lineitem (32768), partsupp (4096) into lineitem.
    for rows, cap_l, cap_r in [(256, 8192, 32768), (256, 4096, 32768)]:
        ls_np, rs_np, l_len_np, r_len_np = probe_case(rng, rows, cap_l, cap_r, fill=main_fill)
        check_probe(torch, cuda_probe, ls_np, rs_np, l_len_np, r_len_np)
        ls, rs, l_len, r_len = (torch.from_numpy(a).cuda() for a in (ls_np, rs_np, l_len_np, r_len_np))
        n_l, n_r = int(l_len_np.sum()), int(r_len_np.sum())
        nbytes = 8 * n_l + 8 * n_r + 8 * rows + 8 * rows * cap_l
        ops = 2 * n_l * np.log2(max(int(r_len_np.max()), 2))
        b_ms, b_by = bound(nbytes, ops)
        shapes.append({
            "kernel": "K2", "shape": [[rows, cap_l], [rows, cap_r]],
            "ms": cuda_ms(lambda: cuda_probe.range_probe(ls, rs, l_len, r_len)),
            "plain_ms": cuda_ms(lambda: cuda_probe.range_probe_plain(ls, rs, l_len, r_len), iters=3, warmup=1),
            "library_ms": cuda_ms(
                lambda: (torch.searchsorted(rs, ls), torch.searchsorted(rs, ls, right=True))
            ),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0,
        })
    for s in shapes:
        log(f"[kernels] {json.dumps(s)}")
    return shapes


# ---------------------------------------------------------------------------
# TPC-H-shaped data (spec clause 4.2.3, numeric columns)
# ---------------------------------------------------------------------------


def tpch(sf: float, seed: int):
    rng = np.random.RandomState(seed)
    n_orders = int(1_500_000 * sf)
    n_cust = int(150_000 * sf)
    n_part = int(200_000 * sf)
    n_supp = int(10_000 * sf)
    i = np.arange(n_orders, dtype=np.int64)
    o_orderkey = (i // 8) * 32 + (i % 8) + 1  # sparse keys: 8 of every 32
    k = rng.randint(0, (2 * n_cust) // 3, n_orders).astype(np.int64)
    o_custkey = 3 * (k // 2) + (k % 2) + 1  # every third customer has no orders
    lines = rng.randint(1, 8, n_orders)
    n_lines = int(lines.sum())
    l_orderkey = np.repeat(o_orderkey, lines)
    first = np.cumsum(lines) - lines
    l_linenumber = (np.arange(n_lines) - np.repeat(first, lines) + 1).astype(np.int64)
    l_partkey = rng.randint(1, n_part + 1, n_lines).astype(np.int64)
    supp_i = rng.randint(0, 4, n_lines).astype(np.int64)

    def suppkey(p, j):
        return (p + j * (n_supp // 4 + (p - 1) // n_supp)) % n_supp + 1

    l_suppkey = suppkey(l_partkey, supp_i)
    l_quantity = rng.randint(1, 51, n_lines).astype(np.float64)
    retail = (90000 + (l_partkey // 10) % 20001 + 100 * (l_partkey % 1000)) / 100.0
    l_extendedprice = np.round(l_quantity * retail, 2)
    l_discount = rng.randint(0, 11, n_lines) / 100.0
    l_tax = rng.randint(0, 9, n_lines) / 100.0
    charge = l_extendedprice * (1 + l_tax) * (1 - l_discount)
    o_totalprice = np.round(np.add.reduceat(charge, first), 2)
    ps_partkey = np.repeat(np.arange(1, n_part + 1, dtype=np.int64), 4)
    ps_suppkey = suppkey(ps_partkey, np.tile(np.arange(4, dtype=np.int64), n_part))
    ps_availqty = rng.randint(1, 10000, 4 * n_part).astype(np.int64)
    ps_supplycost = rng.randint(100, 100001, 4 * n_part) / 100.0
    return {
        "lineitem": {
            "l_orderkey": l_orderkey, "l_partkey": l_partkey, "l_suppkey": l_suppkey,
            "l_linenumber": l_linenumber, "l_quantity": l_quantity,
            "l_extendedprice": l_extendedprice, "l_discount": l_discount, "l_tax": l_tax,
        },
        "orders": {"o_orderkey": o_orderkey, "o_custkey": o_custkey, "o_totalprice": o_totalprice},
        "partsupp": {
            "ps_partkey": ps_partkey, "ps_suppkey": ps_suppkey,
            "ps_availqty": ps_availqty, "ps_supplycost": ps_supplycost,
        },
        "n_supp": n_supp,
    }


def np_join(lk: np.ndarray, rk: np.ndarray):
    """All equal-key (left, right) index pairs of two int64 key arrays."""
    r_order = np.argsort(rk, kind="stable")
    rs = rk[r_order]
    lo = np.searchsorted(rs, lk, "left")
    cnt = np.searchsorted(rs, lk, "right") - lo
    li = np.repeat(np.arange(len(lk)), cnt)
    off = np.arange(len(li)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    return li, r_order[lo[li] + off]


def expected_rows(data):
    li, od, ps = data["lineitem"], data["orders"], data["partsupp"]
    a, b = np_join(li["l_orderkey"], od["o_orderkey"])
    q_ord = {"l_extendedprice": li["l_extendedprice"][a], "o_custkey": od["o_custkey"][b]}
    s = data["n_supp"] + 1
    a, b = np_join(li["l_partkey"] * s + li["l_suppkey"], ps["ps_partkey"] * s + ps["ps_suppkey"])
    q_ps = {"l_quantity": li["l_quantity"][a], "ps_supplycost": ps["ps_supplycost"][b]}
    return q_ord, q_ps


def canonical(rows: dict) -> dict:
    """Columns reordered by a lexsort of all of them: equal multisets of rows
    give equal canonical columns."""
    order = np.lexsort([rows[n] for n in reversed(list(rows))])
    return {n: rows[n][order] for n in rows}


def same_multiset(got: dict, want_canonical: dict) -> bool:
    if list(got) != list(want_canonical):
        return False
    got = canonical(got)
    return all(np.array_equal(got[n], want_canonical[n]) for n in got)


# ---------------------------------------------------------------------------
# The slice through the port's entry points
# ---------------------------------------------------------------------------

INDEXES = [
    ("lineitem", "liOrd", ["l_orderkey"], ["l_quantity", "l_extendedprice", "l_discount"]),
    ("orders", "ordIdx", ["o_orderkey"], ["o_custkey", "o_totalprice"]),
    ("lineitem", "liPs", ["l_partkey", "l_suppkey"], ["l_quantity", "l_extendedprice"]),
    ("partsupp", "psIdx", ["ps_partkey", "ps_suppkey"], ["ps_supplycost", "ps_availqty"]),
]


def write_sources(data, base: str) -> None:
    from hyperspace_tpu_torch.engine import io as engine_io
    from hyperspace_tpu_torch.engine.table import Table

    for name in ("lineitem", "orders", "partsupp"):
        engine_io.write_parquet(
            Table.from_pydict(data[name], "cpu"), os.path.join(base, "src", name, "part-00000.parquet")
        )


def build(base: str, device, warehouse=None):
    """Sessions over the sources under `base/src`; indexes in `warehouse`."""
    import hyperspace_tpu_torch as hst

    s = hst.HyperspaceSession(warehouse=warehouse or base, device=device)
    s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    hs = hst.Hyperspace(s)
    seconds = {}
    for src, name, indexed, included in INDEXES:
        df = s.read.parquet(os.path.join(base, "src", src))
        _, seconds[name] = wall(lambda: hs.create_index(df, hst.IndexConfig(name, indexed, included)))
    hst.enable_hyperspace(s)
    return s, seconds


def queries(s, base: str):
    from hyperspace_tpu_torch import col

    def rd(name):
        return s.read.parquet(os.path.join(base, "src", name))

    q_ord = rd("lineitem").join(rd("orders"), col("l_orderkey") == col("o_orderkey")).select(
        "l_extendedprice", "o_custkey"
    )
    q_ps = rd("lineitem").join(
        rd("partsupp"), (col("l_partkey") == col("ps_partkey")) & (col("l_suppkey") == col("ps_suppkey"))
    ).select("l_quantity", "ps_supplycost")
    return {"q_ord": q_ord, "q_ps": q_ps}


def scanned_indexes(df):
    from hyperspace_tpu_torch.engine.physical import BucketedIndexScanExec

    return sorted(
        n.relation.index_name for n in df.physical_plan().collect_nodes()
        if isinstance(n, BucketedIndexScanExec)
    )


def phase_main(torch, seed: int, sf: float):
    from hyperspace_tpu_torch.ops import cuda_probe, cuda_sort

    t0 = time.perf_counter()
    data = tpch(sf, seed)
    want = {n: canonical(rows) for n, rows in zip(("q_ord", "q_ps"), expected_rows(data))}
    n_li = len(data["lineitem"]["l_orderkey"])
    log(f"[main] TPC-H SF{sf}: lineitem {n_li} rows, orders {len(data['orders']['o_orderkey'])}, "
        f"partsupp {len(data['partsupp']['ps_partkey'])} (generated in {time.perf_counter() - t0:.2f} s)")
    base = tempfile.mkdtemp(prefix="hs_smoke_sf1_")
    try:
        write_sources(data, base)
        cuda_sort.launches = 0
        cuda_probe.launches = 0
        s, build_s = build(base, "cuda")
        log(f"[main] build seconds {json.dumps(build_s)}")
        qs = queries(s, base)
        expect_idx = {"q_ord": ["liOrd", "ordIdx"], "q_ps": ["liPs", "psIdx"]}
        times = {}
        for name, df in qs.items():
            if scanned_indexes(df) != expect_idx[name]:
                raise AssertionError(f"{name}: the plan does not scan the indexes:\n{df.explain_string()}")
            k1, k2 = cuda_sort.launches, cuda_probe.launches
            counts, collects = [], []
            for _ in range(4):
                n, t_count = wall(df.count)
                out, t_collect = wall(df.collect)
                counts.append(t_count)
                collects.append(t_collect)
                if n != len(want[name][next(iter(want[name]))]):
                    raise AssertionError(f"{name}: count {n} != numpy join")
                got = out.to_numpy()
                if not same_multiset(got, want[name]):
                    raise AssertionError(f"{name}: collected rows differ from the numpy join")
            d1, d2 = cuda_sort.launches - k1, cuda_probe.launches - k2
            if d2 == 0 or (name == "q_ps" and d1 == 0):
                raise AssertionError(f"{name}: kernels not launched (K1 {d1}, K2 {d2})")
            times[name] = {
                "rows": n, "count_cold_s": counts[0], "count_p50_s": float(np.median(counts[1:])),
                "collect_cold_s": collects[0], "collect_p50_s": float(np.median(collects[1:])),
                "k1_launches": d1, "k2_launches": d2,
            }
            log(f"[main] {name} {json.dumps(times[name])}")
        launches = {"K1": cuda_sort.launches, "K2": cuda_probe.launches}
        log(f"[main] counts and rows equal the numpy join; launches {json.dumps(launches)}")
        for name, df in qs.items():
            log(f"[main] {name} warm collect breakdown {json.dumps(stage_breakdown(torch, df))}")
        return launches, build_s, times
    finally:
        shutil.rmtree(base, ignore_errors=True)


def stage_breakdown(torch, df) -> dict:
    """Seconds of each stage of one warm `collect()`, run step by step with a
    synchronize after each (the steps `SortMergeJoinExec.execute` chains), and
    the device's busy share of a whole warm `collect()` from `torch.profiler`."""
    from hyperspace_tpu_torch.engine.physical import ExecContext, _assemble_join, _classed_plan, _verify_pairs
    from hyperspace_tpu_torch.ops.bucket_join import classed_pairs, probe_classed

    project = df.physical_plan()
    join = project.child
    ctx = ExecContext(df.session)
    t = {}
    (left, l_starts), t["scan_left_s"] = wall(lambda: join.left.execute_concat(ctx))
    (right, r_starts), t["scan_right_s"] = wall(lambda: join.right.execute_concat(ctx))
    plan, t["layout_s"] = wall(
        lambda: _classed_plan(left, right, join.left_keys, join.right_keys, l_starts, r_starts)
    )
    ranges, t["probe_s"] = wall(lambda: probe_classed(plan))
    (li, ri), t["expand_s"] = wall(lambda: classed_pairs(plan, ranges))
    (li, ri), t["verify_s"] = wall(lambda: _verify_pairs(left, right, join.left_keys, join.right_keys, li, ri))
    out, t["gather_s"] = wall(lambda: _assemble_join(left, right, li, ri).select(project.column_names))
    _, t["to_host_s"] = wall(lambda: out.to("cpu"))
    t["mode"] = plan.mode
    t["classes"] = [[int(len(seg.ids)), seg.l.cap, seg.r.cap] for seg in plan.segments]
    t["outlier_buckets"] = int(len(plan.outlier_ids))
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall_s = wall(df.collect)
    device_us = sum(
        getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) for e in prof.key_averages()
    )
    t["profiled_collect_s"] = wall_s
    t["device_busy_s"] = device_us / 1e6
    t["device_busy_share"] = device_us / 1e6 / wall_s if device_us else None
    return t


def phase_identity(torch, seed: int, sf: float) -> None:
    data = tpch(sf, seed)
    base = tempfile.mkdtemp(prefix="hs_smoke_ident_")
    try:
        write_sources(data, base)
        results, files = {}, {}
        for device in ("cpu", "cuda"):
            wh = os.path.join(base, device)
            s, _ = build(base, device, warehouse=wh)
            results[device] = {n: df.collect().to_numpy() for n, df in queries(s, base).items()}
            root = os.path.join(wh, "indexes")
            files[device] = {
                os.path.relpath(os.path.join(d, f), root): hashlib.sha256(open(os.path.join(d, f), "rb").read()).hexdigest()
                for d, _, fs in os.walk(root) for f in fs if f.endswith(".parquet")
            }
        if files["cpu"] != files["cuda"]:
            raise AssertionError("index files built on the CPU and on the GPU differ")
        for name in results["cpu"]:
            a, b = results["cpu"][name], results["cuda"][name]
            if list(a) != list(b) or not all(np.array_equal(a[k], b[k]) for k in a):
                raise AssertionError(f"{name}: CPU and GPU rows differ (values or order)")
        log(f"[identity] SF{sf}: {len(files['cpu'])} identical index files; "
            f"q_ord {len(next(iter(results['cpu']['q_ord'].values())))} rows and "
            f"q_ps {len(next(iter(results['cpu']['q_ps'].values())))} rows identical in order")
    finally:
        shutil.rmtree(base, ignore_errors=True)


KERNEL_META = {
    "K1": ("bucket_sort", "hyperspace_tpu_torch/csrc/bucket_sort.cu", "hyperspace_tpu/ops/pallas_sort.py:107"),
    "K2": ("range_probe", "hyperspace_tpu_torch/csrc/range_probe.cu", "hyperspace_tpu/ops/pallas_probe.py:129"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="env,kernels,main,identity")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--identity-sf", type=float, default=0.05)
    args = ap.parse_args()
    phases = args.phases.split(",")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from hyperspace_tpu_torch.ops import _kernels
    except ImportError as e:
        print(f"chip_smoke: hyperspace_tpu_torch is not importable here: {e}", file=sys.stderr)
        return 2

    smi = nvidia_smi_line()
    log(smi)
    log(f"[env] torch {torch.__version__} CUDA {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    _kernels.library()
    log(f"[env] kernels built in {_kernels.build_seconds:.2f} s")
    rng = np.random.RandomState(args.seed)
    shapes = phase_kernels(torch, rng) if "kernels" in phases else []
    launches = {}
    if "main" in phases:
        launches, _build_s, _times = phase_main(torch, args.seed, args.sf)
    if "identity" in phases:
        phase_identity(torch, args.seed, args.identity_sf)
    kernels = []
    for kid, (name, source, replaces) in KERNEL_META.items():
        main_shape = next((s for s in shapes if s["kernel"] == kid), None)
        if main_shape is None:
            continue
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches.get(kid, 0), "max_abs_err": main_shape["max_abs_err"],
            "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
            "library_ms": main_shape["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of BENCHMARK.json once on the card and print its result.

    python3 lakebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. With `--trace 0` the last line of standard
output carries the cell's end-to-end metrics; with `--trace 1` its per-layer
metrics, read with the program's tracing on and a `torch.profiler` stretch in
the middle of the window. Each number compared with its limit is printed as
the last lines of standard error and under `checks`, the line's last key. The
run refuses (exit 2, no result) without a CUDA device or with fewer than the
cell asks for, and fails (exit 3, no result) when jax, jaxlib, flax or the JAX
package was loaded. Everything it writes lies under `.lakebench/` in the
checkout and is removed at its end.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: Top-level module names no run may load.
FORBIDDEN = ("jax", "jaxlib", "flax", "hyperspace_tpu")


def forbidden_modules(names) -> list:
    """The forbidden top-level names among module names, compared whole
    (the part before the first dot)."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(run, kind: str) -> dict:
    """The result a finished run prints: `metrics` are the cell's end-to-end
    metrics, or with a traced run its per-layer ones and the traced
    stretch's device numbers; `checks` comes last."""
    from lakebench import devtrace

    device = {"platform": "gpu", "kind": kind, "count": run.cell.chips, "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": run.correct(), "attempted": len(run.queries), "failed": run.failed(),
              "metrics": run.per_layer() if run.trace else run.end_to_end(), "device": device}
    if run.trace:
        device["busy_s"] = devtrace.busy_seconds(run.stretch)
        device["window_s"] = run.stretch.seconds
        result["breakdown"] = devtrace.breakdown(run.stretch)
    result["checks"] = run.checks()
    return result


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, ROOT)
    from lakebench import spec

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"lakebench: {args.workload} needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    scratch = os.path.join(ROOT, ".lakebench")
    spans_path = os.path.join(scratch, "spans.jsonl")
    shutil.rmtree(scratch, ignore_errors=True)
    os.makedirs(scratch)
    if args.trace:
        os.environ["HYPERSPACE_TRACING"] = "1"
        os.environ["HYPERSPACE_TRACE_FILE"] = spans_path
        os.environ["HYPERSPACE_TRACE_MAX_MB"] = "100000"
    from lakebench.harness import Run

    run = Run(cell, args.seed, args.seconds, bool(args.trace), os.path.join(scratch, "run"), "cuda",
              t_process=T_PROCESS)
    try:
        run.setup()
        run.measure()
        run.release()
        run.check_plans()
        run.judge()
        if args.trace:
            run.load_spans(spans_path)
        result = result_line(run, torch.cuda.get_device_name(0))
        report(run)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"lakebench: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def report(run) -> None:
    """What the run did besides its result, on standard error."""
    import numpy as np
    from hyperspace_tpu_torch.telemetry import compile_log

    lat = [q.latency_s for q in sorted(run.completed(), key=lambda q: q.t_submit)]
    info = {
        "setup_parts_s": run.setup_parts, "index_build_s": run.index_build_s,
        "queries": len(run.queries), "completed_in_window": len(run.completed()),
        "latency_ms_first10_rest": [1e3 * float(np.median(x)) if len(x) else None for x in (lat[:10], lat[10:])],
        "launches": {k: run.counter_delta(f"kernel.launches.{v}") for k, v in compile_log.LABELS.items()},
        "window_counters": {n: run.counter_delta(n) for n in (
            "memo.evictions", "memo.pairs.hits", "memo.pairs.misses", "memo.pad.misses", "memo.k64.misses",
            "cache.filtered.hits", "cache.filtered.misses", "cache.filtered.evictions",
            "cache.bucketed_concat.evictions", "cache.scan.evictions", "cache.concat.evictions")},
    }
    for q in run.queries:
        if q.error or q.wrong or q.plan_miss:
            info.setdefault("failures", []).append(
                {"query": q.query, "params": q.params, "error": q.error, "wrong": q.wrong, "plan": q.plan_miss})
            if len(info["failures"]) >= 5:
                break
    print("lakebench: " + json.dumps(info, default=str), file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())

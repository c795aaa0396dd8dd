"""The control of a cell: its plain reference, computed in the precision just
below the one the configuration states (each reference's `CONTROL_DTYPE`),
put in the program's place and judged exactly as a run judges the program.
It has to come out not correct, on every seed; its readings set the upper
end of each limit in `limits/<cell>.json`.

    python3 lakebench/control.py --workload <cell> --seeds 1,2,3 --queries 300

`--queries` is how many queries the streams send, drawn from each seed as a
run's window draws them (a run judges as many). Needs no card and no program.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_run(cell, seed: int, queries: int):
    """A `harness.Run` whose queries carry the control's answers, judged."""
    from lakebench import spec, traffic
    from lakebench.harness import Query, Run

    run = Run(cell, seed, 0.0, False, workdir="", device="cpu")
    run.tables = spec.module("gen", cell.config["generator"]).generate(cell.config, seed)
    run.prepare_references()
    streams = [traffic.stream_queries(cell.mix, seed, s, "window") for s in range(int(cell.mix["streams"]))]
    for k in range(queries):
        s = k % len(streams)
        entry, params = next(streams[s])
        ref, state = run.refs[entry["query"]]
        q = Query(s, entry["query"], params, [], 0.0)
        q.table = ref.answer(state, params, ref.CONTROL_DTYPE)
        run.queries.append(q)
    run.judge()
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--queries", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from lakebench import spec

    cell = spec.cell(args.workload)
    for seed in (int(x) for x in args.seeds.split(",")):
        t = time.perf_counter()
        run = control_run(cell, seed, args.queries)
        print(json.dumps({"workload": args.workload, "seed": seed, "queries": len(run.queries),
                          "correct": run.correct(), "checks": run.checks(),
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

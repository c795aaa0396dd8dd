#!/usr/bin/env python
"""Time the port's index build on the CPU at phase star's itemIdx shape,
and pyarrow's fixed cost of writing one small parquet file.

    python tools/build_write_probe.py [REPO_ROOT] [ROWS]

REPO_ROOT (default: this checkout) is the tree whose `hyperspace_tpu_torch`
is imported, so a second checkout (say, a parent commit unpacked by `git
archive`) can be timed the same way. The source is one parquet file of ROWS
rows (default 18,000: an int64 key, an int, a string of 500 values and a
float), made with numpy from seed 0 in a temporary directory; it is built
three times into 200 buckets by a CPU session, and each build's seconds and
stage seconds (`last_build_stages()`) are printed. Then 600 files of 90 rows
(the rows of one of those buckets) are written with `pq.write_table`, one
after another, and the milliseconds a file are printed. These are CPU times
of the machine that runs the script, not a card's.
"""

import os
import shutil
import sys
import tempfile
import time

import numpy as np


def main() -> None:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.join(os.path.dirname(__file__), ".."))
    rows = int(sys.argv[2]) if len(sys.argv) > 2 else 18_000
    sys.path.insert(0, root)
    import pyarrow as pa
    import pyarrow.parquet as pq

    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch.engine import io as engine_io
    from hyperspace_tpu_torch.engine.table import Table
    from hyperspace_tpu_torch.telemetry.profiling import last_build_stages

    base = tempfile.mkdtemp(prefix="build_write_probe_")
    try:
        rng = np.random.RandomState(0)
        src = os.path.join(base, "src")
        engine_io.write_parquet(Table.from_pydict({
            "k": rng.randint(0, rows, rows).astype(np.int64),
            "i": rng.randint(0, 100, rows).astype(np.int64),
            "s": np.array([f"brand#{x}" for x in rng.randint(0, 500, rows)]),
            "f": rng.rand(rows),
        }, "cpu"), os.path.join(src, "part-00000.parquet"))
        for r in range(3):
            s = hst.HyperspaceSession(warehouse=os.path.join(base, f"wh{r}"), device="cpu")
            s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, 200)
            t0 = time.perf_counter()
            hst.Hyperspace(s).create_index(s.read.parquet(src), hst.IndexConfig("idx", ["k"], ["i", "s", "f"]))
            stages = last_build_stages()
            print(f"build {r}: {time.perf_counter() - t0:.3f} s",
                  {k: v for k, v in stages.items() if k.endswith("_s") or k == "ranges"})
        small = pa.table({"a": np.arange(90), "b": rng.rand(90),
                          "s": pa.array([f"x{i}" for i in range(90)]).dictionary_encode()})
        out = os.path.join(base, "small")
        os.makedirs(out)
        t0 = time.perf_counter()
        for i in range(600):
            pq.write_table(small, os.path.join(out, f"p{i}.parquet"), row_group_size=65536)
        print(f"pq.write_table of a 90-row file: {(time.perf_counter() - t0) / 600 * 1e3:.3f} ms")
    finally:
        shutil.rmtree(base, ignore_errors=True)


if __name__ == "__main__":
    main()

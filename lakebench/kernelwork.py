"""The work kernels K1 (in-bucket sort, `csrc/bucket_sort.cu`) and K2 (range
probe, `csrc/range_probe.cu`) have to do for the queries of a traced stretch,
counted from the joins' real (unpadded) input rows, which the references
know from the generated data.

- K1 sorts one side's n keys within its buckets: it reads each int64 key
  once and writes the sorted key and its int32 slot once (20 bytes a row),
  and makes n * log2(n / buckets) compares.
- K2 probes the smaller side into the larger, bucket by bucket (the
  program's rule): it reads each probing int64 key once and writes an int32
  (start, count) pair per probing row, and makes 2 * log2(larger / buckets)
  compares a probing row; of the larger side it needs at most the keys those
  binary searches touch, each once: min(larger, smaller * log2(larger /
  buckets)) keys. A handful of items probing a 28.8M-row fact reads a few
  kilobytes of it, not all of it.

Only a join that ran counts: the program keeps a pair's probe in a memo, and
a query that found it there launched nothing. A co-bucketed pair ran when
the query's ledger charged join pads; a star's dimension ran when the
query's `join:stages` record says its memo missed. Both come from the
program's own trace of the query, so this is read in traced runs only.
"""

from __future__ import annotations

import math
from typing import Tuple

Work = Tuple[float, float]  # (bytes, operations)


def _log2_per_bucket(n: float, buckets: int) -> float:
    return math.log2(max(n / max(buckets, 1), 2.0))


def k1_sort(n: float, buckets: int) -> Work:
    return 20.0 * n, n * _log2_per_bucket(n, buckets)


def k2_probe(n_a: float, n_b: float, buckets: int) -> Work:
    small, big = sorted((n_a, n_b))
    steps = _log2_per_bucket(big, buckets)
    return 8.0 * small + 8.0 * min(big, small * steps) + 8.0 * small, 2.0 * small * steps


def _ledger(spans) -> dict:
    root = next((s for s in spans if s.get("parent_id") is None), None)
    return (root or {}).get("attrs", {}).get("ledger") or {}


def _star_dims(spans) -> list:
    return [d for s in spans if s["name"] == "join:stages" for d in s.get("attrs", {}).get("star_dims", [])]


def query_work(run, q, kernel: str) -> Work:
    """(bytes, operations) kernel "K1" or "K2" had to do for query q."""
    ref, state = run.refs[q.query]
    rows = ref.join_rows(state, q.params)
    buckets = int(run.cell.config["num_buckets"])
    spans = run.trace_of(q)
    nbytes = ops = 0.0
    star = getattr(ref, "STAR", None)
    if star is not None:
        fact = rows[star]
        for d in _star_dims(spans):
            if d.get("memo") != "miss":
                continue
            n_dim = rows[d["index"]]
            parts = [k1_sort(fact, buckets), k1_sort(n_dim, buckets)] if kernel == "K1" else [
                k2_probe(fact, n_dim, buckets)]
            nbytes += sum(p[0] for p in parts)
            ops += sum(p[1] for p in parts)
        return nbytes, ops
    if kernel == "K2" and _ledger(spans).get("pad_bytes_payload", 0) > 0:
        for a, b in getattr(ref, "PAIRS", ()):
            w = k2_probe(rows[a], rows[b], buckets)
            nbytes += w[0]
            ops += w[1]
    return nbytes, ops


def stretch_work(run, kernel: str) -> Work:
    total_b = total_o = 0.0
    for q in run.stretch_queries:
        b, o = query_work(run, q, kernel)
        total_b += b
        total_o += o
    return total_b, total_o

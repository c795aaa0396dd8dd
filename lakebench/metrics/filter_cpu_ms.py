"""Operators: the self CPU of a query's filters (`FilterExec`), summed per
query, mean over the window's completed queries, in ms: each `op:Filter`
span's `cpu_s` minus that of its child operator spans on its thread (its
steps `filter.key`, `filter.cache_get`, `filter.predicate`,
`filter.compact` and `filter.cache_put` are its own). A synchronize inside
it spins under CUDA's default scheduling, so it counts (measured on the
H100's host, PERF.md). A trace without `cpu_s` reads None."""

from lakebench.metrics.query_cpu_ms import op_self_cpu_s, per_query_ms


def read(run):
    return per_query_ms(run, lambda spans: op_self_cpu_s(spans, "op:Filter"))

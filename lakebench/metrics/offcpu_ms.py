"""Host: the time a query's own thread was off the CPU on something no span
names, mean over the window's completed queries, in ms: the root span's
`duration_s` minus its `cpu_s` minus the `wait_s` (single-flight waits) of
the spans on that thread. Under 3 streams that is mostly waiting for the
GIL. A wait on the card (`torch.cuda.synchronize()`, `.item()`, `.cpu()`,
`nonzero`) is not in it: under CUDA's default scheduling the host spins, so
the wait reads as CPU time (measured on the H100's host, PERF.md). A trace
without `cpu_s` reads None."""

from lakebench.metrics.query_cpu_ms import cpu_s, per_query_ms, tid


def offcpu_s(spans):
    root = spans[0]
    if cpu_s(root) is None or root.get("duration_s") is None:
        return None
    waits = sum(s["attrs"].get("wait_s", 0.0) for s in spans if tid(s) == tid(root))
    return root["duration_s"] - cpu_s(root) - waits


def read(run):
    return per_query_ms(run, offcpu_s)

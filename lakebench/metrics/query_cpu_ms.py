"""Host: the CPU time the program's threads spent on a query, from its
traced spans, mean over the window's completed queries, in ms: the root
span's `cpu_s` (the query's own thread, `time.thread_time` over the span)
plus the `cpu_s` of the outermost span of each other thread in its trace.
Time a thread waits for the GIL or blocks on a lock, an event or a sleep is
not CPU time. A wait on the card (`torch.cuda.synchronize()`, `.item()`,
`.cpu()`, `nonzero`) is: under CUDA's default scheduling the host spins
(measured on the H100's host, PERF.md). A trace without `cpu_s` (a program
that records none) reads None.

The mean, not the median: where the thread CPU clock counts in scheduler
ticks (10 ms on the H100's host), each query's reading is a multiple of the
tick, and a median of such readings sits on one; the mean of tick-sampled
times is not biased so.

The other host and operator readers share the helpers here."""

import statistics


def cpu_s(span):
    return span.get("attrs", {}).get("cpu_s")


def tid(span):
    return span.get("attrs", {}).get("tid")


def per_query_ms(run, reading):
    """The mean over the window's completed queries of `reading(spans)`
    (seconds, or None where a query's trace cannot say), in ms; None when
    no query's can."""
    vals = []
    for q in run.completed():
        spans = run.trace_of(q)
        if spans:
            v = reading(spans)
            if v is not None:
                vals.append(v)
    return 1e3 * statistics.fmean(vals) if vals else None


def query_cpu_s(spans):
    """The root's `cpu_s` and each other thread's outermost spans' (a span
    whose parent ran on another thread, not inside one already counted)."""
    root = spans[0]
    if cpu_s(root) is None:
        return None
    by_id = {s["span_id"]: s for s in spans}
    total = cpu_s(root)
    counted_to = {}
    tops = [s for s in spans[1:] if tid(s) != tid(root) and cpu_s(s) is not None and s.get("duration_s") is not None
            and tid(by_id.get(s["parent_id"], {})) != tid(s)]
    for s in sorted(tops, key=lambda s: s["start_s"]):
        if s["start_s"] < counted_to.get(tid(s), float("-inf")):
            continue
        counted_to[tid(s)] = s["start_s"] + s["duration_s"]
        total += cpu_s(s)
    return total


def op_self_cpu_s(spans, op):
    """The summed self CPU of the trace's spans named `op`: each one's
    `cpu_s` minus that of its nearest `op:*` descendants on its own thread
    (steps, `<op>.<step>`, are its own work and are not subtracted). None
    where one of them lacks `cpu_s`."""
    if cpu_s(spans[0]) is None:
        return None
    children = {}
    for s in spans:
        children.setdefault(s["parent_id"], []).append(s)
    total = 0.0
    for s in spans:
        if s["name"] != op:
            continue
        own = cpu_s(s)
        if own is None:
            return None
        stack = list(children.get(s["span_id"], ()))
        while stack:
            c = stack.pop()
            if not c["name"].startswith("op:"):
                stack.extend(children.get(c["span_id"], ()))
            elif tid(c) == tid(s):
                if cpu_s(c) is None:
                    return None
                own -= cpu_s(c)
        total += own
    return total


def read(run):
    return per_query_ms(run, query_cpu_s)

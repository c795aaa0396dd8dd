"""EXPLAIN ANALYZE: the plan tree with what happened when it ran
(counterpart of `hyperspace_tpu/plananalysis/analyze.py`).

`explain_analyze_string(df)` executes the query once under a trace capture
and renders the physical tree with each executed node's wall, rows out,
cache verdicts (`bucketed_cache`, `pairs_memo`), row-group pruning, retries
and kernel launches, the streamed executors' stage lines (per dimension for
a star join) under the node that ran them, then the sections: rule
decisions, planner, resource ledger, device cost, attribution, the kernel
launches of this query by label, and the process-wide counter deltas.

A node with no span did not execute: a streamed parent read it chunk by
chunk, a memo served it, or it is a star join's cascade that the star
stream replaced. It is marked so, never given a time it did not spend.

The JAX package's "Pallas kernel fallbacks" have no counterpart: the port's
kernels never fall back. Their place holds the launches per kernel label.
"""

from __future__ import annotations

from typing import Dict, List, Optional

NOT_EXECUTED = "   [not executed: fused/streamed into parent or served from cache]"

_VERDICT_KEYS = ("bucketed_cache", "pairs_memo", "row_groups_scanned", "row_groups_skipped", "io_retries")


def _fmt_seconds(s: Optional[float]) -> str:
    if s is None:
        return "?"
    if s >= 1:
        return f"{s:.3f}s"
    return f"{s * 1000:.1f}ms"


def _subtree_verdict(span, children_of, key, rendered_ids, own_id, depth: int = 0):
    """The first `key` verdict in the span's subtree that does not cross
    into another rendered node's spans."""
    v = span.attrs.get(key)
    if v is not None or depth >= 4:
        return v
    for child in children_of.get(span.span_id, ()):
        if not child.name.startswith("op:"):
            continue
        nid = child.attrs.get("node_id")
        if nid is not None and nid != own_id and nid in rendered_ids:
            continue
        v = _subtree_verdict(child, children_of, key, rendered_ids, own_id, depth + 1)
        if v is not None:
            return v
    return None


def _node_annotation(span, children_of, rendered_ids) -> str:
    parts = [f"time={_fmt_seconds(span.duration_s)}"]
    rows = span.attrs.get("rows_out")
    if rows is not None:
        parts.append(f"rows={rows}")
    own_id = span.attrs.get("node_id")
    for key in _VERDICT_KEYS:
        v = _subtree_verdict(span, children_of, key, rendered_ids, own_id)
        if v is not None:
            parts.append(f"{key}={v}")
    compiles = span.attrs.get("xla_compiles")
    if compiles:
        parts.append(f"compiles={compiles}(+{_fmt_seconds(span.attrs.get('xla_compile_s') or 0.0)})")
    launches = {k[len("launches."):]: v for k, v in span.attrs.items() if k.startswith("launches.")}
    if launches:
        parts.append("launches=" + ",".join(f"{k}:{v}" for k, v in sorted(launches.items())))
    if span.status != "ok":
        parts.append(f"status={span.status}")
    return "   [" + ", ".join(parts) + "]"


def _stage_lines(span, children_of, indent: int) -> List[str]:
    """The `<kind>:stages` children of one span, a busy-time line each, and
    for a star join one line per dimension."""
    out: List[str] = []
    pad = "  " * indent + "     "
    for child in children_of.get(span.span_id, ()):
        if not child.name.endswith(":stages"):
            continue
        kind = child.name.split(":", 1)[0]
        stages = [f"{st.name.split(':', 1)[1]}={_fmt_seconds(st.duration_s)}"
                  for st in children_of.get(child.span_id, ())]
        extra = []
        if child.attrs.get("wall_s") is not None:
            extra.append(f"wall={_fmt_seconds(child.attrs['wall_s'])}")
        if child.attrs.get("overlap_ratio") is not None:
            extra.append(f"overlap={child.attrs['overlap_ratio']}")
        if child.attrs.get("mode"):
            extra.append(f"mode={child.attrs['mode']}")
        out.append(pad + f"{kind} stages: " + " ".join(stages + extra))
        if child.attrs.get("join_mode") == "star":
            for dim in child.attrs.get("star_dims") or ():
                if not isinstance(dim, dict):
                    continue
                cells = [f"dim[{dim.get('index', '?')}]:"]
                for k in ("pad_s", "probe_s", "verify_s"):
                    if dim.get(k) is not None:
                        cells.append(f"{k[:-2]}={_fmt_seconds(dim[k])}")
                for k in ("buckets", "pairs", "memo"):
                    if dim.get(k) is not None:
                        cells.append(f"{k}={dim[k]}")
                out.append(pad + "  " + " ".join(cells))
        launches = child.attrs.get("launches")
        if launches:
            out.append(pad + "kernel launches: " + ", ".join(f"{k}={v}" for k, v in sorted(launches.items())))
    return out


def explain_analyze_string(df) -> str:
    """Execute `df` once under a trace and render the annotated tree."""
    return explain_analyze(df)[0]


def explain_analyze(df):
    """(the annotated tree's text, the result table on the CPU) of one traced
    run of `df`."""
    import time as _time

    from .. import resilience
    from ..engine.physical import ExecContext
    from ..telemetry import accounting, metrics, tracing
    from ..telemetry.device_observatory import table_to_host
    from . import attribution as _attribution
    from . import planner as _planner

    session = df.session
    snap0 = metrics.snapshot()
    with tracing.capture() as cap:
        # The scope mirrors collect(): the planner's decisions ride it into
        # the pool workers, so the analyzed run is the decided run.
        with resilience.query_scope("query:explain_analyze"):
            with tracing.query_span("query:explain_analyze") as root:
                accounting.note_device(session.device)
                with tracing.span("plan"):
                    phys = df.physical_plan()
                fp = df._attach_fingerprint(phys)
                pd = _planner.decide(phys, fp, session.device)
                with _planner.decisions_scope(pd):
                    t0 = _time.monotonic()
                    result = table_to_host(phys.execute(ExecContext(session)))
                _planner.observe(pd, _time.monotonic() - t0, stages=_attribution.query_stage_walls())
                root.set_attr("rows_out", int(result.num_rows))
                accounting.set_value("rows_produced", int(result.num_rows))
    snap1 = metrics.snapshot()
    trace = cap.trace
    if trace is None:
        return "EXPLAIN ANALYZE: no trace captured", result
    return render(trace, phys, result.num_rows, pd, snap0, snap1), result


def render(trace, phys, n_rows: int, pd, snap0: dict, snap1: dict) -> str:
    """The annotated tree and its sections from one captured trace."""
    from ..telemetry import accounting, metrics
    from . import attribution as _attribution
    from . import planner as _planner

    # The outermost span of a node wins (a node may open several).
    by_node: Dict[int, object] = {}
    for s in trace.spans:
        nid = s.attrs.get("node_id")
        if nid is not None and nid not in by_node:
            by_node[nid] = s
    children_of = trace.spans_by_parent()

    lines: List[str] = []
    root_span = trace.root
    lines += ["=" * 61, "EXPLAIN ANALYZE", "=" * 61]
    lines.append(f"query_id={trace.query_id}  wall={_fmt_seconds(root_span.duration_s)}  rows={n_rows}")
    plan_spans = trace.find("plan")
    if plan_spans:
        lines.append(f"planning={_fmt_seconds(plan_spans[0].duration_s)}")
    lines.append("")

    rendered_ids = {id(n) for n in phys.collect_nodes()}

    def walk(node, indent: int) -> None:
        line = node.format_line(indent)
        span = by_node.get(id(node))
        line += NOT_EXECUTED if span is None else _node_annotation(span, children_of, rendered_ids)
        lines.append(line)
        if span is not None:
            lines.extend(_stage_lines(span, children_of, indent))
        for c in node.children():
            walk(c, indent + 1)

    walk(phys, 0)
    root_stages = _stage_lines(root_span, children_of, 0)
    if root_stages:
        lines.append("")
        lines.extend(root_stages)

    decisions: List[dict] = []
    for s in trace.spans:
        if s.name.startswith("rule:"):
            decisions.extend(s.attrs.get("decisions", ()))
    lines += ["", "Rule decisions:"]
    if decisions:
        for d in decisions:
            verdict = "applied" if d.get("applied") else "skipped"
            detail = {k: v for k, v in d.items() if k not in ("rule", "applied") and v not in (None, [], {})}
            lines.append(f"  {d.get('rule')}: {verdict}" + (f"  {detail}" if detail else ""))
    else:
        lines.append("  (none recorded — no optimizer rules fired on this plan)")

    lines += ["", "Planner:"]
    if pd is None:
        lines.append("  (off: HYPERSPACE_PLANNER=0 — env-flag defaults in force)")
    else:
        from .costmodel import KNOBS

        wall_actual = root_span.duration_s or 0.0
        lines.append(f"  calibration={pd.calibration_source}  fingerprint={pd.fingerprint or '(not computed)'}")
        for knob in KNOBS:
            d = pd.decisions.get(knob)
            if d is None:
                continue
            drift = f"  drift_x={wall_actual / d.predicted_s:.2f}" if d.predicted_s and d.predicted_s > 0 else ""
            lines.append(
                f"  {knob}: {d.arm} [{d.source}]  predicted={_fmt_seconds(d.predicted_s)}  "
                f"(alt {_planner.arm_label(d.alt)}: {_fmt_seconds(d.predicted_alt_s)}){drift}"
            )
        lines.append(f"  actual wall={_fmt_seconds(wall_actual)}  (drift_x = wall / the arm's predicted attributable cost)")

    led = accounting.ledger_for(trace.query_id)
    led_d = led.to_dict() if led is not None else None
    lines += ["", "Resource ledger (this query):"]
    if led_d is not None:
        for key in sorted(k for k in led_d if k not in ("query_id", "name", "start_s")):
            lines.append(f"  {key}: {led_d[key]}")
    else:
        lines.append("  (no ledger recorded)")

    lines += ["", "Device cost (this query):"]
    if led_d is not None:
        dev_s = led_d.get("device_time_s")
        if dev_s is not None:
            wall = led_d.get("wall_s") or 0.0
            host_s = led_d.get("host_time_s", max(0.0, wall - dev_s))
            pct = f" ({dev_s / wall:.0%} of wall)" if wall else ""
            lines.append(f"  device={_fmt_seconds(dev_s)}{pct}  host={_fmt_seconds(host_s)}  (CUDA-event kernel probes)")
        else:
            lines.append("  device/host split unknown (set HYPERSPACE_DEVICE_TIMING=1 to sample kernel timing)")
        h2d, d2h = led_d.get("device_upload_bytes"), led_d.get("d2h_bytes")
        if h2d or d2h:
            lines.append(f"  transfers: h2d={h2d or 0}B d2h={d2h or 0}B")
        if led_d.get("pad_ratio") is not None:
            lines.append(
                f"  padding tax: payload={led_d.get('pad_bytes_payload', 0)}B "
                f"padded={led_d.get('pad_bytes_padded', 0)}B pad_ratio={led_d['pad_ratio']}"
            )
    else:
        lines.append("  (no ledger recorded)")

    attr_lines = _attribution.explain_lines(led_d)
    if attr_lines:
        lines.append("")
        lines.extend(attr_lines)

    delta = metrics.counters_delta(snap0, snap1)
    prefix = "kernel.launches."
    lines += ["", "Kernel launches (this query):"]
    launched = {k[len(prefix):]: v for k, v in delta.items() if k.startswith(prefix)}
    if launched:
        for label in sorted(launched):
            lines.append(f"  {label}: {launched[label]}")
    else:
        lines.append("  (none — no CUDA kernel ran: a CPU session, or every kernel result came from a memo)")

    lines += ["", "Cache/metric deltas (process-wide during this query):"]
    if delta:
        lines.extend(f"  {name}: +{delta[name]}" for name in sorted(delta))
    else:
        lines.append("  (none)")
    return "\n".join(lines)

"""The streamed executors: a scan's aggregate and a star join's aggregate,
chunk by chunk (counterpart of `hyperspace_tpu/engine/streaming.py`).

`stream_aggregate` (:181) runs a grouped aggregate over a multi-file scan
without concatenating it: `engine.io.iter_file_tables` decodes the files on
a pool ahead of the consumer (each through the per-file scan cache, pruned
by the scan's pushdown), each file's table splits into chunks of at most
`HYPERSPACE_QUERY_CHUNK_ROWS` rows, the Filter/Project/WithColumn chain above
the scan applies per chunk (`execute_stream`), and
`ops.aggregate.StreamAggregator` folds the chunks with a carry.

`stream_star_aggregate` (:559) runs a grouped aggregate over a recognized
star join (`MultiwayJoinExec`) without the cascade's intermediate tables.
Once per dimension it hashes the fact's foreign keys into the dimension's
buckets, lays the fact out in bucket order (`fact_bucket_layout`), builds
the size-classed plan in hash mode against the dimension's covering index
(each class row sorted by K1), probes it (K2), expands and verifies the
pairs exactly and orders them fact-major. Then, per chunk of fact rows, it
composes each row's matches in every dimension (an odometer, the last
dimension fastest), gathers the fact's and the dimensions' columns, applies
the WithColumn/Project chain and folds into the aggregator, by direct cells
when the source group-key columns allow it. Each dimension's verified pairs
enter the pair memo under ("star",) + the pair's subkey only after every
chunk has streamed, so a failure mid-stream leaves nothing partial.

`HYPERSPACE_QUERY_STREAMING=0` turns both off (the one-pass aggregate and
the cascade answer), `HYPERSPACE_MULTIWAY=0` the star stream and, in
`JoinIndexRule`, star recognition. A flag left unset hands its knob to the
planner (`plananalysis/planner.py`): the gates read `decided_value` only
then, and on a warm aggregate over a million rows or more the planner shapes
`query_chunk_rows` from the footers. Both streams check the query deadline
at every chunk boundary (`resilience.check_deadline`). Streamed integer, count, min and max
results equal the one-pass path's exactly; float sums and averages fold
chunk by chunk, so they may differ from it in the last bits. The JAX
package's streamed binary join aggregate (`stream_join_aggregate` :317) is
reached only off its device program and is not ported.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np
import torch

from .. import resilience
from ..telemetry.profiling import timed
from .table import Table

ENV_QUERY_STREAMING = "HYPERSPACE_QUERY_STREAMING"
ENV_QUERY_CHUNK_ROWS = "HYPERSPACE_QUERY_CHUNK_ROWS"
_DEFAULT_QUERY_CHUNK_ROWS = 4_000_000
#: Output rows of a star chunk (the join's rows, not the fact's).
ENV_JOIN_CHUNK_ROWS = "HYPERSPACE_JOIN_CHUNK_ROWS"
_DEFAULT_JOIN_CHUNK_ROWS = 2_000_000
ENV_MULTIWAY = "HYPERSPACE_MULTIWAY"


def multiway_enabled() -> bool:
    """Gates star recognition in `JoinIndexRule` and the star stream: the
    flag when `HYPERSPACE_MULTIWAY` is set ("0" off), else the planner's
    decision, else on."""
    raw = os.environ.get(ENV_MULTIWAY, "")
    if raw != "":
        return raw != "0"
    from ..plananalysis.planner import decided_value

    decided = decided_value("multiway")
    return True if decided is None else bool(decided)


def streaming_enabled() -> bool:
    """The flag when `HYPERSPACE_QUERY_STREAMING` is set ("0" off), else
    the planner's decision, else on."""
    raw = os.environ.get(ENV_QUERY_STREAMING, "")
    if raw != "":
        return raw != "0"
    from ..plananalysis.planner import decided_value

    decided = decided_value("streaming")
    return True if decided is None else bool(decided)


def query_chunk_rows() -> int:
    """`HYPERSPACE_QUERY_CHUNK_ROWS` when set, else the planner's shaped
    chunk, else 4,000,000."""
    raw = os.environ.get(ENV_QUERY_CHUNK_ROWS, "")
    if raw != "":
        try:
            return max(1, int(raw))
        except ValueError:
            return _DEFAULT_QUERY_CHUNK_ROWS
    from ..plananalysis.planner import decided_value

    decided = decided_value("chunk_rows")
    return max(1, int(decided)) if decided is not None else _DEFAULT_QUERY_CHUNK_ROWS


def join_chunk_rows() -> int:
    return max(1, int(os.environ.get(ENV_JOIN_CHUNK_ROWS, _DEFAULT_JOIN_CHUNK_ROWS) or _DEFAULT_JOIN_CHUNK_ROWS))


def split_chunks(t: Table, chunk_rows: int) -> List[Table]:
    """Row slices of at most `chunk_rows` rows (views); chunk boundaries
    change no value and no order."""
    if t.num_rows <= chunk_rows:
        return [t]
    return [t.slice(lo, min(lo + chunk_rows, t.num_rows)) for lo in range(0, t.num_rows, chunk_rows)]


def stream_aggregate(agg_exec, ctx) -> Optional[Table]:
    """A `HashAggregateExec` over its child's chunk stream. None only when no
    chunk arrived (the caller falls back); a failure mid-stream propagates
    and leaves no cache entry of its own."""
    from ..ops.aggregate import StreamAggregator, _empty_result
    from ..telemetry.profiling import StageTimings, record_query_stages

    stages = StageTimings(mode="stream-device", device=ctx.device)
    agg = StreamAggregator(agg_exec.group_keys, agg_exec.aggs, stages=stages)
    # The empty result carries the types every chunk promotes to, as the
    # one-pass path's concatenation would; only a chunk of new types
    # changes it.
    template: Optional[Table] = None
    n_chunks = 0
    for chunk in agg_exec.child.execute_stream(ctx, stages):
        resilience.check_deadline("query.stream")
        if template is None:
            template = chunk.slice(0, 0)
        elif template.schema != chunk.schema:
            template = Table.concat([template, chunk.slice(0, 0)])
        n_chunks += 1
        agg.add_chunk(chunk)
    out = agg.finalize()
    if out is None:
        if template is None:
            return None
        out = _empty_result(template, agg_exec.group_keys, agg_exec.aggs)
    summary = stages.summary()
    summary.update({"chunks": n_chunks, "rows": agg.rows, "groups": out.num_rows})
    record_query_stages(summary)
    return out


def _resolve_named_columns(out_names, chain, names):
    """Aggregate names over a join output's name → Column mapping, as the
    source columns; None when a WithColumn of the chain computes one (it has
    no source column) or a name does not resolve uniquely (:236)."""
    from .physical import WithColumnExec

    shadowed = {op.col_name.lower() for op in chain if isinstance(op, WithColumnExec)}
    cols = []
    for name in names:
        if name.lower() in shadowed:
            return None
        c = out_names.get(name)
        if c is None:
            ci = [k for k in out_names if k.lower() == name.lower()]
            if len(ci) != 1:
                return None
            c = out_names[ci[0]]
        cols.append(c)
    return cols


def star_output_columns(fact: Table, dim_tables):
    """The star output's name → source Column mapping (:269). The cascade
    names fold by fold, so a colliding name takes `<name>_r`, and a third
    table colliding on it overwrites that `_r` entry: the cascade's quirk,
    kept here so that both answer alike."""
    out_names = dict(fact.columns)
    for dt in dim_tables:
        for n, c in dt.columns.items():
            out_names[n if n not in out_names else f"{n}_r"] = c
    return out_names


def _star_agg_input_dtype(name: str, out_names, chain):
    """One aggregate input's declared type over the star output: the
    WithColumn's when the chain computes it, else the source column's; None
    when it does not resolve (:532)."""
    from .physical import WithColumnExec

    for op in chain:
        if isinstance(op, WithColumnExec) and op.col_name.lower() == name.lower():
            return op.dtype
    cols = _resolve_named_columns(out_names, (), [name])
    return cols[0].dtype if cols is not None else None


def _star_float_fold_free(agg_exec, out_names, chain) -> bool:
    """Every sum and avg input is provably not a float (:545): integer
    states add exactly, so the carry's merge equals the one-pass fold. A
    float sum streams only under the direct-cells hint."""
    for _out, fn, cname in agg_exec.aggs:
        if fn in ("sum", "avg") and cname is not None:
            dtype = _star_agg_input_dtype(cname, out_names, chain)
            if dtype is None or dtype in ("float32", "float64"):
                return False
    return True


def _apply_chain(t: Table, chain) -> Table:
    """The WithColumn/Project chain, innermost (nearest the join) first."""
    from .physical import WithColumnExec

    for op in reversed(chain):
        t = op.apply(t) if isinstance(op, WithColumnExec) else t.select(op.column_names)
    return t


def _dimension_matches(star_exec, ctx, stages, fact: Table, side, memo_todo: list):
    """One dimension's verified matches (fact rows, dimension rows) in
    fact-major order, and its stats: from the star pair memo, or by the
    hash-mode classed probe (K1, K2) and exact verification (:626-705)."""
    from ..ops import bucket_join as bj
    from ..ops.hashing import bucket_id
    from . import physical as phys

    dim_exec, fkeys, dkeys, index_name, num_buckets, dt, d_starts = side
    fkeys, dkeys = list(fkeys), list(dkeys)
    t0 = time.monotonic()
    subkey = ("star",) + phys._pair_subkey(fkeys, dkeys, star_exec.fact, dim_exec, fact, dt)
    rows_key = phys._pair_rows_key(star_exec.fact, dim_exec, ctx)
    hit, cached = phys._peek_two_table("pairs", fact, dt, subkey, rows_key)
    stat = {"index": index_name, "buckets": int(num_buckets)}
    if hit:
        li, ri = cached
        stat.update({"pairs": int(len(li)), "memo": "hit"})
        return li, ri, stat
    with timed(stages, "pad"):
        # The fact was never bucketed on this dimension's keys: hash its keys
        # into the dimension's bucket space (the build's hash, strings by
        # their values) and lay it out in bucket order.
        bid = bucket_id([fact.column(k) for k in fkeys], num_buckets)
        perm, f_starts = bj.fact_bucket_layout(bid, num_buckets)
        l_flags, r_flags = phys._joint_float_flags(fact, dt, fkeys, dkeys)
        l_vals = phys._table_key64(fact, fkeys, l_flags)[perm]
        r_vals = phys._table_key64(dt, dkeys, r_flags)
        plan = bj.build_classed_plan(l_vals, r_vals, f_starts, np.asarray(d_starts, np.int64), "hash")
    pad_s = time.monotonic() - t0
    t1 = time.monotonic()
    with timed(stages, "probe"):
        ranges = bj.probe_classed(plan)
    with timed(stages, "expand"):
        pli, ri = bj.classed_pairs(plan, ranges)
        li = perm[pli]  # bucket-layout positions → fact rows
    probe_s = time.monotonic() - t1
    t2 = time.monotonic()
    with timed(stages, "verify"):
        li, ri = phys._verify_pairs(fact, dt, fkeys, dkeys, li, ri)
        # Fact-major, stably: one fact row's matches keep the probe's
        # bucket-major order, the order the odometer composes from.
        order = torch.sort(li, stable=True).indices
        li, ri = li[order], ri[order]
    verify_s = time.monotonic() - t2
    memo_todo.append((dt, subkey, rows_key, li, ri))
    stat.update({"pairs": int(len(li)), "memo": "miss", "pad_s": round(pad_s, 5), "probe_s": round(probe_s, 5),
                 "verify_s": round(verify_s, 5)})
    return li, ri, stat


def stream_star_aggregate(agg_exec, star_exec, chain, ctx) -> Optional[Table]:
    """A `HashAggregateExec` over a `MultiwayJoinExec` as a chunk-carry
    stream (see the module docstring). None when the shape does not apply:
    an empty fact or dimension, a device mesh for the query's rows, or a
    float sum with no direct-cells hint; the `MultiwayJoinExec` then runs
    its cascade."""
    from ..exceptions import CorruptIndexError, HyperspaceException, QueryTimeoutError, RetryBudgetExceededError
    from ..ops.aggregate import StreamAggregator, _empty_result, direct_stream_hint
    from ..telemetry.profiling import StageTimings, record_join_stages
    from . import physical as phys

    try:
        fact = star_exec.fact.execute(ctx)
        dim_sides = []
        for dim_exec, fkeys, dkeys, index_name, num_buckets in star_exec.dims:
            dt, d_starts = dim_exec.execute_concat(ctx)
            dim_sides.append((dim_exec, fkeys, dkeys, index_name, num_buckets, dt, d_starts))
    except (CorruptIndexError, QueryTimeoutError, RetryBudgetExceededError):
        # A corrupt dimension is quarantined by the session, a deadline or a
        # spent budget ends the query: none of them declines to the cascade
        # (the JAX package's :600 declines on each; ROADMAP Queue 3).
        raise
    except HyperspaceException:
        return None
    if fact.num_rows == 0 or any(s[5].num_rows == 0 for s in dim_sides):
        return None
    total_rows = fact.num_rows + sum(s[5].num_rows for s in dim_sides)
    if ctx.session is not None and ctx.session.mesh_for(total_rows) is not None:
        return None  # the sharded probe owns mesh-scale execution (streaming.py:605)

    group_keys = agg_exec.group_keys
    out_names = star_output_columns(fact, [s[5] for s in dim_sides])
    src_keys = _resolve_named_columns(out_names, chain, group_keys)
    hint = direct_stream_hint(src_keys, agg_exec.aggs) if src_keys is not None else None
    if hint is None and not _star_float_fold_free(agg_exec, out_names, chain):
        return None

    dev = ctx.device
    stages = StageTimings(mode="star-stream", device=dev)
    n_fact = fact.num_rows
    per_dim = []  # (dimension table, match counts, match starts, dimension rows) per dimension
    dim_stats: List[dict] = []
    memo_todo: List[tuple] = []
    for side in dim_sides:
        li, ri, stat = _dimension_matches(star_exec, ctx, stages, fact, side, memo_todo)
        counts = torch.bincount(li, minlength=n_fact)
        mstarts = torch.zeros(n_fact + 1, dtype=torch.int64, device=dev)
        mstarts[1:] = torch.cumsum(counts, 0)
        per_dim.append((side[5], counts, mstarts, ri))
        dim_stats.append(stat)

    ndims = len(per_dim)
    # A fact row's output rows: the product of its match counts. Chunks cut
    # fact rows so that each chunk's output stays near the chunk budget.
    K = per_dim[0][1].clone()
    for _dt, counts, _ms, _ri in per_dim[1:]:
        K = K * counts
    out_starts = torch.zeros(n_fact + 1, dtype=torch.int64, device=dev)
    out_starts[1:] = torch.cumsum(K, 0)
    out_starts_h = out_starts.cpu().numpy()
    total_pairs = int(out_starts_h[-1])
    chunk_rows = join_chunk_rows()
    bounds = [0]
    while bounds[-1] < n_fact:
        lo = bounds[-1]
        hi = int(np.searchsorted(out_starts_h, out_starts_h[lo] + chunk_rows, side="right")) - 1
        bounds.append(min(max(hi, lo + 1), n_fact))

    agg = StreamAggregator(group_keys, agg_exec.aggs, stages=stages, direct_hint=hint)

    def build_chunk(lo: int, hi: int) -> Table:
        tot = int(out_starts_h[hi] - out_starts_h[lo])
        with timed(stages, "gather"):
            Kc = K[lo:hi]
            rows = torch.nonzero(Kc).squeeze(1)
            Kr = Kc[rows]
            rows = rows + lo
            fact_idx = torch.repeat_interleave(rows, Kr, output_size=tot)
            ends = torch.cumsum(Kr, 0)
            off = torch.arange(tot, dtype=torch.int64, device=dev) - torch.repeat_interleave(
                ends - Kr, Kr, output_size=tot
            )
            # Composition j of fact row i takes match (j // stride_d) %
            # count_d of dimension d, the last dimension fastest.
            strides: List[Optional[torch.Tensor]] = [None] * ndims
            stride = torch.ones(rows.shape[0], dtype=torch.int64, device=dev)
            for d in range(ndims - 1, -1, -1):
                strides[d] = stride
                stride = stride * per_dim[d][1][rows]
            parts = [fact.take(fact_idx)]
            for d in range(ndims):
                dt_d, counts_d, mstarts_d, ri_d = per_dim[d]
                st_e = torch.repeat_interleave(strides[d], Kr, output_size=tot)
                cnt_e = torch.repeat_interleave(counts_d[rows], Kr, output_size=tot)
                sel = torch.div(off, st_e, rounding_mode="floor") % cnt_e
                first = torch.repeat_interleave(mstarts_d[rows], Kr, output_size=tot)
                parts.append(dt_d.take(ri_d[first + sel]))
        with timed(stages, "eval"):
            cols: dict = {}
            for p in parts:
                for n, c in p.columns.items():
                    cols[n if n not in cols else f"{n}_r"] = c
            t = _apply_chain(Table(cols), chain)
        return t

    template: Optional[Table] = None
    n_chunks = 0
    for lo, hi in zip(bounds, bounds[1:]):
        resilience.check_deadline("query.star_stream")
        t = build_chunk(lo, hi)
        if template is None:
            template = t.slice(0, 0)
        n_chunks += 1
        agg.add_chunk(t)

    # Every chunk has streamed: only now do the dimensions' pairs enter the
    # memo, so that a warm star query starts at the composition.
    for dt_m, subkey, rows_key, li_v, ri_v in memo_todo:
        phys._cached_two_table("pairs", fact, dt_m, subkey, lambda li_v=li_v, ri_v=ri_v: (li_v, ri_v),
                               rows_key=rows_key)

    out = agg.finalize()
    if out is None:
        if template is None:
            return None
        out = _empty_result(template, group_keys, agg_exec.aggs)
    summary = stages.summary()
    summary.update({"chunks": n_chunks, "pairs": total_pairs, "groups": out.num_rows,
                    "direct_cells": hint is not None, "join_mode": "star", "star_dims": dim_stats})
    record_join_stages(summary)
    return out


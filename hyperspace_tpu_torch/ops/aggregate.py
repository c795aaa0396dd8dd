"""Grouped aggregation on the table's device: a key64 sort and segment reductions.

Counterpart of the non-streaming path of `hyperspace_tpu/ops/aggregate.py`
`hash_aggregate` :681, as torch ops:

1. key64-hash the group columns (`ops.hashing`, bit-identical to the JAX
   package) and sort the rows stably by it: equal key tuples hash equal, so
   they are adjacent (null slots hold the canonical fill and hash equal too).
2. Find group boundaries by comparing ADJACENT ACTUAL values and validity,
   never the hash (`_group_ids_body` :44): a 64-bit collision can only split
   a group, never merge two tuples.
3. Reduce each aggregate over the sorted rows, one segment a group. Float
   sums use `torch.segment_reduce`, which adds each segment in row order, so
   the card's answer is the same on every run (a float `index_add_` on CUDA
   adds by atomics in no fixed order); integer sums, counts, min and max are
   exact whatever the order.
4. If the representative key tuples are not all distinct, a collision split a
   group: recompute exactly on the host (`_host_aggregate` :389, as at
   :797-802), whose groups come in first-occurrence order. Only
   representatives with equal key64s can repeat a tuple, so the exact host
   check runs only when two adjacent ones have equal key64s.

Groups come out in the order of the stable key64 sort, the order of the JAX
package's sort paths (its device program, and its host path under
`HYPERSPACE_FORCE_DEVICE_OPS=1`). Its direct-address host path
(`_direct_host_aggregate` :591, a shortcut of its CPU backend) orders groups
differently and is not ported: the port follows the device program.

`StreamAggregator` (:910-1459) is the chunk-carry GROUP BY of the streamed
executors (`engine/streaming.py`): each chunk reduces to per-group partial
states by the same key64 sort and segment reductions, and the carried states
merge by exact key records. Under a direct-cells hint (`direct_stream_hint`:
the chunks are gathers of null-free, bounded integer or dictionary key
columns) it accumulates into dense per-cell tensors instead, and its groups
come out in cell order, as the JAX device program's star stream gives them.

SQL semantics: null group keys form one group; sum, min, max and avg ignore
null inputs and are NULL for an all-null group; count(col) counts non-null
values, count(*) rows; count_distinct counts distinct non-null values (all
NaNs one value, -0.0 equal to 0.0).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..engine.schema import BOOL, FLOAT32, FLOAT64, INT32, INT64, STRING, TORCH_DTYPES
from ..engine.table import Column, Table
from ..exceptions import HyperspaceException
from ..engine.table import _dtype_of
from ..telemetry import tracing as _tracing
from ..telemetry.profiling import timed
from .hashing import key64

#: (out_name, fn, column | None); column None only for count(*).
AggTriple = Tuple[str, str, Optional[str]]

_NUMERIC = (INT32, INT64, FLOAT32, FLOAT64, BOOL)


def result_dtype(fn: str, in_dtype: Optional[str]) -> str:
    """count and count_distinct give int64, avg float64, sum widens to int64
    or float64, min and max keep the input's type (strings too: dictionary
    order is value order)."""
    if fn == "count":
        return INT64
    if in_dtype is None:
        raise HyperspaceException(f"{fn}() requires a column")
    if fn == "count_distinct":
        return INT64
    if fn == "avg":
        if in_dtype not in _NUMERIC:
            raise HyperspaceException(f"avg() unsupported for {in_dtype}")
        return FLOAT64
    if fn == "sum":
        if in_dtype in (FLOAT32, FLOAT64):
            return FLOAT64
        if in_dtype in (INT32, INT64, BOOL):
            return INT64
        raise HyperspaceException(f"sum() unsupported for {in_dtype}")
    if fn in ("min", "max"):
        return in_dtype
    raise HyperspaceException(f"Unknown aggregate function: {fn}")


def _minmax_fill(dtype: torch.dtype, fn: str):
    """The null fill of min/max: the opposite extreme of the type, so a
    masked slot never wins."""
    if dtype.is_floating_point:
        return float("inf") if fn == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if fn == "min" else info.min


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype.is_floating_point else torch.int64


def _out_column(col: Optional[Column], dtype: str, vals: torch.Tensor, validity) -> Column:
    """Reduced values (and the all-null groups' validity) as a column."""
    v = None if validity is None or bool(validity.all()) else validity
    if dtype == STRING:
        d = col.dictionary if col is not None and len(col.dictionary) else np.array([""], "<U1")
        codes = vals.to(torch.int64)
        if v is not None:  # an all-null group holds the min/max fill, not a code
            codes = torch.where(v, codes, torch.zeros((), dtype=codes.dtype, device=codes.device))
        return Column(STRING, codes.to(torch.int32), d, v)
    return Column(dtype, vals.to(TORCH_DTYPES[dtype]), None, v)


def _empty_result(table: Table, group_keys, aggs: Sequence[AggTriple]) -> Table:
    out = {k: table.column(k) for k in group_keys}
    device = _device(table)
    for out_name, fn, col_name in aggs:
        col = table.column(col_name) if col_name is not None else None
        dtype = result_dtype(fn, None if col is None else col.dtype)
        out[out_name] = _out_column(col, dtype, torch.empty(0, dtype=torch.int64, device=device), None)
    return Table(out)


def _device(table: Table) -> torch.device:
    return next(iter(table.columns.values())).data.device if table.columns else torch.device("cpu")


def _valid(col: Column) -> torch.Tensor:
    if col.validity is not None:
        return col.validity
    return torch.ones(len(col), dtype=torch.bool, device=col.data.device)


def _distinct_values(data: torch.Tensor) -> torch.Tensor:
    """The value lane of distinct counting: floats as float64 bit patterns
    with every NaN one value and -0.0 as 0.0 (`_distinct_values` :162)."""
    if data.is_floating_point():
        d = data.to(torch.float64)
        d = torch.where(torch.isnan(d), torch.full((), float("nan"), dtype=d.dtype, device=d.device), d)
        d = torch.where(d == 0.0, torch.zeros((), dtype=d.dtype, device=d.device), d)
        return d.view(torch.int64)
    return data.to(torch.int64)


def _count_distinct_sorted(gid: torch.Tensor, perm: torch.Tensor, col: Column, n_groups: int) -> torch.Tensor:
    """Distinct non-null values per group over the sorted rows
    (`_count_distinct_dev_jit` :191): order each group's values with nulls
    last, count the first of each run of equal values."""
    xs = _distinct_values(col.data)[perm]
    v = _valid(col)[perm]
    order = torch.sort(xs, stable=True).indices
    order = order[torch.sort((gid * 2 + (~v).to(torch.int64))[order], stable=True).indices]
    sg, sx, sv = gid[order], xs[order], v[order]
    first = torch.ones_like(sv)
    first[1:] = (sg[1:] != sg[:-1]) | (sx[1:] != sx[:-1])
    return torch.bincount(sg[first & sv], minlength=n_groups).to(torch.int64)


def _global_aggregate(table: Table, aggs: Sequence[AggTriple]) -> Table:
    """No group keys: one output row (`_global_aggregate` :214); an empty
    input gives count 0 and NULL sum, min, max and avg."""
    out = {}
    n = table.num_rows
    device = _device(table)

    def one(x, dtype=torch.int64):
        return torch.tensor([x], dtype=dtype, device=device)

    for out_name, fn, col_name in aggs:
        col = table.column(col_name) if col_name is not None else None
        dtype = result_dtype(fn, None if col is None else col.dtype)
        if fn == "count" and col is None:
            out[out_name] = _out_column(col, dtype, one(n), None)
            continue
        valid = _valid(col)
        nv = int(valid.sum())
        if fn == "count":
            out[out_name] = _out_column(col, dtype, one(nv), None)
        elif fn == "count_distinct":
            out[out_name] = _out_column(col, dtype, one(int(torch.unique(_distinct_values(col.data)[valid]).numel())), None)
        elif nv == 0:
            out[out_name] = _out_column(col, dtype, one(0), torch.zeros(1, dtype=torch.bool, device=device))
        else:
            data = col.data[valid]  # codes for strings: the min code is the min value
            if fn in ("min", "max"):
                if data.dtype == torch.bool:
                    data = data.to(torch.int32)
                r = (data.min() if fn == "min" else data.max()).reshape(1)
            else:
                r = data.to(torch.float64 if dtype == FLOAT64 else torch.int64).sum().reshape(1)
                if fn == "avg":
                    r = r / nv
            out[out_name] = _out_column(col, dtype, r, None)
    return Table(out)


def _group_ids(key_cols, k64: torch.Tensor):
    """(perm, boundary, gid): the stable key64 order, a group's first sorted
    row, and each sorted row's group id (`_group_ids_body` :44)."""
    perm = torch.sort(k64, stable=True).indices
    n = perm.shape[0]
    eq = torch.ones(max(n - 1, 0), dtype=torch.bool, device=perm.device)
    for c in key_cols:
        sa = c.data[perm]
        col_eq = sa[1:] == sa[:-1]
        if c.validity is not None:
            sv = c.validity[perm]
            col_eq = (col_eq & (sv[1:] == sv[:-1])) | (~sv[1:] & ~sv[:-1])
        eq &= col_eq
    boundary = torch.cat([torch.ones(1, dtype=torch.bool, device=perm.device), ~eq])
    gid = torch.cumsum(boundary.to(torch.int64), 0) - 1
    return perm, boundary, gid


def _segment_reduce(fn: str, col: Optional[Column], perm, gid, seg_rows, n_groups: int):
    """One aggregate over the sorted rows → (values per group, non-null
    inputs per group)."""
    if col is None:  # count(*)
        return seg_rows, seg_rows
    v = None if col.validity is None else col.validity[perm]
    n_valid = seg_rows if v is None else torch.zeros(n_groups, dtype=torch.int64, device=gid.device).index_add_(
        0, gid, v.to(torch.int64)
    )
    if fn == "count":
        return n_valid, n_valid
    xs = col.data[perm]
    if fn in ("sum", "avg"):
        acc = xs.to(_acc_dtype(xs.dtype))
        if v is not None:
            acc = torch.where(v, acc, torch.zeros((), dtype=acc.dtype, device=acc.device))
        if acc.is_floating_point():
            s = torch.segment_reduce(acc, "sum", lengths=seg_rows, unsafe=True)
        else:
            s = torch.zeros(n_groups, dtype=acc.dtype, device=acc.device).index_add_(0, gid, acc)
        if fn == "sum":
            return s, n_valid
        return s.to(torch.float64) / torch.clamp(n_valid, min=1).to(torch.float64), n_valid
    if xs.dtype == torch.bool:
        xs = xs.to(torch.int32)
    fill = _minmax_fill(xs.dtype, fn)
    if v is not None:
        xs = torch.where(v, xs, torch.full((), fill, dtype=xs.dtype, device=xs.device))
    out = torch.full((n_groups,), fill, dtype=xs.dtype, device=xs.device)
    return out.scatter_reduce_(0, gid, xs, reduce="amin" if fn == "min" else "amax"), n_valid


def _key_records(cols) -> np.ndarray:
    """Key tuples as one comparable structured host array: per column
    (data, valid) with null slots at the canonical fill (`_key_records` :374)."""
    fields = []
    for c in cols:
        data = c.data.cpu().numpy()
        valid = np.ones(len(data), bool) if c.validity is None else c.validity.cpu().numpy()
        fields.append(np.where(valid, data, np.zeros((), dtype=data.dtype)))
        fields.append(valid)
    return np.rec.fromarrays(fields)


def _count_distinct_host(group_ids: np.ndarray, data: np.ndarray, valid: np.ndarray, n_groups: int) -> np.ndarray:
    """Exact per-group distinct counts by (group, value) pair dedup on the
    host (`_count_distinct_per_group` :175)."""
    if np.issubdtype(data.dtype, np.floating):
        d = data.astype(np.float64)
        d = np.where(np.isnan(d), np.float64("nan"), d)
        data = np.where(d == 0.0, np.float64(0.0), d).view(np.int64)
    uniq = np.unique(np.rec.fromarrays([group_ids[valid], data[valid]]))
    vals = np.zeros(n_groups, np.int64)
    np.add.at(vals, uniq.f0, 1)
    return vals


def _host_aggregate(table: Table, group_keys, aggs: Sequence[AggTriple]) -> Table:
    """Exact host groupby, groups in first-occurrence order: the collision
    repair (`_host_aggregate` :389), with numpy on host copies; the result
    goes back to the table's device."""
    device = _device(table)
    recs = _key_records([table.column(k) for k in group_keys])
    uniq, first_idx, inverse = np.unique(recs, return_index=True, return_inverse=True)
    inverse = inverse.reshape(-1)
    n_groups = len(uniq)
    order = np.argsort(first_idx, kind="stable")
    remap = np.empty(n_groups, np.int64)
    remap[order] = np.arange(n_groups)
    inverse = remap[inverse]
    rep_rows = table.take(torch.from_numpy(np.sort(first_idx)).to(device))
    out = {k: rep_rows.column(k) for k in group_keys}

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    for out_name, fn, col_name in aggs:
        col = table.column(col_name) if col_name is not None else None
        dtype = result_dtype(fn, None if col is None else col.dtype)
        if col is None:
            vals = np.zeros(n_groups, np.int64)
            np.add.at(vals, inverse, 1)
            out[out_name] = _out_column(col, dtype, dev(vals), None)
            continue
        data = col.data.cpu().numpy()
        valid = np.ones(len(data), bool) if col.validity is None else col.validity.cpu().numpy()
        nv = np.zeros(n_groups, np.int64)
        np.add.at(nv, inverse[valid], 1)
        if fn == "count":
            out[out_name] = _out_column(col, dtype, dev(nv), None)
            continue
        if fn == "count_distinct":
            out[out_name] = _out_column(col, dtype, dev(_count_distinct_host(inverse, data, valid, n_groups)), None)
            continue
        if fn in ("sum", "avg"):
            acc = data.astype(np.float64 if np.issubdtype(data.dtype, np.floating) else np.int64)
            s = np.zeros(n_groups, acc.dtype)
            np.add.at(s, inverse[valid], acc[valid])
            vals = s if fn == "sum" else s.astype(np.float64) / np.maximum(nv, 1)
        else:
            if data.dtype == np.bool_:
                data = data.astype(np.int32)
            fill = _minmax_fill(torch.from_numpy(data[:0]).dtype, fn)
            vals = np.full(n_groups, fill, data.dtype)
            (np.minimum if fn == "min" else np.maximum).at(vals, inverse[valid], data[valid])
        out[out_name] = _out_column(col, dtype, dev(vals), dev(nv > 0))
    return Table(out)


def hash_aggregate(table: Table, group_keys, aggs: Sequence[AggTriple]) -> Table:
    """GROUP BY `group_keys` computing `aggs` = [(out_name, fn, column | None)].
    Steps `agg.keys`, `agg.reduce` and `agg.assemble` while tracing."""
    group_keys = list(group_keys)
    if not group_keys:
        return _global_aggregate(table, aggs)
    if table.num_rows == 0:
        return _empty_result(table, group_keys, aggs)
    with _tracing.step("agg.keys"):
        key_cols = [table.column(k) for k in group_keys]
        k64 = key64(key_cols)
        perm, boundary, gid = _group_ids(key_cols, k64)
        starts = torch.nonzero(boundary).squeeze(1)
        n_groups = int(starts.shape[0])
        ends = torch.cat([starts[1:], torch.tensor([table.num_rows], device=starts.device)])
        seg_rows = ends - starts
    with _tracing.step("agg.reduce"):
        reduced = []
        for out_name, fn, col_name in aggs:
            col = table.column(col_name) if col_name is not None else None
            dtype = result_dtype(fn, None if col is None else col.dtype)
            if fn == "count_distinct":
                reduced.append((out_name, col, dtype, _count_distinct_sorted(gid, perm, col, n_groups), None))
                continue
            vals, n_valid = _segment_reduce(fn, col, perm, gid, seg_rows, n_groups)
            reduced.append((out_name, col, dtype, vals, None if fn == "count" else n_valid > 0))
    with _tracing.step("agg.assemble"):
        rep_rows = table.take(perm[starts]).select(group_keys)
        # Equal tuples hash equal, so two representatives can only repeat a tuple
        # when their key64s are equal: check exactly on the host only then.
        rep_k64 = k64[perm[starts]]
        if bool((rep_k64[1:] == rep_k64[:-1]).any()) and len(
            np.unique(_key_records([rep_rows.column(k) for k in group_keys]))
        ) != n_groups:
            # A 64-bit collision interleaved two tuples in one sorted run.
            return _host_aggregate(table, group_keys, aggs)
        out = {k: rep_rows.column(k) for k in group_keys}
        for out_name, col, dtype, vals, validity in reduced:
            out[out_name] = _out_column(col, dtype, vals, validity)
        return Table(out)


# ---------------------------------------------------------------------------
# The chunk-carry aggregator of the streamed executors (aggregate.py:812-1459)
# ---------------------------------------------------------------------------

#: The direct-cells budget (`_DIRECT_CELL_BUDGET` :546): 4M cells, 32 MB a
#: dense int64 accumulator.
_DIRECT_CELL_BUDGET = 1 << 22

#: The functions the stream carries: scalar states only (a count_distinct
#: state is a set of values).
STREAMING_AGG_FNS = ("count", "sum", "avg", "min", "max")

_STATE_PREFIX = "__hs_"


def streaming_agg_supported(group_keys, aggs: Sequence[AggTriple]) -> bool:
    """A grouped aggregate of scalar-state functions whose keys do not take
    the state columns' names (:823)."""
    if not group_keys:
        return False
    if any(fn not in STREAMING_AGG_FNS for _, fn, _ in aggs):
        return False
    return not any(str(k).startswith(_STATE_PREFIX) for k in group_keys)


def _direct_layout(key_cols, aggs: Sequence[AggTriple]):
    """The direct-address cell layout of key columns (`_direct_layout` :549):
    (los, ranges, strides, cells), or None when the shape does not qualify
    (a min or max aggregate, a nullable or float key, an empty integer key,
    more cells than the budget). String keys range over their dictionary's
    codes, bool keys over 0..1, integer keys over their min..max; the cell id
    is mixed-radix, the last key fastest."""
    if any(fn in ("min", "max") for _, fn, _ in aggs):
        return None
    los, ranges = [], []
    for c in key_cols:
        if c.validity is not None:
            return None
        if c.is_string:
            lo, hi = 0, max(len(c.dictionary) - 1, 0)
        elif c.data.dtype == torch.bool:
            lo, hi = 0, 1
        elif not c.data.is_floating_point():
            if len(c) == 0:
                return None
            lo, hi = torch.stack([c.data.min(), c.data.max()]).to(torch.int64).tolist()
        else:
            return None
        los.append(int(lo))
        ranges.append(int(hi) - int(lo) + 1)
    cells = 1
    for r in ranges:
        cells *= r
        if cells > _DIRECT_CELL_BUDGET:
            return None
    strides = [1] * len(ranges)
    for i in range(len(ranges) - 2, -1, -1):
        strides[i] = strides[i + 1] * ranges[i + 1]
    return los, ranges, strides, cells


def direct_stream_hint(key_cols, aggs: Sequence[AggTriple]):
    """The direct-cells hint of a stream whose chunks are gathers of the
    source columns `key_cols` (:838): every gathered key lies in the
    source's value range, so the stream can accumulate into one dense cell
    array with no state tables and no carry merge. (los, ranges, strides,
    cells, key_meta) or None; key_meta rebuilds the key columns from cell
    ids."""
    layout = _direct_layout(key_cols, aggs)
    if layout is None:
        return None
    key_meta = [(c.dtype, c.dictionary if c.is_string else None, c.data.dtype) for c in key_cols]
    return layout + (key_meta,)


class StreamAggregator:
    """Chunk-carry GROUP BY (`StreamAggregator` :910): `add_chunk` each
    table chunk, then `finalize`.

    A chunk reduces to per-group partial states by the one-pass path's key64
    sort and segment reductions (the JAX device program's `_partial_device`
    :1239): a state is (value, non-null count), avg carries its sum, and the
    states form a small table of the group keys and the state columns. The
    carried states merge by exact key records (`_key_records` over the
    concatenated state tables: string keys re-encode over union
    dictionaries, and a 64-bit collision never merges two groups). Merging
    waits until the pending states outgrow the carry; the fold stays left to
    right whatever the cadence, so the result does not depend on it. Float
    sums add in row order within a segment (`torch.segment_reduce`, no
    atomics), so the card's answer is the same on every run. A group's
    answer is the same whatever the chunking, one chunk included (see
    `_compact`).

    Under a direct-cells hint every chunk folds into dense per-cell
    accumulators (`_add_chunk_direct` :1025); float sums sort the chunk's
    rows by cell stably and reduce each cell's segment in row order, the
    order of the reference's `np.bincount`.

    `finalize` gives the groups in the JAX device program's order: cell
    order under a hint, else ascending key64."""

    def __init__(self, group_keys, aggs: Sequence[AggTriple], stages=None, direct_hint=None):
        self.group_keys = list(group_keys)
        self.aggs = [tuple(a) for a in aggs]
        if not streaming_agg_supported(self.group_keys, self.aggs):
            raise HyperspaceException("aggregate shape not streamable")
        self._stages = stages
        self._carry: Optional[Table] = None
        self._pending: list = []
        self._pending_rows = 0
        self._in_dtypes: list = [None] * len(self.aggs)
        self.chunks = 0
        self.rows = 0
        self._direct = direct_hint
        self._dcounts: Optional[torch.Tensor] = None
        self._dstates: Optional[list] = None

    def add_chunk(self, t: Table) -> None:
        # Input types promote across chunks as the one-pass path's concat
        # promotes them, an empty chunk's included (:967-985).
        for i, (_out, _fn, cname) in enumerate(self.aggs):
            if cname is None:
                continue
            cur, new = self._in_dtypes[i], t.column(cname).dtype
            if cur is None or cur == new or STRING in (cur, new):
                self._in_dtypes[i] = new if cur is None else cur
            else:
                promoted = torch.promote_types(TORCH_DTYPES[cur], TORCH_DTYPES[new])
                self._in_dtypes[i] = next(k for k, v in TORCH_DTYPES.items() if v == promoted and k != STRING)
        if t.num_rows == 0:
            return
        with timed(self._stages, "partial"):
            if self._direct is not None:
                self._add_chunk_direct(t)
            else:
                partial = self._partial(t)
        self.chunks += 1
        self.rows += t.num_rows
        if self._direct is not None:
            return
        self._pending.append(partial)
        self._pending_rows += partial.num_rows
        carry_rows = self._carry.num_rows if self._carry is not None else 0
        if self._pending_rows >= max(1 << 16, carry_rows):
            with timed(self._stages, "merge"):
                self._compact()

    # -- direct cells ---------------------------------------------------------

    def _add_chunk_direct(self, t: Table) -> None:
        los, _ranges, strides, cells, _meta = self._direct
        dev = _device(t)
        gid0 = torch.zeros(t.num_rows, dtype=torch.int64, device=dev)
        for k, lo, st in zip(self.group_keys, los, strides):
            c = t.column(k)
            if c.validity is not None:
                # The hint promised null-free source keys: chunks with a null
                # key are not gathers of them.
                raise HyperspaceException("direct-hint chunk carries null keys")
            gid0 += (c.data.to(torch.int64) - lo) * st
        counts = torch.bincount(gid0, minlength=cells)
        if self._dcounts is None:
            self._dcounts = torch.zeros(cells, dtype=torch.int64, device=dev)
            self._dstates = [[None, None] for _ in self.aggs]  # per agg: [valid counts, values]
        self._dcounts += counts
        for i, (_out, fn, cname) in enumerate(self.aggs):
            if cname is None:
                continue  # count(*) reads the row counts
            col, state = t.column(cname), self._dstates[i]
            if col.validity is None:
                g, data, nv = gid0, col.data, counts
                if state[0] is not None:
                    state[0] += counts
            else:
                g, data = gid0[col.validity], col.data[col.validity]
                nv = torch.bincount(g, minlength=cells)
                if state[0] is None:
                    # Every earlier chunk was all-valid: their valid counts
                    # are their row counts.
                    state[0] = self._dcounts - counts
                state[0] += nv
            if fn == "count":
                continue
            if data.is_floating_point():
                order = torch.sort(g, stable=True).indices
                s = torch.segment_reduce(data.to(torch.float64)[order], "sum", lengths=nv, unsafe=True)
            else:
                s = torch.zeros(cells, dtype=torch.int64, device=dev).index_add_(0, g, data.to(torch.int64))
            if state[1] is None:
                state[1] = s
            else:
                if state[1].dtype != s.dtype:
                    common = torch.promote_types(state[1].dtype, s.dtype)
                    state[1], s = state[1].to(common), s.to(common)
                state[1] += s

    def _finalize_direct(self) -> Optional[Table]:
        if self._dcounts is None or self.rows == 0:
            return None
        los, ranges, strides, _cells, key_meta = self._direct
        present = torch.nonzero(self._dcounts).squeeze(1)
        counts_p = self._dcounts[present]
        out = {}
        for k, (dtype, dictionary, tdtype), lo, rng, st in zip(self.group_keys, key_meta, los, ranges, strides):
            vals = lo + torch.div(present, st, rounding_mode="floor") % rng
            out[k] = Column(dtype, vals.to(tdtype), dictionary, None)
        for i, (out_name, fn, _cname) in enumerate(self.aggs):
            dtype = result_dtype(fn, self._in_dtypes[i])
            nv_cells, val_cells = self._dstates[i]
            nv = counts_p if nv_cells is None else nv_cells[present]
            if fn == "count":
                out[out_name] = _out_column(None, dtype, nv, None)
                continue
            vals = val_cells[present]
            if fn == "avg":
                vals = vals.to(torch.float64) / torch.clamp(nv, min=1).to(torch.float64)
            out[out_name] = _out_column(None, dtype, vals, nv > 0)
        return Table(out)

    # -- partial states and the carry ------------------------------------------

    @staticmethod
    def _state_col(vals: torch.Tensor, n_valid: torch.Tensor, dictionary) -> Column:
        """A state value column: all-null groups hold 0 (code 0 of a string
        state, which always indexes its dictionary) and are invalid."""
        anyv = n_valid > 0
        data = torch.where(anyv, vals, torch.zeros((), dtype=vals.dtype, device=vals.device))
        if dictionary is not None:
            return Column(STRING, data.to(torch.int32), dictionary, anyv.clone())
        return Column(_dtype_of(data), data, None, anyv.clone())

    def _state_table(self, keys: Table, states: list) -> Table:
        out = dict(keys.columns)
        for i, (vals_col, n_valid) in enumerate(states):
            if vals_col is not None:
                out[f"{_STATE_PREFIX}v{i}"] = vals_col
            out[f"{_STATE_PREFIX}n{i}"] = Column(INT64, n_valid.to(torch.int64))
        return Table(out)

    def _partial(self, t: Table) -> Table:
        """One chunk's per-group states by the key64 sort and the segment
        reductions of the one-pass path."""
        key_cols = [t.column(k) for k in self.group_keys]
        perm, boundary, gid = _group_ids(key_cols, key64(key_cols))
        starts = torch.nonzero(boundary).squeeze(1)
        n_groups = int(starts.shape[0])
        ends = torch.cat([starts[1:], torch.tensor([t.num_rows], device=starts.device)])
        seg_rows = ends - starts
        states = []
        for _out, fn, cname in self.aggs:
            col = t.column(cname) if cname is not None else None
            vals, n_valid = _segment_reduce("sum" if fn == "avg" else fn, col, perm, gid, seg_rows, n_groups)
            if fn == "count":
                states.append((None, n_valid))
                continue
            states.append((self._state_col(vals, n_valid, col.dictionary if col.is_string else None), n_valid))
        return self._state_table(t.select(self.group_keys).take(perm[starts]), states)

    def _compact(self) -> None:
        if not self._pending:
            return
        parts = ([self._carry] if self._carry is not None else []) + self._pending
        self._pending = []
        self._pending_rows = 0
        # Even a lone partial merges: rows whose key64s collide (a null hashes
        # as its fill value) interleave in the chunk's sort, so its segments
        # may repeat a key tuple. The JAX package keeps a lone partial as it
        # is and splits such groups (ROADMAP.md Queue 3). The concatenation
        # re-encodes string keys and string min/max states over union
        # dictionaries, so codes compare across chunks.
        pt = Table.concat(parts) if len(parts) > 1 else parts[0]
        dev = _device(pt)
        _uniq, first_idx, inverse = np.unique(
            _key_records([pt.column(k) for k in self.group_keys]), return_index=True, return_inverse=True
        )
        n_groups = len(first_idx)
        inv = torch.from_numpy(inverse.reshape(-1).astype(np.int64)).to(dev)
        out = dict(pt.select(self.group_keys).take(torch.from_numpy(first_idx).to(dev)).columns)
        for i, (_out, fn, _cname) in enumerate(self.aggs):
            contrib = pt.column(f"{_STATE_PREFIX}n{i}").data
            nv = torch.zeros(n_groups, dtype=torch.int64, device=dev).index_add_(0, inv, contrib)
            out[f"{_STATE_PREFIX}n{i}"] = Column(INT64, nv)
            if fn == "count":
                continue
            vcol = pt.column(f"{_STATE_PREFIX}v{i}")
            mask = contrib > 0
            g, vals = inv[mask], vcol.data[mask]
            if fn in ("sum", "avg"):
                if vals.is_floating_point():
                    # Each group's states add in row order (the carry first,
                    # then the chunks as they came), as `np.add.at` does.
                    order = torch.sort(g, stable=True).indices
                    lengths = torch.bincount(g, minlength=n_groups)
                    acc = torch.segment_reduce(vals[order], "sum", lengths=lengths, unsafe=True)
                else:
                    acc = torch.zeros(n_groups, dtype=vals.dtype, device=dev).index_add_(0, g, vals)
            else:
                acc = torch.full((n_groups,), _minmax_fill(vals.dtype, fn), dtype=vals.dtype, device=dev)
                acc = acc.scatter_reduce_(0, g, vals, "amin" if fn == "min" else "amax")
            out[f"{_STATE_PREFIX}v{i}"] = self._state_col(acc, nv, vcol.dictionary if vcol.is_string else None)
        self._carry = Table(out)

    def finalize(self) -> Optional[Table]:
        """The aggregate of every chunk so far; None when no chunk held rows
        (the caller owns the empty-input result)."""
        if self._direct is not None:
            with timed(self._stages, "finalize"):
                return self._finalize_direct()
        with timed(self._stages, "merge"):
            self._compact()
        if self._carry is None:
            return None
        carry = self._carry
        with timed(self._stages, "finalize"):
            order = torch.sort(key64([carry.column(k) for k in self.group_keys]), stable=True).indices
            out = {k: carry.column(k).take(order) for k in self.group_keys}
            for i, (out_name, fn, _cname) in enumerate(self.aggs):
                nv = carry.column(f"{_STATE_PREFIX}n{i}").data[order]
                dtype = result_dtype(fn, self._in_dtypes[i])
                if fn == "count":
                    out[out_name] = _out_column(None, dtype, nv, None)
                    continue
                vcol = carry.column(f"{_STATE_PREFIX}v{i}").take(order)
                vals = vcol.data
                if fn == "avg":
                    vals = vals.to(torch.float64) / torch.clamp(nv, min=1).to(torch.float64)
                out[out_name] = _out_column(vcol, dtype, vals, nv > 0)
        return Table(out)

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
differently and is not ported, nor is the streaming `StreamAggregator`.

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
    """GROUP BY `group_keys` computing `aggs` = [(out_name, fn, column | None)]."""
    group_keys = list(group_keys)
    if not group_keys:
        return _global_aggregate(table, aggs)
    if table.num_rows == 0:
        return _empty_result(table, group_keys, aggs)
    key_cols = [table.column(k) for k in group_keys]
    k64 = key64(key_cols)
    perm, boundary, gid = _group_ids(key_cols, k64)
    starts = torch.nonzero(boundary).squeeze(1)
    n_groups = int(starts.shape[0])
    ends = torch.cat([starts[1:], torch.tensor([table.num_rows], device=starts.device)])
    seg_rows = ends - starts
    reduced = []
    for out_name, fn, col_name in aggs:
        col = table.column(col_name) if col_name is not None else None
        dtype = result_dtype(fn, None if col is None else col.dtype)
        if fn == "count_distinct":
            reduced.append((out_name, col, dtype, _count_distinct_sorted(gid, perm, col, n_groups), None))
            continue
        vals, n_valid = _segment_reduce(fn, col, perm, gid, seg_rows, n_groups)
        reduced.append((out_name, col, dtype, vals, None if fn == "count" else n_valid > 0))
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

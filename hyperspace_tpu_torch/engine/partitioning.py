"""Hive-style partition layouts: `root/key=value/.../file.parquet`.

Counterpart of `hyperspace_tpu/engine/partitioning.py`. The reader discovers
the layout once (`discover`), appends the partition columns to the schema,
and a read appends them to each file's rows (`engine/io.read_files`), so
everything downstream (signatures, rules, the index build) sees them as
ordinary columns.

Values are URL-decoded; `__HIVE_DEFAULT_PARTITION__` is null. Column types:
int64 when every non-null value parses as an integer, else string. The
columns are built on the table's device: an int64 value is a fill, a null a
zero fill with a false validity, a string a one-value dictionary with zero
codes; `partition_columns` builds those of many files' rows at once, with
one `repeat_interleave` of the per-file values over the per-file row counts.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple
from urllib.parse import unquote

import numpy as np
import torch

from ..exceptions import HyperspaceException
from .schema import INT64, STRING, Field
from .table import Column, Table

HIVE_NULL = "__HIVE_DEFAULT_PARTITION__"


@dataclass(frozen=True)
class PartitionSpec:
    """Ordered partition columns and their inferred types (int64 | string)."""

    columns: Tuple[str, ...]
    dtypes: Tuple[str, ...]

    def to_json(self) -> dict:
        return {"columns": list(self.columns), "dtypes": list(self.dtypes)}

    @staticmethod
    def from_json(d: Optional[dict]) -> Optional["PartitionSpec"]:
        if d is None:
            return None
        return PartitionSpec(tuple(d["columns"]), tuple(d["dtypes"]))

    @property
    def fields(self) -> List[Field]:
        return [Field(n, t) for n, t in zip(self.columns, self.dtypes)]


def _segments(root_paths: Sequence[str], path: str) -> Optional[List[Tuple[str, str]]]:
    """The `key=value` components between the (longest matching) root and
    the file; None when the file sits directly under its root or any
    directory level between is not `key=value`."""
    norm = os.path.normpath(path)
    best = None
    for r in root_paths:
        rn = os.path.normpath(r)
        if norm == rn or norm.startswith(rn + os.sep):
            if best is None or len(rn) > len(best):
                best = rn
    if best is None or norm == best:
        return None
    out = []
    for comp in os.path.relpath(os.path.dirname(norm), best).split(os.sep):
        if comp in (".", ""):
            continue
        if "=" not in comp:
            return None  # a plain directory level: not partitioned
        k, v = comp.split("=", 1)
        if not k:
            return None
        out.append((k, unquote(v)))
    return out if out else None


def discover(root_paths: Sequence[str], file_paths: Sequence[str]) -> Optional[PartitionSpec]:
    """The partition layout of a file inventory, or None when the source is
    not partitioned. Every file must name the same column sequence."""
    per_file = []
    for p in file_paths:
        segs = _segments(root_paths, p)
        if segs is None:
            return None
        per_file.append(segs)
    if not per_file:
        return None
    names = tuple(k for k, _ in per_file[0])
    for segs in per_file[1:]:
        if tuple(k for k, _ in segs) != names:
            raise HyperspaceException(
                f"Inconsistent partition layout: {names} vs {tuple(k for k, _ in segs)}"
            )
    dtypes = []
    for i in range(len(names)):
        vals = [segs[i][1] for segs in per_file if segs[i][1] != HIVE_NULL]
        dtypes.append(INT64 if vals and all(_is_int(v) for v in vals) else STRING)
    return PartitionSpec(names, tuple(dtypes))


def _is_int(s: str) -> bool:
    try:
        int(s)
        return True
    except ValueError:
        return False


def values_for(spec: PartitionSpec, root_paths: Sequence[str], path: str) -> Tuple[Optional[object], ...]:
    """This file's value of each spec column (None = the Hive null)."""
    segs = _segments(root_paths, path)
    if segs is None or tuple(k for k, _ in segs) != spec.columns:
        raise HyperspaceException(f"File does not match partition layout: {path}")
    return tuple(
        None if v == HIVE_NULL else int(v) if dt == INT64 else v for (_, v), dt in zip(segs, spec.dtypes)
    )


def partition_columns(
    spec: PartitionSpec,
    values: Sequence[Tuple[Optional[object], ...]],
    counts: Sequence[int],
    wanted: Optional[Sequence[str]] = None,
    device="cpu",
) -> List[Tuple[str, Column]]:
    """The spec's columns (only those in `wanted`) over consecutive runs of
    rows, run i holding `counts[i]` rows of `values[i]`: the concatenation
    of each run's constants, a string column over the union of their
    one-value dictionaries (a null's is `[""]`)."""
    wanted_l = None if wanted is None else {w.lower() for w in wanted}
    n = int(sum(counts))
    reps = torch.as_tensor(np.asarray(counts, dtype=np.int64), device=device)
    out = []
    for j, (name, dt) in enumerate(zip(spec.columns, spec.dtypes)):
        if wanted_l is not None and name.lower() not in wanted_l:
            continue
        vals = [v[j] for v in values]
        valid = np.asarray([v is not None for v in vals], dtype=bool)
        dictionary = None
        if dt == STRING:
            strs = np.asarray(["" if v is None else str(v) for v in vals])
            dictionary = np.unique(strs)
            per = np.searchsorted(dictionary, strs).astype(np.int32)
        else:
            per = np.asarray([0 if v is None else v for v in vals], dtype=np.dtype(dt))
        data = torch.repeat_interleave(torch.as_tensor(per, device=device), reps, output_size=n)
        validity = None
        if not valid.all():
            validity = torch.repeat_interleave(torch.as_tensor(valid, device=device), reps, output_size=n)
        out.append((name, Column(dt, data, dictionary, validity)))
    return out


def constant_columns(
    spec: PartitionSpec,
    values: Tuple[Optional[object], ...],
    n: int,
    wanted: Optional[Sequence[str]] = None,
    device="cpu",
) -> List[Tuple[str, Column]]:
    """The partition columns of one file as n-row constants."""
    return partition_columns(spec, [values], [n], wanted, device)


def append_partition_columns(
    table: Table,
    spec: PartitionSpec,
    root_paths: Sequence[str],
    path: str,
    wanted: Optional[Sequence[str]] = None,
    device="cpu",
) -> Table:
    consts = constant_columns(spec, values_for(spec, root_paths, path), table.num_rows, wanted, device)
    if not consts:
        return table
    return Table({**table.columns, **dict(consts)})

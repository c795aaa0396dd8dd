"""Hive-style partition layouts: `root/key=value/.../file.parquet`.

Counterpart of the layout detection in `hyperspace_tpu/engine/partitioning.py`
(`_segments` :55, `discover` :79). The JAX package turns `key=value` path
segments into columns appended to the schema; the port does not carry
partition columns yet, so its reader only detects the layout and refuses it
(`engine/session.py`), rather than answering without those columns.

Values are URL-decoded; `__HIVE_DEFAULT_PARTITION__` is null. Column types:
int64 when every non-null value parses as an integer, else string.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple
from urllib.parse import unquote

from ..exceptions import HyperspaceException
from .schema import INT64, STRING

HIVE_NULL = "__HIVE_DEFAULT_PARTITION__"


@dataclass(frozen=True)
class PartitionSpec:
    """Ordered partition columns and their inferred types (int64 | string)."""

    columns: Tuple[str, ...]
    dtypes: Tuple[str, ...]


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

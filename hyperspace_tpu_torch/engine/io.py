"""File IO: parquet listing, reading into device tables, and the bucketed writer.

Counterpart of `hyperspace_tpu/engine/io.py`, pyarrow-backed as that module
is. A read decodes each file's requested columns on the host, concatenates
them in sorted file order and copies each column to the device once. The
writer turns a table back into arrow arrays and calls `pq.write_table` with
the same arguments as the JAX package's writer, so equal tables give equal
files. Only parquet is ported; string and nullable data are refused.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from ..exceptions import HyperspaceException, not_in_slice
from ..storage.filesystem import FileStatus, LocalFileSystem
from ..util.path_utils import is_data_path
from .schema import BOOL, FLOAT32, FLOAT64, INT32, INT64, STRING, Field, Schema
from .table import Column, Table

#: Row-group cap of the per-bucket index files: bounded, key-sorted row
#: groups (the JAX package's default `HYPERSPACE_INDEX_ROW_GROUP_ROWS`).
INDEX_ROW_GROUP_ROWS = 65536
#: Files decoded at once by `read_files` (pyarrow releases the GIL).
DECODE_THREADS = 8


def _check_format(file_format: str) -> None:
    if file_format != "parquet":
        raise not_in_slice(f"{file_format} sources")


def list_data_files(path: str, file_format: str, fs: Optional[LocalFileSystem] = None) -> List[FileStatus]:
    """Data files under a root path (file or directory, recursive), with the
    metadata filter applied to every component below the root."""
    _check_format(file_format)
    fs = fs or LocalFileSystem()
    if not fs.exists(path):
        raise HyperspaceException(f"Path does not exist: {path}")
    if not fs.is_dir(path):
        return [fs.get_status(path)]
    rootnorm = os.path.normpath(path)
    out = []
    for st in fs.list_leaf_files(path):
        rel = os.path.relpath(os.path.normpath(st.path), rootnorm)
        if all(is_data_path(p) for p in rel.split(os.sep)) and st.path.endswith(".parquet"):
            out.append(st)
    return out


_ARROW_TO_DTYPE = {
    pa.int32(): INT32,
    pa.int64(): INT64,
    pa.float32(): FLOAT32,
    pa.float64(): FLOAT64,
    pa.bool_(): BOOL,
}


def arrow_schema_to_schema(sch: pa.Schema) -> Schema:
    """Arrow → engine schema with the JAX package's type names. String-like
    fields are typed `string` so a source with text columns still reads; the
    slice refuses them only if a query touches them."""
    fields = []
    for f in sch:
        if f.type in _ARROW_TO_DTYPE:
            fields.append(Field(f.name, _ARROW_TO_DTYPE[f.type]))
        elif (
            pa.types.is_string(f.type)
            or pa.types.is_large_string(f.type)
            or pa.types.is_dictionary(f.type)
            or pa.types.is_temporal(f.type)
        ):
            fields.append(Field(f.name, STRING))
        elif pa.types.is_integer(f.type):
            fields.append(Field(f.name, INT64))
        else:
            raise HyperspaceException(f"Unsupported arrow type: {f.type} ({f.name})")
    return Schema(fields)


def infer_schema(files: List[str], file_format: str) -> Schema:
    """Schema from the first file's footer."""
    _check_format(file_format)
    if not files:
        raise HyperspaceException("No data files to infer schema from.")
    return arrow_schema_to_schema(pq.read_schema(sorted(files)[0]))


def _column_numpy(arr: pa.ChunkedArray, name: str) -> np.ndarray:
    if arr.null_count > 0:
        raise not_in_slice(f"null values (column {name!r})")
    if arr.type not in _ARROW_TO_DTYPE:
        if pa.types.is_integer(arr.type):
            arr = arr.cast(pa.int64())
        else:
            raise not_in_slice(f"string columns (column {name!r}: {arr.type})")
    return arr.to_numpy()


def read_files(
    files: List[str],
    file_format: str,
    columns: Optional[List[str]],
    device,
    row_counts: Optional[List[int]] = None,
) -> Table:
    """Read + concat data files (sorted path order) onto `device`. Files decode
    concurrently (pyarrow releases the GIL); each column crosses to the device
    once. `row_counts`, when given, receives each file's row count in order."""
    _check_format(file_format)
    if not files:
        raise HyperspaceException("No data files to read.")
    ordered = sorted(files)
    with ThreadPoolExecutor(max_workers=min(DECODE_THREADS, len(ordered))) as pool:
        parts = list(pool.map(lambda f: pq.read_table(f, columns=columns), ordered))
    if row_counts is not None:
        row_counts.extend(p.num_rows for p in parts)
    names = parts[0].column_names
    cols = {}
    for n in names:
        pieces = [_column_numpy(p.column(n), n) for p in parts]
        cols[n] = Column.from_numpy(
            pieces[0] if len(pieces) == 1 else np.concatenate(pieces), device
        )
    return Table(cols)


def footer_row_count(files: List[FileStatus]) -> int:
    """Total row count from parquet footers, with no column decode."""
    return sum(pq.ParquetFile(f.path).metadata.num_rows for f in files)


def table_to_arrow(table: Table) -> pa.Table:
    return pa.table({n: pa.array(c.numpy()) for n, c in table.columns.items()})


def write_parquet(table: Table, path: str, row_group_rows: Optional[int] = None) -> None:
    """`row_group_rows` bounds the written row groups (None = pyarrow's default)."""
    at = table_to_arrow(table)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if row_group_rows is None:
        pq.write_table(at, path)
    else:
        pq.write_table(at, path, row_group_size=int(row_group_rows))

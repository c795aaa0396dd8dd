"""File IO: parquet listing, reading into device tables, and the bucketed writer.

Counterpart of `hyperspace_tpu/engine/io.py`, pyarrow-backed as that module
is. A read decodes each file's requested columns on the host (string columns
in code space where the file holds dictionary pages, `engine/encoding.py`),
concatenates them in sorted file order over union dictionaries and copies
each column to the device once. The writer turns a table back into arrow
arrays (string columns as compacted dictionaries) and calls `pq.write_table`
with the same arguments as the JAX package's writer, so equal tables give
equal files. Only parquet is ported; the footer cache, scan caches and
row-group pushdown are not.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import torch

from ..exceptions import HyperspaceException, not_in_slice
from ..storage.filesystem import FileStatus, LocalFileSystem
from ..util.path_utils import is_data_path
from . import encoding as _encoding
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


class FileFooterMeta:
    """What the encoded read needs from one parquet footer: the column names
    and `dict_cols`, per column whether EVERY row-group chunk has a dictionary
    page and the values are strings (the JAX package's `FileFooterMeta`)."""

    __slots__ = ("names", "dict_cols")

    def __init__(self, names, dict_cols):
        self.names = names
        self.dict_cols = dict_cols


def footer_metadata(pf: "pq.ParquetFile") -> FileFooterMeta:
    md = pf.metadata
    schema = pf.schema_arrow
    names = list(schema.names)
    dict_cols = {}
    if md.num_columns == len(names) and md.num_row_groups > 0:  # flat schema: chunk j is column j
        for j, f in enumerate(schema):
            vt = f.type.value_type if pa.types.is_dictionary(f.type) else f.type
            if pa.types.is_string(vt) or pa.types.is_large_string(vt):
                dict_cols[f.name] = all(
                    md.row_group(i).column(j).has_dictionary_page for i in range(md.num_row_groups)
                )
    return FileFooterMeta(names, dict_cols)


def _arrow_to_table(at: pa.Table) -> Table:
    """A host table of an arrow table (`io._arrow_to_table` :183): dictionary
    string columns convert in code space, everything else flattens; nulls
    become a validity mask over canonical fills."""
    cols = {}
    for name in at.column_names:
        arr = at.column(name)
        if pa.types.is_dictionary(arr.type) and _encoding.encoded_exec_enabled():
            c = _encoding.dictionary_array_to_column(arr)
            if c is not None:
                cols[name] = c
                continue
        if pa.types.is_temporal(arr.type):
            arr = arr.cast(pa.string())  # dates ride as ordered strings
        validity = None
        if arr.null_count > 0:
            validity = ~np.asarray(arr.is_null().combine_chunks().to_numpy(zero_copy_only=False))
            if pa.types.is_string(arr.type) or pa.types.is_large_string(arr.type) or pa.types.is_dictionary(arr.type):
                arr = arr.fill_null("")
            elif pa.types.is_boolean(arr.type):
                arr = arr.fill_null(False)
            elif pa.types.is_floating(arr.type):
                arr = arr.fill_null(0.0)
            else:
                arr = arr.fill_null(0)
        if arr.type not in _ARROW_TO_DTYPE and pa.types.is_integer(arr.type):
            arr = arr.cast(pa.int64())
        np_arr = arr.to_numpy(zero_copy_only=False)
        if np_arr.dtype.kind == "O":
            # A zero-row object array stays a string column.
            np_arr = np.empty(0, dtype="<U1") if len(np_arr) == 0 else np.asarray([str(x) for x in np_arr])
        c = Column.from_values(np_arr, "cpu")
        if validity is not None:
            data = c.data.clone()
            valid_t = torch.from_numpy(validity)
            data[~valid_t] = 0  # canonical fill in data/code space
            c = Column(c.dtype, data, c.dictionary, valid_t)
        cols[name] = c
    return Table(cols)


def _read_one(path: str, columns: Optional[List[str]]) -> pa.Table:
    """One parquet file as arrow; string columns whose chunks are all
    dictionary-encoded are read as dictionaries (`io._read_one` :242)."""
    with pq.ParquetFile(path) as pf:
        rd = _encoding.dict_read_columns(footer_metadata(pf), columns)
        if not rd:
            return pf.read(columns=columns)
    with pq.ParquetFile(path, read_dictionary=rd) as pf:
        return pf.read(columns=columns)


def read_files(
    files: List[str],
    file_format: str,
    columns: Optional[List[str]],
    device,
    row_counts: Optional[List[int]] = None,
) -> Table:
    """Read + concat data files (sorted path order) onto `device`. Files decode
    concurrently (pyarrow releases the GIL). Files of one arrow schema
    concatenate as arrow and convert once (a dictionary column's chunks unify
    into the union dictionary of the values present, which is what
    `Table.concat` of the per-file tables gives); files whose schemas differ
    convert one by one and concatenate as tables. Each column crosses to the
    device once. `row_counts`, when given, receives each file's row count in
    order."""
    _check_format(file_format)
    if not files:
        raise HyperspaceException("No data files to read.")
    ordered = sorted(files)
    with ThreadPoolExecutor(max_workers=min(DECODE_THREADS, len(ordered))) as pool:
        parts = list(pool.map(lambda f: _read_one(f, columns), ordered))
    if row_counts is not None:
        row_counts.extend(p.num_rows for p in parts)
    if all(p.schema.equals(parts[0].schema) for p in parts[1:]):
        table = _arrow_to_table(pa.concat_tables(parts))
    else:
        table = Table.concat([_arrow_to_table(p) for p in parts])
    return table.to(device)


def footer_row_count(files: List[FileStatus]) -> int:
    """Total row count from parquet footers, with no column decode."""
    return sum(pq.ParquetFile(f.path).metadata.num_rows for f in files)


def table_to_arrow(table: Table, encode_dictionaries: bool = False) -> pa.Table:
    """Arrow arrays of a table's columns (`io.table_to_arrow` :1196). With
    `encode_dictionaries` (the parquet writer's setting, under
    `HYPERSPACE_ENCODED_EXEC`) string columns go out as compacted dictionary
    arrays; otherwise as decoded values. Nulls become arrow nulls."""
    encode = encode_dictionaries and _encoding.encoded_exec_enabled()
    arrays = {}
    for name, col in table.columns.items():
        mask = None if col.validity is None else ~col.validity.cpu().numpy()
        if encode and col.is_string:
            arrays[name] = _encoding.dictionary_arrow_array(col.data.cpu().numpy(), col.dictionary, mask)
        else:
            arrays[name] = pa.array(col.decode(), mask=mask)
    return pa.table(arrays)


def write_parquet(table: Table, path: str, row_group_rows: Optional[int] = None) -> None:
    """`row_group_rows` bounds the written row groups (None = pyarrow's default)."""
    at = table_to_arrow(table, encode_dictionaries=True)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if row_group_rows is None:
        pq.write_table(at, path)
    else:
        pq.write_table(at, path, row_group_size=int(row_group_rows))

"""File IO: data-file listing, reading into device tables, and the writers.

Counterpart of `hyperspace_tpu/engine/io.py`, pyarrow-backed as that module
is. A read decodes each file's requested columns on the host (string columns
in code space where the file holds dictionary pages, `engine/encoding.py`),
concatenates them in sorted file order over union dictionaries and copies
each column to the device once. The writer turns a table back into arrow
arrays (string columns as compacted dictionaries) and calls `pq.write_table`
with the same arguments as the JAX package's writer, so equal tables give
equal files. A delta table's data files are parquet, so they read, prune and
cache exactly as parquet files do (the snapshot's file list comes from
`storage/delta.py`). ORC reads through `pyarrow.orc`, CSV through
`pyarrow.csv` (no timestamp parsing, an empty cell is null) and JSON lines
through the standard library, as the JAX package reads them; their writers
are its writers. Footer metadata, pushdown and footer row counts stay
parquet's.

A Hive-partitioned read (`partitions=(PartitionSpec, root_paths)`) decodes
each file's own columns only, cached as the file's raw content, and appends
the partition columns, path facts, to the concatenation
(`engine/partitioning.partition_columns`); the concatenation's cache key
carries the partition layout, so a partitioned read and a plain read of the
same files never share an entry.

Reads go through the scan caches (`engine/scan_cache.py`): a file's decoded
columns are cached on the device per (path, size, mtime), and so is a
multi-file scan's concatenation. A parquet footer (row groups and their
per-column min/max/null-count zone maps) is parsed once per file and cached
beside them. A `ScanPredicate` (`engine/pushdown.py`) handed to `read_files`
prunes whole row groups through those zone maps: only the row groups that
can hold a matching row decode, cached under keys of their own.
`HYPERSPACE_SCAN_PUSHDOWN=0` turns pruning off.

Every decode, footer parse and parquet write is a fault point
(`telemetry/faults.py`: `io.decode`, `io.footer`, `storage.write`, and
`pool.worker` in the decode pools) run under `resilience.retry_io`, so a
transient fault is retried and only a finished decode is cached. Reads check
the query deadline between files (`resilience.check_deadline`). The copies
to a CUDA device count their bytes and seconds (`h2d_stats`): the planner
prices a byte moved at that measured rate.

Telemetry, under the JAX package's names: the footer and pruning counters
mirror into the registry (`io.footer.*`, `io.pruning.*`); each file decode
ticks `io.decode.files`, `io.decode.seconds` and the `io.decode.in_flight`
gauge and charges the query's ledger (`decode_files`, `decode_task_s`); a
pruned decode charges `bytes_decoded` / `bytes_skipped`; a copy to the card
is the `h2d` stage and charges `device_upload_bytes`
(`device_observatory.record_h2d`). The decode pools' workers adopt the
submitting query's ledger, scope and stage (`decode` by default).

Concurrent queries share that work (`serve.singleflight`): a footer parse,
each file's decode (keyed by path, projection, row-group selection, stat and
device, so a pruned decode never aliases a whole-file one) and a multi-file
scan's assembly run once for all who ask at the same time; the others wait
and read what the leader cached. A batch decode leads the files no flight
holds, decodes them as one batch, finishes their flights, and only then
waits on the files other queries lead. In a replica fleet each file read
goes through `serve.replicas.coordinate_decode` (the owner reads directly,
another replica under the on-lake lease).
"""

from __future__ import annotations

import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np
import pyarrow as pa
import pyarrow.csv as pa_csv
import pyarrow.parquet as pq
import torch

from .. import resilience as _resilience
from ..config import ENV_INDEX_ROW_GROUP_ROWS, INDEX_ROW_GROUP_ROWS_DEFAULT
from ..exceptions import HyperspaceException, QueryTimeoutError, RetryBudgetExceededError
from ..serve import replicas as _replicas
from ..serve import singleflight as _singleflight
from ..storage.filesystem import FileStatus, FileSystem, LocalFileSystem
from ..telemetry import accounting as _accounting
from ..telemetry import device_observatory as _devobs
from ..telemetry import faults as _faults
from ..telemetry import metrics as _metrics
from ..telemetry import stage_ledger as _stage_ledger
from ..util.path_utils import is_data_path
from . import encoding as _encoding
from .partitioning import partition_columns, values_for
from .pushdown import ZoneStats
from .scan_cache import file_base, global_concat_cache, global_scan_cache
from .schema import BOOL, FLOAT32, FLOAT64, INT32, INT64, STRING, Field, Schema
from .table import Column, Table

def index_row_group_rows() -> int:
    """Row-group cap of the per-bucket index files the build writes:
    bounded, key-sorted row groups give the footer zone maps resolution
    inside a bucket file (`HYPERSPACE_INDEX_ROW_GROUP_ROWS`, 65536)."""
    return max(1, int(os.environ.get(ENV_INDEX_ROW_GROUP_ROWS, "") or INDEX_ROW_GROUP_ROWS_DEFAULT))


#: Files decoded at once by a scan (pyarrow releases the GIL).
DECODE_THREADS = 8

#: The streamed read's decode workers (`io.decode_pool_size` :140): "1" is
#: the serial path, a larger value a cap; unset = min(16, files).
ENV_DECODE_THREADS = "HYPERSPACE_BUILD_DECODE_THREADS"
#: Files the streamed read decodes ahead of its consumer (`prefetch_depth`
#: :152), 16 when unset.
ENV_PREFETCH_FILES = "HYPERSPACE_QUERY_PREFETCH_FILES"
_DEFAULT_PREFETCH_FILES = 16


def decode_pool_size(n_files: int) -> int:
    """Decode workers for `n_files` files under `HYPERSPACE_BUILD_DECODE_THREADS`."""
    raw = int(os.environ.get(ENV_DECODE_THREADS, "0") or 0)
    if raw == 1:
        return 1
    if raw > 1:
        return min(raw, n_files)
    return min(16, n_files)


def prefetch_depth() -> int:
    """Files the streamed read keeps in flight (at least 1)."""
    return max(1, int(os.environ.get(ENV_PREFETCH_FILES, _DEFAULT_PREFETCH_FILES) or _DEFAULT_PREFETCH_FILES))


#: The formats whose data files are parquet (`io._read_one` :244).
PARQUET_SHAPED = ("parquet", "delta")

#: Each format's data-file extensions (`io._FORMAT_EXTENSIONS` :54); a delta
#: table's data files are parquet.
FORMAT_EXTENSIONS = {
    "parquet": (".parquet",),
    "delta": (".parquet",),
    "csv": (".csv",),
    "json": (".json",),
    "orc": (".orc",),
}


def _check_format(file_format: str) -> None:
    if file_format not in FORMAT_EXTENSIONS:
        raise HyperspaceException(f"Unsupported file format: {file_format}")


def list_data_files(path: str, file_format: str, fs: Optional[FileSystem] = None) -> List[FileStatus]:
    """Data files under a root path (file or directory, recursive), with the
    metadata filter applied to every component below the root."""
    _check_format(file_format)
    fs = fs or LocalFileSystem()
    if not fs.exists(path):
        raise HyperspaceException(f"Path does not exist: {path}")
    if not fs.is_dir(path):
        return [fs.get_status(path)]
    rootnorm = os.path.normpath(path)
    exts = FORMAT_EXTENSIONS[file_format]
    out = []
    for st in fs.list_leaf_files(path):
        rel = os.path.relpath(os.path.normpath(st.path), rootnorm)
        if all(is_data_path(p) for p in rel.split(os.sep)) and st.path.endswith(exts):
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
    """Schema of the first file in sorted order (`io.infer_schema` :1153):
    from a parquet footer or an ORC file's schema; a CSV or JSON file is
    decoded."""
    _check_format(file_format)
    if not files:
        raise HyperspaceException("No data files to infer schema from.")
    first = sorted(files)[0]
    if file_format in PARQUET_SHAPED:
        return arrow_schema_to_schema(pq.read_schema(first))
    if file_format == "orc":
        from pyarrow import orc as pa_orc

        return arrow_schema_to_schema(pa_orc.ORCFile(first).schema)
    return _arrow_to_table(_read_other(first, file_format, None)).schema


def _read_json_lines(path: str) -> pa.Table:
    """Line-delimited JSON by the standard library (`io._read_json_lines`
    :301): unlike `pyarrow.json` it never reads a date-like string as a
    timestamp."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    if not rows:
        raise HyperspaceException(f"Empty JSON file: {path}")
    return pa.table({n: pa.array([r[n] for r in rows]) for n in rows[0]})


def _read_other(path: str, file_format: str, columns: Optional[List[str]]) -> pa.Table:
    """One ORC, CSV or JSON file as arrow (`io._read_one` :277-298). A CSV
    keeps date-like strings (no timestamp parsers; `pyarrow.csv` still types
    ISO dates `date32`, which the conversion casts back to strings) and
    reads an empty cell as null."""
    _faults.check("io.decode")
    with _timed("decode"):
        if file_format == "orc":
            from pyarrow import orc as pa_orc

            return pa_orc.ORCFile(path).read(columns=columns)
        if file_format == "csv":
            at = pa_csv.read_csv(
                path, convert_options=pa_csv.ConvertOptions(timestamp_parsers=[], strings_can_be_null=True)
            )
        else:
            at = _read_json_lines(path)
        return at.select(columns) if columns else at


class RowGroupMeta:
    """One row group's row count, byte size, per-column `ZoneStats` and
    per-column uncompressed chunk bytes."""

    __slots__ = ("num_rows", "total_bytes", "stats", "col_bytes")

    def __init__(self, num_rows: int, total_bytes: int, stats: dict, col_bytes: dict):
        self.num_rows = num_rows
        self.total_bytes = total_bytes
        self.stats = stats
        self.col_bytes = col_bytes


class FileFooterMeta:
    """One parquet file's footer facts (`io.FileFooterMeta` :348): row count,
    arrow schema, `dict_cols` (per column, whether EVERY row-group chunk has
    a dictionary page and the values are strings: the encoded read's choice)
    and the row groups' zone maps. The zone maps are parsed from the footer
    on first use (a read that prunes nothing never pays for them)."""

    __slots__ = ("num_rows", "names", "arrow_schema", "dict_cols", "num_row_groups", "_md", "_row_groups")

    def __init__(self, md: "pq.FileMetaData", arrow_schema: pa.Schema):
        self.num_rows = md.num_rows
        self.names = list(arrow_schema.names)
        self.arrow_schema = arrow_schema
        self.num_row_groups = md.num_row_groups
        self._md = md
        self._row_groups: Optional[List[RowGroupMeta]] = None
        # Column chunk j is field j only in a flat schema.
        self.dict_cols: Dict[str, bool] = {}
        if md.num_columns == len(self.names) and md.num_row_groups > 0:
            for j, f in enumerate(arrow_schema):
                vt = f.type.value_type if pa.types.is_dictionary(f.type) else f.type
                self.dict_cols[f.name] = bool(pa.types.is_string(vt) or pa.types.is_large_string(vt)) and all(
                    md.row_group(i).column(j).has_dictionary_page for i in range(md.num_row_groups)
                )

    @property
    def row_groups(self) -> List[RowGroupMeta]:
        if self._row_groups is None:
            self._row_groups = _zone_maps(self._md, self.names)
        return self._row_groups


def _zone_maps(md: "pq.FileMetaData", names: List[str]) -> List[RowGroupMeta]:
    """Each row group's rows, bytes, per-column `ZoneStats` and chunk bytes
    (zone maps only for a flat schema)."""
    flat = md.num_columns == len(names)
    row_groups = []
    for i in range(md.num_row_groups):
        rg = md.row_group(i)
        stats: Dict[str, ZoneStats] = {}
        col_bytes: Dict[str, int] = {}
        for j in range(rg.num_columns if flat else 0):
            chunk = rg.column(j)
            col_bytes[names[j]] = int(chunk.total_uncompressed_size)
            st = chunk.statistics
            if st is None:
                stats[names[j]] = ZoneStats()
                continue
            mn = mx = None
            has = bool(st.has_min_max)
            if has:
                mn, mx = _stat_value(st.min), _stat_value(st.max)
                has = mn is not None and mx is not None
            stats[names[j]] = ZoneStats(mn, mx, has, st.null_count if st.has_null_count else None)
        row_groups.append(RowGroupMeta(rg.num_rows, rg.total_byte_size, stats, col_bytes))
    return row_groups


#: Footer-cache traffic, row-group pruning outcomes and file decodes, as
#: plain counters (`io_stats`); the byte counters tick only at real pruned
#: decodes.
_COUNTS = {
    "footer_hits": 0, "footer_misses": 0, "row_groups_scanned": 0, "row_groups_skipped": 0,
    "bytes_decoded": 0, "bytes_skipped": 0, "decode_files": 0,
}
#: Seconds of the scan's parts: the parquet decode (summed over the decode
#: threads), then the conversion to columns (dictionary strings in code
#: space), the copy to the device and the concatenation, each in the scan's
#: own thread.
SCAN_SECONDS = {"decode": 0.0, "convert": 0.0, "to_device": 0.0, "concat": 0.0}
#: Bytes and seconds of the copies to a CUDA device: the measured
#: host-to-device rate the planner's calibration reads.
_H2D = {"bytes": 0, "seconds": 0.0}
_stats_lock = threading.Lock()


#: `_COUNTS` name -> the registry counter it mirrors.
_REGISTRY_COUNTS = {
    "footer_hits": _metrics.counter("io.footer.hits"),
    "footer_misses": _metrics.counter("io.footer.misses"),
    "row_groups_scanned": _metrics.counter("io.pruning.row_groups_scanned"),
    "row_groups_skipped": _metrics.counter("io.pruning.row_groups_skipped"),
    "bytes_decoded": _metrics.counter("io.pruning.bytes_decoded"),
    "bytes_skipped": _metrics.counter("io.pruning.bytes_skipped"),
    "decode_files": _metrics.counter("io.decode.files"),
}
_DECODE_SECONDS = _metrics.histogram("io.decode.seconds")
_DECODE_IN_FLIGHT = _metrics.gauge("io.decode.in_flight")
_DECODE_IN_FLIGHT_PEAK = _metrics.gauge("io.decode.in_flight_peak")


def _count(name: str, n: int = 1) -> None:
    with _stats_lock:
        _COUNTS[name] += n
    _REGISTRY_COUNTS[name].inc(n)


@contextmanager
def _decode_accounting():
    """One file decode: the in-flight gauge while it runs, then the decode
    counters and the query's `decode_files` / `decode_task_s`."""
    _DECODE_IN_FLIGHT.inc()
    _DECODE_IN_FLIGHT_PEAK.set_max(_DECODE_IN_FLIGHT.value)
    t0 = time.monotonic()
    try:
        yield
    finally:
        dt = time.monotonic() - t0
        _DECODE_IN_FLIGHT.dec()
        _count("decode_files")
        _DECODE_SECONDS.observe(dt)
        _accounting.add("decode_files", 1)
        _accounting.add("decode_task_s", dt)


@contextmanager
def adopt(led, sc, stage, leading=None):
    """Run a pool worker's body as the submitting query: its ledger, its
    resilience scope, its stage and the single-flights it leads."""
    with _accounting.use_ledger(led), _resilience.use_scope(sc), _stage_ledger.stage_scope(stage), \
            _singleflight.lead_with(leading):
        yield


def submitter():
    """What a pool's workers adopt (`adopt`): the caller's ledger, scope,
    stage (`decode` by default) and led flights."""
    return (_accounting.current_ledger(), _resilience.current_scope(), _stage_ledger.worker_stage("decode"),
            _singleflight.leads())


@contextmanager
def _timed(part: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        with _stats_lock:
            SCAN_SECONDS[part] += time.perf_counter() - t0


def io_stats() -> dict:
    """The footer, pruning and file-decode counters and the scan's seconds
    by part."""
    with _stats_lock:
        return {**_COUNTS, "seconds": dict(SCAN_SECONDS)}


def reset_io_stats() -> None:
    with _stats_lock:
        for k in _COUNTS:
            _COUNTS[k] = 0
        for k in SCAN_SECONDS:
            SCAN_SECONDS[k] = 0.0
        _H2D["bytes"], _H2D["seconds"] = 0, 0.0


def h2d_stats() -> dict:
    """Bytes copied to a CUDA device by the scans, their seconds (ended by
    a synchronization) and the rate in GB/s (None before any copy)."""
    with _stats_lock:
        b, s = _H2D["bytes"], _H2D["seconds"]
    return {"bytes": b, "seconds": s, "gb_per_s": (b / s / 1e9) if b and s > 0 else None}


def _stat_value(v):
    """A parquet statistics value in the engine's comparison space (UTF-8
    bytes decode to str; undecodable bytes are unusable)."""
    if isinstance(v, bytes):
        try:
            return v.decode("utf-8")
        except UnicodeDecodeError:
            return None
    return v


def _meta_nbytes(meta: FileFooterMeta) -> int:
    """The footer's charge to the scan-cache budget (an estimate)."""
    return 512 + (64 + 96 * max(1, len(meta.names))) * max(1, meta.num_row_groups)


def footer_metadata(path: str, file_format: str = "parquet", _pf=None, base=None) -> Optional[FileFooterMeta]:
    """One parquet file's footer through the scan cache (freshness = the
    cache's (path, size, mtime) base). None for another format or an
    unreadable footer: the scan then prunes nothing in that file. `_pf` lets
    a cold read parse the footer from its own open; `base` is the file's
    stat when the caller has it."""
    if file_format not in PARQUET_SHAPED:
        return None
    cache = global_scan_cache()
    base = base or file_base(path)
    meta = cache.get_meta(path, base)
    if meta is not None:
        _count("footer_hits")
        return meta
    _count("footer_misses")

    def parse() -> FileFooterMeta:
        _faults.check("io.footer")
        if _pf is not None:
            return FileFooterMeta(_pf.metadata, _pf.schema_arrow)
        with pq.ParquetFile(path) as pf:
            return FileFooterMeta(pf.metadata, pf.schema_arrow)

    def parse_and_cache() -> Optional[FileFooterMeta]:
        try:
            meta = _resilience.retry_io("io.footer", parse)
        except (QueryTimeoutError, RetryBudgetExceededError):
            raise  # query contracts, not pruning details
        except Exception:
            return None  # a corrupt footer costs the pruning, never the scan
        cache.put_meta(path, meta, _meta_nbytes(meta), base)
        return meta

    # One parse for every concurrent cold scan of the file; `_pf` is only
    # touched on the leader's own path.
    return _singleflight.shared(("meta", path, base), parse_and_cache, lambda: cache.get_meta(path, base))


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


def _read_arrow(path: str, columns: Optional[List[str]], sel=None, base=None) -> pa.Table:
    """One parquet file, or only its row groups `sel` (ascending, in the
    file's own row order), as arrow (`io._read_one` :242,
    `io._read_row_groups_one` :654). String columns whose chunks are all
    dictionary-encoded read as dictionaries; a cold footer is parsed from
    this read's own open."""
    _faults.check("io.decode")
    meta = global_scan_cache().get_meta(path, base)
    if meta is not None:
        _count("footer_hits")
    with _timed("decode"):
        with pq.ParquetFile(path) as pf:
            if meta is None:
                meta = footer_metadata(path, _pf=pf, base=base)
            rd = _encoding.dict_read_columns(meta, columns)
            if not rd:
                return pf.read(columns=columns) if sel is None else pf.read_row_groups(list(sel), columns=columns)
        with pq.ParquetFile(path, read_dictionary=rd) as pf:
            return pf.read(columns=columns) if sel is None else pf.read_row_groups(list(sel), columns=columns)


def selection_columns(columns: Optional[List[str]], meta: FileFooterMeta) -> List[str]:
    """The explicit column list of a selection-keyed cache entry: the
    projection, or the footer's whole-file order for columns=None."""
    return list(columns) if columns is not None else list(meta.names)


def _joined(tensors: List[torch.Tensor]) -> torch.Tensor:
    """One host tensor of `tensors`: a view when they are consecutive
    slices of one buffer (a batch converted at once), else a copy."""
    first = tensors[0]
    ptr, end = first.untyped_storage().data_ptr(), first.storage_offset()
    for t in tensors:
        if not t.is_contiguous() or t.untyped_storage().data_ptr() != ptr or t.storage_offset() != end:
            return torch.cat(tensors)
        end += t.numel()
    return torch.as_strided(first, (end - first.storage_offset(),), (1,), first.storage_offset())


def _convert_batch(arrows: List[pa.Table]) -> List[Table]:
    """Host tables of a batch of per-file arrow tables. A batch of one
    schema converts each non-string column once for all its files and
    splits it into per-file views (a conversion per file and column costs
    more than its bytes); string columns keep a dictionary per file, as a
    single-file read gives them."""
    if len(arrows) == 1 or not all(a.schema.equals(arrows[0].schema) for a in arrows[1:]):
        return [_arrow_to_table(a) for a in arrows]
    sizes = [a.num_rows for a in arrows]
    out: List[Dict[str, Column]] = [{} for _ in arrows]
    for j, f in enumerate(arrows[0].schema):
        t = f.type
        if pa.types.is_dictionary(t) or pa.types.is_string(t) or pa.types.is_large_string(t) or pa.types.is_temporal(t):
            for i, a in enumerate(arrows):
                out[i][f.name] = _arrow_to_table(a.select([j])).columns[f.name]
            continue
        chunks = [c for a in arrows for c in a.column(j).chunks]
        whole = _arrow_to_table(pa.table({f.name: pa.chunked_array(chunks, type=t)})).columns[f.name]
        data = whole.data.split(sizes)
        valid = [None] * len(arrows) if whole.validity is None else whole.validity.split(sizes)
        for i in range(len(arrows)):
            out[i][f.name] = Column(whole.dtype, data[i], None, valid[i])
    return [Table(o) for o in out]


def _to_device_batched(hosts: List[Table], device) -> List[Table]:
    """Host tables on `device` with one copy per column for the whole batch,
    split back into per-file views on the device."""
    if device.type == "cpu":
        return hosts
    with _timed("to_device"), _stage_ledger.stage_scope("h2d"):
        if device.type == "cuda":
            torch.cuda.synchronize(device)  # the copies alone: no earlier work, no context start
        t0 = time.perf_counter()
        moved = 0
        out: List[Dict[str, Column]] = [{} for _ in hosts]
        for n in dict.fromkeys(n for h in hosts for n in h.column_names):
            idx = [i for i, h in enumerate(hosts) if n in h.columns]
            cols = [hosts[i].columns[n] for i in idx]
            sizes = [len(c) for c in cols]
            moved += sum(c.data.numel() * c.data.element_size() for c in cols)
            if len({c.data.dtype for c in cols}) == 1:
                data = _joined([c.data for c in cols]).to(device).split(sizes)
            else:
                data = [c.data.to(device) for c in cols]
            valid = [None] * len(cols)
            nullable = [k for k, c in enumerate(cols) if c.validity is not None]
            if nullable:
                moved += sum(sizes[k] for k in nullable)
                parts = _joined([cols[k].validity for k in nullable]).to(device).split([sizes[k] for k in nullable])
                for k, v in zip(nullable, parts):
                    valid[k] = v
            for k, i in enumerate(idx):
                c = cols[k]
                out[i][n] = Column(c.dtype, data[k], c.dictionary, valid[k], c.encoded_read)
        if moved and device.type == "cuda":
            torch.cuda.synchronize(device)
            seconds = time.perf_counter() - t0
            with _stats_lock:
                _H2D["bytes"] += moved
                _H2D["seconds"] += seconds
            _devobs.record_h2d(moved, seconds)
            _accounting.add("device_upload_bytes", moved)
        return [Table({n: o[n] for n in h.column_names}) for h, o in zip(hosts, out)]


_POOL: Optional[ThreadPoolExecutor] = None


def _pool() -> ThreadPoolExecutor:
    """The decode threads, shared by every scan (made on first use)."""
    global _POOL
    if _POOL is None:
        _POOL = ThreadPoolExecutor(max_workers=DECODE_THREADS, thread_name_prefix="hs-decode")
    return _POOL


def _cols_key(columns: Optional[List[str]]) -> tuple:
    """A projection in a flight key (None, all columns, never aliases an
    empty projection)."""
    return ("<all>",) if columns is None else tuple(columns)


def _decode_into_cache(jobs: List[tuple], device, file_format: str = "parquet") -> List[Table]:
    """The miss half of `decode_files` (`io._decode_into_cache` :572) under
    single-flight, one flight a job (path, projection, selection, stat,
    device). The batch this query leads decodes at once (`_decode_batch`)
    and its flights finish before this query waits on any flight another
    query leads; a followed job is read from the cache its leader filled,
    or decoded here when that leader failed or its entry is gone. The
    caller counted the misses; a follower's re-probe counts nothing."""
    if not _singleflight.serving_enabled():
        return _decode_batch(jobs, device, file_format)
    cache = global_scan_cache()
    keys = [("file", path, _cols_key(cols), sel, base, str(device)) for path, cols, _meta, sel, base in jobs]
    first: Dict[tuple, int] = {}
    for i, k in enumerate(keys):
        first.setdefault(k, i)  # a job twice in the batch is decoded once
    out: Dict[tuple, Table] = {}
    todo = list(first)
    while todo:
        led, followed = _singleflight.claim(todo)
        done: set = set()
        try:
            mine = [k for k in todo if k in led]
            if mine:
                for k, t in zip(mine, _decode_batch([jobs[first[k]] for k in mine], device, file_format)):
                    out[k] = t
                done = set(mine)
        finally:
            _singleflight.finish(led, done)
        retry = []
        for k, fl in followed.items():
            path, cols, _meta, sel, base = jobs[first[k]]
            t = cache.get(path, cols, record=False, sel=sel, device=device, base=base) if _singleflight.follow(fl) else None
            if t is None:  # its leader failed, or the entry is gone: lead it again
                _singleflight.note_follower_retry()
                retry.append(k)
            else:
                _singleflight.note_dedup_hit()
                out[k] = t
        todo = retry
    return [out[k] for k in keys]


def _decode_batch(jobs: List[tuple], device, file_format: str = "parquet") -> List[Table]:
    """Decode a batch of cache misses: each job's file in the columns the
    cache lacks (all of them when it cannot tell; a file of another format
    than parquet decodes whole anyway), the arrow reads on the decode
    threads (each through the fleet's `coordinate_decode`), the conversions
    here, one copy to the device per column for the batch, and every table
    cached."""
    cache = global_scan_cache()
    reads = []
    for path, cols, meta, sel, base in jobs:
        missing = cache.missing_columns(path, cols, sel, device, base) if file_format in PARQUET_SHAPED else None
        reads.append(missing if missing and missing != list(cols or []) else cols)
    args = [(job[0], rd, job[3], job[4]) for job, rd in zip(jobs, reads)]

    def read_one(a):
        with _decode_accounting():
            if file_format in PARQUET_SHAPED:
                return _resilience.retry_io("io.decode", lambda: _read_arrow(*a))
            return _resilience.retry_io("io.decode", lambda: _read_other(a[0], file_format, a[1]))

    def read(a):
        return _replicas.coordinate_decode(a[0], lambda: read_one(a))

    if len(args) > 1 and decode_pool_size(len(args)) > 1:
        sub = submitter()

        def worker(a):
            with adopt(*sub):
                _faults.check("pool.worker")
                return read(a)

        arrows = list(_pool().map(worker, args))
    else:
        arrows = [read(a) for a in args]  # retry_io checks the deadline before each
    # A batch that outlived the query's deadline caches nothing.
    _resilience.check_deadline("io.decode_files")
    with _timed("convert"):
        hosts = _convert_batch(arrows)
    out = []
    for (path, cols, meta, sel, base), rd, t in zip(jobs, reads, _to_device_batched(hosts, device)):
        cache.put(path, rd, t, sel, device, base)
        if sel is not None:
            _record_decoded_bytes(meta, sel, t.column_names)
        if rd is not cols:  # only the cold columns were read: assemble the rest from the cache
            whole = cache.get(path, cols, record=False, sel=sel, device=device, base=base)
            t = whole if whole is not None else _decode_batch([(path, list(cols or meta.names), meta, sel, base)], device)[0]
        out.append(t)
    return out


def _empty_file_table(meta: FileFooterMeta, columns: Optional[List[str]], device) -> Table:
    """The 0-row table of an all-pruned file, with the file's exact decoded
    types (from its footer schema), so concatenation promotes as unpruned."""
    at = meta.arrow_schema.empty_table()
    if columns is not None:
        at = at.select(columns)
    return _arrow_to_table(at).to(device)


def _record_decoded_bytes(meta: Optional[FileFooterMeta], sel: tuple, decoded_cols: List[str]) -> None:
    """Bytes of the decoded columns' chunks in the kept and in the pruned row
    groups, counted only where a pruned decode really ran."""
    if meta is None:
        return

    def cols_bytes(rg) -> int:
        return sum(rg.col_bytes.get(c, 0) for c in decoded_cols) if rg.col_bytes else rg.total_bytes

    keep = set(sel)
    decoded = sum(cols_bytes(rg) for i, rg in enumerate(meta.row_groups) if i in keep)
    skipped = sum(cols_bytes(rg) for i, rg in enumerate(meta.row_groups) if i not in keep)
    _count("bytes_decoded", decoded)
    _count("bytes_skipped", skipped)
    # The ledger's mirror: the same values at the same site.
    _accounting.add("bytes_decoded", decoded)
    _accounting.add("bytes_skipped", skipped)


def pushdown_selections(ordered: List[str], pushdown, file_format: str = "parquet"):
    """Per-file (meta, sel) of one scan, aligned with `ordered` (sel None =
    every row group), or None when pushdown does not apply (no predicate,
    not parquet) or prunes nothing anywhere: the caller then reads exactly
    as without pushdown, with the same cache keys (`io._pushdown_selections`
    :485). Counts nothing."""
    if pushdown is None or file_format not in PARQUET_SHAPED:
        return None
    out = []
    for p in ordered:
        meta = footer_metadata(p)
        out.append((meta, pushdown.select_row_groups(meta) if meta is not None else None))
    return out if any(sel is not None for _, sel in out) else None


def record_pruning(selections, pruning_stats: Optional[dict] = None) -> None:
    """Count one assembling scan's kept and skipped row groups; a scan served
    whole by a concat cache never counts (`io._record_pruning` :505)."""
    scanned = skipped = 0
    for meta, sel in selections:
        if meta is None:
            continue
        n = meta.num_row_groups
        scanned += n if sel is None else len(sel)
        skipped += 0 if sel is None else n - len(sel)
    _count("row_groups_scanned", scanned)
    _count("row_groups_skipped", skipped)
    if pruning_stats is not None:
        pruning_stats["row_groups_scanned"] = pruning_stats.get("row_groups_scanned", 0) + scanned
        pruning_stats["row_groups_skipped"] = pruning_stats.get("row_groups_skipped", 0) + skipped


def _stat_all(files: List[str]) -> tuple:
    """`file_base` of each file (None where it cannot be stat'ed); many
    files are stat'ed on the decode threads, a slice each (a stat releases
    the GIL)."""
    if len(files) <= 16:
        return tuple(map(file_base, files))
    step = -(-len(files) // DECODE_THREADS)
    slices = [files[i: i + step] for i in range(0, len(files), step)]
    return tuple(b for part in _pool().map(lambda fs: [file_base(p) for p in fs], slices) for b in part)


def file_stats(files: List[str]) -> Optional[tuple]:
    """Every file's (path, size, mtime), or None if one cannot be stat'ed."""
    bases = _stat_all(files)
    return None if any(b is None for b in bases) else bases


def concat_cache_probe(
    ordered: List[str], columns: Optional[List[str]], device, selection_marker=None, file_format="parquet",
    partitions=None,
):
    """(key, cached table or None) of a multi-file scan in the plain concat
    cache. The key holds the format, every file's (path, size, mtime), the
    columns, the partition layout and the device; a pushdown's selections
    key a pruned concat apart from the whole one (`io.concat_cache_probe`
    :968)."""
    if len(ordered) <= 1:
        return None, None
    stats = file_stats(ordered)
    if stats is None:
        return None, None
    part = None
    if partitions is not None:
        spec, roots = partitions
        part = (tuple(spec.columns), tuple(spec.dtypes), tuple(roots))
    key = ("concat", file_format, stats, ("<all>",) if columns is None else tuple(columns), part, str(device))
    if selection_marker is not None:
        key += (("rgsel", selection_marker),)
    hit = global_concat_cache().get(key)
    return key, None if hit is None else hit[0]


def decode_files(
    jobs: List[tuple], device, bases: Optional[tuple] = None, file_format: str = "parquet"
) -> List[Table]:
    """`jobs` of (path, columns, meta, sel) as tables on `device` through the
    per-file scan cache: the port's `file_table` / `pruned_file_table`
    (`io.py` :551, :685) for a whole scan at once. `sel` None reads the whole
    file under its whole-file keys; a tuple reads those row groups under
    selection keys, never aliasing the whole-file entries; an empty tuple is
    the file's 0-row table. `bases` are the files' stats when the caller
    has them."""
    device = torch.device(device)
    cache = global_scan_cache()
    bases = bases or _stat_all([job[0] for job in jobs])
    tables: List[Optional[Table]] = []
    for (path, cols, meta, sel), base in zip(jobs, bases):
        if sel is None:
            tables.append(cache.get(path, cols, device=device, base=base))
        elif len(sel) == 0:
            tables.append(_empty_file_table(meta, cols, device))
        else:
            tables.append(cache.get(path, selection_columns(cols, meta), sel=tuple(sel), device=device, base=base))
    missing = [i for i, t in enumerate(tables) if t is None]
    cold = []
    for i in missing:
        path, cols, meta, sel = jobs[i]
        if sel is None:
            cold.append((path, cols, meta, None, bases[i]))
        else:
            cold.append((path, selection_columns(cols, meta), meta, tuple(sel), bases[i]))
    for i, t in zip(missing, _decode_into_cache(cold, device, file_format) if cold else []):
        tables[i] = t
    return tables


def concat_tables(tables: List[Table]) -> Table:
    with _timed("concat"):
        return tables[0] if len(tables) == 1 else Table.concat(tables)


def file_columns_for(columns: Optional[List[str]], partitions) -> Optional[List[str]]:
    """The columns to decode from the files for a wanted projection
    (`io.file_columns_for` :533): partition columns are path facts, not file
    content. None = every file column (also when only partition columns are
    wanted: `_file_jobs` then asks a parquet file for one column, which
    gives the row count)."""
    if partitions is None or columns is None:
        return columns
    pset = {c.lower() for c in partitions[0].columns}
    file_columns = [c for c in columns if c.lower() not in pset]
    return file_columns or None


def _file_jobs(paths: List[str], file_format: str, columns, partitions, selections, bases) -> List[tuple]:
    """`decode_files` jobs of one read: each file's columns and row groups."""
    file_cols = file_columns_for(columns, partitions)
    jobs = []
    for p, (meta, sel), base in zip(paths, selections, bases):
        cols = file_cols
        if cols is None and columns is not None and file_format in PARQUET_SHAPED:
            meta = meta or footer_metadata(p, base=base)
            cols = meta.names[:1] if meta is not None and meta.names else None
        jobs.append((p, cols, meta, sel))
    return jobs


def decorate(table: Table, paths: List[str], counts: List[int], partitions, columns, device) -> Table:
    """The rows of `paths` (`counts[i]` rows of file i, in that order) with
    the partition columns appended and the wanted columns selected
    (`io.decorate_file_table` :805, for a whole read at once)."""
    if partitions is None:
        return table
    spec, roots = partitions
    values = [values_for(spec, roots, p) for p in paths]
    t = Table({**table.columns, **dict(partition_columns(spec, values, counts, columns, device))})
    return t.select(columns) if columns is not None else t


def read_in_order(
    paths: List[str], file_format: str, columns: Optional[List[str]], device, partitions=None, selections=None,
    bases=None,
):
    """(the files' rows concatenated in the given order, each file's row
    count): every file through the per-file scan cache, the partition
    columns appended once for all of them. No concatenation cache."""
    device = torch.device(device)
    selections = selections or [(None, None)] * len(paths)
    bases = bases or _stat_all(paths)
    jobs = _file_jobs(paths, file_format, columns, partitions, selections, bases)
    tables = decode_files(jobs, device, bases, file_format)
    counts = [t.num_rows for t in tables]
    return decorate(concat_tables(tables), paths, counts, partitions, columns, device), counts


def read_files(
    files: List[str],
    file_format: str,
    columns: Optional[List[str]],
    device,
    pushdown=None,
    pruning_stats: Optional[dict] = None,
    partitions=None,
) -> Table:
    """Read and concatenate data files, in sorted path order, onto `device`
    (`io.read_files` :1014). Each file's table comes through the per-file scan
    cache; a multi-file scan's concatenation is cached too. `pushdown` (a
    `ScanPredicate`) decodes only the row groups whose footer zone maps can
    satisfy it; when it prunes nothing the read is the pushdown-free read,
    cache keys included. An all-pruned file gives its 0-row table, so types
    and union dictionaries are those of the whole read. `partitions` =
    (PartitionSpec, root_paths) appends a Hive layout's columns."""
    _check_format(file_format)
    if not files:
        raise HyperspaceException("No data files to read.")
    _resilience.check_deadline("io.read_files")
    device = torch.device(device)
    ordered = sorted(files)
    selections = pushdown_selections(ordered, pushdown, file_format)
    marker = None if selections is None else tuple(sel for _, sel in selections)
    key, cached = concat_cache_probe(ordered, columns, device, marker, file_format, partitions)
    if cached is not None:
        return cached

    def assemble() -> Table:
        if selections is not None:
            record_pruning(selections, pruning_stats)
        out, _ = read_in_order(ordered, file_format, columns, device, partitions, selections)
        if key is not None:
            global_concat_cache().put(key, out, None)
        return out

    if key is None:
        return assemble()

    def reprobe() -> Optional[Table]:
        hit = global_concat_cache().get(key)
        return None if hit is None else hit[0]

    # N identical concurrent cold scans assemble once; the others are served
    # the concatenation the leader cached (their re-probe counts its hit).
    return _singleflight.shared(("scan",) + key, assemble, reprobe)


def iter_file_tables(
    files: List[str], file_format: str, columns: Optional[List[str]], device, partitions=None, on_decode=None,
    pushdown=None, pruning_stats: Optional[dict] = None,
):
    """The files' tables one by one in sorted path order, decoded on a pool
    up to `prefetch_depth()` files ahead of the consumer (`iter_file_tables`
    :876): the streamed read. Each file goes through the per-file scan cache
    (no concatenation cache: the stream never concatenates). A `pushdown`
    keeps only the row groups its zone maps cannot exclude, and an all-pruned
    file yields its 0-row table, so types promote as in the whole read. A
    Hive layout's partition columns are appended file by file
    (`decorate`). Tables come in file order, whatever order their decodes
    finish in; a failed decode raises at its file's place in that order and
    caches nothing (the cache holds only finished decodes). `on_decode(s)`
    sees each file's decode seconds."""
    if not files:
        return
    _check_format(file_format)
    device = torch.device(device)
    ordered = sorted(files)
    selections = pushdown_selections(ordered, pushdown, file_format)
    sel_of = {}
    if selections is not None:
        record_pruning(selections, pruning_stats)
        sel_of = dict(zip(ordered, selections))

    sub = submitter()

    def decode_one(path: str) -> Table:
        with adopt(*sub):
            _faults.check("pool.worker")
            t0 = time.monotonic()
            base = file_base(path)
            jobs = _file_jobs([path], file_format, columns, partitions, [sel_of.get(path, (None, None))], (base,))
            t = decode_files(jobs, device, (base,), file_format)[0]
            if on_decode is not None:
                on_decode(time.monotonic() - t0)
            return decorate(t, [path], [t.num_rows], partitions, columns, device)

    depth = prefetch_depth()
    workers = min(decode_pool_size(len(ordered)), depth)
    if workers <= 1:
        for f in ordered:
            _resilience.check_deadline("io.iter_file_tables")
            yield decode_one(f)
        return
    from collections import deque

    pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="hs-stream")
    try:
        pending: deque = deque()
        i = 0
        while i < len(ordered) or pending:
            _resilience.check_deadline("io.iter_file_tables")
            while i < len(ordered) and len(pending) < depth:
                pending.append(pool.submit(decode_one, ordered[i]))
                i += 1
            yield pending.popleft().result()
    finally:
        # Undelivered decodes are cancelled; running ones finish into the
        # cache harmlessly.
        pool.shutdown(wait=False, cancel_futures=True)


def footer_row_count(files: List[FileStatus], file_format: str = "parquet") -> Optional[int]:
    """Total row count from parquet footers (through the footer cache), with
    no column decode; None for another format (no row-count metadata) or an
    unreadable footer."""
    if file_format not in PARQUET_SHAPED:
        return None
    total = 0
    for f in files:
        meta = footer_metadata(f.path)
        if meta is None:
            return None  # unreadable: the caller reads the files, under its guard
        total += meta.num_rows
    return total


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
    """`row_group_rows` bounds the written row groups (None = pyarrow's
    default). The `storage.write` fault point and retry site
    (`io.checked_write_table` :1214): a retried write truncates the partial
    file, so the committed bytes are one clean encode."""
    at = table_to_arrow(table, encode_dictionaries=True)

    def write() -> None:
        _faults.check("storage.write")
        if row_group_rows is None:
            pq.write_table(at, path)
        else:
            pq.write_table(at, path, row_group_size=int(row_group_rows))

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _resilience.retry_io("storage.write", write)


def write_orc(table: Table, path: str) -> None:
    from pyarrow import orc as pa_orc

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    pa_orc.write_table(table_to_arrow(table), path)


def write_csv(table: Table, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    pa_csv.write_csv(table_to_arrow(table), path)


def write_json(table: Table, path: str) -> None:
    """Line-delimited JSON (pyarrow has no JSON writer; `io.write_json` :1258)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cols = {n: c.decode_objects() for n, c in table.columns.items()}
    with open(path, "w") as f:
        for i in range(table.num_rows):
            row = {n: v[i].item() if hasattr(v[i], "item") else v[i] for n, v in cols.items()}
            f.write(json.dumps(row) + "\n")

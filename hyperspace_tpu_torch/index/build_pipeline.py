"""The build's sort, copy to the host and bucket writes: the only place that
writes a build's bucket files (counterpart of
`hyperspace_tpu/index/build_pipeline.py` `_BucketWriter` :264 and
`_sort_write_summarize` :670).

`pipelined_write` runs one `create_index` (or a refresh's rebuild) after its
source is chosen:

1. decode: the builder's read (`CoveringIndexBuilder._index_table`: the
   deadline check, the single-flight scan, the concat-cache insert);
2. sort by (bucket, keys, row) (`partition._bucket_key_sort`: K1's
   composites, K3's packed codes or the stable chain), or, where the
   session hands it a device mesh, the all-to-all exchange whose shards
   sort their rows by the same routes (`parallel.table_ops`, mode "mesh",
   sort route "exchange");
3. gather the sorted table on the session's device, once;
4. bring it to the host in bucket-aligned ranges (`copy_ranges`): on a CUDA
   session one pinned buffer per column is allocated and every range's
   copy is queued at once on a side stream, each marked by an event, so the
   copy engine fills the next range while the host writes this one; on a
   CPU session a range is a view of the sorted table;
5. as each range lands, `_BucketWriter.prepare` builds one arrow array per
   column of it, once: the values with their null mask, a string column's
   decoded values, or under `HYPERSPACE_ENCODED_EXEC` its int32 codes;
6. the range's non-empty buckets go to the writer pool
   (`HYPERSPACE_BUILD_WRITERS` threads), each bucket a zero-copy slice of
   those arrays (an encoded string column compacted to the bucket's own
   dictionary) written through `io.checked_write_table` (pyarrow encodes
   in C++, so the files are written at once), while the calling thread
   waits on the next range.

The files are byte-identical to `io.write_parquet` of each bucket's rows,
which is what both of the JAX package's routes write. The first failure of a
copy, a prepare or a write cancels the writes not begun, waits for those
running, and is raised; the caller's staging directory then goes with it.

Not ported from the JAX module, by design: its pow2 chunks and the staging
of chunks on the device while decoding (`_effective_chunk_rows` :143,
`_split_chunks` :152, `_stage_chunk_device` :467) bound the shapes that XLA
compiles, and torch compiles no shapes; the port's `io.read_files` already
decodes on its pool and copies the batch to the device once. The JAX
package's mesh build takes its serial route; here it is this route's sort
stage, so both write through one bucket writer.
"""

from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import FIRST_EXCEPTION, Future, ThreadPoolExecutor, wait
from typing import Callable, Dict, List, Tuple

import numpy as np
import pyarrow as pa
import torch

from ..engine import encoding as _encoding
from ..engine import io as engine_io
from ..engine.table import Table
from ..ops.hashing import bucket_id
from ..ops.partition import _bucket_key_sort, bucket_starts
from ..telemetry.profiling import StageTimings, record_build_stages

#: The fewest rows a copy range holds, so that a small build is not cut
#: into ranges of a few rows, each with its own events and arrow arrays.
RANGE_MIN_ROWS = 2048


def copy_ranges(starts: np.ndarray, writers: int) -> List[Tuple[int, int]]:
    """Bucket ranges [b_lo, b_hi) of about equal rows, cut at bucket starts
    (`starts`, length buckets + 1): two for each writer, so that the pool
    has a range's buckets to write while the next range lands, and fewer
    where a range would hold under `RANGE_MIN_ROWS` rows."""
    n = int(starts[-1])
    k = max(1, min(2 * writers, n // RANGE_MIN_ROWS))
    cuts = np.searchsorted(starts, np.arange(1, k) * (n / k))
    bounds = np.unique(np.concatenate([[0], cuts, [len(starts) - 1]]).astype(np.int64))
    return list(zip(bounds[:-1].tolist(), bounds[1:].tolist()))


def _pinned(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


class _HostCopy:
    """The sorted table on the host, range by range. On a CUDA session one
    pinned buffer per column (and per validity mask) is allocated, and
    every range's copies are queued at once on a side stream, each range
    between two timing events, so the copy engine fills range r + 1 while
    the host writes range r; `land(r)` waits for range r alone. On the CPU
    a range is a view of the sorted table."""

    def __init__(self, sorted_t: Table, rows: List[Tuple[int, int]], device: torch.device):
        self.sorted_t, self.rows = sorted_t, rows
        self.stream = None
        if device.type != "cuda":
            return
        self.host = {n: (c, _pinned(c.data), None if c.validity is None else _pinned(c.validity))
                     for n, c in sorted_t.columns.items()}
        pairs = [(c.data, d) for c, d, _ in self.host.values()]
        pairs += [(c.validity, v) for c, _, v in self.host.values() if v is not None]
        self.stream = torch.cuda.Stream(device)
        self.stream.wait_stream(torch.cuda.current_stream(device))  # the gather first
        self.events = []
        with torch.cuda.stream(self.stream):
            for lo, hi in rows:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record(self.stream)
                for src, dst in pairs:
                    dst[lo:hi].copy_(src[lo:hi], non_blocking=True)
                end.record(self.stream)
                self.events.append((start, end))

    def land(self, r: int) -> Tuple[Table, float]:
        """Range r on the host once its copy has landed, and the copy's
        seconds on the card (0 for a view)."""
        lo, hi = self.rows[r]
        if self.stream is None:
            return self.sorted_t.slice(lo, hi), 0.0
        start, end = self.events[r]
        end.synchronize()
        table = Table({n: dataclasses.replace(c, data=d[lo:hi], validity=None if v is None else v[lo:hi])
                       for n, (c, d, v) in self.host.items()})
        return table, start.elapsed_time(end) / 1000.0

    def close(self) -> None:
        """Wait for every queued copy: none may run once its buffers go."""
        if self.stream is not None:
            self.stream.synchronize()


class _BucketWriter:
    """The writer pool's stage: `prepare` makes one arrow array per column
    of a host range, once (the arrays `io.table_to_arrow` makes of a bucket,
    over the whole range); `write_bucket` writes one bucket's zero-copy
    slices. Under encoded execution a string column is kept as its codes
    and null mask, and each bucket compacts its own dictionary through
    `encoding.dictionary_arrow_array`, as the per-bucket writer does."""

    def __init__(self, table: Table, index_data_path: str, stages: StageTimings):
        encode = _encoding.encoded_exec_enabled()
        self.dicts = {n: c.dictionary for n, c in table.columns.items() if encode and c.is_string}
        self.path = index_data_path
        self.stages = stages
        self.row_group_rows = engine_io.index_row_group_rows()

    def prepare(self, host: Table) -> Dict[str, object]:
        with self.stages.timed("concat", sync=False):
            arrays: Dict[str, object] = {}
            for name, col in host.columns.items():
                data = col.data.numpy()
                mask = None if col.validity is None else ~col.validity.numpy()
                if name in self.dicts:
                    arrays[name] = (data, mask)
                else:
                    arrays[name] = pa.array(col.dictionary[data] if col.is_string else data, mask=mask)
            return arrays

    def _bucket_array(self, name: str, array, lo: int, hi: int):
        if name not in self.dicts:
            return array.slice(lo, hi - lo)
        codes, mask = array
        return _encoding.dictionary_arrow_array(codes[lo:hi], self.dicts[name], None if mask is None else mask[lo:hi])

    def write_bucket(self, arrays: Dict[str, object], b: int, lo: int, hi: int) -> None:
        """Bucket `b`: rows [lo, hi) of the range whose `arrays` these are."""
        with self.stages.timed("write", sync=False):
            at = pa.table({n: self._bucket_array(n, a, lo, hi) for n, a in arrays.items()})
            engine_io.checked_write_table(at, os.path.join(self.path, f"part-{b:05d}.parquet"), self.row_group_rows)


def _write_ranges(host: _HostCopy, ranges: List[Tuple[int, int]], starts: np.ndarray, writer: _BucketWriter,
                  writers: int, stages: StageTimings) -> float:
    """Land, prepare and write every range of buckets; the writes' wall.
    The calling thread lands each range and submits its buckets to the
    writer pool, so the pool writes range r while range r + 1 lands."""
    futures: List[Future] = []
    t_first = None
    try:
        with ThreadPoolExecutor(max_workers=writers, thread_name_prefix="hs-build-write") as pool:
            try:
                for r, (b_lo, b_hi) in enumerate(ranges):
                    table, copy_s = host.land(r)
                    if host.stream is not None:
                        stages.add("take", copy_s)
                    arrays = writer.prepare(table)
                    base = int(starts[b_lo])
                    for b in range(b_lo, b_hi):
                        lo, hi = int(starts[b]) - base, int(starts[b + 1]) - base
                        if hi > lo:  # an empty bucket writes no file
                            t_first = time.monotonic() if t_first is None else t_first
                            futures.append(pool.submit(writer.write_bucket, arrays, b, lo, hi))
                done, _ = wait(futures, return_when=FIRST_EXCEPTION)
                for f in done:
                    f.result()
            except BaseException:
                for f in futures:
                    f.cancel()
                raise
    finally:
        host.close()
    return 0.0 if t_first is None else time.monotonic() - t_first


def pipelined_write(decode: Callable[[], Table], key_names: List[str], num_buckets: int, index_data_path: str,
                    device: torch.device, writers: int, n_files: int, mesh_for=None) -> dict:
    """Decode, sort, gather, copy and write one build's bucket files into
    `index_data_path`; record and return its stage summary
    (`profiling.last_build_stages()`). `mesh_for(rows)`, where given, may
    hand the sort stage a device mesh: the rows then ride its all-to-all
    exchange (`parallel.table_ops`, mode "mesh"), and the same gather,
    ranges and writers follow."""
    stages = StageTimings(mode="pipelined-device" if device.type == "cuda" else "pipelined-cpu", device=device)
    with stages.timed("decode"):
        table = decode()
    mesh = mesh_for(table.num_rows) if mesh_for is not None else None
    if mesh is not None:
        stages.mode = "mesh"
    with stages.timed("sort"):
        if mesh is not None:
            from ..parallel.table_ops import distributed_bucketize_perm

            perm, starts = distributed_bucketize_perm(mesh, table, key_names, num_buckets)
            route = "exchange"
        else:
            cols = [table.column(c) for c in key_names]
            perm, sorted_b, route = _bucket_key_sort(bucket_id(cols, num_buckets), cols, num_buckets)
            starts = bucket_starts(sorted_b, num_buckets)
    with stages.timed("take"):
        sorted_t = table.take(perm.long())
    ranges = copy_ranges(starts, writers)
    with stages.timed("take", sync=False):  # the pinned allocation; the copies are queued
        host = _HostCopy(sorted_t, [(int(starts[lo]), int(starts[hi])) for lo, hi in ranges], device)
    os.makedirs(index_data_path, exist_ok=True)
    writer = _BucketWriter(table, index_data_path, stages)
    write_wall = _write_ranges(host, ranges, starts, writer, writers, stages)
    summary = stages.summary()
    summary.update({"write_wall_s": round(write_wall, 4), "rows": table.num_rows, "files": n_files,
                    "decode_threads": engine_io.decode_pool_size(n_files), "writers": writers,
                    "ranges": len(ranges), "sort_route": route})
    record_build_stages(summary)
    return summary

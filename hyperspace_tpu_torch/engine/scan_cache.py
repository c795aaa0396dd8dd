"""Scan caches: decoded columns per file, and whole scans per file inventory.

Counterpart of `hyperspace_tpu/engine/scan_cache.py`. Decoding parquet and
converting dictionaries is the expensive part of a scan, so decoded columns
are kept per file, keyed by (path, size, mtime): any rewrite of the file
changes its size or mtime and misses every entry it had.

**The cached tables sit on the device.** The JAX package caches host numpy
columns here and keeps a second memo of their device uploads
(`engine/device_cache.py`). The port's tables live on the session's device
from the read on, so one cache covers both and no upload memo exists: an
entry holds the device tensors themselves, and its charge is their bytes
(data and validity) plus the host dictionary of a string column. A cached
tensor is shared by every query that hits it: no operator writes into a
tensor it did not allocate.

- `ScanCache` (one per process, `global_scan_cache`): column-granular
  entries under a file's (path, size, mtime) base; ("col", name, device) for
  a whole-file decode, ("col", name, device, sel) for a decode of the row
  groups `sel` (the pushdown's pruned reads, never aliasing the whole-file
  entry),
  ("names",) for the file's column order and ("meta",) for its footer. LRU
  eviction under `HYPERSPACE_SCAN_CACHE_BUDGET` (1 GiB).
- `BucketedConcatCache`: a whole scan (one table, and bucket starts for a
  bucketed index scan) keyed by its file inventory and columns. Three
  instances with a budget of 1 GiB each: bucketed index scans, plain
  multi-file scans, and filtered bucketed scans, so that neither plain scans
  nor filters with changing literals evict the join's entries.

Hits, misses, evictions and bytes are kept per instance (`stats()`) and, for
the four process-wide caches, mirrored into the metrics registry under the
JAX package's names (`cache.scan.*`, `cache.bucketed_concat.*`,
`cache.concat.*`, `cache.filtered.*`). The bytes an insert charges and an
eviction frees go to the query's ledger (`cache_bytes_charged`,
`cache_bytes_evicted`).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import List, Optional, Tuple

from ..config import CONCAT_CACHE_BUDGET_DEFAULT, ENV_SCAN_CACHE_BUDGET, SCAN_CACHE_BUDGET_DEFAULT, env_bytes
from ..telemetry import accounting as _accounting
from ..telemetry import metrics as _metrics
from .encoding import column_nbytes
from .table import Column, Table


def table_nbytes(t: Table) -> int:
    return sum(column_nbytes(c) for c in t.columns.values())


def file_base(path: str):
    """The freshness base of one file's entries, or None if it cannot be
    stat'ed."""
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (path, st.st_size, int(st.st_mtime * 1000))


class _LruBytes:
    """An LRU map whose entries end with their byte charge."""

    def __init__(self, capacity_bytes: int, name: Optional[str] = None):
        self._capacity = int(capacity_bytes)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # Only a named (process-wide) cache reports to the registry; an
        # instance a test makes gets private metric objects.
        make_c, make_g = (_metrics.counter, _metrics.gauge) if name else (_metrics.Counter, _metrics.Gauge)
        self._m_hits = make_c(f"cache.{name}.hits")
        self._m_misses = make_c(f"cache.{name}.misses")
        self._m_evictions = make_c(f"cache.{name}.evictions")
        self._m_bytes = make_g(f"cache.{name}.bytes")

    def _count_get(self, hit: bool, n: int = 1) -> None:
        if hit:
            self.hits += n
            self._m_hits.inc(n)
        else:
            self.misses += n
            self._m_misses.inc(n)

    def stats(self) -> dict:
        return {
            "hits": self.hits, "misses": self.misses, "evictions": self.evictions,
            "entries": len(self._entries), "bytes": self._bytes, "budget": self._capacity,
        }

    def _evict_to_capacity_locked(self) -> None:
        evicted = 0
        while self._bytes > self._capacity and self._entries:
            _, ent = self._entries.popitem(last=False)
            self._bytes -= ent[-1]
            evicted += ent[-1]
            self.evictions += 1
            self._m_evictions.inc()
        if evicted:
            _accounting.add("cache_bytes_evicted", evicted)
        self._m_bytes.set(self._bytes)

    def _insert_locked(self, key, ent: tuple) -> None:
        self._entries[key] = ent
        self._bytes += ent[-1]
        if ent[-1]:
            _accounting.add("cache_bytes_charged", ent[-1])
        self._evict_to_capacity_locked()

    def set_capacity(self, capacity_bytes: int) -> None:
        with self._lock:
            self._capacity = int(capacity_bytes)
            self._evict_to_capacity_locked()

    def clear(self) -> None:
        """Drop every entry; the counters keep counting."""
        with self._lock:
            self._entries.clear()
            self._bytes = 0
            self._m_bytes.set(0)


class ScanCache(_LruBytes):
    """Per-column store behind a table-level get/put API. A get that
    assembles a table from its columns counts one hit."""

    def __init__(self, capacity_bytes: Optional[int] = None, name: Optional[str] = None):
        if capacity_bytes is None:
            capacity_bytes = env_bytes(ENV_SCAN_CACHE_BUDGET, SCAN_CACHE_BUDGET_DEFAULT)
        super().__init__(capacity_bytes, name)

    def stats(self) -> dict:
        """The LRU's counters, and `columns`: the entries that hold decoded
        columns (on their device), footers and name lists left out."""
        out = super().stats()
        with self._lock:
            out["columns"] = sum(1 for k in self._entries if k[-1][0] == "col")
        return out

    @staticmethod
    def _col_key(n: str, sel, device) -> tuple:
        """A column entry's kind: a whole-file decode, or one of the row
        groups `sel`, on one device."""
        return ("col", n, str(device)) if sel is None else ("col", n, str(device), tuple(sel))

    def _names_for_locked(self, base, columns: Optional[List[str]]):
        if columns is not None:
            return list(columns)
        ent = self._entries.get(base + (("names",),))
        if ent is None:
            return None
        self._entries.move_to_end(base + (("names",),))
        return list(ent[0])

    def get(
        self, path: str, columns: Optional[List[str]], record: bool = True, sel=None, device="cpu", base=None
    ) -> Optional[Table]:
        """The requested table on `device` assembled from cached columns, or
        None. `record=False` counts nothing (a re-read inside one request);
        `sel` reads the row-group-selection entries instead of the whole-file
        ones. `base` is the file's `file_base` when the caller has it (each
        method stats the file otherwise)."""
        base = base or file_base(path)
        if base is None:
            return None
        with self._lock:
            names = self._names_for_locked(base, columns)
            cols = None
            if names is not None:
                cols = {}
                for n in names:
                    ent = self._entries.get(base + (self._col_key(n, sel, device),))
                    if ent is None:
                        cols = None
                        break
                    cols[n] = ent[0]
            if cols is None:
                self._count_get(False, int(record))
                return None
            for n in names:
                self._entries.move_to_end(base + (self._col_key(n, sel, device),))
            self._count_get(True, int(record))
            return Table(cols)

    def missing_columns(
        self, path: str, columns: Optional[List[str]], sel=None, device="cpu", base=None
    ) -> Optional[List[str]]:
        """The requested columns not cached for this file; None = cannot tell
        (unknown names for columns=None, or the file cannot be stat'ed)."""
        base = base or file_base(path)
        if base is None:
            return None
        with self._lock:
            names = self._names_for_locked(base, columns)
            if names is None:
                return None
            return [n for n in names if base + (self._col_key(n, sel, device),) not in self._entries]

    def put(self, path: str, columns: Optional[List[str]], table: Table, sel=None, device="cpu", base=None) -> None:
        base = base or file_base(path)
        if base is None:
            return
        with self._lock:
            if columns is None and sel is None:
                key = base + (("names",),)
                if key not in self._entries:
                    self._insert_locked(key, (list(table.column_names), 0))
            for n, c in table.columns.items():
                key = base + (self._col_key(n, sel, device),)
                size = column_nbytes(c)
                if key in self._entries or size > self._capacity:
                    continue
                self._insert_locked(key, (c, size))

    def get_meta(self, path: str, base=None):
        """A file's cached footer metadata, or None (counted by the caller)."""
        base = base or file_base(path)
        if base is None:
            return None
        with self._lock:
            ent = self._entries.get(base + (("meta",),))
            if ent is None:
                return None
            self._entries.move_to_end(base + (("meta",),))
            return ent[0]

    def put_meta(self, path: str, meta, nbytes: int, base=None) -> None:
        base = base or file_base(path)
        if base is None:
            return
        with self._lock:
            key = base + (("meta",),)
            if key not in self._entries and nbytes <= self._capacity:
                self._insert_locked(key, (meta, int(nbytes)))


class BucketedConcatCache(_LruBytes):
    """Whole scans: (table, starts) under a key that holds the scan's file
    inventory, so any rewrite of one of its files changes the key."""

    def __init__(self, capacity_bytes: int = CONCAT_CACHE_BUDGET_DEFAULT, name: Optional[str] = None):
        super().__init__(capacity_bytes, name)

    def get(self, key) -> Optional[Tuple[Table, object]]:
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                self._count_get(False)
                return None
            self._entries.move_to_end(key)
            self._count_get(True)
            return hit[0], hit[1]

    def contains(self, key) -> bool:
        """A peek that counts nothing and touches no recency."""
        with self._lock:
            return key in self._entries

    def put(self, key, table: Table, starts) -> None:
        size = table_nbytes(table)
        with self._lock:
            if key not in self._entries and size <= self._capacity:
                self._insert_locked(key, (table, starts, size))


_GLOBAL = ScanCache(name="scan")
_BUCKETED = BucketedConcatCache(name="bucketed_concat")
_CONCAT = BucketedConcatCache(name="concat")
_FILTERED = BucketedConcatCache(name="filtered")


def global_scan_cache() -> ScanCache:
    return _GLOBAL


def global_bucketed_cache() -> BucketedConcatCache:
    return _BUCKETED


def global_concat_cache() -> BucketedConcatCache:
    return _CONCAT


def global_filtered_cache() -> BucketedConcatCache:
    return _FILTERED


def clear_scan_caches() -> None:
    """Empty the four caches (a cold-scan measurement); counters keep counting."""
    for c in (_GLOBAL, _BUCKETED, _CONCAT, _FILTERED):
        c.clear()


def stats() -> dict:
    """Hits, misses, evictions, entries and bytes of each cache."""
    return {
        "scan": _GLOBAL.stats(), "bucketed_concat": _BUCKETED.stats(),
        "concat": _CONCAT.stats(), "filtered": _FILTERED.stats(),
    }

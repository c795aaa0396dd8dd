"""OptimizeAction: compact an index's per-bucket files; ACTIVE → OPTIMIZING → ACTIVE.

Counterpart of `hyperspace_tpu/actions/optimize.py`. Incremental refreshes
spread a bucket over one file per version directory; optimize merges each
bucket's files into one `part-<bucket>.parquet` of a new version directory,
re-sorted within the bucket as the build sorts it, so the compacted files
equal a from-scratch rebuild's byte for byte. Mode "quick" merges the files
below `hyperspace.index.optimize.fileSizeThreshold` (256 MB), "full" every
file. An entry with folded deletes has every part file rewritten without the
deleted files' rows, and its `deletedSourceFiles` set is cleared.

Each bucket's write checks the query deadline; the window after every
compacted bucket is staged and before the rename publishes them is the
`compact.commit` fault point; then the compacted generation is decoded into
the scan cache (`refresh._warm_handoff`) before the log commit.
"""

from __future__ import annotations

import copy
import os
import re
from collections import Counter, defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resilience
from ..config import (
    COMPACT_TRIGGER_FILES_DEFAULT,
    ENV_COMPACT_TRIGGER_FILES,
    IndexConstants,
)
from ..engine import io as engine_io
from ..engine.schema import Schema
from ..engine.table import Table
from ..exceptions import HyperspaceException
from ..index.log_entry import DELETED_SOURCE_FILES_KEY, Content, FileInfo, IndexLogEntry, LogEntry
from ..index.builder import build_writers
from ..index.staging import stage_commit
from ..ops.partition import bucket_starts, sort_perm
from ..telemetry import faults as _faults
from ..telemetry.events import OptimizeActionEvent
from . import states
from .action import Action, _recover_stable

# The quick mode's size threshold, under the JAX package's module names
# (`actions/optimize.py:25-26`); the port keeps them on `IndexConstants`.
OPTIMIZE_FILE_SIZE_THRESHOLD = IndexConstants.OPTIMIZE_FILE_SIZE_THRESHOLD
OPTIMIZE_FILE_SIZE_THRESHOLD_DEFAULT = IndexConstants.OPTIMIZE_FILE_SIZE_THRESHOLD_DEFAULT
OPTIMIZE_MODES = ("quick", "full")

_BUCKET_RE = re.compile(r"part-(\d+)")
_VERSION_RE = re.compile(r"v__=(\d+)")


def _compact_trigger_files() -> int:
    try:
        return max(2, int(os.environ.get(ENV_COMPACT_TRIGGER_FILES, "") or COMPACT_TRIGGER_FILES_DEFAULT))
    except ValueError:
        return COMPACT_TRIGGER_FILES_DEFAULT


def _version_rank(path: str) -> int:
    """The numeric `v__=N` version of an index file path (-1 without one).
    String order would put v__=10 before v__=2; files merge in numeric
    version order so that the merged rows keep a rebuild's order."""
    m = _VERSION_RE.search(path)
    return int(m.group(1)) if m else -1


def needs_compaction(entry: IndexLogEntry) -> bool:
    """Whether compaction should run on `entry` (`optimize.needs_compaction`
    :60): it carries folded deletes, or incremental refreshes spread some
    bucket over at least `HYPERSPACE_COMPACT_TRIGGER_FILES` (2) files."""
    if entry.kind != "CoveringIndex":
        return False
    if entry.deleted_source_files():
        return True
    per_bucket = Counter()
    for f in entry.content.file_infos():
        m = _BUCKET_RE.search(os.path.basename(f.name))
        if m is not None:
            per_bucket[int(m.group(1))] += 1
    return bool(per_bucket) and max(per_bucket.values()) >= _compact_trigger_files()


class OptimizeAction(Action):
    event_class = OptimizeActionEvent

    def __init__(self, session, log_manager, index_data_path: str, mode: str = "quick"):
        super().__init__(log_manager)
        if mode not in OPTIMIZE_MODES:
            raise HyperspaceException(f"Unsupported optimize mode '{mode}'; supported: {OPTIMIZE_MODES}.")
        self._session = session
        self._index_data_path = index_data_path
        self._mode = mode
        self._prev: Optional[IndexLogEntry] = None

    @property
    def transient_state(self) -> str:
        return states.OPTIMIZING

    @property
    def final_state(self) -> str:
        return states.ACTIVE

    def _previous_entry(self) -> IndexLogEntry:
        if self._prev is None:
            prev = self._log_manager.get_log(self.base_id)
            if prev is None:
                raise HyperspaceException("Optimize is only supported on an existing index.")
            if prev.state in states.TRANSIENT_STATES:
                # A dead writer's orphan: optimize judges the latest stable
                # entry; the log's compare-and-set arbitrates a live race.
                prev = _recover_stable(self._log_manager, prev)
            self._prev = prev
        return self._prev

    def _partition_files(self) -> Tuple[Dict[int, List[FileInfo]], List[FileInfo]]:
        """(files to merge per bucket, files left as they are). With folded
        deletes every part file is rewritten, single ones included: the set
        may be cleared only once no file holds a deleted file's rows. Without
        them, a bucket of one file gains nothing and stays."""
        prev = self._previous_entry()
        folding = bool(prev.deleted_source_files())
        threshold = int(self._session.conf.get(
            IndexConstants.OPTIMIZE_FILE_SIZE_THRESHOLD, str(IndexConstants.OPTIMIZE_FILE_SIZE_THRESHOLD_DEFAULT)
        ))
        per_bucket: Dict[int, List[FileInfo]] = defaultdict(list)
        untouched: List[FileInfo] = []
        for f in prev.content.file_infos():
            m = _BUCKET_RE.search(os.path.basename(f.name))
            if m is None:
                untouched.append(f)
            elif folding or self._mode == "full" or f.size < threshold:
                per_bucket[int(m.group(1))].append(f)
            else:
                untouched.append(f)
        if not folding:
            for b in [b for b, fs in per_bucket.items() if len(fs) < 2]:
                untouched.extend(per_bucket.pop(b))
        return per_bucket, untouched

    def validate(self) -> None:
        prev = self._previous_entry()
        if prev.state != states.ACTIVE:
            raise HyperspaceException(f"Optimize is only supported in {states.ACTIVE} state.")
        if prev.kind != "CoveringIndex":
            raise HyperspaceException(
                f"Optimize is only supported for CoveringIndex (got {prev.kind}); "
                "use refresh_index(mode='full') instead."
            )
        per_bucket, _ = self._partition_files()
        if not per_bucket:
            raise HyperspaceException(
                f"Optimize aborted as no optimizable index files found (mode={self._mode})."
            )

    def _lineage_lanes(self, merged: Table) -> Tuple[torch.Tensor, torch.Tensor]:
        """(rows kept, each kept row's source-file rank) of an index with
        lineage: the rows of folded files leave (delete folding's physical
        half; `log_entry` clears the set), and the rank is the row's source
        file's position in the current inventory's path order."""
        prev = self._previous_entry()
        target = IndexConstants.DATA_FILE_NAME_COLUMN.lower()
        col = merged.column(next(n for n in merged.column_names if n.lower() == target))
        codes = col.data.long()
        keep = torch.arange(merged.num_rows, device=codes.device)
        folded = prev.deleted_source_files()
        if folded:
            dropped = torch.as_tensor(np.isin(col.dictionary, sorted(folded)), device=codes.device)
            keep = keep[~dropped[codes]]
        src_rank = {f.name: i for i, f in enumerate(prev.relations[0].data.file_infos())}
        ranks = torch.as_tensor(
            np.array([src_rank.get(v, len(src_rank)) for v in col.dictionary], dtype=np.int64), device=codes.device
        )
        return keep, ranks[codes[keep]]

    def op(self) -> None:
        """Every merged bucket at once: the files concatenated by bucket, then
        numeric version and name; one stable sort by (bucket, indexed
        columns, source-file rank) on the device; one copy to the host; one
        file a bucket. Per bucket that is the JAX package's order (:199-263):
        its rows re-rank stably by source file (with lineage) and then sort
        stably by the key, so equal keys land in (source file rank, row in
        file) order, as a rebuild reads the source files in path order.
        Without lineage the version order stands, which equals a rebuild's
        whenever appended files sort after the earlier ones."""
        prev = self._previous_entry()
        per_bucket, _ = self._partition_files()
        # The index schema's explicit column list: a bare read of a file
        # under `v__=N` would add a hive-style `v__` column to the output.
        index_cols = list(Schema.from_json_string(prev.schema_json).names)
        files = [
            (b, f.name) for b, fs in sorted(per_bucket.items())
            for f in sorted(fs, key=lambda f: (_version_rank(f.name), os.path.basename(f.name)))
        ]
        device = self._session.device
        tables = engine_io.decode_files([(p, index_cols, None, None) for _, p in files], device)
        merged = engine_io.concat_tables(tables)
        bucket = torch.repeat_interleave(
            torch.as_tensor([b for b, _ in files], dtype=torch.int32, device=device),
            torch.as_tensor([t.num_rows for t in tables], device=device), output_size=merged.num_rows,
        )
        lanes = [merged.column(c).data for c in prev.indexed_columns]
        if prev.has_lineage():
            keep, rank = self._lineage_lanes(merged)
            merged, bucket = merged.take(keep), bucket[keep]
            lanes = [lane[keep] for lane in lanes] + [rank]
        perm = sort_perm(bucket, lanes)
        starts = bucket_starts(bucket[perm], prev.num_buckets)
        host = merged.take(perm).to("cpu")
        sc = resilience.current_scope()
        with stage_commit(self._index_data_path) as stage:
            os.makedirs(stage, exist_ok=True)

            def write(b: int) -> None:
                with resilience.use_scope(sc):
                    resilience.check_deadline("optimize.bucket")
                    lo, hi = int(starts[b]), int(starts[b + 1])
                    if hi <= lo:
                        return  # every row deleted: no file, as the build writes none
                    engine_io.write_parquet(
                        host.slice(lo, hi), os.path.join(stage, f"part-{b:05d}.parquet"),
                        row_group_rows=engine_io.index_row_group_rows(),
                    )

            # Parquet encode releases the GIL: the files are written concurrently.
            with ThreadPoolExecutor(max_workers=build_writers()) as pool:
                list(pool.map(write, sorted(per_bucket)))
            # The compaction commit window: every bucket is staged, the rename
            # has not happened. A fault here deletes the staging directory.
            _faults.check("compact.commit")
        from .refresh import _warm_handoff

        _warm_handoff(self._index_data_path, prev.schema_json, device)

    def log_entry(self) -> LogEntry:
        prev = self._previous_entry()
        entry = copy.deepcopy(prev)
        _, untouched = self._partition_files()
        merged_content = Content.from_directory(self._index_data_path, self._session.fs)
        entry.content = Content.merge([Content.from_file_infos(untouched), merged_content])
        if prev.deleted_source_files():
            entry.extra.pop(DELETED_SOURCE_FILES_KEY, None)
        return entry

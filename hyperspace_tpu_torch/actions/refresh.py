"""Refresh: ACTIVE → REFRESHING → ACTIVE.

Counterpart of `hyperspace_tpu/actions/refresh.py` (reference
`actions/RefreshAction.scala:31-86`). `RefreshAction` rebuilds the index
from the source its log entry records, into the next version directory.
`RefreshIncrementalAction` indexes only the source files appended since the
recorded inventory and folds the deleted ones through the lineage column:
their paths join the entry's `deletedSourceFiles` and readers prune their
rows at scan time, so a refresh that only sees deletes writes no data. The
JAX package's warm handoff into the scan cache and its `refresh.merge` fault
point are not ported.
"""

from __future__ import annotations

from typing import Optional

from ..exceptions import HyperspaceException
from ..index.log_entry import DELETED_SOURCE_FILES_KEY, Content, IndexLogEntry, LogEntry
from . import states
from .action import Action, _recover_stable
from .create import IndexerBuilder


class NothingToRefreshError(HyperspaceException):
    """An incremental refresh found no appended or deleted source file: the
    index already covers the source. Typed, so that mode "auto" can do
    nothing on it."""


class RefreshAction(Action):
    def __init__(self, builder: IndexerBuilder, log_manager, index_path: str, index_data_path: str):
        super().__init__(log_manager)
        self._builder = builder
        self._index_path = index_path
        self._index_data_path = index_data_path
        self._prev: Optional[IndexLogEntry] = None
        self._df = None

    def _previous_entry(self) -> IndexLogEntry:
        if self._prev is None:
            prev = self._log_manager.get_log(self.base_id)
            if prev is None:
                raise HyperspaceException("Refresh is only supported on an existing index.")
            if prev.state in states.TRANSIENT_STATES:
                # A dead writer's orphan: refresh judges the latest stable
                # entry; the log's compare-and-set arbitrates a live race.
                prev = _recover_stable(self._log_manager, prev)
            self._prev = prev
        return self._prev

    def _source_df(self):
        if self._df is None:
            relations = self._previous_entry().relations
            if len(relations) != 1:
                raise HyperspaceException("Refresh supports indexes over a single relation.")
            self._df = self._builder.reconstruct_df(relations[0])
        return self._df

    @property
    def transient_state(self) -> str:
        return states.REFRESHING

    @property
    def final_state(self) -> str:
        return states.ACTIVE

    def validate(self) -> None:
        prev = self._previous_entry()
        if prev.state != states.ACTIVE:
            raise HyperspaceException(
                f"Refresh is only supported in {states.ACTIVE} state. Current state: {prev.state}."
            )

    def op(self) -> None:
        config = self._builder.config_from_entry(self._previous_entry())
        self._builder.write(self._source_df(), config, self._index_data_path)

    def log_entry(self) -> LogEntry:
        # Derived fresh per phase: the end() entry inventories what op() wrote.
        config = self._builder.config_from_entry(self._previous_entry())
        return self._builder.derive_log_entry(self._source_df(), config, self._index_path, self._index_data_path)


class RefreshIncrementalAction(RefreshAction):
    """mode="incremental": index only the source files appended since the
    recorded inventory, into a new version directory; the new entry's content
    spans every version directory (the previous content, then the new one)
    and its signature covers the current source. Deleted source files fold
    through lineage when the index has the `_data_file_name` column; without
    it deletes are refused. A file modified in place is always refused: its
    old rows share its path, so lineage cannot separate them."""

    def _diff_files(self):
        """(appended FileStatus list, deleted paths, modified paths) between
        the recorded source inventory and the current one."""
        prev = self._previous_entry()
        recorded = {(f.name, f.size, f.modified_time) for f in prev.relations[0].data.file_infos()}
        recorded_paths = {p for p, _, _ in recorded}
        current_files = self._source_df().plan.relation.files
        current_paths = {f.path for f in current_files}
        deleted = sorted(recorded_paths - current_paths)
        modified = sorted(
            f.path for f in current_files
            if f.path in recorded_paths and (f.path, f.size, f.modified_time) not in recorded
        )
        appended = [f for f in current_files if f.path not in recorded_paths]
        return appended, deleted, modified

    def validate(self) -> None:
        super().validate()
        prev = self._previous_entry()
        if not prev.relations[0].data.file_infos():
            # Nothing to diff against: every current file would look appended.
            raise HyperspaceException(
                "Incremental refresh requires per-file source signatures in "
                "the previous log entry, but it records no file inventory; "
                "use mode='full' to rebuild."
            )
        appended, deleted, modified = self._diff_files()
        # A folded path that re-appears is modified in place in disguise: the
        # index still holds its old rows under the same path.
        reappeared = sorted({f.path for f in appended} & set(prev.deleted_source_files()))
        if modified or reappeared:
            raise HyperspaceException(
                "Incremental refresh does not support source files modified "
                f"in place (modified: {(modified + reappeared)[:3]}); use mode='full'."
            )
        if deleted and not prev.has_lineage():
            raise HyperspaceException(
                "Incremental refresh found deleted source files "
                f"(deleted: {deleted[:3]}) but the index records no lineage "
                "column to fold them through; enable "
                "hyperspace.index.lineage.enabled at build time or use mode='full'."
            )
        if not appended and not deleted:
            raise NothingToRefreshError("Refresh incremental aborted as no appended source data files found.")

    def op(self) -> None:
        appended, _, _ = self._diff_files()
        if appended:
            config = self._builder.config_from_entry(self._previous_entry())
            sub_df = self._builder.restrict_df_to_files(self._source_df(), [f.path for f in appended])
            self._builder.write(sub_df, config, self._index_data_path)

    def log_entry(self) -> LogEntry:
        entry = super().log_entry()  # content = the new version directory only
        prev = self._previous_entry()
        entry.content = Content.merge([prev.content, entry.content])
        _, deleted, _ = self._diff_files()
        # validate() refuses re-appeared paths, so the set only grows until a
        # full rewrite clears it.
        carried = sorted(set(prev.deleted_source_files()) | set(deleted))
        if carried:
            entry.extra[DELETED_SOURCE_FILES_KEY] = carried
        return entry

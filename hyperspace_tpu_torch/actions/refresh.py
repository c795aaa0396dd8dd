"""Refresh: ACTIVE → REFRESHING → ACTIVE.

Counterpart of `hyperspace_tpu/actions/refresh.py` (reference
`actions/RefreshAction.scala:31-86`). `RefreshAction` rebuilds the index
from the source its log entry records, into the next version directory.
`RefreshIncrementalAction` indexes only the source files appended since the
recorded inventory and folds the deleted ones through the lineage column:
their paths join the entry's `deletedSourceFiles` and readers prune their
rows at scan time, so a refresh that only sees deletes writes no data.

The warm handoff (`_warm_handoff`): after an action committed its data
directory and before its log entry moves readers onto it, the new files are
decoded into the scan cache on the session's device, so the first query of
the new generation hits the cache (and the planner sees warm footers).
`HYPERSPACE_REFRESH_WARM_HANDOFF=0` turns it off. The incremental refresh's
merge window, between its data commit and its log commit, is the
`refresh.merge` fault point.
"""

from __future__ import annotations

import os
from typing import Optional

from ..exceptions import HyperspaceException
from ..index.log_entry import DELETED_SOURCE_FILES_KEY, Content, IndexLogEntry, LogEntry
from ..telemetry import faults as _faults
from ..telemetry.events import RefreshActionEvent
from . import states
from .action import Action, _recover_stable
from .create import IndexerBuilder


ENV_REFRESH_WARM_HANDOFF = "HYPERSPACE_REFRESH_WARM_HANDOFF"


def _warm_handoff(index_data_path: str, schema_json: str, device) -> None:
    """Decode a freshly committed version directory's parquet files, in the
    index schema's columns, into the scan cache on `device` (`refresh.py`
    :40). Best effort: the data and log commits are already right, so a
    failure here never fails the action."""
    if os.environ.get(ENV_REFRESH_WARM_HANDOFF, "1") == "0":
        return
    try:
        from ..engine import io as engine_io
        from ..engine.schema import Schema

        if not os.path.isdir(index_data_path):
            return
        files = sorted(os.path.join(index_data_path, n) for n in os.listdir(index_data_path) if n.endswith(".parquet"))
        if files:
            cols = list(Schema.from_json_string(schema_json).names)
            engine_io.decode_files([(f, cols, None, None) for f in files], device)
    except Exception:
        pass


class NothingToRefreshError(HyperspaceException):
    """An incremental refresh found no appended or deleted source file: the
    index already covers the source. Typed, so that mode "auto" can do
    nothing on it."""


class RefreshAction(Action):
    event_class = RefreshActionEvent

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
        _warm_handoff(self._index_data_path, self._previous_entry().schema_json, self._builder._session.device)

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
            _warm_handoff(self._index_data_path, self._previous_entry().schema_json, self._builder._session.device)
        # The merge window: the delta directory is committed, the merged log
        # entry is not. A transient fault fails the refresh cleanly; a hang
        # is the crash window between the data commit and the log commit.
        _faults.check("refresh.merge")

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

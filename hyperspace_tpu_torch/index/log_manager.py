"""Operation log with optimistic concurrency.

Parity: reference `index/IndexLogManager.scala` — numbered JSON entries under
`<indexRoot>/_hyperspace_log/<id>`; `write_log` refuses existing ids and commits
via temp file + atomic rename (`:146-162`); a `latestStable` pointer copy
(`:113-130`). Counterpart of `hyperspace_tpu/index/log_manager.py`: every
entry and pointer write is the `log.write` fault point under
`resilience.retry_io` (`log_manager.py:121-144`). The entries live on any
`FileSystem` (`index/factories.py` picks it by the index path's scheme).
"""

from __future__ import annotations

import os
from typing import Optional

from .. import resilience as _resilience
from ..actions.states import STABLE_STATES
from ..config import IndexConstants
from ..exceptions import is_transient
from ..storage.filesystem import FileSystem, LocalFileSystem
from ..telemetry import faults as _faults
from ..util import json_utils
from .log_entry import LogEntry

LATEST_STABLE = "latestStable"


class IndexLogManager:
    """The contract (reference `IndexLogManager.scala:33-55`)."""

    def get_log(self, log_id: int) -> Optional[LogEntry]:
        raise NotImplementedError

    def get_latest_id(self) -> Optional[int]:
        raise NotImplementedError

    def get_latest_log(self) -> Optional[LogEntry]:
        latest = self.get_latest_id()
        return self.get_log(latest) if latest is not None else None

    def get_latest_stable_log(self) -> Optional[LogEntry]:
        raise NotImplementedError

    def create_latest_stable_log(self, log_id: int) -> bool:
        raise NotImplementedError

    def delete_latest_stable_log(self) -> bool:
        raise NotImplementedError

    def write_log(self, log_id: int, entry: LogEntry) -> bool:
        raise NotImplementedError


class IndexLogManagerImpl(IndexLogManager):
    def __init__(self, index_path: str, fs: Optional[FileSystem] = None):
        self._index_path = index_path
        self._fs = fs or LocalFileSystem()

    @property
    def _log_dir(self) -> str:
        return os.path.join(self._index_path, IndexConstants.HYPERSPACE_LOG)

    def _path_for(self, log_id) -> str:
        return os.path.join(self._log_dir, str(log_id))

    def _read(self, path: str) -> Optional[LogEntry]:
        if not self._fs.exists(path):
            return None
        return LogEntry.from_json(self._fs.read_text(path))

    def get_log(self, log_id: int) -> Optional[LogEntry]:
        return self._read(self._path_for(log_id))

    def get_latest_id(self) -> Optional[int]:
        if not self._fs.exists(self._log_dir):
            return None
        ids = [int(st.name) for st in self._fs.list_status(self._log_dir) if st.name.isdigit()]
        return max(ids) if ids else None

    def get_latest_stable_log(self) -> Optional[LogEntry]:
        stable = self._read(self._path_for(LATEST_STABLE))
        if stable is not None:
            return stable
        latest = self.get_latest_id()
        if latest is None:
            return None
        for i in range(latest, -1, -1):
            entry = self.get_log(i)
            if entry is not None and entry.state in STABLE_STATES:
                return entry
        return None

    def create_latest_stable_log(self, log_id: int) -> bool:
        entry = self.get_log(log_id)
        if entry is None or entry.state not in STABLE_STATES:
            return False
        # The pointer is an overwritable copy, not an OCC participant.
        path = self._path_for(LATEST_STABLE)
        if self._fs.exists(path):
            self._fs.delete(path)
        return self._atomic_write_with_retry(path, json_utils.to_json(entry.to_json()))

    def _atomic_write_with_retry(self, path: str, text: str) -> bool:
        """The atomic commit under retry: a transient fault raised after our
        own rename landed is recognized by reading the target back, so a
        retry never takes our own write for a lost race. False is a real
        OCC loss, never retried."""

        def attempt() -> bool:
            _faults.check("log.write")
            try:
                return self._fs.atomic_write_text(path, text)
            except BaseException as e:
                if is_transient(e) and self._content_is(path, text):
                    return True
                raise

        return _resilience.retry_io("log.write", attempt)

    def _content_is(self, path: str, text: str) -> bool:
        try:
            return self._fs.exists(path) and self._fs.read_text(path) == text
        except Exception:
            return False

    def delete_latest_stable_log(self) -> bool:
        path = self._path_for(LATEST_STABLE)
        if self._fs.exists(path):
            _resilience.retry_io("log.write", lambda: self._fs.delete(path))
        return True

    def write_log(self, log_id: int, entry: LogEntry) -> bool:
        """OCC point: fails if `log_id` already exists (reference :146-162).
        The entry's id is set only after the commit wins."""
        d = entry.to_json()
        d["id"] = log_id
        ok = self._atomic_write_with_retry(self._path_for(log_id), json_utils.to_json(d))
        if ok:
            entry.id = log_id
        return ok

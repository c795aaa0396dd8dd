"""Index management: create, and list the indexes (counterpart of
`hyperspace_tpu/index/collection_manager.py`, reference
`IndexCollectionManager.scala:26-191`). Refresh, optimize, delete, restore,
vacuum, cancel and the TTL metadata cache are not ported yet."""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..actions import states
from ..actions.create import CreateAction
from .builder import CoveringIndexBuilder
from .data_manager import IndexDataManagerImpl
from .index_config import IndexConfig
from .log_entry import IndexLogEntry
from .log_manager import IndexLogManagerImpl
from .path_resolver import PathResolver


class IndexCollectionManager:
    def __init__(self, session):
        self._session = session
        self._resolver = PathResolver(session.conf, session.fs, warehouse=session.warehouse)

    def create(self, df, index_config: IndexConfig) -> None:
        index_path = self._resolver.get_index_path(index_config.index_name)
        fs = self._session.fs
        log_mgr = IndexLogManagerImpl(index_path, fs)
        data_mgr = IndexDataManagerImpl(index_path, fs)
        latest = data_mgr.get_latest_version_id()
        next_version = 0 if latest is None else latest + 1
        CreateAction(
            df,
            index_config,
            CoveringIndexBuilder(self._session),
            log_mgr,
            index_path,
            data_mgr.get_path(next_version),
        ).run()

    def get_indexes(self, states_filter: Optional[Sequence[str]] = None) -> List[IndexLogEntry]:
        """Latest entry of every index (its latest STABLE one while a writer is
        in flight), filtered by state."""
        system = self._resolver.system_path()
        fs = self._session.fs
        out: List[IndexLogEntry] = []
        if not fs.exists(system):
            return out
        for st in fs.list_status(system):
            if not st.is_dir:
                continue
            log_mgr = IndexLogManagerImpl(st.path, fs)
            entry = log_mgr.get_latest_log()
            if entry is not None and entry.state in states.TRANSIENT_STATES:
                entry = log_mgr.get_latest_stable_log()
            if entry is None:
                continue
            if states_filter is None or entry.state in states_filter:
                out.append(entry)
        return out

"""Index management: create, refresh, optimize, delete, restore, vacuum, cancel, list.

Counterpart of `hyperspace_tpu/index/collection_manager.py` (reference
`IndexCollectionManager.scala:26-191`, `CachingIndexCollectionManager.scala`
and `Cache.scala`). Each action runs on the index's own log and data
managers; resolving an index first reclaims the staging directories of dead
writers. `CachingIndexCollectionManager` keeps the list of log entries for
`hyperspace.index.cache.expiryDurationInSeconds` (300 s) and clears it
before and after every mutation. A data-skipping index
(`index/dataskipping.py`) is created and refreshed by its own builder,
chosen by the config's type and by the log entry's kind. The log and data
managers and their filesystem come from the factories of
`index/factories.py` (the filesystem by the index path's scheme). The JAX package's
event logger, metrics and the replica fleet's cross-process invalidation
are not ported.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

from ..actions import states
from ..actions.create import CreateAction
from ..actions.lifecycle import CancelAction, DeleteAction, RestoreAction, VacuumAction
from ..actions.optimize import OptimizeAction
from ..actions.refresh import NothingToRefreshError, RefreshAction, RefreshIncrementalAction
from ..engine.table import Table
from ..exceptions import HyperspaceException
from ..telemetry.event_logging import EventLoggerFactory
from . import quarantine
from .builder import CoveringIndexBuilder
from .dataskipping import DATA_SKIPPING_KIND, DataSkippingIndexBuilder, DataSkippingIndexConfig
from .factories import FileSystemFactory, IndexDataManagerFactory, IndexLogManagerFactory
from .index_config import IndexConfig
from .log_entry import IndexLogEntry
from .path_resolver import PathResolver
from .staging import reclaim_orphans

REFRESH_MODES = ("full", "incremental", "auto")


class IndexManager:
    """CRUD + listing contract (reference `IndexManager.scala:24-90`)."""

    def create(self, df, index_config: IndexConfig) -> None:
        raise NotImplementedError

    def delete(self, index_name: str) -> None:
        raise NotImplementedError

    def restore(self, index_name: str) -> None:
        raise NotImplementedError

    def vacuum(self, index_name: str) -> None:
        raise NotImplementedError

    def refresh(self, index_name: str, mode: str = "full") -> None:
        raise NotImplementedError

    def optimize(self, index_name: str, mode: str = "quick") -> None:
        raise NotImplementedError

    def cancel(self, index_name: str) -> None:
        raise NotImplementedError

    def indexes(self) -> Table:
        raise NotImplementedError

    def get_indexes(self, states_filter: Optional[Sequence[str]] = None) -> List[IndexLogEntry]:
        raise NotImplementedError


class IndexCollectionManager(IndexManager):
    def __init__(
        self,
        session,
        log_manager_factory: Optional[IndexLogManagerFactory] = None,
        data_manager_factory: Optional[IndexDataManagerFactory] = None,
        fs_factory: Optional[FileSystemFactory] = None,
    ):
        self._session = session
        self._log_factory = log_manager_factory or IndexLogManagerFactory()
        self._data_factory = data_manager_factory or IndexDataManagerFactory()
        self._fs_factory = fs_factory or FileSystemFactory()
        self._resolver = PathResolver(session.conf, session.fs, warehouse=session.warehouse)

    def _managers_for(self, name: str):
        """(log manager, data manager, index path) of `name`, after reclaiming
        its dead writers' staging directories (live writers are pid-checked
        and never touched)."""
        index_path = self._resolver.get_index_path(name)
        reclaim_orphans(index_path)
        fs = self._fs_factory.create(index_path)
        return self._log_factory.create(index_path, fs), self._data_factory.create(index_path, fs), index_path

    def _existing_log_manager(self, name: str):
        """An existing index's managers (reference `withLogManager`,
        `IndexCollectionManager.scala:107-118`)."""
        log_mgr, data_mgr, index_path = self._managers_for(name)
        if log_mgr.get_latest_id() is None:
            raise HyperspaceException(f"Index with name {name} could not be found.")
        return log_mgr, data_mgr, index_path

    def _run(self, action) -> None:
        """Run `action` with the session's event logger
        (`hyperspace.eventLoggerClass`)."""
        action.event_logger = EventLoggerFactory.get_logger(self._session.hs_conf.event_logger_class)
        action.run()

    @staticmethod
    def _next_data_path(data_mgr) -> str:
        latest = data_mgr.get_latest_version_id()
        return data_mgr.get_path(0 if latest is None else latest + 1)

    def _builder_for_config(self, index_config):
        if isinstance(index_config, DataSkippingIndexConfig):
            return DataSkippingIndexBuilder(self._session)
        return CoveringIndexBuilder(self._session)

    def _builder_for_entry(self, entry: Optional[IndexLogEntry]):
        if entry is not None and entry.kind == DATA_SKIPPING_KIND:
            return DataSkippingIndexBuilder(self._session)
        return CoveringIndexBuilder(self._session)

    def create(self, df, index_config: IndexConfig) -> None:
        log_mgr, data_mgr, index_path = self._managers_for(index_config.index_name)
        self._run(CreateAction(
            df, index_config, self._builder_for_config(index_config), log_mgr, index_path,
            self._next_data_path(data_mgr),
        ))
        quarantine.clear(index_config.index_name)  # fresh data supersedes corrupt files

    def refresh(self, index_name: str, mode: str = "full") -> None:
        """mode "full" rebuilds; "incremental" indexes the appended files and
        folds the deleted ones; "auto" goes incremental when its validation
        passes, full on any other refusal, and does nothing when the index
        already covers the source, unless it is quarantined (:138-204)."""
        if mode not in REFRESH_MODES:
            raise HyperspaceException(f"Unsupported refresh mode '{mode}'; supported: full, incremental, auto.")
        log_mgr, data_mgr, index_path = self._existing_log_manager(index_name)
        builder = self._builder_for_entry(log_mgr.get_latest_log())
        data_path = self._next_data_path(data_mgr)

        def make(cls):
            return cls(builder, log_mgr, index_path, data_path)

        action = make(RefreshAction if mode == "full" else RefreshIncrementalAction)
        if mode == "auto":
            # Decided by validate() alone: a failure past begin() propagates
            # and never re-runs as full.
            try:
                action.validate()
            except NothingToRefreshError:
                if not quarantine.is_quarantined(index_name):
                    return
                action = make(RefreshAction)  # the documented remedy of a quarantined index
            except HyperspaceException:
                action = make(RefreshAction)
        self._run(action)
        quarantine.clear(index_name)

    def optimize(self, index_name: str, mode: str = "quick") -> None:
        """Compact the index's per-bucket files into the next version
        directory (:206-225): mode "quick" merges the small files, "full"
        every file."""
        log_mgr, data_mgr, _ = self._existing_log_manager(index_name)
        self._run(OptimizeAction(self._session, log_mgr, self._next_data_path(data_mgr), mode))
        quarantine.clear(index_name)

    def delete(self, index_name: str) -> None:
        log_mgr, _, _ = self._existing_log_manager(index_name)
        self._run(DeleteAction(log_mgr))

    def restore(self, index_name: str) -> None:
        log_mgr, _, _ = self._existing_log_manager(index_name)
        self._run(RestoreAction(log_mgr))

    def vacuum(self, index_name: str) -> None:
        log_mgr, data_mgr, index_path = self._existing_log_manager(index_name)
        self._run(VacuumAction(data_mgr, log_mgr))
        reclaim_orphans(index_path)
        quarantine.clear(index_name)

    def cancel(self, index_name: str) -> None:
        log_mgr, _, _ = self._existing_log_manager(index_name)
        self._run(CancelAction(log_mgr))

    def get_indexes(self, states_filter: Optional[Sequence[str]] = None) -> List[IndexLogEntry]:
        """Latest entry of every index, filtered by state. A transient latest
        entry (a writer in flight, or dead in flight) reads as the latest
        stable one, so readers keep the committed generation; with no stable
        entry (a first create in flight) the index sits out."""
        system = self._resolver.system_path()
        fs = self._session.fs
        out: List[IndexLogEntry] = []
        if not fs.exists(system):
            return out
        for st in fs.list_status(system):
            if not st.is_dir:
                continue
            log_mgr = self._log_factory.create(st.path, self._fs_factory.create(st.path))
            entry = log_mgr.get_latest_log()
            if entry is not None and entry.state in states.TRANSIENT_STATES:
                entry = log_mgr.get_latest_stable_log()
            if entry is None:
                continue
            if states_filter is None or entry.state in states_filter:
                out.append(entry)
        return out

    def indexes(self) -> Table:
        """The summary table (reference `IndexSummary`, :151-191) on the host,
        without DOESNOTEXIST indexes, in the JAX package's columns and order."""
        rows = {c: [] for c in (
            "name", "indexedColumns", "includedColumns", "numBuckets", "schema", "indexLocation", "state",
        )}
        for e in self.get_indexes():
            if e.state == states.DOESNOTEXIST:
                continue
            rows["name"].append(e.name)
            rows["indexedColumns"].append(",".join(e.indexed_columns))
            rows["includedColumns"].append(",".join(e.included_columns))
            rows["numBuckets"].append(e.num_buckets)
            rows["schema"].append(e.schema_json)
            rows["indexLocation"].append(e.index_location())
            rows["state"].append(e.state)
        return Table.from_pydict(rows, "cpu")


class IndexCache:
    """Cache of the full entry list (reference `index/Cache.scala:23-41`)."""

    def get(self) -> Optional[List[IndexLogEntry]]:
        raise NotImplementedError

    def set(self, entries: List[IndexLogEntry]) -> None:
        raise NotImplementedError

    def clear(self) -> None:
        raise NotImplementedError


class CreationTimeBasedIndexCache(IndexCache):
    """The entry list, expired `expiry_seconds_fn()` seconds after it was set
    (reference `CreationTimeBasedIndexCache`, :117-168)."""

    def __init__(self, expiry_seconds_fn):
        self._expiry_fn = expiry_seconds_fn
        self._entries: Optional[List[IndexLogEntry]] = None
        self._set_time = 0.0

    def get(self) -> Optional[List[IndexLogEntry]]:
        if self._entries is None:
            return None
        if time.time() - self._set_time > self._expiry_fn():
            self.clear()
            return None
        return self._entries

    def set(self, entries: List[IndexLogEntry]) -> None:
        self._entries = list(entries)
        self._set_time = time.time()

    def clear(self) -> None:
        self._entries = None
        self._set_time = 0.0


class IndexCacheFactory:
    """Cache implementations by policy name (reference
    `IndexCacheFactory.scala:23-38`); `register` is the extension seam."""

    CREATION_TIME_BASED = "CREATION_TIME_BASED"
    _registry = {}

    @classmethod
    def register(cls, cache_type: str, ctor) -> None:
        """ctor: (session) -> IndexCache"""
        cls._registry[cache_type.upper()] = ctor

    @classmethod
    def create(cls, cache_type: str, session) -> IndexCache:
        ctor = cls._registry.get(cache_type.upper())
        if ctor is None:
            raise HyperspaceException(f"Unknown index cache type: {cache_type}")
        return ctor(session)


IndexCacheFactory.register(
    IndexCacheFactory.CREATION_TIME_BASED,
    lambda session: CreationTimeBasedIndexCache(lambda: session.hs_conf.cache_expiry_seconds),
)


class CachingIndexCollectionManager(IndexCollectionManager):
    """The read path through the cache policy `hyperspace.index.cache.type`
    names. A mutation clears the cache before and after the action: a
    concurrent reader may refill it with the old generation while the action
    runs, and a failed action's transient entry must be read, not trusted
    from the cache (:382-496).

    In a replica fleet (`HYPERSPACE_REPLICAS=1`, `serve.replicas`) the clear
    crosses processes: a committed mutation publishes the index's latest log
    id to the fleet's epoch file, and `get_indexes` polls that file (one
    rate-limited `os.stat`, through this manager's own cursor) and drops the
    cache when it moved: a refresh committed by any replica flips every
    replica's readers with no TTL wait. Fleet off: one env read."""

    def __init__(self, session, **factories):
        super().__init__(session, **factories)
        self._cache = IndexCacheFactory.create(session.hs_conf.cache_type, session)
        # A cursor of this manager's own: a shared one would let one manager
        # consume the epoch's move and starve the others of their clear.
        self._epoch_state: dict = {}

    def _fleet_registry_dir(self) -> str:
        from ..serve import replicas as _replicas

        return _replicas.registry_dir(self._session.warehouse)

    def get_indexes(self, states_filter: Optional[Sequence[str]] = None) -> List[IndexLogEntry]:
        from ..serve import replicas as _replicas

        if _replicas.fleet_enabled() and _replicas.check_invalidation(self._epoch_state, self._fleet_registry_dir()):
            self._cache.clear()
        cached = self._cache.get()
        if cached is None:
            cached = super().get_indexes(None)
            self._cache.set(cached)
        if states_filter is None:
            return list(cached)
        return [e for e in cached if e.state in states_filter]

    def clear_cache(self) -> None:
        self._cache.clear()

    def _publish_fleet_invalidation(self, index_name: Optional[str]) -> None:
        """Announce a committed mutation's latest log id to the fleet (a
        no-op without one; never fails the action)."""
        from ..serve import replicas as _replicas

        if index_name is None or not _replicas.fleet_enabled():
            return
        try:
            log_mgr, _, _ = self._managers_for(index_name)
            _replicas.publish_invalidation(index_name, log_mgr.get_latest_id(), self._fleet_registry_dir())
        except Exception:
            pass

    def _mutate(self, fn, index_name: Optional[str] = None) -> None:
        self.clear_cache()
        try:
            fn()
            self._publish_fleet_invalidation(index_name)
        finally:
            self.clear_cache()

    def create(self, df, index_config) -> None:
        self._mutate(lambda: super(CachingIndexCollectionManager, self).create(df, index_config),
                     index_config.index_name)

    def refresh(self, index_name: str, mode: str = "full") -> None:
        self._mutate(lambda: super(CachingIndexCollectionManager, self).refresh(index_name, mode), index_name)

    def optimize(self, index_name: str, mode: str = "quick") -> None:
        self._mutate(lambda: super(CachingIndexCollectionManager, self).optimize(index_name, mode), index_name)

    def delete(self, index_name: str) -> None:
        self._mutate(lambda: super(CachingIndexCollectionManager, self).delete(index_name), index_name)

    def restore(self, index_name: str) -> None:
        self._mutate(lambda: super(CachingIndexCollectionManager, self).restore(index_name), index_name)

    def vacuum(self, index_name: str) -> None:
        self._mutate(lambda: super(CachingIndexCollectionManager, self).vacuum(index_name), index_name)

    def cancel(self, index_name: str) -> None:
        self._mutate(lambda: super(CachingIndexCollectionManager, self).cancel(index_name), index_name)

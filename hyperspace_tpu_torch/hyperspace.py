"""The Hyperspace facade and the session enable/disable implicits
(counterpart of `hyperspace_tpu/hyperspace.py`; reference `Hyperspace.scala`,
`package.scala:34-74`). `enable_hyperspace` registers `JoinIndexRule`,
`FilterIndexRule`, then `DataSkippingFilterRule`, in the JAX package's order.
The facade creates covering and data-skipping indexes, refreshes, compacts
(`optimize_index`, covering indexes only), deletes, restores, vacuums,
cancels and lists them, and explains a query's plan with them and without.
Create, refresh and optimize each run in a `resilience.query_scope` of their
own (one deadline and retry budget for the build) and a root span of their
own (`build:create_index`, `build:refresh_index`, `build:optimize_index`);
refresh and optimize run in the serving layer's batch lane. `server()` makes
the multi-tenant front door (`serve.QueryServer`)."""

from __future__ import annotations

import os
from typing import Optional, Union

from . import resilience
from .telemetry import tracing
from .config import ENV_REFRESH_MODE
from .engine.session import DataFrame, HyperspaceSession
from .engine.table import Table
from .index.collection_manager import CachingIndexCollectionManager
from .index.dataskipping import DataSkippingIndexConfig
from .index.index_config import IndexConfig
from .plananalysis.plan_analyzer import explain_string
from .rules.data_skipping_rule import DataSkippingFilterRule
from .rules.filter_index_rule import FilterIndexRule
from .rules.join_index_rule import JoinIndexRule

_ALL_RULES = (JoinIndexRule, FilterIndexRule, DataSkippingFilterRule)

_MANAGER_ATTR = "_hyperspace_index_manager"


def _index_manager_for(session: HyperspaceSession) -> CachingIndexCollectionManager:
    """One manager per session (the reference's HyperspaceContext)."""
    mgr = getattr(session, _MANAGER_ATTR, None)
    if mgr is None:
        mgr = CachingIndexCollectionManager(session)
        setattr(session, _MANAGER_ATTR, mgr)
    return mgr


class Hyperspace:
    def __init__(self, session: Optional[HyperspaceSession] = None):
        """The index API over `session`, else over the active session
        (`HyperspaceSession.active()`)."""
        self._session = session or HyperspaceSession.active()
        self._manager = _index_manager_for(self._session)

    def create_index(self, df: DataFrame, index_config: Union[IndexConfig, DataSkippingIndexConfig]) -> None:
        with resilience.query_scope("build:create_index"):
            with tracing.query_span("build:create_index", index_name=index_config.index_name):
                self._manager.create(df, index_config)

    def delete_index(self, index_name: str) -> None:
        self._manager.delete(index_name)

    def restore_index(self, index_name: str) -> None:
        self._manager.restore(index_name)

    def vacuum_index(self, index_name: str) -> None:
        self._manager.vacuum(index_name)

    def refresh_index(self, index_name: str, mode: Optional[str] = None) -> None:
        """mode "full": rebuild; "incremental": index only the appended source
        files and fold the deleted ones through lineage; "auto": incremental
        when it can, full when it cannot, nothing when the index is fresh.
        None takes `HYPERSPACE_REFRESH_MODE`, else "full"."""
        mode = mode or os.environ.get(ENV_REFRESH_MODE) or "full"
        with resilience.query_scope("build:refresh_index"), resilience.lane_scope("batch"):
            with tracing.query_span("build:refresh_index", index_name=index_name, mode=mode):
                self._manager.refresh(index_name, mode)

    def optimize_index(self, index_name: str, mode: str = "quick") -> None:
        """Merge each bucket's index files into one ("quick": the files below
        `hyperspace.index.optimize.fileSizeThreshold`; "full": all), and
        drop the rows of folded deleted source files."""
        with resilience.query_scope("build:optimize_index"), resilience.lane_scope("batch"):
            with tracing.query_span("build:optimize_index", index_name=index_name, mode=mode):
                self._manager.optimize(index_name, mode)

    def cancel(self, index_name: str) -> None:
        self._manager.cancel(index_name)

    def indexes(self) -> Table:
        return self._manager.indexes()

    def server(self, max_concurrent: Optional[int] = None, queue_depth: Optional[int] = None,
               tenant_budget: Optional[int] = None):
        """A multi-tenant `serve.QueryServer` over this process's engine:
        bounded workers, priority lanes, per-tenant admission, single-flight
        shared caches (None takes the env knobs).

            with hs.server(max_concurrent=4) as srv:
                fut = srv.submit(lambda: df.collect(), tenant="alice", lane="interactive")

        `HYPERSPACE_SERVING=0` runs every submission inline and serially."""
        from .serve import QueryServer

        return QueryServer(max_concurrent=max_concurrent, queue_depth=queue_depth, tenant_budget=tenant_budget)

    def explain(self, df: DataFrame, verbose: bool = False, redirect=None) -> None:
        """The plan with indexes against the plan without, and the indexes
        used (reference `Hyperspace.scala:101-104`); `verbose` adds the
        physical operator counts. Printed, or passed to `redirect`."""
        s = explain_string(df, self._session, self._manager.indexes(), verbose)
        (redirect or print)(s)


def enable_hyperspace(session: HyperspaceSession) -> HyperspaceSession:
    if not is_hyperspace_enabled(session):
        session.extra_optimizations = session.extra_optimizations + [
            JoinIndexRule(), FilterIndexRule(), DataSkippingFilterRule(),
        ]
    return session


def disable_hyperspace(session: HyperspaceSession) -> HyperspaceSession:
    session.extra_optimizations = [r for r in session.extra_optimizations if not isinstance(r, _ALL_RULES)]
    return session


def is_hyperspace_enabled(session: HyperspaceSession) -> bool:
    return any(isinstance(r, _ALL_RULES) for r in session.extra_optimizations)

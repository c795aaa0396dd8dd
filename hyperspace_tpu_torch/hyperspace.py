"""The Hyperspace facade and the session enable/disable implicits
(counterpart of `hyperspace_tpu/hyperspace.py`; reference `Hyperspace.scala`,
`package.scala:34-74`). `enable_hyperspace` registers `JoinIndexRule`, then
`FilterIndexRule`, in the JAX package's order; its data-skipping rule is not
ported."""

from __future__ import annotations

from .engine.session import DataFrame, HyperspaceSession
from .index.collection_manager import IndexCollectionManager
from .index.index_config import IndexConfig
from .rules.filter_index_rule import FilterIndexRule
from .rules.join_index_rule import JoinIndexRule

_ALL_RULES = (JoinIndexRule, FilterIndexRule)

_MANAGER_ATTR = "_hyperspace_index_manager"


def _index_manager_for(session: HyperspaceSession) -> IndexCollectionManager:
    """One manager per session (the reference's HyperspaceContext)."""
    mgr = getattr(session, _MANAGER_ATTR, None)
    if mgr is None:
        mgr = IndexCollectionManager(session)
        setattr(session, _MANAGER_ATTR, mgr)
    return mgr


class Hyperspace:
    def __init__(self, session: HyperspaceSession):
        self._session = session
        self._manager = _index_manager_for(session)

    def create_index(self, df: DataFrame, index_config: IndexConfig) -> None:
        self._manager.create(df, index_config)


def enable_hyperspace(session: HyperspaceSession) -> HyperspaceSession:
    if not is_hyperspace_enabled(session):
        session.extra_optimizations = session.extra_optimizations + [JoinIndexRule(), FilterIndexRule()]
    return session


def disable_hyperspace(session: HyperspaceSession) -> HyperspaceSession:
    session.extra_optimizations = [r for r in session.extra_optimizations if not isinstance(r, _ALL_RULES)]
    return session


def is_hyperspace_enabled(session: HyperspaceSession) -> bool:
    return any(isinstance(r, _ALL_RULES) for r in session.extra_optimizations)

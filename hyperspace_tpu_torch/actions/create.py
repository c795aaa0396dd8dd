"""CreateAction: (none/DOESNOTEXIST) → CREATING → ACTIVE.

Parity: reference `actions/CreateAction.scala:30-82`. The build and the log-entry
derivation are injected as an `IndexerBuilder` (the seam of
`hyperspace_tpu/actions/create.py`), so the state machine knows nothing of the
engine.
"""

from __future__ import annotations

from ..exceptions import HyperspaceException
from ..index.index_config import IndexConfig
from ..index.log_entry import IndexLogEntry, LogEntry
from . import states
from .action import Action


class IndexerBuilder:
    """Engine seam: validates the source, writes index data, derives the record."""

    def validate_source(self, df, index_config: IndexConfig) -> None:
        raise NotImplementedError

    def write(self, df, index_config: IndexConfig, index_data_path: str) -> None:
        raise NotImplementedError

    def derive_log_entry(
        self, df, index_config: IndexConfig, index_path: str, index_data_path: str
    ) -> IndexLogEntry:
        raise NotImplementedError


class CreateAction(Action):
    def __init__(
        self,
        df,
        index_config: IndexConfig,
        builder: IndexerBuilder,
        log_manager,
        index_path: str,
        index_data_path: str,
    ):
        super().__init__(log_manager)
        self._df = df
        self._config = index_config
        self._builder = builder
        self._index_path = index_path
        self._index_data_path = index_data_path

    @property
    def transient_state(self) -> str:
        return states.CREATING

    @property
    def final_state(self) -> str:
        return states.ACTIVE

    def validate(self) -> None:
        # A live index of the same name blocks creation (reference
        # `CreateAction.scala:44-64`); a transient latest entry is judged by
        # the latest STABLE one (a dead writer's orphan).
        latest = self._log_manager.get_latest_log()
        if latest is not None and latest.state in states.TRANSIENT_STATES:
            latest = self._log_manager.get_latest_stable_log()
        if latest is not None and latest.state != states.DOESNOTEXIST:
            raise HyperspaceException(
                f"Another Index with name {self._config.index_name} already exists."
            )
        self._builder.validate_source(self._df, self._config)

    def op(self) -> None:
        self._builder.write(self._df, self._config, self._index_data_path)

    def log_entry(self) -> LogEntry:
        # Derived fresh per phase: end() must inventory the files op() wrote.
        return self._builder.derive_log_entry(
            self._df, self._config, self._index_path, self._index_data_path
        )

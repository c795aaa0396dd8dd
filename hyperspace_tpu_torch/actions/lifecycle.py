"""Metadata-only lifecycle actions: Delete, Restore, Vacuum, Cancel.

Counterpart of `hyperspace_tpu/actions/lifecycle.py` (reference
`DeleteAction.scala`, `RestoreAction.scala`, `VacuumAction.scala:38-52`,
`CancelAction.scala:28-76`), with the same state transitions, log ids and
events. Each carries the previous log entry forward with a new
state; only vacuum touches data, deleting every version directory.
"""

from __future__ import annotations

import copy
from typing import Optional

from ..exceptions import HyperspaceException
from ..index.log_entry import LogEntry
from ..telemetry.events import CancelActionEvent, DeleteActionEvent, RestoreActionEvent, VacuumActionEvent
from . import states
from .action import Action


class _EntryTransitionAction(Action):
    """An action whose entry is the previous log entry with a new state."""

    def __init__(self, log_manager):
        super().__init__(log_manager)
        self._entry_cache: Optional[LogEntry] = None

    def _previous_entry(self) -> LogEntry:
        prev = self._log_manager.get_log(self.base_id)
        if prev is None:
            raise HyperspaceException("Index does not exist.")
        return prev

    def log_entry(self) -> LogEntry:
        if self._entry_cache is None:
            self._entry_cache = copy.deepcopy(self._previous_entry())
        return self._entry_cache

    def _require_previous(self, state: str, verb: str) -> None:
        if self._previous_entry().state != state:
            raise HyperspaceException(f"{verb} is only supported in {state} state.")


class DeleteAction(_EntryTransitionAction):
    """Soft delete: ACTIVE → DELETING → DELETED; the data stays."""

    event_class = DeleteActionEvent

    transient_state = states.DELETING
    final_state = states.DELETED

    def validate(self) -> None:
        self._require_previous(states.ACTIVE, "Delete")


class RestoreAction(_EntryTransitionAction):
    """DELETED → RESTORING → ACTIVE."""

    event_class = RestoreActionEvent

    transient_state = states.RESTORING
    final_state = states.ACTIVE

    def validate(self) -> None:
        self._require_previous(states.DELETED, "Restore")


class VacuumAction(_EntryTransitionAction):
    """Hard delete: DELETED → VACUUMING → DOESNOTEXIST, removing every data
    version directory (reference `:46-52`)."""

    event_class = VacuumActionEvent

    transient_state = states.VACUUMING
    final_state = states.DOESNOTEXIST

    def __init__(self, data_manager, log_manager):
        super().__init__(log_manager)
        self._data_manager = data_manager

    def validate(self) -> None:
        self._require_previous(states.DELETED, "Vacuum")

    def op(self) -> None:
        latest = self._data_manager.get_latest_version_id()
        if latest is not None:
            for vid in range(latest + 1):
                self._data_manager.delete(vid)


class CancelAction(_EntryTransitionAction):
    """Roll a stuck transient state back to the last stable one (reference
    `CancelAction.scala:28-76`): VACUUMING → DOESNOTEXIST; no stable entry at
    all → DOESNOTEXIST; otherwise the latest stable entry's state."""

    event_class = CancelActionEvent

    transient_state = states.CANCELLING

    @property
    def final_state(self) -> str:
        if self._previous_entry().state == states.VACUUMING:
            return states.DOESNOTEXIST
        stable = self._log_manager.get_latest_stable_log()
        return stable.state if stable is not None else states.DOESNOTEXIST

    def validate(self) -> None:
        if self._previous_entry().state in states.STABLE_STATES:
            raise HyperspaceException("Cancel is only supported when index is in transient states.")

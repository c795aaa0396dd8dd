"""The lifecycle action: a two-phase commit on the operation log.

Parity: reference `actions/Action.scala:34-104` — `run()` = validate → begin → op
→ end, where `begin()` writes log id base+1 with the transient state and `end()`
writes id base+2 with the final state, then refreshes the `latestStable`
pointer. Counterpart of `hyperspace_tpu/actions/action.py`: the run is
wrapped in the action's CRUD events ("Operation Started.", "Operation
Succeeded.", "Operation Failed: ..."), logged to `event_logger`, which the
collection manager sets from `hyperspace.eventLoggerClass`. With the no-op
logger no event is built.
"""

from __future__ import annotations

import time
from typing import Optional

from ..exceptions import ConcurrentWriteError, HyperspaceException, LogCommitError
from ..index.log_entry import LogEntry
from ..telemetry.event_logging import EventLogger, NoOpEventLogger
from ..telemetry.events import HyperspaceEvent, HyperspaceIndexCRUDEvent
from . import states


def _recover_stable(log_manager, orphan: LogEntry, missing_ok: bool = False) -> Optional[LogEntry]:
    """Resolve a dead writer's transient latest entry to the latest STABLE
    one, so that the next action proceeds instead of wedging on it
    (`actions/action._recover_stable` :25). `missing_ok`: a log with no
    stable entry at all (a killed first create) gives None; otherwise it
    raises. A writer that is still alive shares the orphan's id as its base,
    so the two contest the next log id and exactly one wins."""
    stable = log_manager.get_latest_stable_log()
    if stable is None and not missing_ok:
        raise HyperspaceException(
            f"Index log has only a transient entry (state {orphan.state}) and "
            "no stable state to recover to; run cancel() or vacuum."
        )
    return stable


class Action:
    """Subclasses define transient_state, final_state, validate(), op(),
    log_entry() and their `event_class`."""

    event_class = HyperspaceIndexCRUDEvent
    event_logger: EventLogger = NoOpEventLogger()

    def __init__(self, log_manager):
        self._log_manager = log_manager
        self._base_id: Optional[int] = None

    @property
    def transient_state(self) -> str:
        raise NotImplementedError

    @property
    def final_state(self) -> str:
        raise NotImplementedError

    def validate(self) -> None:
        """Raise HyperspaceException if the action is not allowed now."""

    def op(self) -> None:
        """The action body (the index build for create)."""

    def log_entry(self) -> LogEntry:
        raise NotImplementedError

    @property
    def base_id(self) -> int:
        if self._base_id is None:
            latest = self._log_manager.get_latest_id()
            self._base_id = latest if latest is not None else -1
        return self._base_id

    def _write(self, log_id: int, state: str) -> LogEntry:
        entry = self.log_entry()
        entry.state = state
        entry.timestamp = int(time.time() * 1000)
        if not self._log_manager.write_log(log_id, entry):
            raise ConcurrentWriteError(
                "Another Index operation is in progress. Please retry."
            )
        return entry

    def begin(self) -> None:
        self._write(self.base_id + 1, self.transient_state)

    def end(self) -> None:
        final_id = self.base_id + 2
        entry = self._write(final_id, self.final_state)
        if entry.state in states.STABLE_STATES:
            # The numbered entry is committed either way; a failed pointer
            # refresh is reported, classified (`action.end` :102). The create
            # replaces any pointer, so a failed delete is harmless.
            try:
                self._log_manager.delete_latest_stable_log()
            except Exception:
                pass
            try:
                created = self._log_manager.create_latest_stable_log(final_id)
            except Exception as e:
                raise LogCommitError(
                    f"Committed log id {final_id} but the latestStable pointer refresh failed "
                    f"({type(e).__name__}: {e}); readers fall back to the id scan."
                ) from e
            if not created:
                raise LogCommitError(
                    f"Committed log id {final_id} but could not refresh the "
                    "latestStable pointer; readers fall back to the id scan."
                )

    def event_index_name(self) -> str:
        """The index the events name: the previous log entry's."""
        try:
            return self._previous_entry().name
        except Exception:
            return ""

    def event(self, message: str) -> HyperspaceEvent:
        return self.event_class(index_name=self.event_index_name(), message=message)

    def _log(self, message: str) -> None:
        if not isinstance(self.event_logger, NoOpEventLogger):
            self.event_logger.log_event(self.event(message))

    def run(self) -> None:
        """validate, begin, op, end, inside the action's events (reference
        `Action.scala:83-101`): a failure is logged and re-raised."""
        self._log("Operation Started.")
        try:
            self.validate()
            self.begin()
            self.op()
            self.end()
        except Exception as e:
            self._log(f"Operation Failed: {e}")
            raise
        self._log("Operation Succeeded.")

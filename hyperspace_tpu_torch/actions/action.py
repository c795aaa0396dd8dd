"""The lifecycle action: a two-phase commit on the operation log.

Parity: reference `actions/Action.scala:34-104` — `run()` = validate → begin → op
→ end, where `begin()` writes log id base+1 with the transient state and `end()`
writes id base+2 with the final state, then refreshes the `latestStable`
pointer. Counterpart of `hyperspace_tpu/actions/action.py` without telemetry.
"""

from __future__ import annotations

import time
from typing import Optional

from ..exceptions import ConcurrentWriteError, LogCommitError
from ..index.log_entry import LogEntry
from . import states


class Action:
    """Subclasses define transient_state, final_state, validate(), op() and
    log_entry()."""

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
            self._log_manager.delete_latest_stable_log()
            if not self._log_manager.create_latest_stable_log(final_id):
                raise LogCommitError(
                    f"Committed log id {final_id} but could not refresh the "
                    "latestStable pointer; readers fall back to the id scan."
                )

    def run(self) -> None:
        self.validate()
        self.begin()
        self.op()
        self.end()

"""Framework exceptions (counterpart of `hyperspace_tpu/exceptions.py`, cut to
the classes the slice raises)."""

from __future__ import annotations


class HyperspaceException(Exception):
    """Raised for all Hyperspace error conditions (validation, concurrency, state)."""

    def __init__(self, message: str):
        super().__init__(message)
        self.message = message


class ConcurrentWriteError(HyperspaceException):
    """Lost the operation-log optimistic-concurrency race: another writer
    committed the contested log id first. The loser aborts cleanly."""


class LogCommitError(HyperspaceException):
    """A metadata-log write that must succeed failed for a non-OCC reason."""


def not_in_slice(feature: str) -> NotImplementedError:
    """The error every feature outside the ported slice raises, naming it:
    the port refuses such work instead of answering it wrongly."""
    return NotImplementedError(
        f"{feature} is not ported to hyperspace_tpu_torch yet; use hyperspace_tpu "
        "for it (see ROADMAP.md)"
    )

"""Framework exceptions (counterpart of `hyperspace_tpu/exceptions.py`, cut to
the classes the port raises).

One `HyperspaceException` for user-facing errors, extended by a
transient/permanent taxonomy: `resilience.retry_io` retries a
`TransientError` with bounded backoff, a `PermanentError` fails fast, and a
`CorruptIndexError` (an index data file that does not decode) makes
`DataFrame.collect`/`count` quarantine the index and answer from the source.
"""

from __future__ import annotations

from typing import Optional


class HyperspaceException(Exception):
    """Raised for all Hyperspace error conditions (validation, concurrency, state)."""

    def __init__(self, message: str):
        super().__init__(message)
        self.message = message


class TransientError(HyperspaceException):
    """A fault a bounded retry may clear (flaky IO, an injected transient
    fault): the only `HyperspaceException` that `resilience.retry_io` retries."""


class PermanentError(HyperspaceException):
    """A fault a retry cannot clear. Never retried."""


class CorruptIndexError(PermanentError):
    """An index data file failed to decode. Carries the index name, so that
    the query layer can quarantine the index and re-plan over the source."""

    def __init__(self, message: str, index_name: str, path: Optional[str] = None):
        super().__init__(message)
        self.index_name = index_name
        self.path = path


class ConcurrentWriteError(HyperspaceException):
    """Lost the operation-log optimistic-concurrency race: another writer
    committed the contested log id first. The loser aborts cleanly."""


class LogCommitError(HyperspaceException):
    """A metadata-log write that must succeed failed for a non-OCC reason."""


class QueryTimeoutError(HyperspaceException):
    """The query ran past `HYPERSPACE_QUERY_TIMEOUT_S`. Raised at a chunk,
    file or bucket boundary; no partial cache or memo entry is left."""

    def __init__(self, message: str, elapsed_s: float = 0.0, timeout_s: float = 0.0):
        super().__init__(message)
        self.elapsed_s = elapsed_s
        self.timeout_s = timeout_s


class CompileTimeoutError(QueryTimeoutError):
    """The kernel library's build ran past `HYPERSPACE_COMPILE_TIMEOUT_S`;
    its `nvcc` processes were killed."""


class RetryBudgetExceededError(PermanentError):
    """One query spent its retry budget (`HYPERSPACE_QUERY_RETRY_BUDGET`):
    each site's fault is transient, but the query's is systemic."""


def is_transient(exc: BaseException) -> bool:
    """Whether `exc` is worth a retry: the taxonomy decides for the
    framework's errors; of the others, connection and OS-level IO errors are
    transient, while missing files, parse errors (pyarrow's `ArrowInvalid` is
    a `ValueError`) and everything else are not."""
    if isinstance(exc, TransientError):
        return True
    if isinstance(exc, HyperspaceException):
        return False
    if isinstance(exc, (FileNotFoundError, IsADirectoryError, PermissionError)):
        return False
    return isinstance(exc, (ConnectionError, TimeoutError, InterruptedError, OSError))


def not_in_slice(feature: str) -> NotImplementedError:
    """The error every feature outside the ported slice raises, naming it:
    the port refuses such work instead of answering it wrongly."""
    return NotImplementedError(
        f"{feature} is not ported to hyperspace_tpu_torch yet; use hyperspace_tpu "
        "for it (see ROADMAP.md)"
    )

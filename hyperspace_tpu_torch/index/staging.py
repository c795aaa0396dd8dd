"""Crash-safe index-data commits: the build writes into a dot-prefixed staging
directory that every inventory ignores, committed by ONE atomic rename.

Counterpart of `hyperspace_tpu/index/staging.py`. A writer killed before its
rename leaves only an invisible staging directory; `reclaim_orphans` deletes
those whose writer is dead (same host, dead pid) or, for another host's,
that have sat untouched past `HYPERSPACE_STAGING_TTL_S` (24 h). Every action
that resolves an index, and vacuum, runs it.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import socket
import time
import uuid
from typing import Iterator, List, Optional, Tuple

from ..exceptions import ConcurrentWriteError
from ..util.procs import pid_alive

STAGING_PREFIX = ".staging-"

#: Reclamation age of another host's staging directories, seconds: pid
#: liveness is knowable only on this host, and a live build elsewhere must
#: keep its staging area.
ENV_STAGING_TTL_S = "HYPERSPACE_STAGING_TTL_S"
_DEFAULT_STAGING_TTL_S = 24 * 3600.0


def _staging_ttl_s() -> float:
    try:
        return max(0.0, float(os.environ.get(ENV_STAGING_TTL_S, "") or _DEFAULT_STAGING_TTL_S))
    except ValueError:
        return _DEFAULT_STAGING_TTL_S


def _staging_name(final_name: str) -> str:
    # The same '~'-separated owner tail as the JAX package, so either
    # package's reclaim pass can parse the other's staging directories.
    return (
        f"{STAGING_PREFIX}{final_name}"
        f"~{socket.gethostname()}~{os.getpid()}~{uuid.uuid4().hex[:8]}"
    )


def _owner_of(name: str) -> Tuple[Optional[str], int]:
    """(hostname, pid) encoded in a staging directory's name; (None, -1) when
    it cannot be parsed."""
    parts = name.split("~")
    try:
        return parts[-3], int(parts[-2])
    except (IndexError, ValueError):
        return None, -1


@contextlib.contextmanager
def stage_commit(final_path: str) -> Iterator[str]:
    """Yield a staging directory for the build of `final_path`; commit it by
    rename on clean exit, delete it on failure. Raises `ConcurrentWriteError`
    when `final_path` appeared concurrently."""
    final_path = final_path.rstrip(os.sep)
    parent = os.path.dirname(final_path) or "."
    os.makedirs(parent, exist_ok=True)
    stage = os.path.join(parent, _staging_name(os.path.basename(final_path)))
    try:
        yield stage
    except BaseException:
        shutil.rmtree(stage, ignore_errors=True)
        raise
    if not os.path.isdir(stage):
        return
    try:
        os.rename(stage, final_path)
    except OSError as e:
        shutil.rmtree(stage, ignore_errors=True)
        if os.path.exists(final_path):
            raise ConcurrentWriteError(
                f"Another writer committed {final_path} first; this build was "
                "aborted cleanly. Please retry."
            ) from e
        raise


def _is_orphan(path: str, name: str) -> bool:
    host, pid = _owner_of(name)
    if host == socket.gethostname() and pid > 0:
        return not pid_alive(pid)
    try:
        age = time.time() - os.stat(path).st_mtime
    except OSError:
        return False  # vanished concurrently: someone else reclaimed it
    return age > _staging_ttl_s()


def list_orphans(index_path: str) -> List[str]:
    """Staging directories under `index_path` whose writer is provably dead
    (this host, dead pid) or stale past the TTL (another host)."""
    if not os.path.isdir(index_path):
        return []
    return [
        os.path.join(index_path, name)
        for name in os.listdir(index_path)
        if name.startswith(STAGING_PREFIX) and _is_orphan(os.path.join(index_path, name), name)
    ]


def reclaim_orphans(index_path: str) -> int:
    """Delete the orphaned staging directories under `index_path`; returns
    their count. Live writers are never touched."""
    n = 0
    for p in list_orphans(index_path):
        shutil.rmtree(p, ignore_errors=True)
        n += 1
    return n

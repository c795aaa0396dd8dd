"""Crash-safe index-data commits: the build writes into a dot-prefixed staging
directory that every inventory ignores, committed by ONE atomic rename.

Counterpart of `hyperspace_tpu/index/staging.py` `stage_commit` (orphan
reclamation is not ported yet).
"""

from __future__ import annotations

import contextlib
import os
import shutil
import socket
import uuid
from typing import Iterator

from ..exceptions import ConcurrentWriteError

STAGING_PREFIX = ".staging-"


def _staging_name(final_name: str) -> str:
    # The same '~'-separated owner tail as the JAX package, so either
    # package's reclaim pass can parse the other's staging directories.
    return (
        f"{STAGING_PREFIX}{final_name}"
        f"~{socket.gethostname()}~{os.getpid()}~{uuid.uuid4().hex[:8]}"
    )


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

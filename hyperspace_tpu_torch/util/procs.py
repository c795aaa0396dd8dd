"""Process liveness for dead-writer reclaim (counterpart of
`hyperspace_tpu/util/procs.py`)."""

from __future__ import annotations

import os


def pid_alive(pid: int) -> bool:
    """Whether `pid` is a live process on this host. Anything but a definite
    ProcessLookupError counts as alive: a reclaim must never delete what
    might be live."""
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except OSError:  # PermissionError included: it exists, or it is unknown
        return True

"""Size-capped rotation of the JSONL sinks (counterpart of
`hyperspace_tpu/telemetry/rotation.py`, same knobs and counter).

- `HYPERSPACE_TRACE_MAX_MB` / `HYPERSPACE_METRICS_MAX_MB` cap the live
  trace and exporter files (0 or unset: no cap).
- At the cap the live file becomes `<path>.1`, `.1` becomes `.2` and so on,
  `HYPERSPACE_SINK_KEEP` generations (default 3); the oldest is dropped.
  The shift happens before the write, so one appended blob (a whole trace,
  a whole frame) never spans two files and every file parses alone.
- Each rotation ticks `telemetry.sink.rotations`.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

from . import metrics as _metrics

ENV_TRACE_MAX_MB = "HYPERSPACE_TRACE_MAX_MB"
ENV_METRICS_MAX_MB = "HYPERSPACE_METRICS_MAX_MB"
ENV_SINK_KEEP = "HYPERSPACE_SINK_KEEP"
_DEFAULT_KEEP = 3

_ROTATIONS = _metrics.counter("telemetry.sink.rotations")


def _max_bytes(env_key: str) -> int:
    try:
        mb = float(os.environ.get(env_key, "") or 0.0)
    except ValueError:
        mb = 0.0
    return int(mb * 1_000_000) if mb > 0 else 0


def keep_files() -> int:
    try:
        return max(1, int(os.environ.get(ENV_SINK_KEEP, "") or _DEFAULT_KEEP))
    except ValueError:
        return _DEFAULT_KEEP


def _shift(path: str, keep: int, drop) -> None:
    """Drop generation `keep` with `drop`, move each younger one up, and the
    live `path` to `.1`; a generation that does not exist is skipped."""
    drop(f"{path}.{keep}")
    for i in range(keep - 1, 0, -1):
        try:
            os.replace(f"{path}.{i}", f"{path}.{i + 1}")
        except OSError:
            continue
    try:
        os.replace(path, f"{path}.1")
    except OSError:
        return  # nothing to rotate (or it vanished meanwhile)
    _ROTATIONS.inc()


def _unlink(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


def rotate(path: str) -> None:
    """Shift the file `path` → `path.1` → … → `path.<keep>`."""
    _shift(path, keep_files(), _unlink)


def rotate_dir(path: str, keep: Optional[int] = None) -> None:
    """`rotate` for a directory (the profile captures under
    `HYPERSPACE_PROFILE_DIR`, whose callers pass their own keep count)."""
    _shift(path, keep_files() if keep is None else keep, lambda p: shutil.rmtree(p, ignore_errors=True))


def append(path: str, text: str, max_mb_env: Optional[str] = None) -> None:
    """Append `text` to `path`, rotating first when it would cross the cap
    that `max_mb_env` names. A blob larger than the whole cap still lands,
    in a fresh file: rotation bounds growth and never drops telemetry."""
    cap = _max_bytes(max_mb_env) if max_mb_env else 0
    if cap > 0:
        try:
            size = os.path.getsize(path)
        except OSError:
            size = 0
        if size > 0 and size + len(text) > cap:
            rotate(path)
    with open(path, "a") as f:
        f.write(text)
        f.flush()

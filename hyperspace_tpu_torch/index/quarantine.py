"""Corruption quarantine: a broken index sits out instead of failing queries.

Counterpart of `hyperspace_tpu/index/quarantine.py`. A quarantined index is
skipped at candidate selection (`rules.rule_utils.get_candidate_indexes`), so
its queries fall back to the source scan; `refresh(mode="auto")` rebuilds a
quarantined index even when its source has not changed, and every mutation
that writes new data (create, refresh, vacuum) lifts the mark. The state is
process-local and advisory: the lake's log is not touched. The JAX package's
metrics (`index.quarantine.events` and `.active`) are plain counters here
(`stats()`).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

_lock = threading.Lock()
_entries: Dict[str, dict] = {}
_events = 0


def mark(index_name: str, reason: str, path: Optional[str] = None) -> bool:
    """Quarantine `index_name`; False if it already was (the caller then knows
    re-planning cannot help and should propagate the failure)."""
    global _events
    with _lock:
        if index_name in _entries:
            return False
        _entries[index_name] = {"reason": reason, "path": path, "ts": time.time()}
        _events += 1
    return True


def is_quarantined(index_name: str) -> bool:
    with _lock:
        return index_name in _entries


def clear(index_name: Optional[str] = None) -> None:
    """Lift the quarantine of one index (rebuilt or refreshed data supersedes
    the corrupt files) or of all (None)."""
    with _lock:
        if index_name is None:
            _entries.clear()
        else:
            _entries.pop(index_name, None)


def snapshot() -> Dict[str, dict]:
    with _lock:
        return {k: dict(v) for k, v in _entries.items()}


def stats() -> Dict[str, int]:
    """Lifetime quarantine events and the indexes quarantined now."""
    with _lock:
        return {"events": _events, "active": len(_entries)}

"""A Delta-style transactional table source (the "delta" format).

Counterpart of `hyperspace_tpu/storage/delta.py` (BASELINE.md config 5's
source): parquet data files plus `_delta_log/<version>.json` commits of
`add` / `remove` actions, one JSON action a line. A reader resolves the
ACTIVE file set by replaying the log, so a DataFrame over a delta table sees
one snapshot, and an index signature fingerprints exactly its files: a file
that a `remove` commit dropped stays on disk (for a vacuum) but is never read.
Versions are committed by an atomic no-overwrite create, the same optimistic
concurrency primitive as the index operation log. The log layout and the
data-file names are the JAX package's, so either package reads, indexes and
appends to a table the other wrote.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

from ..exceptions import HyperspaceException
from .filesystem import FileStatus, LocalFileSystem

DELTA_LOG_DIR = "_delta_log"
_COMMIT_RETRIES = 50


def _log_dir(path: str) -> str:
    return os.path.join(path, DELTA_LOG_DIR)


def _commit_path(path: str, version: int) -> str:
    return os.path.join(_log_dir(path), f"{version:020d}.json")


def is_delta_table(path: str, fs: Optional[LocalFileSystem] = None) -> bool:
    fs = fs or LocalFileSystem()
    return fs.exists(_log_dir(path))


def latest_version(path: str, fs: LocalFileSystem) -> Optional[int]:
    """The highest committed version, or None before the first commit."""
    d = _log_dir(path)
    if not fs.exists(d):
        return None
    versions = [
        int(st.name.split(".")[0])
        for st in fs.list_status(d)
        if st.name.endswith(".json") and st.name.split(".")[0].isdigit()
    ]
    return max(versions) if versions else None


def commit(path: str, actions: List[Dict], fs: Optional[LocalFileSystem] = None) -> int:
    """Append one commit of `actions` as the next version; a writer that
    loses the race for a version number retries on the next (bounded)."""
    fs = fs or LocalFileSystem()
    text = "\n".join(json.dumps(a) for a in actions)
    for _ in range(_COMMIT_RETRIES):
        latest = latest_version(path, fs)
        version = 0 if latest is None else latest + 1
        if fs.atomic_write_text(_commit_path(path, version), text):
            return version
    raise HyperspaceException(f"Could not commit to delta table {path} (contention).")


def active_files(path: str, fs: Optional[LocalFileSystem] = None) -> List[FileStatus]:
    """Replay the log: the current snapshot's data files, by relative path,
    with the size and modification time their `add` action recorded."""
    fs = fs or LocalFileSystem()
    latest = latest_version(path, fs)
    if latest is None:
        raise HyperspaceException(f"Not a delta table (no {DELTA_LOG_DIR}): {path}")
    active: Dict[str, Dict] = {}
    for v in range(latest + 1):
        p = _commit_path(path, v)
        if not fs.exists(p):
            continue
        for line in fs.read_text(p).splitlines():
            if not line.strip():
                continue
            a = json.loads(line)
            if "add" in a:
                active[a["add"]["path"]] = a["add"]
            elif "remove" in a:
                active.pop(a["remove"]["path"], None)
    out = []
    for rel_path, add in sorted(active.items()):
        full = os.path.join(path, rel_path)
        if "size" in add:
            size = add["size"]
        else:
            size = fs.get_status(full).size if fs.exists(full) else 0
        out.append(FileStatus(path=full, size=size, modified_time=add.get("modificationTime", 0), is_dir=False))
    return out


def write_delta(table, path: str, mode: str = "append", fs: Optional[LocalFileSystem] = None) -> int:
    """Write a table as one parquet file and commit it (mode "append", or
    "overwrite": the same commit removes every active file). Returns the
    committed version."""
    from ..engine import io as engine_io

    fs = fs or LocalFileSystem()
    if mode not in ("append", "overwrite"):
        raise HyperspaceException(f"Unsupported delta write mode: {mode}")
    latest = latest_version(path, fs)
    next_v = 0 if latest is None else latest + 1
    fname = f"part-{next_v:05d}-{int(time.time() * 1000)}.parquet"
    full = os.path.join(path, fname)
    engine_io.write_parquet(table, full)
    st = fs.get_status(full)
    actions: List[Dict] = []
    if mode == "overwrite" and latest is not None:
        for f in active_files(path, fs):
            actions.append({"remove": {"path": os.path.relpath(f.path, path)}})
    actions.append({"add": {"path": fname, "size": st.size, "modificationTime": st.modified_time}})
    return commit(path, actions, fs)


def remove_file(path: str, rel_path: str, fs: Optional[LocalFileSystem] = None) -> int:
    """Commit a remove action; the data file itself stays on disk (a
    vacuum's work, as in Delta)."""
    return commit(path, [{"remove": {"path": rel_path}}], fs)

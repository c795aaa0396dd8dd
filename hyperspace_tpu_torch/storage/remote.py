"""Remote-protocol storage: an fsspec adapter behind the `FileSystem` seam.

Counterpart of `hyperspace_tpu/storage/remote.py` (`FsspecFileSystem` :46,
`filesystem_for_path` :167; reference `FileSystemFactory.create(path)`,
`index/factories.scala:43-50`). Any fsspec backend (memory://, s3://,
gcs://, abfs://, hdfs://, whatever backends the deployment installs) serves the
`FileSystem` contract of the log and data managers.

The operation log's optimistic concurrency needs an atomic no-overwrite
commit, and object stores have no atomic rename, so `atomic_write_text` is
fsspec's exclusive create (`open(path, "xb")`): the conditional put of the
store (S3 If-None-Match, a GCS precondition, an ABFS lease). fsspec leaves
mode "x" to each backend; where a backend lacks it the commit falls back to a
check then a put, exact for the process-local `memory://` and warned about
once for anything else. `rename` is a check then a move and is not atomic;
nothing on the commit path uses it. fsspec is imported only when a backend
is made, never when this module is imported.
"""

from __future__ import annotations

import posixpath
import warnings
from typing import List, Optional

from .filesystem import FileStatus, FileSystem

_occ_fallback_warned = False

#: The path schemes served by fsspec (`remote.py:158`).
SCHEMES = ("memory://", "s3://", "gcs://", "gs://", "abfs://", "az://", "hdfs://")


def _epoch_ms(v) -> int:
    if v is None:
        return 0
    if hasattr(v, "timestamp"):
        return int(v.timestamp() * 1000)
    try:
        return int(float(v) * 1000)
    except (TypeError, ValueError):
        return 0


class FsspecFileSystem(FileSystem):
    """`FileSystem` over an fsspec instance (by default a new handle on the
    `protocol` backend)."""

    def __init__(self, fs=None, protocol: str = "memory"):
        if fs is None:
            import fsspec

            fs = fsspec.filesystem(protocol)
        self._fs = fs

    def exists(self, path: str) -> bool:
        return self._fs.exists(path)

    def is_dir(self, path: str) -> bool:
        return self._fs.isdir(path)

    def mkdirs(self, path: str) -> None:
        self._fs.makedirs(path, exist_ok=True)

    @staticmethod
    def _to_status(info: dict) -> FileStatus:
        mtime = info.get("mtime", info.get("LastModified", info.get("created")))
        return FileStatus(
            path=info["name"],
            size=int(info.get("size") or 0),
            modified_time=_epoch_ms(mtime),
            is_dir=info.get("type") == "directory",
        )

    def list_status(self, path: str) -> List[FileStatus]:
        if not self._fs.isdir(path):
            return []
        return sorted((self._to_status(i) for i in self._fs.ls(path, detail=True)), key=lambda s: s.path)

    def get_status(self, path: str) -> FileStatus:
        return self._to_status(self._fs.info(path))

    def delete(self, path: str, recursive: bool = False) -> None:
        if self._fs.exists(path):
            self._fs.rm(path, recursive=recursive)

    def rename(self, src: str, dst: str) -> bool:
        """A check then a move: not atomic under racing writers."""
        if self._fs.exists(dst):
            return False
        self._fs.mv(src, dst, recursive=self._fs.isdir(src))
        return True

    def read_bytes(self, path: str) -> bytes:
        with self._fs.open(path, "rb") as f:
            return f.read()

    def write_bytes(self, path: str, data: bytes) -> None:
        parent = posixpath.dirname(path)
        if parent:
            self._fs.makedirs(parent, exist_ok=True)
        with self._fs.open(path, "wb") as f:
            f.write(data)

    def atomic_write_text(self, path: str, text: str) -> bool:
        """The OCC commit by exclusive create: of racing writers of one log
        id exactly one wins, on a store with a true conditional put; the
        others get FileExistsError, returned as False."""
        parent = posixpath.dirname(path)
        if parent:
            self._fs.makedirs(parent, exist_ok=True)
        try:
            with self._fs.open(path, "xb") as f:
                f.write(text.encode("utf-8"))
            return True
        except FileExistsError:
            return False
        except ValueError:
            # The backend has no mode "x" (fsspec lets a backend refuse it
            # with ValueError): a check then a put, exact for a
            # process-local store, weaker than a conditional put for a
            # shared one.
            if not self._is_process_local():
                global _occ_fallback_warned
                if not _occ_fallback_warned:
                    _occ_fallback_warned = True
                    warnings.warn(
                        f"fsspec backend {type(self._fs).__name__} does not support exclusive create "
                        "(mode 'x'); the operation log's OCC commit falls back to a NON-ATOMIC "
                        "check-then-put. Racing writers on a shared store can both succeed: verify "
                        "the backend before trusting concurrent index changes.",
                        RuntimeWarning,
                        stacklevel=3,
                    )
            if self._fs.exists(path):
                return False
            with self._fs.open(path, "wb") as f:
                f.write(text.encode("utf-8"))
            return True

    def _is_process_local(self) -> bool:
        """Whether the backend's state lives in this process (the memory://
        family), where a check then a put is as good as an exclusive create."""
        proto = getattr(self._fs, "protocol", "")
        return "memory" in (proto if isinstance(proto, (tuple, list)) else (proto,))


def filesystem_for_path(path: str) -> Optional[FileSystem]:
    """An `FsspecFileSystem` for a path with a remote scheme, None for a
    plain local path."""
    for scheme in SCHEMES:
        if path.startswith(scheme):
            import fsspec

            return FsspecFileSystem(fsspec.filesystem(scheme.split(":", 1)[0]))
    return None

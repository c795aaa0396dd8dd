"""Filesystem abstraction (the L1 storage layer): local disk with an atomic,
no-overwrite rename, which the operation log's optimistic concurrency rides.

Counterpart of `hyperspace_tpu/storage/filesystem.py` (`LocalFileSystem` only).
"""

from __future__ import annotations

import os
import shutil
import threading
from dataclasses import dataclass
from typing import List


@dataclass(frozen=True)
class FileStatus:
    """Metadata of one file or directory (name is the full path)."""

    path: str
    size: int
    modified_time: int  # epoch millis
    is_dir: bool

    @property
    def name(self) -> str:
        return os.path.basename(self.path.rstrip("/"))


class LocalFileSystem:
    """Local-disk backend."""

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def is_dir(self, path: str) -> bool:
        return os.path.isdir(path)

    def _status(self, path: str) -> FileStatus:
        st = os.stat(path)
        is_dir = os.path.isdir(path)
        return FileStatus(
            path=path,
            size=0 if is_dir else st.st_size,
            modified_time=int(st.st_mtime * 1000),
            is_dir=is_dir,
        )

    def list_status(self, path: str) -> List[FileStatus]:
        if not os.path.isdir(path):
            return []
        return sorted(
            (self._status(os.path.join(path, n)) for n in os.listdir(path)),
            key=lambda s: s.path,
        )

    def get_status(self, path: str) -> FileStatus:
        return self._status(path)

    def delete(self, path: str, recursive: bool = False) -> None:
        if os.path.isdir(path):
            if recursive:
                shutil.rmtree(path)
            else:
                os.rmdir(path)
        elif os.path.exists(path):
            os.remove(path)

    def rename(self, src: str, dst: str) -> bool:
        """Atomic rename of a file; False if `dst` already exists. `os.link`
        raises FileExistsError atomically where `os.rename` would replace."""
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        try:
            os.link(src, dst)
            os.unlink(src)
            return True
        except FileExistsError:
            return False

    def read_text(self, path: str) -> str:
        with open(path, "rb") as f:
            return f.read().decode("utf-8")

    def write_text(self, path: str, text: str) -> None:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "wb") as f:
            f.write(text.encode("utf-8"))

    def atomic_write_text(self, path: str, text: str) -> bool:
        """OCC commit primitive: write a unique temp file, then link it into
        place; False (temp cleaned up) when `path` already exists."""
        if self.exists(path):
            return False
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.temp"
        self.write_text(tmp, text)
        ok = self.rename(tmp, path)
        if self.exists(tmp):
            self.delete(tmp)
        return ok

    def list_leaf_files(self, path: str) -> List[FileStatus]:
        """Recursive listing of all plain files beneath `path`."""
        out: List[FileStatus] = []
        stack = [path]
        while stack:
            p = stack.pop()
            for st in self.list_status(p):
                if st.is_dir:
                    stack.append(st.path)
                else:
                    out.append(st)
        return sorted(out, key=lambda s: s.path)

"""Filesystem abstraction (the L1 storage layer).

Counterpart of `hyperspace_tpu/storage/filesystem.py`. All persistent state
(the operation log and the index data) lives on a filesystem-like store with
an atomic, no-overwrite commit, which the log's optimistic concurrency rides.
`FileSystem` is the contract the log and data managers and the IO layer are
written against; `LocalFileSystem` is the local disk (the default),
`InMemoryFileSystem` a dict for tests and `storage/remote.FsspecFileSystem`
any fsspec protocol (`memory://`, `s3://`, ...), chosen by path scheme
(`index/factories.FileSystemFactory`).
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Dict, List


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


class FileSystem:
    """The contract of a storage backend: a listing, status, delete, an
    atomic no-overwrite rename and whole-file bytes."""

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def is_dir(self, path: str) -> bool:
        raise NotImplementedError

    def mkdirs(self, path: str) -> None:
        raise NotImplementedError

    def list_status(self, path: str) -> List[FileStatus]:
        """Non-recursive listing of a directory, sorted by path."""
        raise NotImplementedError

    def get_status(self, path: str) -> FileStatus:
        raise NotImplementedError

    def delete(self, path: str, recursive: bool = False) -> None:
        raise NotImplementedError

    def rename(self, src: str, dst: str) -> bool:
        """Atomic rename; False if `dst` already exists (no overwrite)."""
        raise NotImplementedError

    def read_bytes(self, path: str) -> bytes:
        raise NotImplementedError

    def write_bytes(self, path: str, data: bytes) -> None:
        """Create-or-overwrite write (creates parent directories)."""
        raise NotImplementedError

    def read_text(self, path: str) -> str:
        return self.read_bytes(path).decode("utf-8")

    def write_text(self, path: str, text: str) -> None:
        self.write_bytes(path, text.encode("utf-8"))

    def atomic_write_text(self, path: str, text: str) -> bool:
        """OCC commit primitive (reference `IndexLogManager.scala:146-162`):
        write a unique temp file, then rename it into place; False (temp
        cleaned up) when `path` already exists. Of racing writers of one
        path exactly one wins."""
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

    def directory_size(self, path: str) -> int:
        """Bytes of every plain file beneath `path` (every backend, remote
        ones too, through `list_leaf_files`)."""
        return sum(f.size for f in self.list_leaf_files(path))


class LocalFileSystem(FileSystem):
    """Local-disk backend (the default)."""

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def is_dir(self, path: str) -> bool:
        return os.path.isdir(path)

    def mkdirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

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
        out = []
        for n in os.listdir(path):
            try:
                out.append(self._status(os.path.join(path, n)))
            except FileNotFoundError:
                continue  # renamed or deleted since the listing (a writer's temp file): not there
        return sorted(out, key=lambda s: s.path)

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
        raises FileExistsError atomically where `os.rename` would replace.
        A directory moves by `os.rename` after a check (not on the OCC
        path)."""
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        if os.path.isdir(src):
            if os.path.exists(dst):
                return False
            try:
                os.rename(src, dst)
                return True
            except OSError:
                return False
        try:
            os.link(src, dst)
            os.unlink(src)
            return True
        except FileExistsError:
            return False

    def read_bytes(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def write_bytes(self, path: str, data: bytes) -> None:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)


class InMemoryFileSystem(FileSystem):
    """A dict-backed filesystem for tests (`filesystem.py:189`)."""

    def __init__(self):
        self._files: Dict[str, bytes] = {}
        self._mtimes: Dict[str, int] = {}
        self._dirs: set = set()
        # Reentrant: write_bytes holds the lock and calls mkdirs.
        self._lock = threading.RLock()

    @staticmethod
    def _norm(path: str) -> str:
        return os.path.normpath(path)

    def _has_under(self, p: str) -> bool:
        prefix = p + os.sep
        return any(f.startswith(prefix) for f in self._files)

    def exists(self, path: str) -> bool:
        p = self._norm(path)
        with self._lock:
            return p in self._files or p in self._dirs or self._has_under(p)

    def is_dir(self, path: str) -> bool:
        p = self._norm(path)
        with self._lock:
            return p in self._dirs or self._has_under(p)

    def mkdirs(self, path: str) -> None:
        p = self._norm(path)
        with self._lock:
            while p and p != os.sep:
                self._dirs.add(p)
                p = os.path.dirname(p)

    def list_status(self, path: str) -> List[FileStatus]:
        p = self._norm(path)
        prefix = p + os.sep
        with self._lock:
            children = {f[len(prefix):].split(os.sep)[0] for f in list(self._files) + list(self._dirs)
                        if f.startswith(prefix)}
            return [self.get_status(os.path.join(p, c)) for c in sorted(children)]

    def get_status(self, path: str) -> FileStatus:
        p = self._norm(path)
        with self._lock:
            if p in self._files:
                return FileStatus(p, len(self._files[p]), self._mtimes.get(p, 0), False)
            return FileStatus(p, 0, 0, True)

    def delete(self, path: str, recursive: bool = False) -> None:
        p = self._norm(path)
        with self._lock:
            self._files.pop(p, None)
            self._mtimes.pop(p, None)
            self._dirs.discard(p)
            if recursive:
                prefix = p + os.sep
                for f in [f for f in self._files if f.startswith(prefix)]:
                    del self._files[f]
                    self._mtimes.pop(f, None)
                self._dirs = {d for d in self._dirs if not d.startswith(prefix)}

    def rename(self, src: str, dst: str) -> bool:
        s, d = self._norm(src), self._norm(dst)
        with self._lock:
            if d in self._files or d in self._dirs:
                return False
            if s in self._files:
                self._files[d] = self._files.pop(s)
                self._mtimes[d] = self._mtimes.pop(s, 0)
                return True
            if s in self._dirs or self.is_dir(s):
                prefix = s + os.sep
                for f in [f for f in self._files if f.startswith(prefix)]:
                    self._files[d + f[len(s):]] = self._files.pop(f)
                    self._mtimes[d + f[len(s):]] = self._mtimes.pop(f, 0)
                moved = {x for x in self._dirs if x == s or x.startswith(prefix)}
                self._dirs = (self._dirs - moved) | {d + x[len(s):] for x in moved} | {d}
                return True
            return False

    def read_bytes(self, path: str) -> bytes:
        p = self._norm(path)
        with self._lock:
            if p not in self._files:
                raise FileNotFoundError(path)
            return self._files[p]

    def write_bytes(self, path: str, data: bytes) -> None:
        p = self._norm(path)
        with self._lock:
            self._files[p] = data
            self._mtimes[p] = int(time.time() * 1000)
            parent = os.path.dirname(p)
            if parent:
                self.mkdirs(parent)

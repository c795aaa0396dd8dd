"""Versioned index-data directories (reference `index/IndexDataManager.scala:38-73`):
data lives under `<indexRoot>/v__=<n>/`; `delete` removes one version
directory (vacuum)."""

from __future__ import annotations

import os
from typing import List, Optional

from ..config import IndexConstants
from ..storage.filesystem import FileSystem, LocalFileSystem


class IndexDataManager:
    """The contract (reference `IndexDataManager.scala:26-36`)."""

    def get_latest_version_id(self) -> Optional[int]:
        raise NotImplementedError

    def get_path(self, version_id: int) -> str:
        raise NotImplementedError

    def delete(self, version_id: int) -> None:
        raise NotImplementedError


class IndexDataManagerImpl(IndexDataManager):
    def __init__(self, index_path: str, fs: Optional[FileSystem] = None):
        self._index_path = index_path
        self._fs = fs or LocalFileSystem()

    def _version_ids(self) -> List[int]:
        if not self._fs.exists(self._index_path):
            return []
        prefix = IndexConstants.INDEX_VERSION_DIR_PREFIX + "="
        out = []
        for st in self._fs.list_status(self._index_path):
            if st.is_dir and st.name.startswith(prefix) and st.name[len(prefix):].isdigit():
                out.append(int(st.name[len(prefix):]))
        return out

    def get_latest_version_id(self) -> Optional[int]:
        ids = self._version_ids()
        return max(ids) if ids else None

    def get_path(self, version_id: int) -> str:
        return os.path.join(
            self._index_path, f"{IndexConstants.INDEX_VERSION_DIR_PREFIX}={version_id}"
        )

    def delete(self, version_id: int) -> None:
        path = self.get_path(version_id)
        if self._fs.exists(path):
            self._fs.delete(path, recursive=True)

"""Index path resolution (reference `index/PathResolver.scala:30-106`): the
system root (`hyperspace.system.path`, default `<warehouse>/indexes`) and the
per-index path, matched case-insensitively against existing directories."""

from __future__ import annotations

import os
from typing import Optional

from ..config import IndexConstants, SessionConf
from ..storage.filesystem import LocalFileSystem

DEFAULT_INDEX_SYSTEM_DIR = "indexes"


class PathResolver:
    def __init__(self, conf: SessionConf, fs: Optional[LocalFileSystem] = None, warehouse: str = "."):
        self._conf = conf
        self._fs = fs or LocalFileSystem()
        self._warehouse = warehouse

    def system_path(self) -> str:
        p = self._conf.get(IndexConstants.INDEX_SYSTEM_PATH)
        if p:
            return p
        return os.path.join(self._warehouse, DEFAULT_INDEX_SYSTEM_DIR)

    def get_index_path(self, name: str) -> str:
        root = self.system_path()
        if self._fs.exists(root):
            for st in self._fs.list_status(root):
                if st.is_dir and st.name.lower() == name.lower():
                    return st.path
        return os.path.join(root, name)

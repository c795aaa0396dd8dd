"""The seams that make the log and data managers and their filesystem
(`hyperspace_tpu/index/factories.py`, reference `index/factories.scala:23-50`).
Tests inject their own through `IndexCollectionManager`'s arguments, as the
reference's tests inject mocked factories."""

from __future__ import annotations

from typing import Optional

from ..storage.filesystem import FileSystem, LocalFileSystem
from .data_manager import IndexDataManager, IndexDataManagerImpl
from .log_manager import IndexLogManager, IndexLogManagerImpl


class FileSystemFactory:
    def create(self, path: str) -> FileSystem:
        """The backend by the path's scheme (`FileSystemFactory.create(path)`):
        a remote protocol (memory://, s3://, ...) gets the fsspec adapter,
        anything else the local disk."""
        from ..storage.remote import filesystem_for_path

        remote = filesystem_for_path(path)
        return remote if remote is not None else LocalFileSystem()


class IndexLogManagerFactory:
    def create(self, index_path: str, fs: Optional[FileSystem] = None) -> IndexLogManager:
        return IndexLogManagerImpl(index_path, fs)


class IndexDataManagerFactory:
    def create(self, index_path: str, fs: Optional[FileSystem] = None) -> IndexDataManager:
        return IndexDataManagerImpl(index_path, fs)

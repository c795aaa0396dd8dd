from .filesystem import FileStatus, FileSystem, InMemoryFileSystem, LocalFileSystem  # noqa: F401

from . import hashing, join  # noqa: F401

"""Path helpers (reference `util/PathUtils.scala:21-38`): the data-path filter
that hides `_*`/`.*` metadata files, except hive-style `key=value` directories."""

from __future__ import annotations

import os


def is_data_path(name: str) -> bool:
    """True if a file/dir name is user data (not `_`/`.`-prefixed metadata)."""
    base = os.path.basename(name.rstrip("/"))
    return not ((base.startswith("_") and "=" not in base) or base.startswith("."))

"""md5 helper of the signature providers (reference `util/HashingUtils.scala:24-34`)."""

from __future__ import annotations

import hashlib
from typing import Any


def md5_hex(obj: Any) -> str:
    """md5 hex digest of the string rendering of `obj` (stable across processes)."""
    return hashlib.md5(str(obj).encode("utf-8")).hexdigest()

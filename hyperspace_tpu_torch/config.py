"""Configuration: the session's flat string-keyed conf and its typed accessors.

Counterpart of `hyperspace_tpu/config.py`, cut to the keys the build → rewrite →
co-bucketed join slice reads. Key names and defaults are the JAX package's, so
a conf written for one package means the same to the other.
"""

from __future__ import annotations

from typing import Dict, Optional


class IndexConstants:
    """Config keys and defaults (reference `index/IndexConstants.scala:21-57`)."""

    INDEX_SYSTEM_PATH = "hyperspace.system.path"

    INDEX_NUM_BUCKETS = "hyperspace.index.num.buckets"
    INDEX_NUM_BUCKETS_DEFAULT = 200  # reference default = spark.sql.shuffle.partitions

    # Bucket hash-scheme version recorded at build time: bucket co-location
    # across independently built indexes needs BUILD and QUERY to hash
    # identically. "1" = ints hashed as int64 bits, floats as float64 bits.
    HASH_SCHEME_KEY = "hashSchemeVersion"
    HASH_SCHEME_VERSION = "1"

    # On-lake layout names (reference `IndexConstants.scala:41-42`).
    HYPERSPACE_LOG = "_hyperspace_log"
    INDEX_VERSION_DIR_PREFIX = "v__"

    # Column-name resolution (the spark.sql.caseSensitive analogue).
    RESOLUTION_CASE_SENSITIVE = "hyperspace.resolution.caseSensitive"
    RESOLUTION_CASE_SENSITIVE_DEFAULT = False


class SessionConf:
    """Flat string-keyed conf map with defaults (the SQLConf analogue)."""

    def __init__(self, initial: Optional[Dict[str, str]] = None):
        self._conf: Dict[str, str] = dict(initial or {})

    def set(self, key: str, value) -> None:
        self._conf[key] = str(value)

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self._conf.get(key, default)

    def get_int(self, key: str, default: int) -> int:
        v = self._conf.get(key)
        return int(v) if v is not None else default

    def get_bool(self, key: str, default: bool) -> bool:
        v = self._conf.get(key)
        if v is None:
            return default
        return v.strip().lower() in ("1", "true", "yes", "on")


class HyperspaceConf:
    """Typed accessors over a SessionConf (reference `util/HyperspaceConf.scala`)."""

    def __init__(self, conf: SessionConf):
        self._c = conf

    @property
    def num_buckets(self) -> int:
        return self._c.get_int(
            IndexConstants.INDEX_NUM_BUCKETS, IndexConstants.INDEX_NUM_BUCKETS_DEFAULT
        )

    @property
    def case_sensitive(self) -> bool:
        return self._c.get_bool(
            IndexConstants.RESOLUTION_CASE_SENSITIVE,
            IndexConstants.RESOLUTION_CASE_SENSITIVE_DEFAULT,
        )

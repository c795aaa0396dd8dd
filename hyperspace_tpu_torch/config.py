"""Configuration: the session's flat string-keyed conf and its typed accessors.

Counterpart of `hyperspace_tpu/config.py`, cut to the keys the ported slices
read (build, JoinIndexRule and the co-bucketed join, FilterIndexRule, the scan
layer, the aggregate, the index lifecycle, refresh, Hybrid Scan, compaction,
data skipping, explain and the device mesh). Key names,
environment variables and defaults are the JAX package's, so a conf or an
environment written for one package means the same to the other.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

#: Row-group pushdown on/off (`engine/pushdown.py`); "0" = whole-file reads.
ENV_SCAN_PUSHDOWN = "HYPERSPACE_SCAN_PUSHDOWN"
#: Byte budget of the per-file scan cache (`engine/scan_cache.py`).
ENV_SCAN_CACHE_BUDGET = "HYPERSPACE_SCAN_CACHE_BUDGET"
SCAN_CACHE_BUDGET_DEFAULT = 1 << 30
#: Budget of each concat cache (bucketed, plain multi-file, filtered); the
#: JAX package reads no variable for it.
CONCAT_CACHE_BUDGET_DEFAULT = 1 << 30
#: Row-group cap of the index bucket files (`engine/io.py`).
ENV_INDEX_ROW_GROUP_ROWS = "HYPERSPACE_INDEX_ROW_GROUP_ROWS"
INDEX_ROW_GROUP_ROWS_DEFAULT = 65536
#: Byte budget of the join memos (`engine/physical.py`), one LRU order.
ENV_DEVICE_CACHE_BUDGET = "HYPERSPACE_DEVICE_CACHE_BUDGET"
DEVICE_CACHE_BUDGET_DEFAULT = 2 << 30
#: The refresh mode `Hyperspace.refresh_index(name)` takes when given none
#: ("full" when unset; also "incremental" or "auto").
ENV_REFRESH_MODE = "HYPERSPACE_REFRESH_MODE"
#: Background-compaction trigger (`actions/optimize.needs_compaction`): an
#: index needs compaction once a bucket is spread over this many files.
ENV_COMPACT_TRIGGER_FILES = "HYPERSPACE_COMPACT_TRIGGER_FILES"
COMPACT_TRIGGER_FILES_DEFAULT = 2


def env_bytes(name: str, default: int) -> int:
    """A byte budget from the environment (unset = `default`)."""
    return int(os.environ.get(name, default))


class IndexConstants:
    """Config keys and defaults (reference `index/IndexConstants.scala:21-57`)."""

    INDEX_SYSTEM_PATH = "hyperspace.system.path"
    # Read by nothing beyond their getters, as in the JAX package.
    INDEX_CREATION_PATH = "hyperspace.index.creation.path"
    INDEX_SEARCH_PATHS = "hyperspace.index.search.paths"

    INDEX_NUM_BUCKETS = "hyperspace.index.num.buckets"
    INDEX_NUM_BUCKETS_DEFAULT = 200  # reference default = spark.sql.shuffle.partitions

    # TTL of the index metadata cache (reference `IndexConstants.scala`;
    # `index/collection_manager.CachingIndexCollectionManager`).
    INDEX_CACHE_EXPIRY_DURATION_SECONDS = "hyperspace.index.cache.expiryDurationInSeconds"
    INDEX_CACHE_EXPIRY_DURATION_SECONDS_DEFAULT = 300
    INDEX_CACHE_TYPE = "hyperspace.index.cache.type"
    INDEX_CACHE_TYPE_DEFAULT = "CREATION_TIME_BASED"

    # Hybrid Scan: an index whose source gained files since its last refresh
    # (or lost files, under lineage) still answers, the appended files merged
    # in at query time (`rules/rule_utils.get_candidate_indexes`).
    INDEX_HYBRID_SCAN_ENABLED = "hyperspace.index.hybridscan.enabled"
    INDEX_HYBRID_SCAN_ENABLED_DEFAULT = False

    # optimize_index "quick" merges only the index files below this size.
    OPTIMIZE_FILE_SIZE_THRESHOLD = "hyperspace.index.optimize.fileSizeThreshold"
    OPTIMIZE_FILE_SIZE_THRESHOLD_DEFAULT = 256 * 1024 * 1024

    # Lineage: the build adds the per-row source file path, which lets an
    # incremental refresh fold deleted source files (`actions/refresh.py`).
    INDEX_LINEAGE_ENABLED = "hyperspace.index.lineage.enabled"
    INDEX_LINEAGE_ENABLED_DEFAULT = False
    DATA_FILE_NAME_COLUMN = "_data_file_name"

    # Bucket hash-scheme version recorded at build time: bucket co-location
    # across independently built indexes needs BUILD and QUERY to hash
    # identically. "1" = ints hashed as int64 bits, floats as float64 bits.
    HASH_SCHEME_KEY = "hashSchemeVersion"
    HASH_SCHEME_VERSION = "1"

    # On-lake layout names (reference `IndexConstants.scala:41-42`).
    HYPERSPACE_LOG = "_hyperspace_log"
    INDEX_VERSION_DIR_PREFIX = "v__"

    # FilterIndexRule reads only the hash bucket(s) of a head-column equality.
    INDEX_FILTER_BUCKET_PRUNING = "hyperspace.index.filter.bucketPruning"
    INDEX_FILTER_BUCKET_PRUNING_DEFAULT = True

    # Data-skipping indexes (`index/dataskipping.py`): the key is read by
    # neither package's build, which writes one sketch file per version.
    DATASKIPPING_TARGET_INDEX_DATA_FILE_SIZE = "hyperspace.index.dataskipping.targetIndexDataFileSize"

    # Explain display modes (reference `IndexConstants.scala:45-52`).
    DISPLAY_MODE = "hyperspace.explain.displayMode"
    HIGHLIGHT_BEGIN_TAG = "hyperspace.explain.displayMode.highlight.beginTag"
    HIGHLIGHT_END_TAG = "hyperspace.explain.displayMode.highlight.endTag"

    # The dotted path of the telemetry event logger class
    # (`telemetry/event_logging.py`); unset = the no-op logger.
    EVENT_LOGGER_CLASS = "hyperspace.eventLoggerClass"

    # Column-name resolution (the spark.sql.caseSensitive analogue).
    RESOLUTION_CASE_SENSITIVE = "hyperspace.resolution.caseSensitive"
    RESOLUTION_CASE_SENSITIVE_DEFAULT = False

    # Devices the build shards over; read by nothing beyond its getter, as in
    # the JAX package (the mesh is the visible devices, `parallel/mesh.py`).
    BUILD_MESH_DEVICES = "hyperspace.build.mesh.devices"

    # Execution over the device mesh (`parallel/`): with more than one
    # visible device, builds exchange rows all-to-all, the general join
    # exchanges for real and co-bucketed joins probe shard by shard.
    DISTRIBUTED_ENABLED = "hyperspace.distributed.enabled"
    DISTRIBUTED_ENABLED_DEFAULT = True
    # Below this many rows one device runs it; tests set 0 to force the mesh.
    DISTRIBUTED_MIN_ROWS = "hyperspace.distributed.minRows"
    DISTRIBUTED_MIN_ROWS_DEFAULT = 65536
    # Hash partitions a device of the general join's exchange.
    DISTRIBUTED_PARTITIONS_PER_DEVICE = "hyperspace.distributed.partitionsPerDevice"
    DISTRIBUTED_PARTITIONS_PER_DEVICE_DEFAULT = 8


class SessionConf:
    """Flat string-keyed conf map with defaults (the SQLConf analogue)."""

    def __init__(self, initial: Optional[Dict[str, str]] = None):
        self._conf: Dict[str, str] = dict(initial or {})

    def set(self, key: str, value) -> None:
        self._conf[key] = str(value)

    def unset(self, key: str) -> None:
        self._conf.pop(key, None)

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

    def copy(self) -> "SessionConf":
        return SessionConf(dict(self._conf))


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
    def lineage_enabled(self) -> bool:
        return self._c.get_bool(
            IndexConstants.INDEX_LINEAGE_ENABLED, IndexConstants.INDEX_LINEAGE_ENABLED_DEFAULT
        )

    @property
    def hybrid_scan_enabled(self) -> bool:
        return self._c.get_bool(
            IndexConstants.INDEX_HYBRID_SCAN_ENABLED, IndexConstants.INDEX_HYBRID_SCAN_ENABLED_DEFAULT
        )

    @property
    def cache_expiry_seconds(self) -> int:
        return self._c.get_int(
            IndexConstants.INDEX_CACHE_EXPIRY_DURATION_SECONDS,
            IndexConstants.INDEX_CACHE_EXPIRY_DURATION_SECONDS_DEFAULT,
        )

    @property
    def cache_type(self) -> str:
        return self._c.get(IndexConstants.INDEX_CACHE_TYPE, IndexConstants.INDEX_CACHE_TYPE_DEFAULT)

    @property
    def system_path(self) -> Optional[str]:
        return self._c.get(IndexConstants.INDEX_SYSTEM_PATH)

    @property
    def search_paths(self) -> Optional[List[str]]:
        v = self._c.get(IndexConstants.INDEX_SEARCH_PATHS)
        return v.split(",") if v else None

    @property
    def build_mesh_devices(self) -> int:
        return self._c.get_int(IndexConstants.BUILD_MESH_DEVICES, 1)

    @property
    def case_sensitive(self) -> bool:
        return self._c.get_bool(
            IndexConstants.RESOLUTION_CASE_SENSITIVE,
            IndexConstants.RESOLUTION_CASE_SENSITIVE_DEFAULT,
        )

    @property
    def event_logger_class(self) -> Optional[str]:
        return self._c.get(IndexConstants.EVENT_LOGGER_CLASS)

    @property
    def distributed_enabled(self) -> bool:
        """`HYPERSPACE_DISTRIBUTED`, read per call, when set ("0" pins the
        single-device path), else the session conf (config.py:196)."""
        env = os.environ.get("HYPERSPACE_DISTRIBUTED")
        if env is not None and env != "":
            return env != "0"
        return self._c.get_bool(IndexConstants.DISTRIBUTED_ENABLED, IndexConstants.DISTRIBUTED_ENABLED_DEFAULT)

    @property
    def distributed_min_rows(self) -> int:
        return self._c.get_int(IndexConstants.DISTRIBUTED_MIN_ROWS, IndexConstants.DISTRIBUTED_MIN_ROWS_DEFAULT)

    @property
    def partitions_per_device(self) -> int:
        """At least 1: a zero would reach the exchange as a zero modulus."""
        return max(1, self._c.get_int(IndexConstants.DISTRIBUTED_PARTITIONS_PER_DEVICE,
                                      IndexConstants.DISTRIBUTED_PARTITIONS_PER_DEVICE_DEFAULT))

    @property
    def filter_bucket_pruning(self) -> bool:
        return self._c.get_bool(
            IndexConstants.INDEX_FILTER_BUCKET_PRUNING,
            IndexConstants.INDEX_FILTER_BUCKET_PRUNING_DEFAULT,
        )

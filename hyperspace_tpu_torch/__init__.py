"""hyperspace_tpu_torch: the PyTorch/CUDA port of hyperspace_tpu.

A second package beside the JAX reference, ported slice by slice. It runs the
paper's core loop on an NVIDIA GPU: create covering indexes (hash-bucketed,
sorted parquet plus the JSON operation log) over numeric, dictionary-string
and nullable columns; let `JoinIndexRule` rewrite an equi-join over two
indexed relations into a shuffle-free co-bucketed merge join, and
`FilterIndexRule` rewrite a filter into a scan of the index's matching hash
buckets, whose parquet row groups are pruned by their footer zone maps; feed
the join into computed columns and a grouped aggregate. Data-skipping
indexes (MinMax and bloom sketches per source file) let
`DataSkippingFilterRule` drop files from a filtered scan. Sources are parquet,
CSV, JSON-lines and ORC directories, Hive-partitioned or not, and
Delta-style tables (`read.delta`, `write_delta`). Frames union,
intersect, subtract and deduplicate on the device, compute host-evaluated
user functions (`udf`), register as named views, explain their plans with
indexes and without, and serialize their logical plans (`serde`). Scans and
the join's device work are cached across queries. Indexes are refreshed
(full, incremental with lineage delete folding, auto), compacted, deleted,
restored, vacuumed and cancelled through the JAX package's operation log,
kept on the local disk or any fsspec store (`index/factories.py`).
The sorts and searches on that path are hand-written CUDA kernels (`csrc/`).
Many tenants' concurrent queries run through `Hyperspace.server()` (a
`QueryServer`: priority lanes, admission, single-flight caches, SLOs, and
with `HYPERSPACE_REPLICAS=1` a fleet of processes over one lake).
Tables live on the session's device, CUDA by default. The package imports
torch, numpy and pyarrow, never jax or hyperspace_tpu. Its public surface is
the JAX package's, module by module: a program written for hyperspace_tpu
runs here once its imports name hyperspace_tpu_torch, apart from the JAX-only
machinery the README lists.
"""

from .config import HyperspaceConf, IndexConstants, SessionConf  # noqa: F401
from .engine.expr import col, lit, udf  # noqa: F401
from .engine.session import DataFrame, HyperspaceSession  # noqa: F401
from .exceptions import (  # noqa: F401
    AdmissionRejectedError,
    CompileTimeoutError,
    ConcurrentWriteError,
    CorruptIndexError,
    HyperspaceException,
    LogCommitError,
    PermanentError,
    QueryTimeoutError,
    RetryBudgetExceededError,
    TransientError,
)
from .hyperspace import (  # noqa: F401
    Hyperspace,
    disable_hyperspace,
    enable_hyperspace,
    is_hyperspace_enabled,
)
from .index.dataskipping import BloomFilterSketch, DataSkippingIndexConfig, MinMaxSketch  # noqa: F401
from .index.index_config import IndexConfig  # noqa: F401


def __getattr__(name):
    # The serving layer loads on first use.
    if name == "QueryServer":
        from .serve import QueryServer

        return QueryServer
    raise AttributeError(name)

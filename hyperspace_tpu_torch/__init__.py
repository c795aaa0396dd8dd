"""hyperspace_tpu_torch: the PyTorch/CUDA port of hyperspace_tpu.

A second package beside the JAX reference, ported slice by slice. This slice
runs the paper's core loop on an NVIDIA GPU: create covering indexes
(hash-bucketed, sorted parquet plus the JSON operation log), let
`JoinIndexRule` rewrite an equi-join over two indexed relations, and execute
it as a shuffle-free co-bucketed merge join whose in-bucket sort and range
probe are hand-written CUDA kernels (`csrc/`). Tables live on the session's
device, CUDA by default. The package imports torch, numpy and pyarrow, never
jax or hyperspace_tpu.
"""

from .config import IndexConstants, SessionConf  # noqa: F401
from .engine.expr import col  # noqa: F401
from .engine.session import DataFrame, HyperspaceSession  # noqa: F401
from .exceptions import HyperspaceException  # noqa: F401
from .hyperspace import (  # noqa: F401
    Hyperspace,
    enable_hyperspace,
    is_hyperspace_enabled,
)
from .index.index_config import IndexConfig  # noqa: F401

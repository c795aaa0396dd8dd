"""The device mesh: the build's all-to-all exchange, the general join's real
ShuffleExchange and the sharded co-bucketed probe (counterpart of
`hyperspace_tpu/parallel/`). One process drives every shard (`mesh.py`)."""

from .mesh import (  # noqa: F401
    BUCKET_AXIS,
    Mesh,
    make_mesh,
    mesh_row_quantum,
    quantize_cap,
    quantized_rows,
    shard_rows,
    virtual_devices,
    visible_devices,
)
from .distributed import (  # noqa: F401
    all_to_all,
    distributed_bucketed_join_counts,
    distributed_bucketize,
    distributed_bucketize_coded,
    exchange_counts,
    exchange_counts_coded,
    exchange_rows,
)
from .table_ops import (  # noqa: F401
    DIST_JOIN_STATS,
    DistBlocks,
    build_dist_blocks,
    distributed_bucketed_join_pairs,
    distributed_bucketize_perm,
    distributed_bucketize_table,
    distributed_exchange_table,
    probe_dist_blocks,
)

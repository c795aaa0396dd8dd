"""Build (`actions/create.py`, `index/build_pipeline.py`, `ops/partition.py`):
the set-up's `create_index` walls, each ended by a device synchronization,
summed, in seconds."""


def read(run):
    return sum(run.index_build_s.values()) if run.index_build_s else None

"""CoveringIndexBuilder: the engine side of index creation.

Counterpart of `hyperspace_tpu/index/builder.py`'s serial route
(`HYPERSPACE_BUILD_DECODE_THREADS=1`, the order the JAX package pins its
pipelined and mesh builds to): read the indexed + included columns onto the
device, bucketize (hash + stable in-bucket sort, `ops/partition.py`), write one
`part-<bucket>.parquet` per non-empty bucket with bounded row groups, inside a
staging directory committed by one rename. `derive_log_entry` (:265) builds
the same metadata record, field for field.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List

from ..actions.create import IndexerBuilder
from ..config import IndexConstants
from ..engine import io as engine_io
from ..engine.logical import ScanNode
from ..engine.schema import Field, Schema
from ..exceptions import HyperspaceException
from ..ops.partition import bucketize_table
from ..util.resolver_utils import resolve_all
from .index_config import IndexConfig
from .log_entry import (
    Content,
    CoveringIndexProperties,
    Directory,
    IndexLogEntry,
    LogicalPlanFingerprint,
    Relation,
    Signature,
    Source,
    SourcePlanProperties,
)
from .signatures import create_provider
from .staging import stage_commit

_WRITERS = 8


class CoveringIndexBuilder(IndexerBuilder):
    def __init__(self, session):
        self._session = session

    def validate_source(self, df, index_config: IndexConfig) -> None:
        if not isinstance(df.plan, ScanNode):
            raise HyperspaceException("Only creating index over a plain relation scan is supported.")
        names = df.plan.output_schema.names
        cs = self._session.hs_conf.case_sensitive
        for group in (index_config.indexed_columns, index_config.included_columns):
            if resolve_all(group, names, cs) is None:
                raise HyperspaceException(
                    f"Index config columns {group} could not be resolved against "
                    f"dataframe columns {names}."
                )

    def _resolved_columns(self, df, index_config: IndexConfig):
        names = df.plan.output_schema.names
        cs = self._session.hs_conf.case_sensitive
        return (
            resolve_all(index_config.indexed_columns, names, cs),
            resolve_all(index_config.included_columns, names, cs),
        )

    def write(self, df, index_config: IndexConfig, index_data_path: str) -> None:
        with stage_commit(index_data_path) as stage:
            self._write_serial(df, index_config, stage)

    def _write_serial(self, df, index_config: IndexConfig, index_data_path: str) -> None:
        indexed, included = self._resolved_columns(df, index_config)
        rel = df.plan.relation
        table = engine_io.read_files(
            [f.path for f in rel.files], rel.file_format, indexed + included, self._session.device
        )
        num_buckets = self._session.hs_conf.num_buckets
        sorted_table, starts = bucketize_table(table, indexed, num_buckets)
        host = sorted_table.to("cpu")
        os.makedirs(index_data_path, exist_ok=True)

        def write_bucket(b: int) -> None:
            lo, hi = int(starts[b]), int(starts[b + 1])
            if hi <= lo:
                return  # empty bucket: no file
            engine_io.write_parquet(
                host.slice(lo, hi),
                os.path.join(index_data_path, f"part-{b:05d}.parquet"),
                row_group_rows=engine_io.INDEX_ROW_GROUP_ROWS,
            )

        # Parquet encode releases the GIL: bucket files are written concurrently.
        with ThreadPoolExecutor(max_workers=_WRITERS) as pool:
            list(pool.map(write_bucket, range(num_buckets)))

    def _index_schema(self, df, index_config: IndexConfig) -> Schema:
        indexed, included = self._resolved_columns(df, index_config)
        src = df.plan.output_schema
        fields: List[Field] = [src.field(n) for n in indexed + included]
        return Schema(fields)

    def derive_log_entry(
        self, df, index_config: IndexConfig, index_path: str, index_data_path: str
    ) -> IndexLogEntry:
        rel = df.plan.relation
        provider = create_provider()
        sig = provider.signature(df.plan)
        if sig is None:
            raise HyperspaceException("Signature provider does not support this plan.")
        indexed, included = self._resolved_columns(df, index_config)
        relation = Relation(
            root_paths=list(rel.root_paths),
            data=Content(Directory.from_leaf_files("/", rel.files)),
            data_schema_json=rel.schema.to_json_string(),
            file_format=rel.file_format,
            options=dict(rel.options),
        )
        return IndexLogEntry(
            name=index_config.index_name,
            derived_dataset=CoveringIndexProperties(
                indexed_columns=indexed,
                included_columns=included,
                schema_json=self._index_schema(df, index_config).to_json_string(),
                num_buckets=self._session.hs_conf.num_buckets,
                properties={IndexConstants.HASH_SCHEME_KEY: IndexConstants.HASH_SCHEME_VERSION},
            ),
            content=Content.from_directory(index_data_path, self._session.fs),
            source=Source(
                SourcePlanProperties(
                    relations=[relation],
                    fingerprint=LogicalPlanFingerprint(signatures=[Signature(provider.name, sig)]),
                )
            ),
        )

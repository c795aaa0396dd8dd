"""CoveringIndexBuilder: the engine side of index creation.

Counterpart of `hyperspace_tpu/index/builder.py`. `write` has one route,
inside a staging directory committed by one rename: read the indexed and
included columns onto the session's device (`_index_table`, through
`io.read_files`: the deadline check, the single-flight scan and the
concat-cache insert), then `build_pipeline.pipelined_write` sorts by
(bucket, keys, row), gathers, copies the sorted columns to the host in
bucket-aligned ranges and writes one `part-<bucket>.parquet` per non-empty
bucket with bounded row groups on the writer pool, the copies overlapped
with the writes. Each build records its stages
(`telemetry.profiling.last_build_stages()`). Where the session has a device
mesh for the build (`_mesh_may_apply`, then `mesh_for` of the decoded
rows), the sort stage is the mesh's all-to-all exchange. `derive_log_entry`
(:265) builds the same metadata record, field for field. With lineage on
(`hyperspace.index.lineage.enabled`) the source files are read in inventory
order, and each row gets its file's path in the `_data_file_name` string
column (:79-107), which lets a refresh fold deleted source files; the
partition columns of a Hive-partitioned source that the config leaves out
are indexed too, between the configured columns and the lineage column.
"""

from __future__ import annotations

import os
from typing import List

from ..actions.create import IndexerBuilder
from ..config import IndexConstants
from ..engine import io as engine_io
from ..engine.logical import ScanNode, SourceRelation
from ..engine.physical import lineage_column, partitions_of
from ..engine.schema import STRING, Field, Schema
from ..engine.table import Table
from ..exceptions import HyperspaceException
from ..util.resolver_utils import resolve_all
from . import build_pipeline
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

#: Parquet writers of a build or a compaction (`build_pipeline.py:79`):
#: "1" writes the buckets one after another, in bucket order.
ENV_WRITERS = "HYPERSPACE_BUILD_WRITERS"
_DEFAULT_WRITERS = 8


def build_writers() -> int:
    try:
        return max(1, int(os.environ.get(ENV_WRITERS, "") or _DEFAULT_WRITERS))
    except ValueError:
        return _DEFAULT_WRITERS


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
        indexed, _ = self._resolved_columns(df, index_config)
        rel = df.plan.relation
        mesh_for = self._session.mesh_for if self._mesh_may_apply(rel) else None
        with stage_commit(index_data_path) as stage:
            build_pipeline.pipelined_write(
                lambda: self._index_table(df, index_config), indexed, self._session.hs_conf.num_buckets, stage,
                self._session.device, build_writers(), len(rel.files), mesh_for,
            )

    def _mesh_may_apply(self, rel: SourceRelation) -> bool:
        """Whether the mesh build could take this source, decided before
        decoding (builder.py:230): not with distribution off or one visible
        device; for parquet and Delta sources, by the footers' row counts;
        for other formats (or unreadable footers) yes, and `mesh_for` of the
        decoded row count decides."""
        from ..parallel.mesh import visible_devices

        if not self._session.hs_conf.distributed_enabled or len(visible_devices(self._session.device)) < 2:
            return False
        if rel.file_format not in ("parquet", "delta"):
            return True
        try:
            import pyarrow.parquet as pq

            est = sum(pq.ParquetFile(f.path).metadata.num_rows for f in rel.files)
        except (OSError, ValueError):  # no readable footer (pyarrow's errors derive from these)
            return True
        return self._session.mesh_for(est) is not None

    @staticmethod
    def _missing_partition_columns(rel: SourceRelation, wanted: List[str]) -> List[str]:
        """Partition columns not already selected: lineage mode indexes them
        so that a lineage row maps back to its source partition (reference
        `CreateActionBase.scala:176-188`)."""
        if rel.partition_spec is None:
            return []
        have = {w.lower() for w in wanted}
        return [c for c in rel.partition_spec.columns if c.lower() not in have]

    def _index_table(self, df, index_config: IndexConfig) -> Table:
        """The indexed + included columns on the device, and with lineage on
        the missing partition columns and `_data_file_name`."""
        indexed, included = self._resolved_columns(df, index_config)
        rel = df.plan.relation
        wanted = indexed + included
        device = self._session.device
        partitions = partitions_of(rel)
        if not self._session.hs_conf.lineage_enabled:
            return engine_io.read_files([f.path for f in rel.files], rel.file_format, wanted, device,
                                        partitions=partitions)
        wanted = wanted + self._missing_partition_columns(rel, wanted)
        paths = [f.path for f in rel.files]
        t, counts = engine_io.read_in_order(paths, rel.file_format, wanted, device, partitions)
        return Table({**t.columns, IndexConstants.DATA_FILE_NAME_COLUMN: lineage_column(paths, counts, device)})

    def _index_schema(self, df, index_config: IndexConfig) -> Schema:
        indexed, included = self._resolved_columns(df, index_config)
        src = df.plan.output_schema
        fields: List[Field] = [src.field(n) for n in indexed + included]
        if self._session.hs_conf.lineage_enabled:
            for p in self._missing_partition_columns(df.plan.relation, indexed + included):
                fields.append(src.field(p))
            fields.append(Field(IndexConstants.DATA_FILE_NAME_COLUMN, STRING))
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

    def reconstruct_df(self, relation: Relation):
        """The source again, over the logged root paths, by the logged format:
        listed anew (partitions discovered anew), or a delta table's current
        snapshot (`builder.py:307-320`)."""
        reader = self._session.read
        readers = {"parquet": reader.parquet, "csv": reader.csv, "json": reader.json, "orc": reader.orc,
                   "delta": reader.delta}
        if relation.file_format not in readers:
            raise HyperspaceException(f"Unsupported file format: {relation.file_format}")
        return readers[relation.file_format](*relation.root_paths)

    def restrict_df_to_files(self, df, file_paths):
        """The same relation limited to `file_paths` (the files an incremental
        refresh indexes); a delta table's files are read as the parquet
        files they are (:322-336)."""
        from ..engine.session import DataFrame

        rel = df.plan.relation
        wanted = set(file_paths)
        sub = SourceRelation(
            root_paths=list(rel.root_paths),
            file_format="parquet" if rel.file_format == "delta" else rel.file_format,
            schema=rel.schema,
            files=[f for f in rel.files if f.path in wanted],
            options=dict(rel.options),
            partition_spec=rel.partition_spec,
        )
        return DataFrame(self._session, ScanNode(sub))

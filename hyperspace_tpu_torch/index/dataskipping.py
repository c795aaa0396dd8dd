"""Data-skipping indexes: per-source-file sketches that prune files from scans.

Counterpart of `hyperspace_tpu/index/dataskipping.py` (BASELINE.md config 4).
Two sketch types:

- `MinMaxSketch(col)`: each file's [min, max] of the column, for range and
  equality filters; `granularity="rowgroup"` also records each row group's
  zone from the file's parquet footer.
- `BloomFilterSketch(col, num_bits, num_hashes)`: each file's bloom filter of
  the column's values, for equality and IN filters.

The build reads each source file onto the session's device: min and max are
torch reductions there, and the bloom bitset is the join path's two murmur
lanes (`ops/hashing.column_hash_u32`, seeds `_SEED1` / `_SEED2`) combined as
`(h1 + i*h2) % num_bits` in int64 (each lane is below 2^32, so the sum fits)
and scattered into a `uint8` tensor. The JAX package computes this with
`jnp` outside any Pallas kernel, so no CUDA kernel stands behind it here
either. The sketches persist as one parquet file per index version (bloom
bitsets hex-encoded) under a covering-index log entry of
kind="DataSkippingIndex".

The sketch file's bytes equal the JAX package's, except where its sketch is
unsound and the port keeps every file that can hold a match:

- a float column's min and max are taken over its non-NaN values (the JAX
  package's NaN min prunes a file that holds a match); an all-NaN file
  records NaN, and a NaN bound always keeps (`data_skipping_rule`);
- a string column's min and max are the smallest and largest of the values
  present, nulls excluded, or null when every value is null (always keeps);
  the JAX package raises there.

A nullable numeric column's null slots hold the fill 0, which enters the
min and max as in the JAX package: a wider range, never a wrong one.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..actions.create import IndexerBuilder
from ..config import IndexConstants
from ..engine import io as engine_io
from ..engine.logical import ScanNode
from ..engine.physical import partitions_of
from ..engine.schema import STRING, Schema
from ..engine.table import Column, Table
from ..exceptions import HyperspaceException
from ..ops.hashing import _SEED1, _SEED2, column_hash_u32, host_hash_dictionary
from ..util.resolver_utils import resolve_all
from .builder import CoveringIndexBuilder
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
    register_entry_kind,
)
from .signatures import create_provider
from .staging import stage_commit

DATA_SKIPPING_KIND = "DataSkippingIndex"
FILE_COLUMN = "_file"


class Sketch:
    kind = "Sketch"

    def __init__(self, column: str):
        self.column = column

    def to_json(self) -> dict:
        return {"kind": self.kind, "column": self.column}

    @staticmethod
    def from_json(d: dict) -> "Sketch":
        if d["kind"] == "MinMaxSketch":
            return MinMaxSketch(d["column"], d.get("granularity", "file"))
        if d["kind"] == "BloomFilterSketch":
            return BloomFilterSketch(d["column"], d.get("numBits", 1024), d.get("numHashes", 5))
        raise HyperspaceException(f"Unknown sketch kind: {d['kind']}")


class MinMaxSketch(Sketch):
    """Per-file [min, max]. `granularity="rowgroup"` also records each row
    group's [min, max] from the file's footer (no extra decode): a file whose
    range straddles a literal still prunes when no row group can hold it."""

    kind = "MinMaxSketch"

    def __init__(self, column: str, granularity: str = "file"):
        super().__init__(column)
        if granularity not in ("file", "rowgroup"):
            raise HyperspaceException(f"MinMaxSketch granularity must be 'file' or 'rowgroup': {granularity}")
        self.granularity = granularity

    def to_json(self) -> dict:
        d = super().to_json()
        if self.granularity != "file":
            d["granularity"] = self.granularity
        return d


class BloomFilterSketch(Sketch):
    kind = "BloomFilterSketch"

    def __init__(self, column: str, num_bits: int = 1024, num_hashes: int = 5):
        super().__init__(column)
        self.num_bits = num_bits
        self.num_hashes = num_hashes

    def to_json(self) -> dict:
        d = super().to_json()
        d.update({"numBits": self.num_bits, "numHashes": self.num_hashes})
        return d


class DataSkippingIndexConfig:
    """An index name and its sketches, with the `IndexConfig` surface the
    actions and the manager read."""

    def __init__(self, index_name: str, sketches: Sequence[Sketch]):
        if not index_name or not index_name.strip():
            raise HyperspaceException("Index name cannot be empty.")
        if not sketches:
            raise HyperspaceException("At least one sketch is required.")
        self.index_name = index_name
        self.sketches = list(sketches)

    @property
    def indexed_columns(self) -> List[str]:
        return list(dict.fromkeys(s.column for s in self.sketches))

    @property
    def included_columns(self) -> List[str]:
        return []


# ---------------------------------------------------------------------------
# Sketch computation (device side)
# ---------------------------------------------------------------------------


def _minmax(col: Column):
    """(min, max) of one file's column as Python values (module docstring)."""
    if col.is_string:
        codes = col.data if col.validity is None else col.data[col.validity]
        if codes.numel() == 0:
            return None, None
        lo, hi = torch.aminmax(codes)
        return str(col.dictionary[int(lo)]), str(col.dictionary[int(hi)])
    x = col.data
    if x.dtype == torch.bool:
        lo, hi = torch.aminmax(x.to(torch.uint8))
        return bool(lo), bool(hi)
    if x.is_floating_point():
        x = x[~torch.isnan(x)]
        if x.numel() == 0:
            return float("nan"), float("nan")
    lo, hi = torch.aminmax(x)
    return lo.item(), hi.item()


def bloom_bits(col: Column, num_bits: int, num_hashes: int) -> np.ndarray:
    """The bloom bitset (uint8 0/1, `num_bits` long) of a column's values:
    double hashing h1 + i*h2, one scatter for every row and hash lane."""
    h1 = column_hash_u32(col, _SEED1)
    h2 = column_hash_u32(col, _SEED2)
    i = torch.arange(num_hashes, dtype=torch.int64, device=h1.device)[:, None]
    idx = (h1[None, :] + i * h2[None, :]) % num_bits
    bits = torch.zeros(num_bits, dtype=torch.uint8, device=h1.device)
    bits[idx.reshape(-1)] = 1
    return bits.cpu().numpy()


def literal_hashes(value, column_dtype: str):
    """(h1, h2) of one literal hashed as the column's values were, or None
    when it cannot be hashed so (the probe then keeps the file): a numeric
    literal is cast to the column's dtype first (int 5 and float 5.0 hash
    differently), and a cast that changes the value (5.5 into an int
    column, NaN) or fails gives None; a string column takes only a string
    literal (`dataskipping.bloom_probe` :150-177)."""
    if column_dtype == STRING:
        if not isinstance(value, (str, np.str_)):
            return None
        d = np.asarray([str(value)])
        return int(host_hash_dictionary(d, _SEED1)[0]), int(host_hash_dictionary(d, _SEED2)[0])
    try:
        cast = np.asarray([value], dtype=np.dtype(column_dtype))
        if cast[0] != value:
            return None
    except (ValueError, OverflowError, TypeError):
        return None
    t = torch.from_numpy(cast)
    return int(column_hash_u32(t, _SEED1)[0]), int(column_hash_u32(t, _SEED2)[0])


def bloom_positions(hashes, num_bits: int, num_hashes: int) -> List[int]:
    h1, h2 = hashes
    return [(h1 + i * h2) % num_bits for i in range(num_hashes)]


def bloom_probe(bits: np.ndarray, value, column_dtype: str, num_hashes: int) -> bool:
    """Whether one file's bloom bits may hold `value` (`dataskipping.bloom_probe`
    :150): the rule's probe (`literal_hashes`, `bloom_positions`) for one
    literal; True (keep the file) when the literal cannot be hashed as the
    column's values were."""
    hashes = literal_hashes(value, column_dtype)
    if hashes is None:
        return True
    return bool(np.asarray(bits)[bloom_positions(hashes, len(bits), num_hashes)].all())


def row_group_zones(path: str, file_format: str, column: str) -> list:
    """Each row group's [min, max] of one source file's column from its
    parquet footer (no decode): a list of 2-lists, None for a zone without
    statistics (it always keeps). [] when the file has no usable footer or
    no such column: the sketch then prunes by its file range alone."""
    meta = engine_io.footer_metadata(path, file_format)
    if meta is None:
        return []
    ci = [n for n in meta.names if n.lower() == column.lower()]
    name = column if column in meta.names else (ci[0] if len(ci) == 1 else None)
    if name is None:
        return []
    zones = []
    for rg in meta.row_groups:
        st = rg.stats.get(name)
        if st is None or not st.has_minmax:
            zones.append(None)
        else:
            mn = st.mn.item() if hasattr(st.mn, "item") else st.mn
            mx = st.mx.item() if hasattr(st.mx, "item") else st.mx
            zones.append([mn, mx])
    return zones


def bits_to_hex(bits: np.ndarray) -> str:
    return np.packbits(bits.astype(np.uint8)).tobytes().hex()


def hex_to_bits(s: str, num_bits: int) -> np.ndarray:
    return np.unpackbits(np.frombuffer(bytes.fromhex(s), dtype=np.uint8))[:num_bits]


# ---------------------------------------------------------------------------
# Builder (the covering index's create / refresh actions drive it)
# ---------------------------------------------------------------------------


class DataSkippingIndexBuilder(IndexerBuilder):
    def __init__(self, session):
        self._session = session

    def validate_source(self, df, index_config: DataSkippingIndexConfig) -> None:
        if not isinstance(df.plan, ScanNode):
            raise HyperspaceException("Only creating index over a plain relation scan is supported.")
        names = df.plan.output_schema.names
        if resolve_all(index_config.indexed_columns, names, self._session.hs_conf.case_sensitive) is None:
            raise HyperspaceException(
                f"Sketch columns {index_config.indexed_columns} could not be resolved "
                f"against dataframe columns {names}."
            )

    def write(self, df, index_config: DataSkippingIndexConfig, index_data_path: str) -> None:
        # The covering build's crash-safe staged commit: the sketch file
        # lands by one atomic rename, never as a partial visible write.
        with stage_commit(index_data_path) as stage:
            self._write_sketches(df, index_config, stage)

    def _write_sketches(self, df, index_config: DataSkippingIndexConfig, index_data_path: str) -> None:
        """One row per source file, in inventory order: `_file`, then per
        sketch `min_<c>` / `max_<c>` (and `rgzm_<c>`, the row-group zones as
        JSON) or `bloom_<c>` (hex)."""
        rel = df.plan.relation
        cols = list(dict.fromkeys(s.column for s in index_config.sketches))
        rows: Dict[str, list] = {FILE_COLUMN: []}
        partitions = partitions_of(rel)
        for f in rel.files:
            t = engine_io.read_files([f.path], rel.file_format, cols, self._session.device, partitions=partitions)
            rows[FILE_COLUMN].append(f.path)
            for s in index_config.sketches:
                c = t.column(s.column)
                if isinstance(s, MinMaxSketch):
                    mn, mx = _minmax(c)
                    rows.setdefault(f"min_{s.column}", []).append(mn)
                    rows.setdefault(f"max_{s.column}", []).append(mx)
                    if s.granularity == "rowgroup":
                        zones = row_group_zones(f.path, rel.file_format, s.column)
                        rows.setdefault(f"rgzm_{s.column}", []).append(json.dumps(zones))
                elif isinstance(s, BloomFilterSketch):
                    bits = bloom_bits(c, s.num_bits, s.num_hashes)
                    rows.setdefault(f"bloom_{s.column}", []).append(bits_to_hex(bits))
        # A string bound of None (an all-null file) makes its column an
        # object array, whose None entries become nulls.
        engine_io.write_parquet(Table.from_pydict(rows, "cpu"), os.path.join(index_data_path, "part-00000.parquet"))

    def derive_log_entry(
        self, df, index_config: DataSkippingIndexConfig, index_path: str, index_data_path: str
    ) -> IndexLogEntry:
        rel = df.plan.relation
        provider = create_provider()
        sig = provider.signature(df.plan)
        if sig is None:
            raise HyperspaceException("Signature provider does not support this plan.")
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
                indexed_columns=index_config.indexed_columns,
                included_columns=[],
                schema_json=Schema([]).to_json_string(),
                num_buckets=1,
                properties={
                    "sketches": json.dumps([s.to_json() for s in index_config.sketches]),
                    IndexConstants.HASH_SCHEME_KEY: IndexConstants.HASH_SCHEME_VERSION,
                },
            ),
            content=Content.from_directory(index_data_path, self._session.fs),
            source=Source(
                SourcePlanProperties(
                    relations=[relation],
                    fingerprint=LogicalPlanFingerprint(signatures=[Signature(provider.name, sig)]),
                )
            ),
            kind=DATA_SKIPPING_KIND,
        )

    def reconstruct_df(self, relation: Relation):
        return CoveringIndexBuilder(self._session).reconstruct_df(relation)

    def restrict_df_to_files(self, df, file_paths):
        return CoveringIndexBuilder(self._session).restrict_df_to_files(df, file_paths)

    def config_from_entry(self, entry: IndexLogEntry) -> DataSkippingIndexConfig:
        return DataSkippingIndexConfig(entry.name, sketches_of(entry))


def sketches_of(entry: IndexLogEntry) -> List[Sketch]:
    raw = entry.derived_dataset.properties.get("sketches", "[]")
    return [Sketch.from_json(d) for d in json.loads(raw)]


register_entry_kind(DATA_SKIPPING_KIND, IndexLogEntry.from_json)

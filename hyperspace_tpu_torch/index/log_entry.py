"""Index metadata model: the operation-log record and the on-lake file inventory.

Parity: reference `index/LogEntry.scala:22-47` (abstract versioned record) and
`index/IndexLogEntry.scala` (the full metadata record: CoveringIndex properties, Content
file tree, Source relations with plan fingerprint). The JSON layout mirrors the
reference's spec example (`IndexLogEntryTest.scala:69`) in spirit: polymorphic decode on a
version field, nested `content`/`source` trees, value-equality on
config+signature+content+source+state.

Counterpart of `hyperspace_tpu/index/log_entry.py`: the field names and the
layout are the same, so either package reads the other's operation log.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..storage.filesystem import FileStatus, LocalFileSystem
from ..util.path_utils import is_data_path


# ---------------------------------------------------------------------------
# Content: directory tree of index data files (reference IndexLogEntry.scala:39-228)
# ---------------------------------------------------------------------------


@dataclass
class FileInfo:
    """One leaf file: name, size, modification time (reference `FileInfo`, :221-228)."""

    name: str
    size: int
    modified_time: int

    def to_json(self) -> dict:
        return {"name": self.name, "size": self.size, "modifiedTime": self.modified_time}

    @staticmethod
    def from_json(d: dict) -> "FileInfo":
        return FileInfo(d["name"], d["size"], d["modifiedTime"])


@dataclass
class Directory:
    """A directory node: name, files, subDirs (reference `Directory`)."""

    name: str
    files: List[FileInfo] = field(default_factory=list)
    subdirs: List["Directory"] = field(default_factory=list)

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "files": [f.to_json() for f in self.files],
            "subDirs": [d.to_json() for d in self.subdirs],
        }

    @staticmethod
    def from_json(d: dict) -> "Directory":
        return Directory(
            d["name"],
            [FileInfo.from_json(f) for f in d.get("files", [])],
            [Directory.from_json(s) for s in d.get("subDirs", [])],
        )

    @staticmethod
    def from_directory(path: str, fs: LocalFileSystem) -> "Directory":
        """Build a tree by recursively listing leaf files under ``path``
        (reference `Directory.fromDirectory`, :106-121). Metadata files and
        directories (`_*`, `.*`) are filtered out via the data-path filter applied to
        every path component below the root — so e.g. `_hyperspace_log/0` is never
        inventoried as index data."""
        rootnorm = os.path.normpath(path)

        def is_data_leaf(st) -> bool:
            rel = os.path.relpath(os.path.normpath(st.path), rootnorm)
            return all(is_data_path(part) for part in rel.split(os.sep))

        leaves = [f for f in fs.list_leaf_files(path) if is_data_leaf(f)]
        return Directory.from_leaf_files(path, leaves)

    @staticmethod
    def from_leaf_files(root: str, leaves: List[FileStatus]) -> "Directory":
        """Reconstruct the tree from a flat FileStatus list
        (reference `Directory.fromLeafFiles`, :141-193)."""
        rootnorm = os.path.normpath(root)
        tree = Directory(name=rootnorm)
        for st in leaves:
            rel = os.path.relpath(os.path.normpath(st.path), rootnorm)
            parts = [p for p in rel.split(os.sep) if p and p != "."]
            node = tree
            for part in parts[:-1]:
                child = next((d for d in node.subdirs if d.name == part), None)
                if child is None:
                    child = Directory(name=part)
                    node.subdirs.append(child)
                node = child
            node.files.append(FileInfo(parts[-1], st.size, st.modified_time))
        return tree


@dataclass
class Content:
    """Root of the file inventory; `files` flattens to full paths
    (reference `Content.files`, :42-52)."""

    root: Directory

    def files(self) -> List[str]:
        return [f.name for f in self.file_infos()]

    def file_infos(self) -> List[FileInfo]:
        out: List[FileInfo] = []

        def walk(node: Directory, prefix: str):
            base = node.name if not prefix else os.path.join(prefix, node.name)
            for f in node.files:
                out.append(FileInfo(os.path.join(base, f.name), f.size, f.modified_time))
            for d in node.subdirs:
                walk(d, base)

        walk(self.root, "")
        return sorted(out, key=lambda f: f.name)

    def to_json(self) -> dict:
        return {"root": self.root.to_json()}

    @staticmethod
    def from_json(d: dict) -> "Content":
        return Content(Directory.from_json(d["root"]))

    @staticmethod
    def from_directory(path: str, fs: LocalFileSystem) -> "Content":
        return Content(Directory.from_directory(path, fs))

    @staticmethod
    def from_file_infos(infos: List[FileInfo]) -> "Content":
        """A tree rooted at "/" over absolute-path FileInfos (the merged
        inventory of an index spread over several version directories)."""
        leaves = [FileStatus(f.name, f.size, f.modified_time, False) for f in infos]
        return Content(Directory.from_leaf_files("/", leaves))

    @staticmethod
    def merge(contents: List["Content"]) -> "Content":
        """The union of inventories, each flattened in path order, in the
        order given (`log_entry.Content.merge` :143)."""
        all_infos: List[FileInfo] = []
        for c in contents:
            all_infos.extend(c.file_infos())
        return Content.from_file_infos(all_infos)


# ---------------------------------------------------------------------------
# Source lineage: relations + plan fingerprint (reference IndexLogEntry.scala:242-282)
# ---------------------------------------------------------------------------


@dataclass
class Signature:
    provider: str
    value: str

    def to_json(self) -> dict:
        return {"provider": self.provider, "value": self.value}

    @staticmethod
    def from_json(d: dict) -> "Signature":
        return Signature(d["provider"], d["value"])


@dataclass
class LogicalPlanFingerprint:
    """Fingerprint of the source logical plan (reference `LogicalPlanFingerprint`, :245-250)."""

    kind: str = "LogicalPlan"
    signatures: List[Signature] = field(default_factory=list)

    def to_json(self) -> dict:
        return {
            "kind": self.kind,
            "properties": {"signatures": [s.to_json() for s in self.signatures]},
        }

    @staticmethod
    def from_json(d: dict) -> "LogicalPlanFingerprint":
        return LogicalPlanFingerprint(
            d.get("kind", "LogicalPlan"),
            [Signature.from_json(s) for s in d.get("properties", {}).get("signatures", [])],
        )


@dataclass
class Relation:
    """One source relation: root paths, data file inventory, schema, format, options
    (reference `Relation`, :261-266)."""

    root_paths: List[str]
    data: Content
    data_schema_json: str
    file_format: str
    options: Dict[str, str] = field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "rootPaths": self.root_paths,
            "data": {"properties": {"content": self.data.to_json()}},
            "dataSchemaJson": self.data_schema_json,
            "fileFormat": self.file_format,
            "options": self.options,
        }

    @staticmethod
    def from_json(d: dict) -> "Relation":
        return Relation(
            d["rootPaths"],
            Content.from_json(d["data"]["properties"]["content"]),
            d["dataSchemaJson"],
            d["fileFormat"],
            d.get("options", {}),
        )


@dataclass
class SourcePlanProperties:
    """Plan properties: relations + raw plan + fingerprint (reference `SparkPlan`, :269-279).

    `raw_plan` carries the serialized logical plan when plan persistence is on (the
    reference designed-for-but-dormant serde path, `CreateActionBase.scala:65-70`)."""

    relations: List[Relation]
    raw_plan: Optional[str] = None
    sql: Optional[str] = None
    fingerprint: LogicalPlanFingerprint = field(default_factory=LogicalPlanFingerprint)

    def to_json(self) -> dict:
        return {
            "properties": {
                "relations": [r.to_json() for r in self.relations],
                "rawPlan": self.raw_plan,
                "sql": self.sql,
                "fingerprint": self.fingerprint.to_json(),
            },
            "kind": "QueryPlan",
        }

    @staticmethod
    def from_json(d: dict) -> "SourcePlanProperties":
        p = d["properties"]
        return SourcePlanProperties(
            [Relation.from_json(r) for r in p.get("relations", [])],
            p.get("rawPlan"),
            p.get("sql"),
            LogicalPlanFingerprint.from_json(p["fingerprint"]),
        )


@dataclass
class Source:
    plan: SourcePlanProperties

    def to_json(self) -> dict:
        return {"plan": self.plan.to_json()}

    @staticmethod
    def from_json(d: dict) -> "Source":
        return Source(SourcePlanProperties.from_json(d["plan"]))


# ---------------------------------------------------------------------------
# Derived-dataset (index) properties
# ---------------------------------------------------------------------------


@dataclass
class CoveringIndexProperties:
    """indexed/included columns + schema + bucketing (reference `CoveringIndex`, :231-239)."""

    indexed_columns: List[str]
    included_columns: List[str]
    schema_json: str
    num_buckets: int
    properties: Dict[str, str] = field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "kind": "CoveringIndex",
            "properties": {
                "columns": {
                    "indexed": self.indexed_columns,
                    "included": self.included_columns,
                },
                "schemaJson": self.schema_json,
                "numBuckets": self.num_buckets,
                "properties": self.properties,
            },
        }

    @staticmethod
    def from_json(d: dict) -> "CoveringIndexProperties":
        p = d["properties"]
        return CoveringIndexProperties(
            p["columns"]["indexed"],
            p["columns"]["included"],
            p["schemaJson"],
            p["numBuckets"],
            p.get("properties", {}),
        )


# ---------------------------------------------------------------------------
# LogEntry base + IndexLogEntry (reference LogEntry.scala, IndexLogEntry.scala:285-334)
# ---------------------------------------------------------------------------


class LogEntry:
    """Abstract versioned log record with mutable id/state/timestamp/enabled
    (reference `LogEntry.scala:22-47`)."""

    VERSION = "0.1"

    def __init__(self):
        self.id: int = 0
        self.state: str = ""
        self.timestamp: int = 0
        self.enabled: bool = True

    def base_json(self) -> dict:
        return {
            "version": self.VERSION,
            "id": self.id,
            "state": self.state,
            "timestamp": self.timestamp,
            "enabled": self.enabled,
        }

    @staticmethod
    def from_json(text_or_dict) -> "LogEntry":
        """Polymorphic decode keyed on the version/kind fields
        (reference `LogEntry.fromJson`)."""
        from ..util import json_utils

        d = text_or_dict if isinstance(text_or_dict, dict) else json_utils.from_json(text_or_dict)
        version = d.get("version")
        if version != LogEntry.VERSION:
            raise ValueError(f"Unsupported log entry version: {version!r}")
        kind = d.get("kind", "CoveringIndex")
        decoder = _ENTRY_DECODERS.get(kind)
        if decoder is None:
            raise ValueError(f"Unsupported log entry kind: {kind!r}")
        return decoder(d)


#: `extra` key of the source-file paths whose rows are still in the index data
#: but logically deleted: folded in by an incremental refresh that saw the
#: files vanish (`actions/refresh.RefreshIncrementalAction`), pruned at scan
#: time through the lineage column (`rules.rule_utils.lineage_prune_condition`)
#: and cleared by the next full rewrite.
DELETED_SOURCE_FILES_KEY = "deletedSourceFiles"


class IndexLogEntry(LogEntry):
    """The full index metadata record (reference `IndexLogEntry.scala:285-334`)."""

    def __init__(
        self,
        name: str,
        derived_dataset: CoveringIndexProperties,
        content: Content,
        source: Source,
        extra: Optional[Dict[str, Any]] = None,
        kind: str = "CoveringIndex",
    ):
        super().__init__()
        self.name = name
        self.derived_dataset = derived_dataset
        self.content = content
        self.source = source
        self.extra = dict(extra or {})
        self.kind = kind

    # -- helpers mirroring the reference's accessors ------------------------

    @property
    def schema_json(self) -> str:
        return self.derived_dataset.schema_json

    @property
    def indexed_columns(self) -> List[str]:
        return self.derived_dataset.indexed_columns

    @property
    def included_columns(self) -> List[str]:
        return self.derived_dataset.included_columns

    @property
    def num_buckets(self) -> int:
        return self.derived_dataset.num_buckets

    @property
    def created(self) -> bool:
        return self.state == "ACTIVE"

    @property
    def relations(self) -> List[Relation]:
        return self.source.plan.relations

    def signature(self) -> Signature:
        sigs = self.source.plan.fingerprint.signatures
        if len(sigs) != 1:
            raise ValueError(f"expected exactly one signature, got {len(sigs)}")
        return sigs[0]

    def has_lineage(self) -> bool:
        """Whether the index data carries the per-row source-file lineage
        column, the precondition of delete folding."""
        from ..config import IndexConstants
        from ..engine.schema import Schema

        target = IndexConstants.DATA_FILE_NAME_COLUMN.lower()
        return any(n.lower() == target for n in Schema.from_json_string(self.schema_json).names)

    def deleted_source_files(self) -> List[str]:
        """Source-file paths whose rows remain in the index data but were
        folded as deleted by an incremental refresh."""
        v = self.extra.get(DELETED_SOURCE_FILES_KEY)
        return list(v) if v else []

    def index_location(self) -> str:
        """Root directory of the index data (common prefix of content files — may
        span multiple version dirs after incremental refresh)."""
        files = self.content.files()
        if not files:
            return self.content.root.name
        if len(files) == 1:
            return os.path.dirname(files[0])
        return os.path.commonpath(files)

    # -- serde --------------------------------------------------------------

    def to_json(self) -> dict:
        d = self.base_json()
        d.update(
            {
                "name": self.name,
                "derivedDataset": self.derived_dataset.to_json(),
                "content": self.content.to_json(),
                "source": self.source.to_json(),
                "extra": self.extra,
                "kind": self.kind,
            }
        )
        return d

    @staticmethod
    def from_json(d: dict) -> "IndexLogEntry":
        e = IndexLogEntry(
            d["name"],
            CoveringIndexProperties.from_json(d["derivedDataset"]),
            Content.from_json(d["content"]),
            Source.from_json(d["source"]),
            d.get("extra", {}),
            d.get("kind", "CoveringIndex"),
        )
        e.id = d.get("id", 0)
        e.state = d.get("state", "")
        e.timestamp = d.get("timestamp", 0)
        e.enabled = d.get("enabled", True)
        return e

# Kinds the polymorphic LogEntry decode knows; extension index kinds
# (`index/dataskipping.py`) register themselves.
_ENTRY_DECODERS = {
    "CoveringIndex": IndexLogEntry.from_json,
}


def register_entry_kind(kind: str, decoder) -> None:
    _ENTRY_DECODERS[kind] = decoder


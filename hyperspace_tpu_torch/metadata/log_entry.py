"""The versioned index log entry model.

Reference parity: index/IndexLogEntry.scala:27-131 and index/LogEntry.scala:22-47.
A log entry is a versioned JSON document:

- mutable envelope: id / state / timestamp / enabled (LogEntry.scala:22-29);
- `name`: index name;
- `derivedDataset`: the CoveringIndex spec — indexed columns, included
  columns, schema, numBuckets (IndexLogEntry.scala:39-47);
- `content`: root of the index data (versioned bucket dirs live below it);
- `source`: lineage — the serialized logical plan, its data fingerprint, and
  the list of source files (IndexLogEntry.scala:61-74). Unlike the
  reference's Base64-Kryo blob (the fragile subsystem flagged in SURVEY.md
  §7), the plan here is our own JSON-native plan IR, so `source.plan` is a
  plain JSON object.

Decoding is keyed on `version` (LogEntry.scala:33-46) so future layouts can
coexist in one log directory.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

LOG_ENTRY_VERSION = "0.1"


@dataclasses.dataclass
class FileInfo:
    """One source data file: identity for fingerprinting."""

    path: str
    size: int
    mtime_ns: int

    def to_json(self) -> dict[str, Any]:
        return {"path": self.path, "size": self.size, "mtimeNs": self.mtime_ns}

    @staticmethod
    def from_json(d: dict[str, Any]) -> "FileInfo":
        return FileInfo(d["path"], d["size"], d["mtimeNs"])


@dataclasses.dataclass
class Fingerprint:
    """Signature of the source plan's data (kind + opaque value).

    Reference: LogicalPlanFingerprint / NoOpFingerprint
    (index/IndexLogEntry.scala:96-118)."""

    kind: str
    value: str

    def to_json(self) -> dict[str, Any]:
        return {"kind": self.kind, "value": self.value}

    @staticmethod
    def from_json(d: dict[str, Any]) -> "Fingerprint":
        return Fingerprint(d["kind"], d["value"])


NOOP_FINGERPRINT = Fingerprint(kind="noOp", value="")


@dataclasses.dataclass
class CoveringIndex:
    """The derived dataset spec (index/IndexLogEntry.scala:39-47)."""

    indexed_columns: list[str]
    included_columns: list[str]
    schema: list[dict[str, Any]]  # Schema.to_json() output
    num_buckets: int

    kind = "CoveringIndex"

    def to_json(self) -> dict[str, Any]:
        return {
            "kind": "CoveringIndex",
            "properties": {
                "indexedColumns": self.indexed_columns,
                "includedColumns": self.included_columns,
                "schema": self.schema,
                "numBuckets": self.num_buckets,
            },
        }

    @staticmethod
    def from_json(d: dict[str, Any]) -> "CoveringIndex":
        p = d["properties"]
        return CoveringIndex(
            list(p["indexedColumns"]),
            list(p["includedColumns"]),
            list(p["schema"]),
            int(p["numBuckets"]),
        )

    @property
    def all_columns(self) -> list[str]:
        return list(self.indexed_columns) + list(self.included_columns)


@dataclasses.dataclass
class VectorIndex:
    """Derived dataset for the ANN/embedding covering index (no analog in
    the v0.2 reference; required by BASELINE config 5). Rows are
    partitioned by nearest k-means centroid; a query probes the nprobe
    closest partitions with a matmul + top-k."""

    embedding_column: str
    included_columns: list[str]
    schema: list[dict[str, Any]]  # Schema.to_json() output
    num_partitions: int
    dim: int
    metric: str = "l2"  # l2 | ip | cos

    kind = "VectorIndex"

    def to_json(self) -> dict[str, Any]:
        return {
            "kind": "VectorIndex",
            "properties": {
                "embeddingColumn": self.embedding_column,
                "includedColumns": self.included_columns,
                "schema": self.schema,
                "numPartitions": self.num_partitions,
                "dim": self.dim,
                "metric": self.metric,
            },
        }

    @staticmethod
    def from_json(d: dict[str, Any]) -> "VectorIndex":
        p = d["properties"]
        return VectorIndex(
            p["embeddingColumn"],
            list(p["includedColumns"]),
            list(p["schema"]),
            int(p["numPartitions"]),
            int(p["dim"]),
            p.get("metric", "l2"),
        )

    @property
    def all_columns(self) -> list[str]:
        return [self.embedding_column] + list(self.included_columns)

    # Shared bucket-count vocabulary with CoveringIndex (partition == bucket).
    @property
    def num_buckets(self) -> int:
        return self.num_partitions


@dataclasses.dataclass
class Content:
    """Root of the index data tree (index/IndexLogEntry.scala:49-59)."""

    root: str
    directories: list[str] = dataclasses.field(default_factory=list)

    def to_json(self) -> dict[str, Any]:
        return {"root": self.root, "directories": self.directories}

    @staticmethod
    def from_json(d: dict[str, Any]) -> "Content":
        return Content(d["root"], list(d.get("directories", [])))


@dataclasses.dataclass
class Source:
    """Lineage of the index (index/IndexLogEntry.scala:61-74)."""

    plan: dict[str, Any]  # plan IR JSON (plan/nodes.py serde)
    fingerprint: Fingerprint
    files: list[FileInfo]

    def to_json(self) -> dict[str, Any]:
        return {
            "plan": self.plan,
            "fingerprint": self.fingerprint.to_json(),
            "files": [f.to_json() for f in self.files],
        }

    @staticmethod
    def from_json(d: dict[str, Any]) -> "Source":
        return Source(
            d["plan"],
            Fingerprint.from_json(d["fingerprint"]),
            [FileInfo.from_json(f) for f in d.get("files", [])],
        )


@dataclasses.dataclass
class LogEntry:
    """Mutable envelope common to all log entries (LogEntry.scala:22-29)."""

    id: int = 0
    state: str = ""
    timestamp: float = 0.0
    enabled: bool = True

    def with_state(self, state: str) -> "LogEntry":
        out = dataclasses.replace(self)
        out.state = state
        out.timestamp = time.time()
        return out


@dataclasses.dataclass
class IndexLogEntry(LogEntry):
    """The concrete v0.1 entry for a covering index."""

    name: str = ""
    derived_dataset: CoveringIndex | None = None
    content: Content | None = None
    source: Source | None = None
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)

    # -- convenience accessors -------------------------------------------
    @property
    def indexed_columns(self) -> list[str]:
        return self.derived_dataset.indexed_columns

    @property
    def included_columns(self) -> list[str]:
        return self.derived_dataset.included_columns

    @property
    def num_buckets(self) -> int:
        return self.derived_dataset.num_buckets

    @property
    def signature(self) -> Fingerprint:
        return self.source.fingerprint

    # -- serde -----------------------------------------------------------
    def to_json(self) -> dict[str, Any]:
        return {
            "version": LOG_ENTRY_VERSION,
            "id": self.id,
            "state": self.state,
            "timestamp": self.timestamp,
            "enabled": self.enabled,
            "name": self.name,
            "derivedDataset": self.derived_dataset.to_json() if self.derived_dataset else None,
            "content": self.content.to_json() if self.content else None,
            "source": self.source.to_json() if self.source else None,
            "extra": self.extra,
        }

    @staticmethod
    def from_json(d: dict[str, Any]) -> "IndexLogEntry":
        version = d.get("version")
        if version != LOG_ENTRY_VERSION:
            # Polymorphic decode keyed on version (LogEntry.scala:33-46).
            raise ValueError(f"unsupported log entry version: {version!r}")
        return IndexLogEntry(
            id=int(d["id"]),
            state=d["state"],
            timestamp=float(d["timestamp"]),
            enabled=bool(d.get("enabled", True)),
            name=d["name"],
            derived_dataset=(
                _derived_dataset_from_json(d["derivedDataset"]) if d.get("derivedDataset") else None
            ),
            content=Content.from_json(d["content"]) if d.get("content") else None,
            source=Source.from_json(d["source"]) if d.get("source") else None,
            extra=dict(d.get("extra", {})),
        )


_DERIVED_KINDS = {"CoveringIndex": CoveringIndex, "VectorIndex": VectorIndex}


def _derived_dataset_from_json(d: dict[str, Any]):
    """Polymorphic decode keyed on `kind` (the reference keys decoding on
    the envelope version, LogEntry.scala:33-46; kinds compose with it)."""
    kind = d.get("kind", "CoveringIndex")
    if kind not in _DERIVED_KINDS:
        raise ValueError(f"unknown derived dataset kind {kind!r}")
    return _DERIVED_KINDS[kind].from_json(d)


def entry_from_json(d: dict[str, Any]) -> IndexLogEntry:
    return IndexLogEntry.from_json(d)

"""Vector (ANN) covering index: config, build pipeline, create action.

A port of the JAX package's `vector/index.py`, with the same two-plane
split as the covering index:

- metadata: a `VectorIndex` derived dataset inside the standard
  IndexLogEntry, committed through the same two-phase op log;
- device: build = k-means coarse quantizer (ops/kmeans.py, matrix
  products on the session's device) + partition carve on the host.

On-disk layout mirrors the covering index and the JAX package's vector
index file for file: one parquet file per partition
(`bucket-XXXXX.parquet`, embedding + included columns) in a `v__=n` dir,
plus the manifest and a `_centroids.npy`, so an index built by either
package is searched by the other.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from hyperspace_tpu_torch.actions import states
from hyperspace_tpu_torch.actions.create import CreateActionBase
from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.execution import io as hio
from hyperspace_tpu_torch.index.index_config import IndexConfig
from hyperspace_tpu_torch.metadata.data_manager import IndexDataManager
from hyperspace_tpu_torch.metadata.log_entry import Content, Fingerprint, IndexLogEntry, Source, VectorIndex
from hyperspace_tpu_torch.metadata.log_manager import IndexLogManager
from hyperspace_tpu_torch.ops.kmeans import assign_partitions, train_centroids
from hyperspace_tpu_torch.plan.nodes import LogicalPlan, Scan
from hyperspace_tpu_torch.signature import create_signature_provider, fingerprint_files
from hyperspace_tpu_torch.utils.name_utils import normalize_index_name

CENTROIDS_NAME = "_centroids.npy"

_METRICS = ("l2", "ip", "cos")


@dataclasses.dataclass
class VectorIndexConfig:
    """User spec for a vector index (the IndexConfig analog)."""

    index_name: str
    embedding_column: str
    included_columns: list[str] = dataclasses.field(default_factory=list)
    num_partitions: int | None = None  # default: conf.num_buckets
    metric: str = "l2"

    def __post_init__(self):
        self.index_name = normalize_index_name(self.index_name)
        if not self.index_name:
            raise HyperspaceError("index name cannot be empty")
        if self.metric not in _METRICS:
            raise HyperspaceError(f"unknown metric {self.metric!r}; one of {_METRICS}")
        low = [self.embedding_column.lower()] + [c.lower() for c in self.included_columns]
        if len(set(low)) != len(low):
            raise HyperspaceError("duplicate columns in vector index config")

    @property
    def all_columns(self) -> list[str]:
        return [self.embedding_column] + list(self.included_columns)


class VectorIndexBuilder:
    """The build pipeline: k-means and assignment on `device`, the carve
    on the host. `last_build_stats` holds the row count and the phase wall
    times (read, kmeans, assign, carve) of the last build."""

    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)
        self.last_build_stats: dict = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def write(
        self,
        plan: LogicalPlan,
        columns: list[str],
        embedding_column: str,
        num_partitions: int,
        dest_path: Path,
        metric: str,
    ) -> np.ndarray:
        """Build partitions under dest_path; returns the centroids."""
        from hyperspace_tpu_torch.execution.exec_scan import scan_files

        if not isinstance(plan, Scan):
            raise HyperspaceError("vector index builds materialize scan-only plans")
        t0 = time.perf_counter()
        table = hio.read_parquet(scan_files(plan), columns=columns, schema=plan.schema, device="cpu")
        if table.num_rows == 0:
            raise HyperspaceError("cannot build a vector index over an empty source")
        emb = table.host_column(embedding_column)
        if metric == "cos":
            norms = np.linalg.norm(emb, axis=1, keepdims=True)
            emb = emb / np.maximum(norms, 1e-12)
        x = torch.from_numpy(np.ascontiguousarray(emb, dtype=np.float32)).to(self.device)
        self._sync()
        t_read = time.perf_counter()

        centroids = train_centroids(x, num_partitions)
        self._sync()
        t_kmeans = time.perf_counter()
        # Partition ids come back to the host for the stable sort and carve.
        part = assign_partitions(x, centroids).cpu().numpy()
        t_assign = time.perf_counter()
        del x

        order = np.argsort(part, kind="stable")
        dest = Path(dest_path)
        hio.carve_and_write(
            dest, table, np.bincount(part, minlength=num_partitions), [embedding_column], order
        )
        centroids = centroids.cpu().numpy()
        np.save(dest / CENTROIDS_NAME, centroids)
        t_done = time.perf_counter()
        self.last_build_stats = {
            "path": "vector",
            "rows": table.num_rows,
            "phases_s": {
                "read": t_read - t0, "kmeans": t_kmeans - t_read,
                "assign": t_assign - t_kmeans, "carve": t_done - t_assign,
            },
        }
        return centroids


class VectorCreateAction(CreateActionBase):
    """CREATING → ACTIVE for a vector index; the same two-phase op-log
    commit as the covering index."""

    def __init__(
        self,
        plan: LogicalPlan,
        config: VectorIndexConfig,
        log_manager: IndexLogManager,
        data_manager: IndexDataManager,
        index_path: Path,
        conf: HyperspaceConf,
        builder: VectorIndexBuilder,
    ):
        # The base class wants an IndexConfig; give it the column view.
        base_cfg = IndexConfig(config.index_name, [config.embedding_column], config.included_columns)
        super().__init__(plan, base_cfg, log_manager, data_manager, index_path, conf, builder)
        self.vconfig = config

    def _num_partitions(self) -> int:
        if self.vconfig.num_partitions is not None:
            return int(self.vconfig.num_partitions)
        return int(self.conf.num_buckets)

    def validate(self) -> None:
        if not isinstance(self.plan, Scan):
            raise HyperspaceError("only scan-only plans are supported for vector indexes")
        schema = self.plan.schema
        for c in self.vconfig.all_columns:
            if c not in schema:
                raise HyperspaceError(f"column {c!r} not found in source schema {schema.names}")
        emb = schema.field(self.vconfig.embedding_column)
        if not emb.is_vector:
            raise HyperspaceError(
                f"embedding column {emb.name!r} must have vector dtype (got {emb.dtype!r})"
            )
        latest = self.log_manager.get_latest_log()
        if latest is not None and latest.state != states.DOESNOTEXIST:
            raise HyperspaceError(
                f"another index with name {self.vconfig.index_name!r} already exists "
                f"(state={latest.state})"
            )

    def build_log_entry(self) -> IndexLogEntry:
        schema = self.plan.schema
        selected = schema.select(self.vconfig.all_columns)
        emb = schema.field(self.vconfig.embedding_column)
        files = self._source_files()
        provider = create_signature_provider()
        return IndexLogEntry(
            name=self.vconfig.index_name,
            derived_dataset=VectorIndex(
                embedding_column=emb.name,
                included_columns=[schema.field(c).name for c in self.vconfig.included_columns],
                schema=selected.to_json(),
                num_partitions=self._num_partitions(),
                dim=int(emb.dim),
                metric=self.vconfig.metric,
            ),
            content=Content(root=str(self.index_path), directories=[f"v__={self._version_id}"]),
            source=Source(
                plan=self.plan.to_json(),
                fingerprint=Fingerprint(kind=provider.name, value=fingerprint_files(files)),
                files=files,
            ),
        )

    def op(self) -> None:
        dd = self.log_entry.derived_dataset
        self.writer.write(
            self.plan, dd.all_columns, dd.embedding_column, dd.num_partitions,
            self.data_manager.get_path(self._version_id), dd.metric,
        )

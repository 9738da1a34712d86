"""Vector-index lifecycle: refresh (full + incremental) and optimize.

A port of the JAX package's `vector/lifecycle.py`. Design mirrors the
covering index's lifecycle:

- full refresh re-lists the logged source, RETRAINS the coarse quantizer
  and rebuilds every partition into the next `v__=` version;
- incremental refresh assigns ONLY the appended rows to the EXISTING
  centroids (the assignment matmul on the session's device) and writes
  per-partition delta files, with a copy of the centroids, into the next
  version, keeping all prior version dirs live (partition p = union of
  p's files across dirs — exactly the covering index's hybrid layout);
- optimize re-reads all live rows, retrains the centroids over the full
  set, and compacts everything back into one file per partition.

All three run inside the standard 2-phase op-log commit (REFRESHING /
OPTIMIZING transient states), so crash recovery and `cancel` apply
unchanged. The k-means and the assignment run through the session's
`VectorIndexBuilder` (vector/index.py).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from hyperspace_tpu_torch.actions import states
from hyperspace_tpu_torch.actions.base import Action
from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.execution import io as hio
from hyperspace_tpu_torch.metadata.data_manager import IndexDataManager
from hyperspace_tpu_torch.metadata.log_entry import IndexLogEntry
from hyperspace_tpu_torch.metadata.log_manager import IndexLogManager
from hyperspace_tpu_torch.plan.nodes import plan_from_json
from hyperspace_tpu_torch.schema import Schema
from hyperspace_tpu_torch.signature import diff_source_files
from hyperspace_tpu_torch.vector.index import (
    CENTROIDS_NAME,
    VectorCreateAction,
    VectorIndexBuilder,
    VectorIndexConfig,
)


def _live_dirs(entry: IndexLogEntry) -> list[Path]:
    return [Path(entry.content.root) / d for d in entry.content.directories]


def load_centroids(entry: IndexLogEntry) -> np.ndarray:
    """Centroids of the newest live version (every version dir carries a
    copy so vacuuming old dirs can never orphan the quantizer)."""
    for d in reversed(_live_dirs(entry)):
        p = d / CENTROIDS_NAME
        if p.exists():
            return np.load(p)
    raise HyperspaceError(f"index {entry.name!r} has no {CENTROIDS_NAME}")


class VectorRefreshAction(VectorCreateAction):
    """Full rebuild from logged lineage (REFRESHING → ACTIVE): the scan
    re-lists the live filesystem, the quantizer is retrained, every
    partition is rewritten into the next version."""

    transient_state = states.REFRESHING
    final_state = states.ACTIVE

    def __init__(
        self,
        log_manager: IndexLogManager,
        data_manager: IndexDataManager,
        index_path: Path,
        conf: HyperspaceConf,
        builder: VectorIndexBuilder,
    ):
        prev = log_manager.get_latest_log()
        if prev is None:
            raise HyperspaceError("no index to refresh")
        dd = prev.derived_dataset
        if dd is None or dd.kind != "VectorIndex":
            raise HyperspaceError(f"index {prev.name!r} is not a vector index")
        plan = plan_from_json(prev.source.plan)
        cfg = VectorIndexConfig(
            prev.name,
            dd.embedding_column,
            list(dd.included_columns),
            dd.num_partitions,
            dd.metric,
        )
        super().__init__(plan, cfg, log_manager, data_manager, index_path, conf, builder)
        self.previous_entry = prev

    def validate(self) -> None:
        if self.previous_entry.state != states.ACTIVE:
            raise HyperspaceError(
                f"refresh is only supported in {states.ACTIVE} state "
                f"(found {self.previous_entry.state})"
            )


class VectorRefreshIncrementalAction(VectorRefreshAction):
    """Index ONLY the appended source files: assign their rows to the
    existing centroids and write per-partition delta files into the next
    version; prior version dirs stay live."""

    def __init__(self, log_manager, data_manager, index_path, conf, builder: VectorIndexBuilder):
        super().__init__(log_manager, data_manager, index_path, conf, builder)
        self._appended, self._deleted = diff_source_files(self.previous_entry, self.plan)

    def validate(self) -> None:
        super().validate()
        if self._deleted:
            raise HyperspaceError(
                "incremental refresh cannot handle deleted or modified source "
                f"files ({[f.path for f in self._deleted][:3]}...); run a full "
                "refresh instead"
            )
        if not self._appended:
            raise HyperspaceError("refresh aborted: no appended source data files found")

    def _source_files(self) -> list:
        # EXACTLY the indexed snapshot: previous files + the diff (never a
        # second live listing).
        return sorted(
            list(self.previous_entry.source.files) + list(self._appended),
            key=lambda f: f.path,
        )

    def build_log_entry(self) -> IndexLogEntry:
        entry = super().build_log_entry()
        prev_dirs = list(self.previous_entry.content.directories)
        entry.content = dataclasses.replace(
            entry.content, directories=prev_dirs + [f"v__={self._version_id}"]
        )
        return entry

    def op(self) -> None:
        entry = self.log_entry
        dest = self.data_manager.get_path(self._version_id)
        delta_plan = dataclasses.replace(self.plan, files=[f.path for f in self._appended])
        write_partitions(delta_plan, entry.derived_dataset, load_centroids(self.previous_entry), dest, self.writer)


class VectorOptimizeAction(Action):
    """Retrain + compact (OPTIMIZING → ACTIVE): all live rows are re-read,
    the quantizer is retrained on the full embedding set (appended data
    shifted the distribution the original centroids were fit to), and one
    file per partition is written to the next version."""

    transient_state = states.OPTIMIZING
    final_state = states.ACTIVE

    def __init__(
        self,
        log_manager: IndexLogManager,
        data_manager: IndexDataManager,
        builder: VectorIndexBuilder,
    ):
        super().__init__(log_manager)
        self.data_manager = data_manager
        self.builder = builder
        self._version: int | None = None
        self.previous_entry = log_manager.get_latest_log()
        if self.previous_entry is None:
            raise HyperspaceError("no index to optimize")
        dd = self.previous_entry.derived_dataset
        if dd is None or dd.kind != "VectorIndex":
            raise HyperspaceError(f"index {self.previous_entry.name!r} is not a vector index")

    def validate(self) -> None:
        if self.previous_entry.state != states.ACTIVE:
            raise HyperspaceError(
                f"optimize is only supported in {states.ACTIVE} state "
                f"(found {self.previous_entry.state})"
            )

    @property
    def _version_id(self) -> int:
        # Memoized (see actions/create.py): entry, dest, and failure
        # cleanup must agree on one version once op() starts writing.
        if self._version is None:
            latest = self.data_manager.get_latest_version_id()
            self._version = 0 if latest is None else latest + 1
        return self._version

    def cleanup_failed_op(self) -> None:
        try:
            self.data_manager.quarantine(self._version_id)
        except OSError:
            # Must-not-raise path: recover()'s orphan GC owns whatever
            # this leaves behind.
            pass

    def build_log_entry(self) -> IndexLogEntry:
        entry = dataclasses.replace(self.previous_entry)
        entry.content = dataclasses.replace(entry.content, directories=[f"v__={self._version_id}"])
        return entry

    def op(self) -> None:
        dd = self.previous_entry.derived_dataset
        schema = Schema.from_json(dd.schema)
        files = []
        for d in _live_dirs(self.previous_entry):
            files.extend(
                str(d / hio.bucket_file_name(p)) for p in range(dd.num_partitions)
                if (d / hio.bucket_file_name(p)).exists()
            )
        table = hio.read_parquet(files, columns=schema.names, schema=schema, device="cpu")
        if table.num_rows == 0:
            raise HyperspaceError("index has no data to optimize")
        self.builder.write_table(
            table, dd.embedding_column, dd.num_partitions, self.data_manager.get_path(self._version_id), dd.metric
        )


def write_partitions(plan, dd, centroids: np.ndarray, dest: Path, builder: VectorIndexBuilder) -> None:
    """Assign `plan`'s rows to EXISTING centroids (on the builder's
    device) and carve one parquet per partition into `dest` (+ a
    centroids copy)."""
    builder.write(
        plan, dd.all_columns, dd.embedding_column, dd.num_partitions, Path(dest), dd.metric, centroids=centroids
    )

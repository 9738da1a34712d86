"""CreateAction: build a new covering index (CREATING → ACTIVE).

Reference parity: actions/CreateAction.scala:27-75 +
actions/CreateActionBase.scala:30-121. Validation requires a scan-only source
plan (CreateAction.scala:42-48), schema containment (:64-70) and a free index
name (:54-61). `build_log_entry` assembles the full IndexLogEntry — selected
schema, numBuckets from conf, the JSON plan (vs. the reference's Kryo blob),
the file-based signature and the source file list
(CreateActionBase.scala:38-97). `op` runs the device build pipeline — the
hot path: select columns → hash-bucketize (the exchange over the
writer's mesh, or one device) → a stable sort by (bucket, key) a shard →
persist buckets (CreateActionBase.scala:99-120).
A copy of the JAX package's module.

The pipeline is injected via the `IndexWriter` protocol — the DI seam the
tests use (analog of index/factories.scala).
"""

from __future__ import annotations

from pathlib import Path
from typing import Protocol

from hyperspace_tpu_torch.actions import states
from hyperspace_tpu_torch.actions.base import Action
from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.index.index_config import IndexConfig
from hyperspace_tpu_torch.metadata.data_manager import IndexDataManager
from hyperspace_tpu_torch.metadata.log_entry import (
    Content,
    CoveringIndex,
    IndexLogEntry,
    Source,
)
from hyperspace_tpu_torch.metadata.log_manager import IndexLogManager
from hyperspace_tpu_torch.plan.nodes import LogicalPlan, Scan
from hyperspace_tpu_torch.signature import create_signature_provider


class IndexWriter(Protocol):
    """The device build pipeline seam."""

    def write(
        self,
        plan: LogicalPlan,
        columns: list[str],
        indexed_columns: list[str],
        num_buckets: int,
        dest_path: Path,
    ) -> None: ...


class CreateActionBase(Action):
    transient_state = states.CREATING
    final_state = states.ACTIVE

    def __init__(
        self,
        plan: LogicalPlan,
        index_config: IndexConfig,
        log_manager: IndexLogManager,
        data_manager: IndexDataManager,
        index_path: Path,
        conf: HyperspaceConf,
        writer: IndexWriter,
    ):
        super().__init__(log_manager)
        self.plan = plan
        self.index_config = index_config
        self.data_manager = data_manager
        self.index_path = Path(index_path)
        self.conf = conf
        self.writer = writer
        self._version: int | None = None

    @property
    def _version_id(self) -> int:
        """Next data version dir (CreateActionBase.scala:31-36). Memoized
        on first access: once op() starts creating the directory, a
        recomputation would see it and skip ahead — the log entry, the
        build destination, and the failure cleanup must all name the SAME
        version."""
        if self._version is None:
            latest = self.data_manager.get_latest_version_id()
            self._version = 0 if latest is None else latest + 1
        return self._version

    def cleanup_failed_op(self) -> None:
        """A failed build leaves a partial `v__=N`; quarantine it so it
        can never be listed as index data (and never collides with the
        next attempt's version numbering)."""
        try:
            self.data_manager.quarantine(self._version_id)
        except OSError:
            # Must-not-raise path: the partial version dir stays behind
            # under its own name and is never listed as index data.
            pass

    def _num_buckets(self) -> int:
        return int(self.conf.num_buckets)

    def _source_files(self) -> list:
        """The file snapshot this build indexes. Base: one live listing of
        the plan's leaves. Subclasses that index a pre-computed snapshot
        (incremental refresh) override this so the entry can never claim
        files the build didn't see."""
        from hyperspace_tpu_torch.signature import collect_leaf_files

        files = []
        for leaf in self.plan.leaves():
            files.extend(collect_leaf_files(leaf))
        return files

    def build_log_entry(self) -> IndexLogEntry:
        from hyperspace_tpu_torch.metadata.log_entry import Fingerprint
        from hyperspace_tpu_torch.signature import fingerprint_files

        cfg = self.index_config
        plan_schema = self.plan.schema
        selected = plan_schema.select(cfg.all_columns)
        num_buckets = self._num_buckets()
        # Single listing pass: the fingerprint and the recorded file list are
        # derived from the same snapshot so they can never diverge.
        files = self._source_files()
        provider = create_signature_provider()
        fp = Fingerprint(kind=provider.name, value=fingerprint_files(files))
        version = self._version_id
        return IndexLogEntry(
            name=cfg.index_name,
            derived_dataset=CoveringIndex(
                indexed_columns=[plan_schema.field(c).name for c in cfg.indexed_columns],
                included_columns=[plan_schema.field(c).name for c in cfg.included_columns],
                schema=selected.to_json(),
                num_buckets=num_buckets,
            ),
            content=Content(root=str(self.index_path), directories=[f"v__={version}"]),
            source=Source(plan=self.plan.to_json(), fingerprint=fp, files=files),
        )

    def op(self) -> None:
        entry = self.log_entry
        dest = self.data_manager.get_path(self._version_id)
        self.writer.write(
            self.plan,
            entry.derived_dataset.all_columns,
            entry.derived_dataset.indexed_columns,
            entry.derived_dataset.num_buckets,
            dest,
        )


class CreateAction(CreateActionBase):
    def validate(self) -> None:
        # Scan-only source plans (CreateAction.scala:42-48).
        if not isinstance(self.plan, Scan):
            raise HyperspaceError(
                "only scan-only (single relation) plans are supported for createIndex"
            )
        # Schema containment (CreateAction.scala:64-70).
        schema = self.plan.schema
        for c in self.index_config.all_columns:
            if c not in schema:
                raise HyperspaceError(f"column {c!r} not found in source schema {schema.names}")
        # Name non-collision (CreateAction.scala:54-61).
        latest = self.log_manager.get_latest_log()
        if latest is not None and latest.state != states.DOESNOTEXIST:
            raise HyperspaceError(
                f"another index with name {self.index_config.index_name!r} already exists "
                f"(state={latest.state})"
            )

"""RefreshAction: full rebuild from logged lineage (REFRESHING → ACTIVE).

Reference parity: actions/RefreshAction.scala:30-78 — deserialize the stored
source plan (picking up new source files because the scan re-lists the live
filesystem), re-derive the IndexConfig from the previous entry
(RefreshAction.scala:52-55), re-run the build into the next `v__=` version.
Valid only from ACTIVE (RefreshAction.scala:64-70).

A copy of the JAX package's module, full and incremental refresh, so an
index refreshed by either package is read, optimized and refreshed again
by the other. Both builds run through `DeviceIndexBuilder.write`: one
stable device sort by (bucket, key lanes) of the rows they index.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

from hyperspace_tpu_torch.actions import states
from hyperspace_tpu_torch.actions.create import CreateActionBase, IndexWriter
from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.index.index_config import IndexConfig
from hyperspace_tpu_torch.metadata.data_manager import IndexDataManager
from hyperspace_tpu_torch.metadata.log_entry import IndexLogEntry
from hyperspace_tpu_torch.metadata.log_manager import IndexLogManager
from hyperspace_tpu_torch.plan.nodes import plan_from_json
from hyperspace_tpu_torch.signature import diff_source_files


class RefreshAction(CreateActionBase):
    transient_state = states.REFRESHING
    final_state = states.ACTIVE

    def __init__(
        self,
        log_manager: IndexLogManager,
        data_manager: IndexDataManager,
        index_path: Path,
        conf: HyperspaceConf,
        writer: IndexWriter,
    ):
        prev = log_manager.get_latest_log()
        if prev is None:
            raise HyperspaceError("no index to refresh")
        if prev.derived_dataset is not None and prev.derived_dataset.kind != "CoveringIndex":
            raise HyperspaceError(
                f"refresh of {prev.derived_dataset.kind} indexes is not supported yet; "
                "drop and re-create the index"
            )
        self.previous_entry = prev
        plan = plan_from_json(prev.source.plan)
        cfg = IndexConfig(
            prev.name,
            prev.derived_dataset.indexed_columns,
            prev.derived_dataset.included_columns,
        )
        super().__init__(plan, cfg, log_manager, data_manager, index_path, conf, writer)

    def _num_buckets(self) -> int:
        # Keep the previous bucket count stable across refreshes.
        return self.previous_entry.derived_dataset.num_buckets

    def validate(self) -> None:
        if self.previous_entry.state != states.ACTIVE:
            raise HyperspaceError(
                f"refresh is only supported in {states.ACTIVE} state "
                f"(found {self.previous_entry.state})"
            )


class RefreshIncrementalAction(RefreshAction):
    """Incremental refresh: index ONLY the source files appended since the
    last build, writing per-bucket delta files into the next `v__=` version.

    - diff the live file listing against the logged `source.files`;
    - appended files are bucketized with the SAME bucket count and row-hash
      function as the base build, so bucket b's data is the union of bucket
      b's files across all version dirs — query plans need no re-shuffle;
    - the new log entry lists ALL version dirs in `content.directories` and
      records EXACTLY the indexed snapshot (previous files + the diff —
      never a second live listing, which could claim files written after
      the diff that op() will not index);
    - deleted/modified source files require a full refresh.
    """

    def __init__(
        self,
        log_manager: IndexLogManager,
        data_manager: IndexDataManager,
        index_path: Path,
        conf: HyperspaceConf,
        writer: IndexWriter,
    ):
        super().__init__(log_manager, data_manager, index_path, conf, writer)
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
            raise HyperspaceError(
                "refresh aborted: no appended source data files found"
            )

    def _source_files(self) -> list:
        return sorted(
            list(self.previous_entry.source.files) + list(self._appended),
            key=lambda f: f.path,
        )

    def build_log_entry(self) -> IndexLogEntry:
        entry = super().build_log_entry()
        # Keep every prior version dir live: bucket b = union over dirs.
        prev_dirs = list(self.previous_entry.content.directories)
        entry.content = dataclasses.replace(
            entry.content, directories=prev_dirs + [f"v__={self._version_id}"]
        )
        return entry

    def op(self) -> None:
        entry = self.log_entry
        dest = self.data_manager.get_path(self._version_id)
        delta_plan = dataclasses.replace(self.plan, files=[f.path for f in self._appended])
        self.writer.write(
            delta_plan,
            entry.derived_dataset.all_columns,
            entry.derived_dataset.indexed_columns,
            entry.derived_dataset.num_buckets,
            dest,
        )

"""OptimizeAction: compact index data files (OPTIMIZING → ACTIVE).

The v0.2 reference does not yet ship optimizeIndex (it arrives in later
Hyperspace releases), but the BASELINE configs require an
incremental-refresh + compaction loop (NYC-Taxi), so it is first-class here:
valid from ACTIVE, op merges the per-bucket delta files produced by
incremental refreshes into one sorted file per bucket, written to the next
`v__=` version; the log swap makes the compacted version live.

The compaction itself is injected via the same writer seam as create
(actions/create.py) — an `IndexCompactor` with a `compact` method; the
port's is `DeviceIndexBuilder.compact`, one stable device sort of every
live version's rows. A copy of the JAX package's module.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Protocol

from hyperspace_tpu_torch.actions import states
from hyperspace_tpu_torch.actions.base import Action
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.metadata.data_manager import IndexDataManager
from hyperspace_tpu_torch.metadata.log_entry import IndexLogEntry
from hyperspace_tpu_torch.metadata.log_manager import IndexLogManager


class IndexCompactor(Protocol):
    def compact(self, entry: IndexLogEntry, src_paths: list[Path], dest_path: Path) -> None: ...


class OptimizeAction(Action):
    transient_state = states.OPTIMIZING
    final_state = states.ACTIVE

    def __init__(
        self,
        log_manager: IndexLogManager,
        data_manager: IndexDataManager,
        compactor: IndexCompactor,
    ):
        super().__init__(log_manager)
        self.data_manager = data_manager
        self.compactor = compactor
        self._version: int | None = None
        self.previous_entry = log_manager.get_latest_log()
        if self.previous_entry is None:
            raise HyperspaceError("no index to optimize")
        dd = self.previous_entry.derived_dataset
        if dd is not None and dd.kind != "CoveringIndex":
            raise HyperspaceError(
                f"optimize of {dd.kind} indexes is not supported yet"
            )

    def validate(self) -> None:
        if self.previous_entry.state != states.ACTIVE:
            raise HyperspaceError(
                f"optimize is only supported in {states.ACTIVE} state "
                f"(found {self.previous_entry.state})"
            )

    @property
    def _version_id(self) -> int:
        # Memoized for the same reason as CreateActionBase: entry, dest,
        # and failure cleanup must agree on one version.
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
        prev_version = self.data_manager.get_latest_version_id()
        if prev_version is None:
            raise HyperspaceError("index has no data to optimize")
        # Compact EVERY live version dir (base + incremental-refresh deltas)
        # into one sorted file per bucket in the next version.
        root = Path(self.previous_entry.content.root)
        srcs = [root / d for d in self.previous_entry.content.directories]
        dest = self.data_manager.get_path(self._version_id)
        self.compactor.compact(self.previous_entry, srcs, dest)

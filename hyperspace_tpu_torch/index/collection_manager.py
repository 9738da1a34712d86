"""Index collection management: wiring actions to per-index managers.

Reference parity: index/IndexManager.scala:24-81 (the 7-method interface),
index/IndexCollectionManager.scala:26-137 (wiring + getIndexes enumerating
every index dir under the system path), and
index/CachingIndexCollectionManager.scala:37-160 (read-path TTL cache,
cleared by every mutating API).

A copy of the JAX package's module: create, delete, restore, vacuum,
refresh (full and incremental), optimize, cancel, recover (torn tail,
transient tail, orphan GC), the lazy recover on access and `indexes()`,
for covering and vector indexes, with the log and data manager factory
seams through which tests inject protocol fakes.
"""

from __future__ import annotations

import time
from pathlib import Path

from hyperspace_tpu_torch import states, stats
from hyperspace_tpu_torch.actions import (
    CancelAction,
    CreateAction,
    DeleteAction,
    OptimizeAction,
    RefreshAction,
    RefreshIncrementalAction,
    RestoreAction,
    VacuumAction,
)
from hyperspace_tpu_torch.config import DATA_VERSION_PREFIX, HyperspaceConf
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.index.index_config import IndexConfig
from hyperspace_tpu_torch.metadata.cache import CreationTimeBasedCache
from hyperspace_tpu_torch.metadata.data_manager import IndexDataManager
from hyperspace_tpu_torch.metadata.log_entry import IndexLogEntry
from hyperspace_tpu_torch.metadata.log_manager import IndexLogManager
from hyperspace_tpu_torch.metadata.path_resolver import PathResolver
from hyperspace_tpu_torch.plan.nodes import LogicalPlan


class IndexCollectionManager:
    """Concrete manager: one log/data manager pair per index directory."""

    def __init__(
        self,
        conf: HyperspaceConf,
        writer_factory,
        vector_builder_factory,
        log_manager_factory=None,
        data_manager_factory=None,
    ):
        self.conf = conf
        self.path_resolver = PathResolver(conf)
        # The DI seams (analog of index/factories.scala:22-52): the writer
        # builds and compacts covering-index data, the vector builder
        # vector-index data; the log/data manager factories let tests
        # inject protocol fakes per index path.
        self.writer_factory = writer_factory
        self.vector_builder_factory = vector_builder_factory
        self.log_manager_factory = log_manager_factory or IndexLogManager
        self.data_manager_factory = data_manager_factory or IndexDataManager

    def _managers(self, name: str) -> tuple[IndexLogManager, IndexDataManager, Path]:
        index_path = self.path_resolver.get_index_path(name)
        return self.log_manager_factory(index_path), self.data_manager_factory(index_path), index_path

    # -- IndexManager interface ------------------------------------------
    def create(self, plan: LogicalPlan, config: IndexConfig) -> None:
        lm, dm, path = self._managers(config.index_name)
        CreateAction(plan, config, lm, dm, path, self.conf, self.writer_factory()).run()

    def create_vector(self, plan: LogicalPlan, config) -> None:
        from hyperspace_tpu_torch.vector.index import VectorCreateAction

        lm, dm, path = self._managers(config.index_name)
        VectorCreateAction(plan, config, lm, dm, path, self.conf, self.vector_builder_factory()).run()

    def delete(self, name: str) -> None:
        lm, _, _ = self._managers(name)
        DeleteAction(lm).run()

    def restore(self, name: str) -> None:
        lm, _, _ = self._managers(name)
        RestoreAction(lm).run()

    def vacuum(self, name: str) -> None:
        lm, dm, _ = self._managers(name)
        VacuumAction(lm, dm).run()

    def refresh(self, name: str, mode: str = "full") -> None:
        lm, dm, path = self._managers(name)
        if mode not in ("full", "incremental"):
            raise HyperspaceError(f"unknown refresh mode {mode!r} (full|incremental)")
        if self._is_vector(lm):
            from hyperspace_tpu_torch.vector.lifecycle import (
                VectorRefreshAction,
                VectorRefreshIncrementalAction,
            )

            action = VectorRefreshAction if mode == "full" else VectorRefreshIncrementalAction
            action(lm, dm, path, self.conf, self.vector_builder_factory()).run()
        elif mode == "full":
            RefreshAction(lm, dm, path, self.conf, self.writer_factory()).run()
        else:
            RefreshIncrementalAction(lm, dm, path, self.conf, self.writer_factory()).run()

    def optimize(self, name: str) -> None:
        lm, dm, _ = self._managers(name)
        if self._is_vector(lm):
            from hyperspace_tpu_torch.vector.lifecycle import VectorOptimizeAction

            VectorOptimizeAction(lm, dm, self.vector_builder_factory()).run()
        else:
            OptimizeAction(lm, dm, self.writer_factory()).run()

    @staticmethod
    def _is_vector(lm) -> bool:
        entry = lm.get_latest_log()
        return (
            entry is not None
            and entry.derived_dataset is not None
            and entry.derived_dataset.kind == "VectorIndex"
        )

    def cancel(self, name: str) -> None:
        lm, _, _ = self._managers(name)
        if lm.get_latest_log() is None:
            raise HyperspaceError(f"index {name!r} does not exist")
        CancelAction(lm).run()

    # -- crash recovery ---------------------------------------------------
    def recover(self, name: str) -> dict:
        """Repair one index after a crashed writer. Idempotent three-step
        state machine:

        1. **Torn tail**: trailing log entries that no longer parse are
           quarantined until the tail is readable.
        2. **Transient tail**: a latest entry in a transient state is
           rolled forward/back to the last stable state with the exact
           `cancel` semantics (VACUUMING → DOESNOTEXIST, otherwise the
           last stable state), and the `latestStable` pointer is
           refreshed — also repairing an `end()` that died between the
           final CAS write and the pointer swap.
        3. **Orphan GC**: `v__=N` dirs the latest stable entry does not
           reference (partial builds, superseded failed refreshes) are
           deleted. A DELETED entry still references its dirs (restore
           needs them); DOESNOTEXIST references none, so a crashed
           vacuum's remaining dirs are swept here.
        """
        lm, dm, _ = self._managers(name)
        report = {"rolled": False, "quarantined_entries": 0, "orphans_removed": 0}
        latest = None
        while True:
            latest_id = lm.get_latest_id()
            if latest_id is None:
                break
            try:
                latest = lm.get_log(latest_id)
                break
            except Exception:
                if not lm.quarantine_log(latest_id):
                    break
                report["quarantined_entries"] += 1
                stats.increment("recover.quarantined_entries")
        if latest is None:
            return report
        if latest.state not in states.STABLE_STATES:
            CancelAction(lm).run()
            report["rolled"] = True
            stats.increment("recover.rolled")
        # Refresh the pointer unconditionally: cheap, and repairs a crash
        # between end()'s final write and its pointer swap.
        lm.create_latest_stable_log(lm.get_latest_id())
        stable = lm.get_latest_stable_log()
        referenced: set[str] = set()
        if stable is not None and stable.state != states.DOESNOTEXIST and stable.content is not None:
            referenced = set(stable.content.directories)
        for vid in dm.get_version_ids():
            if f"{DATA_VERSION_PREFIX}{vid}" not in referenced:
                dm.delete(vid)
                report["orphans_removed"] += 1
                stats.increment("recover.orphans_removed")
        return report

    def _latest_for_listing(self, lm, dir_path: Path) -> IndexLogEntry | None:
        """One index dir's latest entry, lazily repairing crash damage.

        With `hyperspace.recover.onAccess` (default on), a torn latest
        entry recovers immediately, and a TRANSIENT latest entry recovers
        once it is older than `hyperspace.recover.graceSeconds` — the
        grace keeps a listing from cancelling a live writer's in-flight
        action, while a long-dead writer's index heals on first access.
        Safe against the race anyway: recovery commits through the same
        CAS protocol, so a live writer that loses simply aborts."""
        try:
            entry = lm.get_latest_log()
        except Exception:
            entry = None
            if not self.conf.recover_on_access:
                raise
        if not self.conf.recover_on_access:
            return entry
        stale = (
            entry is not None
            and entry.state not in states.STABLE_STATES
            # Wall clock on purpose: entry.timestamp is a PERSISTED stamp
            # from a possibly-different process; monotonic() cannot
            # compare across those.
            and time.time() - (entry.timestamp or 0) > self.conf.recover_grace_seconds  # noqa: HSL007
        )
        if entry is None or stale:
            try:
                self.recover(dir_path.name)
                entry = lm.get_latest_log()
            except Exception:
                # Lazy repair is best-effort by design (the listing must
                # not fail because one index is broken) — but count it:
                # a silent failure here would hide a dead index forever.
                stats.increment("recover.on_access_failed")
        return entry

    def get_indexes(self, states_filter=(states.ACTIVE,)) -> list[IndexLogEntry]:
        """Enumerate every index dir under the system path and read each
        latest log (IndexCollectionManager.scala:87-105)."""
        out = []
        for d in self.path_resolver.list_index_paths():
            entry = self._latest_for_listing(self.log_manager_factory(d), d)
            if entry is not None and entry.state in states_filter:
                out.append(entry)
        return out

    def indexes(self):
        """Project all indexes to a summary DataFrame
        (IndexCollectionManager.scala:79-85, IndexSummary :151-173)."""
        import pandas as pd

        rows = []
        for entry in self.get_indexes(states_filter=tuple(states.ALL_STATES)):
            dd = entry.derived_dataset
            indexed = list(dd.indexed_columns) if dd.kind == "CoveringIndex" else [dd.embedding_column]
            rows.append(
                {
                    "name": entry.name,
                    "kind": dd.kind,
                    "indexedColumns": indexed,
                    "includedColumns": list(dd.included_columns),
                    "numBuckets": dd.num_buckets,
                    "schema": [f["name"] for f in dd.schema],
                    "indexLocation": str(Path(entry.content.root) / entry.content.directories[-1]),
                    "state": entry.state,
                }
            )
        return pd.DataFrame(rows, columns=[
            "name", "kind", "indexedColumns", "includedColumns", "numBuckets", "schema", "indexLocation", "state",
        ])


class CachingIndexCollectionManager(IndexCollectionManager):
    """Read-path cache of the ACTIVE index entries with TTL expiry;
    every mutating API clears the cache first
    (CachingIndexCollectionManager.scala:60-98)."""

    def __init__(self, conf: HyperspaceConf, writer_factory, vector_builder_factory):
        super().__init__(conf, writer_factory, vector_builder_factory)
        self._cache = CreationTimeBasedCache(conf.cache_expiry_seconds)

    def clear_cache(self) -> None:
        self._cache.clear()
        # Index mutations version the data files: the decoded columns and
        # derived arrays of a superseded version can never hit again, so
        # drop them instead of letting them pin device memory.
        from hyperspace_tpu_torch.execution import device_cache

        device_cache.clear_all()

    def get_indexes(self, states_filter=(states.ACTIVE,)) -> list[IndexLogEntry]:
        if tuple(states_filter) == (states.ACTIVE,):
            cached = self._cache.get()
            if cached is not None:
                return cached
            entries = super().get_indexes(states_filter)
            self._cache.set(entries)
            return entries
        return super().get_indexes(states_filter)

    def create(self, plan, config):
        self.clear_cache()
        super().create(plan, config)

    def create_vector(self, plan, config):
        self.clear_cache()
        super().create_vector(plan, config)

    def delete(self, name):
        self.clear_cache()
        super().delete(name)

    def restore(self, name):
        self.clear_cache()
        super().restore(name)

    def vacuum(self, name):
        self.clear_cache()
        super().vacuum(name)

    def refresh(self, name, mode: str = "full"):
        self.clear_cache()
        super().refresh(name, mode)

    def optimize(self, name):
        self.clear_cache()
        super().optimize(name)

    def cancel(self, name):
        self.clear_cache()
        super().cancel(name)

    def recover(self, name):
        self.clear_cache()
        return super().recover(name)

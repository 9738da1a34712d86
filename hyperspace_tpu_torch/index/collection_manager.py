"""Index collection management: wiring actions to per-index managers.

Reference parity: index/IndexManager.scala:24-81,
index/IndexCollectionManager.scala:26-137 (wiring + getIndexes enumerating
every index dir under the system path), and
index/CachingIndexCollectionManager.scala:37-160 (read-path TTL cache,
cleared by every mutating API).

A trimmed copy of the JAX package's module: `create` and the listing are
ported; the other lifecycle actions (delete, restore, vacuum, refresh,
optimize, cancel, recover) are not ported yet.
"""

from __future__ import annotations

from pathlib import Path

from hyperspace_tpu_torch import states
from hyperspace_tpu_torch.actions import CreateAction
from hyperspace_tpu_torch.config import DEFAULT_CACHE_EXPIRY_SECONDS, HyperspaceConf
from hyperspace_tpu_torch.index.index_config import IndexConfig
from hyperspace_tpu_torch.metadata.cache import CreationTimeBasedCache
from hyperspace_tpu_torch.metadata.data_manager import IndexDataManager
from hyperspace_tpu_torch.metadata.log_entry import IndexLogEntry
from hyperspace_tpu_torch.metadata.log_manager import IndexLogManager
from hyperspace_tpu_torch.metadata.path_resolver import PathResolver
from hyperspace_tpu_torch.plan.nodes import LogicalPlan


class IndexCollectionManager:
    """Concrete manager: one log/data manager pair per index directory."""

    def __init__(self, conf: HyperspaceConf, writer_factory):
        self.conf = conf
        self.path_resolver = PathResolver(conf)
        # The DI seam (analog of index/factories.scala:22-52): the writer
        # builds index data.
        self.writer_factory = writer_factory

    def _managers(self, name: str) -> tuple[IndexLogManager, IndexDataManager, Path]:
        index_path = self.path_resolver.get_index_path(name)
        return IndexLogManager(index_path), IndexDataManager(index_path), index_path

    def create(self, plan: LogicalPlan, config: IndexConfig) -> None:
        lm, dm, path = self._managers(config.index_name)
        CreateAction(plan, config, lm, dm, path, self.conf, self.writer_factory()).run()

    def get_indexes(self, states_filter=(states.ACTIVE,)) -> list[IndexLogEntry]:
        """Enumerate every index dir under the system path and read each
        latest log (IndexCollectionManager.scala:87-105)."""
        out = []
        for d in self.path_resolver.list_index_paths():
            entry = IndexLogManager(d).get_latest_log()
            if entry is not None and entry.state in states_filter:
                out.append(entry)
        return out


class CachingIndexCollectionManager(IndexCollectionManager):
    """Read-path cache of the ACTIVE index entries with TTL expiry;
    every mutating API clears the cache first
    (CachingIndexCollectionManager.scala:60-98)."""

    def __init__(self, conf: HyperspaceConf, writer_factory):
        super().__init__(conf, writer_factory)
        self._cache = CreationTimeBasedCache(DEFAULT_CACHE_EXPIRY_SECONDS)

    def clear_cache(self) -> None:
        self._cache.clear()

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

"""User facade and session integration.

Reference parity: com/microsoft/hyperspace/Hyperspace.scala:24-133 (user
APIs delegating to the collection manager) and package.scala:34-77
(enable/disable toggling the optimizer rule batch). `HyperspaceSession`
owns the configuration, the device, the executor's device cache and the
enable/disable switch; `session.run(plan)` is the query entry point that
applies the rewrite rules when enabled.

A port of the JAX package's `hyperspace.py` (`HyperspaceSession.parquet /
enable_hyperspace / disable_hyperspace / run / to_pandas` and
`Hyperspace.create_index`). The session runs on the CUDA card unless the
caller passes `device="cpu"`. Corruption fallback, profiles, serving, the
advisor and the lifecycle APIs other than create are not ported yet.
"""

from __future__ import annotations

from pathlib import Path

import torch

from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.dataset import Dataset
from hyperspace_tpu_torch.device import resolve_device
from hyperspace_tpu_torch.execution.device_cache import DeviceTableCache
from hyperspace_tpu_torch.index.collection_manager import CachingIndexCollectionManager
from hyperspace_tpu_torch.index.index_config import IndexConfig
from hyperspace_tpu_torch.plan.nodes import LogicalPlan, Scan
from hyperspace_tpu_torch.plan.prune import prune_columns
from hyperspace_tpu_torch.rules.base import apply_rules


class HyperspaceSession:
    """The engine session: configuration + device + rule toggle."""

    def __init__(
        self,
        system_path: str | None = None,
        num_buckets: int | None = None,
        device: "str | torch.device | None" = None,
    ):
        kwargs = {}
        if system_path is not None:
            kwargs["system_path"] = str(system_path)
        if num_buckets is not None:
            kwargs["num_buckets"] = int(num_buckets)
        self.conf = HyperspaceConf(**kwargs)
        self.device = resolve_device(device)
        self.cache = DeviceTableCache()
        self._enabled = False
        self._manager: CachingIndexCollectionManager | None = None
        self._last_writer = None
        # Executed-plan evidence of the most recent run().
        self.last_query_stats: dict = {}
        self.last_optimized_plan: LogicalPlan | None = None

    # -- rule toggle (package.scala:46-70) --------------------------------
    def enable_hyperspace(self) -> "HyperspaceSession":
        self._enabled = True
        return self

    def disable_hyperspace(self) -> "HyperspaceSession":
        self._enabled = False
        return self

    def is_hyperspace_enabled(self) -> bool:
        return self._enabled

    # -- wiring -----------------------------------------------------------
    @property
    def manager(self) -> CachingIndexCollectionManager:
        if self._manager is None:

            def writer_factory():
                from hyperspace_tpu_torch.execution.builder import DeviceIndexBuilder

                self._last_writer = DeviceIndexBuilder(self.device)
                return self._last_writer

            self._manager = CachingIndexCollectionManager(self.conf, writer_factory)
        return self._manager

    @property
    def last_build_stats(self) -> dict:
        """Stats of the most recent index build in this session, including
        the per-phase wall times (decode / hash_lanes / partition_sort /
        carve_encode_write)."""
        return dict(getattr(self._last_writer, "last_build_stats", {}) or {})

    # -- data access ------------------------------------------------------
    def parquet(self, root: str | Path) -> Scan:
        """Register a parquet dataset and return its scan plan."""
        return Dataset.parquet(root).scan()

    def optimized_plan(self, plan: LogicalPlan) -> LogicalPlan:
        if not self._enabled:
            return plan
        # Column pruning FIRST (the analog of Spark running ColumnPruning
        # before the extraOptimizations batch): scans narrow to what the
        # query needs, which is what index coverage is checked against.
        return apply_rules(prune_columns(plan), self.manager.get_indexes(), conf=self.conf)

    def run(self, plan: LogicalPlan):
        """Execute a plan (rewriting through indexes when enabled);
        returns a ColumnTable on the session's device."""
        from hyperspace_tpu_torch.execution.executor import Executor

        optimized = self.optimized_plan(plan)
        executor = Executor(self.device, self.cache)
        result = executor.execute(optimized)
        self.last_query_stats = executor.stats
        self.last_optimized_plan = optimized
        return result

    def to_pandas(self, plan: LogicalPlan):
        import pandas as pd

        return pd.DataFrame(self.run(plan).decode())


class Hyperspace:
    """The user API (Hyperspace.scala:32-104); `create_index` is ported."""

    def __init__(self, session: HyperspaceSession):
        self.session = session

    def create_index(self, plan: LogicalPlan, index_config: IndexConfig) -> None:
        self.session.manager.create(plan, index_config)

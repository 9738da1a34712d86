"""User facade and session integration.

Reference parity: com/microsoft/hyperspace/Hyperspace.scala:24-133 (user
APIs delegating to the collection manager) and package.scala:34-77
(enable/disable toggling the optimizer rule batch). `HyperspaceSession`
owns the configuration, the device and the enable/disable switch;
`session.run(plan)` is the query entry point that applies the rewrite
rules when enabled.

A port of the JAX package's `hyperspace.py` (`HyperspaceSession.parquet /
enable_hyperspace / disable_hyperspace / run / to_pandas` and
`Hyperspace.create_index`, `create_vector_index` and `ann_search`), with
`run_query(plan, plan_cache=)` and `QueryOutcome`. The session runs on
the CUDA card unless the caller passes `device="cpu"`. `last_query_stats`
reports what ran: the scan kind, files read or pruned, rows pruned by a
range slice or a join's dynamic partition pruning and whether a range
slice was exact, the aggregate path, for a
join its path (`zero-exchange-aligned`, `single-partition`,
`broadcast-hash`, `rebucketized-aligned` or `bucket-preserved-aligned`;
`join_paths` lists every join's), kernel, exchange kernel and bucket
count, and the host's seconds by step (`host_s`: plan, read,
derive, execute). Decoded columns and derived arrays are cached per
process (execution/device_cache.py). Corruption fallback, profiles, the
server, the advisor and the lifecycle APIs other than create are not
ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import torch

from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.dataset import Dataset
from hyperspace_tpu_torch.device import resolve_device
from hyperspace_tpu_torch.index.collection_manager import CachingIndexCollectionManager
from hyperspace_tpu_torch.index.index_config import IndexConfig
from hyperspace_tpu_torch.plan.nodes import LogicalPlan, Scan
from hyperspace_tpu_torch.plan.prune import prune_columns
from hyperspace_tpu_torch.plan.pushdown import push_down_filters
from hyperspace_tpu_torch.rules.base import apply_rules


@dataclasses.dataclass
class QueryOutcome:
    """Everything one query produced, owned by the caller rather than
    the session: the result (a ColumnTable), the executor's stats and the
    optimized plan that ran. `run` publishes one into the session's view
    (`last_query_stats`, `last_optimized_plan`); `run_query` does not."""

    result: object
    stats: dict
    optimized_plan: LogicalPlan


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

            def vector_builder_factory():
                from hyperspace_tpu_torch.vector.index import VectorIndexBuilder

                self._last_writer = VectorIndexBuilder(self.device)
                return self._last_writer

            self._manager = CachingIndexCollectionManager(self.conf, writer_factory, vector_builder_factory)
        return self._manager

    @property
    def last_build_stats(self) -> dict:
        """Stats of the most recent index build in this session, including
        the per-phase wall times (a covering index: decode / hash_lanes /
        partition_sort / carve_encode_write; a vector index: read / kmeans
        / assign / carve)."""
        return dict(getattr(self._last_writer, "last_build_stats", {}) or {})

    # -- data access ------------------------------------------------------
    def parquet(self, root: str | Path) -> Scan:
        """Register a parquet dataset and return its scan plan."""
        return Dataset.parquet(root).scan()

    def optimized_plan(self, plan: LogicalPlan) -> LogicalPlan:
        if not self._enabled:
            return plan
        # Predicate pushdown and column pruning FIRST (the analog of Spark
        # running PushDownPredicate/ColumnPruning before the
        # extraOptimizations batch): side-local filters reach the join
        # sides, where the index rules cover them, and scans narrow to
        # what the query needs, which is what index coverage is checked
        # against.
        return apply_rules(prune_columns(push_down_filters(plan)), self.manager.get_indexes(), conf=self.conf)

    def run(self, plan: LogicalPlan):
        """Execute a plan (rewriting through indexes when enabled);
        returns a ColumnTable on the session's device."""
        outcome = self.run_query(plan)
        self.last_query_stats = outcome.stats
        self.last_optimized_plan = outcome.optimized_plan
        return outcome.result

    def run_query(self, plan: LogicalPlan, plan_cache=None) -> QueryOutcome:
        """Execute a plan into a QueryOutcome without touching the
        session's view. `plan_cache` (a serve.PlanCache) memoizes
        `optimized_plan` per versioned plan key while hyperspace is
        enabled. The outcome's stats carry the host's seconds by step
        (`host_s`): plan (the rewrite or a cache hit), read (decoded
        columns: the device cache, or parquet), derive (derived arrays:
        their cache, or the derivation) and execute (everything after
        planning, read and derive included; the device's work is not
        waited for)."""
        from hyperspace_tpu_torch.execution import device_cache
        from hyperspace_tpu_torch.execution.executor import Executor

        t0 = time.perf_counter()
        if plan_cache is not None and self._enabled:
            optimized = plan_cache.get_or_optimize(self, plan)
        else:
            optimized = self.optimized_plan(plan)
        t1 = time.perf_counter()
        derive0 = device_cache.derive_seconds()
        executor = Executor(self.device, self.conf)
        result = executor.execute(optimized)
        stats = executor.stats
        stats["host_s"] = {
            "plan": t1 - t0,
            "read": stats.pop("read_s"),
            "derive": device_cache.derive_seconds() - derive0,
            "execute": time.perf_counter() - t1,
        }
        return QueryOutcome(result, stats, optimized)

    def to_pandas(self, plan: LogicalPlan):
        import pandas as pd

        return pd.DataFrame(self.run(plan).decode())


class Hyperspace:
    """The user API (Hyperspace.scala:32-104); `create_index`,
    `create_vector_index` and `ann_search` are ported."""

    def __init__(self, session: HyperspaceSession):
        self.session = session

    def create_index(self, plan: LogicalPlan, index_config: IndexConfig) -> None:
        self.session.manager.create(plan, index_config)

    def create_vector_index(self, plan: LogicalPlan, config) -> None:
        """Build an ANN index over an embedding column (VectorIndexConfig)."""
        self.session.manager.create_vector(plan, config)

    def ann_search(self, plan: LogicalPlan, queries, k: int, nprobe: int | None = None,
                   embedding_column: str | None = None, metric: str | None = None):
        """Top-k nearest neighbours; probes a matching vector index when
        hyperspace is enabled, else brute-forces the source (exact)."""
        from hyperspace_tpu_torch.vector.search import ann_search

        return ann_search(self.session, plan, queries, k, nprobe, embedding_column, metric)

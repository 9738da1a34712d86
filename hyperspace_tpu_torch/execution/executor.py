"""Plan executor: runs logical plans on the session's device.

The analog of Spark's physical planning + execution for the IR's node
types. What matters for speed:

- **bucket pruning** (Filter over an index scan with equality literals on
  every bucket column): recompute the canonical row hash on the literal
  tuple and read ONLY that bucket's file; for a point lookup this divides
  IO by numBuckets;
- decoded columns stay on the device between queries
  (execution/device_cache.py);
- predicates and aggregates evaluate on the device (ops/filter.py,
  ops/aggregate.py).

A port of the JAX package's `Executor._dispatch` for Scan, Filter, Project
and Aggregate. There are no venues: every operator runs on the session's
device.
"""

from __future__ import annotations

import torch

from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.execution.device_cache import DeviceTableCache
from hyperspace_tpu_torch.execution.exec_agg import AggregateMixin
from hyperspace_tpu_torch.execution.exec_scan import ScanFilterMixin
from hyperspace_tpu_torch.execution.table import ColumnTable
from hyperspace_tpu_torch.plan.nodes import Aggregate, Filter, LogicalPlan, Project, Scan
from hyperspace_tpu_torch.plan.prune import prune_columns


class Executor(ScanFilterMixin, AggregateMixin):
    """Runs plans on `device`. `stats` records what physically ran."""

    def __init__(self, device: torch.device, cache: DeviceTableCache):
        self.device = device
        self.cache = cache
        self.stats: dict = {"files_read": 0, "files_pruned": 0, "scan": None, "agg_path": None}

    def execute(self, plan: LogicalPlan) -> ColumnTable:
        return self._execute(prune_columns(plan))

    def _execute(self, plan: LogicalPlan) -> ColumnTable:
        if isinstance(plan, Scan):
            self.stats["scan"] = "IndexScan" if plan.bucket_spec is not None else "TableScan"
            return self._scan(plan)
        if isinstance(plan, Filter):
            return self._filter(plan)
        if isinstance(plan, Project):
            return self._execute(plan.child).select(plan.columns)
        if isinstance(plan, Aggregate):
            return self._aggregate(plan)
        raise HyperspaceError(f"cannot execute plan node {type(plan).__name__}")

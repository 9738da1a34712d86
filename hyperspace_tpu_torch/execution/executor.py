"""Plan executor: runs logical plans on the session's device.

The analog of Spark's physical planning + execution for the IR's node
types. What matters for speed:

- **bucket pruning** (Filter over an index scan with equality literals on
  every bucket column): recompute the canonical row hash on the literal
  tuple and read ONLY that bucket's file; for a point lookup this divides
  IO by numBuckets;
- decoded columns stay on the device between queries, and what queries
  derive from them is cached by identity (execution/device_cache.py);
- range pruning (min/max stats) with a sliced sorted key for range
  predicates over an index scan;
- predicates and aggregates evaluate on the device (ops/filter.py,
  ops/aggregate.py);
- an inner equi-join of two indexes bucketed alike runs per bucket with
  zero exchange (exec_side.py, exec_join.py), and an aggregate over it
  never materializes the joined pairs (exec_join_agg.py).

A port of the JAX package's `Executor._dispatch` for Scan, Filter,
Project (with computed entries, ops/project.py), Join and Aggregate.
There are no venues: every operator runs on the session's device.
"""

from __future__ import annotations

import torch

from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.execution.exec_agg import AggregateMixin
from hyperspace_tpu_torch.execution.exec_join import JoinMixin
from hyperspace_tpu_torch.execution.exec_join_agg import FusedJoinAggMixin
from hyperspace_tpu_torch.execution.exec_scan import ScanFilterMixin
from hyperspace_tpu_torch.execution.exec_side import JoinSidesMixin
from hyperspace_tpu_torch.execution.table import ColumnTable
from hyperspace_tpu_torch.ops.project import project_table
from hyperspace_tpu_torch.plan.nodes import Aggregate, Filter, Join, LogicalPlan, Project, Scan
from hyperspace_tpu_torch.plan.prune import prune_columns


class Executor(ScanFilterMixin, JoinSidesMixin, JoinMixin, FusedJoinAggMixin, AggregateMixin):
    """Runs plans on `device`. `stats` records what physically ran."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stats: dict = {
            "files_read": 0,
            "files_pruned": 0,
            "rows_pruned": 0,
            "range_exact": None,
            "read_s": 0.0,
            "scan": None,
            "agg_path": None,
            "join_path": None,
            "join_kernel": None,
            "num_buckets": None,
        }

    def execute(self, plan: LogicalPlan) -> ColumnTable:
        return self._execute(prune_columns(plan))

    def _execute(self, plan: LogicalPlan) -> ColumnTable:
        if isinstance(plan, Scan):
            self.stats["scan"] = "IndexScan" if plan.bucket_spec is not None else "TableScan"
            return self._scan(plan)
        if isinstance(plan, Filter):
            return self._filter(plan)
        if isinstance(plan, Project):
            child = self._execute(plan.child)
            if plan.is_simple:
                return child.select(plan.columns)
            return project_table(child, plan.columns, plan.schema)
        if isinstance(plan, Join):
            return self._join(plan)
        if isinstance(plan, Aggregate):
            return self._aggregate(plan)
        raise HyperspaceError(f"cannot execute plan node {type(plan).__name__}")

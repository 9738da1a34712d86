"""Aggregate execution (Executor mixin).

A port of the plain GROUP BY path of the JAX package's
`execution/exec_agg.py::AggregateMixin._aggregate`: the child executes,
then one segment-reduce over every channel on the session's device.
Grouping sets, count-distinct, partial-aggregation pushdown and the fused
Aggregate(Join) are not ported yet.
"""

from __future__ import annotations

from hyperspace_tpu_torch.execution.table import ColumnTable
from hyperspace_tpu_torch.ops.aggregate import aggregate_table
from hyperspace_tpu_torch.plan.nodes import Aggregate


class AggregateMixin:
    def _aggregate(self, plan: Aggregate) -> ColumnTable:
        table = self._execute(plan.child)
        self.stats["agg_path"] = f"segment-reduce-{self.device.type}"
        return aggregate_table(table, plan.group_by, plan.aggs, plan.schema)

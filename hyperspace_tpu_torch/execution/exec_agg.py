"""Aggregate execution (Executor mixin).

A port of the plain GROUP BY path of the JAX package's
`execution/exec_agg.py::AggregateMixin._aggregate`: an Aggregate over an
inner join first tries the fused Aggregate(Join) (exec_join_agg.py), as
the JAX package does; otherwise the child executes, then one
segment-reduce over every channel on the session's device. Group ids go
through the identity cache (exec_common.py::_group_ids_cached), as in the
JAX package. An aggregate with no aggregate functions (`distinct()`, the
set operations' left side) takes the group ids only and launches no
reduce. Grouping sets, count-distinct and partial-aggregation pushdown
are not ported yet.
"""

from __future__ import annotations

from hyperspace_tpu_torch.execution.exec_common import _group_ids_cached
from hyperspace_tpu_torch.execution.table import ColumnTable
from hyperspace_tpu_torch.ops.aggregate import aggregate_table
from hyperspace_tpu_torch.plan.nodes import Aggregate


class AggregateMixin:
    def _aggregate(self, plan: Aggregate) -> ColumnTable:
        fused = self._try_fused_join_aggregate(plan)
        if fused is not None:
            return fused
        table = self._execute(plan.child)
        self.stats["agg_path"] = f"segment-reduce-{self.device.type}"
        return aggregate_table(
            table, plan.group_by, plan.aggs, plan.schema, groups=_group_ids_cached(table, plan.group_by)
        )

"""Join execution: the per-bucket merge join over bucket-grouped layouts
and match-pair gathering (Executor mixin).

A port of the inner-join path of the JAX package's
`execution/exec_join.py`: `_join`, `_partition_join` for `how="inner"`
without an ON residual, `_match_pairs` (device path only) and
`_gather_pairs`. Outer, semi and anti joins, ON residuals, null-safe keys
and the broadcast-hash probe are not ported yet and raise; they never
fall back to a wrong answer.
"""

from __future__ import annotations

import torch

from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.execution.exec_common import SideData, _padded_key_codes
from hyperspace_tpu_torch.execution.table import ColumnTable
from hyperspace_tpu_torch.ops import join as join_ops
from hyperspace_tpu_torch.plan.nodes import Join


def check_join_ported(plan: Join) -> None:
    """Raise on the join shapes the port does not execute yet."""
    if plan.how != "inner":
        raise HyperspaceError(f"{plan.how} joins are not ported yet")
    if plan.condition is not None:
        raise HyperspaceError("join ON residuals (condition=) are not ported yet")
    if plan.null_safe:
        raise HyperspaceError("null-safe joins are not ported yet")


class JoinMixin:
    def _join(self, plan: Join) -> ColumnTable:
        check_join_ported(plan)
        lside, rside = self._join_sides(plan)
        return self._partition_join(plan, lside, rside)

    def _partition_join(self, plan: Join, lside: SideData, rside: SideData) -> ColumnTable:
        """Per-bucket merge join over the concatenated bucket-grouped
        layout, all on the device: pad, run bounds, expand, one gather
        per output column — no per-bucket Python loop."""
        lidx, ridx = self._match_pairs(plan, lside, rside)
        return self._gather_pairs(plan, lside.table, rside.table, lidx, ridx)

    def _match_pairs(self, plan: Join, lside: SideData, rside: SideData):
        """(lidx, ridx) global match row indices of the equi-join on the
        device, bucket-major: the shared key factorization (host), the
        within-bucket sort when a side is not sorted, then
        ops/join.merge_join over the bucket-major padded codes."""
        (lk, lperm), (rk, rperm) = _padded_key_codes(lside, rside, plan.left_on, plan.right_on)
        self.stats["num_buckets"] = len(lside.offsets) - 1
        li, ri, totals = join_ops.merge_join(lk, rk)
        self.stats["join_kernel"] = "device-searchsorted"
        # Local (within-bucket) match indices → global row indices.
        dev = lk.device
        lidx = torch.repeat_interleave(torch.from_numpy(lside.offsets[:-1]).to(dev), totals) + li
        ridx = torch.repeat_interleave(torch.from_numpy(rside.offsets[:-1]).to(dev), totals) + ri
        if lperm is not None:
            lidx = lperm[lidx]
        if rperm is not None:
            ridx = rperm[ridx]
        return lidx, ridx

    def _gather_pairs(self, plan: Join, lt: ColumnTable, rt: ColumnTable, lidx, ridx) -> ColumnTable:
        """Materialize matched rows in the join's schema: the left side's
        columns (its key column included) + the right side's non-key
        columns, each one gather on the device."""
        schema = plan.schema
        left_names = {n.lower() for n in plan.left.schema.names}
        cols, dicts, val = {}, {}, {}
        for f in schema.fields:
            src, idx = (lt, lidx) if f.name.lower() in left_names else (rt, ridx)
            name = src.schema.field(f.name).name
            cols[f.name] = src.columns[name][idx]
            if name in src.dictionaries:
                dicts[f.name] = src.dictionaries[name]
            if name in src.validity:
                val[f.name] = src.validity[name][idx]
        return ColumnTable(schema, cols, dicts, val, lt.device)

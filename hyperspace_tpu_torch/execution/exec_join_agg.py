"""Fused Aggregate(Join): aggregate over an inner equi-join without
materializing the joined pairs (Executor mixin).

A port of the JAX package's `execution/exec_join_agg.py`:
`_try_fused_join_aggregate` and `_device_fused_channels`. There is no
host venue: the channels always run on the session's device through
ops/join_agg.py (K2 for the run bounds, K1 for the fold). Its sides come
from `_join_sides`, so they may be zero-exchange aligned, re-bucketized,
bucket-preserved or cut by dynamic partition pruning; a side whose
buckets are not sorted within (an exchanged one) is sorted by
(bucket, code) on the device first. It never takes the broadcast probe. Group ids are
factorized on the host (ops/aggregate.py::group_ids), as for the plain
aggregate. Group ids, channels, pads and channel stacks go through the
identity caches (exec_common.py), as in the JAX package: a repeat over the
same index version derives none of them again.
"""

from __future__ import annotations

import numpy as np
import torch

from hyperspace_tpu_torch.execution.device_cache import device_put_cached
from hyperspace_tpu_torch.execution.exec_common import (
    _agg_channels_cached,
    _group_ids_cached,
    _pad_bucket_major_cached,
    _padded_key_codes,
    _stack_cached,
)
from hyperspace_tpu_torch.execution.table import ColumnTable, to_numpy
from hyperspace_tpu_torch.ops.aggregate import finalize_agg_values
from hyperspace_tpu_torch.ops.join_agg import fused_join_aggregate
from hyperspace_tpu_torch.plan.expr import Col
from hyperspace_tpu_torch.plan.nodes import Aggregate, Join, Project


class FusedJoinAggMixin:
    def _try_fused_join_aggregate(self, plan: Aggregate) -> ColumnTable | None:
        """Aggregate(Join) without materializing the joined pairs. Applies
        when the join is inner without a residual, every aggregate is
        sum/count/mean/min/max over one side's numeric column (or
        count(*)), and the grouping columns (if any) come from one side —
        the primary side, whose rows the groups are made of. Anything
        else returns None and runs the materialized join."""
        child = plan.child
        if isinstance(child, Project) and child.is_simple:
            child = child.child
        if not isinstance(child, Join) or child.how != "inner" or child.condition is not None:
            return None
        join = child
        lnames = {n.lower() for n in join.left.schema.names}
        rnames = {n.lower() for n in join.right.schema.names}

        def side_of(cols) -> str | None:
            cl = {c.lower() for c in cols}
            if cl and cl <= lnames:
                return "left"
            if cl and cl <= rnames:
                return "right"
            return None

        gside = None
        if plan.group_by:
            gside = side_of(plan.group_by)
            if gside is None:
                return None
        spec_sides: list[str | None] = []
        for a in plan.aggs:
            if a.expr is None:
                spec_sides.append(None)  # count(*)
                continue
            if not isinstance(a.expr, Col):
                return None
            s = side_of(a.references())
            if s is None:
                return None
            sch = join.left.schema if s == "left" else join.right.schema
            if sch.field(a.expr.name).is_string:
                return None
            spec_sides.append(s)
        primary = gside or "left"
        secondary = "right" if primary == "left" else "left"

        lside, rside = self._join_sides(join)
        self.stats["join_paths"].append(self.stats["join_path"])
        data = {"left": lside, "right": rside}
        self.stats["agg_path"] = "fused-join-agg"
        self.stats["num_buckets"] = len(lside.offsets) - 1

        (lk, lperm), (rk, rperm) = _padded_key_codes(lside, rside, join.left_on, join.right_on, join.null_safe)
        keys, perms = {"left": lk, "right": rk}, {"left": lperm, "right": rperm}

        ptable = data[primary].table
        gid, k, rep = _group_ids_cached(ptable, plan.group_by)
        if k == 0:  # empty primary side
            if plan.group_by:
                return ColumnTable.empty(plan.schema, device=self.device)
            k, gid, rep = 1, np.zeros(0, np.int64), np.zeros(0, np.int64)

        self.stats["join_kernel"] = "device-run-prefix"
        out, spec_layout = self._device_fused_channels(
            plan, data, keys, perms, primary, secondary, spec_sides, gid, k
        )
        star = out[0]

        keep = star > 0 if plan.group_by else np.ones(k, bool)
        out_schema = plan.schema
        cols: dict[str, np.ndarray] = {}
        dicts: dict[str, np.ndarray] = {}
        validity: dict[str, np.ndarray] = {}
        # rep may be empty when the primary side has no rows but a global
        # (no group_by) aggregate still emits its one row.
        kept_rep = torch.from_numpy(rep[keep[: len(rep)]]).to(ptable.device)
        for c in plan.group_by:
            f = ptable.schema.field(c)
            out_f = out_schema.field(c)
            cols[out_f.name] = to_numpy(ptable.columns[f.name][kept_rep])
            if f.name in ptable.dictionaries:
                dicts[out_f.name] = ptable.dictionaries[f.name]
            gv = ptable.valid_mask(c)
            if gv is not None:
                validity[out_f.name] = to_numpy(gv[kept_rep])
        for spec, (vi, ci) in zip(plan.aggs, spec_layout):
            out_f = out_schema.field(spec.alias)
            cnt = out[ci][keep]
            if spec.fn == "count":
                cols[out_f.name] = cnt.astype(np.int64)
                continue
            val = out[vi][keep]
            if spec.fn == "mean":
                with np.errstate(invalid="ignore", divide="ignore"):
                    val = val / cnt
            empty = cnt == 0
            cols[out_f.name] = finalize_agg_values(val, empty, out_f.device_dtype)
            if empty.any():
                validity[out_f.name] = ~empty
        return ColumnTable.from_numpy(out_schema, cols, dicts, validity, device=self.device)

    def _device_fused_channels(self, plan, data, keys, perms, primary, secondary, spec_sides, gid, k):
        """The channel program's inputs, bucket-major padded on the device
        at natural widths (the widest bucket of each side, as the padded
        key codes `keys`), then ops/join_agg.fused_join_aggregate. Returns
        (host [C, k] channel results, per-spec (value channel, count
        channel) indices)."""
        pk, sk = keys[primary], keys[secondary]
        lp, ls = pk.shape[1], sk.shape[1]

        def pad_rows(side: str, vals: torch.Tensor, fill=0.0) -> torch.Tensor:
            """Per-original-row values of `side` → bucket-sorted padded [B, L]."""
            if perms[side] is not None:
                vals = vals[perms[side]]
            width = lp if side == primary else ls
            return _pad_bucket_major_cached(vals, data[side].offsets, fill=fill, width=width)

        ptable = data[primary].table
        # Pads carry group id k: the dead segment.
        gid_pad = pad_rows(primary, device_put_cached(gid, ptable.device, torch.int32), fill=k)

        channels: list[tuple] = [("star",)]
        p_arrays: list[torch.Tensor] = []
        s_arrays: list[torch.Tensor] = []

        def add_channel(side: str, padded: torch.Tensor, fn: str | None = None) -> int:
            base = "p" if side == primary else "s"
            kind = base + fn if fn in ("min", "max") else base
            arrays = p_arrays if side == primary else s_arrays
            arrays.append(padded)
            channels.append((kind, len(arrays) - 1))
            return len(channels) - 1

        spec_layout: list[tuple[int | None, int]] = []  # (value ch, count ch; 0 = star)
        for spec, s in zip(plan.aggs, spec_sides):
            if s is None:  # count(*)
                spec_layout.append((None, 0))
                continue
            vals, ind = _agg_channels_cached(data[s].table, spec)
            vi = None
            if spec.fn in ("sum", "mean"):
                vi = add_channel(s, pad_rows(s, vals))
            elif spec.fn in ("min", "max"):
                # Extremum channels: nulls and pads carry the ±inf identity.
                ident = float("inf") if spec.fn == "min" else float("-inf")
                vi = add_channel(s, pad_rows(s, _extremum_input(vals, ind, ident), fill=ident), spec.fn)
            ci = add_channel(s, pad_rows(s, ind))
            spec_layout.append((vi, ci))

        dev = pk.device
        b = pk.shape[0]
        pvals = _stack_cached(p_arrays, (0, b, lp), dev)
        svals = _stack_cached(s_arrays, (0, b, ls), dev)
        out = fused_join_aggregate(pk, sk, pvals, svals, gid_pad, k, tuple(channels))
        return to_numpy(out), spec_layout


def _extremum_input(vals: torch.Tensor, ind: torch.Tensor, ident: float) -> torch.Tensor:
    """An extremum channel's input: null slots carry the ±inf identity.
    Derived from stable channels, it is cached like them."""
    from hyperspace_tpu_torch.execution import device_cache as dc

    def build():
        return torch.where(ind > 0, vals, torch.full_like(vals, ident))

    if dc.is_stable(vals) and dc.is_stable(ind):
        return dc.derived(("extremum", dc.ident(vals), dc.ident(ind), ident), (vals, ind), build)
    return build()

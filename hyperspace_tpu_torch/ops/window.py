"""Window functions as sorted-segment computations on the device.

A port of the JAX package's `ops/window.py`. One stable sort by
(partition id, order lanes) yields segment and peer boundaries, and every
function is then a prefix or segment computation over the sorted rows —
no per-partition loop — in torch ops on the table's device:

  - "partition" frame: the whole partition's value, broadcast back;
  - "rows":  running (UNBOUNDED PRECEDING .. CURRENT ROW) prefix sums;
  - "range": the "rows" result at the LAST peer row, shared by peers
    (SQL's default frame with ORDER BY).

The JAX package sorts with `np.lexsort` (partition id primary) and scans
with numpy; here the sort is ops/sortkeys.py's stable LSD sort over the
same lanes, so rows, ties included, land in the same order. Integer sums
accumulate in int64 (exact); float sums in float64, whose order on the
card is not numpy's sequential one, so they may differ in the last bits.
Running min/max rank the values once with a stable sort (NaN last, -0.0
and +0.0 in input order, as numpy's argsort) and take `cummax` of the
int64 key `segment * n + rank`, which restarts per segment. A partition's
min/max is a NaN if the partition holds one (numpy's reduceat), and
otherwise the running extremum at its last row; a partition's float sum
adds its own values (`index_add_`), never a difference of prefix sums.
Group ids for the partitions are the aggregate's
(ops/aggregate.py::group_ids).
"""

from __future__ import annotations

import torch

from hyperspace_tpu_torch.execution.table import ColumnTable, to_tensor
from hyperspace_tpu_torch.ops.aggregate import group_ids
from hyperspace_tpu_torch.ops.project import _expr_input, _full, _torch_dtype
from hyperspace_tpu_torch.ops.sortkeys import device_lanes_perm, lane_tensor, order_lanes
from hyperspace_tpu_torch.plan.expr import Col
from hyperspace_tpu_torch.plan.nodes import WindowSpec


def _segment_starts(arrs: list[torch.Tensor]) -> torch.Tensor:
    """Bool [n]: row i starts a new segment (any key differs from i-1)."""
    n = len(arrs[0])
    new = torch.zeros(n, dtype=torch.bool, device=arrs[0].device)
    if n:
        new[0] = True
        for a in arrs:
            new[1:] |= a[1:] != a[:-1]
    return new


def _segment_ends(new_seg: torch.Tensor) -> torch.Tensor:
    """Bool [n]: row i ends its segment (the next row starts one)."""
    end = torch.ones_like(new_seg)
    end[:-1] = new_seg[1:]
    return end


def _start_index(new_seg: torch.Tensor) -> torch.Tensor:
    """For each row, the index of its segment's first row."""
    idx = torch.arange(len(new_seg), dtype=torch.int64, device=new_seg.device)
    return torch.cummax(torch.where(new_seg, idx, 0), dim=0).values


def _last_index(new_seg: torch.Tensor) -> torch.Tensor:
    """For each row, the index of its segment's last row."""
    seg = torch.cumsum(new_seg, dim=0) - 1
    return torch.nonzero(_segment_ends(new_seg)).flatten()[seg]


def _seg_prefix_sum(vals: torch.Tensor, start_idx: torch.Tensor) -> torch.Tensor:
    """Per-segment running sum (inclusive) via the global cumsum minus the
    segment's base (everything before its first row)."""
    cs = torch.cumsum(vals, dim=0)
    return cs - (cs[start_idx] - vals[start_idx])


def _seg_prefix_extremum(vals: torch.Tensor, new_seg: torch.Tensor, fn: str) -> torch.Tensor:
    """Per-segment running min/max, exactly, with no segment loop: rank
    the values once, combine (segment ordinal, rank) into one int64 key
    whose prefix maximum restarts per segment (the segment term
    dominates), then map winning ranks back to values."""
    n = len(vals)
    order = torch.sort(vals, stable=True).indices
    rank = torch.empty(n, dtype=torch.int64, device=vals.device)
    rank[order] = torch.arange(n, dtype=torch.int64, device=vals.device)
    r = rank if fn == "max" else (n - 1) - rank  # min = max of inverted ranks
    base = (torch.cumsum(new_seg, dim=0) - 1) * n
    acc = torch.cummax(base + r, dim=0).values - base
    if fn == "min":
        acc = (n - 1) - acc
    return vals[order][acc]


def _safe_int(vals: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Cast extremum results to an integer dtype: the ±inf identities of
    rows whose frame holds no valid value (their validity marks them
    NULL) are zero-backed first."""
    return torch.where(torch.isfinite(vals), vals, 0).to(dtype)


def _input(table: ColumnTable, e, venue: str):
    """(values [n], validity or None) of a window function's input, its
    CASE masks on `venue`."""
    if isinstance(e, Col):
        f = table.schema.field(e.name)
        return table.columns[f.name], table.validity.get(f.name)
    vals, valid = _expr_input(table, e, venue)
    return _full(vals, table.num_rows, table.device), valid


def window_table(
    table: ColumnTable,
    partition_by: list[str],
    order_by: list[tuple[str, bool]],
    funcs: list[WindowSpec],
    frame: str,
    out_schema,
    venue: str = "device",
) -> ColumnTable:
    n = table.num_rows
    dev = table.device
    if n == 0:
        return ColumnTable.empty(out_schema, device=dev)
    cols = dict(table.columns)
    dicts = dict(table.dictionaries)
    validity = dict(table.validity)

    gid = to_tensor(group_ids(table, partition_by)[0], dev)
    lanes = [lane_tensor(l, dev) for l in order_lanes(table, order_by)] if order_by else []
    # Partition id primary, then the order lanes; stable, so ties keep
    # input order (row_number determinism).
    if lanes or partition_by:
        perm = device_lanes_perm([gid, *lanes])
    else:
        perm = torch.arange(n, device=dev)
    sgid = gid[perm]
    new_seg = _segment_starts([sgid])
    new_peer = _segment_starts([sgid, *(l[perm] for l in lanes)]) if lanes else new_seg
    start_idx = _start_index(new_seg)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    peer_last = _last_index(new_peer)

    def scatter(sorted_vals: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(sorted_vals)
        out[perm] = sorted_vals
        return out

    for spec, field in zip(funcs, out_schema.fields[len(table.schema.fields) :]):
        if spec.fn in ("lag", "lead"):
            # Partition-bounded shift along the ORDER BY: NULL past the
            # segment's edge (SQL's default).
            vals, valid = _input(table, spec.expr, venue)
            src_dict = table.dictionaries.get(table.schema.field(spec.expr.name).name) if isinstance(spec.expr, Col) else None
            sv = vals[perm]
            if spec.fn == "lag":
                src = idx - spec.offset
                in_seg = src >= start_idx
            else:
                src = idx + spec.offset
                in_seg = src <= _last_index(new_seg)
            src_c = src.clamp(0, n - 1)
            shifted = sv[src_c]
            ok = in_seg if valid is None else (in_seg & valid[perm][src_c])
            if field.is_string:
                cols[field.name] = scatter(shifted)
                if src_dict is not None:
                    dicts[field.name] = src_dict
            else:
                cols[field.name] = scatter(shifted).to(_torch_dtype(field.device_dtype))
            if not bool(ok.all()):
                validity[field.name] = scatter(ok)
            continue
        if spec.fn == "row_number":
            cols[field.name] = scatter(idx - start_idx + 1)
            continue
        if spec.fn == "rank":
            peer_start = torch.cummax(torch.where(new_peer, idx, 0), dim=0).values
            cols[field.name] = scatter(peer_start - start_idx + 1)
            continue
        if spec.fn == "dense_rank":
            dense = torch.cumsum(new_peer, dim=0)
            cols[field.name] = scatter(dense - dense[start_idx] + 1)
            continue

        # Aggregate functions.
        if spec.expr is None:  # count(*)
            vals, valid = torch.ones(n, dtype=torch.int64, device=dev), None
        else:
            vals, valid = _input(table, spec.expr, venue)
        sv = vals[perm]
        svalid = None if valid is None else valid[perm]
        ones = torch.ones(n, dtype=torch.int64, device=dev) if svalid is None else svalid.to(torch.int64)
        is_int = field.dtype in ("int32", "int64", "bool", "date")
        acc_dtype = torch.int64 if is_int and spec.fn in ("sum", "count", "min", "max") else torch.float64
        contrib = sv.to(acc_dtype)
        if svalid is not None and spec.fn in ("sum", "mean"):
            contrib = torch.where(svalid, contrib, torch.zeros((), dtype=acc_dtype, device=dev))
        run_ones = _seg_prefix_sum(ones, start_idx)
        run_ok = run_ones > 0
        if spec.fn == "count":
            run, run_ok = run_ones, None
        elif spec.fn in ("sum", "mean") and frame == "partition" and contrib.is_floating_point():
            # A whole-partition float sum adds the partition's own values
            # (as numpy's bincount does), never a difference of prefix sums.
            seg = torch.cumsum(new_seg, dim=0) - 1
            total = torch.zeros(int(seg[-1]) + 1, dtype=torch.float64, device=dev).index_add_(0, seg, contrib)
            run = total[seg] / run_ones[_last_index(new_seg)] if spec.fn == "mean" else total[seg]
        elif spec.fn in ("sum", "mean"):
            rs = _seg_prefix_sum(contrib, start_idx)
            run = rs.to(torch.float64) / run_ones if spec.fn == "mean" else rs
        else:  # min / max
            fx = contrib.to(torch.float64)
            if svalid is not None:
                fx = torch.where(svalid, fx, float("inf") if spec.fn == "min" else float("-inf"))
            if frame == "partition":
                # The partition's extremum propagates a NaN, as numpy's
                # reduceat does; the running one ranks NaN last.
                seg = torch.cumsum(new_seg, dim=0) - 1
                has_nan = torch.zeros(int(seg[-1]) + 1, dtype=torch.int64, device=dev)
                has_nan.index_add_(0, seg, torch.isnan(fx).to(torch.int64))
                ext = _seg_prefix_extremum(torch.where(torch.isnan(fx), float("-inf") if spec.fn == "max" else float("inf"), fx), new_seg, spec.fn)
                run = torch.where(has_nan[seg] > 0, float("nan"), ext)
            else:
                run = _seg_prefix_extremum(fx, new_seg, spec.fn)
            if is_int:
                run = _safe_int(run, acc_dtype)
        if frame == "partition":
            # The value at the partition's last row, broadcast over it.
            last = _last_index(new_seg)
            run = run[last]
            run_ok = None if run_ok is None else run_ok[last]
        elif frame == "range":
            run = run[peer_last]
            run_ok = None if run_ok is None else run_ok[peer_last]
        cols[field.name] = scatter(run).to(_torch_dtype(field.device_dtype))
        if run_ok is not None and not bool(run_ok.all()):
            validity[field.name] = scatter(run_ok)

    return ColumnTable(out_schema, cols, dicts, validity, dev)

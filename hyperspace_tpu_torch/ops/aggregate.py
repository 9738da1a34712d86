"""Grouped aggregation on the device.

Group identity is factorized on the host (the JAX package's `group_ids`,
copied), the reduction runs as ONE segment-reduce launch over every
channel on the session's device (ops/segment_reduce.py — the CUDA kernel
that replaces the JAX package's Pallas kernel), and only the K-sized
per-group results come back.

Channel layout (the JAX package's `aggregate_arrays`, aggregate.py:503-529):
each aggregate input contributes a value channel reduced by its fn (null
slots masked to the fn's identity: 0 for sums, +inf for min, -inf for
max) followed by a non-null count channel (0/1 indicators, summed), so
count, mean and all-null (NULL result) groups compose from the pair.

The JAX package picks a venue for the reduce (host numpy by default) and
engages its Pallas kernel only behind an exactness gate; the port runs
every aggregate on the session's device, always through the one kernel.

SQL semantics: null inputs are ignored by sum/min/max/mean and count(col);
count(*) counts rows; a group whose inputs are all null yields NULL
(validity mask); null group keys form their own group.
"""

from __future__ import annotations

import numpy as np
import torch

from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.execution.table import ColumnTable, to_numpy
from hyperspace_tpu_torch.ops.segment_reduce import segment_reduce
from hyperspace_tpu_torch.plan.expr import Col
from hyperspace_tpu_torch.schema import Schema


# -- host factorization (a copy of the JAX package's) --------------------------


def _dense_codes(arr: np.ndarray, valid) -> tuple[np.ndarray, int] | None:
    """O(n) factorization for integer columns whose value range is small
    relative to n: rank via a presence table instead of np.unique's
    O(n log n) argsort. Returns (codes [n] int64 with 0 reserved for nulls,
    cardinality incl. the null slot) in VALUE-sorted code order, or None
    when out of range."""
    if not np.issubdtype(arr.dtype, np.integer) or len(arr) == 0:
        return None
    vv = arr if valid is None else arr[valid]
    if len(vv) == 0:
        return np.zeros(len(arr), np.int64), 1
    lo, hi = int(vv.min()), int(vv.max())
    span = hi - lo + 1
    if span > max(4 * len(arr), 1 << 16):
        return None
    offs = arr.astype(np.int64) - lo
    if valid is not None:
        offs = np.where(valid, offs, 0)
    present = np.zeros(span, dtype=bool)
    present[offs[valid] if valid is not None else offs] = True
    ids = np.cumsum(present, dtype=np.int64)  # 1-based rank among present
    codes = ids[offs]
    if valid is not None:
        codes[~valid] = 0
    return codes, int(present.sum()) + 1


def _column_codes(table: ColumnTable, c: str) -> tuple[np.ndarray, int]:
    """(codes [n] int64 with 0 = null, cardinality) for one group column,
    codes in value-sorted order."""
    arr = table.host_column(c)
    valid = table.host_valid_mask(c)
    dense = _dense_codes(arr, valid)
    if dense is not None:
        return dense
    _, inv = np.unique(arr, return_inverse=True)
    inv = inv.astype(np.int64) + 1
    card = int(inv.max()) + 1 if len(inv) else 1
    if valid is not None:
        inv[~valid] = 0
    return inv, card


def _compress(codes: np.ndarray) -> tuple[np.ndarray, int, np.ndarray]:
    """Combined codes → (gid [n] in [0, K), K, rep [K]) with gid order
    following code order."""
    dense = _dense_codes(codes, None)
    if dense is not None:
        gid = dense[0] - 1  # no nulls at this stage; drop the reserved 0
        k = dense[1] - 1
    else:
        uniq, gid = np.unique(codes, return_inverse=True)
        gid = gid.reshape(-1).astype(np.int64)
        k = len(uniq)
    # Any representative row per group works (the key values are equal).
    rep = np.empty(k, dtype=np.int64)
    rep[gid] = np.arange(len(gid), dtype=np.int64)
    return gid, k, rep


def group_ids(table: ColumnTable, group_by: list[str]):
    """Host factorization of the group-key tuples. Returns
    (gid [n] int64, K, rep [K] — a representative row per group)."""
    n = table.num_rows
    if not group_by:
        return np.zeros(n, np.int64), 1, np.zeros(1 if n else 0, np.int64)
    if len(group_by) == 1 and n:
        # Dictionary-coded string group column with no nulls: the codes
        # already ARE compact ranks in value order.
        f = table.schema.field(group_by[0])
        if f.is_string and table.valid_mask(group_by[0]) is None:
            codes = table.host_column(f.name)
            k_dict = len(table.dictionaries[f.name])
            if k_dict:
                used = np.bincount(codes, minlength=k_dict) > 0
                if used.all():
                    gid = codes.astype(np.int64, copy=False)
                    k = k_dict
                else:
                    gid = (np.cumsum(used, dtype=np.int64) - 1)[codes]
                    k = int(used.sum())
                rep = np.empty(k, dtype=np.int64)
                rep[gid] = np.arange(n, dtype=np.int64)
                return gid, k, rep
    combined, total = _column_codes(table, group_by[0])
    for c in group_by[1:]:
        codes, card = _column_codes(table, c)
        if total * card >= np.iinfo(np.int64).max:
            raise HyperspaceError("group-by key cardinalities overflow the int64 code space")
        combined = combined * np.int64(card) + codes
        total *= card
    return _compress(combined)


# -- channels and the device reduce --------------------------------------------


def agg_input(table: ColumnTable, spec) -> tuple[torch.Tensor, torch.Tensor | None, bool]:
    """(values, valid mask or None, is_string_codes) for one AggSpec, on
    the table's device."""
    if spec.expr is None:  # count(*)
        return torch.ones(table.num_rows, dtype=torch.float64, device=table.device), None, False
    if not isinstance(spec.expr, Col):
        raise HyperspaceError("aggregates over computed expressions are not ported yet")
    f = table.schema.field(spec.expr.name)
    valid = table.valid_mask(f.name)
    if f.is_string and spec.fn not in ("min", "max", "count"):
        raise HyperspaceError(f"{spec.fn} over string column {f.name!r}")
    return table.columns[f.name], valid, f.is_string


def aggregate_arrays(inputs: list, gid: torch.Tensor, num_groups: int) -> tuple[np.ndarray, np.ndarray]:
    """Segment-reduce of (values, valid, fn) triples sharing group ids
    (fn ∈ sum/min/max). Returns host (results [A, K], counts [A, K])."""
    if not inputs:
        return np.zeros((0, num_groups)), np.zeros((0, num_groups))
    fns: list[str] = []
    channels: list[torch.Tensor] = []
    for vals, valid, fn in inputs:
        v = vals.to(torch.float64)
        if valid is not None:
            ident = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}[fn]
            v = torch.where(valid, v, torch.full_like(v, ident))
        channels.append(v)
        fns.append(fn)
        # Every input also gets a non-null count (for mean/null results).
        channels.append(
            torch.ones_like(v) if valid is None else valid.to(torch.float64)
        )
        fns.append("sum")
    out = to_numpy(segment_reduce(torch.stack(channels), gid, num_groups, tuple(fns)))
    return out[0::2], out[1::2]


def finalize_agg_values(vals: np.ndarray, empty: np.ndarray, dtype) -> np.ndarray:
    """Per-group aggregate values → output column. Float outputs keep
    legitimately non-finite results; only empty (all-NULL) groups are
    zero-backed, and their validity mask marks them NULL."""
    if np.dtype(dtype).kind == "f":
        safe = np.where(empty, 0, vals)
    else:
        safe = np.where(empty, 0, np.where(np.isfinite(vals), vals, 0))
    return safe.astype(dtype)


def aggregate_table(table: ColumnTable, group_by: list[str], aggs: list, out_schema: Schema) -> ColumnTable:
    """Execute a grouped aggregation over a materialized table; the result
    lies on the table's device."""
    gid, k, rep = group_ids(table, group_by)
    inputs = []
    string_dicts: dict[int, np.ndarray] = {}
    for i, spec in enumerate(aggs):
        vals, valid, is_string = agg_input(table, spec)
        if is_string:
            string_dicts[i] = table.dictionaries[table.schema.field(spec.expr.name).name]
        fn = spec.fn
        if fn == "count":
            vals = torch.ones(table.num_rows, dtype=torch.float64, device=table.device) if valid is None else valid
            valid, fn = None, "sum"
        elif fn == "mean":
            fn = "sum"
        inputs.append((vals, valid, fn))
    if k == 0:
        return ColumnTable.empty(out_schema, device=table.device)
    gid_t = torch.from_numpy(gid.astype(np.int32)).to(table.device)
    results, counts = aggregate_arrays(inputs, gid_t, k)

    cols: dict[str, np.ndarray] = {}
    dicts: dict[str, np.ndarray] = {}
    validity: dict[str, np.ndarray] = {}
    rep_t = torch.from_numpy(rep).to(table.device)
    for c in group_by:
        f = table.schema.field(c)
        out_f = out_schema.field(c)
        cols[out_f.name] = to_numpy(table.columns[f.name][rep_t])
        if f.name in table.dictionaries:
            dicts[out_f.name] = table.dictionaries[f.name]
        gv = table.valid_mask(c)
        if gv is not None:
            validity[out_f.name] = to_numpy(gv[rep_t])
    for i, spec in enumerate(aggs):
        out_f = out_schema.field(spec.alias)
        res, cnt = results[i], counts[i]
        if spec.fn == "count":
            cols[out_f.name] = res.astype(np.int64)
            continue
        if spec.fn == "mean":
            with np.errstate(invalid="ignore", divide="ignore"):
                vals = res / cnt
        else:
            vals = res
        empty = cnt == 0  # all inputs null ⇒ NULL result
        if i in string_dicts:
            cols[out_f.name] = np.where(empty, 0, vals).astype(np.int32)
            dicts[out_f.name] = string_dicts[i]
        else:
            cols[out_f.name] = finalize_agg_values(vals, empty, out_f.device_dtype)
        if empty.any():
            validity[out_f.name] = ~empty
    return ColumnTable.from_numpy(out_schema, cols, dicts, validity, device=table.device)

"""Grouped aggregation, on the device or on the host.

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

The reduce has two venues, as in the JAX package. The device venue runs
every aggregate through the one kernel (the JAX package engages its Pallas
kernel only behind an exactness gate, its lax path otherwise; the port has
no second device path). The host venue (`aggregate_arrays_host`, the JAX
package's, copied) reduces with numpy: bincount sums and min / max by a
stable sort and `reduceat` over the non-empty groups, in exact float64
and row order. It reads the channels' host copies
(`device_cache.host_array`: a card tensor downloads once a query, a stable
one once) and the host group ids, and its [A, K] results go back to the
table's device with the group columns. Counts, integral sums, min and max
are equal on both venues; a non-integral sum agrees within 2·N·u (K1's
float64 atomics vary its last bits). With a mesh (`sharded_segment_reduce`, the JAX package's
`_make_sharded_segment_reduce`) the row dimension shards over it, K1 runs
once on each shard, and the [C, K] partials combine by `psum`, `pmin`
and `pmax` a channel in shard order, the distributed HashAggregate the
reference gets from Spark's partial and final aggregation. The JAX
package runs lax there, not its Pallas kernel; K1 is the port's segment
reduce, so it stays.

An aggregate's input is a column or an expression (`agg_input`): a CASE
takes the filter's predicate semantics for its conditions, float64 legs
and the validity of the branch taken; arithmetic, date parts and math
functions evaluate as ops/project.py's numeric expressions. Expression
channels over stable tables are memoized (`prepared_agg_input`); a
per-query table, such as the pushdown's partial aggregate, never is.

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
from hyperspace_tpu_torch.parallel.mesh import mesh_size, pmax, pmin, psum, row_ranges, to_shard
from hyperspace_tpu_torch.plan.expr import Case, Col
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


def agg_input(table: ColumnTable, spec, venue: str = "device") -> tuple[torch.Tensor, torch.Tensor | None, bool]:
    """(values, valid mask or None, is_string_codes) for one AggSpec, on
    the table's device. A CASE evaluates its conditions with the filter's
    full predicate semantics and its legs in float64, its validity
    following the branch taken, its masks on `venue`; any other expression
    evaluates with the JAX package's numpy dtypes (ops/project.py)."""
    from hyperspace_tpu_torch.ops.project import _case_input, _expr_input, _full

    if spec.expr is None:  # count(*)
        return torch.ones(table.num_rows, dtype=torch.float64, device=table.device), None, False
    if isinstance(spec.expr, Case):
        vals, valid = _case_input(table, spec.expr, venue)
        return vals, valid, False
    if isinstance(spec.expr, Col):
        f = table.schema.field(spec.expr.name)
        valid = table.valid_mask(f.name)
        if f.is_string and spec.fn not in ("min", "max", "count"):
            raise HyperspaceError(f"{spec.fn} over string column {f.name!r}")
        return table.columns[f.name], valid, f.is_string
    vals, valid = _expr_input(table, spec.expr, venue)
    return _full(vals, table.num_rows, table.device), valid, False


def _spec_identity(table: ColumnTable, spec):
    """(refs, id-parts) over every array one AggSpec reads: the identity
    key of its prepared channels. (None, None) when any input is unstable
    (a per-query table, such as a pushdown's partial aggregate: nothing
    to memoize against)."""
    from hyperspace_tpu_torch.execution import device_cache as dc

    names = sorted({r.lower() for r in spec.references()}) if spec.expr is not None else []
    refs: list = []
    parts: list = []
    for nm in names:
        f = table.schema.field(nm)
        for a in (table.columns[f.name], table.dictionaries.get(f.name), table.validity.get(f.name)):
            if a is None:
                parts.append(None)
                continue
            if not dc.is_stable(a):
                return None, None
            refs.append(a)
            parts.append(dc.ident(a))
    return tuple(refs), tuple(parts)


def prepared_agg_input(
    table: ColumnTable, spec, mask_venue: str = "device",
) -> tuple[torch.Tensor, torch.Tensor | None, str]:
    """(values, validity, reduce fn) channel inputs for one AggSpec. An
    expression's are memoized in HOST_DERIVED per (fn, expression, input
    identity) for stable tables, so that repeat queries skip evaluating
    it; a plain column's channel is the column itself."""
    import json

    from hyperspace_tpu_torch.execution import device_cache as dc

    def build():
        vals, valid, _ = agg_input(table, spec, mask_venue)
        fn = {"count": "sum", "mean": "sum"}.get(spec.fn, spec.fn)
        if spec.fn == "count":
            vals = torch.ones(table.num_rows, dtype=torch.float64, device=table.device) if valid is None else valid
            valid = None
        return vals, valid, fn

    if spec.expr is None or isinstance(spec.expr, Col):
        return build()  # the column itself (or ones): nothing is derived
    refs, parts = _spec_identity(table, spec)
    if not refs:  # an unstable input or a constant: nothing to key on
        return build()
    key = ("aggprep", spec.fn, json.dumps(spec.expr.to_json(), sort_keys=True), table.num_rows, parts)
    return dc.derived(key, refs, build)


def sharded_segment_reduce(vals: torch.Tensor, gid: torch.Tensor, num_segments: int, fns: tuple, mesh) -> torch.Tensor:
    """`segment_reduce` with the row dimension sharded over `mesh`: shard
    i reduces its contiguous rows (n / D, rounded up) with one K1 launch
    on its device, and the partials combine on `vals`' device, sums by
    `psum`, extrema by `pmin` / `pmax`, in shard order. A shard with no
    rows holds the identity and launches nothing."""
    from hyperspace_tpu_torch.execution.device_cache import shard_cached

    d = mesh_size(mesh)
    n = vals.shape[1]
    partials = [
        segment_reduce(to_shard(vals[:, lo:hi], mesh, i), shard_cached(gid, mesh, i, lo, hi), num_segments, fns)
        for i, (lo, hi) in enumerate(row_ranges(n, -(-n // d), d)) if hi > lo
    ]
    if len(partials) <= 1:
        return segment_reduce(vals, gid, num_segments, fns) if not partials else partials[0].to(vals.device)
    out = torch.empty((len(fns), num_segments), dtype=torch.float64, device=vals.device)
    for kind, combine in (("sum", psum), ("min", pmin), ("max", pmax)):
        rows = [c for c, f in enumerate(fns) if f == kind]
        if rows:
            out[rows] = combine([p[rows] for p in partials], vals.device)
    return out


def aggregate_arrays(inputs: list, gid: torch.Tensor, num_groups: int, mesh=None) -> tuple[np.ndarray, np.ndarray]:
    """Segment-reduce of (values, valid, fn) triples sharing group ids
    (fn ∈ sum/min/max), sharded over `mesh` where one is given. Returns
    host (results [A, K], counts [A, K])."""
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
    stacked = torch.stack(channels)
    if mesh is not None and mesh_size(mesh) > 1:
        out = sharded_segment_reduce(stacked, gid, num_groups, tuple(fns), mesh)
    else:
        out = segment_reduce(stacked, gid, num_groups, tuple(fns))
    out = to_numpy(out)
    return out[0::2], out[1::2]


def aggregate_arrays_host(inputs: list, gid: np.ndarray, num_groups: int) -> tuple[np.ndarray, np.ndarray]:
    """The host venue of the segment reduce: bincount sums and
    sorted-reduceat min / max in exact float64 over host (values, valid,
    fn) triples. Returns (results [A, K], counts [A, K])."""
    n = len(gid)
    order = None
    group_rows = np.bincount(gid, minlength=num_groups).astype(np.int64)
    results: list[np.ndarray] = []
    counts: list[np.ndarray] = []
    for vals, valid, fn in inputs:
        v = np.asarray(vals, dtype=np.float64)
        if fn == "sum":
            if valid is not None:
                v = np.where(valid, v, 0.0)
            res = np.bincount(gid, weights=v, minlength=num_groups)
        else:
            identity = np.inf if fn == "min" else -np.inf
            if order is None:
                order = np.argsort(gid, kind="stable")
                starts = np.searchsorted(gid[order], np.arange(num_groups))
            sv = v[order]
            if valid is not None:
                sv = np.where(valid[order], sv, identity)
            nonempty = group_rows > 0
            res = np.full(num_groups, identity)
            if n and nonempty.any():
                op = np.minimum if fn == "min" else np.maximum
                # reduceat only over NON-EMPTY groups: an empty group's start
                # equals the next group's, so including it would shrink a
                # neighbour's segment; a non-empty group's segment runs to
                # the next listed start, exactly its true end.
                res[nonempty] = op.reduceat(sv, starts[nonempty])
        cnt = (group_rows.astype(np.float64) if valid is None
               else np.bincount(gid, weights=valid.astype(np.float64), minlength=num_groups))
        results.append(res)
        counts.append(cnt)
    return np.stack(results), np.stack(counts)


def finalize_agg_values(vals: np.ndarray, empty: np.ndarray, dtype) -> np.ndarray:
    """Per-group aggregate values → output column. Float outputs keep
    legitimately non-finite results; only empty (all-NULL) groups are
    zero-backed, and their validity mask marks them NULL."""
    if np.dtype(dtype).kind == "f":
        safe = np.where(empty, 0, vals)
    else:
        safe = np.where(empty, 0, np.where(np.isfinite(vals), vals, 0))
    return safe.astype(dtype)


def aggregate_table(
    table: ColumnTable, group_by: list[str], aggs: list, out_schema: Schema, groups=None, mesh=None,
    venue: str = "device", mask_venue: str = "device",
) -> ColumnTable:
    """Execute a grouped aggregation over a materialized table; the result
    lies on the table's device. `groups` is group_ids' (gid, K, rep) when
    the caller has them (the executor's identity cache); their uploads go
    through the device cache; a factorization made on the device
    (tensors) is used as it is. With `mesh`, the reduce shards over it.
    `venue` "host" reduces with numpy on the host (`aggregate_arrays_host`);
    `mask_venue` is where the inputs' CASE masks evaluate."""
    from hyperspace_tpu_torch.execution.device_cache import device_put_cached, host_array

    gid, k, rep = group_ids(table, group_by) if groups is None else groups
    inputs = []
    string_dicts: dict[int, np.ndarray] = {}
    for i, spec in enumerate(aggs):
        if isinstance(spec.expr, Col) and table.schema.field(spec.expr.name).is_string:
            string_dicts[i] = table.dictionaries[table.schema.field(spec.expr.name).name]
        inputs.append(prepared_agg_input(table, spec, mask_venue))
    if k == 0:
        return ColumnTable.empty(out_schema, device=table.device)
    if venue == "host":
        rep_t = rep if isinstance(rep, torch.Tensor) else device_put_cached(rep, table.device)
        results, counts = aggregate_arrays_host(
            [(host_array(v), None if m is None else host_array(m), fn) for v, m, fn in inputs], host_array(gid), k
        ) if inputs else (np.zeros((0, k)), np.zeros((0, k)))
    else:
        if isinstance(gid, torch.Tensor):  # a factorization made on the device
            gid_t, rep_t = gid.to(torch.int32), rep
        else:
            gid_t, rep_t = device_put_cached(gid, table.device, torch.int32), device_put_cached(rep, table.device)
        results, counts = aggregate_arrays(inputs, gid_t, k, mesh)

    cols: dict[str, np.ndarray] = {}
    dicts: dict[str, np.ndarray] = {}
    validity: dict[str, np.ndarray] = {}
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

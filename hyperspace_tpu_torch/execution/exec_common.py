"""Executor support: side descriptors, key-bound analysis, the identity
caches, the shared key factorization, bucket-major padding, the
broadcast probe, the outer join's null extension and the aggregate
channel inputs.

A port of the JAX package's `execution/exec_common.py` without what
only its unported modules use (hybrid-scan deltas, the run-extremum host
venue, count-distinct, the partial-aggregation leaf): `AlignedSide`
(without its projection: the join gather emits the join's schema
directly), `SideData` with its hash domain and `_hash_fields_compatible`,
`_filter_side`, `_bucket_sorted_codes`, `_pad_bucket_major`,
`_composite_keys`, `_broadcast_probe`, `_copy_field`, `_null_field`
and `_factorize_keys` (null-safe keys included) with its helpers;
`KeyBounds`, `key_bounds`, `predicate_all_key_bounds`, `_stats_overlap`
and `_convert_bounds`; and the identity caches `_stable_table_refs`,
`_group_ids_cached`, `_agg_channels_cached`, `_factorize_keys_cached`,
`_pad_bucket_major_cached` and `_stack_cached` (execution/device_cache.py
says what "stable" means here). The key factorization is a copy and runs
on the host (numpy): it yields int32 rank codes whose order is the key
tuples' order and whose equality across sides is key equality. Sorting,
padding, probing and everything after run as torch ops on the tables'
device.
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import torch

from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.execution import device_cache as dc
from hyperspace_tpu_torch.execution.table import ColumnTable, to_tensor
from hyperspace_tpu_torch.ops.aggregate import agg_input, group_ids
from hyperspace_tpu_torch.ops.filter import eval_predicate_mask
from hyperspace_tpu_torch.ops.join import sentinel_for
from hyperspace_tpu_torch.plan.expr import BinOp, Col, Expr, InList, Lit, split_conjuncts
from hyperspace_tpu_torch.plan.nodes import Scan


@dataclasses.dataclass
class AlignedSide:
    scan: Scan
    # Side-local filter (JoinIndexRule keeps linear sides with filters):
    # applied per bucket BEFORE the merge, preserving bucket grouping and
    # within-bucket sort order (a filtered subsequence stays sorted).
    predicate: Expr | None = None


@dataclasses.dataclass
class SideData:
    """One join side in concatenated bucket-grouped layout: rows of bucket
    b occupy [offsets[b], offsets[b+1])."""

    table: ColumnTable
    offsets: np.ndarray  # [B+1] int64, on the host
    sorted_within: bool  # buckets key-sorted (index files are)?
    # Fields defining the bucket hash domain (the dtypes the row hash was
    # computed in): two bucketings pair only when these are compatible.
    hash_fields: tuple | None = None


def _hash_fields_compatible(a, b) -> bool:
    """Equal key values bucket identically under both domains."""
    if a is None or b is None or len(a) != len(b):
        return False
    for fa, fb in zip(a, b):
        if fa.is_string != fb.is_string:
            return False
        if not fa.is_string and np.dtype(fa.device_dtype) != np.dtype(fb.device_dtype):
            return False
    return True


def _bucket_of(offsets: np.ndarray, device: torch.device) -> torch.Tensor:
    """[n] bucket id of every row of a bucket-grouped layout."""
    counts = torch.from_numpy(np.diff(offsets)).to(device)
    return torch.repeat_interleave(torch.arange(len(counts), device=device), counts)


def _filter_side(side: SideData, predicate: Expr) -> SideData:
    """Apply a side-local filter to bucket-grouped data, recomputing the
    bucket offsets over the surviving rows (grouping and within-bucket
    order are preserved — a filtered subsequence stays sorted). As in the
    JAX package, the filtered side carries no hash domain: a join over it
    leaves no bucket grouping for a later join to reuse."""
    t = side.table
    if t.num_rows == 0:
        return side
    mask = eval_predicate_mask(t, predicate)
    b = len(side.offsets) - 1
    new_counts = torch.bincount(_bucket_of(side.offsets, t.device)[mask], minlength=b)
    offsets = np.concatenate([[0], np.cumsum(new_counts.cpu().numpy())]).astype(np.int64)
    return SideData(t.filter_mask(mask), offsets, side.sorted_within)


def _bucket_sorted_codes(codes: torch.Tensor, side: SideData) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Ensure codes are non-decreasing within each bucket. Returns (sorted
    codes, perm) where perm maps sorted positions back to the side's row
    order (None when already sorted — the index-file case, verified with
    one vectorized pass). Otherwise ONE stable device sort by (bucket,
    code), as the JAX package's device regroup; a single partition is a
    plain stable sort of the codes."""
    n = len(codes)
    if n == 0:
        return codes, None
    bucket_of = _bucket_of(side.offsets, codes.device)
    if side.sorted_within:
        down = codes[1:] < codes[:-1]
        if not bool((down & (bucket_of[1:] == bucket_of[:-1])).any()):
            return codes, None
    # Codes span int32, buckets are small: (bucket << 32) + (code + 2^31)
    # is collision-free and orders rows by (bucket, code).
    key = (bucket_of << 32) + (codes.long() + (1 << 31))
    perm = torch.sort(key, stable=True).indices
    return codes[perm], perm


def _pad_bucket_major(
    values: torch.Tensor, offsets: np.ndarray, fill=None, width: int | None = None
) -> torch.Tensor:
    """[n] bucket-grouped values → [B, L] padded tensor, built with one
    gather. Default fill is the dtype's sort-last sentinel (key codes);
    value channels pass an explicit fill and width."""
    counts = np.diff(offsets)
    b = len(counts)
    lmax = width if width is not None else max(int(counts.max()) if counts.size else 1, 1)
    fill = sentinel_for(values.dtype) if fill is None else fill
    dev = values.device
    if len(values) == 0:
        return torch.full((b, lmax), fill, dtype=values.dtype, device=dev)
    col = torch.arange(lmax, device=dev)
    idx = to_tensor(offsets[:-1], dev)[:, None] + col[None, :]
    mask = col[None, :] < torch.from_numpy(counts).to(dev)[:, None]
    gathered = values[idx.clamp_(max=len(values) - 1)]
    return torch.where(mask, gathered, torch.full((), fill, dtype=values.dtype, device=dev))


def _composite_keys(codes: torch.Tensor, offsets: np.ndarray) -> torch.Tensor:
    """(bucket << 33) + code composites on the codes' device: codes span
    int32 (±2^31) and buckets are small, so the shifted sum is
    collision-free in int64 and globally SORTED for bucket-major
    key-sorted inputs. The semi/anti membership probe's keys."""
    return (_bucket_of(offsets, codes.device) << 33) + codes.long()


def _broadcast_probe(lcodes: torch.Tensor, rcodes: torch.Tensor):
    """Match pairs through a broadcast table on the codes' device: the
    smaller side builds a dense code -> (start, count) table (`bincount`,
    `cumsum`, one stable sort of its codes), every row of the larger side
    probes it with one gather, and duplicate runs expand with
    `repeat_interleave`. The larger side is never sorted. Null codes are
    negative and never match. Returns None when the shared code space is
    too sparse for a table (the caller merges instead); else (lidx,
    ridx) int64 in probe order (the JAX package's `_broadcast_probe`,
    pair for pair)."""
    dev = lcodes.device
    swap = len(lcodes) < len(rcodes)
    build, probe = (lcodes, rcodes) if swap else (rcodes, lcodes)
    tops = [t.max().long() + 1 for t in (build, probe) if len(t)]
    top = max(int(torch.stack(tops).max()), 0) if tops else 0
    if top == 0:
        # Every key on both sides is null-coded: no row can match.
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return empty, empty
    if top > 8 * len(build) + 65_536:
        return None  # sparse code space: the table would dwarf the side
    bvalid = build >= 0
    counts = torch.bincount(build[bvalid].long(), minlength=top)
    starts = torch.cumsum(counts, 0) - counts
    order = torch.sort(build, stable=True).indices  # null codes sort first
    nneg = (~bvalid).sum()
    pvalid = probe >= 0
    pc = torch.where(pvalid, probe.long(), torch.zeros((), dtype=torch.int64, device=dev))
    cnt = torch.where(pvalid, counts[pc], torch.zeros((), dtype=counts.dtype, device=dev))
    lo = nneg + starts[pc]
    if int(counts.max()) <= 1:
        # Unique build keys (the dimension-table case): each probe row
        # matches 0 or 1 build rows, no run expansion.
        probe_idx = torch.nonzero(cnt > 0).flatten()
        build_idx = order[lo[probe_idx]]
    else:
        total = int(cnt.sum())
        probe_idx = torch.repeat_interleave(torch.arange(len(probe), device=dev), cnt, output_size=total)
        run_starts = torch.cumsum(cnt, 0) - cnt
        within = torch.arange(total, device=dev) - run_starts[probe_idx]
        build_idx = order[lo[probe_idx] + within]
    if swap:
        return build_idx, probe_idx  # the build side is the LEFT input
    return probe_idx, build_idx


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=np_dtype)).dtype


def _copy_field(out_f, src: ColumnTable, src_name: str, cols, dicts, val) -> None:
    """Copy src column `src_name` into output field `out_f` (cast where
    the numeric dtypes differ: a right-unmatched outer-join row takes its
    left-named key column from the right side)."""
    sf = src.schema.field(src_name)
    arr = src.columns[sf.name]
    if sf.name in src.dictionaries:
        dicts[out_f.name] = src.dictionaries[sf.name]
        cols[out_f.name] = arr
    else:
        want = _torch_dtype(out_f.device_dtype)
        cols[out_f.name] = arr if arr.ndim > 1 or arr.dtype == want else arr.to(want)
    v = src.validity.get(sf.name)
    if v is not None:
        val[out_f.name] = v


def _null_field(out_f, n: int, dict_src: ColumnTable | None, device, cols, dicts, val) -> None:
    """All-null column for output field `out_f` (outer-join null
    extension). A string field reuses `dict_src`'s dictionary for that
    field, so that the concat with the matched part needs no merge."""
    if out_f.is_vector:
        raise HyperspaceError(f"outer join cannot null-extend vector column {out_f.name!r}")
    if out_f.is_string:
        d = None
        if dict_src is not None:
            try:
                d = dict_src.dictionaries.get(dict_src.schema.field(out_f.name).name)
            except Exception:
                d = None
        if d is None or len(d) == 0:
            d = np.array([""], dtype=object)
        cols[out_f.name] = torch.zeros(n, dtype=torch.int32, device=device)
        dicts[out_f.name] = d
    else:
        cols[out_f.name] = torch.zeros(n, dtype=_torch_dtype(out_f.device_dtype), device=device)
    val[out_f.name] = torch.zeros(n, dtype=torch.bool, device=device)


def _padded_key_codes(
    lside: SideData, rside: SideData, left_on: list[str], right_on: list[str], null_safe: bool = False
) -> list[tuple[torch.Tensor, torch.Tensor | None]]:
    """Per side (left, right): the join keys' int32 codes from the shared
    factorization, sorted within each bucket and padded bucket-major to
    [B, L] (pads at the int32 max), and the perm from sorted positions
    back to the side's rows (None when the buckets were sorted already).
    Every step goes through the identity caches: over stable tables a
    repeat join factorizes, uploads, sorts and pads nothing."""
    lt, rt = lside.table, rside.table
    lkeys = [lt.schema.field(c).name for c in left_on]
    rkeys = [rt.schema.field(c).name for c in right_on]
    lc, rc = _factorize_keys_cached(lt, rt, lkeys, rkeys, null_safe=null_safe)
    out = []
    for side, codes in ((lside, lc), (rside, rc)):
        codes_t = dc.device_put_cached(codes, side.table.device)
        sorted_codes, perm = _bucket_sorted_codes_cached(codes_t, side)
        out.append((_pad_bucket_major_cached(sorted_codes, side.offsets), perm))
    return out


def _agg_channels(table: ColumnTable, spec) -> tuple[torch.Tensor, torch.Tensor]:
    """(masked values, indicator) float64 channels for one AggSpec on the
    table's device, with the plain aggregate path's null semantics: null
    slots carry 0, the indicator marks the valid ones."""
    vals, valid, _ = agg_input(table, spec)
    vals = vals.to(torch.float64)
    if valid is None:
        return vals, torch.ones_like(vals)
    return torch.where(valid, vals, torch.zeros_like(vals)), valid.to(torch.float64)


# -- identity caches (execution/device_cache.py) ------------------------------------


def _stable_table_refs(table: ColumnTable, names: set[str]):
    """(refs, id-parts) over every array the named columns touch (data,
    dictionary, validity), or (None, None) when any is unstable."""
    refs: list = []
    parts: list = []
    for nm in sorted(names):
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


def _group_ids_cached(table: ColumnTable, group_by: list[str]):
    """group_ids memoized on the identity of the (stable) group-key
    columns: repeat aggregations over the same index version or source
    skip the host factorization of millions of keys."""
    if not group_by:
        return group_ids(table, group_by)
    refs, parts = _stable_table_refs(table, {c.lower() for c in group_by})
    if refs is None:
        return group_ids(table, group_by)
    return dc.derived(
        ("gid", tuple(c.lower() for c in group_by), parts), refs, lambda: group_ids(table, group_by)
    )


def _agg_channels_cached(tbl: ColumnTable, spec) -> tuple[torch.Tensor, torch.Tensor]:
    """`_agg_channels` memoized per (expression, input identity) for
    stable tables."""
    refs, parts = _stable_table_refs(tbl, {r.lower() for r in spec.references()})
    if not refs:  # unstable or constant expression: no identity to key on
        return _agg_channels(tbl, spec)
    key = ("aggin", json.dumps(spec.expr.to_json(), sort_keys=True), parts)
    return dc.derived(key, refs, lambda: _agg_channels(tbl, spec))


def _factorize_keys_cached(
    lt: ColumnTable, rt: ColumnTable, lkeys, rkeys, null_safe: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """Pairwise key factorization memoized on the identity of every input
    it reads (key columns, dictionaries, validity), valid only when all
    are stable. Repeat joins over the same index version skip ranking
    entirely; the codes are frozen, so their uploads and pads cache too.
    `null_safe` is part of the key: a set operation and a join over the
    same columns code their nulls differently. Returns (lcodes, rcodes)."""

    def build():
        lc, rc = _factorize_keys([lt], [rt], lkeys, rkeys, null_safe=null_safe)
        return lc[0], rc[0]

    lrefs, lparts = _stable_table_refs(lt, {k.lower() for k in lkeys})
    rrefs, rparts = _stable_table_refs(rt, {k.lower() for k in rkeys})
    if lrefs is None or rrefs is None:
        return build()
    return dc.derived(("fact", (lparts, rparts, null_safe)), lrefs + rrefs, build)


def _bucket_sorted_codes_cached(codes: torch.Tensor, side: SideData) -> tuple[torch.Tensor, torch.Tensor | None]:
    """`_bucket_sorted_codes` through the derived cache when `codes` is
    stable; a side already sorted keeps `codes` itself."""
    if not dc.is_stable(codes):
        return _bucket_sorted_codes(codes, side)

    def build():
        out, perm = _bucket_sorted_codes(codes, side)
        return (None, None) if perm is None else (out, perm)

    out, perm = dc.derived(
        ("bsort", dc.ident(codes), side.offsets.tobytes(), side.sorted_within), (codes,), build
    )
    return (codes, None) if perm is None else (out, perm)


def _pad_bucket_major_cached(
    values: torch.Tensor, offsets: np.ndarray, fill=None, width: int | None = None
) -> torch.Tensor:
    """Bucket-major pad through the derived cache when the input is
    stable."""
    if dc.is_stable(values):
        return dc.derived(
            ("padbm", dc.ident(values), offsets.tobytes(), repr(fill), width),
            (values,),
            lambda: _pad_bucket_major(values, offsets, fill=fill, width=width),
        )
    return _pad_bucket_major(values, offsets, fill=fill, width=width)


def _stack_cached(arrs: list, empty_shape: tuple, device: torch.device) -> torch.Tensor:
    """torch.stack through the derived cache when every channel is stable
    (an [A, B, L] float64 stack is a copy of hundreds of MB a query)."""
    if not arrs:
        return torch.zeros(empty_shape, dtype=torch.float64, device=device)
    if all(dc.is_stable(a) for a in arrs):
        return dc.derived(("stack", tuple(dc.ident(a) for a in arrs)), tuple(arrs), lambda: torch.stack(arrs))
    return torch.stack(arrs)


# -- key bounds for range pruning (a copy of the JAX package's) -----------------------


@dataclasses.dataclass
class KeyBounds:
    """Conjunct bounds on one column: lo/hi literal (None = unbounded) and
    whether each bound is strict (< / >) rather than inclusive."""

    lo: object = None
    lo_strict: bool = False
    hi: object = None
    hi_strict: bool = False


_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}


def _conjunct_col_lit(conj) -> tuple[str, str, object] | None:
    """Destructure one conjunct as (column, op, literal), normalizing
    `lit op col` by flipping the comparison. NaN literals are rejected
    (they defeat ordered-bound reasoning: every comparison is False, but
    searchsorted treats NaN as largest). Returns None otherwise."""
    if not isinstance(conj, BinOp):
        return None
    op = conj.op
    if isinstance(conj.left, Col) and isinstance(conj.right, Lit):
        name, v = conj.left.name, conj.right.value
    elif isinstance(conj.right, Col) and isinstance(conj.left, Lit):
        name, v = conj.right.name, conj.left.value
        op = _FLIP.get(op, op)
    else:
        return None
    if v is None:
        return None
    if isinstance(v, (float, np.floating)) and np.isnan(v):
        return None
    return name, op, v


def _conjunct_bound_ops(conj, key: str) -> list[tuple[str, object]] | None:
    """One conjunct → literal (op, value) bounds it implies on `key`:
    plain comparisons pass through; IN gives its min/max envelope. The
    residual filter mask still applies the exact predicate — bounds only
    need to be a valid superset. (The JAX package's LIKE-prefix and
    date-part bounds wait for those expressions' port.)"""
    if isinstance(conj, InList) and isinstance(conj.child, Col):
        if conj.child.name.lower() != key:
            return None
        vals = conj.values
        if any(isinstance(v, (float, np.floating)) and np.isnan(v) for v in vals):
            return None
        try:
            return [("ge", min(vals)), ("le", max(vals))]
        except TypeError:
            return None
    dec = _conjunct_col_lit(conj)
    if dec is None:
        return None
    name, op, v = dec
    if name.lower() != key or op not in ("eq", "lt", "le", "gt", "ge"):
        return None
    return [(op, v)]


def key_bounds(predicate: Expr, key: str) -> KeyBounds | None:
    """Extract literal comparison bounds on `key` from the predicate's
    conjuncts (key op lit / lit op key; eq pins both ends; IN gives its
    envelope). Returns None when no conjunct bounds the column.
    Incomparable literal types are ignored (the residual filter mask
    still applies them exactly)."""
    key = key.lower()
    b = KeyBounds()
    found = False
    for conj in split_conjuncts(predicate):
        pairs = _conjunct_bound_ops(conj, key)
        if pairs is None:
            continue
        for op, v in pairs:
            try:
                if op in ("gt", "ge", "eq") and (b.lo is None or v > b.lo or (v == b.lo and op == "gt")):
                    b.lo, b.lo_strict = v, op == "gt"
                    found = True
                if op in ("lt", "le", "eq") and (b.hi is None or v < b.hi or (v == b.hi and op == "lt")):
                    b.hi, b.hi_strict = v, op == "lt"
                    found = True
            except TypeError:
                continue
    return b if found else None


def predicate_all_key_bounds(predicate: Expr, key: str) -> bool:
    """True iff EVERY conjunct is a comparable literal bound on `key`
    (eq/lt/le/gt/ge) — i.e. an exact searchsorted slice on the sorted key
    fully implements the predicate and the residual mask is redundant."""
    key = key.lower()
    for conj in split_conjuncts(predicate):
        dec = _conjunct_col_lit(conj)
        if dec is None:
            return False
        name, op, v = dec
        if name.lower() != key or op not in ("eq", "lt", "le", "gt", "ge"):
            return False
        if not isinstance(v, (int, float, bool, np.number)):
            return False
    return True


def _stats_overlap(bounds: KeyBounds, mn, mx) -> bool:
    """Can any value in [mn, mx] satisfy the bounds?"""
    try:
        if bounds.hi is not None and (mn > bounds.hi or (bounds.hi_strict and mn == bounds.hi)):
            return False
        if bounds.lo is not None and (mx < bounds.lo or (bounds.lo_strict and mx == bounds.lo)):
            return False
    except TypeError:
        return True  # incomparable stats: keep the file
    return True


def _bounds_domain(field, bounds: KeyBounds):
    """Conversion putting pruning comparisons in the SAME numeric domain
    the filter mask uses (numpy's promotion, which ops/filter.py keeps):
    float32 columns compare weak scalars in float32 (the literal ROUNDS),
    and int columns compare float literals in float64. Without this,
    pruning could drop rows the mask would keep. Returns None when raw
    comparison already matches (ints vs ints, strings)."""
    dt = np.dtype(field.device_dtype)
    vals = [v for v in (bounds.lo, bounds.hi) if v is not None]
    if dt.kind == "f":
        weak = all(type(v) in (int, float, bool) or isinstance(v, (np.bool_, np.float32)) for v in vals)
        return np.float32 if (dt.itemsize <= 4 and weak) else np.float64
    if dt.kind in "iu" and any(isinstance(v, (float, np.floating)) for v in vals):
        return np.float64
    return None


def _convert_bounds(field, bounds: KeyBounds) -> tuple[KeyBounds, object]:
    """(bounds cast into the comparison domain, stat-value converter)."""
    conv = _bounds_domain(field, bounds)
    if conv is None:
        return bounds, lambda v: v
    try:
        cast = KeyBounds(
            conv(bounds.lo) if bounds.lo is not None else None,
            bounds.lo_strict,
            conv(bounds.hi) if bounds.hi is not None else None,
            bounds.hi_strict,
        )
    except (TypeError, ValueError, OverflowError):
        return bounds, lambda v: v

    def stat_conv(v):
        try:
            return conv(v)
        except (TypeError, ValueError, OverflowError):
            return v

    return cast, stat_conv


# -- key factorization (a copy of the JAX package's, on the host) ---------------


def _key_null_mask(table: ColumnTable, keys: list[str]) -> np.ndarray | None:
    """True where ANY key column is null (such rows never join — SQL:
    NULL = NULL is not true). None when every key column is null-free."""
    m = None
    for k in keys:
        valid = table.host_valid_mask(k)
        if valid is not None:
            m = ~valid if m is None else (m | ~valid)
    return m


def _apply_null_codes(lcodes, rcodes, lnulls, rnulls):
    """Null-keyed rows get side-distinct negative codes (-2 left, -1
    right): they sort first and can never equal across sides, so the merge
    drops them with zero extra work."""
    for c, m in zip(lcodes, lnulls):
        if m is not None:
            c[m] = -2
    for c, m in zip(rcodes, rnulls):
        if m is not None:
            c[m] = -1
    return lcodes, rcodes


def _factorize_keys(
    ltables, rtables, lkeys, rkeys, null_safe: bool = False
) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Map each partition's key tuples to a shared int32 rank-code space
    whose order matches the lexicographic order of the raw key tuples
    (host numpy arrays; ranks always fit, bounded by the row count).

    `null_safe` switches the NULL treatment from SQL join equality (a
    null-keyed row never matches: side-distinct negative codes) to SQL
    set / IS NOT DISTINCT FROM equality: per key column, NULL becomes one
    extra domain value SHARED across sides (code `len(uniq)`), so
    (1, NULL) matches (1, NULL) but still not (1, 0) — the physical
    zero or "" a null slot holds can no longer collide with a real
    value."""
    lnulls = [_key_null_mask(t, lkeys) for t in ltables]
    rnulls = [_key_null_mask(t, rkeys) for t in rtables]
    has_nulls = any(m is not None for m in lnulls + rnulls)
    # Fast path: a single integer key whose value SPAN fits int32 needs no
    # ranking — values shifted by the minimum are order-preserving,
    # non-negative codes, so a negative code always means a null-keyed
    # row (what the broadcast and membership probes rely on). (Skipped
    # with nulls: raw values could collide with the null codes.)
    if len(lkeys) == 1 and not has_nulls:
        lvals = [_logical_key(t, lkeys[0]) for t in ltables]
        rvals = [_logical_key(t, rkeys[0]) for t in rtables]
        if all(np.issubdtype(v.dtype, np.integer) for v in lvals + rvals):
            lo = min((int(v.min()) for v in lvals + rvals if len(v)), default=0)
            hi = max((int(v.max()) for v in lvals + rvals if len(v)), default=0)
            # Span strictly below int32 max: the sentinel pad must still
            # sort last after the shift.
            if hi - lo < np.iinfo(np.int32).max - 1:
                shift = np.int64(lo)
                return (
                    [(v.astype(np.int64) - shift).astype(np.int32) for v in lvals],
                    [(v.astype(np.int64) - shift).astype(np.int32) for v in rvals],
                )

    def null_masks(lname, rname):
        return [t.host_valid_mask(lname) for t in ltables] + [t.host_valid_mask(rname) for t in rtables]

    per_col_codes_l: list[list[np.ndarray]] = [[] for _ in ltables]
    per_col_codes_r: list[list[np.ndarray]] = [[] for _ in rtables]
    cards: list[int] = []
    for lname, rname in zip(lkeys, rkeys):
        dict_res = _dict_domain_codes(ltables, rtables, lname, rname)
        if dict_res is not None:
            # Dictionary-coded string keys factorize in the DICTIONARY
            # domain: merge the small sorted dictionaries and remap each
            # side's codes with one gather.
            lvals, rvals, card = dict_res
            if null_safe and has_nulls:
                masks = null_masks(lname, rname)
                if any(m is not None for m in masks):
                    lvals = [v.copy() for v in lvals]
                    rvals = [v.copy() for v in rvals]
                    any_null = False
                    for v, m in zip(lvals + rvals, masks):
                        if m is not None and (~m).any():
                            v[~m] = card
                            any_null = True
                    if any_null:
                        card += 1
            cards.append(max(card, 1))
            for i, v in enumerate(lvals):
                per_col_codes_l[i].append(v)
            for i, v in enumerate(rvals):
                per_col_codes_r[i].append(v)
            continue
        lvals = [_logical_key(t, lname) for t in ltables]
        rvals = [_logical_key(t, rname) for t in rtables]
        allv = np.concatenate(lvals + rvals) if (lvals or rvals) else np.array([])
        uniq, inv = np.unique(allv, return_inverse=True)
        inv = inv.reshape(-1)
        card = max(len(uniq), 1)
        if null_safe and has_nulls:
            # NULL = one extra domain value of this column, shared across
            # sides.
            masks = null_masks(lname, rname)
            if any(m is not None for m in masks):
                alln = np.concatenate([
                    (~m if m is not None else np.zeros(len(v), dtype=bool))
                    for m, v in zip(masks, lvals + rvals)
                ])
                if alln.any():
                    inv = inv.copy()
                    inv[alln] = len(uniq)
                    card = len(uniq) + 1
        cards.append(card)
        pos = 0
        for i, v in enumerate(lvals):
            per_col_codes_l[i].append(inv[pos : pos + len(v)])
            pos += len(v)
        for i, v in enumerate(rvals):
            per_col_codes_r[i].append(inv[pos : pos + len(v)])
            pos += len(v)

    def combine(per_part):
        out = []
        for codes in per_part:
            acc = np.zeros(len(codes[0]) if codes else 0, dtype=np.int64)
            for c, k in zip(codes, cards):
                acc = acc * np.int64(k) + c.astype(np.int64)
            out.append(acc)
        return out

    if math.prod(cards) >= np.iinfo(np.int64).max:
        raise HyperspaceError(f"join key cardinalities {cards} overflow the int64 code space")
    lcomb, rcomb = combine(per_col_codes_l), combine(per_col_codes_r)
    int32_max = np.iinfo(np.int32).max
    # Mixed-radix codes that provably fit int32 cast directly.
    if math.prod(cards) < int32_max:
        lc = [c.astype(np.int32) for c in lcomb]
        rc = [c.astype(np.int32) for c in rcomb]
        if null_safe:
            # Nulls are real domain values in these codes already.
            return lc, rc
        return _apply_null_codes(lc, rc, lnulls, rnulls)
    # Otherwise re-rank the combined codes down to int32 (order preserved
    # by np.unique).
    allc = np.concatenate(lcomb + rcomb) if (lcomb or rcomb) else np.zeros(0, np.int64)
    uniq, inv = np.unique(allc, return_inverse=True)
    if len(uniq) >= int32_max:
        raise HyperspaceError(
            f"join key space has {len(uniq)} distinct tuples — exceeds the int32 code space"
        )
    inv = inv.reshape(-1).astype(np.int32)
    pos, out_l, out_r = 0, [], []
    for c in lcomb:
        out_l.append(inv[pos : pos + len(c)])
        pos += len(c)
    for c in rcomb:
        out_r.append(inv[pos : pos + len(c)])
        pos += len(c)
    if null_safe:
        return out_l, out_r
    return _apply_null_codes(out_l, out_r, lnulls, rnulls)


def _dict_domain_codes(ltables, rtables, lname, rname):
    """Dictionary-domain factorization of one string key column:
    (per-left-table codes, per-right-table codes, cardinality) in the
    merged sorted-dictionary domain, or None when the column pair is not
    string-typed on every table."""
    lfs = [t.schema.field(lname) for t in ltables]
    rfs = [t.schema.field(rname) for t in rtables]
    if not all(f.is_string for f in lfs + rfs):
        return None
    pairs = [(t, t.schema.field(lname).name) for t in ltables] + [
        (t, t.schema.field(rname).name) for t in rtables
    ]
    dicts = [np.asarray(t.dictionaries[nm]) for t, nm in pairs]
    first = dicts[0]
    if all(len(d) == len(first) and np.array_equal(d, first) for d in dicts[1:]):
        # One shared sorted dictionary: the codes already ARE the ranks.
        codes = [t.host_column(nm).astype(np.int64, copy=False) for t, nm in pairs]
        card = len(first)
    else:
        merged = np.unique(np.concatenate([d.astype(str) for d in dicts]))
        codes = []
        for (t, nm), d in zip(pairs, dicts):
            col = t.host_column(nm)
            old_to_new = np.searchsorted(merged, d.astype(str)).astype(np.int64)
            codes.append(old_to_new[col] if len(d) else col.astype(np.int64, copy=False))
        card = len(merged)
    nl = len(ltables)
    return codes[:nl], codes[nl:], card


def _logical_key(table: ColumnTable, name: str) -> np.ndarray:
    f = table.schema.field(name)
    arr = table.host_column(f.name)
    if f.is_string:
        return np.asarray(table.dictionaries[f.name])[arr]
    return arr

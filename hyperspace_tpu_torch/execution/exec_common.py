"""Executor support for joins: side descriptors, the shared key
factorization, bucket-major padding and the aggregate channel inputs.

A port of the subset of the JAX package's `execution/exec_common.py` that
the bucket-aligned inner join and the fused Aggregate(Join) run:
`AlignedSide` (without hybrid-scan deltas, and without the projection:
the join gather emits the join's schema directly), `SideData` (without
the hash domain, which only the re-bucketing exchange and the
bucket-preserved reuse read — neither is ported), `_filter_side`,
`_bucket_sorted_codes`, `_pad_bucket_major` and `_factorize_keys` with
its helpers. The key
factorization is a copy and runs on the host (numpy): it yields int32
rank codes whose order is the key tuples' order and whose equality across
sides is key equality. Sorting, padding and everything after run as torch
ops on the tables' device. The JAX package's identity caches (memoized
factorizations, pads, channel stacks) have no counterpart yet: every
query recomputes them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.execution.table import ColumnTable
from hyperspace_tpu_torch.ops.aggregate import agg_input
from hyperspace_tpu_torch.ops.filter import eval_predicate_mask
from hyperspace_tpu_torch.ops.join import sentinel_for
from hyperspace_tpu_torch.plan.expr import Expr
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


def _bucket_of(offsets: np.ndarray, device: torch.device) -> torch.Tensor:
    """[n] bucket id of every row of a bucket-grouped layout."""
    counts = torch.from_numpy(np.diff(offsets)).to(device)
    return torch.repeat_interleave(torch.arange(len(counts), device=device), counts)


def _filter_side(side: SideData, predicate: Expr) -> SideData:
    """Apply a side-local filter to bucket-grouped data, recomputing the
    bucket offsets over the surviving rows (grouping and within-bucket
    order are preserved — a filtered subsequence stays sorted)."""
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
    idx = torch.from_numpy(offsets[:-1]).to(dev)[:, None] + col[None, :]
    mask = col[None, :] < torch.from_numpy(counts).to(dev)[:, None]
    gathered = values[idx.clamp_(max=len(values) - 1)]
    return torch.where(mask, gathered, torch.full((), fill, dtype=values.dtype, device=dev))


def _padded_key_codes(
    lside: SideData, rside: SideData, left_on: list[str], right_on: list[str]
) -> list[tuple[torch.Tensor, torch.Tensor | None]]:
    """Per side (left, right): the join keys' int32 codes from the shared
    factorization, sorted within each bucket and padded bucket-major to
    [B, L] (pads at the int32 max), and the perm from sorted positions
    back to the side's rows (None when the buckets were sorted already)."""
    lt, rt = lside.table, rside.table
    lkeys = [lt.schema.field(c).name for c in left_on]
    rkeys = [rt.schema.field(c).name for c in right_on]
    lc, rc = _factorize_keys([lt], [rt], lkeys, rkeys)
    out = []
    for side, codes in ((lside, lc[0]), (rside, rc[0])):
        sorted_codes, perm = _bucket_sorted_codes(torch.from_numpy(codes).to(side.table.device), side)
        out.append((_pad_bucket_major(sorted_codes, side.offsets), perm))
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


def _factorize_keys(ltables, rtables, lkeys, rkeys) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Map each partition's key tuples to a shared int32 rank-code space
    whose order matches the lexicographic order of the raw key tuples
    (host numpy arrays; ranks always fit, bounded by the row count).
    Null-keyed rows get side-distinct negative codes. The JAX package's
    null-safe variant (set operations) is not ported."""
    lnulls = [_key_null_mask(t, lkeys) for t in ltables]
    rnulls = [_key_null_mask(t, rkeys) for t in rtables]
    has_nulls = any(m is not None for m in lnulls + rnulls)
    # Fast path: a single integer key whose value SPAN fits int32 needs no
    # ranking — values shifted by the minimum are order-preserving,
    # non-negative codes. (Skipped with nulls: raw values could collide
    # with the null codes.)
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
        cards.append(max(len(uniq), 1))
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

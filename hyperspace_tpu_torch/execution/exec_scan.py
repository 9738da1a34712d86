"""Scan + filter execution: device-resident decode, bucket pruning and
range pruning (Executor mixin).

A port of the JAX package's `execution/exec_scan.py`: `_scan`, `_filter`,
the point (equality / IN) bucket pruning of index scans, and range
(min/max) pruning with the within-file slice of the sorted key
(`_range_prune_list`, `_range_read`). Where the JAX package slices each
surviving file on the host with np.searchsorted, the port finds every
file's slice with one batched torch.searchsorted over the bucket-major
padded keys and gathers the kept rows once: a key range overlaps nearly
every bucket of a hash-bucketed index, and a slice a file, each with a
host sync, would cost more than the query. Hybrid scans are not ported
yet.
"""

from __future__ import annotations

import itertools
import math
import os
import time
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import torch

from hyperspace_tpu_torch.dataset import format_suffix, list_data_files
from hyperspace_tpu_torch.exceptions import IndexCorruptionError
from hyperspace_tpu_torch.execution import io as hio
from hyperspace_tpu_torch.execution.device_cache import DEVICE_CACHE, freeze, nbytes_of
from hyperspace_tpu_torch.execution.exec_common import (
    KeyBounds,
    _convert_bounds,
    _pad_bucket_major_cached,
    _stats_overlap,
    key_bounds,
    predicate_all_key_bounds,
)
from hyperspace_tpu_torch.execution.table import ColumnTable
from hyperspace_tpu_torch.ops.filter import apply_filter
from hyperspace_tpu_torch.ops.hashing import bucket_ids, hash_scalar_key
from hyperspace_tpu_torch.plan.expr import BinOp, Col, Expr, InList, Lit, split_conjuncts
from hyperspace_tpu_torch.plan.nodes import Filter, Scan

# Bucket pruning reads at most this many point combinations; above it
# the (still-correct) mask takes over.
MAX_POINT_COMBOS = 64


def scan_files(scan: Scan) -> list[str]:
    if scan.files is not None:
        return list(scan.files)
    return [fi.path for fi in list_data_files(scan.root, suffix=format_suffix(scan.format))]


def point_prune_names(scan: Scan, predicate: Expr) -> set[str] | None:
    """Bucket file NAMES owned by the predicate's equality/IN literals on
    every bucket column, or None when the predicate does not pin them (or
    the combination count exceeds `MAX_POINT_COMBOS`). IN on the bucket column
    divides IO by numBuckets/|IN|."""
    num_buckets, bucket_cols = scan.bucket_spec
    cand: dict[str, list] = {}
    for conj in split_conjuncts(predicate):
        got: tuple[str, list] | None = None
        if isinstance(conj, BinOp) and conj.op == "eq":
            if isinstance(conj.left, Col) and isinstance(conj.right, Lit):
                got = (conj.left.name.lower(), [conj.right.value])
            elif isinstance(conj.right, Col) and isinstance(conj.left, Lit):
                got = (conj.right.name.lower(), [conj.left.value])
        elif isinstance(conj, InList) and isinstance(conj.child, Col):
            got = (conj.child.name.lower(), list(conj.values))
        if got is not None:
            name, vals = got
            # Conjunctive constraints: keep the smallest candidate list.
            if name not in cand or len(vals) < len(cand[name]):
                cand[name] = vals
    try:
        lists = [cand[c.lower()] for c in bucket_cols]
    except KeyError:
        return None
    if math.prod(len(l) for l in lists) > MAX_POINT_COMBOS:
        return None
    fields = [scan.scan_schema.field(c) for c in bucket_cols]
    names: set[str] = set()
    for combo in itertools.product(*lists):
        h = hash_scalar_key(list(combo), fields)
        names.add(hio.bucket_file_name(int(bucket_ids(h, num_buckets)[0])))
    return names


class ScanFilterMixin:
    def _read(
        self, files: list[str], columns: list[str], schema, index_root: str | None, *, file_rows: bool = False
    ):
        """Read through DEVICE_CACHE, one entry a column (device_cache.py):
        only the columns it lacks are decoded, in one multi-file read;
        files_read counts the files of such a physical read. The files'
        mtimes are part of every key, so a rewritten file misses. An
        unreadable index file surfaces as a typed IndexCorruptionError
        naming the index. With `file_rows`, returns (table, per-file row
        counts)."""
        files = list(files)
        t0 = time.perf_counter()
        try:
            mtimes = tuple(os.stat(f).st_mtime_ns for f in files)
            where = (tuple(files), mtimes)
            dev = str(self.device)
            got = {c: DEVICE_CACHE.get(("col", *where, c, dev)) for c in columns}
            missing = [c for c in columns if got[c] is None]
            rows = None
            if missing:
                table, rows = hio.read_parquet(files, columns=missing, schema=schema, device=self.device,
                                               file_rows=True)
                self.stats["files_read"] += len(files)
                for c in missing:
                    name = table.schema.field(c).name
                    entry = (table.columns[name], table.validity.get(name), table.dictionaries.get(name))
                    if entry[2] is not None:
                        freeze(entry[2])
                    DEVICE_CACHE.put(("col", *where, c, dev), entry, nbytes_of(entry))
                    got[c] = entry
                DEVICE_CACHE.put(("rows", *where), freeze(rows), nbytes_of(rows))
            elif file_rows:
                rows = DEVICE_CACHE.get(("rows", *where))
                if rows is None:  # the columns came from a read without row counts
                    rows = freeze(np.array([pq.read_metadata(f).num_rows for f in files], dtype=np.int64))
                    DEVICE_CACHE.put(("rows", *where), rows, nbytes_of(rows))
        except (OSError, pa.ArrowException) as e:
            if index_root is None:
                raise
            raise IndexCorruptionError(
                f"unreadable index data under {index_root}: {e}",
                index_root=index_root,
                path=files[0] if files else None,
            ) from e
        sub = schema.select(list(columns))
        cols, val, dicts = {}, {}, {}
        for c, f in zip(columns, sub.fields):
            data, valid, d = got[c]
            cols[f.name] = data
            if valid is not None:
                val[f.name] = valid
            if d is not None:
                dicts[f.name] = d
        table = ColumnTable(sub, cols, dicts, val, self.device)
        self.stats["read_s"] += time.perf_counter() - t0
        return (table, rows) if file_rows else table

    def _scan(self, scan: Scan) -> ColumnTable:
        files = scan_files(scan)
        cols = scan.scan_schema.names
        if not files:
            return ColumnTable.empty(scan.scan_schema, device=self.device)
        root = scan.root if scan.bucket_spec is not None else None
        return self._read(files, cols, scan.scan_schema, root)

    def _filter(self, plan: Filter) -> ColumnTable:
        child = plan.child
        if isinstance(child, Scan) and child.bucket_spec is not None:
            pruned = self._prune_bucket_files(child, plan.predicate)
            if pruned is not None:
                self.stats["scan"] = "IndexPointLookup"
                table = self._read(pruned, child.scan_schema.names, child.scan_schema, child.root)
                return apply_filter(table, plan.predicate)
            ranged = self._range_read(child, plan.predicate)
            if ranged is not None:
                table, exact = ranged
                self.stats["scan"] = "IndexRangeScan"
                if exact and predicate_all_key_bounds(plan.predicate, child.bucket_spec[1][0]):
                    # The slice IS the predicate: every conjunct bounds the
                    # sorted key, so the residual mask would be all-true.
                    self.stats["range_exact"] = True
                    return table
                self.stats["range_exact"] = False
                return apply_filter(table, plan.predicate)
        return apply_filter(self._execute(child), plan.predicate)

    def _prune_bucket_files(self, scan: Scan, predicate: Expr) -> list[str] | None:
        """If the predicate pins every bucket column with equality
        literals — single (eq) or multi-point (IN) — return only the
        owning buckets' files."""
        names = point_prune_names(scan, predicate)
        if names is None:
            return None
        files = scan_files(scan)
        matches = [f for f in files if Path(f).name in names]
        if matches:
            self.stats["files_pruned"] += len(files) - len(matches)
            return matches
        return None

    def _range_prune_list(self, scan: Scan, predicate: Expr) -> tuple[list[str], KeyBounds | None, dict] | None:
        """File-level range (min/max) pruning: drop bucket files whose
        manifest key stats cannot overlap the predicate's bounds on the
        leading indexed column, or whose included-column stats cannot
        overlap that column's bounds. Comparisons run in the filter mask's
        own numeric domain so pruning never disagrees with it. Returns
        (kept files, key bounds or None, key stats), or None when no
        literal bounds or no stats exist."""
        key = scan.bucket_spec[1][0]
        bounds = key_bounds(predicate, key)
        files = scan_files(scan)
        stats = hio.file_key_stats(files) if bounds is not None else {}
        if bounds is not None and stats:
            bounds, stat_conv = _convert_bounds(scan.scan_schema.field(key), bounds)
        else:
            stat_conv = None
        refs = {r.lower() for r in predicate.references()}
        extra: list[tuple[KeyBounds, object, dict]] = []
        for c in scan.scan_schema.names:
            if c.lower() == key.lower() or c.lower() not in refs:
                continue
            b = key_bounds(predicate, c)
            if b is None:
                continue
            cstats = hio.file_column_stats(files, c)
            if not cstats:
                continue
            cb, cconv = _convert_bounds(scan.scan_schema.field(c), b)
            extra.append((cb, cconv, cstats))
        if stat_conv is None and not extra:
            return None
        kept: list[str] = []
        for f in files:
            keep = True
            if stat_conv is not None and f in stats:
                st = stats[f]
                # None: the bucket is empty or its key all null; no row can
                # satisfy a literal comparison.
                keep = st is not None and _stats_overlap(bounds, stat_conv(st[0]), stat_conv(st[1]))
            for cb, cconv, cstats in extra:
                if not keep:
                    break
                if f in cstats:
                    st = cstats[f]
                    keep = st is not None and _stats_overlap(cb, cconv(st[0]), cconv(st[1]))
            if keep:
                kept.append(f)
        if stat_conv is None and len(kept) == len(files):
            # Included-column stats pruned nothing and the key gives no
            # slicing bounds: stay on the plain scan path.
            return None
        self.stats["files_pruned"] += len(files) - len(kept)
        return kept, (bounds if stat_conv is not None else None), stats

    def _range_read(self, scan: Scan, predicate: Expr) -> tuple[ColumnTable, bool] | None:
        """Range pruning, then each surviving file sliced to the rows its
        sorted key bounds admit. Every file's slice comes from one batched
        torch.searchsorted over the kept files' keys padded bucket-major
        ([files, widest]), and the kept rows from one gather. String keys
        (dictionary codes are not ordered across files), files whose key
        holds nulls and files without stats are not sliced (the mask does
        the rest). Returns (table, exact): exact when every row returned
        provably satisfies the key bounds (every non-empty file sliced on
        a null-free, stats-backed, non-float key)."""
        pruned = self._range_prune_list(scan, predicate)
        if pruned is None:
            return None
        kept, bounds, stats_files = pruned
        schema = scan.scan_schema
        field = schema.field(scan.bucket_spec[1][0])
        if not kept:
            return ColumnTable.empty(schema, device=self.device), True
        table, rows = self._read(kept, schema.names, schema, scan.root, file_rows=True)
        offsets = np.concatenate([[0], np.cumsum(rows)]).astype(np.int64)
        nonempty = rows > 0
        # Float keys can hold NaN values (sorted last by the build): a
        # lower-bound-only slice would keep them where the mask drops them.
        exact = bounds is not None and np.dtype(field.device_dtype).kind != "f"
        sliceable = np.array([bounds is not None and not field.is_string and f in stats_files for f in kept])
        if bool(sliceable.any()) and field.name in table.validity:
            # A file whose key holds nulls is not sorted on it from its
            # first row: whole, and masked.
            nulls = torch.cumsum((~table.validity[field.name]).to(torch.int64), 0)
            at = torch.from_numpy(offsets).to(nulls.device)
            per_file = torch.diff(torch.cat([nulls.new_zeros(1), nulls]).index_select(0, at)).cpu().numpy()
            sliceable &= per_file == 0
        if not bool(sliceable[nonempty].all()):
            exact = False
        lo_i, hi_i = np.zeros(len(kept), np.int64), rows.astype(np.int64)
        if bool(sliceable.any()):
            lo_i, hi_i = self._slice_bounds(table.columns[field.name], offsets, bounds)
            lo_i = np.where(sliceable, lo_i, 0)
            hi_i = np.where(sliceable, np.maximum(hi_i, lo_i), rows)
        keep_rows = hi_i - lo_i
        self.stats["rows_pruned"] += int((rows - keep_rows)[nonempty].sum())
        if int(keep_rows.sum()) == int(rows.sum()):
            return table, exact
        starts = torch.from_numpy(offsets[:-1] + lo_i).to(self.device)
        counts = torch.from_numpy(keep_rows).to(self.device)
        total = int(keep_rows.sum())
        base = torch.repeat_interleave(starts - (torch.cumsum(counts, 0) - counts), counts, output_size=total)
        return table.take(base + torch.arange(total, device=self.device)), exact

    @staticmethod
    def _slice_bounds(keys: torch.Tensor, offsets: np.ndarray, bounds: KeyBounds):
        """Per file [lo, hi) of the rows within `bounds` on the sorted
        `keys`, as np.searchsorted finds them on each file alone: one
        torch.searchsorted a side over the bucket-major padded keys, in
        the filter mask's comparison domain (integer keys take integer
        bounds: a float bound rounds inward), clipped to each file's rows
        so that pads never count."""
        rows = np.diff(offsets)
        lo_i, hi_i = np.zeros_like(rows), rows
        if keys.dtype.is_floating_point:
            # _convert_bounds put the bounds in float32 only where the
            # column and the literals allow it.
            domain = torch.float32 if all(
                isinstance(v, np.float32) for v in (bounds.lo, bounds.hi) if v is not None
            ) and keys.dtype == torch.float32 else torch.float64
            lo = None if bounds.lo is None else (float(bounds.lo), bounds.lo_strict)
            hi = None if bounds.hi is None else (float(bounds.hi), not bounds.hi_strict)
            fill = float("inf")
        else:
            domain = torch.int64 if keys.dtype == torch.bool else keys.dtype
            info = torch.iinfo(domain)
            lo = hi = None
            if bounds.lo is not None:
                v = bounds.lo
                # The least admitted integer (±inf past every one).
                first = v if math.isinf(v) else math.floor(v) + 1 if bounds.lo_strict else math.ceil(v)
                if first > info.max:
                    return rows.copy(), hi_i
                lo = (first, False) if first > info.min else None
            if bounds.hi is not None:
                v = bounds.hi
                last = v if math.isinf(v) else math.ceil(v) - 1 if bounds.hi_strict else math.floor(v)
                if last < info.min:
                    return lo_i, np.zeros_like(rows)
                hi = (last, True) if last < info.max else None
            fill = None
        values = keys if keys.dtype == domain else keys.to(domain)
        padded = _pad_bucket_major_cached(values, offsets, fill=fill)
        found = []
        for bound in (lo, hi):
            if bound is not None:
                probe = torch.full((len(rows), 1), bound[0], dtype=domain, device=keys.device)
                found.append(torch.searchsorted(padded, probe, right=bound[1])[:, 0])
        found = torch.stack(found).cpu().numpy() if found else None
        if lo is not None:
            lo_i = np.minimum(found[0], rows)
        if hi is not None:
            hi_i = np.minimum(found[-1], rows)
        return lo_i, hi_i

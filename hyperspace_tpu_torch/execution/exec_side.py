"""Join side preparation: aligned-side detection, bucket data, the
re-bucketing exchange, the bucket-preserved reuse of an inner join's
output and dynamic partition pruning (Executor mixin).

A port of the JAX package's `execution/exec_side.py`: `_join_sides` with
every branch — the zero-exchange aligned path (both sides index scans
bucketed alike on their join keys) with its dynamic-partition-pruning
producer, the one-keyed-side exchange or preserved reuse with the DPP
soundness rule per join type, the preserved-or-rebucketized pairing of
two unindexed sides, and the single-partition fallback — and
`_base_rows`, `_side_key_bounds`, `_table_key_bounds`,
`_rebucketize_side`, `_side_data`, `_dpp_bucket_set` and the DPP cut.

The port reads a side as ONE multi-file table with bucket offsets, not as
one table a bucket, so the JAX package's per-bucket range slice and
key-set cut become one pass over the whole side on the device: a range
mask over the buckets the build sorted (a sorted bucket's rows inside
[lo, hi] are its one contiguous slice) and one `torch.searchsorted`
membership probe against the producer's sorted key set. The cut is
memoized in HOST_DERIVED on the side's stable identity, so a repeated
query sees the same tensors. The exchange hashes rows on the host (the
row hash, as the build does) and groups them on the join venue: one
stable device sort of the bucket ids (the JAX package's
`device-sort-exchange`), or on the host the native counting sort
(`host-counting-sort-exchange`; numpy's stable argsort,
`host-argsort-exchange`, where the library is turned off). A hybrid
side (a Union of an index scan and the appended files' scans, from hybrid
scan) is an aligned side with deltas: its delta rows are hashed on the
host on the bucket columns in build order and, with the index rows'
bucket ids, grouped by one stable device sort (`_merge_deltas`). As in
the JAX package, DPP cuts only the index rows; the deltas join whole.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np
import torch

from hyperspace_tpu_torch import native
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.execution import device_cache as dc
from hyperspace_tpu_torch.execution import io as hio
from hyperspace_tpu_torch.execution.exec_common import (
    AlignedSide,
    SideData,
    _bucket_of,
    _filter_side,
    _hash_fields_compatible,
    _stable_table_refs,
)
from hyperspace_tpu_torch.execution.exec_scan import scan_files
from hyperspace_tpu_torch.execution.table import ColumnTable, to_tensor
from hyperspace_tpu_torch.execution.build_exchange import NULL_HASH, compute_row_hashes
from hyperspace_tpu_torch.ops.hashing import bucket_ids, combine_hashes, hash_int_column, string_dict_hashes
from hyperspace_tpu_torch.plan.expr import And
from hyperspace_tpu_torch.plan.nodes import Filter, Join, LogicalPlan, Project, Scan, Union


class JoinSidesMixin:
    @staticmethod
    def _bucket_hash_dtypes(scan: Scan) -> tuple[str, ...]:
        """The hash domain of a scan's bucket columns. The canonical row
        hash is dtype-sensitive (an int64 mixes two words; an int32 one),
        so two bucketings agree on equal key VALUES only when the bucket
        column dtypes agree."""
        out = []
        for c in scan.bucket_spec[1]:
            f = scan.scan_schema.field(c)
            out.append("string" if f.is_string else str(np.dtype(f.device_dtype)))
        return tuple(out)

    def _keyed_on_buckets(self, side: AlignedSide | None, join_on: list[str]) -> bool:
        """True iff the side is an index scan bucketed exactly on its join
        keys (the precondition for any bucket-parallel pairing)."""
        return (
            side is not None
            and side.scan.bucket_spec is not None
            and [c.lower() for c in side.scan.bucket_spec[1]] == [c.lower() for c in join_on]
        )

    def _join_sides(self, plan: Join) -> tuple[SideData, SideData]:
        """Per-side bucket data for a join — the one place that decides
        between the zero-exchange aligned path (both sides bucketed with
        equal counts on the join keys), the re-bucketing exchange (one
        side bucketed, the other re-bucketized on the fly to match), the
        bucket-preserving reuse of an inner join's output grouping, and
        the single-partition fallback. Sets `join_path` last: a nested
        join executed on the way sets its own and must not leak into this
        frame's label."""
        left_side = self._aligned_side(plan.left)
        right_side = self._aligned_side(plan.right)
        if (
            self._keyed_on_buckets(left_side, plan.left_on)
            and self._keyed_on_buckets(right_side, plan.right_on)
            and left_side.scan.bucket_spec[0] == right_side.scan.bucket_spec[0]
            # Equal VALUES hash identically only in equal dtype domains.
            and self._bucket_hash_dtypes(left_side.scan) == self._bucket_hash_dtypes(right_side.scan)
        ):
            self.stats["join_path"] = "zero-exchange-aligned"
            num_buckets = left_side.scan.bucket_spec[0]
            # Dynamic partition pruning: build the predicate-bearing side
            # FIRST, bound its surviving join keys, and skip or cut the
            # other side's buckets that cannot hold a match (inner joins
            # only: an outer side must keep its unmatched rows).
            producer = None
            if plan.how == "inner":
                if left_side.predicate is not None and right_side.predicate is None:
                    producer = "left"
                elif right_side.predicate is not None and left_side.predicate is None:
                    producer = "right"
                elif left_side.predicate is not None and right_side.predicate is not None:
                    producer = "left" if self._base_rows(left_side) <= self._base_rows(right_side) else "right"
            if producer == "left":
                lside = self._side_data(left_side, num_buckets)
                bounds = self._side_key_bounds(lside, left_side)
                rside = self._side_data(right_side, num_buckets, dpp_bounds=bounds)
            elif producer == "right":
                rside = self._side_data(right_side, num_buckets)
                bounds = self._side_key_bounds(rside, right_side)
                lside = self._side_data(left_side, num_buckets, dpp_bounds=bounds)
            else:
                lside = self._side_data(left_side, num_buckets)
                rside = self._side_data(right_side, num_buckets)
            return lside, rside
        # One side bucketed on its join keys: the other side can ride a
        # query-time re-bucketing exchange so the merge stays
        # bucket-parallel.
        mode = self.conf.join_rebucketize
        lt = rt = None
        l_keyed = self._keyed_on_buckets(left_side, plan.left_on)
        r_keyed = self._keyed_on_buckets(right_side, plan.right_on)
        if mode != "off" and l_keyed != r_keyed:
            if l_keyed:
                idx_side, other_plan, other_on = left_side, plan.right, plan.right_on
            else:
                idx_side, other_plan, other_on = right_side, plan.left, plan.left_on
            num_buckets = idx_side.scan.bucket_spec[0]
            idx_fields = [idx_side.scan.scan_schema.field(c) for c in idx_side.scan.bucket_spec[1]]
            t_other = self._execute(other_plan)
            preserved = self._preserved_sidedata(t_other, other_on)
            if preserved is not None and not (
                len(preserved.offsets) - 1 == num_buckets
                and _hash_fields_compatible(preserved.hash_fields, idx_fields)
            ):
                preserved = None
            engage = (
                preserved is not None  # reuse is free: always take it
                or mode == "force"
                or not self._should_broadcast(t_other.num_rows, self._base_rows(idx_side))
            )
            if engage:
                sd_other = preserved or self._rebucketize_side(t_other, other_on, idx_fields, num_buckets)
                if sd_other is not None:
                    # The materialized side doubles as the DPP producer
                    # where dropping unmatched INDEXED-side rows early is
                    # sound for the join type (the indexed side must not
                    # be a preserved outer side). Not for a null-safe join
                    # (a set operation): the producer's bounds leave its
                    # nulls out, and there a null key matches. (The JAX
                    # package prunes there too, and its INTERSECT loses
                    # the NULL row; ROADMAP queue 3.)
                    idx_is_right = not l_keyed
                    prune_ok = not plan.null_safe and (
                        plan.how == "inner"
                        or (idx_is_right and plan.how in ("left", "semi", "anti"))
                        or (not idx_is_right and plan.how == "right")
                    )
                    dpp = self._table_key_bounds(t_other, other_on[0]) if prune_ok else None
                    sd_idx = self._side_data(idx_side, num_buckets, dpp_bounds=dpp)
                    self.stats["join_path"] = (
                        "bucket-preserved-aligned" if preserved is not None else "rebucketized-aligned"
                    )
                    self.stats["exchanges"].append("preserved" if preserved is not None else "rebucketize")
                    self._phys(exchange=self.stats["exchanges"][-1], buckets=num_buckets)
                    if l_keyed:
                        return sd_idx, sd_other
                    return sd_other, sd_idx
            if l_keyed:
                rt = t_other
            else:
                lt = t_other
        if mode != "off" and not l_keyed and not r_keyed:
            # Neither side indexed: a child inner join's preserved bucket
            # grouping can still pair — directly against another
            # preserved side, or by re-bucketizing the other side into
            # its domain.
            lt = lt if lt is not None else self._execute(plan.left)
            rt = rt if rt is not None else self._execute(plan.right)
            pl = self._preserved_sidedata(lt, plan.left_on)
            pr = self._preserved_sidedata(rt, plan.right_on)
            if (
                pl is not None
                and pr is not None
                and len(pl.offsets) == len(pr.offsets)
                and _hash_fields_compatible(pl.hash_fields, pr.hash_fields)
            ):
                self.stats["join_path"] = "bucket-preserved-aligned"
                self.stats["exchanges"].append("preserved-both")
                self._phys(exchange="preserved-both", buckets=len(pl.offsets) - 1)
                return pl, pr
            keyed = pl or pr
            if keyed is not None and (mode == "force" or not self._should_broadcast(lt.num_rows, rt.num_rows)):
                if pl is not None:
                    pair = (pl, self._rebucketize_side(rt, plan.right_on, list(pl.hash_fields), len(pl.offsets) - 1))
                else:
                    pair = (self._rebucketize_side(lt, plan.left_on, list(pr.hash_fields), len(pr.offsets) - 1), pr)
                if pair[0] is not None and pair[1] is not None:
                    self.stats["join_path"] = "rebucketized-aligned"
                    self.stats["exchanges"].append("preserved+rebucketize")
                    self._phys(exchange="preserved+rebucketize", buckets=len(keyed.offsets) - 1)
                    return pair
        # General path: one partition (bucket count 1).
        if lt is None:
            lt = self._execute(plan.left)
        if rt is None:
            rt = self._execute(plan.right)
        self.stats["join_path"] = "single-partition"
        return (
            SideData(lt, np.array([0, lt.num_rows], dtype=np.int64), False),
            SideData(rt, np.array([0, rt.num_rows], dtype=np.int64), False),
        )

    def _aligned_side(self, plan: LogicalPlan) -> AlignedSide | None:
        """The side as (index or source scan, conjoined filters) when it is
        a linear chain of filters and passthrough projections over one
        scan (a computed projection is not absorbed: the side then runs
        whole)."""
        node, predicate = plan, None
        while isinstance(node, Filter) or (isinstance(node, Project) and node.is_simple):
            if isinstance(node, Filter):
                predicate = node.predicate if predicate is None else And(predicate, node.predicate)
            node = node.child
        if isinstance(node, Union):
            # Hybrid scan of any width: exactly one bucketed index scan
            # plus unbucketed delta scans (appended files).
            base = None
            deltas: list[Scan] = []
            for inp in node.inputs:
                if isinstance(inp, Project) and inp.is_simple and isinstance(inp.child, Scan):
                    inp = inp.child
                if not isinstance(inp, Scan):
                    return None
                if inp.bucket_spec is not None:
                    if base is not None:
                        return None  # two index scans: not a hybrid side
                    base = inp
                else:
                    deltas.append(inp)
            if base is None:
                return None
            return AlignedSide(base, deltas=tuple(deltas), predicate=predicate)
        if isinstance(node, Scan):
            return AlignedSide(node, predicate=predicate)
        return None

    def _base_rows(self, side: AlignedSide) -> int:
        """Total indexed rows from the side's manifest (`bucketRows`), for
        picking the smaller DPP producer; a large sentinel when unknown."""
        files = scan_files(side.scan)
        if files:
            m = hio.read_manifest_cached(Path(files[0]).parent)
            if m and "bucketRows" in m:
                return int(sum(m["bucketRows"]))
        return 1 << 60

    # Set-based DPP only materializes the producer's distinct keys below
    # these sizes (the semi-join reduction; beyond them the range alone
    # applies).
    _DPP_SET_MAX_ROWS = 4_000_000
    _DPP_SET_MAX_KEYS = 262_144
    # DPP only enumerates the producer's key span when it is this small.
    _DPP_SPAN_LIMIT = 8192

    def _side_key_bounds(self, sdata: SideData, side: AlignedSide):
        """DPP producer bounds of an aligned side (see _table_key_bounds)."""
        return self._table_key_bounds(sdata.table, side.scan.bucket_spec[1][0])

    def _table_key_bounds(self, t: ColumnTable, key: str):
        """(lo, hi, key_set or None) of the surviving join-key values,
        nulls excluded (they never match): lo / hi as Python scalars,
        key_set the SORTED distinct integer keys on the device when small
        enough to enumerate. (None, None, None) = an empty producer,
        which prunes everything. None = no DPP: NaN keys (they poison
        min / max) and string keys (no consumer reads decoded bounds)."""
        f = t.schema.field(key)
        vals = t.columns[f.name]
        valid = t.valid_mask(key)
        if valid is not None:
            vals = vals[valid]
        if len(vals) == 0:
            return (None, None, None)
        kind = np.dtype(f.device_dtype).kind
        if kind == "f" and bool(torch.isnan(vals).any()):
            return None
        if f.name in t.dictionaries:
            return None
        lo, hi = torch.stack([vals.min(), vals.max()]).tolist()
        kset = None
        if kind in "iu" and len(vals) <= self._DPP_SET_MAX_ROWS:
            u = torch.unique(vals)  # sorted
            if len(u) <= self._DPP_SET_MAX_KEYS:
                kset = u
        return (lo, hi, kset)

    def _rebucketize_side(self, table: ColumnTable, key_cols: list[str], idx_fields, num_buckets: int) -> SideData | None:
        """Query-time re-bucketing exchange: group a materialized table
        into the SAME bucket layout an index side uses, by recomputing the
        canonical row hash with each key column cast into the index side's
        dtype domain (equal values then hash identically; values the index
        side cannot represent have no partner there, so their placement
        cannot matter). The hash runs on the host, as the build's does;
        the grouping is one stable sort of the bucket ids on the join venue
        (the device, or the host's counting sort). None when the key shapes
        cannot share a hash domain (string vs non-string)."""
        hs = []
        for c, fi in zip(key_cols, idx_fields):
            f = table.schema.field(c)
            if f.is_string != fi.is_string:
                return None
            arr = table.host_column(c)
            if f.is_string:
                dh = string_dict_hashes(table.dictionaries[f.name])
                h = dh[arr] if len(dh) else np.zeros(len(arr), np.uint32)
            else:
                if arr.dtype != fi.device_dtype:
                    arr = arr.astype(fi.device_dtype)
                h = hash_int_column(arr)
            valid = table.host_valid_mask(c)
            if valid is not None:
                h = np.where(valid, h, NULL_HASH)
            hs.append(h)
        bucket_np = np.asarray(bucket_ids(combine_hashes(hs), num_buckets), dtype=np.int32)
        if self._join_venue() == "device":
            bucket = to_tensor(bucket_np, table.device)
            order = torch.sort(bucket, stable=True).indices
            counts = torch.bincount(bucket, minlength=num_buckets).cpu().numpy()
            self.stats["exchange_kernel"] = "device-sort-exchange"
        else:
            res = native.bucket_perm(bucket_np, num_buckets)
            if res is not None:
                order, counts = res
                self.stats["exchange_kernel"] = "host-counting-sort-exchange"
            else:
                order = np.argsort(bucket_np, kind="stable")
                counts = np.bincount(bucket_np, minlength=num_buckets).astype(np.int64)
                self.stats["exchange_kernel"] = "host-argsort-exchange"
            order = torch.from_numpy(order).to(table.device)
        offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        return SideData(table.take(order), offsets, False, hash_fields=tuple(idx_fields))

    def _side_data(self, side: AlignedSide, num_buckets: int, dpp_bounds=None) -> SideData:
        """One bucket-grouped table per join side: every bucket's files
        read in bucket order as one multi-file read through the session's
        device cache, with the bucket offsets. `dpp_bounds` (lo, hi,
        key_set) are the other side's surviving keys (dynamic partition
        pruning): an enumerable key set or span skips whole bucket FILES
        by hashing the keys to their bucket set, and the rows left are cut
        to the bounds and the key set. The side's own filter applies
        after, per bucket."""
        schema = side.scan.scan_schema
        hf = tuple(schema.field(c) for c in side.scan.bucket_spec[1])
        groups = self._bucket_files_in_order(side.scan, num_buckets)
        if dpp_bounds is not None:
            keep = self._dpp_bucket_set(side, dpp_bounds, num_buckets)
            if keep is not None:
                pruned = sum(len(g) for b, g in enumerate(groups) if b not in keep)
                if pruned:
                    groups = [g if b in keep else [] for b, g in enumerate(groups)]
                    self.stats["files_pruned"] += pruned
                    self._phys(dpp_files_pruned=pruned)
        files = [f for g in groups for f in g]
        if files:
            table, file_rows = self._read(files, schema.names, schema, side.scan.root, file_rows=True)
        else:
            table, file_rows = ColumnTable.empty(schema, device=self.device), np.zeros(0, np.int64)
        # Files of one bucket are adjacent: sum their rows per bucket.
        ends = np.cumsum([len(g) for g in groups])
        file_ends = np.concatenate([[0], np.cumsum(file_rows)]).astype(np.int64)
        offsets = np.concatenate([[0], file_ends[ends]]).astype(np.int64)
        # A bucket of several files (incremental refresh) is not sorted as
        # a whole; one file per bucket is; an empty one trivially is.
        sorted_within = all(len(g) <= 1 for g in groups)
        if dpp_bounds is not None and dpp_bounds[0] is not None and table.num_rows:
            sliceable = np.array([len(g) <= 1 for g in groups])
            rows_before = table.num_rows
            table, offsets = self._dpp_cut_cached(table, offsets, sliceable, schema.field(hf[0].name), dpp_bounds)
            if rows_before - table.num_rows:
                self.stats["rows_pruned"] += rows_before - table.num_rows
                self._phys(dpp_rows_pruned=rows_before - table.num_rows)
        if side.deltas:
            table, offsets = self._merge_deltas(side, table, offsets, num_buckets)
            sorted_within = False
        out = SideData(table, offsets, sorted_within, hash_fields=hf)
        if side.predicate is not None:
            out = _filter_side(out, side.predicate, self.mesh, self._filter_venue())
        return out

    def _merge_deltas(self, side: AlignedSide, table: ColumnTable, offsets: np.ndarray, num_buckets: int):
        """Hybrid scan: the appended files' rows bucketized on the fly and
        merged into the index side's buckets. The delta rows are hashed on
        the host on the bucket columns in BUILD order (not join-key order),
        so they land in the buckets the index used; their bucket ids, after
        the index rows' ids, get one stable device sort, so each bucket
        holds its index rows first, then its delta rows in file order (the
        JAX package's host argsort, row for row). Memoized in HOST_DERIVED
        on the inputs' stable identity, so a repeated query sees the same
        tensors and every derivation keyed on them hits. Returns (table,
        offsets); the buckets are no longer sorted within."""
        schema = side.scan.scan_schema
        keys = list(side.scan.bucket_spec[1])
        dts = [self._read(scan_files(d), schema.names, d.scan_schema, None, fmt=d.format) for d in side.deltas]
        names = {n.lower() for n in schema.names}

        def merge():
            dbs = [to_tensor(bucket_ids(compute_row_hashes(dt, keys), num_buckets), table.device) for dt in dts]
            all_bucket = torch.cat([_bucket_of(offsets, table.device).to(torch.int32), *dbs])
            order = torch.sort(all_bucket, stable=True).indices
            counts = torch.bincount(all_bucket, minlength=num_buckets).cpu().numpy()
            new_offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
            out = ColumnTable.concat([table, *dts]).take(order)
            return out.columns, out.validity, out.dictionaries, new_offsets

        stable = [_stable_table_refs(t, names) for t in (table, *dts)]
        if any(refs is None for refs, _ in stable):
            cols, val, dicts, new_offsets = merge()
        else:
            refs = tuple(r for t_refs, _ in stable for r in t_refs)
            key = ("hybrid", tuple(parts for _, parts in stable), offsets.tobytes(), tuple(k.lower() for k in keys))
            cols, val, dicts, new_offsets = dc.derived(key, refs, merge)
        return ColumnTable(table.schema, dict(cols), dict(dicts), dict(val), table.device), new_offsets

    def _dpp_bucket_set(self, side: AlignedSide, bounds, num_buckets: int):
        """The set of bucket ids the producer's surviving keys can hash
        into, or None when not enumerable (wide span, non-integer or
        multi-column bucket key). Keys are hash-distributed, so file
        min / max stats cannot prune; a small ENUMERABLE key span or key
        set hashes to a concrete bucket subset (on the host: the row
        hash)."""
        lo, hi, kset = bounds
        if lo is None:  # empty producer: nothing joins
            return set()
        if len(side.scan.bucket_spec[1]) != 1:
            return None
        key = side.scan.bucket_spec[1][0]
        f = side.scan.scan_schema.field(key)
        if f.is_string or np.dtype(f.device_dtype).kind not in "iu":
            return None
        if kset is not None and len(kset) <= self._DPP_SPAN_LIMIT:
            vals = kset.cpu().numpy().astype(f.device_dtype, copy=False)
        else:
            span = int(hi) - int(lo) + 1
            if span > self._DPP_SPAN_LIMIT:
                return None
            vals = np.arange(int(lo), int(hi) + 1, dtype=f.device_dtype)
        probe = ColumnTable.from_numpy(side.scan.scan_schema.select([key]), {f.name: vals}, device="cpu")
        return set(np.unique(bucket_ids(compute_row_hashes(probe, [key]), num_buckets)).tolist())

    def _dpp_cut_cached(self, table: ColumnTable, offsets: np.ndarray, sliceable: np.ndarray, key_field, dpp_bounds):
        """The side's rows that can match the producer, and their bucket
        offsets: in each bucket read from one sorted file whose key holds
        no null, the rows within [lo, hi] (the JAX package's
        searchsorted slice of the file); everywhere, with an integer key
        set, the rows whose key is in it (one `torch.searchsorted` against
        the sorted set; nulls never match). A pruned bucket keeps an empty
        run. Memoized in HOST_DERIVED on (the side's stable identity, the
        bounds, a digest of the key set — one a side), so a repeated query
        gets the same tensors and every derivation keyed on them hits.
        Returns (table, offsets); the table itself when nothing is cut."""
        lo, hi, kset = dpp_bounds
        kset_digest = hashlib.md5(kset.cpu().numpy().tobytes()).hexdigest() if kset is not None else None

        def cut():
            keep = self._dpp_keep_mask(table, offsets, sliceable, key_field, lo, hi, kset)
            if keep is None:
                return None
            counts = torch.bincount(_bucket_of(offsets, table.device)[keep], minlength=len(offsets) - 1)
            new_offsets = np.concatenate([[0], np.cumsum(counts.cpu().numpy())]).astype(np.int64)
            out = table.filter_mask(keep)
            return out.columns, out.validity, new_offsets

        refs, parts = _stable_table_refs(table, {n.lower() for n in table.schema.names})
        if not refs:
            got = cut()
        else:
            key = ("dppcut", parts, offsets.tobytes(), sliceable.tobytes(), lo, hi, kset_digest)
            got = dc.derived(key, refs, lambda: cut() or ({}, {}, None))
            if got[2] is None:
                got = None
        if got is None:
            return table, offsets
        cols, val, new_offsets = got
        return ColumnTable(table.schema, dict(cols), dict(table.dictionaries), dict(val), table.device), new_offsets

    @staticmethod
    def _dpp_keep_mask(table, offsets, sliceable, key_field, lo, hi, kset) -> torch.Tensor | None:
        """The DPP cut's row mask on the side's device, or None when it
        keeps every row."""
        colv = table.columns[key_field.name]
        dev = table.device
        valid = table.validity.get(key_field.name)
        keep = None
        if not key_field.is_string:
            b = len(offsets) - 1
            rows = np.diff(offsets)
            slice_b = sliceable & (rows > 0)
            bucket_of = _bucket_of(offsets, dev)
            if valid is not None and bool(slice_b.any()):
                # A bucket whose key holds nulls is not sorted on it from
                # its first row: not sliced.
                nulls = torch.bincount(bucket_of[~valid], minlength=b).cpu().numpy()
                slice_b &= nulls == 0
            if bool(slice_b.any()):
                # The comparison domain of the JAX package's searchsorted
                # (numpy's promotion): float64 where either side is a
                # float, else the column's integers with the bounds
                # clipped to their range.
                v = colv.long() if colv.dtype == torch.bool else colv
                if v.dtype.is_floating_point or isinstance(lo, float) or isinstance(hi, float):
                    v = v.to(torch.float64)
                    in_range = (v >= float(lo)) & (v <= float(hi))
                else:
                    info = torch.iinfo(v.dtype)
                    if lo > info.max or hi < info.min:
                        in_range = torch.zeros(len(v), dtype=torch.bool, device=dev)
                    else:
                        in_range = (v >= max(lo, info.min)) & (v <= min(hi, info.max))
                keep = in_range | ~torch.from_numpy(slice_b).to(dev)[bucket_of]
        if kset is not None and not key_field.is_string and np.dtype(key_field.device_dtype).kind in "iu":
            # Semi-join reduction: only rows whose key is in the
            # producer's distinct set (a sorted subsequence stays sorted).
            c64, k64 = colv.long(), kset.long()
            pos = torch.searchsorted(k64, c64).clamp_(max=len(k64) - 1)
            hit = k64[pos] == c64
            if valid is not None:
                hit &= valid
            keep = hit if keep is None else keep & hit
        if keep is None or bool(keep.all()):
            return None
        return keep

    def _bucket_files_in_order(self, scan: Scan, num_buckets: int) -> list[list[str]]:
        """Per-bucket file groups. A bucket can have several files (base
        version + incremental-refresh deltas); order within a group is the
        sorted file-path order."""
        by_name: dict[str, list[str]] = {}
        for f in sorted(scan_files(scan)):
            by_name.setdefault(Path(f).name, []).append(f)
        out = []
        for b in range(num_buckets):
            name = hio.bucket_file_name(b)
            if name not in by_name:
                raise HyperspaceError(f"missing bucket file {name} in {scan.root}")
            out.append(by_name[name])
        return out

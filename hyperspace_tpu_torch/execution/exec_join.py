"""Join execution: the per-bucket merge join over bucket-grouped layouts,
match-pair derivation, the broadcast probe, outer / semi / anti
composition and ON-residual matching (Executor mixin).

A port of the JAX package's `execution/exec_join.py`, every join type it
executes: `_join` (the inner join's residual as a filter over the
matched rows), `_partition_join` (outer joins null-extend their
unmatched rows; semi and anti joins without a residual are a membership
probe; with one, only the columns the residual reads are gathered; an
outer join's residual changes the matching itself), `_semi_match_mask`,
`_match_pairs` with the broadcast probe and `_should_broadcast`,
`_gather_pairs`, `_left_unmatched` and `_right_unmatched`. The key
factorization runs on the host; the probes and the gathers on the
session's device. The merge has the JAX package's two venues
(`_join_venue`): the device venue pads the sorted codes bucket-major and
merges them with K2 (`device-searchsorted`); the host venue runs the
native C++ merge (`native.merge_join_sorted`, `host-native-merge`) over
the host codes, regrouped on the sort venue, and uploads the pairs for
the gathers. The residual masks run on the filter venue. With the
executor's mesh, the device merge shards its buckets over it
(`ops/join.py::merge_join_sharded`, one K2 a shard; `stats["join_devices"]`)
and the residual masks their rows, as the JAX package's device venue
does.
"""

from __future__ import annotations

import numpy as np
import torch

from hyperspace_tpu_torch.execution import device_cache as dc
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.execution.exec_common import (
    SideData,
    _broadcast_probe,
    _composite_keys,
    _copy_field,
    _factorize_keys_cached,
    _null_field,
    _padded_key_codes,
    _sorted_key_codes,
)
from hyperspace_tpu_torch.execution.table import ColumnTable, to_tensor
from hyperspace_tpu_torch.ops import join as join_ops
from hyperspace_tpu_torch.ops.filter import eval_predicate_mask
from hyperspace_tpu_torch.parallel.mesh import mesh_for_parallelism, mesh_size
from hyperspace_tpu_torch.plan.nodes import Join
from hyperspace_tpu_torch.schema import Schema


def _as_schema(table: ColumnTable, schema: Schema) -> ColumnTable:
    """`table`'s columns named by `schema`'s fields (case-insensitive
    lookup), under `schema`: what a semi / anti join returns of its left
    side, whose table may carry more columns than the join's output."""
    cols, dicts, val = {}, {}, {}
    for f in schema.fields:
        name = table.schema.field(f.name).name
        cols[f.name] = table.columns[name]
        if name in table.dictionaries:
            dicts[f.name] = table.dictionaries[name]
        if name in table.validity:
            val[f.name] = table.validity[name]
    return ColumnTable(schema, cols, dicts, val, table.device)


class JoinMixin:
    def _join(self, plan: Join) -> ColumnTable:
        lside, rside = self._join_sides(plan)
        # The path of THIS frame's decision (_join_sides sets it last,
        # after any nested join it executed).
        path = self.stats["join_path"]
        out = self._partition_join(plan, lside, rside)
        if self.stats["join_kernel"] == "device-broadcast-hash":
            path = "broadcast-hash"
            self.stats["join_path"] = path
        if plan.condition is not None and plan.how == "inner":
            # Inner-join ON residual: a plain 3-valued filter over the
            # matched rows. (Outer / semi / anti residuals alter MATCHING
            # and apply inside _partition_join.) The filtered table is a
            # new table, so it inherits no preserved bucket grouping.
            before = out.num_rows
            out = out.filter_mask(eval_predicate_mask(out, plan.condition, mesh=self.mesh,
                                                      venue=self._filter_venue()))
            self._phys(residual_condition=True, residual_rows_dropped=before - out.num_rows)
        self.stats["join_paths"].append(path)
        self._phys(
            "BroadcastHashJoin" if path == "broadcast-hash" else "SortMergeJoin",
            path=path,
            kernel=self.stats["join_kernel"],
            buckets=self.stats["num_buckets"],
            devices=1,
        )
        return out

    def _partition_join(self, plan: Join, lside: SideData, rside: SideData) -> ColumnTable:
        """Per-bucket merge join over the concatenated bucket-grouped
        layout, all on the device: pad, run bounds, expand, one gather
        per output column — no per-bucket Python loop. Every join type
        derives from the same match pairs: outer joins append the
        unmatched side's rows null-extended, semi / anti keep left rows by
        their match flag."""
        lt, rt = lside.table, rside.table
        how = plan.how

        if how in ("semi", "anti") and plan.condition is None:
            # Existence is a membership probe, not a join: never expand
            # the match pairs (a hot key repeated k×k ways would
            # materialize k² pairs only to collapse into |L| bits).
            matched = self._semi_match_mask(plan, lside, rside)
            return _as_schema(lt.filter_mask(matched if how == "semi" else ~matched), plan.schema)

        lidx, ridx, totals = self._match_pairs(plan, lside, rside)

        if how in ("semi", "anti"):
            # Residual existence (EXISTS with extra conditions): a left
            # row matches iff SOME equi-pair also passes the residual.
            # Gather ONLY the columns the condition reads, evaluate, and
            # reduce the surviving pairs' left rows to bits.
            refs = {r.lower() for r in plan.condition.references()}
            rkeys_low = {rt.schema.field(c).name.lower() for c in plan.right_on}
            left_names = plan.left.schema
            lkeep = [f.name for f in left_names.fields if f.name.lower() in refs]
            if not lkeep:  # keep one cheap key lane so the row count survives
                lkeep = [left_names.field(plan.left_on[0]).name]
            rkeep = [
                f.name for f in plan.right.schema.fields
                if f.name.lower() in refs and f.name.lower() not in rkeys_low
            ]
            sub_schema = Schema(
                tuple(left_names.select(lkeep).fields) + tuple(plan.right.schema.select(rkeep).fields)
            )
            pairs = self._gather_pairs(plan, lt, rt, lidx, ridx, schema=sub_schema)
            pmask = eval_predicate_mask(pairs, plan.condition, mesh=self.mesh, venue=self._filter_venue())
            matched = torch.zeros(lt.num_rows, dtype=torch.bool, device=lt.device)
            kept = lidx[pmask]
            matched[kept] = True
            self._phys(residual_condition=True, residual_pairs_dropped=len(lidx) - len(kept))
            return _as_schema(lt.filter_mask(matched if how == "semi" else ~matched), plan.schema)

        inner = self._gather_pairs(plan, lt, rt, lidx, ridx)
        if plan.condition is not None and how != "inner":
            # An outer join's ON residual alters MATCHING: a pair failing
            # it is no match, so its rows fall through to the
            # null-extended unmatched parts below (computed from the
            # SURVIVING pairs).
            pmask = eval_predicate_mask(inner, plan.condition, mesh=self.mesh, venue=self._filter_venue())
            inner = inner.filter_mask(pmask)
            pairs = len(lidx)
            lidx, ridx = lidx[pmask], ridx[pmask]
            self._phys(residual_condition=True, residual_pairs_dropped=pairs - len(lidx))
        if how == "inner":
            # Bucket-preserving output: an inner join over B > 1 buckets
            # emits pairs bucket-major, so the result STAYS bucket-grouped
            # on the (merged, left-named) join keys — a later join on the
            # same keys reuses the grouping with no exchange.
            if totals is not None and len(totals) > 1 and lside.hash_fields is not None:
                counts = totals.cpu().numpy()
                self._stash_bucketed(
                    inner, np.concatenate([[0], np.cumsum(counts)]).astype(np.int64),
                    plan.left_on, lside.hash_fields,
                )
            return inner
        parts = [inner]
        if how in ("left", "full"):
            lmask = torch.zeros(lt.num_rows, dtype=torch.bool, device=lt.device)
            lmask[lidx] = True
            parts.append(self._left_unmatched(plan, lt, rt, ~lmask))
        if how in ("right", "full"):
            rmask = torch.zeros(rt.num_rows, dtype=torch.bool, device=rt.device)
            rmask[ridx] = True
            parts.append(self._right_unmatched(plan, lt, rt, ~rmask))
        parts = [p for p in parts if p.num_rows > 0]
        if not parts:
            return inner
        return ColumnTable.concat(parts) if len(parts) > 1 else parts[0]

    def _semi_match_mask(self, plan: Join, lside: SideData, rside: SideData) -> torch.Tensor:
        """Per-left-row existence of an equi-match in the right side: one
        sorted membership probe over (bucket, key code) composites on the
        device (`torch.searchsorted`), no pair expansion. Null-keyed rows
        carry side-distinct negative codes and never match (SQL: NULL =
        NULL is not true), so anti keeps them — unless the join is
        null-safe (a set operation), where NULL is a real domain value
        that matches its twin."""
        lt, rt = lside.table, rside.table
        lkeys = [lt.schema.field(c).name for c in plan.left_on]
        rkeys = [rt.schema.field(c).name for c in plan.right_on]
        lc0, rc0 = _factorize_keys_cached(lt, rt, lkeys, rkeys, null_safe=plan.null_safe)
        self.stats["num_buckets"] = len(lside.offsets) - 1
        self.stats["join_kernel"] = "device-membership-probe"
        comp_l = _composite_keys(dc.device_put_cached(lc0, lt.device), lside.offsets)
        comp_r = torch.sort(_composite_keys(dc.device_put_cached(rc0, rt.device), rside.offsets)).values
        matched = torch.zeros(lt.num_rows, dtype=torch.bool, device=lt.device)
        if len(comp_r) == 0:
            return matched
        pos = torch.searchsorted(comp_r, comp_l).clamp_(max=len(comp_r) - 1)
        return comp_r[pos] == comp_l

    def _match_pairs(self, plan: Join, lside: SideData, rside: SideData):
        """(lidx, ridx, totals): global match row indices of the
        equi-join on the device and the per-bucket pair counts (None on
        the broadcast branch). A heavily asymmetric single-partition join
        takes the broadcast probe: only the small side is sorted, the
        large side probes it. Otherwise the shared key factorization
        (host), the within-bucket sort where a side is not sorted, then
        ops/join.merge_join over the bucket-major padded codes; its pairs
        come bucket-major, so `totals` doubles as the output's bucket
        grouping."""
        lt, rt = lside.table, rside.table
        if len(lside.offsets) - 1 == 1 and self._should_broadcast(lt.num_rows, rt.num_rows):
            lkeys = [lt.schema.field(c).name for c in plan.left_on]
            rkeys = [rt.schema.field(c).name for c in plan.right_on]
            lc, rc = _factorize_keys_cached(lt, rt, lkeys, rkeys, null_safe=plan.null_safe)
            res = _broadcast_probe(dc.device_put_cached(lc, lt.device), dc.device_put_cached(rc, rt.device))
            if res is not None:
                self.stats["num_buckets"] = 1
                self.stats["join_kernel"] = "device-broadcast-hash"
                return res[0], res[1], None
        b = len(lside.offsets) - 1
        self.stats["num_buckets"] = b
        regroup = self._sort_venue()
        if self._join_venue() == "host":
            return self._host_match_pairs(plan, lside, rside, regroup)
        (lk, lperm), (rk, rperm) = _padded_key_codes(lside, rside, plan.left_on, plan.right_on, plan.null_safe,
                                                     regroup)
        if self.mesh is not None:
            # The bucket dimension shards over the mesh: one K2 a shard.
            jmesh = mesh_for_parallelism(self.mesh, b)
            li, ri, totals = join_ops.merge_join_sharded(lk, rk, jmesh)
            self.stats["join_devices"] = mesh_size(jmesh)
        else:
            li, ri, totals = join_ops.merge_join(lk, rk)
        self.stats["join_kernel"] = "device-searchsorted"
        # Local (within-bucket) match indices → global row indices.
        dev = lk.device
        lidx = torch.repeat_interleave(to_tensor(lside.offsets[:-1], dev), totals) + li
        ridx = torch.repeat_interleave(to_tensor(rside.offsets[:-1], dev), totals) + ri
        if lperm is not None:
            lidx = lperm[lidx]
        if rperm is not None:
            ridx = rperm[ridx]
        return lidx, ridx, totals

    def _host_match_pairs(self, plan: Join, lside: SideData, rside: SideData, regroup: str):
        """The host venue of `_match_pairs`: the exact bucket-parallel C++
        merge over the host codes sorted within each bucket (on the
        `regroup` venue, brought to the host), the perms applied on the
        host, and the pairs and per-bucket counts uploaded for the
        gathers."""
        from hyperspace_tpu_torch import native
        from hyperspace_tpu_torch.execution.device_cache import host_array

        (lcodes, lperm), (rcodes, rperm) = [
            (host_array(c), None if p is None else host_array(p))
            for c, p in _sorted_key_codes(lside, rside, plan.left_on, plan.right_on, plan.null_safe, regroup)
        ]
        res = native.merge_join_sorted(lcodes, lside.offsets, rcodes, rside.offsets)
        if res is None:
            # pick_venue refuses a forced host without the library; a
            # library turned off later is a fault, never a device retreat.
            raise HyperspaceError("hyperspace.join.venue=host: the native library is turned off")
        lidx, ridx, totals = res
        self.stats["join_kernel"] = "host-native-merge"
        if lperm is not None:
            lidx = lperm[lidx]
        if rperm is not None:
            ridx = rperm[ridx]
        dev = lside.table.device
        return (torch.from_numpy(lidx).to(dev), torch.from_numpy(ridx).to(dev),
                torch.from_numpy(np.asarray(totals, dtype=np.int64)).to(dev))

    def _should_broadcast(self, n_l: int, n_r: int) -> bool:
        """Small-enough and asymmetric-enough for the broadcast probe."""
        cap = self.conf.join_broadcast_max_rows
        if cap <= 0:
            return False
        small, large = min(n_l, n_r), max(n_l, n_r)
        return 0 < small <= cap and large >= 4 * small

    def _gather_pairs(self, plan: Join, lt: ColumnTable, rt: ColumnTable, lidx, ridx, schema=None) -> ColumnTable:
        """Materialize matched rows in the join's schema (or `schema`: a
        residual semi / anti join gathers only what its condition reads):
        the left side's columns (its key column included) + the right
        side's non-key columns, each one gather on the device."""
        schema = schema if schema is not None else plan.schema
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

    def _left_unmatched(self, plan: Join, lt: ColumnTable, rt: ColumnTable, mask) -> ColumnTable:
        """Unmatched left rows, right-side fields null-extended."""
        sub = lt.filter_mask(mask)
        lnames = {x.lower() for x in plan.left.schema.names}
        cols, dicts, val = {}, {}, {}
        for f in plan.schema.fields:
            if f.name.lower() in lnames:
                _copy_field(f, sub, f.name, cols, dicts, val)
            else:
                _null_field(f, sub.num_rows, rt, lt.device, cols, dicts, val)
        return ColumnTable(plan.schema, cols, dicts, val, lt.device)

    def _right_unmatched(self, plan: Join, lt: ColumnTable, rt: ColumnTable, mask) -> ColumnTable:
        """Unmatched right rows: key columns coalesce to the RIGHT key's
        values (under the left-named output column, in its dtype), right
        non-key fields carry their values, left-only fields are
        null-extended."""
        sub = rt.filter_mask(mask)
        key_src = {l.lower(): r for l, r in zip(plan.left_on, plan.right_on)}
        rnames = {x.lower() for x in plan.right.schema.names}
        cols, dicts, val = {}, {}, {}
        for f in plan.schema.fields:
            low = f.name.lower()
            if low in key_src:
                _copy_field(f, sub, key_src[low], cols, dicts, val)
            elif low in rnames:
                _copy_field(f, sub, f.name, cols, dicts, val)
            else:
                _null_field(f, sub.num_rows, lt, lt.device, cols, dicts, val)
        return ColumnTable(plan.schema, cols, dicts, val, lt.device)

"""Aggregate execution: segment reduce, partial-aggregation pushdown,
distinct expansion, and grouping-set re-folds (Executor mixin).

A port of the JAX package's `execution/exec_agg.py::AggregateMixin` with
its venues: every reduce goes through ops/aggregate.py::aggregate_table
on the aggregation venue (`_agg_venue`): the CUDA segment-reduce kernel
on the session's device, or numpy's bincount / reduceat on the host. With
the executor's mesh, the plain segment reduce's device venue shards its
rows over it (one K1 a shard; `stats["agg_devices"]`), as the JAX
package's does; the host venue never shards, and the other branches
reduce on one device, as there. A plain
aggregate over an inner join first tries the
partial-aggregation pushdown, then the fused Aggregate(Join)
(exec_join_agg.py), as the JAX package does; otherwise the child
executes and one segment-reduce runs over every channel. Group ids go
through the identity cache (exec_common.py::_group_ids_cached). An
aggregate with no aggregate functions (`distinct()`, the set operations'
left side) takes the group ids only and launches no reduce.

count_distinct runs as a two-phase re-aggregation when it counts one
column and nothing takes a mean, else as the distinct expansion; GROUPING
SETS (ROLLUP, CUBE) as one finest-grain aggregate and one re-fold of its
partials per set, or, with a count_distinct, one aggregate per set over
the child materialized once. `stats["agg_path"]` names the branch that
ran with the JAX package's physical-plan names (`PartialAggPushdown`,
`CountDistinctReaggregate`, `DistinctExpandAggregate`,
`GroupingSetsReaggregate`, `GroupingSetsDistinct`), set when the branch
finishes, over whatever its inner aggregates recorded; a plain
aggregate records `segment-reduce-<device type>` (`segment-reduce-host`
on the host venue) or `fused-join-agg`.
Each branch also names its physical node with the JAX package's op and
detail keys (`SegmentReduceAggregate`, `FusedJoinAggregate`, ...); its
`venue` is the session's device type, or `host`.
The distinct pair counts (numpy's bincount on the host venue) and a
ROLLUP's prefix-chain factorization (one sort of the finest key for
every level) run as torch ops on the session's device.
"""

from __future__ import annotations

import numpy as np
import torch

from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.execution.exec_common import (
    _TableLeaf,
    _copy_field,
    _desugar_count_distinct,
    _group_ids_cached,
    _null_field,
)
from hyperspace_tpu_torch.execution.table import ColumnTable, to_tensor
from hyperspace_tpu_torch.ops.aggregate import _column_codes, aggregate_table, group_ids
from hyperspace_tpu_torch.parallel.mesh import mesh_size
from hyperspace_tpu_torch.plan.expr import Case, Col, Lit, when
from hyperspace_tpu_torch.plan.nodes import AggSpec, Aggregate, Join, LogicalPlan
from hyperspace_tpu_torch.schema import Field, Schema


def _zero_nulls(cols: dict, validity: dict, name: str) -> None:
    """SQL count is never NULL: a sum of count partials over zero inner
    rows is, so its NULLs become 0."""
    v = validity.pop(name, None)
    if v is not None:
        cols[name] = torch.where(v, cols[name], torch.zeros((), dtype=cols[name].dtype, device=v.device))


class AggregateMixin:
    def _aggregate(self, plan: Aggregate) -> ColumnTable:
        if plan.grouping_sets is not None:
            return self._grouping_sets_aggregate(plan)
        if any(a.fn == "count_distinct" for a in plan.aggs):
            for a in plan.aggs:
                if a.fn == "count_distinct" and not isinstance(a.expr, Col):
                    raise HyperspaceError("count_distinct requires a plain column")
            dcols = {a.expr.name.lower() for a in plan.aggs if a.fn == "count_distinct"}
            if len(dcols) == 1 and not any(a.fn == "mean" for a in plan.aggs):
                # Single distinct column, no mean: the plan-level two-phase
                # desugar keeps the inner aggregate eligible for the fused
                # Aggregate(Join) path.
                self._phys("CountDistinctReaggregate")
                plan2, count_aliases = _desugar_count_distinct(plan)
                out = self._execute(plan2)
                for alias in count_aliases:
                    _zero_nulls(out.columns, out.validity, out.schema.field(alias).name)
                self.stats["agg_path"] = "CountDistinctReaggregate"
                return out
            return self._distinct_aggregate(plan, sorted(dcols))
        pushed = self._try_partial_agg_pushdown(plan)
        if isinstance(pushed, ColumnTable):
            return pushed
        if pushed is not None:
            # Pushdown bailed AFTER materializing the left side: continue
            # with the spliced plan so nothing below re-executes it.
            plan = pushed
        fused = self._try_fused_join_aggregate(plan)
        if fused is not None:
            self._phys(
                "FusedJoinAggregate",
                join_path=self.stats["join_path"],
                kernel=self.stats["join_kernel"],
                buckets=self.stats["num_buckets"],
            )
            return fused
        table = self._execute(plan.child)
        venue = self._agg_venue()
        name = self._venue_label(venue)
        self.stats["agg_path"] = f"segment-reduce-{name}"
        mesh = self.mesh if venue == "device" else None
        if mesh is not None:
            # The row dimension shards over the mesh: one K1 a shard.
            self.stats["agg_devices"] = mesh_size(mesh)
        self._phys(
            "SegmentReduceAggregate", venue=name, groups=len(plan.group_by), aggs=len(plan.aggs),
            devices=self.stats.get("agg_devices", 1),
        )
        return aggregate_table(
            table, plan.group_by, plan.aggs, plan.schema, groups=_group_ids_cached(table, plan.group_by),
            mesh=mesh, venue=venue, mask_venue=self._filter_venue(),
        )

    def _venue_label(self, venue: str) -> str:
        """A venue as the stats and the physical plan name it: the
        session's device type, or `host`."""
        return self.device.type if venue == "device" else "host"

    def _try_partial_agg_pushdown(self, plan: Aggregate) -> "ColumnTable | Aggregate | None":
        """Partial aggregation pushdown: for Aggregate(Join(L, R)) where
        every aggregate reads only the L side — optionally inside a CASE
        whose CONDITION reads only the R side (the weekly pivot shape; R
        attributes are constant per join-key run, so the case splits into
        the outer re-aggregation) — pre-aggregate L by (join keys + L group
        columns), join the FEW partial rows, and re-fold. Adaptive: bails
        when the partial grouping would not shrink L about 8x."""
        child = plan.child
        if not isinstance(child, Join) or child.how != "inner" or child.condition is not None:
            return None
        if isinstance(child.left, _TableLeaf) or isinstance(child.right, _TableLeaf):
            return None  # already pushed (recursion guard)
        lnames = {n.lower() for n in child.left.schema.names}
        rnames = {n.lower() for n in child.right.schema.names}
        g_l = [c for c in plan.group_by if c.lower() in lnames]
        g_r = [c for c in plan.group_by if c.lower() not in lnames]
        if any(c.lower() not in rnames for c in g_r):
            return None

        partial_specs: list[AggSpec] = []
        outer_specs: list[AggSpec] = []
        mean_parts: dict[str, tuple[str, str]] = {}  # alias -> (sum, count) temp names
        count_aliases: list[str] = []
        uses_r = bool(g_r)
        for i, a in enumerate(plan.aggs):
            refs = {r.lower() for r in a.references()}
            if a.fn == "count" and a.expr is None:
                partial_specs.append(AggSpec("count", None, f"__pp{i}"))
                outer_specs.append(AggSpec("sum", Col(f"__pp{i}"), a.alias))
                count_aliases.append(a.alias)
                continue
            if a.fn in ("sum", "count", "min", "max") and refs and refs <= lnames:
                partial_specs.append(AggSpec(a.fn, a.expr, f"__pp{i}"))
                outer_specs.append(AggSpec("sum" if a.fn in ("sum", "count") else a.fn, Col(f"__pp{i}"), a.alias))
                if a.fn == "count":
                    count_aliases.append(a.alias)
                continue
            if a.fn == "mean" and refs and refs <= lnames:
                partial_specs.append(AggSpec("sum", a.expr, f"__pp{i}s"))
                partial_specs.append(AggSpec("count", a.expr, f"__pp{i}c"))
                outer_specs.append(AggSpec("sum", Col(f"__pp{i}s"), f"__po{i}s"))
                outer_specs.append(AggSpec("sum", Col(f"__pp{i}c"), f"__po{i}c"))
                mean_parts[a.alias] = (f"__po{i}s", f"__po{i}c")
                continue
            if (
                a.fn == "sum"
                and isinstance(a.expr, Case)
                and len(a.expr.branches) == 1
                and isinstance(a.expr.default, Lit)
                and a.expr.default.value in (0, 0.0)
            ):
                cond, val = a.expr.branches[0]
                crefs = {r.lower() for r in cond.references()}
                vrefs = {r.lower() for r in val.references()}
                if crefs and crefs <= rnames and vrefs <= lnames:
                    uses_r = True
                    partial_specs.append(AggSpec("sum", val, f"__pp{i}"))
                    outer_specs.append(AggSpec("sum", when(cond, Col(f"__pp{i}")).otherwise(0.0), a.alias))
                    continue
            return None
        if not uses_r:
            # The aggregate needs R only for the join's filtering: the
            # fused path serves that shape better.
            return None

        pkeys: list[str] = list(child.left_on)
        pk_low = {c.lower() for c in pkeys}
        for c in g_l:
            if c.lower() not in pk_low:
                pkeys.append(c)
                pk_low.add(c.lower())

        lt = self._execute(child.left)
        gid, k, rep = _group_ids_cached(lt, pkeys)
        if k > max(64, lt.num_rows // 8):
            # Less than ~8x shrink: the fused path does better. A deep left
            # side is already materialized — hand back a plan with it
            # spliced in so nothing below re-executes it. An index-aligned
            # scan side stays a plan: splicing would knock it off the
            # zero-exchange aligned path (and its DPP), which beats the
            # re-execution it avoids (the scan is cache-served anyway).
            if self._aligned_side(child.left) is not None:
                return None
            return Aggregate(
                Join(_TableLeaf(lt), child.right, child.left_on, child.right_on, child.how, condition=child.condition),
                list(plan.group_by),
                list(plan.aggs),
            )

        pschema = Aggregate(_TableLeaf(lt), pkeys, partial_specs).schema
        partial = aggregate_table(lt, pkeys, partial_specs, pschema, groups=(gid, k, rep),
                                  venue=self._agg_venue(), mask_venue=self._filter_venue())
        self._phys("PartialAggPushdown", partial_rows=partial.num_rows, input_rows=lt.num_rows, keys=pkeys)
        outer_plan: LogicalPlan = Aggregate(
            Join(_TableLeaf(partial), child.right, child.left_on, child.right_on, "inner"),
            list(plan.group_by),
            outer_specs,
        )
        out = self._execute(outer_plan)
        # Re-shape to the original output: means recompose from their
        # sum/count partials (NULL when no valid input), counts restore
        # SQL's never-NULL zero, columns return in declared order.
        cols: dict[str, torch.Tensor] = {}
        dicts: dict = {}
        validity: dict[str, torch.Tensor] = {}
        for f in plan.schema.fields:
            if f.name in mean_parts:
                s_name, c_name = mean_parts[f.name]
                s = out.column(s_name).to(torch.float64)
                c = out.column(c_name).to(torch.float64)
                cols[f.name] = torch.where(c > 0, s / c.clamp(min=1), 0.0)
                if bool((c == 0).any()):
                    validity[f.name] = c > 0
                continue
            _copy_field(f, out, f.name, cols, dicts, validity)
            if f.name in count_aliases:
                _zero_nulls(cols, validity, f.name)
        self.stats["agg_path"] = "PartialAggPushdown"
        return ColumnTable(plan.schema, cols, dicts, validity, self.device)

    def _distinct_aggregate(self, plan: Aggregate, dcols: list[str]) -> ColumnTable:
        """General distinct expansion (the Spark planner's Expand analog
        for multi-distinct aggregates): execute the child ONCE, factorize
        the group keys ONCE, run the non-distinct specs as a normal
        segment reduce sharing that factorization, and count each
        distinct column by factorizing (group keys, column) pairs — the
        representative row of each pair maps back to its outer group, so
        a bincount over pair representatives IS the distinct count."""
        ct = self._execute(plan.child)
        venue = self._agg_venue()
        gid, k, rep = _group_ids_cached(ct, plan.group_by)
        out_schema = plan.schema
        self.stats["agg_path"] = "DistinctExpandAggregate"
        self._phys("DistinctExpandAggregate", distinct_cols=dcols, groups=len(plan.group_by),
                   venue=self._venue_label(venue))
        if k == 0 or (ct.num_rows == 0 and plan.group_by):
            return ColumnTable.empty(out_schema, device=self.device)
        regular = [a for a in plan.aggs if a.fn != "count_distinct"]
        reg_fields = [out_schema.field(c) for c in plan.group_by]
        reg_fields += [out_schema.field(a.alias) for a in regular]
        base = aggregate_table(ct, plan.group_by, regular, Schema(tuple(reg_fields)), groups=(gid, k, rep),
                               venue=venue, mask_venue=self._filter_venue())
        cols = dict(base.columns)
        dicts = dict(base.dictionaries)
        validity = dict(base.validity)
        pair_counts: dict[str, torch.Tensor] = {}
        if venue == "host":
            # The JAX package's host pair counts: numpy over host group ids.
            for d in dcols:
                prep = group_ids(ct, [*plan.group_by, d])[2]
                outer = gid[prep]
                vd = ct.host_valid_mask(d)
                if vd is not None:
                    outer = outer[vd[prep]]  # SQL: distinct counts exclude NULL
                pair_counts[d] = to_tensor(np.bincount(outer, minlength=k).astype(np.int64), self.device)
        else:
            gid_t = to_tensor(gid, self.device)
            for d in dcols:
                prep = to_tensor(group_ids(ct, [*plan.group_by, d])[2], self.device)
                outer = gid_t[prep]
                vd = ct.valid_mask(d)
                if vd is not None:
                    outer = outer[vd[prep]]  # SQL: distinct counts exclude NULL
                pair_counts[d] = torch.bincount(outer, minlength=k).to(torch.int64)
        for a in plan.aggs:
            if a.fn == "count_distinct":
                cols[out_schema.field(a.alias).name] = pair_counts[a.expr.name.lower()]
        return ColumnTable(out_schema, cols, dicts, validity, self.device)

    def _grouping_sets_aggregate(self, plan: Aggregate) -> ColumnTable:
        """ROLLUP / CUBE / GROUPING SETS as ONE finest-grain aggregate
        (which gets the fused Aggregate(Join) path when it applies) plus
        cheap re-aggregations of its partials per set. The union
        null-extends group columns a set aggregates away; grouping()
        flags tell data NULLs from subtotal NULLs."""
        if any(a.fn == "count_distinct" for a in plan.aggs):
            # Distinct counts do not compose from partials: materialize
            # the child ONCE and aggregate each set directly over it.
            return self._grouping_sets_distinct(plan)

        # Phase 1: finest grain over the full group_by, means split into
        # sum+count partials so coarser sets can recompose them exactly.
        base_specs: list[AggSpec] = []
        for a in plan.aggs:
            if a.fn == "grouping":
                continue
            if a.fn == "mean":
                base_specs.append(AggSpec("sum", a.expr, f"__gs_sum_{a.alias}"))
                base_specs.append(AggSpec("count", a.expr, f"__gs_cnt_{a.alias}"))
            else:
                base_specs.append(AggSpec(a.fn, a.expr, a.alias))
        bt = self._execute(Aggregate(plan.child, plan.group_by, base_specs))
        out_schema = plan.schema
        venue = self._agg_venue()
        self._phys("GroupingSetsReaggregate", sets=[list(s) for s in plan.grouping_sets],
                   venue=self._venue_label(venue))

        def refold(a: AggSpec) -> list[AggSpec]:
            """Phase-2 spec(s) re-aggregating a phase-1 partial column."""
            if a.fn == "mean":
                return [
                    AggSpec("sum", Col(f"__gs_sum_{a.alias}"), f"__gs_sum_{a.alias}"),
                    AggSpec("sum", Col(f"__gs_cnt_{a.alias}"), f"__gs_cnt_{a.alias}"),
                ]
            return [AggSpec("sum" if a.fn in ("sum", "count") else a.fn, Col(a.alias), a.alias)]

        # ROLLUP's sets are prefixes of group_by: ONE sort of the finest
        # key serves every level.
        prefix_groups = self._prefix_chain_groups(bt, plan.group_by, plan.grouping_sets)

        parts: list[ColumnTable] = []
        for s in plan.grouping_sets:
            specs2 = [sp for a in plan.aggs if a.fn != "grouping" for sp in refold(a)]
            fields = [bt.schema.field(c) for c in s]
            for sp in specs2:
                src = bt.schema.field(sp.expr.name)
                if sp.fn in ("min", "max"):
                    dtype = src.dtype
                else:
                    dtype = "int64" if src.dtype in ("int32", "int64", "bool", "date") else "float64"
                fields.append(Field(sp.alias, dtype))
            sub = aggregate_table(
                bt, list(s), specs2, Schema(tuple(fields)),
                groups=None if prefix_groups is None else prefix_groups.get(len(s)), venue=venue,
            )

            def agg_col(f, spec, cols, dicts, validity, sub=sub):
                if spec.fn == "mean":
                    ssum = sub.column(f"__gs_sum_{spec.alias}").to(torch.float64)
                    scnt = sub.column(f"__gs_cnt_{spec.alias}").to(torch.float64)
                    sv = sub.valid_mask(f"__gs_sum_{spec.alias}")
                    cols[f.name] = torch.where(scnt > 0, ssum / scnt.clamp(min=1), 0.0)
                    if sv is not None or bool((scnt == 0).any()):
                        ok = scnt > 0
                        validity[f.name] = ok if sv is None else (ok & sv)
                elif spec.fn == "count":
                    # COUNT is never NULL: a zero-row re-fold's NULL sum
                    # partial becomes 0.
                    v = sub.valid_mask(spec.alias)
                    c = sub.column(spec.alias)
                    cols[f.name] = c if v is None else torch.where(v, c, torch.zeros((), dtype=c.dtype, device=c.device))
                else:
                    _copy_field(f, sub, spec.alias, cols, dicts, validity)

            parts.append(self._gs_assemble(plan, out_schema, sub, s, bt, agg_col))
        self.stats["agg_path"] = "GroupingSetsReaggregate"
        return ColumnTable.concat(parts)

    @staticmethod
    def _prefix_chain_groups(bt: ColumnTable, group_by, sets):
        """Per-set (gid, K, rep) factorizations for prefix-chain grouping
        sets (ROLLUP), all derived from ONE stable sort on the device. The
        finest combined key is mixed-radix over the per-column codes; a
        length-L prefix's key is its quotient by the trailing radix
        product — monotone, so the full-key sort order is sorted for every
        prefix and each level needs only a segment mask. None when the
        sets are not a prefix chain or the radix product overflows (the
        caller factorizes per set)."""
        gb_low = [c.lower() for c in group_by]
        lens = set()
        for s in sets:
            if [c.lower() for c in s] != gb_low[: len(s)]:
                return None
            lens.add(len(s))
        if not group_by or bt.num_rows == 0:
            return None
        codes, cards = zip(*(_column_codes(bt, c) for c in group_by))
        total = 1
        for card in cards:
            total *= int(card)
            if total >= 2**63 - 1:
                return None
        dev = bt.device
        combined = to_tensor(codes[0].astype("int64"), dev)
        for cd, card in zip(codes[1:], cards[1:]):
            combined = combined * int(card) + to_tensor(cd.astype("int64"), dev)
        # Trailing radix products: suffix[L] divides the full key down to
        # the length-L prefix's key.
        suffix = [1] * (len(group_by) + 1)
        for i in range(len(group_by) - 1, -1, -1):
            suffix[i] = suffix[i + 1] * int(cards[i])
        sc, perm = torch.sort(combined, stable=True)
        n = len(sc)
        out = {}
        for length in sorted(lens):
            if length == 0:
                out[0] = (torch.zeros(n, dtype=torch.int64, device=dev), 1, torch.zeros(1, dtype=torch.int64, device=dev))
                continue
            q = torch.div(sc, suffix[length], rounding_mode="floor")
            newseg = torch.ones(n, dtype=torch.bool, device=dev)
            newseg[1:] = q[1:] != q[:-1]
            seg = torch.cumsum(newseg, dim=0) - 1
            gid = torch.empty(n, dtype=torch.int64, device=dev)
            gid[perm] = seg
            out[length] = (gid, int(seg[-1]) + 1, perm[newseg])
        return out

    def _gs_assemble(self, plan: Aggregate, out_schema, sub: ColumnTable, s, dict_src, agg_col) -> ColumnTable:
        """One grouping set's output part: group columns in `s` copy
        through, group columns aggregated away null-extend (keeping a
        dictionary of the finest table's, so the concat merges nothing),
        grouping() flags derive from set membership, and `agg_col(field,
        spec, cols, dicts, validity)` fills the aggregate columns."""
        in_set = {c.lower() for c in s}
        gb_low = {c.lower() for c in plan.group_by}
        cols: dict[str, torch.Tensor] = {}
        dicts: dict = {}
        validity: dict[str, torch.Tensor] = {}
        nrows = sub.num_rows
        for f in out_schema.fields:
            low = f.name.lower()
            if low in gb_low:
                if low in in_set:
                    _copy_field(f, sub, f.name, cols, dicts, validity)
                else:
                    _null_field(f, nrows, dict_src if f.is_string else None, self.device, cols, dicts, validity)
                continue
            spec = next(a for a in plan.aggs if a.alias.lower() == low)
            if spec.fn == "grouping":
                flag = 0 if spec.expr.name.lower() in in_set else 1
                cols[f.name] = torch.full((nrows,), flag, dtype=torch.int64, device=self.device)
            else:
                agg_col(f, spec, cols, dicts, validity)
        return ColumnTable(out_schema, cols, dicts, validity, self.device)

    def _grouping_sets_distinct(self, plan: Aggregate) -> ColumnTable:
        """GROUPING SETS with count_distinct aggregates: the child
        materializes once, then every set aggregates it directly —
        distinct counts cannot be composed from finer partials."""
        ct = self._execute(plan.child)
        leaf = _TableLeaf(ct)
        self._phys(
            "GroupingSetsDistinct",
            sets=[list(s) for s in plan.grouping_sets],
            distinct_cols=sorted(a.expr.name.lower() for a in plan.aggs if a.fn == "count_distinct"),
        )
        parts: list[ColumnTable] = []
        for s in plan.grouping_sets:
            sub = self._execute(Aggregate(leaf, list(s), [a for a in plan.aggs if a.fn != "grouping"]))

            def agg_col(f, spec, cols, dicts, validity, sub=sub):
                _copy_field(f, sub, spec.alias, cols, dicts, validity)

            parts.append(self._gs_assemble(plan, plan.schema, sub, s, ct, agg_col))
        self.stats["agg_path"] = "GroupingSetsDistinct"
        return ColumnTable.concat(parts)

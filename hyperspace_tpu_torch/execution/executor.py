"""Plan executor: runs logical plans on the session's device.

The analog of Spark's physical planning + execution for the IR's node
types. What matters for speed:

- **bucket pruning** (Filter over an index scan with equality literals on
  every bucket column): recompute the canonical row hash on the literal
  tuple and read ONLY that bucket's file; for a point lookup this divides
  IO by numBuckets;
- decoded columns stay on the device between queries, and what queries
  derive from them is cached by identity (execution/device_cache.py);
- range pruning (min/max stats) with a sliced sorted key for range
  predicates over an index scan;
- predicates and aggregates evaluate on the device (ops/filter.py,
  ops/aggregate.py);
- an equi-join of two indexes bucketed alike runs per bucket with zero
  exchange (exec_side.py, exec_join.py); a join with one indexed side
  re-bucketizes the other on the fly or, where it is small, probes a
  broadcast table of it; an inner join's output stays bucket-grouped for
  a later join on the same keys; and an aggregate over an inner join
  never materializes the joined pairs (exec_join_agg.py).

A port of the JAX package's `Executor._dispatch` for Scan, Filter,
Project (with computed entries, ops/project.py), Join (every join type),
Union, Aggregate (grouping sets, count-distinct and the pushdown:
exec_agg.py), Window (ops/window.py), Sort and Limit, with its
bucket-preserved join outputs (`_stash_bucketed`, `_preserved_sidedata`,
`_propagate_stash`), ORDER BY ... LIMIT as a top-N selection (`_top_n`)
and LIMIT over an unordered scan chain as an early-out read
(`_limit_early_out`). There are no venues: every operator runs on the
session's device. The stats name what ran; `join_paths` lists the path of
every join of the query in the order they finished (`join_path` is the
last's), and `exchanges` what each exchanging join did to its sides
(`rebucketize`, `preserved`, `preserved-both` or `preserved+rebucketize`,
the JAX package's `exchange` detail of its physical plan). `top_n` and
`limit_early_out` carry the details of the JAX package's `TopN` and
`LimitEarlyOut` physical nodes (the selection's kernel and candidates;
the files scanned of the files listed).

The executed physical plan (`physical_plan`, execution/physical.py) is
recorded as the query runs, with the JAX package's operator names and
detail keys: one node an `_execute` frame, annotated by `_phys`, with
its files and bytes read, its rows out and its wall time. Each frame
also opens an `execute.<op>` span (obs/trace.py). The wall is the
host's: the operators launch their device work and do not wait for it.
Detail values that name a kernel or a venue are the port's own (`venue`
is the session's device type).

`execute` validates the plan first (`check_plan`, analysis/validator.py)
and its own pushdown and pruning after (`validate_rewrite`), as the JAX
package does, unless `hyperspace.analysis.validate` is false: a
malformed plan raises `PlanValidationError` before any device work.
"""

from __future__ import annotations

import dataclasses
import functools
import time
import weakref

import numpy as np
import torch

from hyperspace_tpu_torch.analysis.validator import check_plan, validate_rewrite
from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.execution.exec_agg import AggregateMixin
from hyperspace_tpu_torch.execution.exec_common import SideData, _TableLeaf
from hyperspace_tpu_torch.execution.exec_join import JoinMixin
from hyperspace_tpu_torch.execution.exec_join_agg import FusedJoinAggMixin
from hyperspace_tpu_torch.execution.exec_scan import ScanFilterMixin, scan_files
from hyperspace_tpu_torch.execution.exec_side import JoinSidesMixin
from hyperspace_tpu_torch.execution.physical import PhysicalNode
from hyperspace_tpu_torch.execution.table import ColumnTable
from hyperspace_tpu_torch.ops.project import project_table
from hyperspace_tpu_torch.ops.sortkeys import column_lanes, device_order_perm, lane_tensor, lanes_as_unsigned
from hyperspace_tpu_torch.obs import trace as obs_trace
from hyperspace_tpu_torch.ops.window import window_table
from hyperspace_tpu_torch.plan.expr import And
from hyperspace_tpu_torch.plan.nodes import Aggregate, Filter, Join, Limit, LogicalPlan, Project, Scan, Sort, Union, Window
from hyperspace_tpu_torch.plan.prune import prune_columns
from hyperspace_tpu_torch.plan.pushdown import push_down_filters


class Executor(ScanFilterMixin, JoinSidesMixin, JoinMixin, FusedJoinAggMixin, AggregateMixin):
    """Runs plans on `device`. `stats` records what physically ran."""

    def __init__(self, device: torch.device, conf: HyperspaceConf | None = None):
        self.device = device
        self.conf = conf if conf is not None else HyperspaceConf()
        self.stats: dict = {
            "files_read": 0,
            "files_pruned": 0,
            "rows_pruned": 0,
            "bytes_scanned": 0,
            "range_exact": None,
            "read_s": 0.0,
            "scan": None,
            "agg_path": None,
            "join_path": None,
            "join_kernel": None,
            "join_paths": [],
            "exchange_kernel": None,
            "exchanges": [],
            "num_buckets": None,
            "top_n": None,
            "limit_early_out": None,
        }
        # Executed physical plan, built as the query runs.
        self.physical_plan: PhysicalNode | None = None
        self._cur_phys: PhysicalNode | None = None
        # Bucket-preserving join outputs: id(table) -> (weakref, offsets,
        # lowered key names, hash-domain fields). Bounded; the weakrefs
        # keep a reused id from matching a dead table.
        self._bucketed_outputs: dict[int, tuple] = {}

    def _stash_bucketed(self, table: ColumnTable, offsets: np.ndarray, keys, hash_fields) -> None:
        if len(self._bucketed_outputs) >= 16:
            self._bucketed_outputs.clear()
        self._bucketed_outputs[id(table)] = (
            weakref.ref(table), offsets, tuple(k.lower() for k in keys), hash_fields,
        )

    def _preserved_sidedata(self, table: ColumnTable, join_on: list[str]) -> SideData | None:
        """The stashed bucket grouping of `table` as a join side, when the
        grouping's keys are the join's."""
        e = self._bucketed_outputs.get(id(table))
        if e is None or e[0]() is not table or e[2] != tuple(k.lower() for k in join_on):
            return None
        return SideData(table, e[1], False, hash_fields=e[3])

    def _propagate_stash(self, src: ColumnTable, dst: ColumnTable) -> ColumnTable:
        """A column selection keeps the rows, so a stashed bucket grouping
        stays valid on the derived table while its keys survive."""
        e = self._bucketed_outputs.get(id(src))
        if e is not None and e[0]() is src and dst is not src:
            names = {n.lower() for n in dst.schema.names}
            if all(k in names for k in e[2]):
                self._stash_bucketed(dst, e[1], list(e[2]), e[3])
        return dst

    def execute(self, plan: LogicalPlan) -> ColumnTable:
        validate = self.conf.validate_plans
        if validate:
            # Pre-execution analysis (analysis/validator.py): reject a
            # malformed plan with node-provenance diagnostics before any
            # device work, instead of a mid-execution KeyError.
            check_plan(plan)
        optimized = prune_columns(push_down_filters(plan))
        if validate:
            # Guard our own rewrites: pushdown and pruning must keep the
            # output schema and never push a filter beneath the
            # null-extended side of an outer join.
            validate_rewrite(plan, optimized)
        return self._execute(optimized)

    def _execute(self, plan: LogicalPlan) -> ColumnTable:
        """One operator frame: a physical node (a child of the frame that
        called it) and an `execute.<op>` span around `_dispatch`, then
        the files, bytes and rows this operator accounts for."""
        node = PhysicalNode(op=type(plan).__name__)
        parent, self._cur_phys = self._cur_phys, node
        if parent is not None:
            parent.children.append(node)
        else:
            self.physical_plan = node
        files_before = self.stats["files_read"]
        bytes_before = self.stats["bytes_scanned"]
        sp = obs_trace.span(f"execute.{type(plan).__name__}")
        t0 = time.perf_counter()
        with sp:
            try:
                result = self._dispatch(plan)
            finally:
                self._cur_phys = parent
                # Recorded even on failure, so partial profiles stay honest.
                node.wall_s = time.perf_counter() - t0
                sp.rename(f"execute.{node.op}")
            # The file IO of THIS operator: its frame's delta less what the
            # child frames already claimed.
            subtree = self.stats["files_read"] - files_before
            node._subtree_files = subtree
            own = subtree - sum(getattr(c, "_subtree_files", 0) for c in node.children)
            if own > 0:
                node.detail.setdefault("files", own)
            sub_bytes = self.stats["bytes_scanned"] - bytes_before
            node._subtree_bytes = sub_bytes
            own_bytes = sub_bytes - sum(getattr(c, "_subtree_bytes", 0) for c in node.children)
            if own_bytes > 0:
                node.detail.setdefault("bytes", own_bytes)
            node.rows_out = result.num_rows
            sp.set(rows_out=result.num_rows)
            if own > 0:
                sp.set(files=own, bytes=own_bytes)
        return result

    def _phys(self, op: str | None = None, **detail) -> None:
        """Annotate the operator currently executing."""
        if self._cur_phys is None:
            return
        if op is not None:
            self._cur_phys.op = op
        self._cur_phys.detail.update(detail)

    def _dispatch(self, plan: LogicalPlan) -> ColumnTable:
        if isinstance(plan, Scan):
            # Labeled here, not in _scan: a scan also runs as a
            # subroutine of other operators (hybrid delta reads).
            if plan.bucket_spec is not None:
                self._phys("IndexScan", buckets=plan.bucket_spec[0])
            else:
                self._phys("TableScan")
            self.stats["scan"] = self._cur_phys.op
            return self._scan(plan)
        if isinstance(plan, Filter):
            return self._filter(plan)
        if isinstance(plan, Project):
            self._cur_phys.detail["columns"] = list(plan.output_names)
            child = self._execute(plan.child)
            if plan.is_simple:
                return self._propagate_stash(child, child.select(plan.columns))
            self._phys("ProjectCompute", computed=[c[0] for c in plan.columns if not isinstance(c, str)])
            return project_table(child, plan.columns, plan.schema)
        if isinstance(plan, Join):
            return self._join(plan)
        if isinstance(plan, Union):
            self._cur_phys.op = "HybridScanUnion"
            return self._union(plan)
        if isinstance(plan, Aggregate):
            return self._aggregate(plan)
        if isinstance(plan, Window):
            t = self._execute(plan.child)
            self._phys(
                "WindowSortedSegments",
                partitions=list(plan.partition_by),
                frame=plan.frame,
                funcs=[f.fn for f in plan.funcs],
            )
            return window_table(t, plan.partition_by, plan.order_by, plan.funcs, plan.frame, plan.schema)
        if isinstance(plan, Sort):
            t = self._execute(plan.child)
            self._phys("DeviceSort", keys=[c for c, _ in plan.by])
            return self._sorted_table(t, plan)
        if isinstance(plan, _TableLeaf):
            return plan.table
        if isinstance(plan, Limit):
            self._cur_phys.detail["n"] = plan.n
            if isinstance(plan.child, Sort):
                return self._top_n(plan.child, plan.n)
            early = self._limit_early_out(plan.child, plan.n)
            if early is not None:
                return early
            t = self._execute(plan.child)
            return t.take(torch.arange(min(plan.n, t.num_rows), device=t.device))
        raise HyperspaceError(f"cannot execute plan node {type(plan).__name__}")

    def _limit_early_out(self, child: LogicalPlan, n: int) -> ColumnTable | None:
        """LIMIT over an unordered linear scan chain: pull rows file by
        file and STOP once n rows survive, instead of materializing the
        whole child (any n rows are a correct answer without ORDER BY).
        Returns None when the shape doesn't apply (non-linear child, a
        single file)."""
        chain: list[LogicalPlan] = []
        node = child
        while isinstance(node, (Project, Filter)):
            chain.append(node)
            node = node.child
        if not isinstance(node, Scan):
            return None
        files = scan_files(node)
        preds = [w.predicate for w in chain if isinstance(w, Filter)]
        if node.bucket_spec is not None and preds:
            # Index scans prune FIRST: a point lookup stays a single-file
            # read, not a file-by-file walk through non-owning buckets.
            pred = functools.reduce(And, preds)
            pruned = self._prune_bucket_files(node, pred)
            if pruned is None:
                ranged = self._range_prune_list(node, pred)
                pruned = ranged[0] if ranged is not None else None
            if pruned is not None:
                files = pruned
        if len(files) <= 1:
            return None
        parts: list[ColumnTable] = []
        total = 0
        scanned = 0
        for f in files:
            sub: LogicalPlan = dataclasses.replace(node, files=[f])
            for wrapper in reversed(chain):
                sub = dataclasses.replace(wrapper, child=sub)
            # Sequential by design: stopping early is the point.
            t = self._execute(sub)
            scanned += 1
            if t.num_rows:
                parts.append(t)
                total += t.num_rows
            if total >= n:
                break
        self.stats["limit_early_out"] = {"files_scanned": scanned, "files_total": len(files)}
        self._phys("LimitEarlyOut", **self.stats["limit_early_out"])
        if not parts:
            return ColumnTable.empty(child.schema, device=self.device)
        out = ColumnTable.concat(parts) if len(parts) > 1 else parts[0]
        return out.take(torch.arange(min(n, out.num_rows), device=out.device))

    def _top_n(self, sort_plan: Sort, n: int) -> ColumnTable:
        """ORDER BY ... LIMIT n as an O(rows) selection: the n-th smallest
        key of the first sort column is the threshold, and only the
        (ties-inclusive) candidate set gets the full lexicographic sort.
        The JAX package packs the column's two leading 32-bit lanes into a
        uint64 and selects with np.partition; torch orders no uint64, so
        the same 64 bits travel as an int64 whose high word has its top
        bit flipped (the order is kept), selected with `torch.kthvalue`.
        Candidates keep ascending row order, as np.flatnonzero's."""
        table = self._execute(sort_plan.child)
        rows = table.num_rows
        if n <= 0:
            return table.take(torch.arange(0, device=table.device))
        if rows <= max(2 * n, 1024):
            self.stats["top_n"] = {"kernel": "full-sort"}
            self._phys("TopN", n=n, **self.stats["top_n"])
            full = self._sorted_table(table, sort_plan)
            return full.take(torch.arange(min(n, full.num_rows), device=full.device))
        # The FIRST sort column's lanes (DESC inverted, as the full sort
        # does); a constant validity lane is dropped so both 32-bit words
        # carry real key entropy.
        c0, asc0 = sort_plan.by[0]
        lanes = column_lanes(table, c0, force_validity=table.valid_mask(c0) is not None)
        if not asc0:
            lanes = [~l for l in lanes]
        lu = lanes_as_unsigned(lanes[:2])
        hi = lane_tensor(lu[0], table.device) - (1 << 31)  # uint32 order as signed
        key = hi * (1 << 32) + (lane_tensor(lu[1], table.device) if lu.shape[0] > 1 else 0)
        thr = torch.kthvalue(key, n).values
        # The key may be a PREFIX of the column's order (lanes unseen):
        # prefix ties stay in, every true top-n row has key <= thr, and
        # the exact sort of the candidates settles the rest.
        cand = torch.nonzero(key <= thr).flatten()
        self.stats["top_n"] = {"kernel": "partition-select + sort", "candidates": len(cand)}
        self._phys("TopN", n=n, **self.stats["top_n"])
        full = self._sorted_table(table.take(cand), sort_plan)
        return full.take(torch.arange(min(n, full.num_rows), device=full.device))

    @staticmethod
    def _sorted_table(table: ColumnTable, plan: Sort) -> ColumnTable:
        """Total order of a materialized table (one stable device sort)."""
        if table.num_rows <= 1:
            return table
        return table.take(device_order_perm(table, plan.by))

    def _union(self, plan: Union) -> ColumnTable:
        """UNION ALL, and the hybrid scan's union of an index scan with
        the appended files (its delta reads count in `files_read`)."""
        schema = plan.schema
        parts = []
        for child in plan.inputs:
            t = self._execute(child)
            # Remap onto the union schema's exact field names and order
            # (child names match case-insensitively).
            cols, dicts, val = {}, {}, {}
            for f in schema.fields:
                cf = t.schema.field(f.name)
                cols[f.name] = t.columns[cf.name]
                if cf.name in t.dictionaries:
                    dicts[f.name] = t.dictionaries[cf.name]
                if cf.name in t.validity:
                    val[f.name] = t.validity[cf.name]
            parts.append(ColumnTable(schema, cols, dicts, val, t.device))
        return ColumnTable.concat(parts)

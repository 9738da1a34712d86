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
Project (with computed entries, ops/project.py), Join (every join type)
and Aggregate, with its bucket-preserved join outputs
(`_stash_bucketed`, `_preserved_sidedata`, `_propagate_stash`). There
are no venues: every operator runs on the session's device. The stats
name what ran; `join_paths` lists the path of every join of the query in
the order they finished (`join_path` is the last's), and `exchanges`
what each exchanging join did to its sides (`rebucketize`, `preserved`,
`preserved-both` or `preserved+rebucketize`, the JAX package's
`exchange` detail of its physical plan).
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.execution.exec_agg import AggregateMixin
from hyperspace_tpu_torch.execution.exec_common import SideData
from hyperspace_tpu_torch.execution.exec_join import JoinMixin
from hyperspace_tpu_torch.execution.exec_join_agg import FusedJoinAggMixin
from hyperspace_tpu_torch.execution.exec_scan import ScanFilterMixin
from hyperspace_tpu_torch.execution.exec_side import JoinSidesMixin
from hyperspace_tpu_torch.execution.table import ColumnTable
from hyperspace_tpu_torch.ops.project import project_table
from hyperspace_tpu_torch.plan.nodes import Aggregate, Filter, Join, LogicalPlan, Project, Scan
from hyperspace_tpu_torch.plan.prune import prune_columns


class Executor(ScanFilterMixin, JoinSidesMixin, JoinMixin, FusedJoinAggMixin, AggregateMixin):
    """Runs plans on `device`. `stats` records what physically ran."""

    def __init__(self, device: torch.device, conf: HyperspaceConf | None = None):
        self.device = device
        self.conf = conf if conf is not None else HyperspaceConf()
        self.stats: dict = {
            "files_read": 0,
            "files_pruned": 0,
            "rows_pruned": 0,
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
        }
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
        return self._execute(prune_columns(plan))

    def _execute(self, plan: LogicalPlan) -> ColumnTable:
        if isinstance(plan, Scan):
            self.stats["scan"] = "IndexScan" if plan.bucket_spec is not None else "TableScan"
            return self._scan(plan)
        if isinstance(plan, Filter):
            return self._filter(plan)
        if isinstance(plan, Project):
            child = self._execute(plan.child)
            if plan.is_simple:
                return self._propagate_stash(child, child.select(plan.columns))
            return project_table(child, plan.columns, plan.schema)
        if isinstance(plan, Join):
            return self._join(plan)
        if isinstance(plan, Aggregate):
            return self._aggregate(plan)
        raise HyperspaceError(f"cannot execute plan node {type(plan).__name__}")

"""Join side preparation: aligned-side detection and per-bucket side data
(Executor mixin).

A port of the subset of the JAX package's `execution/exec_side.py` that
the bucket-aligned inner join runs: `_bucket_hash_dtypes`,
`_keyed_on_buckets`, `_aligned_side`, `_side_data`,
`_bucket_files_in_order` and `_join_sides` with two of its branches — the
zero-exchange aligned path (both sides index scans bucketed alike on
their join keys) and the single-partition fallback. Not ported yet: the
hybrid-scan (Union) sides, dynamic partition pruning, the re-bucketing
exchange and the bucket-preserved reuse of an inner join's output; a join
they would serve runs on one partition instead, which is correct, only
slower.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.execution import io as hio
from hyperspace_tpu_torch.execution.exec_common import AlignedSide, SideData, _filter_side
from hyperspace_tpu_torch.execution.exec_scan import scan_files
from hyperspace_tpu_torch.plan.expr import And
from hyperspace_tpu_torch.plan.nodes import Filter, Join, LogicalPlan, Project, Scan


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
        """Per-side bucket data for a join: the zero-exchange aligned path
        when both sides are bucketed with equal counts on the join keys in
        one hash domain, else one partition holding each whole side."""
        left_side = self._aligned_side(plan.left)
        right_side = self._aligned_side(plan.right)
        if (
            self._keyed_on_buckets(left_side, plan.left_on)
            and self._keyed_on_buckets(right_side, plan.right_on)
            and left_side.scan.bucket_spec[0] == right_side.scan.bucket_spec[0]
            # Equal VALUES hash identically only in equal dtype domains.
            and self._bucket_hash_dtypes(left_side.scan) == self._bucket_hash_dtypes(right_side.scan)
        ):
            num_buckets = left_side.scan.bucket_spec[0]
            lside = self._side_data(left_side, num_buckets)
            rside = self._side_data(right_side, num_buckets)
            self.stats["join_path"] = "zero-exchange-aligned"
            return lside, rside
        # Single partition (bucket count 1). The path stat is set AFTER the
        # children run: a nested join inside them sets its own path and
        # must not leak into this frame's label.
        lt = self._execute(plan.left)
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
        if isinstance(node, Scan):
            return AlignedSide(node, predicate=predicate)
        return None

    def _side_data(self, side: AlignedSide, num_buckets: int) -> SideData:
        """One bucket-grouped table per join side: every bucket's files
        read in bucket order as one multi-file read through the session's
        device cache (the table and its per-file row counts are one
        entry), with the bucket offsets; the side's own filter applies
        after, per bucket."""
        schema = side.scan.scan_schema
        groups = self._bucket_files_in_order(side.scan, num_buckets)
        files = [f for g in groups for f in g]
        table, file_rows = self._read(files, schema.names, schema, side.scan.root, file_rows=True)
        # Files of one bucket are adjacent: sum their rows per bucket.
        starts = np.cumsum([0] + [len(g) for g in groups[:-1]])
        offsets = np.concatenate([[0], np.cumsum(np.add.reduceat(file_rows, starts))]).astype(np.int64)
        # A bucket of several files (incremental refresh) is not sorted as
        # a whole; one file per bucket is.
        sorted_within = all(len(g) <= 1 for g in groups)
        out = SideData(table, offsets, sorted_within)
        if side.predicate is not None:
            out = _filter_side(out, side.predicate)
        return out

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

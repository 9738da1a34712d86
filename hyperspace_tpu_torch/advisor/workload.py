"""Workload capture: the per-query evidence the advisor learns from.

A port of the JAX package's `advisor/workload.py`. Every
``session.run_query`` appends one compact :class:`WorkloadRecord` to the
session's bounded :class:`WorkloadLog` — the logical plan (an in-memory
reference, not a copy), its structural signature, the measured
wall/bytes, and which indexes served it. The log is the advisor's input:
the what-if analyzer replays its plans through the rewrite rules against
hypothetical indexes (whatif.py), the cost model calibrates from its
profiles (cost.py), and the drop detector looks for indexes it never
names (an index no observed query touched is paying refresh/storage rent
for nothing).

Recording costs one dataclass + deque append per query and is bounded by
``hyperspace.advisor.workload.maxRecords`` — old traffic ages out, so a
workload shift re-trains the advisor automatically.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from pathlib import Path

from hyperspace_tpu_torch.plan.nodes import Filter, LogicalPlan, Project, Scan


@dataclasses.dataclass
class WorkloadRecord:
    """One observed query: identity, measured cost, index usage."""

    signature: str  # plan_signature of the LOGICAL plan (pre-optimize)
    plan: LogicalPlan  # in-memory reference (the advisor replays it)
    total_s: float
    bytes_scanned: int
    used_indexes: bool  # post-fallback/routing truth
    index_names: tuple[str, ...]  # index dirs that served this query
    profile: object = None  # QueryProfile (cost-model calibration input)
    routed: str | None = None  # advisor routing decision, None = routing off

    def to_json(self) -> dict:
        return {
            "signature": self.signature,
            "total_s": self.total_s,
            "bytes_scanned": self.bytes_scanned,
            "used_indexes": self.used_indexes,
            "index_names": list(self.index_names),
            "routed": self.routed,
        }


class WorkloadLog:
    """Bounded, thread-safe ring of recent :class:`WorkloadRecord`\\ s."""

    def __init__(self, max_records: int = 512):
        self._lock = threading.Lock()
        self._records: deque[WorkloadRecord] = deque(maxlen=int(max_records))

    def record(self, rec: WorkloadRecord) -> None:
        with self._lock:
            self._records.append(rec)

    def snapshot(self) -> list[WorkloadRecord]:
        with self._lock:
            return list(self._records)

    def clear(self) -> None:
        with self._lock:
            self._records.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)


def used_index_names(optimized_plan: LogicalPlan) -> tuple[str, ...]:
    """Index directory names the optimized plan reads (bucketed scans'
    roots are index dirs; their basename is the index name). Pure plan
    walk — no catalog round-trip on the query hot path."""
    names = []
    for leaf in optimized_plan.leaves():
        if leaf.bucket_spec is not None:
            names.append(Path(leaf.root).name)
    return tuple(sorted(set(names)))


@dataclasses.dataclass(frozen=True)
class PredicateShape:
    """One mined rewrite opportunity: a filter over a raw source scan."""

    root: str  # source dataset root
    fmt: str
    filter_columns: tuple[str, ...]  # lowercased, sorted — candidate keys
    required_columns: tuple[str, ...]  # lowercased — coverage set


def mine_predicate_shapes(plan: LogicalPlan) -> list[tuple[PredicateShape, Scan]]:
    """Filter-over-raw-scan shapes in `plan` — exactly the shapes
    FilterIndexRule rewrites (Project(Filter(Scan)) / Filter(Scan) /
    Filter(Project(Scan))), mined from the un-rewritten logical plan so
    the advisor sees what COULD be indexed, not what already is."""
    out: list[tuple[PredicateShape, Scan]] = []

    def shape(scan: Scan, predicate, output_cols) -> None:
        if scan.bucket_spec is not None:
            return  # already an index scan
        fcols = tuple(sorted(predicate.references()))
        req = tuple(sorted(fcols + tuple(c.lower() for c in output_cols)))
        if fcols:
            out.append((PredicateShape(scan.root, scan.format, fcols, req), scan))

    def walk(p: LogicalPlan) -> None:
        if isinstance(p, Project) and isinstance(p.child, Filter) and isinstance(p.child.child, Scan):
            shape(p.child.child, p.child.predicate, p.input_columns())
            return  # the inner Filter(Scan) is THIS shape, not a second one
        if isinstance(p, Filter) and isinstance(p.child, Scan):
            shape(p.child, p.predicate, p.child.scan_schema.names)
            return
        if (
            isinstance(p, Filter)
            and isinstance(p.child, Project)
            and p.child.is_simple
            and isinstance(p.child.child, Scan)
        ):
            shape(p.child.child, p.predicate, p.child.input_columns())
            return
        for c in p.children():
            walk(c)

    walk(plan)
    return out

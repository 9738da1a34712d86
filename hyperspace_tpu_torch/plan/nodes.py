"""Logical plan IR: declarative, JSON-native relational algebra.

Design stance (SURVEY.md §7): the reference's most fragile subsystem is its
Kryo plan serde (index/serde/LogicalPlanSerDeUtils.scala:37-246 + 12 wrapper
classes) which exists only because Catalyst plans aren't serializable. Our
plans are plain dataclasses that round-trip through JSON trivially, while
keeping the same capability: the log entry stores the plan as lineage and
`refresh` re-executes it (actions/RefreshAction.scala:45-50).

A `Scan` stores the dataset root + format + schema — NOT a pinned file list.
On (re-)execution the file list is derived from the live filesystem.

A copy of the JAX package's `plan/nodes.py`, cut to the nodes the port's
slice executes: Scan, Filter, a passthrough Project, and a plain GROUP BY
Aggregate over sum / count / min / max / mean. Join, Union, Window, Sort,
Limit, computed projections, grouping sets and count-distinct are not
ported yet. The JSON form is the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from hyperspace_tpu_torch.plan.expr import Col, Expr, expr_from_json
from hyperspace_tpu_torch.schema import Field, Schema


class LogicalPlan:
    """Base plan node. Offers the fluent builder users treat as a DataFrame."""

    def filter(self, predicate: Expr) -> "Filter":
        return Filter(self, predicate)

    def select(self, *columns: str) -> "Project":
        """Project (pass through) the named columns."""
        return Project(self, list(columns))

    def aggregate(self, group_by: list[str], aggs: list) -> "Aggregate":
        """Grouped aggregation. `aggs` entries are AggSpec or
        (fn, expr|column|None, alias) tuples; fn ∈ sum/count/min/max/mean."""
        specs = [a if isinstance(a, AggSpec) else AggSpec.of(*a) for a in aggs]
        return Aggregate(self, list(group_by), specs)

    # -- interface --------------------------------------------------------
    @property
    def schema(self) -> Schema:
        raise NotImplementedError

    def children(self) -> list["LogicalPlan"]:
        raise NotImplementedError

    def to_json(self) -> dict[str, Any]:
        raise NotImplementedError

    def leaves(self) -> list["Scan"]:
        if isinstance(self, Scan):
            return [self]
        out: list[Scan] = []
        for c in self.children():
            out.extend(c.leaves())
        return out


@dataclasses.dataclass
class Scan(LogicalPlan):
    """Leaf: scan a registered columnar dataset (analog of
    LogicalRelation(HadoopFsRelation) in the reference)."""

    root: str
    format: str
    scan_schema: Schema
    # Optional pinned file subset (used for index scans); None ⇒ list the
    # live filesystem at execution time.
    files: list[str] | None = None
    # Bucket spec when scanning bucketed index data (num_buckets, bucket_cols)
    bucket_spec: tuple[int, list[str]] | None = None

    @property
    def schema(self) -> Schema:
        return self.scan_schema

    def children(self) -> list[LogicalPlan]:
        return []

    def to_json(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "type": "scan",
            "root": self.root,
            "format": self.format,
            "schema": self.scan_schema.to_json(),
        }
        if self.files is not None:
            d["files"] = self.files
        if self.bucket_spec is not None:
            d["bucketSpec"] = {"numBuckets": self.bucket_spec[0], "bucketColumns": self.bucket_spec[1]}
        return d


@dataclasses.dataclass
class Filter(LogicalPlan):
    child: LogicalPlan
    predicate: Expr

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def children(self) -> list[LogicalPlan]:
        return [self.child]

    def to_json(self) -> dict[str, Any]:
        return {"type": "filter", "child": self.child.to_json(), "predicate": self.predicate.to_json()}


@dataclasses.dataclass
class Project(LogicalPlan):
    """Passthrough projection: every entry of `columns` is a column name."""

    child: LogicalPlan
    columns: list

    def __post_init__(self):
        if not all(isinstance(c, str) for c in self.columns):
            raise ValueError("only passthrough (column-name) projections are supported")

    @property
    def output_names(self) -> list[str]:
        return list(self.columns)

    def input_columns(self) -> set[str]:
        """Lowercased child columns the projection reads."""
        return {c.lower() for c in self.columns}

    @property
    def schema(self) -> Schema:
        return self.child.schema.select(self.columns)

    def children(self) -> list[LogicalPlan]:
        return [self.child]

    def to_json(self) -> dict[str, Any]:
        return {"type": "project", "child": self.child.to_json(), "columns": self.columns}


@dataclasses.dataclass
class AggSpec:
    """One aggregation: fn over an expression (None = count(*))."""

    fn: str  # sum | count | min | max | mean
    expr: Expr | None
    alias: str

    _FNS = ("sum", "count", "min", "max", "mean")

    def __post_init__(self):
        if self.fn not in self._FNS:
            raise ValueError(f"unknown aggregate fn {self.fn!r}")
        if self.expr is None and self.fn != "count":
            raise ValueError(f"{self.fn} requires an input expression")

    @staticmethod
    def of(fn: str, expr=None, alias: str | None = None) -> "AggSpec":
        if isinstance(expr, str):
            expr = Col(expr)
        if alias is None:
            base = expr.name if isinstance(expr, Col) else ("star" if expr is None else "expr")
            alias = f"{fn}_{base}" if expr is not None else "count"
        return AggSpec(fn, expr, alias)

    def references(self) -> set[str]:
        return self.expr.references() if self.expr is not None else set()

    def to_json(self) -> dict[str, Any]:
        return {
            "fn": self.fn,
            "expr": self.expr.to_json() if self.expr is not None else None,
            "alias": self.alias,
        }

    @staticmethod
    def from_json(d: dict[str, Any]) -> "AggSpec":
        e = expr_from_json(d["expr"]) if d.get("expr") is not None else None
        return AggSpec(d["fn"], e, d["alias"])


@dataclasses.dataclass
class Aggregate(LogicalPlan):
    """Grouped aggregation: plain GROUP BY over the child's rows."""

    child: LogicalPlan
    group_by: list[str]
    aggs: list[AggSpec]

    def __post_init__(self):
        seen: set[str] = set()
        for name in [*(c.lower() for c in self.group_by), *(a.alias.lower() for a in self.aggs)]:
            if name in seen:
                raise ValueError(f"duplicate output column {name!r} in aggregate")
            seen.add(name)

    @property
    def schema(self) -> Schema:
        child = self.child.schema
        fields = [child.field(c) for c in self.group_by]
        for a in self.aggs:
            if a.fn == "count":
                dtype = "int64"
            elif a.fn == "mean":
                dtype = "float64"
            elif isinstance(a.expr, Col):
                src = child.field(a.expr.name)
                if a.fn in ("min", "max"):
                    dtype = src.dtype
                else:  # sum widens integers
                    dtype = "int64" if src.dtype in ("int32", "int64", "bool", "date") else "float64"
            else:
                dtype = "float64"
            fields.append(Field(a.alias, dtype))
        return Schema(tuple(fields))

    def children(self) -> list[LogicalPlan]:
        return [self.child]

    def to_json(self) -> dict[str, Any]:
        return {
            "type": "aggregate",
            "child": self.child.to_json(),
            "groupBy": self.group_by,
            "aggs": [a.to_json() for a in self.aggs],
        }


def plan_from_json(d: dict[str, Any]) -> LogicalPlan:
    t = d["type"]
    if t == "scan":
        bs = None
        if "bucketSpec" in d:
            bs = (int(d["bucketSpec"]["numBuckets"]), list(d["bucketSpec"]["bucketColumns"]))
        return Scan(
            d["root"],
            d["format"],
            Schema.from_json(d["schema"]),
            files=d.get("files"),
            bucket_spec=bs,
        )
    if t == "filter":
        return Filter(plan_from_json(d["child"]), expr_from_json(d["predicate"]))
    if t == "project":
        return Project(plan_from_json(d["child"]), list(d["columns"]))
    if t == "aggregate":
        return Aggregate(
            plan_from_json(d["child"]),
            list(d["groupBy"]),
            [AggSpec.from_json(a) for a in d["aggs"]],
        )
    raise ValueError(f"unknown plan node type {t!r}")

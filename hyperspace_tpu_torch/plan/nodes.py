"""Logical plan IR: declarative, JSON-native relational algebra.

Design stance (SURVEY.md §7): the reference's most fragile subsystem is its
Kryo plan serde (index/serde/LogicalPlanSerDeUtils.scala:37-246 + 12 wrapper
classes) which exists only because Catalyst plans aren't serializable. Our
plans are plain dataclasses that round-trip through JSON trivially, while
keeping the same capability: the log entry stores the plan as lineage and
`refresh` re-executes it (actions/RefreshAction.scala:45-50).

A `Scan` stores the dataset root + format + schema — NOT a pinned file list.
On (re-)execution the file list is derived from the live filesystem.

A copy of the JAX package's `plan/nodes.py`, cut to the nodes the port
executes: Scan, Filter, Project (passthrough and computed), the
equi-Join with every join type (inner, left / right / full outer, semi,
anti), an ON residual and null-safe keys, and a plain GROUP BY Aggregate
over sum / count / min / max / mean; with the builders `intersect`,
`except_` and `distinct`, which desugar to those nodes. Union, Window,
Sort, Limit, grouping sets and count-distinct are not ported yet. The
JSON form is the JAX package's.
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

    def select(self, *columns) -> "Project":
        """Project columns. Entries are names (passthrough) or
        ``(alias, Expr)`` pairs for computed output columns."""
        return Project(self, list(columns))

    def with_column(self, alias: str, expression) -> "Project":
        """Add one computed column, or replace an existing column of the
        same name (Spark withColumn semantics)."""
        entries = [(alias, expression) if c.lower() == alias.lower() else c for c in self.schema.names]
        if not any(c.lower() == alias.lower() for c in self.schema.names):
            entries.append((alias, expression))
        return Project(self, entries)

    def join(
        self,
        other: "LogicalPlan",
        left_on: list[str],
        right_on: list[str] | None = None,
        how: str = "inner",
        condition: "Expr | None" = None,
    ) -> "Join":
        """Equi-join on key lists; `condition` adds a non-equi residual
        (`ON a.k = b.k AND a.lo <= b.hi` shapes)."""
        return Join(
            self, other, list(left_on), list(right_on or left_on), how,
            condition=condition,
        )

    def aggregate(self, group_by: list[str], aggs: list) -> "Aggregate":
        """Grouped aggregation. `aggs` entries are AggSpec or
        (fn, expr|column|None, alias) tuples; fn ∈ sum/count/min/max/mean."""
        specs = [a if isinstance(a, AggSpec) else AggSpec.of(*a) for a in aggs]
        return Aggregate(self, list(group_by), specs)

    def intersect(self, other: "LogicalPlan") -> "Join":
        """SQL INTERSECT (set semantics, positional columns): distinct left
        rows that also appear in `other`. Desugars to DISTINCT + NULL-SAFE
        SEMI JOIN on every column: set comparison treats NULL as equal to
        NULL (SQL's IS NOT DISTINCT FROM), so a NULL-bearing row
        intersects with its NULL-bearing twin — unlike the ordinary join,
        where NULL never equals anything."""
        return self._set_op(other, "semi")

    def except_(self, other: "LogicalPlan") -> "Join":
        """SQL EXCEPT: distinct left rows absent from `other`. Desugars to
        DISTINCT + NULL-SAFE ANTI JOIN on every column (the NULL semantics
        of intersect)."""
        return self._set_op(other, "anti")

    def _set_op(self, other: "LogicalPlan", how: str) -> "Join":
        if len(self.schema.names) != len(other.schema.names):
            raise ValueError(
                f"set operation inputs must have equal width: {self.schema.names} vs {other.schema.names}"
            )
        for lf, rf in zip(self.schema.fields, other.schema.fields):
            # Positional pairs must share a comparison domain: a silent
            # string/number coercion would "match" 1 with '1'.
            if lf.is_string != rf.is_string:
                raise ValueError(
                    f"set operation column types are incompatible: {lf.name} ({lf.dtype}) vs {rf.name} ({rf.dtype})"
                )
        return Join(self.distinct(), other, list(self.schema.names), list(other.schema.names), how, null_safe=True)

    def distinct(self) -> "Aggregate":
        """Distinct rows = group by every column with no aggregates.
        Vector (embedding) columns have no grouping semantics — select the
        scalar columns first."""
        vec = [f.name for f in self.schema.fields if f.is_vector]
        if vec:
            raise ValueError(
                f"distinct() is not defined over vector columns {vec}; select the scalar columns first"
            )
        return Aggregate(self, list(self.schema.names), [])

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
    """Projection with optional named computed expressions. Entries of
    `columns` are either a column name (passthrough) or an ``(alias,
    Expr)`` pair (`SELECT a*b AS x`), typed via expr_dtype."""

    child: LogicalPlan
    columns: list

    @property
    def is_simple(self) -> bool:
        """True iff every entry is a plain passthrough column name."""
        return all(isinstance(c, str) for c in self.columns)

    @property
    def output_names(self) -> list[str]:
        return [c if isinstance(c, str) else c[0] for c in self.columns]

    def input_columns(self) -> set[str]:
        """Lowercased child columns the projection reads (what index
        coverage checks and column pruning need)."""
        out: set[str] = set()
        for c in self.columns:
            if isinstance(c, str):
                out.add(c.lower())
            else:
                out |= c[1].references()
        return out

    @property
    def schema(self) -> Schema:
        from hyperspace_tpu_torch.plan.expr import expr_dtype

        if self.is_simple:
            return self.child.schema.select(self.columns)
        child = self.child.schema
        fields = []
        for c in self.columns:
            if isinstance(c, str):
                fields.append(child.field(c))
            else:
                fields.append(Field(c[0], expr_dtype(c[1], child)))
        return Schema(tuple(fields))

    def children(self) -> list[LogicalPlan]:
        return [self.child]

    def to_json(self) -> dict[str, Any]:
        if self.is_simple:
            return {"type": "project", "child": self.child.to_json(), "columns": self.columns}
        cols = [c if isinstance(c, str) else {"alias": c[0], "expr": c[1].to_json()} for c in self.columns]
        return {"type": "project", "child": self.child.to_json(), "columns": cols}


JOIN_TYPES = ("inner", "left", "right", "full", "semi", "anti")


@dataclasses.dataclass
class Join(LogicalPlan):
    """Equi-join on key column lists (reference matches CNF of EqualTo,
    JoinIndexRule.scala:179-185; the equi-join is structural here). `how`
    covers inner / left / right / full outer, plus (left) semi and anti;
    `condition` is the ON clause's non-equi residual, and `null_safe`
    makes NULL keys equal (the set operations)."""

    left: LogicalPlan
    right: LogicalPlan
    left_on: list[str]
    right_on: list[str]
    how: str = "inner"
    # Non-equi residual of the ON clause (equality stays structural).
    condition: Expr | None = None
    # NULL-safe key equality (SQL IS NOT DISTINCT FROM), used by the set
    # operations (intersect / except_).
    null_safe: bool = False

    def __post_init__(self):
        if len(self.left_on) != len(self.right_on):
            raise ValueError("join key lists must have equal length")
        if self.how not in JOIN_TYPES:
            raise ValueError(f"unknown join type {self.how!r}; one of {JOIN_TYPES}")
        if self.condition is not None:
            # Validate references against the MATCH schema now, so a typo
            # or a merged-away key fails here, not mid-execution.
            out_names = {n.lower() for n in self.match_schema.names}
            missing = sorted(r for r in self.condition.references() if r not in out_names)
            if missing:
                raise ValueError(
                    f"join condition references {missing} not present in the "
                    f"join match schema (right-side key columns merge into "
                    f"the left-named key)"
                )

    @property
    def match_schema(self) -> Schema:
        """Left columns plus right non-key columns — the inner-join shape.
        A non-key name collision is ambiguous and rejected."""
        lf = self.left.schema.fields
        left_names = {f.name.lower() for f in lf}
        keys = {k.lower() for k in self.right_on}
        rf = []
        for f in self.right.schema.fields:
            low = f.name.lower()
            if low in keys:
                continue  # merged into the left key column
            if low in left_names:
                raise ValueError(f"ambiguous non-key column {f.name!r} appears on both join sides")
            rf.append(f)
        return Schema(tuple(lf) + tuple(rf))

    @property
    def schema(self) -> Schema:
        """Join key columns appear once; semi/anti produce the left side's
        schema only."""
        if self.how in ("semi", "anti"):
            return Schema(tuple(self.left.schema.fields))
        return self.match_schema

    def children(self) -> list[LogicalPlan]:
        return [self.left, self.right]

    def to_json(self) -> dict[str, Any]:
        d = {
            "type": "join",
            "left": self.left.to_json(),
            "right": self.right.to_json(),
            "leftOn": self.left_on,
            "rightOn": self.right_on,
            "how": self.how,
        }
        if self.condition is not None:
            d["condition"] = self.condition.to_json()
        if self.null_safe:
            d["nullSafe"] = True
        return d


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
        cols = [c if isinstance(c, str) else (c["alias"], expr_from_json(c["expr"])) for c in d["columns"]]
        return Project(plan_from_json(d["child"]), cols)
    if t == "join":
        return Join(
            plan_from_json(d["left"]),
            plan_from_json(d["right"]),
            list(d["leftOn"]),
            list(d["rightOn"]),
            d.get("how", "inner"),
            condition=expr_from_json(d["condition"]) if "condition" in d else None,
            null_safe=bool(d.get("nullSafe", False)),
        )
    if t == "aggregate":
        return Aggregate(
            plan_from_json(d["child"]),
            list(d["groupBy"]),
            [AggSpec.from_json(a) for a in d["aggs"]],
        )
    raise ValueError(f"unknown plan node type {t!r}")

"""Logical plan IR: declarative, JSON-native relational algebra.

Design stance (SURVEY.md §7): the reference's most fragile subsystem is its
Kryo plan serde (index/serde/LogicalPlanSerDeUtils.scala:37-246 + 12 wrapper
classes) which exists only because Catalyst plans aren't serializable. Our
plans are plain dataclasses that round-trip through JSON trivially, while
keeping the same capability: the log entry stores the plan as lineage and
`refresh` re-executes it (actions/RefreshAction.scala:45-50).

A `Scan` stores the dataset root + format + schema — NOT a pinned file list.
On (re-)execution the file list is derived from the live filesystem, which is
exactly how the reference's deserialize rebuilds `InMemoryFileIndex` against
the live session to pick up new source files
(index/serde/LogicalPlanSerDeUtils.scala:156-223).

A copy of the JAX package's `plan/nodes.py`: Scan, Filter, Project
(passthrough and computed), Union, the equi-Join with every join type, an
ON residual and null-safe keys, Aggregate with count-distinct and grouping
sets (ROLLUP / CUBE), Window, Sort and Limit. The JSON form is the JAX
package's, so a plan logged by one package reads in the other.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from hyperspace_tpu_torch.plan.expr import Expr, expr_from_json
from hyperspace_tpu_torch.schema import Schema


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
        entries = [
            (alias, expression) if c.lower() == alias.lower() else c
            for c in self.schema.names
        ]
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
        (`ON a.k = b.k AND a.lo <= b.hi` shapes). For inner joins it
        filters the matched rows; for outer/semi/anti joins it alters
        MATCHING — a pair failing the residual does not count as a
        match, so the left/right row null-extends (outer) or flips its
        existence verdict (semi/anti), per SQL ON-clause semantics."""
        return Join(
            self, other, list(left_on), list(right_on or left_on), how,
            condition=condition,
        )

    def aggregate(
        self, group_by: list[str], aggs: list, grouping_sets: list[list[str]] | None = None
    ) -> "Aggregate":
        """Grouped aggregation. `aggs` entries are AggSpec or
        (fn, expr|column|None, alias) tuples; fn ∈ sum/count/min/max/mean
        (+ count_distinct, and grouping with grouping_sets)."""
        specs = [a if isinstance(a, AggSpec) else AggSpec.of(*a) for a in aggs]
        return Aggregate(self, list(group_by), specs, grouping_sets=grouping_sets)

    def rollup(self, group_by: list[str], aggs: list) -> "Aggregate":
        """SQL GROUP BY ROLLUP(c1..cn): grouping sets are the prefixes
        (c1..cn), (c1..cn-1), ..., () — subtotals at every level plus the
        grand total."""
        sets = [list(group_by[:i]) for i in range(len(group_by), -1, -1)]
        return self.aggregate(group_by, aggs, grouping_sets=sets)

    def cube(self, group_by: list[str], aggs: list) -> "Aggregate":
        """SQL GROUP BY CUBE(c1..cn): all 2^n column subsets."""
        import itertools

        sets = [
            [c for c in group_by if c in chosen]
            for r in range(len(group_by), -1, -1)
            for chosen in map(set, itertools.combinations(group_by, r))
        ]
        return self.aggregate(group_by, aggs, grouping_sets=sets)

    def window(
        self,
        partition_by: list[str],
        order_by: list | None = None,
        funcs: list | None = None,
        frame: str | None = None,
    ) -> "Window":
        """Window functions. `funcs` entries are WindowSpec or
        (fn, expr|column|None, alias) tuples; `order_by` entries are
        names or (name, asc) pairs. Default frame: SQL's — "range"
        (peers share) when an ORDER BY is present, else the whole
        partition."""
        ob = []
        for b in order_by or []:
            ob.append((b[0], bool(b[1])) if isinstance(b, tuple) else (b, True))
        specs = [f if isinstance(f, WindowSpec) else WindowSpec.of(*f) for f in funcs or []]
        if frame is None:
            frame = "range" if ob else "partition"
        return Window(self, list(partition_by), ob, specs, frame)

    def sort(self, by: list, ascending: bool | list[bool] = True) -> "Sort":
        """Order by columns. `by` entries are names or (name, asc) pairs."""
        keys = []
        asc_list = ascending if isinstance(ascending, list) else [ascending] * len(by)
        for b, a in zip(by, asc_list):
            if isinstance(b, tuple):
                keys.append((b[0], bool(b[1])))
            else:
                keys.append((b, bool(a)))
        return Sort(self, keys)

    def limit(self, n: int) -> "Limit":
        return Limit(self, int(n))

    def intersect(self, other: "LogicalPlan") -> "Join":
        """SQL INTERSECT (set semantics, positional columns like the
        reference round-trips via Catalyst's Intersect node,
        LogicalPlanSerDeUtils.scala:82-145): distinct left rows that also
        appear in `other`. Desugars to DISTINCT + NULL-SAFE SEMI JOIN on
        every column: set comparison treats NULL as equal to NULL (SQL's
        IS NOT DISTINCT FROM), so a NULL-bearing row intersects with its
        NULL-bearing twin — unlike the engine's ordinary join semantics
        where NULL never equals anything."""
        return self._set_op(other, "semi")

    def except_(self, other: "LogicalPlan") -> "Join":
        """SQL EXCEPT: distinct left rows absent from `other`. Desugars
        to DISTINCT + NULL-SAFE ANTI JOIN on every column (same NULL
        semantics as intersect: a left NULL-bearing row is removed when
        `other` holds an identical NULL-bearing row)."""
        return self._set_op(other, "anti")

    def _set_op(self, other: "LogicalPlan", how: str) -> "Join":
        if len(self.schema.names) != len(other.schema.names):
            raise ValueError(
                f"set operation inputs must have equal width: "
                f"{self.schema.names} vs {other.schema.names}"
            )
        for lf, rf in zip(self.schema.fields, other.schema.fields):
            # Positional pairs must share a comparison domain — a silent
            # string/number coercion would "match" 1 with '1'.
            if lf.is_string != rf.is_string:
                raise ValueError(
                    f"set operation column types are incompatible: "
                    f"{lf.name} ({lf.dtype}) vs {rf.name} ({rf.dtype})"
                )
        return Join(
            self.distinct(), other, list(self.schema.names),
            list(other.schema.names), how, null_safe=True,
        )

    def distinct(self) -> "Aggregate":
        """Distinct rows = group by every column with no aggregates.
        Vector (embedding) columns have no grouping semantics — select
        the scalar columns first."""
        vec = [f.name for f in self.schema.fields if f.is_vector]
        if vec:
            raise ValueError(
                f"distinct() is not defined over vector columns {vec}; "
                "select the scalar columns first"
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

    def is_linear(self) -> bool:
        """True iff no node has more than one child (reference requires
        linear sub-plans for join sides, JoinIndexRule.scala:210-211)."""
        cs = self.children()
        return len(cs) <= 1 and all(c.is_linear() for c in cs)


@dataclasses.dataclass
class Scan(LogicalPlan):
    """Leaf: scan a registered columnar dataset (analog of
    LogicalRelation(HadoopFsRelation) in the reference)."""

    root: str
    format: str
    scan_schema: Schema
    # Optional pinned file subset (used for index scans / hybrid scan);
    # None ⇒ list the live filesystem at execution time.
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
    `columns` are either a column name (passthrough) or an
    ``(alias, Expr)`` pair (`SELECT a*b AS x` — the reference gets
    computed select lists from Catalyst's Project for free; our IR
    carries them explicitly and types them via expr_dtype)."""

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
        from hyperspace_tpu_torch.schema import Field

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
        cols = [
            c if isinstance(c, str) else {"alias": c[0], "expr": c[1].to_json()}
            for c in self.columns
        ]
        return {"type": "project", "child": self.child.to_json(), "columns": cols}


@dataclasses.dataclass
class Union(LogicalPlan):
    """Concatenate rows of name-compatible children. Exists for Hybrid Scan:
    an index scan unioned with a scan pinned to source files appended since
    the index build (the analog of later-Hyperspace's hybrid scan plan,
    which unions index data with an on-the-fly scan of appended files)."""

    inputs: list[LogicalPlan]

    def __post_init__(self):
        if not self.inputs:
            raise ValueError("union needs at least one input")
        first = [n.lower() for n in self.inputs[0].schema.names]
        for child in self.inputs[1:]:
            if [n.lower() for n in child.schema.names] != first:
                raise ValueError(
                    f"union inputs must share column names: {first} vs {child.schema.names}"
                )

    @property
    def schema(self) -> Schema:
        return self.inputs[0].schema

    def children(self) -> list[LogicalPlan]:
        return list(self.inputs)

    def to_json(self) -> dict[str, Any]:
        return {"type": "union", "inputs": [c.to_json() for c in self.inputs]}


JOIN_TYPES = ("inner", "left", "right", "full", "semi", "anti")


@dataclasses.dataclass
class Join(LogicalPlan):
    """Equi-join on key column lists (reference matches CNF of EqualTo,
    JoinIndexRule.scala:179-185; we make the equi-join structural). `how`
    covers the join types Spark's SortMergeJoinExec serves over the
    reference's rewritten bucketed relations (JoinIndexRule.scala:124-153
    swaps only the relations inside whatever join node it matched):
    inner / left / right / full outer, plus (left) semi and anti."""

    left: LogicalPlan
    right: LogicalPlan
    left_on: list[str]
    right_on: list[str]
    how: str = "inner"
    # Non-equi residual of the ON clause (equality stays structural):
    # evaluated with full 3-valued semantics over the equi-matched
    # pairs. Inner joins filter; outer/semi/anti joins treat a failing
    # pair as NO MATCH (null-extension / existence semantics).
    condition: Expr | None = None
    # NULL-safe key equality (SQL IS NOT DISTINCT FROM): NULL matches
    # NULL per key column instead of never matching. The set operations
    # (intersect/except_) desugar with this on; the key factorization
    # gives NULL its own code-domain value per column, shared across
    # sides (execution/exec_common.py).
    null_safe: bool = False

    def __post_init__(self):
        if len(self.left_on) != len(self.right_on):
            raise ValueError("join key lists must have equal length")
        if self.how not in JOIN_TYPES:
            raise ValueError(f"unknown join type {self.how!r}; one of {JOIN_TYPES}")
        if self.condition is not None:
            # Validate references against the MATCH schema now (right
            # key names merge into the left-named column; semi/anti
            # conditions may read right non-key columns even though the
            # output is left-only), so a typo or a merged-away key fails
            # here, not mid-execution.
            out_names = {n.lower() for n in self.match_schema.names}
            missing = sorted(
                r for r in self.condition.references() if r not in out_names
            )
            if missing:
                raise ValueError(
                    f"join condition references {missing} not present in the "
                    f"join match schema (right-side key columns merge into "
                    f"the left-named key)"
                )

    @property
    def match_schema(self) -> Schema:
        """The schema an ON residual evaluates over: left columns plus
        right non-key columns — the inner-join shape, whatever `how` is.
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
                raise ValueError(
                    f"ambiguous non-key column {f.name!r} appears on both join sides"
                )
            rf.append(f)
        return Schema(tuple(lf) + tuple(rf))

    @property
    def schema(self) -> Schema:
        """Join key columns appear once (equal for matches; outer joins
        coalesce the surviving side's key into the left-named column).
        Semi/anti produce the left side's schema only."""
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
            # Emitted only when set, so pre-existing plan signatures and
            # logged lineage stay byte-identical for ordinary joins.
            d["nullSafe"] = True
        return d


@dataclasses.dataclass
class AggSpec:
    """One aggregation: fn over an expression (None = count(*)).
    count_distinct counts distinct non-null values of a column and
    executes as a two-phase re-aggregation (the executor desugars it)."""

    fn: str  # sum | count | min | max | mean | count_distinct | grouping
    expr: Expr | None
    alias: str

    _FNS = ("sum", "count", "min", "max", "mean", "count_distinct", "grouping")

    def __post_init__(self):
        from hyperspace_tpu_torch.plan.expr import Col

        if self.fn not in self._FNS:
            raise ValueError(f"unknown aggregate fn {self.fn!r}")
        if self.expr is None and self.fn != "count":
            raise ValueError(f"{self.fn} requires an input expression")
        if self.fn == "grouping" and not isinstance(self.expr, Col):
            # SQL GROUPING(col): 1 when the output row aggregates the
            # column away (a coarser grouping set), else 0.
            raise ValueError("grouping() takes a single group-by column")

    @staticmethod
    def of(fn: str, expr=None, alias: str | None = None) -> "AggSpec":
        from hyperspace_tpu_torch.plan.expr import Col

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
    """Grouped aggregation — one of the engine-side operators the TPU build
    owns (SURVEY.md §2.2 lists the WholeStageCodegen'd operators Spark
    'provided' to the reference). Sorted-key segments post-index make the
    device reduction cheap; Aggregate(Join) additionally fuses into a
    run-prefix aggregation that never materializes the joined pairs."""

    child: LogicalPlan
    group_by: list[str]
    aggs: list[AggSpec]
    # GROUPING SETS: each entry is a subset of group_by; the output is
    # the union of re-groupings (ROLLUP/CUBE desugar to this). None =
    # plain GROUP BY. Executes as ONE finest-grain aggregate + cheap
    # re-aggregations of its partials (the two-phase machinery that
    # count_distinct pioneered, generalized).
    grouping_sets: list[list[str]] | None = None

    def __post_init__(self):
        seen: set[str] = set()
        for name in [*(c.lower() for c in self.group_by), *(a.alias.lower() for a in self.aggs)]:
            if name in seen:
                raise ValueError(f"duplicate output column {name!r} in aggregate")
            seen.add(name)
        gset = {c.lower() for c in self.group_by}
        if self.grouping_sets is not None:
            for s in self.grouping_sets:
                if not {c.lower() for c in s} <= gset:
                    raise ValueError(f"grouping set {s} is not a subset of group_by")
        for a in self.aggs:
            if a.fn == "grouping":
                if self.grouping_sets is None:
                    raise ValueError("grouping() requires grouping sets / rollup")
                if a.expr.name.lower() not in gset:
                    raise ValueError(f"grouping({a.expr.name}) is not a group-by column")

    @property
    def schema(self) -> Schema:
        from hyperspace_tpu_torch.plan.expr import Col
        from hyperspace_tpu_torch.schema import Field

        child = self.child.schema
        fields = [child.field(c) for c in self.group_by]
        for a in self.aggs:
            if a.fn in ("count", "count_distinct", "grouping"):
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
        d = {
            "type": "aggregate",
            "child": self.child.to_json(),
            "groupBy": self.group_by,
            "aggs": [a.to_json() for a in self.aggs],
        }
        if self.grouping_sets is not None:
            d["groupingSets"] = [list(s) for s in self.grouping_sets]
        return d


@dataclasses.dataclass
class WindowSpec:
    """One window function: fn over an expression (None for the ranking
    family and count(*)). lag/lead shift the value within the partition
    by `offset` rows of the ORDER BY (SQL LAG/LEAD with a NULL default);
    they ignore the frame."""

    fn: str  # row_number | rank | dense_rank | sum | count | mean | min | max | lag | lead
    expr: Expr | None
    alias: str
    offset: int = 1  # lag/lead only

    _FNS = ("row_number", "rank", "dense_rank", "sum", "count", "mean", "min", "max", "lag", "lead")
    RANKING = ("row_number", "rank", "dense_rank")
    SHIFT = ("lag", "lead")

    def __post_init__(self):
        if self.fn not in self._FNS:
            raise ValueError(f"unknown window fn {self.fn!r}")
        if self.expr is None and self.fn not in (*self.RANKING, "count"):
            raise ValueError(f"{self.fn} requires an input expression")
        if self.expr is not None and self.fn in self.RANKING:
            raise ValueError(f"{self.fn} takes no input expression")
        if self.fn in self.SHIFT and self.offset < 1:
            raise ValueError(f"{self.fn} offset must be >= 1")

    @staticmethod
    def of(fn: str, expr=None, alias: str | None = None, offset: int = 1) -> "WindowSpec":
        from hyperspace_tpu_torch.plan.expr import Col

        if isinstance(expr, str):
            expr = Col(expr)
        if alias is None:
            base = expr.name if isinstance(expr, Col) else ("star" if expr is None else "expr")
            alias = f"{fn}_{base}" if expr is not None else fn
        return WindowSpec(fn, expr, alias, offset)

    def references(self) -> set[str]:
        return self.expr.references() if self.expr is not None else set()

    def to_json(self) -> dict[str, Any]:
        d = {
            "fn": self.fn,
            "expr": self.expr.to_json() if self.expr is not None else None,
            "alias": self.alias,
        }
        if self.fn in self.SHIFT:
            d["offset"] = self.offset
        return d

    @staticmethod
    def from_json(d: dict[str, Any]) -> "WindowSpec":
        e = expr_from_json(d["expr"]) if d.get("expr") is not None else None
        return WindowSpec(d["fn"], e, d["alias"], d.get("offset", 1))


WINDOW_FRAMES = ("partition", "rows", "range")


@dataclasses.dataclass
class Window(LogicalPlan):
    """Window functions over partitions: every child row passes through
    with one extra column per WindowSpec. The reference's environment gets
    Spark's Window exec; the engine formulates it as sorted segments
    over the engine's order-preserving key lanes (ops/window.py).

    `frame` applies to the aggregate functions:
      - "partition": the whole partition (no ORDER BY needed);
      - "rows":  ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW;
      - "range": RANGE ... CURRENT ROW (peer rows by the order key share
        the frame result — SQL's default frame when ORDER BY is present).
    Ranking functions always need an ORDER BY and ignore the frame."""

    child: LogicalPlan
    partition_by: list[str]
    order_by: list[tuple[str, bool]]
    funcs: list["WindowSpec"]
    frame: str = "partition"

    def __post_init__(self):
        if not self.funcs:
            raise ValueError("window requires at least one function")
        if self.frame not in WINDOW_FRAMES:
            raise ValueError(f"unknown window frame {self.frame!r}; one of {WINDOW_FRAMES}")
        if self.frame != "partition" and not self.order_by:
            raise ValueError(f"window frame {self.frame!r} requires an ORDER BY")
        if not self.order_by and any(
            f.fn in (*WindowSpec.RANKING, *WindowSpec.SHIFT) for f in self.funcs
        ):
            raise ValueError("ranking and lag/lead window functions require an ORDER BY")
        child_names = {n.lower() for n in self.child.schema.names}
        seen = set(child_names)
        for f in self.funcs:
            low = f.alias.lower()
            if low in seen:
                raise ValueError(f"window output column {f.alias!r} collides")
            seen.add(low)

    @property
    def schema(self) -> Schema:
        from hyperspace_tpu_torch.plan.expr import Col
        from hyperspace_tpu_torch.schema import Field

        child = self.child.schema
        fields = list(child.fields)
        for f in self.funcs:
            if f.fn in (*WindowSpec.RANKING, "count"):
                dtype = "int64"
            elif f.fn == "mean":
                dtype = "float64"
            elif isinstance(f.expr, Col):
                src = child.field(f.expr.name)
                if f.fn in ("min", "max", "lag", "lead"):
                    dtype = src.dtype  # extremum / shift preserve the input type
                else:  # sum widens integers
                    dtype = "int64" if src.dtype in ("int32", "int64", "bool", "date") else "float64"
            else:
                dtype = "float64"
            fields.append(Field(f.alias, dtype))
        return Schema(tuple(fields))

    def children(self) -> list[LogicalPlan]:
        return [self.child]

    def to_json(self) -> dict[str, Any]:
        return {
            "type": "window",
            "child": self.child.to_json(),
            "partitionBy": self.partition_by,
            "orderBy": [[c, bool(a)] for c, a in self.order_by],
            "funcs": [f.to_json() for f in self.funcs],
            "frame": self.frame,
        }


@dataclasses.dataclass
class Sort(LogicalPlan):
    """Total order by (column, ascending) keys — executes as one stable
    device sort over order-preserving 32-bit lanes (ops/sortkeys.py)."""

    child: LogicalPlan
    by: list[tuple[str, bool]]

    def __post_init__(self):
        if not self.by:
            raise ValueError("sort requires at least one order-by key")

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def children(self) -> list[LogicalPlan]:
        return [self.child]

    def to_json(self) -> dict[str, Any]:
        return {
            "type": "sort",
            "child": self.child.to_json(),
            "by": [[c, bool(a)] for c, a in self.by],
        }


@dataclasses.dataclass
class Limit(LogicalPlan):
    child: LogicalPlan
    n: int

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def children(self) -> list[LogicalPlan]:
        return [self.child]

    def to_json(self) -> dict[str, Any]:
        return {"type": "limit", "child": self.child.to_json(), "n": self.n}


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
        cols = [
            c if isinstance(c, str) else (c["alias"], expr_from_json(c["expr"]))
            for c in d["columns"]
        ]
        return Project(plan_from_json(d["child"]), cols)
    if t == "union":
        return Union([plan_from_json(c) for c in d["inputs"]])
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
        gs = d.get("groupingSets")
        return Aggregate(
            plan_from_json(d["child"]),
            list(d["groupBy"]),
            [AggSpec.from_json(a) for a in d["aggs"]],
            grouping_sets=[list(s) for s in gs] if gs is not None else None,
        )
    if t == "window":
        return Window(
            plan_from_json(d["child"]),
            list(d["partitionBy"]),
            [(c, bool(a)) for c, a in d["orderBy"]],
            [WindowSpec.from_json(f) for f in d["funcs"]],
            d.get("frame", "partition"),
        )
    if t == "sort":
        return Sort(plan_from_json(d["child"]), [(c, bool(a)) for c, a in d["by"]])
    if t == "limit":
        return Limit(plan_from_json(d["child"]), int(d["n"]))
    raise ValueError(f"unknown plan node type {t!r}")

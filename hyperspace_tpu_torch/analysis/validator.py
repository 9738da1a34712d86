"""Pre-execution plan validator.

The Spark reference never validates plans itself — Catalyst's analyzer
rejects malformed trees before any Hyperspace rule sees them. Our IR has
no Catalyst in front of it, so a malformed plan (a typo'd column, a
string compared to a number, two indexes bucketed differently on the
join keys) used to surface as an opaque mid-execution KeyError or device
shape error. This pass walks the logical plan BEFORE the executor runs
and reports every problem at once as structured `PlanDiagnostic`s with
node provenance.

Severities:
- **error** — the plan cannot execute correctly (unresolved column,
  dtype-incompatible predicate, unsortable key, string arithmetic).
  `Executor.execute` refuses these up front.
- **warning** — legal but almost certainly a mistake or a silent perf
  cliff (join over two index scans bucketed on the join keys whose
  bucket specs disagree: the executor quietly falls off the
  zero-exchange path and re-shuffles). Surfaced by `validate_plan`;
  `check_plan(fail_on="warning")` promotes them to failures.

`validate_rewrite(original, optimized)` additionally guards the
optimizer: the rewritten plan must resolve, keep the original output
schema, and must not have pushed a filter beneath the null-extended
side of an outer join (which would drop rows that should null-extend).

A copy of the JAX package's `analysis/validator.py`, with the same rule
codes and node paths, and one deliberate difference in `_check_scan`:
an index scan (a Scan with a bucket spec and a pinned file list, as the
rewrite rules build it) whose bucket column was pruned away by column
pruning is no error here. The JAX package rejects that plan
(`Filter(k IN (1, 2)).select("k", "v")` over an index on `[k, s]`:
"bucket column 's' does not exist in the scan schema"), although the
scan answers it correctly; the port serves it. A bucket column missing
from any other bucketed scan stays `unresolved-column`.
"""

from __future__ import annotations

import json

from hyperspace_tpu_torch.exceptions import PlanDiagnostic, PlanRewriteError, PlanValidationError
from hyperspace_tpu_torch.plan.expr import (
    And,
    BinOp,
    Case,
    Col,
    DatePart,
    Expr,
    InList,
    IsNull,
    Like,
    Lit,
    MathFn,
    Not,
    Or,
    Substr,
    expr_dtype,
    split_conjuncts,
)
from hyperspace_tpu_torch.plan.nodes import (
    Aggregate,
    Filter,
    Join,
    Limit,
    LogicalPlan,
    Project,
    Scan,
    Sort,
    Union,
    Window,
)
from hyperspace_tpu_torch.schema import Schema

_STRINGY = ("string",)
_SORTABLE = ("int32", "int64", "float32", "float64", "bool", "string", "date", "timestamp")


# -- public API --------------------------------------------------------------

def validate_plan(plan: LogicalPlan) -> list[PlanDiagnostic]:
    """All diagnostics for `plan`, most severe first."""
    diags: list[PlanDiagnostic] = []
    _walk(plan, type(plan).__name__, diags)
    diags.sort(key=lambda d: (d.severity != "error", d.path))
    return diags


def check_plan(plan: LogicalPlan, fail_on: str = "error") -> None:
    """Raise `PlanValidationError` if `plan` has diagnostics at or above
    `fail_on` severity ("error" | "warning")."""
    diags = validate_plan(plan)
    bad = [d for d in diags if d.severity == "error" or fail_on == "warning"]
    if bad:
        raise PlanValidationError(bad)


def validate_rewrite(original: LogicalPlan, optimized: LogicalPlan) -> None:
    """Guard an optimizer rewrite: `optimized` must validate error-free,
    keep `original`'s output schema, and must not have introduced a
    filter beneath the null-extended side of an outer join. Raises
    `PlanRewriteError` naming the offending node."""
    diags = [d for d in validate_plan(optimized) if d.severity == "error"]
    if diags:
        raise PlanRewriteError(diags)
    try:
        orig_schema, opt_schema = original.schema, optimized.schema
    except Exception as e:  # schema errors already surfaced above for optimized
        raise PlanRewriteError(
            [PlanDiagnostic("rewrite-schema-change", type(optimized).__name__, "",
                            f"cannot resolve rewritten schema: {e}")]
        )
    if not _schemas_equivalent(orig_schema, opt_schema):
        raise PlanRewriteError(
            [PlanDiagnostic(
                "rewrite-schema-change",
                type(optimized).__name__,
                type(optimized).__name__,
                f"rewrite changed the output schema: "
                f"{[(f.name, f.dtype) for f in orig_schema.fields]} -> "
                f"{[(f.name, f.dtype) for f in opt_schema.fields]}",
            )]
        )
    before = _filters_below_null_extended(original)
    pushed = {
        key: (path, pred)
        for key, (path, pred) in _filters_below_null_extended(optimized).items()
        if key not in before
    }
    if pushed:
        raise PlanRewriteError(
            [
                PlanDiagnostic(
                    "illegal-pushdown",
                    "Filter",
                    path,
                    f"predicate {pred} was pushed beneath the null-extended "
                    f"side of an outer join; rows it drops should null-extend "
                    f"instead",
                )
                for path, pred in pushed.values()
            ]
        )


# -- node walk ---------------------------------------------------------------

def _walk(node: LogicalPlan, path: str, diags: list[PlanDiagnostic]) -> None:
    try:
        _check_node(node, path, diags)
    except Exception as e:
        # A node whose schema cannot even be computed (ambiguous join
        # columns, malformed children) is itself the diagnostic.
        diags.append(PlanDiagnostic(
            "schema-error", type(node).__name__, path, str(e)
        ))
    for edge, child in _edges(node):
        _walk(child, f"{path}/{edge}:{type(child).__name__}", diags)


def _edges(node: LogicalPlan):
    if isinstance(node, Join):
        return [("left", node.left), ("right", node.right)]
    if isinstance(node, Union):
        return [(f"inputs[{i}]", c) for i, c in enumerate(node.inputs)]
    return [("child", c) for c in node.children()]


def _check_node(node: LogicalPlan, path: str, diags: list[PlanDiagnostic]) -> None:
    name = type(node).__name__
    if isinstance(node, Scan):
        _check_scan(node, path, diags)
        return
    if isinstance(node, Filter):
        schema = node.child.schema
        dt = _check_expr(node.predicate, schema, name, path, diags)
        if dt is not None and dt != "bool":
            diags.append(PlanDiagnostic(
                "dtype-incompatible-predicate", name, path,
                f"filter predicate has dtype {dt!r}, expected bool",
            ))
        return
    if isinstance(node, Project):
        schema = node.child.schema
        for c in node.columns:
            if isinstance(c, str):
                if c not in schema:
                    diags.append(PlanDiagnostic(
                        "unresolved-column", name, path,
                        f"projected column {c!r} does not exist in the input "
                        f"schema {schema.names}",
                    ))
            else:
                _check_expr(c[1], schema, name, path, diags, what=f"computed column {c[0]!r}")
        return
    if isinstance(node, Join):
        _check_join(node, path, diags)
        return
    if isinstance(node, Aggregate):
        _check_aggregate(node, path, diags)
        return
    if isinstance(node, Window):
        _check_window(node, path, diags)
        return
    if isinstance(node, Sort):
        schema = node.child.schema
        for c, _asc in node.by:
            _check_sort_key(c, schema, name, path, diags)
        return
    if isinstance(node, Union):
        _check_union(node, path, diags)
        return
    if isinstance(node, Limit):
        if node.n < 0:
            diags.append(PlanDiagnostic(
                "bad-limit", name, path, f"limit must be >= 0, got {node.n}"
            ))
        return
    # Unknown node kinds (internal leaves like the executor's _TableLeaf)
    # have nothing structural to check beyond their children.


def _check_scan(node: Scan, path: str, diags: list[PlanDiagnostic]) -> None:
    if node.bucket_spec is None:
        return
    num_buckets, cols = node.bucket_spec
    if num_buckets < 1:
        diags.append(PlanDiagnostic(
            "bad-bucket-spec", "Scan", path,
            f"bucket count must be >= 1, got {num_buckets}",
        ))
    for c in cols:
        if c not in node.scan_schema:
            if node.files is not None:
                # An index scan narrowed by column pruning: the bucket
                # column is not read, and the files stay bucketed on it.
                continue
            diags.append(PlanDiagnostic(
                "unresolved-column", "Scan", path,
                f"bucket column {c!r} does not exist in the scan schema "
                f"{node.scan_schema.names}",
            ))
        elif node.scan_schema.field(c).is_vector:
            diags.append(PlanDiagnostic(
                "bad-bucket-spec", "Scan", path,
                f"bucket column {c!r} has vector dtype; vectors have no "
                f"hash-bucket semantics",
            ))


def _check_join(node: Join, path: str, diags: list[PlanDiagnostic]) -> None:
    ls, rs = node.left.schema, node.right.schema
    ok = True
    for side, keys, schema in (("left", node.left_on, ls), ("right", node.right_on, rs)):
        for k in keys:
            if k not in schema:
                diags.append(PlanDiagnostic(
                    "unresolved-column", "Join", path,
                    f"{side} join key {k!r} does not exist in the {side} "
                    f"schema {schema.names}",
                ))
                ok = False
    if ok:
        for lk, rk in zip(node.left_on, node.right_on):
            lf, rf = ls.field(lk), rs.field(rk)
            if lf.is_vector or rf.is_vector:
                diags.append(PlanDiagnostic(
                    "join-key-type-mismatch", "Join", path,
                    f"join key {lk!r}/{rk!r} has vector dtype; vectors "
                    f"cannot be equi-join keys",
                ))
            elif lf.is_string != rf.is_string:
                diags.append(PlanDiagnostic(
                    "join-key-type-mismatch", "Join", path,
                    f"join keys {lk!r} ({lf.dtype}) and {rk!r} ({rf.dtype}) "
                    f"live in different comparison domains; equal values "
                    f"can never match",
                ))
    if node.condition is not None:
        _check_expr(node.condition, node.match_schema, "Join", path, diags,
                    what="join condition")
    # Null-sentinel consistency: the null-extended side's columns must be
    # null-extendable — vector columns have no null representation on
    # device (execution/exec_common._null_field refuses them at runtime).
    extended = {"left": [("right", rs)], "right": [("left", ls)],
                "full": [("left", ls), ("right", rs)]}.get(node.how, [])
    keysets = {"left": {k.lower() for k in node.left_on},
               "right": {k.lower() for k in node.right_on}}
    for side, schema in extended:
        for f in schema.fields:
            if f.name.lower() in keysets[side]:
                continue  # key columns coalesce across sides, never extended
            if f.is_vector:
                diags.append(PlanDiagnostic(
                    "null-extension-vector", "Join", path,
                    f"{node.how} outer join null-extends {side} column "
                    f"{f.name!r}, but vector columns have no null "
                    f"representation",
                    severity="warning",
                ))
    _check_bucket_alignment(node, path, diags)


def _check_bucket_alignment(node: Join, path: str, diags: list[PlanDiagnostic]) -> None:
    """Both sides bucketed on the join keys is the zero-exchange shape —
    but only when the specs AGREE (same count, same hash dtype domain).
    A disagreement is legal (the executor falls back to a re-shuffle)
    yet almost always a mis-built index pair, so it warns."""
    lscan = _aligned_scan(node.left)
    rscan = _aligned_scan(node.right)
    if lscan is None or rscan is None:
        return
    if not (_keyed_on(lscan, node.left_on) and _keyed_on(rscan, node.right_on)):
        return
    if lscan.bucket_spec[0] != rscan.bucket_spec[0]:
        diags.append(PlanDiagnostic(
            "join-bucket-mismatch", "Join", path,
            f"both sides are index scans bucketed on the join keys but "
            f"with different bucket counts ({lscan.bucket_spec[0]} vs "
            f"{rscan.bucket_spec[0]}); the zero-exchange join path cannot "
            f"apply and the right side will be re-shuffled at query time",
            severity="warning",
        ))
        return
    if _hash_domain(lscan) != _hash_domain(rscan):
        diags.append(PlanDiagnostic(
            "join-bucket-mismatch", "Join", path,
            f"both sides are bucketed on the join keys with equal counts "
            f"but over different hash dtype domains "
            f"({_hash_domain(lscan)} vs {_hash_domain(rscan)}); equal key "
            f"values bucket differently, so the aligned join path cannot "
            f"apply",
            severity="warning",
        ))


def _aligned_scan(plan: LogicalPlan) -> Scan | None:
    """The bucketed Scan beneath a linear Project/Filter chain — the same
    descent the executor's `_aligned_side` performs when deciding the
    zero-exchange path (execution/exec_side.py)."""
    node = plan
    while isinstance(node, (Project, Filter)):
        if isinstance(node, Project) and not node.is_simple:
            return None
        node = node.child
    if isinstance(node, Scan) and node.bucket_spec is not None:
        return node
    return None


def _keyed_on(scan: Scan, join_on: list[str]) -> bool:
    return [c.lower() for c in scan.bucket_spec[1]] == [c.lower() for c in join_on]


def _hash_domain(scan: Scan) -> tuple[str, ...]:
    """The hash dtype domain of a scan's bucket columns (mirrors
    execution/exec_side.JoinSidesMixin._bucket_hash_dtypes: the canonical
    row hash is dtype-sensitive, so equal key VALUES bucket identically
    only when the bucket column dtypes agree)."""
    import numpy as np

    out = []
    for c in scan.bucket_spec[1]:
        f = scan.scan_schema.field(c)
        out.append("string" if f.is_string else str(np.dtype(f.device_dtype)))
    return tuple(out)


def _check_aggregate(node: Aggregate, path: str, diags: list[PlanDiagnostic]) -> None:
    schema = node.child.schema
    for c in node.group_by:
        if c not in schema:
            diags.append(PlanDiagnostic(
                "unresolved-column", "Aggregate", path,
                f"group-by column {c!r} does not exist in the input schema "
                f"{schema.names}",
            ))
        elif schema.field(c).is_vector:
            diags.append(PlanDiagnostic(
                "dtype-incompatible-aggregate", "Aggregate", path,
                f"group-by column {c!r} has vector dtype; vectors have no "
                f"grouping semantics",
            ))
    for a in node.aggs:
        if a.expr is None:
            continue
        dt = _check_expr(a.expr, schema, "Aggregate", path, diags,
                         what=f"aggregate {a.alias!r}")
        if dt in _STRINGY and a.fn in ("sum", "mean"):
            diags.append(PlanDiagnostic(
                "dtype-incompatible-aggregate", "Aggregate", path,
                f"{a.fn}({a.alias}) aggregates a string-typed expression; "
                f"strings cannot be summed or averaged",
            ))


def _check_window(node: Window, path: str, diags: list[PlanDiagnostic]) -> None:
    schema = node.child.schema
    for c in node.partition_by:
        if c not in schema:
            diags.append(PlanDiagnostic(
                "unresolved-column", "Window", path,
                f"partition column {c!r} does not exist in the input schema "
                f"{schema.names}",
            ))
    for c, _asc in node.order_by:
        _check_sort_key(c, schema, "Window", path, diags)
    for f in node.funcs:
        if f.expr is None:
            continue
        dt = _check_expr(f.expr, schema, "Window", path, diags,
                         what=f"window function {f.alias!r}")
        if dt in _STRINGY and f.fn in ("sum", "mean"):
            diags.append(PlanDiagnostic(
                "dtype-incompatible-aggregate", "Window", path,
                f"{f.fn}({f.alias}) aggregates a string-typed expression",
            ))


def _check_sort_key(c: str, schema: Schema, node: str, path: str,
                    diags: list[PlanDiagnostic]) -> None:
    if c not in schema:
        diags.append(PlanDiagnostic(
            "unresolved-column", node, path,
            f"sort key {c!r} does not exist in the input schema {schema.names}",
        ))
        return
    f = schema.field(c)
    if f.dtype not in _SORTABLE:
        diags.append(PlanDiagnostic(
            "unsortable-key", node, path,
            f"sort key {c!r} has dtype {f.dtype!r}, which has no total "
            f"order (sortable: {_SORTABLE})",
        ))


def _check_union(node: Union, path: str, diags: list[PlanDiagnostic]) -> None:
    first = node.inputs[0].schema
    for i, child in enumerate(node.inputs[1:], start=1):
        for lf, rf in zip(first.fields, child.schema.fields):
            if lf.is_string != rf.is_string:
                diags.append(PlanDiagnostic(
                    "union-type-mismatch", "Union", path,
                    f"column {lf.name!r} is {lf.dtype} in inputs[0] but "
                    f"{rf.dtype} in inputs[{i}]; branches cannot concatenate",
                ))


# -- expression checks -------------------------------------------------------

def _check_expr(e: Expr, schema: Schema, node: str, path: str,
                diags: list[PlanDiagnostic], what: str = "expression") -> str | None:
    """Type-check one expression against `schema`. Returns the result
    dtype, or None when resolution failed (diagnostics appended)."""
    missing = sorted(r for r in e.references() if r not in schema)
    if missing:
        for m in missing:
            diags.append(PlanDiagnostic(
                "unresolved-column", node, path,
                f"{what} references column {m!r}, which does not exist in "
                f"the input schema {schema.names}",
            ))
        return None
    vec = sorted(r for r in e.references() if schema.field(r).is_vector)
    if vec:
        diags.append(PlanDiagnostic(
            "dtype-incompatible-predicate", node, path,
            f"{what} references vector column(s) {vec}; vectors cannot "
            f"appear in scalar expressions",
        ))
        return None
    before = len(diags)
    _expr_structure(e, schema, node, path, diags, what)
    if len(diags) > before:
        return None
    try:
        return expr_dtype(e, schema)
    except ValueError as err:
        diags.append(PlanDiagnostic(
            "dtype-incompatible-predicate", node, path, f"{what}: {err}"
        ))
        return None


def _dtype_or_none(e: Expr, schema: Schema) -> str | None:
    try:
        return expr_dtype(e, schema)
    except ValueError:
        return None


def _expr_structure(e: Expr, schema: Schema, node: str, path: str,
                    diags: list[PlanDiagnostic], what: str) -> None:
    """Structural dtype rules `expr_dtype` is too permissive to catch:
    cross-domain comparisons, string arithmetic, LIKE/SUBSTRING over
    non-strings, date-part extraction from non-dates, IN lists whose
    literals live in a different domain than the probe."""
    if isinstance(e, BinOp):
        _expr_structure(e.left, schema, node, path, diags, what)
        _expr_structure(e.right, schema, node, path, diags, what)
        lt, rt = _dtype_or_none(e.left, schema), _dtype_or_none(e.right, schema)
        if lt is None or rt is None:
            return
        if e.op in ("eq", "ne", "lt", "le", "gt", "ge"):
            if (lt in _STRINGY) != (rt in _STRINGY):
                diags.append(PlanDiagnostic(
                    "dtype-incompatible-predicate", node, path,
                    f"{what}: cannot compare {lt} with {rt} — string and "
                    f"numeric values live in different comparison domains",
                ))
        else:  # arithmetic
            if lt in _STRINGY or rt in _STRINGY:
                diags.append(PlanDiagnostic(
                    "dtype-incompatible-predicate", node, path,
                    f"{what}: arithmetic op {e.op!r} is undefined over "
                    f"string operands ({lt} {e.op} {rt})",
                ))
        return
    if isinstance(e, (And, Or)):
        for side in (e.left, e.right):
            _expr_structure(side, schema, node, path, diags, what)
            dt = _dtype_or_none(side, schema)
            if dt is not None and dt != "bool":
                diags.append(PlanDiagnostic(
                    "dtype-incompatible-predicate", node, path,
                    f"{what}: AND/OR operand has dtype {dt!r}, expected bool",
                ))
        return
    if isinstance(e, Not):
        _expr_structure(e.child, schema, node, path, diags, what)
        dt = _dtype_or_none(e.child, schema)
        if dt is not None and dt != "bool":
            diags.append(PlanDiagnostic(
                "dtype-incompatible-predicate", node, path,
                f"{what}: NOT operand has dtype {dt!r}, expected bool",
            ))
        return
    if isinstance(e, Like):
        _expr_structure(e.child, schema, node, path, diags, what)
        dt = _dtype_or_none(e.child, schema)
        if dt is not None and dt not in _STRINGY:
            diags.append(PlanDiagnostic(
                "dtype-incompatible-predicate", node, path,
                f"{what}: LIKE applies to string columns, got {dt!r}",
            ))
        return
    if isinstance(e, Substr):
        _expr_structure(e.child, schema, node, path, diags, what)
        dt = _dtype_or_none(e.child, schema)
        if dt is not None and dt not in _STRINGY:
            diags.append(PlanDiagnostic(
                "dtype-incompatible-predicate", node, path,
                f"{what}: SUBSTRING applies to string columns, got {dt!r}",
            ))
        return
    if isinstance(e, DatePart):
        _expr_structure(e.child, schema, node, path, diags, what)
        dt = _dtype_or_none(e.child, schema)
        if dt is not None and dt != "date":
            diags.append(PlanDiagnostic(
                "dtype-incompatible-predicate", node, path,
                f"{what}: {e.part}() extracts from date columns, got {dt!r}",
            ))
        return
    if isinstance(e, InList):
        _expr_structure(e.child, schema, node, path, diags, what)
        dt = _dtype_or_none(e.child, schema)
        if dt is None:
            return
        str_vals = [v for v in e.values if isinstance(v, str)]
        if dt in _STRINGY and len(str_vals) != len(e.values):
            diags.append(PlanDiagnostic(
                "dtype-incompatible-predicate", node, path,
                f"{what}: IN list over a string column contains non-string "
                f"literals {[v for v in e.values if not isinstance(v, str)]}",
            ))
        elif dt not in _STRINGY and str_vals:
            diags.append(PlanDiagnostic(
                "dtype-incompatible-predicate", node, path,
                f"{what}: IN list over a {dt} column contains string "
                f"literals {str_vals}",
            ))
        return
    if isinstance(e, Case):
        for cond, val in e.branches:
            _expr_structure(cond, schema, node, path, diags, what)
            _expr_structure(val, schema, node, path, diags, what)
            dt = _dtype_or_none(cond, schema)
            if dt is not None and dt != "bool":
                diags.append(PlanDiagnostic(
                    "dtype-incompatible-predicate", node, path,
                    f"{what}: CASE condition has dtype {dt!r}, expected bool",
                ))
        _expr_structure(e.default, schema, node, path, diags, what)
        return
    if isinstance(e, (IsNull, Not, MathFn)):
        _expr_structure(e.child, schema, node, path, diags, what)
        return
    if isinstance(e, (Col, Lit)):
        return
    # Unknown expression kinds: nothing structural to check.


# -- rewrite guard helpers ---------------------------------------------------

def _schemas_equivalent(a: Schema, b: Schema) -> bool:
    if len(a.fields) != len(b.fields):
        return False
    return all(
        fa.name.lower() == fb.name.lower() and fa.dtype == fb.dtype
        for fa, fb in zip(a.fields, b.fields)
    )


def _filters_below_null_extended(plan: LogicalPlan) -> dict[str, tuple[str, str]]:
    """Conjuncts sitting directly beneath a null-extended outer-join side
    (through linear Project/Filter chains), keyed by canonical predicate
    JSON -> (node path, predicate repr). Used to detect rewrites that
    PUSHED a filter where null-extension semantics forbid it: a conjunct
    present in the optimized tree's map but not the original's was moved
    there by the rewrite."""
    acc: dict[str, tuple[str, str]] = {}
    _collect_null_extended(plan, type(plan).__name__, acc)
    return acc


def _collect_null_extended(plan: LogicalPlan, path: str, acc: dict) -> None:
    if isinstance(plan, Join):
        sides = {"left": [("right", plan.right)], "right": [("left", plan.left)],
                 "full": [("left", plan.left), ("right", plan.right)]}.get(plan.how, [])
        for edge, side in sides:
            node, spath = side, f"{path}/{edge}:{type(side).__name__}"
            while isinstance(node, (Project, Filter)):
                if isinstance(node, Filter):
                    for c in split_conjuncts(node.predicate):
                        key = json.dumps(c.to_json(), sort_keys=True)
                        acc[key] = (spath, repr(c))
                node = node.child
                spath = f"{spath}/child:{type(node).__name__}"
    for edge, child in _edges(plan):
        _collect_null_extended(child, f"{path}/{edge}:{type(child).__name__}", acc)

"""Expression IR: a small, JSON-serializable predicate/projection language.

The reference has no expression IR of its own — it pattern-matches Catalyst
expressions (e.g. CNF of EqualTo at index/rules/JoinIndexRule.scala:179-185)
and pays for it with a 495-LoC Kryo serde layer (index/serde/). Here
expressions are plain dataclasses with trivial JSON round-trip.

A copy of the JAX package's `plan/expr.py`, cut to the nodes the port's
slices evaluate: columns, literals, comparisons and arithmetic, AND / OR /
NOT, IN, IS NULL, CASE (`when(...).otherwise(...)`) and SUBSTRING, with
`expr_dtype` typing a computed projection. LIKE, date parts and math
functions are not ported yet. The JSON form is the JAX package's, so a
plan logged by one package reads in the other.

String semantics: device columns hold dictionary codes whose dictionary is
sorted at encode time, so both equality and range comparisons on codes are
order-correct once a string literal is translated to its code (the executor
does the translation; see execution/table.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

_BIN_OPS = {"eq", "ne", "lt", "le", "gt", "ge", "add", "sub", "mul", "div", "mod"}
_CMP_OPS = {"eq", "ne", "lt", "le", "gt", "ge"}


class Expr:
    """Base expression node."""

    # Operator sugar so users can write col("a") == 5, (p1 & p2), etc.
    def __eq__(self, other):  # type: ignore[override]
        return BinOp("eq", self, _wrap(other))

    def __ne__(self, other):  # type: ignore[override]
        return BinOp("ne", self, _wrap(other))

    def __lt__(self, other):
        return BinOp("lt", self, _wrap(other))

    def __le__(self, other):
        return BinOp("le", self, _wrap(other))

    def __gt__(self, other):
        return BinOp("gt", self, _wrap(other))

    def __ge__(self, other):
        return BinOp("ge", self, _wrap(other))

    def __add__(self, other):
        return BinOp("add", self, _wrap(other))

    def __sub__(self, other):
        return BinOp("sub", self, _wrap(other))

    def __mul__(self, other):
        return BinOp("mul", self, _wrap(other))

    def __truediv__(self, other):
        return BinOp("div", self, _wrap(other))

    def __mod__(self, other):
        return BinOp("mod", self, _wrap(other))

    def __and__(self, other):
        return And(self, _wrap(other))

    def __or__(self, other):
        return Or(self, _wrap(other))

    def __invert__(self):
        return Not(self)

    # -- SQL predicate sugar ----------------------------------------------
    def is_null(self) -> "IsNull":
        return IsNull(self)

    def is_not_null(self) -> "Not":
        return Not(IsNull(self))

    def isin(self, values) -> "InList":
        return InList(self, list(values))

    def between(self, lo, hi) -> "And":
        """SQL BETWEEN sugar: inclusive on both ends."""
        return And(BinOp("ge", self, _wrap(lo)), BinOp("le", self, _wrap(hi)))

    def substr(self, start: int, length: int) -> "Substr":
        """SQL SUBSTRING(self, start, length), 1-based."""
        return Substr(self, start, length)

    def __hash__(self):
        return hash(repr(self))

    def to_json(self) -> dict[str, Any]:
        raise NotImplementedError

    def references(self) -> set[str]:
        """Column names this expression reads (lowercased)."""
        raise NotImplementedError


@dataclasses.dataclass(eq=False, repr=True)
class Col(Expr):
    name: str

    def to_json(self):
        return {"type": "col", "name": self.name}

    def references(self):
        return {self.name.lower()}


@dataclasses.dataclass(eq=False, repr=True)
class Lit(Expr):
    value: Any

    def to_json(self):
        return {"type": "lit", "value": self.value}

    def references(self):
        return set()


@dataclasses.dataclass(eq=False, repr=True)
class BinOp(Expr):
    op: str
    left: Expr
    right: Expr

    def __post_init__(self):
        if self.op not in _BIN_OPS:
            raise ValueError(f"unknown op {self.op!r}")

    @property
    def is_comparison(self) -> bool:
        return self.op in _CMP_OPS

    def to_json(self):
        return {"type": "binop", "op": self.op, "left": self.left.to_json(), "right": self.right.to_json()}

    def references(self):
        return self.left.references() | self.right.references()


@dataclasses.dataclass(eq=False, repr=True)
class And(Expr):
    left: Expr
    right: Expr

    def to_json(self):
        return {"type": "and", "left": self.left.to_json(), "right": self.right.to_json()}

    def references(self):
        return self.left.references() | self.right.references()


@dataclasses.dataclass(eq=False, repr=True)
class Or(Expr):
    left: Expr
    right: Expr

    def to_json(self):
        return {"type": "or", "left": self.left.to_json(), "right": self.right.to_json()}

    def references(self):
        return self.left.references() | self.right.references()


@dataclasses.dataclass(eq=False, repr=True)
class Not(Expr):
    child: Expr

    def to_json(self):
        return {"type": "not", "child": self.child.to_json()}

    def references(self):
        return self.child.references()


@dataclasses.dataclass(eq=False, repr=True)
class Case(Expr):
    """SQL CASE WHEN: ordered (condition, value) branches + default.
    Conditions use full predicate semantics (3-valued logic; a null
    condition does not take its branch)."""

    branches: list[tuple[Expr, Expr]]
    default: Expr

    def to_json(self):
        return {
            "type": "case",
            "branches": [[c.to_json(), v.to_json()] for c, v in self.branches],
            "default": self.default.to_json(),
        }

    def references(self):
        out: set[str] = self.default.references()
        for c, v in self.branches:
            out |= c.references() | v.references()
        return out


@dataclasses.dataclass(eq=False, repr=True)
class Substr(Expr):
    """SQL SUBSTRING(col, start, length), 1-based, over a string column."""

    child: Expr
    start: int
    length: int

    def __post_init__(self):
        if self.start < 1:
            raise ValueError("SUBSTRING start is 1-based and must be >= 1")
        if self.length < 0:
            raise ValueError("SUBSTRING length must be >= 0")

    def to_json(self):
        return {"type": "substr", "child": self.child.to_json(), "start": self.start, "length": self.length}

    def references(self):
        return self.child.references()


@dataclasses.dataclass(eq=False, repr=True)
class IsNull(Expr):
    """SQL IS NULL. Never UNKNOWN (the point of the operator); IS NOT
    NULL is Not(IsNull(...)). For a compound child, null iff any input
    column is null (matching the engine's expression null semantics)."""

    child: Expr

    def to_json(self):
        return {"type": "isnull", "child": self.child.to_json()}

    def references(self):
        return self.child.references()


@dataclasses.dataclass(eq=False, repr=True)
class InList(Expr):
    """SQL IN over a literal list. 3-valued: a null probe is UNKNOWN.
    Desugars (at translation time) to an OR of equalities in the physical
    code domain — which also feeds multi-point bucket pruning and
    min/max envelope pruning on indexed columns."""

    child: Expr
    values: list

    def __post_init__(self):
        if not self.values:
            raise ValueError("IN requires a non-empty value list")
        if any(v is None for v in self.values):
            raise ValueError("IN list literals must be non-null")

    def to_json(self):
        return {"type": "in", "child": self.child.to_json(), "values": list(self.values)}

    def references(self):
        return self.child.references()


class CaseBuilder:
    """`when(cond, value).when(...).otherwise(default)` sugar."""

    def __init__(self, branches):
        self._branches = branches

    def when(self, cond: Expr, value) -> "CaseBuilder":
        return CaseBuilder(self._branches + [(cond, _wrap(value))])

    def otherwise(self, default) -> Case:
        return Case(self._branches, _wrap(default))


def when(cond: Expr, value) -> CaseBuilder:
    return CaseBuilder([(cond, _wrap(value))])


def col(name: str) -> Col:
    return Col(name)


def lit(value: Any) -> Lit:
    return Lit(value)


def _wrap(v: Any) -> Expr:
    return v if isinstance(v, Expr) else Lit(v)


def expr_from_json(d: dict[str, Any]) -> Expr:
    t = d["type"]
    if t == "col":
        return Col(d["name"])
    if t == "lit":
        return Lit(d["value"])
    if t == "binop":
        return BinOp(d["op"], expr_from_json(d["left"]), expr_from_json(d["right"]))
    if t == "and":
        return And(expr_from_json(d["left"]), expr_from_json(d["right"]))
    if t == "or":
        return Or(expr_from_json(d["left"]), expr_from_json(d["right"]))
    if t == "not":
        return Not(expr_from_json(d["child"]))
    if t == "case":
        return Case(
            [(expr_from_json(c), expr_from_json(v)) for c, v in d["branches"]],
            expr_from_json(d["default"]),
        )
    if t == "isnull":
        return IsNull(expr_from_json(d["child"]))
    if t == "in":
        return InList(expr_from_json(d["child"]), list(d["values"]))
    if t == "substr":
        return Substr(expr_from_json(d["child"]), int(d["start"]), int(d["length"]))
    raise ValueError(f"unknown expr type {t!r}")


def expr_dtype(e: Expr, schema) -> str:
    """Engine dtype an expression produces when evaluated over `schema`
    (a copy of the JAX package's, over the ported nodes)."""
    if isinstance(e, Col):
        return schema.field(e.name).dtype
    if isinstance(e, Lit):
        if isinstance(e.value, bool):
            return "bool"
        if isinstance(e.value, int):
            return "int64"
        if isinstance(e.value, float):
            return "float64"
        return "string"
    if isinstance(e, BinOp):
        if e.op in _CMP_OPS:
            return "bool"
        lt, rt = expr_dtype(e.left, schema), expr_dtype(e.right, schema)
        if "date" in (lt, rt):
            # Dates are day numbers: date ± days stays a date, date - date
            # is the day count; anything else is undefined.
            if e.op == "sub" and lt == "date" and rt == "date":
                return "int64"
            if e.op in ("add", "sub") and lt == "date" and rt in ("int32", "int64", "bool"):
                return "date"
            if e.op == "add" and rt == "date" and lt in ("int32", "int64", "bool"):
                return "date"
            raise ValueError(f"unsupported date arithmetic {lt} {e.op} {rt}")
        if e.op == "div" or "float64" in (lt, rt) or "float32" in (lt, rt):
            return "float64"
        return "int64"
    if isinstance(e, (And, Or, Not, IsNull, InList)):
        return "bool"
    if isinstance(e, Case):
        vals = [v for _, v in e.branches] + [e.default]
        ts = [expr_dtype(v, schema) for v in vals]
        if all(t == ts[0] for t in ts):
            return ts[0]
        nonlit = [t for v, t in zip(vals, ts) if not isinstance(v, Lit)]
        if nonlit and all(t == "date" for t in nonlit) and all(t in ("int32", "int64", "bool", "date") for t in ts):
            return "date"
        if any(t in ("float64", "float32") for t in ts):
            return "float64"
        if all(t in ("int32", "int64", "bool") for t in ts):
            return "int64"
        raise ValueError(f"CASE branches mix incompatible types {ts}")
    if isinstance(e, Substr):
        return "string"
    raise ValueError(f"cannot type expression {type(e).__name__}")


def split_conjuncts(e: Expr) -> list[Expr]:
    """Flatten a conjunction into its factors (CNF top level).

    Reference analog: splitConjunctivePredicates usage at
    index/rules/JoinIndexRule.scala:179-185."""
    if isinstance(e, And):
        return split_conjuncts(e.left) + split_conjuncts(e.right)
    return [e]


def evaluate(e: Expr, resolve: Callable[[str], Any]) -> Any:
    """Evaluate a comparison / arithmetic / boolean expression given
    `resolve(name) -> tensor`. Literal translation for string columns
    happens in the caller (see execution/table.py); null semantics are
    the caller's (ops/filter.py)."""
    if isinstance(e, Col):
        return resolve(e.name)
    if isinstance(e, Lit):
        return e.value
    if isinstance(e, BinOp):
        a = evaluate(e.left, resolve)
        b = evaluate(e.right, resolve)
        return {
            "eq": lambda: a == b,
            "ne": lambda: a != b,
            "lt": lambda: a < b,
            "le": lambda: a <= b,
            "gt": lambda: a > b,
            "ge": lambda: a >= b,
            "add": lambda: a + b,
            "sub": lambda: a - b,
            "mul": lambda: a * b,
            "div": lambda: a / b,
            "mod": lambda: a % b,
        }[e.op]()
    if isinstance(e, And):
        return evaluate(e.left, resolve) & evaluate(e.right, resolve)
    if isinstance(e, Or):
        return evaluate(e.left, resolve) | evaluate(e.right, resolve)
    if isinstance(e, Not):
        return ~evaluate(e.child, resolve)
    raise ValueError(f"cannot evaluate {e!r}")

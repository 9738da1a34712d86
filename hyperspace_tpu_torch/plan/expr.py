"""Expression IR: a small, JSON-serializable predicate/projection language.

The reference has no expression IR of its own — it pattern-matches Catalyst
expressions (e.g. CNF of EqualTo at index/rules/JoinIndexRule.scala:179-185)
and pays for it with a 495-LoC Kryo serde layer (index/serde/). Here
expressions are plain dataclasses with trivial JSON round-trip.

A copy of the JAX package's `plan/expr.py`, cut to the nodes the port's
slice evaluates: columns, literals, comparisons and arithmetic, AND / OR /
NOT, IN and IS NULL. CASE, LIKE, SUBSTRING, date parts and math functions
are not ported yet. The JSON form is the JAX package's, so a plan logged
by one package reads in the other.

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
    if t == "isnull":
        return IsNull(expr_from_json(d["child"]))
    if t == "in":
        return InList(expr_from_json(d["child"]), list(d["values"]))
    raise ValueError(f"unknown expr type {t!r}")


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

"""Predicate evaluation on the device.

The analog of Spark's WholeStageCodegen'd filter over the index scan: the
predicate tree evaluates as torch ops over the columns on the table's
device, with SQL's three-valued logic carried as a pair of boolean masks
(definitely-true, definitely-false); a comparison with a NULL input is
neither.

A port of the JAX package's `ops/filter.py` (`eval_predicate_mask`,
`apply_filter`, and the Kleene evaluation of `_host_mask`). The card has
native int64 and float64, so the TPU's lowering of 64-bit comparisons
onto pairs of 32-bit words is not needed. String literals translate into
the sorted dictionary's code domain on the host first, as there; a
comparison of two string columns maps both dictionaries into one merged
sorted dictionary first (the JAX package's `_StrColCmp`), since codes of
two dictionaries are not comparable.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.execution.table import ColumnTable
from hyperspace_tpu_torch.plan.expr import And, BinOp, Col, Expr, InList, IsNull, Lit, Not, Or, evaluate

_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq", "ne": "ne"}
_INT64_MIN, _INT64_MAX = np.iinfo(np.int64).min, np.iinfo(np.int64).max


def _or_chain(parts: list[Expr]) -> Expr:
    """BALANCED disjunction (depth log2 n)."""
    if len(parts) == 1:
        return parts[0]
    mid = len(parts) // 2
    return Or(_or_chain(parts[:mid]), _or_chain(parts[mid:]))


def _normalize_int_literal(value, op: str):
    """Reduce a numeric literal compared against an INTEGER column to an
    int literal + op, or a constant bool when the comparison is decided
    (so an int64 column is never compared in a float type).

    Returns ("const", bool) | ("cmp", op, int_value)."""
    if isinstance(value, (bool, np.bool_)):
        value = int(value)
    if isinstance(value, (float, np.floating)):
        f = float(value)
        if math.isnan(f):
            return ("const", op == "ne")
        if f == math.inf:
            return ("const", op in ("lt", "le", "ne"))
        if f == -math.inf:
            return ("const", op in ("gt", "ge", "ne"))
        if f == int(f):
            value = int(f)
        else:
            # x OP non-integral f over integers decides by floor/ceil.
            if op == "eq":
                return ("const", False)
            if op == "ne":
                return ("const", True)
            if op in ("lt", "le"):
                return ("cmp", "le", math.floor(f))
            return ("cmp", "ge", math.ceil(f))  # gt, ge
    v = int(value)
    if v > _INT64_MAX:
        return ("const", op in ("lt", "le", "ne"))
    if v < _INT64_MIN:
        return ("const", op in ("gt", "ge", "ne"))
    return ("cmp", op, v)


class _StrColCmp(Expr):
    """Internal leaf: a comparison of two string columns whose
    dictionaries differ (codes from two dictionaries are not comparable).
    Each side's codes map through `lmap` / `rmap` into one MERGED sorted
    dictionary, where integer order is string order."""

    def __init__(self, op: str, left: Col, right: Col, lmap: np.ndarray, rmap: np.ndarray):
        self.op = op
        self.left = left
        self.right = right
        self.lmap = lmap  # [left dict size] int32 positions in the merged dict
        self.rmap = rmap

    def references(self):
        return self.left.references() | self.right.references()


def _string_col(table: ColumnTable, e: Expr) -> str | None:
    """The field name when `e` is a string column of `table`."""
    if isinstance(e, Col):
        f = table.schema.field(e.name)
        if f.is_string:
            return f.name
    return None


class _Const(Expr):
    """Internal leaf: a comparison decided at translation time."""

    def __init__(self, value: bool, child: Expr):
        self.value = value
        self.child = child  # kept for its null semantics (references)

    def references(self):
        return self.child.references()


def translate_predicate(table: ColumnTable, e: Expr) -> Expr:
    """Rewrite string-column comparisons against literals into the code
    domain of `table`'s dictionaries (order-preserving), desugar IN into
    equalities, and settle numeric literals against integer columns.
    Pure — returns a new tree, never mutates the plan's predicate."""
    if isinstance(e, BinOp) and e.is_comparison:
        l, r = e.left, e.right
        ls, rs = _string_col(table, l), _string_col(table, r)
        if ls is not None and rs is not None:
            # String column vs string column: remap both dictionaries into
            # one merged sorted dictionary first (comparing raw codes of
            # two dictionaries gives wrong rows).
            lvals = np.asarray(table.dictionaries[ls]).astype(str)
            rvals = np.asarray(table.dictionaries[rs]).astype(str)
            merged = np.unique(np.concatenate([lvals, rvals]))
            lmap = np.searchsorted(merged, lvals).astype(np.int32)
            rmap = np.searchsorted(merged, rvals).astype(np.int32)
            return _StrColCmp(e.op, Col(ls), Col(rs), lmap, rmap)
        if (ls is None) != (rs is None) and not isinstance(r if ls is not None else l, Lit):
            raise HyperspaceError("cannot compare a string column with a non-string expression")
        if isinstance(r, Col) and isinstance(l, Lit):
            return translate_predicate(table, BinOp(_FLIP[e.op], r, l))
        if isinstance(l, Col) and isinstance(r, Lit):
            f = table.schema.field(l.name)
            if f.is_string:
                if not isinstance(r.value, str):
                    raise HyperspaceError("cannot compare a string column with a non-string literal")
                return BinOp(e.op, l, Lit(table.translate_literal(l.name, r.value, e.op)))
            if f.device_dtype.kind in "iub":
                norm = _normalize_int_literal(r.value, e.op)
                if norm[0] == "const":
                    return _Const(norm[1], e)
                return BinOp(norm[1], l, Lit(norm[2]))
        return e
    if isinstance(e, InList):
        if not isinstance(e.child, Col):
            raise HyperspaceError("IN applies to a column")
        return _or_chain([translate_predicate(table, BinOp("eq", e.child, Lit(v))) for v in e.values])
    if isinstance(e, And):
        return And(translate_predicate(table, e.left), translate_predicate(table, e.right))
    if isinstance(e, Or):
        return Or(translate_predicate(table, e.left), translate_predicate(table, e.right))
    if isinstance(e, Not):
        return Not(translate_predicate(table, e.child))
    return e


def _mask(table: ColumnTable, predicate: Expr) -> torch.Tensor:
    """Kleene evaluation of a translated predicate; returns the
    definitely-true mask (what a SQL filter keeps)."""
    n_rows = table.num_rows
    device = table.device

    def resolve(name: str) -> torch.Tensor:
        return table.column(name)

    def known_mask(e: Expr) -> torch.Tensor:
        """True where every column input of `e` is non-null."""
        known = torch.ones(n_rows, dtype=torch.bool, device=device)
        for name in e.references():
            valid = table.valid_mask(name)
            if valid is not None:
                known = known & valid
        return known

    def tri(e: Expr) -> tuple[torch.Tensor, torch.Tensor]:
        if isinstance(e, And):
            t1, f1 = tri(e.left)
            t2, f2 = tri(e.right)
            return t1 & t2, f1 | f2
        if isinstance(e, Or):
            t1, f1 = tri(e.left)
            t2, f2 = tri(e.right)
            return t1 | t2, f1 & f2
        if isinstance(e, Not):
            t, f = tri(e.child)
            return f, t
        if isinstance(e, IsNull):
            known = known_mask(e.child)
            return ~known, known  # IS NULL is never UNKNOWN
        if isinstance(e, _StrColCmp):
            lmap = torch.from_numpy(e.lmap).to(device)
            rmap = torch.from_numpy(e.rmap).to(device)
            lv = lmap[resolve(e.left.name).long()]
            rv = rmap[resolve(e.right.name).long()]
            v = {"eq": torch.eq, "ne": torch.ne, "lt": torch.lt, "le": torch.le,
                 "gt": torch.gt, "ge": torch.ge}[e.op](lv, rv)
        elif isinstance(e, _Const):
            v = torch.full((n_rows,), e.value, dtype=torch.bool, device=device)
        else:
            # Leaf comparison: any null input makes it unknown.
            v = torch.as_tensor(evaluate(e, resolve), dtype=torch.bool, device=device)
            v = v.expand(n_rows)
        known = known_mask(e)
        return v & known, ~v & known

    t, _ = tri(predicate)
    return t


def eval_predicate_mask(table: ColumnTable, predicate: Expr) -> torch.Tensor:
    """The predicate's definitely-true mask, as a bool tensor on the
    table's device."""
    return _mask(table, translate_predicate(table, predicate))


def apply_filter(table: ColumnTable, predicate: Expr) -> ColumnTable:
    if table.num_rows == 0:
        return table
    return table.filter_mask(eval_predicate_mask(table, predicate))

"""Predicate evaluation, on the device or on the host.

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
two dictionaries are not comparable. LIKE and SUBSTRING comparisons match
over the dictionary on the host and become code ranges, or a boolean per
code gathered on the device where the matches scatter (`_codes_runs_expr`,
`_DictLut`); a comparison of the year of a date with a literal becomes a
day range (`_translate_date_part_cmp`); month and day parts and
arithmetic probes evaluate as torch ops (plan/expr.py::evaluate). With a
mesh, the row dimension shards over it (`eval_predicate_mask`'s
condition, the JAX package's), each shard masking its rows on its
device: the analog of the reference keeping full scan parallelism
(FilterIndexRule.scala:114-120).

The host venue (`venue="host"`, `_host_mask`) is the JAX package's exact
numpy evaluation with the same Kleene logic, copied: it reads each column
the predicate references as a host array (`device_cache.host_array`: one
download a query of a card tensor, none for a stable one after the first)
and uploads the finished mask to the table's device. The default venue
is the device: the executor resolves `hyperspace.filter.venue` and passes
it to every mask it wants (its filters, join conditions, projections,
CASE inputs and window inputs).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.execution.table import ColumnTable
from hyperspace_tpu_torch.parallel.mesh import concat_shards, mesh_size, row_ranges
from hyperspace_tpu_torch.plan.expr import (
    And, BinOp, Col, DatePart, Expr, InList, IsNull, Like, Lit, Not, Or, Substr, evaluate, evaluate_host,
)

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


# More code runs than this and a match set becomes a lookup table per code.
_MAX_CODE_RUNS = 64


class _DictLut(Expr):
    """Internal leaf: boolean lookup over a string column's dictionary
    codes (lut[code]), for a LIKE / SUBSTRING match set too scattered
    for code ranges."""

    def __init__(self, col: Col, lut: np.ndarray):
        self.col = col
        self.lut = lut  # bool, [dictionary size]

    def references(self):
        return self.col.references()


def _string_valued(table: ColumnTable, e: Expr):
    """(column name, per-code string values) when `e` is a string column
    or SUBSTRING of one; None otherwise."""
    if isinstance(e, Col):
        f = table.schema.field(e.name)
        if f.is_string:
            return f.name, np.asarray(table.dictionaries[f.name], dtype=object)
        return None
    if isinstance(e, Substr) and isinstance(e.child, Col) and table.schema.field(e.child.name).is_string:
        return _substr_values(table, e)
    return None


def _substr_values(table: ColumnTable, sub: Substr) -> tuple[str, np.ndarray]:
    """(column name, per-dictionary-entry substring values)."""
    if not isinstance(sub.child, Col):
        raise HyperspaceError("SUBSTRING applies to a column")
    f = table.schema.field(sub.child.name)
    if not f.is_string:
        raise HyperspaceError(f"SUBSTRING requires a string column, got {sub.child.name!r}")
    lo = sub.start - 1
    d = table.dictionaries[f.name]
    return f.name, np.array([str(s)[lo : lo + sub.length] for s in d], dtype=object)


def _codes_runs_expr(col: Col, codes: np.ndarray, dict_size: int) -> Expr:
    """Matched dictionary codes (sorted) → the equivalent predicate in the
    code domain: an OR of contiguous code ranges (a prefix LIKE over a
    sorted dictionary is one range), or a lookup table when the match set
    is scattered. Either form keeps SQL's nulls (a null row is unknown)."""
    if len(codes) == 0:
        return BinOp("eq", col, Lit(-1))  # -1 is never a code
    codes = np.asarray(codes, dtype=np.int64)
    breaks = np.flatnonzero(np.diff(codes) > 1)
    if len(breaks) + 1 > _MAX_CODE_RUNS:
        lut = np.zeros(dict_size, dtype=bool)
        lut[codes] = True
        return _DictLut(col, lut)
    starts = np.concatenate([[0], breaks + 1])
    ends = np.concatenate([breaks, [len(codes) - 1]])
    parts: list[Expr] = []
    for s, t in zip(starts, ends):
        a, b = int(codes[s]), int(codes[t])
        if a == b:
            parts.append(BinOp("eq", col, Lit(a)))
        else:
            parts.append(And(BinOp("ge", col, Lit(a)), BinOp("le", col, Lit(b))))
    return _or_chain(parts)


def like_regex(pattern: str):
    """Compiled regex for a SQL LIKE pattern (% = any run, _ = one char)."""
    import re

    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("".join(out), re.DOTALL)


def _like_codes(table: ColumnTable, colname: str, pattern: str) -> np.ndarray:
    f = table.schema.field(colname)
    if not f.is_string:
        raise HyperspaceError(f"LIKE requires a string column, got {colname!r}")
    rx = like_regex(pattern)
    d = table.dictionaries[f.name]
    return np.flatnonzero([rx.fullmatch(str(s)) is not None for s in d])


_NP_CMP = {"eq": "__eq__", "ne": "__ne__", "lt": "__lt__", "le": "__le__", "gt": "__gt__", "ge": "__ge__"}


def _days(y: int, m: int, d: int) -> int:
    import datetime

    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


def _translate_date_part_cmp(op: str, dp: DatePart, value) -> Expr | None:
    """year(col) OP literal → the equivalent day-range comparison on the
    raw date column (it feeds range pruning too). Month and day parts are
    not intervals over days: None."""
    if dp.part != "year" or not isinstance(dp.child, Col):
        return None
    if isinstance(value, (bool, np.bool_)) or not isinstance(value, (int, np.integer)):
        return None
    col = dp.child
    y = int(value)
    if y < 1 or y > 9998:  # keep datetime.date in range
        return None
    first, next_first = _days(y, 1, 1), _days(y + 1, 1, 1)
    if op == "eq":
        return And(BinOp("ge", col, Lit(first)), BinOp("lt", col, Lit(next_first)))
    if op == "ne":
        return Or(BinOp("lt", col, Lit(first)), BinOp("ge", col, Lit(next_first)))
    if op == "lt":
        return BinOp("lt", col, Lit(first))
    if op == "le":
        return BinOp("lt", col, Lit(next_first))
    if op == "ge":
        return BinOp("ge", col, Lit(first))
    if op == "gt":
        return BinOp("ge", col, Lit(next_first))
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
        ls, rs = _string_valued(table, l), _string_valued(table, r)
        if ls is not None and rs is not None:
            # String-valued vs string-valued: remap both dictionaries into
            # one merged sorted dictionary first (comparing raw codes of
            # two dictionaries gives wrong rows).
            lvals, rvals = ls[1].astype(str), rs[1].astype(str)
            merged = np.unique(np.concatenate([lvals, rvals]))
            lmap = np.searchsorted(merged, lvals).astype(np.int32)
            rmap = np.searchsorted(merged, rvals).astype(np.int32)
            return _StrColCmp(e.op, Col(ls[0]), Col(rs[0]), lmap, rmap)
        if (ls is None) != (rs is None) and not isinstance(r if ls is not None else l, Lit):
            raise HyperspaceError("cannot compare a string column with a non-string expression")
        if isinstance(r, (Substr, DatePart)) and isinstance(l, Lit):
            return translate_predicate(table, BinOp(_FLIP[e.op], r, l))
        if isinstance(l, Substr) and isinstance(r, Lit):
            name, vals = _substr_values(table, l)
            cmp = getattr(vals.astype(str), _NP_CMP[e.op])
            return _codes_runs_expr(Col(name), np.flatnonzero(cmp(str(r.value))), len(vals))
        if isinstance(l, DatePart) and isinstance(r, Lit):
            t = _translate_date_part_cmp(e.op, l, r.value)
            return e if t is None else translate_predicate(table, t)
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
        if isinstance(e.child, Substr):
            name, vals = _substr_values(table, e.child)
            want = {str(v) for v in e.values}
            return _codes_runs_expr(Col(name), np.flatnonzero([v in want for v in vals]), len(vals))
        if not isinstance(e.child, Col):
            return e  # date-part and arithmetic probes evaluate as they are
        return _or_chain([translate_predicate(table, BinOp("eq", e.child, Lit(v))) for v in e.values])
    if isinstance(e, Like):
        if not isinstance(e.child, Col):
            raise HyperspaceError("LIKE applies to a column")
        f = table.schema.field(e.child.name)
        return _codes_runs_expr(Col(f.name), _like_codes(table, f.name, e.pattern), len(table.dictionaries[f.name]))
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
        elif isinstance(e, _DictLut):
            v = torch.from_numpy(e.lut).to(device)[resolve(e.col.name).long()]
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


def _host_mask(table: ColumnTable, predicate: Expr) -> np.ndarray:
    """The host venue: numpy with full 64-bit semantics and Kleene logic
    over the columns' host copies (the JAX package's `_host_mask`).
    Returns the definitely-true mask (what a SQL filter keeps) as a host
    bool array."""
    from hyperspace_tpu_torch.execution.device_cache import host_array

    def resolve(name: str) -> np.ndarray:
        return host_array(table.column(name))

    n_rows = table.num_rows

    def known_mask(e: Expr) -> np.ndarray:
        """True where every column input of `e` is non-null."""
        known = np.ones(n_rows, dtype=bool)
        for name in e.references():
            valid = table.valid_mask(name)
            if valid is not None:
                known = known & host_array(valid)
        return known

    def tri(e: Expr):
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
        if isinstance(e, _DictLut):
            v = e.lut[resolve(e.col.name)]
        elif isinstance(e, _StrColCmp):
            fn = {"eq": np.equal, "ne": np.not_equal, "lt": np.less,
                  "le": np.less_equal, "gt": np.greater, "ge": np.greater_equal}[e.op]
            v = fn(e.lmap[resolve(e.left.name)], e.rmap[resolve(e.right.name)])
        elif isinstance(e, _Const):
            v = np.full(n_rows, e.value, dtype=bool)
        else:
            # Leaf comparison / expression: any null input makes it unknown.
            with np.errstate(all="ignore"):
                v = np.broadcast_to(np.asarray(evaluate_host(e, resolve), dtype=bool), (n_rows,))
        known = known_mask(e)
        return v & known, ~v & known

    t, _ = tri(predicate)
    return t


def _pow2(n: int) -> int:
    return 1 << max(1, (n - 1)).bit_length() if n > 1 else 1


def _shard_table(table: ColumnTable, names: list, mesh, i: int, lo: int, hi: int) -> ColumnTable:
    """Rows [lo, hi) of `table`'s columns `names` on shard i of `mesh`."""
    from hyperspace_tpu_torch.execution.device_cache import shard_cached

    sub = table.select(names)
    return ColumnTable(
        sub.schema,
        {k: shard_cached(v, mesh, i, lo, hi) for k, v in sub.columns.items()},
        sub.dictionaries,
        {k: shard_cached(v, mesh, i, lo, hi) for k, v in sub.validity.items()},
        mesh.devices[i],
    )


def eval_predicate_mask(table: ColumnTable, predicate: Expr, mesh=None, venue: str = "device") -> torch.Tensor:
    """The predicate's definitely-true mask, as a bool tensor on the
    table's device. `venue` "host" evaluates it with numpy on the host
    (`_host_mask`). On the device, with a mesh of D > 1
    shards whose size divides the row count padded to a power of two (the
    JAX package's condition), the rows shard over it: shard i masks its
    contiguous n_pad / D rows on its device (no collective) and the masks
    concatenate in shard order."""
    predicate = translate_predicate(table, predicate)
    if venue == "host":
        return torch.from_numpy(_host_mask(table, predicate)).to(table.device)
    n = table.num_rows
    names = sorted({r.lower() for r in predicate.references()})
    if mesh is not None and names:
        d = mesh_size(mesh)
        n_pad = _pow2(n)
        if d > 1 and n_pad % d == 0:
            parts = [_mask(_shard_table(table, names, mesh, i, lo, hi), predicate)
                     for i, (lo, hi) in enumerate(row_ranges(n, n_pad // d, d)) if hi > lo]
            return concat_shards(parts, table.device)
    return _mask(table, predicate)


def apply_filter(table: ColumnTable, predicate: Expr, mesh=None, venue: str = "device") -> ColumnTable:
    if table.num_rows == 0:
        return table
    return table.filter_mask(eval_predicate_mask(table, predicate, mesh=mesh, venue=venue))

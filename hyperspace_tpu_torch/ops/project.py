"""Computed projection: evaluate named select-list expressions.

A port of the JAX package's `ops/project.py` (`compute_column`,
`project_table`). The IR carries (alias, Expr) entries and this op
materializes them over a ColumnTable on its device. Numeric expressions
evaluate as torch ops with 3-valued nulls (an input's null makes the
result null; CASE validity follows the branch taken) in the dtypes of
the JAX package's host evaluation: numpy's promotion with each literal a
0-d int64, float64 or bool array (so a float32 column times 0.1 is
float64), int / int in float64. Torch's own promotion differs (an int64
column times 2.5 would be float32), so every operand is cast to that
dtype first. Date parts and the math functions evaluate as torch ops
(plan/expr.py::eval_date_part). Boolean expressions, LIKE among them,
ride the filter's mask machinery, on the mask venue the caller passes
(`venue`: the executor's `hyperspace.filter.venue`, else the device);
SUBSTRING and the string CASE map the
(small, sorted) dictionary on the host and remap the codes on the device,
so the order-preserving codes invariant holds downstream. The aggregate
inputs over expressions (ops/aggregate.py::agg_input) are these same
numeric evaluations.
"""

from __future__ import annotations

import numpy as np
import torch

from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.execution.table import ColumnTable, to_tensor
from hyperspace_tpu_torch.plan.expr import (
    And, BinOp, Case, Col, DatePart, Expr, InList, IsNull, Like, Lit, MathFn, Not, Or, Substr, eval_date_part,
)
from hyperspace_tpu_torch.schema import Field


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dt)).dtype


def _np_dtype(dt: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dt).numpy().dtype


def _binop(op: str, a, b):
    """a OP b for tensors or Python literals, in numpy's result type of
    the tensors' dtypes and the literals as 0-d arrays."""
    dt = np.result_type(*(_np_dtype(x.dtype) if isinstance(x, torch.Tensor) else np.asarray(x).dtype for x in (a, b)))
    if op == "div" and dt.kind in "biu":
        dt = np.dtype(np.float64)
    tdt = _torch_dtype(dt)
    device = next((x.device for x in (a, b) if isinstance(x, torch.Tensor)), None)
    if device is None:  # two literals
        a, b = (np.asarray(x, dtype=dt) for x in (a, b))
    else:
        # A literal becomes a 0-d tensor of the result dtype.
        a, b = (x.to(tdt) if isinstance(x, torch.Tensor) else torch.tensor(x, dtype=tdt, device=device)
                for x in (a, b))
    return {
        "eq": lambda: a == b, "ne": lambda: a != b, "lt": lambda: a < b, "le": lambda: a <= b,
        "gt": lambda: a > b, "ge": lambda: a >= b, "add": lambda: a + b, "sub": lambda: a - b,
        "mul": lambda: a * b, "div": lambda: a / b, "mod": lambda: a % b,
    }[op]()


def _full(vals, n: int, device) -> torch.Tensor:
    if isinstance(vals, torch.Tensor):
        return vals if vals.dim() == 1 else vals.expand(n)
    if isinstance(vals, np.ndarray):  # a result of two literals
        return torch.full((n,), vals.item(), dtype=_torch_dtype(vals.dtype), device=device)
    # A Python literal keeps numpy's dtype for it (0.1 stays float64).
    return torch.full((n,), vals, dtype=_torch_dtype(np.asarray(vals).dtype), device=device)


def _and_valid(av, bv):
    if av is None:
        return bv
    if bv is None:
        return av
    return av & bv


def _expr_input(table: ColumnTable, e: Expr, venue: str = "device"):
    """(values, validity or None) of a numeric expression: values a
    tensor, or a Python literal until the caller broadcasts."""
    if isinstance(e, Case):
        return _case_input(table, e, venue)
    if isinstance(e, Col):
        f = table.schema.field(e.name)
        if f.is_string:
            raise HyperspaceError(f"numeric expression over string column {f.name!r}")
        return table.columns[f.name], table.valid_mask(e.name)
    if isinstance(e, Lit):
        return e.value, None
    if isinstance(e, BinOp):
        a, av = _expr_input(table, e.left, venue)
        b, bv = _expr_input(table, e.right, venue)
        return _binop(e.op, a, b), _and_valid(av, bv)
    if isinstance(e, DatePart):
        vals, valid = _expr_input(table, e.child, venue)
        return eval_date_part(e.part, _full(vals, table.num_rows, table.device)), valid
    if isinstance(e, MathFn):
        vals, valid = _expr_input(table, e.child, venue)
        v = _full(vals, table.num_rows, table.device)
        if e.fn == "sqrt":
            return torch.sqrt(v if v.is_floating_point() else v.to(torch.float64)), valid
        if e.fn == "abs":
            return torch.abs(v), valid
        return (torch.floor(v) if v.is_floating_point() else v).to(torch.int64), valid
    raise HyperspaceError(f"cannot evaluate expression {type(e).__name__} as a number")


def _case_input(table: ColumnTable, e: Case, venue: str = "device"):
    """CASE WHEN over numbers: conditions with full predicate semantics (a
    null condition does not take its branch), values in float64, validity
    following the branch taken."""
    from hyperspace_tpu_torch.ops.filter import eval_predicate_mask

    n, dev = table.num_rows, table.device
    out, valid = _expr_input(table, e.default, venue)
    out = _full(out, n, dev).to(torch.float64)
    for cond, val in reversed(e.branches):
        m = eval_predicate_mask(table, cond, venue=venue)
        v, vvalid = _expr_input(table, val, venue)
        out = torch.where(m, _full(v, n, dev).to(torch.float64), out)
        if valid is not None or vvalid is not None:
            va = torch.ones(n, dtype=torch.bool, device=dev) if valid is None else valid
            vb = torch.ones(n, dtype=torch.bool, device=dev) if vvalid is None else vvalid
            valid = torch.where(m, vb, va)
    return out, valid


def _bool_column(table: ColumnTable, e: Expr, venue: str = "device"):
    """SQL boolean value of a predicate: True / False / NULL (unknown):
    the true-mask and, where neither it nor the false-mask holds, NULL."""
    from hyperspace_tpu_torch.ops.filter import eval_predicate_mask

    tmask = eval_predicate_mask(table, e, venue=venue)
    fmask = eval_predicate_mask(table, Not(e), venue=venue)
    known = tmask | fmask
    return tmask, None if bool(known.all()) else known


def _substr_column(table: ColumnTable, e: Substr):
    """(codes, sorted dictionary, validity) for SUBSTRING(col, s, l): the
    dictionary is cut and re-sorted on the host, the codes remapped with
    one gather on the device."""
    if not isinstance(e.child, Col):
        raise HyperspaceError("SUBSTRING projection requires a string column input")
    f = table.schema.field(e.child.name)
    if not f.is_string:
        raise HyperspaceError(f"SUBSTRING over non-string column {f.name!r}")
    d = table.dictionaries[f.name]
    lo = e.start - 1
    sub = np.array([s[lo : lo + e.length] for s in d], dtype=object)
    new_dict, inverse = np.unique(sub.astype(str), return_inverse=True)
    remap = to_tensor(inverse.reshape(-1).astype(np.int32), table.device)
    codes = remap[table.columns[f.name].long()] if len(d) else table.columns[f.name]
    return codes, new_dict.astype(object), table.valid_mask(f.name)


def _string_case_column(table: ColumnTable, e: Expr, venue: str = "device"):
    """String-valued CASE whose branch values are one string column or
    string literals: the dictionary extends with the literals (re-sorted
    to keep the order-preserving codes) and branches select in code
    space."""
    from hyperspace_tpu_torch.ops.filter import eval_predicate_mask

    if not isinstance(e, Case):
        raise HyperspaceError(f"cannot project string-typed expression {type(e).__name__}")
    src: str | None = None
    lits: set[str] = set()
    for v in [*(v for _, v in e.branches), e.default]:
        if isinstance(v, Col):
            f = table.schema.field(v.name)
            if not f.is_string:
                raise HyperspaceError("string CASE branches must be string-typed")
            if src is not None and f.name != src:
                raise HyperspaceError("string CASE supports one source column (plus literals)")
            src = f.name
        elif isinstance(v, Lit) and isinstance(v.value, str):
            lits.add(v.value)
        else:
            raise HyperspaceError("string CASE branches must be a string column or string literals")
    base = table.dictionaries[src] if src is not None else np.zeros(0, dtype=object)
    merged = np.unique(np.concatenate([base.astype(str), np.array(sorted(lits), dtype=str)]))
    old_to_new = to_tensor(np.searchsorted(merged, base.astype(str)).astype(np.int32), table.device)
    lit_code = {s: int(np.searchsorted(merged, s)) for s in lits}
    n, dev = table.num_rows, table.device

    def branch_codes(v) -> torch.Tensor:
        if isinstance(v, Col):
            return old_to_new[table.columns[src].long()]
        return torch.full((n,), lit_code[v.value], dtype=torch.int32, device=dev)

    def branch_valid(v):
        return table.validity.get(src) if isinstance(v, Col) else None

    codes = branch_codes(e.default)
    valid = branch_valid(e.default)
    for cond, v in reversed(e.branches):
        m = eval_predicate_mask(table, cond, venue=venue)
        codes = torch.where(m, branch_codes(v), codes)
        bv = branch_valid(v)
        if valid is not None or bv is not None:
            va = torch.ones(n, dtype=torch.bool, device=dev) if valid is None else valid
            vb = torch.ones(n, dtype=torch.bool, device=dev) if bv is None else bv
            valid = torch.where(m, vb, va)
    return codes.to(torch.int32), merged.astype(object), valid


def compute_column(table: ColumnTable, e: Expr, dtype: str, venue: str = "device"):
    """Evaluate one computed projection entry on the table's device, its
    predicate masks on `venue`. Returns (values, dictionary or None, validity or None); values are
    physical (codes when a dictionary is returned)."""
    if isinstance(e, Col):
        # Column rename (SELECT c AS x): codes, dictionary and validity.
        f = table.schema.field(e.name)
        return table.columns[f.name], table.dictionaries.get(f.name), table.validity.get(f.name)
    if isinstance(e, Substr):
        return _substr_column(table, e)
    if dtype == "bool" and isinstance(e, (And, Or, Not, IsNull, InList, Like)) or (isinstance(e, BinOp) and e.is_comparison):
        vals, valid = _bool_column(table, e, venue)
        return vals, None, valid
    if dtype == "string":
        if isinstance(e, Lit) and isinstance(e.value, str):
            # A constant string column: a one-entry dictionary, codes 0.
            return (torch.zeros(table.num_rows, dtype=torch.int32, device=table.device),
                    np.array([e.value], dtype=object), None)
        return _string_case_column(table, e, venue)
    vals, valid = _expr_input(table, e, venue)
    phys = _torch_dtype(Field("_", dtype).device_dtype)
    return _full(vals, table.num_rows, table.device).to(phys), None, valid


def project_table(table: ColumnTable, columns: list, out_schema, venue: str = "device") -> ColumnTable:
    """Execute a Project with computed entries over a table; the result
    lies on the table's device, its predicate masks on `venue`."""
    cols: dict[str, torch.Tensor] = {}
    dicts: dict[str, np.ndarray] = {}
    validity: dict[str, torch.Tensor] = {}
    for entry, field in zip(columns, out_schema.fields):
        if isinstance(entry, str):
            f = table.schema.field(entry)
            cols[field.name] = table.columns[f.name]
            if f.name in table.dictionaries:
                dicts[field.name] = table.dictionaries[f.name]
            if f.name in table.validity:
                validity[field.name] = table.validity[f.name]
            continue
        vals, d, valid = compute_column(table, entry[1], field.dtype, venue)
        cols[field.name] = vals
        if d is not None:
            dicts[field.name] = d
        if valid is not None and not bool(valid.all()):
            validity[field.name] = valid
    return ColumnTable(out_schema, cols, dicts, validity, table.device)

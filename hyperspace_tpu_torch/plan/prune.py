"""Projection pushdown: read only the columns a query needs.

The analog of Spark's ColumnPruning + Parquet column projection. Without
it every scan decodes the full table width — on real TPC-H schemas that
means dictionary-encoding 6M comment strings to answer a 3-column query.
The pass rewrites each Scan's `scan_schema` to the subset of columns
required by its ancestors; the executor then feeds the pruned schema
straight into the parquet column projection.

A copy of the JAX package's pass: a Join narrows each side to its own
needed columns plus its join keys; a Window keeps its partition and order
columns and a Sort its keys, whatever the ancestors need.
"""

from __future__ import annotations

import dataclasses

from hyperspace_tpu_torch.plan.nodes import Aggregate, Filter, Join, Limit, LogicalPlan, Project, Scan, Sort, Union, Window


def _one_cheap_column(schema) -> set[str]:
    """A zero-column scan would report num_rows == 0; a pure count(*)
    needs the row count, so keep one (non-string) column."""
    names = schema.names
    if not names:
        return set()
    return {next((c for c in names if not schema.field(c).is_string), names[0]).lower()}


def prune_columns(plan: LogicalPlan, needed: set[str] | None = None) -> LogicalPlan:
    """Rewrite `plan` so every Scan reads only columns in `needed`
    (lowercase names; None = all columns are required)."""
    if isinstance(plan, Scan):
        if needed is None:
            return plan
        cols = [c for c in plan.scan_schema.names if c.lower() in needed]
        if not cols:
            cols = [c for c in plan.scan_schema.names if c.lower() in _one_cheap_column(plan.scan_schema)]
        if len(cols) == len(plan.scan_schema.names):
            return plan
        return dataclasses.replace(plan, scan_schema=plan.scan_schema.select(cols))
    if isinstance(plan, Project):
        # Inner projections narrow to what ancestors need (the top-level
        # call has needed=None, so the user-visible schema never changes).
        # A kept computed entry needs every column its expression reads.
        if needed is None:
            keep = list(plan.columns)
        else:
            keep = [c for c in plan.columns if (c if isinstance(c, str) else c[0]).lower() in needed]
        child_needed: set[str] = set()
        for c in keep:
            child_needed |= {c.lower()} if isinstance(c, str) else c[1].references()
        return Project(prune_columns(plan.child, child_needed), keep)
    if isinstance(plan, Filter):
        if needed is None:
            child_needed = None
        else:
            child_needed = set(needed) | {c.lower() for c in plan.predicate.references()}
        return Filter(prune_columns(plan.child, child_needed), plan.predicate)
    if isinstance(plan, Join):
        if needed is None:
            lneed = rneed = None
        else:
            cond_refs = (
                {c.lower() for c in plan.condition.references()} if plan.condition is not None else set()
            )
            lneed = {c.lower() for c in plan.left.schema.names if c.lower() in needed | cond_refs}
            lneed |= {c.lower() for c in plan.left_on}
            rneed = {c.lower() for c in plan.right.schema.names if c.lower() in needed | cond_refs}
            rneed |= {c.lower() for c in plan.right_on}
        return dataclasses.replace(
            plan, left=prune_columns(plan.left, lneed), right=prune_columns(plan.right, rneed)
        )
    if isinstance(plan, Aggregate):
        child_needed = {c.lower() for c in plan.group_by}
        for a in plan.aggs:
            child_needed |= {c.lower() for c in a.references()}
        if not child_needed:
            child_needed = _one_cheap_column(plan.child.schema)
        return dataclasses.replace(plan, child=prune_columns(plan.child, child_needed))
    if isinstance(plan, Union):
        return Union([prune_columns(c, needed) for c in plan.inputs])
    if isinstance(plan, Window):
        aliases = {f.alias.lower() for f in plan.funcs}
        if needed is None:
            child_needed = None
        else:
            child_needed = {c for c in needed if c not in aliases}
            child_needed |= {c.lower() for c in plan.partition_by}
            child_needed |= {c.lower() for c, _ in plan.order_by}
            for f in plan.funcs:
                child_needed |= f.references()
            if not child_needed:
                # count(*)-style window over no keys: keep one cheap
                # column so the child's row count survives pruning.
                child_needed = _one_cheap_column(plan.child.schema)
        return dataclasses.replace(plan, child=prune_columns(plan.child, child_needed))
    if isinstance(plan, Sort):
        child_needed = None if needed is None else set(needed) | {c.lower() for c, _ in plan.by}
        return dataclasses.replace(plan, child=prune_columns(plan.child, child_needed))
    if isinstance(plan, Limit):
        return dataclasses.replace(plan, child=prune_columns(plan.child, needed))
    return plan

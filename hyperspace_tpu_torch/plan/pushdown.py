"""Predicate pushdown: move filters below inner joins.

A copy of the JAX package's `plan/pushdown.py`, the analog of Spark's
PushDownPredicate, which runs before the rewrite rules (the Hyperspace
rules see plans Catalyst has already normalized). Side-local conjuncts of
a filter above an inner equi-join filter that side BEFORE the join: the
index rules then cover them, and the bucket-aligned path applies them per
bucket and merges the (much smaller) surviving rows; conjuncts touching
both sides stay above as a residual filter. Semantics-preserving for
inner joins.
"""

from __future__ import annotations

import dataclasses
import functools

from hyperspace_tpu_torch.plan.expr import And, Expr, split_conjuncts
from hyperspace_tpu_torch.plan.nodes import Filter, Join, LogicalPlan, Union


def _conjoin(conjuncts: list[Expr]) -> Expr:
    return functools.reduce(And, conjuncts)


def push_down_filters(plan: LogicalPlan) -> LogicalPlan:
    """Rewrite Filter(Join) shapes so side-local conjuncts run on their
    side; applied recursively over the whole plan."""
    if isinstance(plan, Filter):
        child = push_down_filters(plan.child)
        if isinstance(child, Join):
            # Which sides accept a pushed filter without changing the join
            # semantics: the null-EXTENDED side of an outer join cannot (a
            # pushed filter would drop rows before null extension instead
            # of nulling their columns after); semi/anti output left rows
            # verbatim, so left pushes are safe there too.
            push_left = child.how in ("inner", "left", "semi", "anti")
            push_right = child.how in ("inner", "right")
            lnames = {n.lower() for n in child.left.schema.names}
            rnames = {n.lower() for n in child.right.schema.names}
            left_c: list[Expr] = []
            right_c: list[Expr] = []
            residual: list[Expr] = []
            for conj in split_conjuncts(plan.predicate):
                refs = {r.lower() for r in conj.references()}
                if push_left and refs and refs <= lnames:
                    left_c.append(conj)
                elif push_right and refs and refs <= rnames:
                    right_c.append(conj)
                else:
                    residual.append(conj)
            if left_c or right_c:
                new_left = push_down_filters(Filter(child.left, _conjoin(left_c))) if left_c else child.left
                new_right = push_down_filters(Filter(child.right, _conjoin(right_c))) if right_c else child.right
                out: LogicalPlan = Join(
                    new_left, new_right, child.left_on, child.right_on, child.how,
                    condition=child.condition, null_safe=child.null_safe,
                )
                return Filter(out, _conjoin(residual)) if residual else out
        return Filter(child, plan.predicate)
    kids = plan.children()
    if not kids:
        return plan
    if isinstance(plan, Union):
        return Union([push_down_filters(c) for c in plan.inputs])
    if isinstance(plan, Join):
        return dataclasses.replace(plan, left=push_down_filters(plan.left), right=push_down_filters(plan.right))
    return dataclasses.replace(plan, child=push_down_filters(plan.child))

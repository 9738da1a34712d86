"""Static analysis of plans: the pre-execution plan validator.

A port of the JAX package's `analysis/` for its `validator` only
(`validate_plan`, `check_plan`, `validate_rewrite`): it walks the
logical plan before the executor touches a device, checking schema and
dtype resolution of every expression, join bucket-spec compatibility,
sort-key legality and rewrite (pushdown / prune) equivalence, and
raises `PlanValidationError` with structured `PlanDiagnostic`s naming
the offending node. The JAX package's lint and whole-program rules are
not ported.
"""

from hyperspace_tpu_torch.analysis.validator import (
    check_plan,
    validate_plan,
    validate_rewrite,
)

__all__ = ["check_plan", "validate_plan", "validate_rewrite"]

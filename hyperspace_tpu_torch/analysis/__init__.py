"""Static analysis of the port: plan validation, per-file lint and the
whole-program engine.

Three layers, as in the JAX package's `analysis/`:

- `validator` — walks the logical plan before the executor touches a
  device, checking schema and dtype resolution of every expression, join
  bucket-spec compatibility, sort-key legality and rewrite (pushdown /
  prune) equivalence, and raises `PlanValidationError` with structured
  `PlanDiagnostic`s naming the offending node.
- `lint` — the per-file AST rules (HSL001-HSL008): no import of jax,
  jaxlib or the JAX package and no private torch API outside
  `ops/kernels.py`, no host sync or tensor truth value in a kernel
  wrapper's launch body, hashable launch-plan memo keys, seeded
  randomness, metadata writes through `file_utils`, monotonic durations
  and declared counters, locked module-global mutation. Run as
  `python -m hyperspace_tpu_torch.analysis.lint <paths>`.
- the **whole-program engine** — `program` (module/symbol index and
  single-pass function summaries), `callgraph`, `locks`, `effects`,
  `races`, `raises`, and the domain layers `procdomain` (which code runs
  in which process: HSL019-022), `tracedomain` (which code runs on a
  kernel's launch path, and the launch contract of every kernel:
  HSL023-026) and `duradomain` (crash consistency: HSL027-030). The
  unified check — lint, whole-program rules, validator corpus, findings
  baseline — is `python -m hyperspace_tpu_torch.analysis.check`
  (docs/torch/static_analysis.md).

The engine is stdlib-`ast` only: it never imports the code it analyses,
and it imports neither jax nor the JAX package.
"""

from hyperspace_tpu_torch.analysis.validator import (
    check_plan,
    validate_plan,
    validate_rewrite,
)

__all__ = [
    "check_plan",
    "validate_plan",
    "validate_rewrite",
    "CallGraph",
    "Effects",
    "LockGraph",
    "Program",
    "Raises",
]


def __getattr__(name):
    # Lazy: the engine is only needed by the check and tests.
    if name == "Program":
        from hyperspace_tpu_torch.analysis.program import Program

        return Program
    if name == "CallGraph":
        from hyperspace_tpu_torch.analysis.callgraph import CallGraph

        return CallGraph
    if name == "LockGraph":
        from hyperspace_tpu_torch.analysis.locks import LockGraph

        return LockGraph
    if name == "Effects":
        from hyperspace_tpu_torch.analysis.effects import Effects

        return Effects
    if name == "Raises":
        from hyperspace_tpu_torch.analysis.raises import Raises

        return Raises
    raise AttributeError(name)

"""Device operators of the port. The hand-written CUDA kernels are listed
in `ops/kernels.py::SOURCES`; each replaces a Pallas TPU kernel of the JAX
package (`hyperspace_tpu/ops/__init__.py::KNOWN_KERNELS`)."""

# The declared kernel registry: every hand-written CUDA kernel's wrapper,
# by its package-relative name. Rule HSL026 (analysis/tracedomain.py)
# holds it both ways against the wrappers that count launches, their
# `kernels.load(...)` engagements and `kernels.SOURCES`; chip_smoke.py
# holds it against the card's launch counts.
KNOWN_KERNELS = (
    "ops.segment_reduce.segment_reduce",
    "ops.sortkeys.run_bounds",
    "ops.topk.topk",
)

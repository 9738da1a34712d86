"""Device operators of the port. The hand-written CUDA kernels are listed
in `ops/kernels.py::SOURCES`; each replaces a Pallas TPU kernel of the JAX
package (`hyperspace_tpu/ops/__init__.py::KNOWN_KERNELS`)."""

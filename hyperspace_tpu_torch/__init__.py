"""hyperspace-tpu on PyTorch and CUDA: covering indexes and index-rewritten
queries on an NVIDIA card.

The port of the JAX package `hyperspace_tpu` (which stays the reference):
the same covering-index layout on disk (op log, bucket files, manifest),
the same rewrite rules, and a query executor whose operators run on the
session's device — the CUDA card unless the caller asks for the CPU. The
segment reduce behind every grouped aggregate is a hand-written CUDA
kernel (ops/segment_reduce.py). Importing the package loads neither JAX
nor the JAX package.
"""

from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.index.index_config import IndexConfig
from hyperspace_tpu_torch.plan.expr import col, lit
from hyperspace_tpu_torch.plan.nodes import AggSpec
from hyperspace_tpu_torch.schema import Field, Schema

__version__ = "0.1.0"

__all__ = [
    "AggSpec",
    "Field",
    "Hyperspace",
    "HyperspaceError",
    "HyperspaceSession",
    "IndexConfig",
    "Schema",
    "col",
    "lit",
]


def __getattr__(name):
    if name in ("Hyperspace", "HyperspaceSession"):
        from hyperspace_tpu_torch import hyperspace as _h

        return getattr(_h, name)
    raise AttributeError(name)

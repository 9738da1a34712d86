"""hyperspace-tpu on PyTorch and CUDA: covering indexes and index-rewritten
queries on an NVIDIA card.

The port of the JAX package `hyperspace_tpu` (which stays the reference):
the same covering-index layout on disk (op log, bucket files, manifest),
the same rewrite rules, and a query executor whose operators run on the
session's device — the CUDA card unless the caller asks for the CPU. The
segment reduce behind every grouped aggregate (ops/segment_reduce.py) and
the run bounds behind every join (ops/sortkeys.py::run_bounds) and the
top-k behind every vector search (ops/topk.py) are hand-written CUDA
kernels. Importing the package loads neither JAX nor
the JAX package.
"""

from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.index.index_config import IndexConfig
from hyperspace_tpu_torch.plan.expr import abs_, col, date_lit, day, floor, lit, month, sqrt, when, year
from hyperspace_tpu_torch.plan.nodes import AggSpec, Join, WindowSpec
from hyperspace_tpu_torch.schema import Field, Schema

__version__ = "0.1.0"

__all__ = [
    "AggSpec",
    "Field",
    "Hyperspace",
    "HyperspaceError",
    "HyperspaceSession",
    "IndexConfig",
    "Join",
    "PlanCache",
    "QueryOutcome",
    "Schema",
    "VectorIndexConfig",
    "WindowSpec",
    "abs_",
    "col",
    "date_lit",
    "day",
    "floor",
    "lit",
    "month",
    "sqrt",
    "when",
    "year",
]


def __getattr__(name):
    if name in ("Hyperspace", "HyperspaceSession", "QueryOutcome"):
        from hyperspace_tpu_torch import hyperspace as _h

        return getattr(_h, name)
    if name == "VectorIndexConfig":
        from hyperspace_tpu_torch.vector.index import VectorIndexConfig

        return VectorIndexConfig
    if name == "PlanCache":
        from hyperspace_tpu_torch.serve.plan_cache import PlanCache

        return PlanCache
    if name in ("stats", "faults", "obs", "serve"):
        # The counters (stats.snapshot()), the fault-injection harness,
        # the observability plane (tracer, metrics, events, profiles) and
        # the query server.
        import importlib

        return importlib.import_module(f"hyperspace_tpu_torch.{name}")
    raise AttributeError(name)

"""The serving plane: a concurrent query server and its caches.

`QueryServer` puts a bounded worker pool and an admission-control queue in
front of one `HyperspaceSession` (`session.serve()`); `PlanCache` and
`ResultCache` memoize optimized plans and whole results under versioned
keys that index mutations and source appends invalidate structurally. A
port of the JAX package's `serve/`: the multi-process fleet
(`serve/fleet/`: shared caches, single-flight, tenant quotas, the
supervisor) and the operations controller (`serve/controller.py`,
`Hyperspace.controller()`) too.
"""

from hyperspace_tpu_torch.serve.controller import OpsController
from hyperspace_tpu_torch.serve.plan_cache import PlanCache, collection_log_versions, versioned_plan_key
from hyperspace_tpu_torch.serve.result_cache import ResultCache, table_nbytes
from hyperspace_tpu_torch.serve.scheduler import QueryHandle, QueryServer

__all__ = [
    "OpsController",
    "PlanCache",
    "QueryHandle",
    "QueryServer",
    "ResultCache",
    "collection_log_versions",
    "table_nbytes",
    "versioned_plan_key",
]

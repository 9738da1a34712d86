"""The serving plane's caches. Only the optimized-plan cache is ported
(serve/plan_cache.py); the server, result cache and admission control of
the JAX package's `serve/` are not ported yet."""

from hyperspace_tpu_torch.serve.plan_cache import PlanCache, collection_log_versions, versioned_plan_key

__all__ = ["PlanCache", "collection_log_versions", "versioned_plan_key"]

"""Multi-process serving fleet: a port of the JAX package's `serve/fleet/`.

N `QueryServer` processes over ONE index store, each with a CUDA context
of its own (contexts of several processes on one card are time-sliced,
not concurrent):

- `shared_cache.py` — disk-backed plan/result cache under the serving
  plane's versioned keys, so any process's index mutation structurally
  invalidates every process's entries;
- `singleflight.py` — lease-file cross-process build dedup (N cold
  processes, one optimize/execute; crashed holders reaped by TTL);
- `quota.py` — per-tenant token-bucket admission + the scheduler's
  queue-depth shedding = graceful saturation (bounded p99, typed
  rejections, never collapse);
- `supervisor.py` — spawn (never fork)/monitor/restart/drain the worker
  processes and aggregate their `/metrics` + `/healthz`;
- `lease.py` — the crash-safe file-lease primitive under all of it.

The normal wiring is :func:`shared_caches`: build the fleet caches from
a session's config and hand them to ``session.serve(plan_cache=...,
result_cache=...)`` in every worker process.
"""

from __future__ import annotations

from pathlib import Path

from hyperspace_tpu_torch.serve.fleet.lease import FileLease
from hyperspace_tpu_torch.serve.fleet.quota import TenantQuotas, TokenBucket
from hyperspace_tpu_torch.serve.fleet.shared_cache import SharedPlanCache, SharedResultCache
from hyperspace_tpu_torch.serve.fleet.singleflight import SingleFlight
from hyperspace_tpu_torch.serve.fleet.supervisor import (
    FleetSupervisor,
    WorkerContext,
    read_workers,
    register_worker,
)


def fleet_dir(conf) -> Path:
    """The fleet's shared on-disk root for a session config:
    `hyperspace.fleet.cache.dir`, defaulting to `<system.path>/_fleet`
    (underscore-prefixed ⇒ invisible to index listing)."""
    return Path(conf.fleet_cache_dir or Path(conf.system_path) / "_fleet")


def shared_caches(session) -> tuple[SharedPlanCache, SharedResultCache]:
    """The fleet cache pair for `session`, rooted at its fleet dir and
    wired through one SingleFlight — pass straight into
    ``session.serve(plan_cache=..., result_cache=...)``. Every process
    pointing at the same store derives the same paths, which is the
    whole trick."""
    conf = session.conf
    root = fleet_dir(conf)
    sf = SingleFlight(
        root / "sf",
        lease_ttl_s=conf.fleet_lease_seconds,
        wait_s=conf.fleet_singleflight_wait_seconds,
    )
    plans = SharedPlanCache(
        root / "cache" / "plans",
        max_bytes=max(1, conf.fleet_cache_max_bytes // 16),
        lease_ttl_s=conf.fleet_lease_seconds,
        single_flight=sf,
    )
    results = SharedResultCache(
        root / "cache" / "results",
        max_bytes=conf.fleet_cache_max_bytes,
        lease_ttl_s=conf.fleet_lease_seconds,
        single_flight=sf,
        device=session.device,
    )
    return plans, results


__all__ = [
    "FileLease",
    "FleetSupervisor",
    "SharedPlanCache",
    "SharedResultCache",
    "SingleFlight",
    "TenantQuotas",
    "TokenBucket",
    "WorkerContext",
    "fleet_dir",
    "read_workers",
    "register_worker",
    "shared_caches",
]

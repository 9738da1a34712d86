"""Process-wide counters: a facade over the metrics registry.

A port of the JAX package's `stats.py`: the call-site API
(``increment`` / ``get`` / ``snapshot`` / ``reset``) over declared
counters of `obs/metrics.py`. Counter names are **declared** in
:data:`KNOWN_COUNTERS`; incrementing an undeclared name raises
immediately instead of silently creating a new counter (the
``increment("retyr.attempts")`` typo class).

The port declares only the counters its modules increment:

- ``metadata.cache.hits``    TTL index-entry cache hits (metadata/cache.py)
- ``metadata.cache.misses``  TTL index-entry cache misses (empty or expired)
- ``retry.attempts``       extra attempts made after a transient failure
  (utils/retry.py)
- ``retry.exhausted``      retry loops that gave up and re-raised
- ``faults.injected``      faults the injection harness actually fired
  (faults.py)
- ``faults.delays_injected``  brownout delays the harness applied (a
  subset of ``faults.injected``)
- ``index.corruption``     typed corruption detections (bucket/manifest)
- ``fallback.queries``     queries re-planned against healthy indexes or
  the source data (hyperspace.py)
- ``action.rolled_back``   op() failures rolled back to the last stable
  state (actions/base.py)
- ``action.rollback_failed``  in-process rollback attempts that themselves
  failed (recover() finishes the repair from the next process)
- ``action.cleanup_failed``   partial-data quarantines that failed (the
  orphan GC in recover() sweeps what they left)
- ``io.footer_cache.hits``    parquet footer parses skipped by the
  mtime-validated footer cache (execution/io.py)
- ``io.footer_cache.misses``  footer parses that opened the file
- ``build.exchange.bytes``  decoded bytes the pooled build's p1 shards
  spilled for its p2 owners (execution/builder.py)
- ``build.worker.crashes``  pooled-build workers found dead without a
  posted result, each a typed WorkerCrashed (parallel/procpool.py)
- ``device.stage.bytes_zero_copy``  scalar column bytes that went from
  Arrow's buffer straight into the host-to-device copy
  (execution/staging.py)
- ``device.stage.bytes_copied``  scalar column bytes copied on the host
  first (nulls, casts, several chunks, a column bound for the CPU,
  staging off or a staging fault)
"""

from __future__ import annotations

from hyperspace_tpu_torch.obs import metrics as _metrics

KNOWN_COUNTERS = (
    "metadata.cache.hits",
    "metadata.cache.misses",
    "retry.attempts",
    "retry.exhausted",
    "faults.injected",
    "faults.delays_injected",
    "index.corruption",
    "fallback.queries",
    "action.rolled_back",
    "action.rollback_failed",
    "action.cleanup_failed",
    "io.footer_cache.hits",
    "io.footer_cache.misses",
    "build.exchange.bytes",
    "build.worker.crashes",
    "device.stage.bytes_zero_copy",
    "device.stage.bytes_copied",
)

_counters = {name: _metrics.counter(name) for name in KNOWN_COUNTERS}


def increment(name: str, n: int = 1) -> None:
    c = _counters.get(name)
    if c is None:
        raise KeyError(
            f"undeclared counter {name!r} — declare it in stats.KNOWN_COUNTERS "
            f"(silent typo counters are exactly what the declared registry removes)"
        )
    c.inc(n)


def get(name: str) -> int:
    c = _counters.get(name)
    if c is None:
        raise KeyError(f"undeclared counter {name!r} (see stats.KNOWN_COUNTERS)")
    return c.value


def snapshot() -> dict[str, int]:
    """Point-in-time copy of every declared counter."""
    return {name: c.value for name, c in _counters.items()}


def reset() -> None:
    for c in _counters.values():
        c._reset()

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
"""

from __future__ import annotations

from hyperspace_tpu_torch.obs import metrics as _metrics

KNOWN_COUNTERS = (
    "metadata.cache.hits",
    "metadata.cache.misses",
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

"""Per-tenant admission quotas: token buckets in front of the scheduler.

A port of the JAX package's `serve/fleet/quota.py`, with the same bucket
arithmetic.

The admission queue (serve/scheduler.py) bounds TOTAL work; it cannot
stop one noisy tenant from filling the whole queue and starving
everyone else. This module adds the per-tenant dimension: each tenant
id gets a token bucket (`ratePerSecond` refill, `burst` capacity), and
a submit whose bucket is dry is refused with a typed
:class:`~hyperspace_tpu_torch.exceptions.QuotaExceeded` — an
`AdmissionRejected` subclass carrying `retry_after_s`, the earliest
moment a token will exist again — BEFORE the query costs a queue slot
or worker time. Layered under the scheduler's priority lane: quota
admission runs first, then depth shedding, then the hard depth limit
.

Deterministic by construction: the bucket math uses an injectable
monotonic clock, so tests drive time explicitly. Buckets are created
lazily per tenant and the map is bounded (LRU past `max_tenants` — a
tenant idle long enough to be evicted restarts with a full bucket,
which only ever errs in the tenant's favor).
"""

from __future__ import annotations

import threading
import time

from hyperspace_tpu_torch.exceptions import QuotaExceeded
from hyperspace_tpu_torch.obs import events as obs_events
from hyperspace_tpu_torch.obs import metrics as obs_metrics

_EVT_QUOTA = obs_events.declare("serve.quota_rejected")
_QUOTA_REJECTED = obs_metrics.counter(
    "serve.quota.rejected", "submits refused by a tenant's token bucket"
)


class TokenBucket:
    """One tenant's bucket: `rate` tokens/second refill up to `burst`.
    Not self-locking — the owning :class:`TenantQuotas` serializes."""

    __slots__ = ("rate", "burst", "tokens", "_t_last")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._t_last = now

    def try_take(self, now: float, scale: float = 1.0) -> float:
        """Take one token. Returns 0.0 on success, else the seconds
        until one will be available (the retry-after hint). `scale`
        multiplies the refill rate for this refill window — the ops
        controller's fleet-wide throttle (serve/controller.py)."""
        rate = self.rate * scale
        self.tokens = min(self.burst, self.tokens + (now - self._t_last) * rate)
        self._t_last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return 0.0
        if rate <= 0:
            return float("inf")
        return (1.0 - self.tokens) / rate


class TenantQuotas:
    """Tenant id -> token bucket, with per-tenant limit overrides."""

    def __init__(
        self,
        rate: float = 100.0,
        burst: float = 200.0,
        clock=time.monotonic,
        max_tenants: int = 4096,
    ):
        self.default_rate = float(rate)
        self.default_burst = float(burst)
        self.max_tenants = int(max_tenants)
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: dict[str, TokenBucket] = {}
        self._limits: dict[str, tuple[float, float]] = {}
        # Multiplier on every bucket's refill rate (1.0 = rated). The
        # ops controller tightens it while serve SLOs page and restores
        # it on recovery; per-tenant limits and burst stay untouched.
        self._throttle = 1.0

    def set_throttle(self, factor: float) -> None:
        """Scale every tenant's refill rate by `factor` (0 < factor;
        1.0 restores the rated quotas)."""
        with self._lock:
            self._throttle = max(0.0, float(factor))

    def throttle(self) -> float:
        with self._lock:
            return self._throttle

    def set_limit(self, tenant: str, rate: float, burst: float | None = None) -> None:
        """Override one tenant's rate/burst; takes effect on its next
        bucket refill (an existing bucket is rebuilt)."""
        with self._lock:
            self._limits[tenant] = (float(rate), float(burst if burst is not None else rate * 2))
            self._buckets.pop(tenant, None)

    def admit(self, tenant: str) -> None:
        """Take one token for `tenant` or raise :class:`QuotaExceeded`
        (with `retry_after_s`). Tenants are strings — opaque ids minted
        by whatever fronts the fleet."""
        tenant = str(tenant)
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                rate, burst = self._limits.get(
                    tenant, (self.default_rate, self.default_burst)
                )
                bucket = TokenBucket(rate, burst, self._clock())
                self._buckets[tenant] = bucket
                while len(self._buckets) > self.max_tenants:
                    self._buckets.pop(next(iter(self._buckets)))
            else:
                self._buckets[tenant] = self._buckets.pop(tenant)  # LRU touch
            wait_s = bucket.try_take(self._clock(), scale=self._throttle)
        if wait_s > 0.0:
            _QUOTA_REJECTED.inc()
            _EVT_QUOTA.emit(tenant=tenant, retry_after_s=wait_s)
            raise QuotaExceeded(
                f"tenant {tenant!r} admission quota exhausted "
                f"(retry after {wait_s:.3f}s)",
                tenant=tenant,
                retry_after_s=wait_s,
            )

    def snapshot(self) -> dict:
        """Point-in-time {tenant: remaining tokens} (healthz/tests)."""
        with self._lock:
            return {t: b.tokens for t, b in self._buckets.items()}

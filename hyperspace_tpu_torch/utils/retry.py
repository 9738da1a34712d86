"""Retry with exponential backoff for transient-IO call sites.

A copy of the JAX package's `utils/retry.py`. Wraps the IO primitives
the metadata plane depends on (write_json, parquet reads) so a flaky disk or a lease-contended rename is a
delay, not a failure. Policy knobs surface as `hyperspace.retry.*`
config keys (config.py routes them here); classification of what is
worth retrying lives in `exceptions.is_retryable` — corruption and
missing files surface immediately, only genuinely transient OS errors
(and injected `faults.FaultError`s, which carry errno EIO) retry.

Determinism: backoff is a pure function of the attempt number
(base * multiplier**attempt, capped). A `jitter` hook exists for
deployments that want decorrelation, but it must be injected explicitly
— nothing here draws from an RNG, so tests replay byte-identically. The sleeper is injectable for the
same reason: unit tests pass a recording no-op and assert the schedule
instead of actually waiting.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from hyperspace_tpu_torch import stats
from hyperspace_tpu_torch.exceptions import is_retryable
from hyperspace_tpu_torch.obs import trace as obs_trace


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Attempt budget + deterministic exponential backoff schedule."""

    max_attempts: int = 3
    backoff_base: float = 0.005  # seconds before the first retry
    backoff_multiplier: float = 2.0
    backoff_max: float = 0.25
    # Optional decorrelation hook: (attempt_index, computed_delay) -> delay.
    # None ⇒ fully deterministic schedule.
    jitter: Callable[[int, float], float] | None = None
    retryable: Callable[[BaseException], bool] = is_retryable

    def delay(self, attempt: int) -> float:
        """Seconds to sleep before retry number `attempt` (0-based)."""
        d = min(self.backoff_max, self.backoff_base * self.backoff_multiplier**attempt)
        if self.jitter is not None:
            d = self.jitter(attempt, d)
        return max(0.0, d)


_io_policy = RetryPolicy()
_cas_attempts = 1  # Action.run CAS-contention retries; 1 = abort on loss (reference behavior)
_sleeper: Callable[[float], None] = time.sleep


def configure(
    *,
    max_attempts: int | None = None,
    backoff_base: float | None = None,
    backoff_max: float | None = None,
    cas_attempts: int | None = None,
    sleeper: Callable[[float], None] | None = None,
) -> None:
    """Adjust the process-default policy (the `hyperspace.retry.*` keys
    route here from HyperspaceConf.set). `max_attempts=1` is the retry
    kill switch: every transient failure surfaces on first occurrence."""
    global _io_policy, _cas_attempts, _sleeper
    kwargs: dict[str, Any] = {}
    if max_attempts is not None:
        kwargs["max_attempts"] = max(1, int(max_attempts))
    if backoff_base is not None:
        kwargs["backoff_base"] = float(backoff_base)
    if backoff_max is not None:
        kwargs["backoff_max"] = float(backoff_max)
    if kwargs:
        _io_policy = dataclasses.replace(_io_policy, **kwargs)
    if cas_attempts is not None:
        _cas_attempts = max(1, int(cas_attempts))
    if sleeper is not None:
        _sleeper = sleeper


def io_policy() -> RetryPolicy:
    return _io_policy


def cas_attempts() -> int:
    """Whole-protocol retries Action.run() makes when its begin() CAS
    loses to a concurrent writer (re-reads the log and re-validates per
    attempt). Default 1 — single-writer optimistic concurrency aborts,
    matching the reference; opt in via `hyperspace.retry.casAttempts`."""
    return _cas_attempts


def retry_call(fn: Callable[..., Any], *args, policy: RetryPolicy | None = None, **kwargs) -> Any:
    """Run `fn(*args, **kwargs)`, retrying per `policy` on retryable
    exceptions. Exhaustion re-raises the last exception unchanged (so
    existing `except OSError` handling upstream keeps working). Only
    `Exception` subclasses are considered — a simulated crash
    (faults.CrashPoint, a BaseException) always propagates: a dead
    process does not retry."""
    p = policy if policy is not None else _io_policy
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 — classified below
            if attempt >= p.max_attempts - 1 or not p.retryable(e):
                if attempt > 0:
                    stats.increment("retry.exhausted")
                    obs_trace.event("retry.exhausted", attempts=attempt + 1, error=str(e))
                raise
            stats.increment("retry.attempts")
            delay = p.delay(attempt)
            # Point event on the active span (if any): which call site
            # retried, why, and what the backoff cost.
            obs_trace.event("retry", attempt=attempt + 1, delay_s=delay, error=str(e))
            _sleeper(delay)
            attempt += 1


def retrying(policy: RetryPolicy | None = None):
    """Decorator form of retry_call for named transient-IO functions."""

    def deco(fn):
        import functools

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return retry_call(fn, *args, policy=policy, **kwargs)

        return wrapper

    return deco

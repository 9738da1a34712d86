"""Cross-process single-flight: N cold processes, ONE build.

A port of the JAX package's `serve/fleet/singleflight.py`; its lease files
are the JAX package's, so the two packages dedup against each other.

`device_cache.RefCache` already dedups concurrent in-process misses on
one cold key (one thread builds, the rest wait on its event). A fleet
of processes has the same thundering-herd problem one level up: N freshly started workers all miss the shared
plan/result cache on the same hot key and would each pay the same
optimize/execute/stage cost. This module extends the dedup across
process boundaries with a lease-file protocol (fleet/lease.py):

- the first claimant wins the lease and becomes the **leader** — it
  runs ``build()`` (which normally publishes its artifact into the
  shared cache) and releases the lease;
- every other process is a **follower**: it polls ``check()`` (the
  shared-cache read) and returns as soon as the leader's artifact
  appears;
- a follower whose wait expires (``wait_s``) falls back to a **local
  build** — correctness never depends on the leader, the wait only
  dedups work;
- a leader that is SIGKILLed mid-build leaves a lease whose epoch goes
  stale after the TTL; the next claimant **reaps** it and takes over
  (`fleet.singleflight.takeovers`) — a crashed holder can never wedge
  the fleet.

Every outcome is counted (`fleet.singleflight.*`, stats.KNOWN_COUNTERS)
and a takeover additionally emits a WARN ``fleet.singleflight.takeover``
event naming the key — reaping a dead process's lease is worth an
operator's attention even though the fleet healed itself.
"""

from __future__ import annotations

import hashlib
import time
from pathlib import Path
from typing import Callable

from hyperspace_tpu_torch import stats
from hyperspace_tpu_torch.obs import events as obs_events
from hyperspace_tpu_torch.obs import trace as obs_trace
from hyperspace_tpu_torch.serve.fleet.lease import FileLease

_EVT_TAKEOVER = obs_events.declare("fleet.singleflight.takeover")

# Follower poll cadence: cheap (one stat / small read per lap) and fast
# enough that a follower observes the leader's publish promptly.
_POLL_S = 0.02


def key_name(key: object) -> str:
    """Filesystem-safe digest of an arbitrary (reprable) key."""
    return hashlib.md5(repr(key).encode()).hexdigest()


class SingleFlight:
    """Lease-backed cross-process build dedup rooted at one directory
    (every fleet member must point at the same dir — the factory in
    serve/fleet/__init__.py derives it from the shared store path)."""

    def __init__(self, root: str | Path, lease_ttl_s: float = 10.0, wait_s: float = 15.0):
        self.root = Path(root)
        self.lease_ttl_s = float(lease_ttl_s)
        self.wait_s = float(wait_s)

    def run(self, name: str, build: Callable, check: Callable | None = None,
            on_lease: Callable | None = None):
        """Run `build()` at most once across the fleet for `name`,
        returning its value. `check() -> value | None` observes the
        leader's published artifact (e.g. a shared-cache read); without
        it every claimant that loses the lease waits for the lease to
        clear and then builds (pure serialization, no artifact reuse).
        Exceptions from `build` propagate to the caller that ran it;
        the lease is always released.

        `on_lease(lease, token)` (optional) is told when this process
        WINS the lease, and `on_lease(None, None)` when it is released —
        a shutdown path (OpsController.stop) uses it to release a lease
        its in-flight actuation still holds instead of leaving it live
        for TTL seconds. FileLease.release is token-checked and
        idempotent, so the `finally` re-release is harmless."""
        lease = FileLease(self.root / f"{key_name(name)}.lease", self.lease_ttl_s)
        deadline = time.monotonic() + self.wait_s
        # Follower wait span: opened lazily on the first lap that
        # actually waits, linked to the leader's root trace id read from
        # the lease token's note field — the cross-process edge a merged
        # fleet trace needs. NOOP outside a trace; closed on every exit path.
        wait_span = None
        leader_id = None
        try:
            while True:
                # Check BEFORE claiming: once the leader releases, every
                # waiter's next acquire would succeed — without this order a
                # waiter that raced past its last check would win the freed
                # lease and redo the build it was waiting for.
                if check is not None:
                    value = check()
                    if value is not None:
                        stats.increment("fleet.singleflight.follower_hits")
                        if wait_span is not None:
                            wait_span.set(outcome="follower_hit")
                        return value
                claim = lease.try_acquire(note=obs_trace.current_trace_id())
                if claim is not None:
                    token, reaped = claim
                    if on_lease is not None:
                        on_lease(lease, token)
                    try:
                        if check is not None:
                            # Double-check after winning: the previous
                            # leader may have published between our check
                            # and the claim.
                            value = check()
                            if value is not None:
                                stats.increment("fleet.singleflight.follower_hits")
                                if wait_span is not None:
                                    wait_span.set(outcome="follower_hit")
                                return value
                        if reaped:
                            stats.increment("fleet.singleflight.takeovers")
                            _EVT_TAKEOVER.emit(key=str(name))
                        stats.increment("fleet.singleflight.leader")
                        if wait_span is not None:
                            wait_span.set(outcome="became_leader")
                        return build()
                    finally:
                        lease.release(token)
                        if on_lease is not None:
                            on_lease(None, None)
                if time.monotonic() >= deadline:
                    # The leader is slow (or its artifact is uncacheable):
                    # build locally. Same cost as a world without dedup.
                    stats.increment("fleet.singleflight.local_fallbacks")
                    if wait_span is not None:
                        wait_span.set(outcome="local_fallback")
                    return build()
                if wait_span is None:
                    wait_span = obs_trace.span(
                        "fleet.singleflight.wait", key=str(name)
                    ).__enter__()
                if leader_id is None:
                    leader_id = lease.holder_note()
                    if leader_id:
                        wait_span.set(leader_trace_id=leader_id)
                time.sleep(_POLL_S)
        finally:
            if wait_span is not None:
                wait_span.__exit__(None, None, None)

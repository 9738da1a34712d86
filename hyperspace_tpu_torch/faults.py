"""Deterministic fault injection for the metadata and execution planes.

The production claim this repo rides on — the operation log tolerates
writers that die mid-`op()` (actions/base.py two-phase protocol) — is
untestable without a way to make IO fail *on purpose, at a chosen call,
deterministically*. This module provides that: named **fault points**
threaded through `utils/file_utils.py`, `metadata/log_manager.py` and
`execution/io.py` call :func:`fault_point` with a semantic name and the
path being acted on; tests register :class:`FaultRule`\\ s that make a
specific call raise a transient :class:`FaultError`, simulate a hard
process death via :class:`CrashPoint`, or truncate/corrupt the bytes on
disk — on a schedule (fail the first N calls, fail exactly call K).

Design constraints:

- **Zero overhead when disabled.** `fault_point` is a single module-global
  check (`if not _armed: return`) on the hot IO paths; nothing else runs
  unless a test armed the harness.
- **Crash ≠ error.** :class:`CrashPoint` derives from ``BaseException``,
  so the `except Exception` failure handling in `Action.run()` cannot
  "survive" it — exactly like a real `kill -9`, the dying writer gets no
  chance to clean up, and recovery must happen in a later process
  (`Hyperspace.recover`). Transient :class:`FaultError` is an ``OSError``
  with errno EIO, so `exceptions.is_retryable` classifies it and the
  retry layer (utils/retry.py) handles it like any flaky disk.
- **Deterministic.** Schedules count calls, never wall time or RNG.
  Brownout jitter derives from the rule's own call counter through a
  Knuth multiplicative hash — the same schedule every run.

Brownout (slow-path) injection: a rule with ``delay_s`` makes the point
*slow* instead of failed — the arriving call sleeps ``delay_s`` plus a
deterministic per-call jitter in ``[0, jitter_s)`` before continuing (or
before the rule's error/crash action, so "slow then fail" composes).
The sleep happens OUTSIDE the harness lock, in small slices
that re-check the armed gate, so the ``hyperspace.faults.enabled`` kill
switch disarms a delay already in flight. Tests that must not spend
wall time install a virtual sleeper via :func:`set_sleeper` (a virtual
clock); delays are clamped to
``hyperspace.faults.maxDelaySeconds`` so a typo'd rule cannot wedge a
deadline-carrying path past its typed timeout budget.

Kill switch: ``hyperspace.faults.enabled`` (config.py) — when set False,
`fault_point` is inert even with rules registered, so a production
config can never be one stray rule away from injected failures.

Fault point names in use (see each call site). A port of the JAX
package's `faults.py`: its `KNOWN_POINTS` lists the points of every
module, this one only the points the port fires. Each other point joins
the list with the module that fires it, and `inject` of a point that is
not listed raises.

====================  =====================================================
``file.write_json``   file_utils.write_json overwrite (temp + replace) path
``file.atomic_write`` file_utils.atomic_write CAS-create path
``log.write``         log_manager.write_log, before the entry CAS
``log.written``       after a log entry commits (truncate ⇒ torn entry)
``log.stable.write``  before the latestStable pointer rewrite
``manifest.write``    io.write_manifest, before the atomic write
``manifest.written``  after the manifest commits (truncate ⇒ torn manifest)
``manifest.read``     io.read_manifest, before the JSON parse
``bucket.write``      io.write_bucket, before the parquet encode
``bucket.written``    after a bucket file lands (truncate ⇒ corrupt bucket)
``bucket.read``       io._read_one_file / io._read_chunk_file, before a
                      data decode, inside the retried call (a transient
                      fault is retried)
``footer.read``       io._read_footer, a footer-cache miss, inside the
                      retried call
``spill.read``        builder._p2_pipelined's reader, before a spill
                      bucket's decode
``pipeline.put``      the reader, before it queues a decoded bucket
``pipeline.get``      the sort stage, before it takes the next bucket
``prefetch.issue``    prefetch.prefetch_plan, before a file's job is
                      submitted (a transient fault skips that file)
``build.worker.spawn``  builder._write_pooled, before each worker starts
``build.exchange.write``  build_exchange.p1_shard, in the worker, before
                      each spill file closes
``build.exchange.read``  build_exchange.p2_owner, in the worker, before a
                      bucket's spill files are read
``build.manifest.merge``  builder._write_pooled, before the per-owner stats
                      merge into the manifest
``device.stage``      staging.stage_column, before a column goes
                      zero-copy to the card (a transient fault takes that
                      column down the copied path)
``fleet.lease.acquire``  fleet/lease.py, before a cross-process lease claim
``fleet.cache.read``  fleet/shared_cache.py, before a shared-entry read
``fleet.cache.write`` fleet/shared_cache.py, before a shared-entry publish
``fleet.cache.evict`` fleet/shared_cache.py, before each lease-held eviction
``controller.actuate``  serve/controller.py, immediately before each
                      controller mutation (shed engage / release, heal,
                      scale): a crash there leaves no partial actuation
``journal.seal``      obs/journal.py, after a sealed segment publishes but
                      before the eviction runs
``controller.heal.marker``  serve/controller.py, after the leader heals
                      the shared bytes but before the generation marker
                      publishes
``advisor.recommend`` advisor/whatif.py, at the head of a recommendation pass
``advisor.apply``     advisor/lifecycle.py, before each policy mutation
``ingest.tail``       ingest/tailer.py, after a CDC batch file lands but
                      before the cursor persists: a crash there leaves an
                      orphan batch that the deterministic naming makes the
                      retry idempotent over
``ingest.commit``     ingest/writer.py, before a micro-batch's incremental
                      refresh runs (a crash mid-commit leaves at most the
                      action protocol's transient log entry)
``ingest.compact``    ingest/writer.py, before the gated optimize action
                      compacts delta buckets
``ingest.stamp``      ingest/daemon.py, after a micro-batch commits but
                      before the daemon stamps its lag / commit bookkeeping
====================  =====================================================

`export_state` / `install_state` carry the harness into the pooled
build's spawned workers and the ingest worker (parallel/procpool.py): a rule at a worker-side
point fires inside the worker, and the worker's observed points merge
back on join.
"""

from __future__ import annotations

import dataclasses
import errno as _errno
import os
import threading
from contextlib import contextmanager
from typing import Iterator

from hyperspace_tpu_torch import stats

KNOWN_POINTS = (
    "file.write_json",
    "file.atomic_write",
    "log.write",
    "log.written",
    "log.stable.write",
    "manifest.write",
    "manifest.written",
    "manifest.read",
    "bucket.write",
    "bucket.written",
    "bucket.read",
    "footer.read",
    "spill.read",
    "pipeline.put",
    "pipeline.get",
    "prefetch.issue",
    "build.worker.spawn",
    "build.exchange.write",
    "build.exchange.read",
    "build.manifest.merge",
    "device.stage",
    "fleet.lease.acquire",
    "fleet.cache.read",
    "fleet.cache.write",
    "fleet.cache.evict",
    "controller.actuate",
    "journal.seal",
    "controller.heal.marker",
    "advisor.recommend",
    "advisor.apply",
    "ingest.tail",
    "ingest.commit",
    "ingest.compact",
    "ingest.stamp",
)


class FaultError(OSError):
    """Injected transient IO failure. errno EIO ⇒ retryable
    (exceptions.is_retryable), so the retry layer treats it exactly like
    a real flaky disk."""

    def __init__(self, msg: str):
        super().__init__(_errno.EIO, msg)


class CrashPoint(BaseException):
    """Simulated hard process death at a fault point.

    BaseException on purpose: recovery code that catches ``Exception``
    must not be able to run in the "dying" process — the test harness
    catches this at its outermost level and then plays the next process
    (recover / re-open), which is the only honest way to test crash
    consistency.
    """

    def __init__(self, point: str, path: str | None = None):
        super().__init__(f"simulated crash at fault point {point!r}")
        self.point = point
        self.path = path


@dataclasses.dataclass
class FaultRule:
    """One registered fault: where, what, and on which calls.

    `at_call` fires on exactly the K-th arrival at the point (1-based);
    `times` caps how many times the rule fires (fail-N-then-succeed);
    both unset ⇒ fires on every arrival. Actions compose in order:
    `delay_s` sleeps first (brownout), then truncate/corrupt mutate the
    file, then `error`/`crash` raise — so a single rule can model "the
    disk went slow, wrote garbage AND the process died". A pure-delay
    rule (delay_s set, no other action) slows the call and lets it
    proceed; `jitter_s` adds a deterministic per-call extra in
    ``[0, jitter_s)`` derived from the rule's call counter (no RNG)."""

    point: str
    error: BaseException | type | None = None
    crash: bool = False
    truncate: int | None = None  # keep only the first N bytes of `path`
    corrupt: bytes | None = None  # overwrite the head of `path` with these bytes
    delay_s: float = 0.0  # brownout: sleep this long before any other action
    jitter_s: float = 0.0  # deterministic per-call extra delay in [0, jitter_s)
    at_call: int | None = None  # 1-based call index this rule fires at
    times: int | None = None  # max number of firings (None = unlimited)
    calls: int = 0
    fired: int = 0


_lock = threading.Lock()
_rules: list[FaultRule] = []
_observed: set[str] = set()
_armed = False  # fast-path gate: False ⇒ fault_point returns immediately
_enabled = True  # hyperspace.faults.enabled kill switch

# Brownout machinery. The sleeper is a hook (default: real time.sleep)
# so virtual-clock harnesses account delay without spending wall time;
# sleeps run in _DELAY_SLICE_S slices re-checking the armed gate, so
# the kill switch disarms a delay already in flight. _max_delay_s caps
# any single injected delay (hyperspace.faults.maxDelaySeconds).
_DELAY_SLICE_S = 0.05
_KNUTH = 2654435761  # multiplicative-hash constant (deterministic jitter)
_sleeper = None  # None ⇒ time.sleep; swapped by set_sleeper()
_max_delay_s = 30.0


def set_enabled(enabled: bool) -> None:
    """Config kill switch (`hyperspace.faults.enabled`). False disarms
    the harness even with rules registered."""
    global _enabled, _armed
    with _lock:
        _enabled = bool(enabled)
        _armed = _enabled and bool(_rules)


def set_sleeper(sleeper) -> None:
    """Install the brownout sleep hook: ``sleeper(seconds)`` is called
    (possibly in slices) for every injected delay. Pass a virtual-clock
    advance to keep delay accounting wall-clock-free, or None to restore
    real ``time.sleep``."""
    global _sleeper
    with _lock:
        _sleeper = sleeper


def set_max_delay(seconds: float) -> None:
    """Config clamp (`hyperspace.faults.maxDelaySeconds`) on any single
    injected delay (base + jitter)."""
    global _max_delay_s
    with _lock:
        _max_delay_s = max(0.0, float(seconds))


def inject(
    point: str,
    *,
    error: BaseException | type | None = None,
    crash: bool = False,
    truncate: int | None = None,
    corrupt: bytes | None = None,
    delay_s: float = 0.0,
    jitter_s: float = 0.0,
    at_call: int | None = None,
    times: int | None = None,
) -> FaultRule:
    """Register a fault at `point`. With no explicit action, the rule
    raises a transient :class:`FaultError` (the common retry-test case);
    a bare ``delay_s`` makes a brownout rule — the call slows down and
    then proceeds normally."""
    if point not in KNOWN_POINTS:
        raise ValueError(f"unknown fault point {point!r} (see faults.KNOWN_POINTS)")
    if (error is None and not crash and truncate is None and corrupt is None
            and not delay_s):
        error = FaultError
    rule = FaultRule(
        point=point, error=error, crash=crash, truncate=truncate,
        corrupt=corrupt, delay_s=delay_s, jitter_s=jitter_s,
        at_call=at_call, times=times,
    )
    global _armed
    with _lock:
        _rules.append(rule)
        _armed = _enabled
    return rule


def reset() -> None:
    """Clear every rule and observation; disarm the fast path. The
    brownout sleeper hook is restored to real ``time.sleep`` so a
    virtual clock can never leak across tests."""
    global _armed, _sleeper
    with _lock:
        _rules.clear()
        _observed.clear()
        _armed = False
        _sleeper = None


@contextmanager
def injected(point: str, **kwargs) -> Iterator[FaultRule]:
    """`with faults.injected("log.write", crash=True): ...` — register one
    rule for the block, always reset after."""
    rule = inject(point, **kwargs)
    try:
        yield rule
    finally:
        reset()


@contextmanager
def recording() -> Iterator[set]:
    """Arm the harness with no rules, purely to record which fault points
    a block of code passes through — the discovery pass the crash sweep
    uses to enumerate the points each action actually exercises. The
    yielded set keeps its contents after the block exits."""
    global _armed
    out: set[str] = set()
    with _lock:
        _observed.clear()
        _armed = _enabled
    try:
        yield out
    finally:
        with _lock:
            out |= _observed
        reset()


def observed_points() -> set[str]:
    """Fault points hit while the harness was armed (recording or rules)."""
    with _lock:
        return set(_observed)


def merge_observed(points) -> None:
    """Fold a worker's observed points back into this process's set (the
    return leg of the cross-process recording)."""
    if not points:
        return
    with _lock:
        _observed.update(points)


def export_state() -> dict:
    """Picklable snapshot of the harness (rules with FRESH call/fire
    schedules, the kill switch, and whether the fast path is armed) for
    shipping into a spawned worker process. Schedules count per process:
    `at_call=1` fires at each worker's first arrival."""
    with _lock:
        return {
            "enabled": _enabled,
            "armed": _armed,
            "max_delay_s": _max_delay_s,
            "rules": [dataclasses.replace(r, calls=0, fired=0) for r in _rules],
        }


def install_state(state: dict) -> None:
    """Install a coordinator's :func:`export_state` snapshot into this
    (worker) process. `armed` is honored even with zero rules so a
    coordinator-side `recording()` pass observes worker-side points
    too."""
    global _armed, _enabled, _max_delay_s
    with _lock:
        _rules.clear()
        _rules.extend(state.get("rules") or ())
        _enabled = bool(state.get("enabled", True))
        _max_delay_s = float(state.get("max_delay_s", _max_delay_s))
        _armed = _enabled and (bool(_rules) or bool(state.get("armed")))


def fault_point(name: str, path: str | os.PathLike | None = None) -> None:
    """Declare a named fault point. Call sites sprinkle this on the IO
    paths; it is a no-op unless a test armed the harness."""
    # Benign racy read by design: _armed is a bool gate flipped under
    # _lock; a stale False skips at most one injection during the arming
    # instant, and the disarmed fast path must stay lock-free (every
    # metadata/IO call site runs through here).
    if not _armed:
        return
    _hit(name, path)


def _hit(name: str, path: str | os.PathLike | None) -> None:
    to_fire: list[tuple[FaultRule, int]] = []
    with _lock:
        _observed.add(name)
        for rule in _rules:
            if rule.point != name:
                continue
            rule.calls += 1
            if rule.at_call is not None and rule.calls != rule.at_call:
                continue
            if rule.times is not None and rule.fired >= rule.times:
                continue
            rule.fired += 1
            to_fire.append((rule, rule.calls))
    for rule, call_no in to_fire:
        stats.increment("faults.injected")
        # Brownout first — "went slow, THEN failed" is the composition a
        # real degraded disk exhibits. Runs outside _lock.
        if rule.delay_s > 0.0 or rule.jitter_s > 0.0:
            _apply_delay(rule, call_no)
        if path is not None and (rule.truncate is not None or rule.corrupt is not None):
            _mangle_file(path, rule)
        if rule.crash:
            raise CrashPoint(name, str(path) if path is not None else None)
        if rule.error is not None:
            if isinstance(rule.error, type):
                raise rule.error(f"injected fault at {name!r}" + (f" ({path})" if path else ""))
            raise rule.error


def _apply_delay(rule: FaultRule, call_no: int) -> None:
    """Sleep the rule's brownout schedule for its `call_no`-th arrival:
    base delay plus a deterministic jitter in ``[0, jitter_s)`` hashed
    from the call counter (same schedule every run, no RNG), clamped to
    the configured max. Sliced so the kill switch (or reset) disarms a
    delay already in flight."""
    jitter = rule.jitter_s * ((call_no * _KNUTH) % 1000) / 1000.0
    with _lock:
        total = min(rule.delay_s + jitter, _max_delay_s)
        sleeper = _sleeper
    if total <= 0.0:
        return
    stats.increment("faults.delays_injected")
    import time

    if sleeper is None:
        sleeper = time.sleep
    remaining = total
    while remaining > 0.0:
        with _lock:  # kill switch flipped mid-delay ⇒ stop browning out
            armed = _armed
        if not armed:
            return
        step = min(remaining, _DELAY_SLICE_S)
        sleeper(step)
        remaining -= step


def _mangle_file(path: str | os.PathLike, rule: FaultRule) -> None:
    """Apply a truncate/corrupt schedule to the file at `path` (missing
    file ⇒ no-op: the point fired before the bytes landed)."""
    try:
        if rule.truncate is not None:
            with open(path, "r+b") as f:
                f.truncate(rule.truncate)
        if rule.corrupt is not None:
            with open(path, "r+b") as f:
                f.write(rule.corrupt)
    except OSError:
        pass

"""Framework exception types (the subset the port raises).

Reference parity: com/microsoft/hyperspace/HyperspaceException.scala:17-19 —
a single exception class carrying a message, plus the typed corruption
error the scan path raises for unreadable index data, the serving
plane's typed refusals (`AdmissionRejected`, its tenant-scoped
`QuotaExceeded`, `QueryTimeout`), the
transient-IO classification the retry layer reads (`TransientIOError`,
`TRANSIENT_ERRNOS`, `is_retryable`) and the plan validator's structured
diagnostics (`PlanDiagnostic`, `PlanValidationError`, `PlanRewriteError`):
a malformed plan fails before execution with the offending node's path
from the plan root.
"""

from __future__ import annotations

import dataclasses
import errno as _errno


class HyperspaceError(Exception):
    """Raised for any user-facing framework error."""

    def __init__(self, msg: str):
        super().__init__(msg)
        self.msg = msg


class IndexCorruptionError(HyperspaceError):
    """Index data on disk is unreadable: a truncated/garbage bucket file,
    a torn `_index_manifest.json`, or a missing file the log still
    references. Carries the index root and the failing path."""

    def __init__(self, msg: str, index_root: str | None = None, path: str | None = None):
        super().__init__(msg)
        self.index_root = index_root
        self.path = path


class AdmissionRejected(HyperspaceError):
    """The serving layer refused to enqueue a query: the admission queue
    is at its configured max depth (or past the shed depth), or the
    server is draining or shut down. Raised at submit time, so load is
    shed before it costs queue slots and worker time. Carries the
    observed depth for client-side backoff."""

    def __init__(self, msg: str, depth: int | None = None, max_depth: int | None = None):
        super().__init__(msg)
        self.depth = depth
        self.max_depth = max_depth


class QuotaExceeded(AdmissionRejected):
    """A tenant's token-bucket admission quota is exhausted
    (serve/fleet/quota.py): the submit was refused before it cost a queue
    slot, like a depth rejection, but scoped to one tenant id. Carries
    `retry_after_s`, the earliest time a token will be available again.
    Subclasses :class:`AdmissionRejected`, so `QueryServer.submit`'s
    declared error contract covers it."""

    def __init__(self, msg: str, tenant: str | None = None, retry_after_s: float | None = None):
        super().__init__(msg)
        self.tenant = tenant
        self.retry_after_s = retry_after_s


class QueryTimeout(HyperspaceError):
    """A served query exceeded its per-query timeout: it expired while
    waiting in the admission queue (the worker discards it unexecuted),
    or the caller's `result()` wait ran out while it was still executing.
    `elapsed_s` is how long the query had been in the system."""

    def __init__(self, msg: str, elapsed_s: float | None = None):
        super().__init__(msg)
        self.elapsed_s = elapsed_s


class UnknownConfigKeyError(HyperspaceError):
    """A `hyperspace.*` config key was get/set that is declared nowhere
    (almost always a typo). Carries a did-you-mean `suggestion` when a
    declared key is close."""

    def __init__(self, key: str, suggestion: str | None = None):
        msg = f"unknown config key {key!r}"
        if suggestion:
            msg += f" — did you mean {suggestion!r}?"
        super().__init__(msg)
        self.key = key
        self.suggestion = suggestion


class WorkerCrashed(HyperspaceError):
    """A pooled-build worker process died without posting its result (a
    real ``kill -9``, an OOM kill, or an injected CrashPoint unwinding out
    of the worker). Raised by the coordinator's bounded join
    (`parallel/procpool.py`) instead of a hang; `Action.run` rolls the
    build back like any other op() failure."""

    def __init__(self, msg: str, task_id=None, exitcode: int | None = None):
        super().__init__(msg)
        self.task_id = task_id
        self.exitcode = exitcode


class WorkerFailed(HyperspaceError):
    """A pooled-build worker's task body raised: the worker posted the
    error (type, message, traceback text) and the coordinator re-raises it
    as this typed abort, the worker's traceback in the message."""

    def __init__(self, msg: str, task_id=None, error_type: str | None = None):
        super().__init__(msg)
        self.task_id = task_id
        self.error_type = error_type


class TransientIOError(OSError):
    """Marker for IO failures worth retrying (lease contention, flaky
    remote filesystems). Carries errno EIO so `is_retryable` classifies
    it without special-casing the type."""

    def __init__(self, msg: str):
        super().__init__(_errno.EIO, msg)


# errnos that signal a transient condition: the same call can succeed on
# retry without anything else changing. ENOENT/EEXIST/EACCES are excluded
# on purpose — they describe durable state, and retrying masks real bugs.
TRANSIENT_ERRNOS = frozenset(
    {
        _errno.EIO,
        _errno.EAGAIN,
        _errno.EBUSY,
        _errno.EINTR,
        _errno.ETIMEDOUT,
        _errno.ECONNRESET,
        _errno.ECONNABORTED,
        _errno.ESTALE,
    }
)


# The declared typed-error surface of every public entry point: the
# exception types (by class name, hierarchy-aware — an entry covers its
# subclasses) that MAY escape each API. The static rule HSL016
# (analysis/raises.py) verifies both directions on every push: any
# statically observed escape not covered here is contract drift, and a
# declared program-local type covering no observed escape is dead.
# docs/torch/errors.md renders this table (python -m
# hyperspace_tpu_torch.analysis.check --write-error-docs regenerates it).
#
# How to read it: HyperspaceError covers the typed framework surface
# (plan validation, admission, timeouts, corruption); OSError covers
# real disk failures AND injected FaultError; CrashPoint is the
# simulated hard death that must NEVER be absorbed below these APIs;
# ValueError/KeyError/NotImplementedError are the programming-error
# surface (bad plans, undeclared counters, abstract hooks).
_QUERY_SURFACE = (
    "HyperspaceError", "OSError", "CrashPoint",
    "ValueError", "KeyError", "NotImplementedError",
)
ERROR_CONTRACTS: dict[str, tuple[str, ...]] = {
    "hyperspace_tpu_torch.hyperspace.HyperspaceSession.run": _QUERY_SURFACE,
    "hyperspace_tpu_torch.hyperspace.HyperspaceSession.run_query": _QUERY_SURFACE,
    # submit emits admission telemetry; the journal's seal path arms the
    # journal.seal fault point (HSL028 torn window), so a simulated hard
    # death there escapes untouched — and stats.increment's KeyError is
    # the declared-counter-registry programming-error surface.
    "hyperspace_tpu_torch.serve.scheduler.QueryServer.submit": (
        "AdmissionRejected", "CrashPoint", "KeyError",
    ),
    "hyperspace_tpu_torch.serve.scheduler.QueryHandle.result": (
        "QueryTimeout", "HyperspaceError", "OSError", "CrashPoint",
    ),
    "hyperspace_tpu_torch.hyperspace.Hyperspace.create_index": _QUERY_SURFACE,
    "hyperspace_tpu_torch.hyperspace.Hyperspace.refresh_index": _QUERY_SURFACE,
    "hyperspace_tpu_torch.hyperspace.Hyperspace.optimize_index": _QUERY_SURFACE,
    "hyperspace_tpu_torch.hyperspace.Hyperspace.vacuum_index": _QUERY_SURFACE,
    "hyperspace_tpu_torch.hyperspace.Hyperspace.recover": _QUERY_SURFACE,
    # explain runs the same planner (and, mode="analyze", the executor)
    # as run(): it shares the full query surface, including lazy
    # recover-on-access fault points reachable from index listing.
    "hyperspace_tpu_torch.hyperspace.Hyperspace.explain": _QUERY_SURFACE,
    "hyperspace_tpu_torch.actions.base.Action.run": _QUERY_SURFACE,
    # Advisor plane. recommend() replays observed plans
    # through the rules/validator (planner surface) and reads the index
    # log; sweep() additionally executes lifecycle actions — individual
    # apply failures are absorbed (recorded, sweep continues), but the
    # recommendation pass, CrashPoint, and policy programming errors
    # escape with the standard query surface.
    "hyperspace_tpu_torch.advisor.whatif.WhatIfAnalyzer.recommend": _QUERY_SURFACE,
    # sweep absorbs per-apply Exceptions (recorded, the sweep continues),
    # so the typed framework surface does not statically escape it — what
    # remains is injected IO faults at advisor.* fault points, CrashPoint,
    # and the programming-error surface.
    "hyperspace_tpu_torch.advisor.lifecycle.LifecyclePolicy.sweep": (
        "OSError", "CrashPoint", "ValueError", "KeyError", "NotImplementedError",
    ),
    # Self-driving operations controller (serve/controller.py). One
    # reconciliation step actuates through the SAME facade methods an
    # operator would call (recover/refresh/lifecycle), so it shares the
    # full query surface: at runtime `_actuate` absorbs per-mutation
    # Exceptions (recorded as controller.actuation_failed, the step
    # continues), but the declared surface stays the honest upper bound
    # on what the actuator lambdas can raise — plus the injected
    # IO-fault surface at the controller.actuate fault point and
    # CrashPoint (a dying process does not keep reconciling).
    "hyperspace_tpu_torch.serve.controller.OpsController.step": _QUERY_SURFACE,
    # Fleet plane. The shared caches
    # are advisory by contract — IO failures are counted and answered
    # with a miss — so what escapes is the injected hard-death surface
    # (CrashPoint via the fleet.* fault points) plus, for the plan
    # cache, the planner surface its cold path runs. Tenant quota
    # admission is exactly one typed rejection. SingleFlight.run's own
    # protocol raises nothing — whatever the caller's build() raises
    # passes through it (the scheduler's contracts cover those).
    # (KeyError is the declared-registry surface: stats.increment raises
    # it for an undeclared counter name — a programming error.)
    # Rejections emit telemetry, so the journal.seal crash surface (and
    # the counter-registry KeyError) rides along with the typed verdict.
    "hyperspace_tpu_torch.serve.fleet.quota.TenantQuotas.admit": (
        "QuotaExceeded", "CrashPoint", "KeyError",
    ),
    "hyperspace_tpu_torch.serve.fleet.singleflight.SingleFlight.run": (
        "OSError", "CrashPoint", "KeyError",
    ),
    "hyperspace_tpu_torch.serve.fleet.shared_cache.SharedResultCache.get": (
        "OSError", "CrashPoint", "KeyError",
    ),
    "hyperspace_tpu_torch.serve.fleet.shared_cache.SharedResultCache.put": (
        "OSError", "CrashPoint", "KeyError",
    ),
    "hyperspace_tpu_torch.serve.fleet.shared_cache.SharedPlanCache.get_or_optimize": _QUERY_SURFACE,
    # Scale-out build worker entry points. These module-level functions ARE process entry
    # points — parallel/procpool.py runs them in spawned workers and the
    # coordinator's typed abort (WorkerFailed/WorkerCrashed) relies on
    # their surface: framework errors and injected IO faults post back
    # through the result queue; CrashPoint deliberately kills the worker
    # (the coordinator's liveness check converts that into WorkerCrashed).
    "hyperspace_tpu_torch.execution.build_exchange.p1_shard": _QUERY_SURFACE,
    "hyperspace_tpu_torch.execution.build_exchange.p2_owner": _QUERY_SURFACE,
    # Continuous-ingestion daemon (ingest/). The writer commits through the SAME facade
    # methods an operator would call (refresh/optimize), so it shares
    # the full query surface. One daemon tick absorbs per-index
    # Exceptions (recorded as ingest.commit_failures /
    # ingest.compact_failures, the loop keeps polling the other
    # watches) — what escapes tick() is injected IO faults at the
    # ingest.* fault points, CrashPoint (a dying daemon does not keep
    # committing), and the programming-error surface. The CDC tailer's
    # poll is a contract of its own: the crash window between a batch
    # file landing and the cursor persisting (the ingest.tail fault
    # point) unwinds through it, and the deterministic batch naming is
    # what makes the retry idempotent. `_service_entry` is the
    # processWorker-mode spawn target (procdomain SPAWN_ENTRY_POINTS):
    # its setup (session rebuild, config replay, watch registration)
    # runs before the absorbing loop, so the full surface applies.
    "hyperspace_tpu_torch.ingest.daemon.IngestDaemon.tick": (
        "OSError", "CrashPoint", "ValueError", "KeyError", "NotImplementedError",
    ),
    "hyperspace_tpu_torch.ingest.tailer.CdcTailer.poll": (
        "OSError", "CrashPoint", "ValueError", "KeyError",
    ),
    "hyperspace_tpu_torch.ingest.daemon._service_entry": _QUERY_SURFACE,
    "hyperspace_tpu_torch.ingest.writer.commit_micro_batch": _QUERY_SURFACE,
    "hyperspace_tpu_torch.ingest.writer.maybe_compact": _QUERY_SURFACE,
}


def is_retryable(exc: BaseException) -> bool:
    """Retryable-exception classification for utils/retry.py: transient
    OS-level IO failures retry; everything else (corruption, missing
    files, programming errors) surfaces immediately."""
    if isinstance(exc, TimeoutError):
        return True
    if isinstance(exc, OSError):
        return exc.errno in TRANSIENT_ERRNOS
    return False


@dataclasses.dataclass(frozen=True)
class PlanDiagnostic:
    """One validator finding, anchored to a plan node.

    `path` is the node's provenance from the plan root — child edges
    joined with "/", e.g. "Join/left:Filter" — so a diagnostic names
    WHERE in the plan tree the problem sits, not just what it is.
    `severity` is "error" (the plan cannot execute correctly) or
    "warning" (legal but almost certainly a mistake or a perf hazard,
    e.g. two index scans bucketed on the join keys with mismatched
    bucket counts, which silently falls off the zero-exchange path).
    """

    rule: str  # e.g. "unresolved-column", "join-bucket-mismatch"
    node: str  # plan node type name, e.g. "Filter"
    path: str  # provenance path from the plan root
    message: str
    severity: str = "error"  # "error" | "warning"

    def __str__(self) -> str:
        return f"[{self.rule}] {self.path or self.node}: {self.message}"


class PlanValidationError(HyperspaceError):
    """A plan failed pre-execution validation (analysis/validator.py).

    Carries the full diagnostic list; the message renders every finding
    with its rule id and node path.
    """

    def __init__(self, diagnostics):
        self.diagnostics = list(diagnostics)
        lines = "\n".join(f"  {d}" for d in self.diagnostics)
        super().__init__(f"plan validation failed:\n{lines}")


class PlanRewriteError(PlanValidationError):
    """An optimizer rewrite (pushdown / column pruning) produced a plan
    that is not equivalent to the original — wrong output schema, a
    reference to a pruned-away column, or a filter pushed beneath the
    null-extended side of an outer join."""

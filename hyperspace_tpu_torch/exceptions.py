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

"""Framework exception types (the subset the port raises).

Reference parity: com/microsoft/hyperspace/HyperspaceException.scala:17-19 —
a single exception class carrying a message, plus the typed corruption
error the scan path raises for unreadable index data and the serving
plane's two typed refusals (`AdmissionRejected`, `QueryTimeout`).
"""

from __future__ import annotations


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

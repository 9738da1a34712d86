"""Streaming delta writer: micro-batch commits and gated compaction.

A port of the JAX package's `ingest/writer.py`. Each micro-batch commits
through the unchanged two-phase action protocol: one
``refresh(name, "incremental")`` a poll tick that saw appended data,
which appends exactly one delta bucket and swaps ``latestStable``
atomically (actions/refresh.py). The daemon adds no commit machinery of
its own: a SIGKILL mid-commit leaves at most the protocol's transient log
entry, and ``recover()`` converges it as it would an operator's refresh.
An empty poll is a no-op, not an error (the refresh action's "no appended
source data files" abort is absorbed here).

Compaction is gated: it fires only when both ``hyperspace.ingest.autoCompact``
and the advisor's ``hyperspace.advisor.lifecycle.autoOptimize`` are on,
only past ``hyperspace.advisor.lifecycle.maxDeltas`` delta buckets, and is
deferred (``ingest.deferred``) while serve SLOs burn.
"""

from __future__ import annotations

from hyperspace_tpu_torch import faults, stats
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.obs import events as obs_events
from hyperspace_tpu_torch.obs import trace as obs_trace

_EVT_COMMITTED = obs_events.declare("ingest.committed")
_EVT_COMPACTED = obs_events.declare("ingest.compacted")

# The refresh action's typed empty-poll abort (actions/refresh.py);
# matched by message so the action's contract stays unchanged.
_EMPTY_POLL = "no appended source data files found"


def _latest_id(session, name: str):
    mgr = session.manager
    return mgr.log_manager_factory(mgr.path_resolver.get_index_path(name)).get_latest_id()


def delta_count(session, name: str) -> int:
    """Version directories in the latest stable entry (compaction pressure)."""
    mgr = session.manager
    entry = mgr.log_manager_factory(mgr.path_resolver.get_index_path(name)).get_latest_stable_log()
    if entry is None or entry.content is None:
        return 0
    return len(entry.content.directories)


def commit_micro_batch(hyperspace, name: str) -> int | None:
    """Commit appended source data as one delta bucket; returns the new
    latest log id, or None when the poll saw nothing new. The committed
    event carries the device the bucket sort ran on."""
    faults.fault_point("ingest.commit")
    try:
        with obs_trace.span("ingest.commit", index=name):
            hyperspace.refresh_index(name, "incremental")
    except HyperspaceError as e:
        if _EMPTY_POLL in str(e):
            return None
        raise
    stats.increment("ingest.commits")
    session = hyperspace.session
    new_id = _latest_id(session, name)
    build = getattr(session, "last_build_stats", None) or {}
    _EVT_COMMITTED.emit(index=name, log_id=new_id, sort_device=build.get("sort_device"))
    return new_id


def maybe_compact(hyperspace, name: str, burning: bool = False) -> bool:
    """Compact delta buckets through the gated optimize action; returns
    True only when a compaction ran."""
    conf = hyperspace.session.conf
    if not (conf.ingest_auto_compact and conf.advisor_auto_optimize):
        return False
    if delta_count(hyperspace.session, name) <= int(conf.advisor_lifecycle_max_deltas):
        return False
    if burning:
        # The controller's backoff discipline: hold rebuild-class IO while
        # serve SLOs burn.
        stats.increment("ingest.deferred")
        return False
    faults.fault_point("ingest.compact")
    with obs_trace.span("ingest.compact", index=name):
        hyperspace.optimize_index(name)
    stats.increment("ingest.compactions")
    _EVT_COMPACTED.emit(index=name, log_id=_latest_id(hyperspace.session, name))
    return True

"""Bounded, severity-leveled structured event ring.

A port of the JAX package's `obs/events.py`. Counters say *how often*;
spans say *how long*; this module records *that something notable
happened* (a submit refused, a burst of result-cache evictions) as one
structured record carrying the active root-trace id (obs/trace.py).

Event names are **declared** in :data:`KNOWN_EVENTS`: instrumented
modules obtain a handle at import time via :func:`declare`, which raises
immediately for an undeclared name, and the handle's ``emit`` never
raises (``QueryServer.submit`` emits inside its narrow error contract).
The port declares only the events its modules emit.

The ring is process-global and bounded (``hyperspace.obs.events
.maxEvents``): old events age out, ``obs.events.dropped`` counts how many
did, ``obs.events.ring_utilization`` shows saturation coming, and memory
stays O(max). Every emitted record also goes to the durable telemetry
journal (obs/journal.py) when it is on.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

from hyperspace_tpu_torch.obs import journal as _journal
from hyperspace_tpu_torch.obs import metrics as _metrics
from hyperspace_tpu_torch.obs import trace as _trace

# Severity order, least to most severe (filter threshold semantics).
SEVERITIES = ("debug", "info", "warn", "error")

# The declared event set: name -> default severity.
KNOWN_EVENTS: dict[str, str] = {
    # Serving plane: admission control refused a submit; queue-depth
    # shedding refused a non-priority submit before the queue filled; the
    # result cache evicted a burst of entries for one put.
    "serve.admission_rejected": "warn",
    "serve.shed": "warn",
    "serve.result_cache.eviction_storm": "warn",
    # Query plane: a query re-planned around unreadable index data, and
    # the index that served it quarantined for the session (hyperspace.py).
    "fallback.replan": "warn",
    "index.quarantined": "warn",
    # Advisor plane (advisor/routing.py): adaptive routing demoted a plan
    # signature to a raw source scan.
    "advisor.routing.demoted": "info",
    # Fleet plane (serve/fleet/): a tenant bounced off its token-bucket
    # quota; a crashed single-flight holder's lease was reaped by another
    # process; the supervisor respawned a dead member, backed off a
    # crash-looping one, or moved its member count.
    "serve.quota_rejected": "warn",
    "fleet.singleflight.takeover": "warn",
    "fleet.worker.restarted": "warn",
    "fleet.worker.crash_loop": "warn",
    "fleet.worker.scaled": "info",
    # The operations controller (serve/controller.py): every decision
    # (`controller.actuation`: action, trigger, outcome), a mutation that
    # raised, background work held while serve SLOs burn, the budget
    # running out (once), and an incident bundle opened or closed.
    "controller.actuation": "info",
    "controller.actuation_failed": "error",
    "controller.backoff": "info",
    "controller.observe_only": "error",
    "controller.incident": "warn",
    # The controller answered a `jit.recompile_storm`: the storming key's
    # signature was pinned to the raw-scan route. The port compiles no
    # jit code and emits no storm of its own; the controller answers one
    # that reaches the ring.
    "controller.storm_response": "warn",
    "jit.recompile_storm": "warn",
    # SLO plane (obs/slo.py): an objective's multi-window burn rate
    # crossed its page threshold.
    "slo.burn": "error",
}

DEFAULT_MAX_EVENTS = 256

_EMITTED = _metrics.counter("obs.events.emitted", "structured events recorded")
_DROPPED = _metrics.counter("obs.events.dropped", "events aged out of the bounded ring")
_UTILIZATION = _metrics.gauge(
    "obs.events.ring_utilization",
    "resident events / ring capacity — saturation visible before drops start",
)

_seq = itertools.count(1)  # itertools.count is GIL-atomic


class _Ring:
    """The bounded ring itself; one process-global instance."""

    def __init__(self, max_events: int = DEFAULT_MAX_EVENTS):
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(maxlen=int(max_events))

    def resize(self, max_events: int) -> None:
        with self._lock:
            self._events = collections.deque(self._events, maxlen=int(max_events))

    def append(self, event: dict) -> None:
        with self._lock:
            if len(self._events) == self._events.maxlen:
                _DROPPED.inc()
            self._events.append(event)
        _EMITTED.inc()

    def recent(self, level: str | None = None, limit: int | None = None) -> list[dict]:
        with self._lock:
            out = list(self._events)
        if level is not None:
            floor = SEVERITIES.index(level)  # unknown level -> ValueError
            out = [e for e in out if SEVERITIES.index(e["severity"]) >= floor]
        if limit is not None:
            out = out[-int(limit):]
        return out

    def counts_by_severity(self) -> dict[str, int]:
        with self._lock:
            out = dict.fromkeys(SEVERITIES, 0)
            for e in self._events:
                out[e["severity"]] += 1
        return out

    def max_events(self) -> int:
        with self._lock:
            return int(self._events.maxlen or 0)

    def utilization(self) -> float:
        with self._lock:
            cap = self._events.maxlen or 0
            return len(self._events) / cap if cap else 0.0

    def clear(self) -> None:
        with self._lock:
            self._events.clear()


RING = _Ring()


class Event:
    """A declared event's emit handle (obtained via :func:`declare` at
    module import). ``emit`` never raises: validation happened at
    declaration."""

    __slots__ = ("name", "severity")

    def __init__(self, name: str, severity: str):
        self.name = name
        self.severity = severity

    def emit(self, severity: str | None = None, **fields) -> dict:
        record = {
            "seq": next(_seq),
            "ts": time.time(),  # wall clock: correlated with external logs
            "name": self.name,
            "severity": severity or self.severity,
            "trace_id": _trace.current_trace_id(),
            "fields": fields,
        }
        RING.append(record)
        _journal.record_event(record)  # durable tap; advisory, never raises
        return record


def declare(name: str) -> Event:
    """The emit handle for a declared event name; an undeclared name
    raises here, at the instrumented module's import."""
    severity = KNOWN_EVENTS.get(name)
    if severity is None:
        raise KeyError(
            f"undeclared event {name!r} — declare it in obs.events.KNOWN_EVENTS "
            f"(declared registries are how silent-typo telemetry dies here)"
        )
    return Event(name, severity)


def recent(level: str | None = None, limit: int | None = None) -> list[dict]:
    """Recorded events, oldest first; `level` keeps events at or above
    that severity, `limit` keeps the newest N."""
    return RING.recent(level=level, limit=limit)


def counts_by_severity() -> dict[str, int]:
    """How many resident ring events sit at each severity (healthz)."""
    return RING.counts_by_severity()


def max_events() -> int:
    """The ring's current bound (config get path)."""
    return RING.max_events()


def refresh_gauges() -> float:
    """Refresh `obs.events.ring_utilization` from the live ring (per
    /metrics scrape and /healthz read). Returns the utilization."""
    u = RING.utilization()
    _UTILIZATION.set(u)
    return u


def configure(max_events: int | None = None) -> None:
    """Adjust the process-global ring (`hyperspace.obs.events.maxEvents`
    routes here). Shrinking keeps the newest events."""
    if max_events is not None:
        RING.resize(max_events)


def reset() -> None:
    """Drop every recorded event and restore the default bound (test
    isolation)."""
    RING.clear()
    RING.resize(DEFAULT_MAX_EVENTS)

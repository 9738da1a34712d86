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
did, and memory stays O(max). The JAX package's durable journal tap is
not ported.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

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
}

DEFAULT_MAX_EVENTS = 256

_EMITTED = _metrics.counter("obs.events.emitted", "structured events recorded")
_DROPPED = _metrics.counter("obs.events.dropped", "events aged out of the bounded ring")

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

    def max_events(self) -> int:
        with self._lock:
            return int(self._events.maxlen or 0)

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


def max_events() -> int:
    """The ring's current bound (config get path)."""
    return RING.max_events()


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

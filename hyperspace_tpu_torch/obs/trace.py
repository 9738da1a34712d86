"""Zero-dependency tracer: nestable spans over a contextvar.

A port of the JAX package's `obs/trace.py`. A :class:`Span` measures one
unit of work (``perf_counter`` wall time on the host), carries free-form
attributes and point-in-time events, and nests: the span active when
another opens becomes its parent. The active span lives in a
:data:`contextvars.ContextVar`, so nesting follows the call stack,
including across thread hops when the submitted task is wrapped with
:func:`wrap` (worker threads start with an empty context; the wrapper
re-plants the caller's active span for the task's duration).

- **Near-zero overhead when disabled.** ``span()``/``trace()`` check one
  module global and return shared no-op singletons: no Span object, no
  attrs dict, no contextvar write. ``hyperspace.obs.enabled`` routes
  here (config.py).
- **Spans always close.** ``__exit__`` runs on ``BaseException`` too, so
  a failure still records ``error=`` and the duration before it
  propagates.
- **Recording needs an active trace.** ``span()`` is a no-op unless some
  enclosing :func:`trace` established a root (``session.run_query`` and
  ``Action.run`` do), so library code calls ``span()`` unconditionally.
- **Host walls.** CUDA launches return before the card finishes, and no
  span waits for the card: a span around a kernel measures its launch.
  The card's own time is `torch.profiler`'s
  (``session.run(plan, profile_dir=...)``).

Finished root traces go to the JSON-lines sink when one is configured
(``hyperspace.obs.sink``), and the last root is kept in-process
(:func:`last_trace`, :func:`recent_roots`); :func:`adopt_root` adds a
worker process's finished root (shipped back as its ``to_json()`` dict by
`parallel/procpool.py`) to both, and every finished root (local or
adopted) to the durable telemetry journal when it is on (obs/journal.py).
"""

from __future__ import annotations

import collections
import contextvars
import itertools
import json
import os
import threading
import time
from typing import Any, Callable

_current: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "hyperspace_torch_obs_span", default=None
)
# Root-trace id of the active trace (None outside one), so events anywhere
# in the tree can cite the ROOT id without a parent-pointer walk.
_trace_id: contextvars.ContextVar["str | None"] = contextvars.ContextVar(
    "hyperspace_torch_obs_trace_id", default=None
)

_enabled = True  # hyperspace.obs.enabled; module-global fast path
_sink_path: str | None = None  # hyperspace.obs.sink; None = no export
_sink_lock = threading.Lock()
_last_trace: "Span | None" = None  # most recently finished ROOT span
# Bounded ring of recently finished root spans: a root span tree is a few
# KB; 32 of them is bounded memory.
RECENT_ROOTS_MAX = 32
_recent_lock = threading.Lock()
_recent_roots: collections.deque = collections.deque(maxlen=RECENT_ROOTS_MAX)
_trace_seq = itertools.count(1)  # itertools.count is GIL-atomic


class Span:
    """One timed unit of work. Use as a context manager; attributes via
    ``set(k=v)`` (chainable), point events via ``add_event``."""

    __slots__ = (
        "name", "attrs", "children", "events", "start_s", "wall_s",
        "error", "tid", "trace_id", "_token",
    )

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.children: list[Span] = []
        self.events: list[dict] = []
        self.start_s: float | None = None
        self.wall_s: float | None = None
        self.error: str | None = None
        self.tid: int | None = None  # OS thread the span ran on
        self.trace_id: str | None = None  # set on ROOT spans only
        self._token = None

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def rename(self, name: str) -> "Span":
        self.name = name
        return self

    def add_event(self, name: str, **attrs) -> None:
        self.events.append({"name": name, **attrs})

    def __enter__(self) -> "Span":
        parent = _current.get()
        if parent is not None:
            # list.append is atomic under the GIL: worker threads
            # re-planted on this parent via wrap() attach children
            # concurrently without a lock.
            parent.children.append(self)
        self._token = _current.set(self)
        self.tid = threading.get_ident()
        self.start_s = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.wall_s = time.perf_counter() - (self.start_s or 0.0)
        if exc is not None and self.error is None:
            self.error = f"{exc_type.__name__}: {exc}"
        _current.reset(self._token)
        return False

    def self_s(self) -> float:
        """Wall time NOT attributed to child spans."""
        own = self.wall_s or 0.0
        return max(0.0, own - sum(c.wall_s or 0.0 for c in self.children))

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()

    def to_json(self) -> dict:
        out: dict[str, Any] = {"name": self.name, "wall_s": self.wall_s}
        if self.start_s is not None:
            out["t0_s"] = self.start_s
        if self.tid is not None:
            out["tid"] = self.tid
        if self.trace_id is not None:
            out["trace_id"] = self.trace_id
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        if self.error is not None:
            out["error"] = self.error
        if self.events:
            out["events"] = list(self.events)
        if self.children:
            out["children"] = [c.to_json() for c in self.children]
        return out


class _NoopSpan:
    """Shared do-nothing span: the disabled/untraced fast path."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NoopSpan":
        return self

    def rename(self, name: str) -> "_NoopSpan":
        return self

    def add_event(self, name: str, **attrs) -> None:
        pass


NOOP = _NoopSpan()


class _TraceHandle:
    """Context manager establishing (or joining) a trace. Entering yields
    the root span; exiting a true root records it as the last trace and
    emits one JSON line to the sink."""

    __slots__ = ("_span", "_is_root", "_id_token")

    def __init__(self, span: Span):
        self._span = span
        self._is_root = False
        self._id_token = None

    def __enter__(self) -> Span:
        self._is_root = _current.get() is None
        if self._is_root:
            # pid-qualified so sink lines from several processes stay
            # distinguishable after aggregation.
            self._span.trace_id = f"{os.getpid()}-{next(_trace_seq)}"
            self._id_token = _trace_id.set(self._span.trace_id)
        return self._span.__enter__()

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._span.__exit__(exc_type, exc, tb)
        if self._is_root:
            global _last_trace
            _last_trace = self._span
            _trace_id.reset(self._id_token)
            with _recent_lock:
                _recent_roots.append(self._span)
            _emit(self._span)
            _journal_root(self._span)
        return False


class _NoopTrace:
    __slots__ = ()

    def __enter__(self) -> _NoopSpan:
        return NOOP

    def __exit__(self, *exc) -> bool:
        return False


_NOOP_TRACE = _NoopTrace()


def enabled() -> bool:
    return _enabled


def set_enabled(on: bool) -> None:
    """`hyperspace.obs.enabled` (config.py routes here). Process-global,
    like the metrics it feeds."""
    global _enabled
    _enabled = bool(on)


def configure(sink: str | None = ...) -> None:
    """Adjust module-global tracer config (`hyperspace.obs.*` keys).
    `sink` is a JSON-lines path receiving one event per finished root
    trace; None disables export."""
    global _sink_path
    if sink is not ...:
        _sink_path = str(sink) if sink else None


def sink_path() -> str | None:
    return _sink_path


def trace(name: str, **attrs):
    """Open a ROOT span (or a plain child span when a trace is already
    active: nested requests don't double-root). No-op when disabled."""
    if not _enabled:
        return _NOOP_TRACE
    return _TraceHandle(Span(name, attrs))


def span(name: str, **attrs):
    """Open a child span under the active trace. Returns the shared
    no-op singleton when disabled or untraced: nothing is allocated."""
    if not _enabled or _current.get() is None:
        return NOOP
    return Span(name, attrs)


def current_span() -> "Span | None":
    return _current.get()


def annotate(**attrs) -> None:
    """Attach attributes to the active span, if any (code that has
    evidence but did not open the span, e.g. a rule recording why it
    failed)."""
    cur = _current.get()
    if cur is not None:
        cur.attrs.update(attrs)


def event(name: str, **attrs) -> None:
    """Record a point-in-time event on the active span. No-op when
    untraced."""
    if not _enabled:
        return
    cur = _current.get()
    if cur is not None:
        cur.add_event(name, **attrs)


def wrap(fn: Callable) -> Callable:
    """Propagate the caller's active span into a worker-thread task.

    Thread-pool workers start with an empty context, so spans opened
    inside them would silently detach; wrapping the submitted callable
    re-plants the submitting thread's active span for the task's
    duration (each task sets and resets its own thread's context)."""
    if not _enabled:
        return fn
    parent = _current.get()
    if parent is None:
        return fn

    def run(*args, **kwargs):
        token = _current.set(parent)
        try:
            return fn(*args, **kwargs)
        finally:
            _current.reset(token)

    return run


def span_from_json(d: dict) -> Span:
    """Rebuild a Span tree from its :meth:`Span.to_json` dict (spans cross
    a process boundary only as dicts)."""
    s = Span(str(d.get("name", "?")), dict(d.get("attrs") or {}))
    s.wall_s = d.get("wall_s")
    s.start_s = d.get("t0_s")
    s.tid = d.get("tid")
    s.trace_id = d.get("trace_id")
    s.error = d.get("error")
    s.events = list(d.get("events") or [])
    s.children = [span_from_json(c) for c in d.get("children") or ()]
    return s


def adopt_root(root: "dict | None") -> None:
    """Adopt a worker process's finished root span, shipped back as its
    ``to_json()`` dict, into this process's recent-root ring and sink. The
    root keeps its own pid-qualified trace_id. Never raises on a malformed
    dict (adoption is telemetry, not control flow)."""
    if not _enabled or not root:
        return
    try:
        span = span_from_json(root)
    except (TypeError, ValueError, AttributeError):
        return
    with _recent_lock:
        _recent_roots.append(span)
    _emit(span)
    _journal_root(span)


def _journal_root(span: "Span") -> None:
    """Durable tap: completed root spans (local and adopted) also land
    in the telemetry journal (obs/journal.py). The journal is advisory
    and off by default; `to_json` is only paid when it is on."""
    from hyperspace_tpu_torch.obs import journal as _journal

    if _journal.enabled():
        _journal.record_span(span.to_json())


def last_trace() -> "Span | None":
    """The most recently finished root span (None before the first)."""
    return _last_trace


def current_trace_id() -> "str | None":
    """The active root trace's id (None outside a trace): the
    correlation key structured events carry (obs/events.py)."""
    return _trace_id.get()


def recent_roots(limit: int | None = None) -> "list[Span]":
    """The most recently finished root spans, oldest first (bounded at
    RECENT_ROOTS_MAX)."""
    with _recent_lock:
        roots = list(_recent_roots)
    return roots if limit is None else roots[-int(limit):]


def reset() -> None:
    """Drop the last trace, recent roots, and sink config (test
    isolation)."""
    global _last_trace, _sink_path
    _last_trace = None
    _sink_path = None
    with _recent_lock:
        _recent_roots.clear()


def _emit(root: Span) -> None:
    """Append one JSON line per finished root trace to the sink. Export
    must never fail a query: errors are swallowed."""
    if _sink_path is None:
        return
    # Wall-clock stamp (not a duration): sink lines are correlated with
    # external logs, which speak wall time.
    line = json.dumps({"ts": time.time(), "trace": root.to_json()}, default=str)
    try:
        with _sink_lock, open(_sink_path, "a") as f:
            f.write(line + "\n")
    except OSError:
        pass

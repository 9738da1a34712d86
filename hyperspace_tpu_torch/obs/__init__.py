"""Query-plane observability: tracing spans, metrics, per-query profiles.

A port of the JAX package's `obs/` for the serving plane:

- **trace**: nestable spans (``span("execute.Join")``) threaded through
  ``session.run_query``, rule application, the executor's operator
  dispatch, parquet reads, the kernel launches and the action lifecycle;
  a no-op singleton when ``hyperspace.obs.enabled`` is false;
- **metrics**: the declared registry of counters, gauges and bounded
  histograms (``hyperspace_tpu_torch.stats`` is a facade over it);
- **events**: the bounded ring of structured events;
- **profile**: the per-query :class:`~hyperspace_tpu_torch.obs.profile.QueryProfile`
  that ``session.last_profile()`` returns and ``explain(mode="analyze")``
  renders.

The runtime health plane on top:

- **journal**: a durable, bounded, crash-safe JSONL journal of events,
  root spans, SLO transitions and metrics snapshots, one ``<root>/<pid>/``
  directory a process (``hyperspace.obs.journal.*``);
- **slo**: declared objectives (availability, p99 latency) with
  multi-window error-budget burn rates;
- **runtime**: the process gauges ``proc.map_count`` and
  ``proc.rss_watermark.bytes`` (the JAX package's jit accounting has no
  counterpart: the port compiles nothing at run time);
- **export**: Prometheus text and Chrome traces
  (``python -m hyperspace_tpu_torch.obs.export``);
- **http**: ``/metrics``, ``/healthz``, ``/debug/events``,
  ``/debug/trace`` and ``/debug/incidents`` on a stdlib server riding the
  QueryServer's lifecycle (``hyperspace.obs.http.*``).

Times are host walls; the card's time is `torch.profiler`'s.
"""

from hyperspace_tpu_torch.obs import events, journal, metrics, runtime, slo, trace
from hyperspace_tpu_torch.obs.trace import annotate, current_span, event, set_enabled, span

__all__ = [
    "annotate",
    "current_span",
    "event",
    "events",
    "journal",
    "metrics",
    "runtime",
    "set_enabled",
    "slo",
    "span",
    "trace",
]

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

Times are host walls; the card's time is `torch.profiler`'s. The JAX
package's journal, SLOs, HTTP health plane, export and runtime
introspection are not ported.
"""

from hyperspace_tpu_torch.obs import events, metrics, trace
from hyperspace_tpu_torch.obs.trace import annotate, current_span, event, set_enabled, span

__all__ = ["annotate", "current_span", "event", "events", "metrics", "set_enabled", "span", "trace"]

"""Declared SLO objectives with multi-window burn-rate tracking.

A port of the JAX package's `obs/slo.py`: the same objectives, windows,
thresholds and arithmetic, so the same counter samples give the same
burn rates and verdicts in both packages. The serving tier's ROADMAP contract — "bounded p99, typed rejections,
never collapse" — is only checkable at runtime if the process itself
computes how fast it is consuming its error budget. This module does
the standard SRE multi-window burn-rate math over the *already
declared* serve metrics (obs/metrics.py):

- **availability** — of the queries the scheduler admitted, the
  fraction that completed (failures, timeouts, and shutdown
  cancellations spend budget);
- **p99 latency** — the fraction of served queries finishing under the
  configured threshold must stay ≥ 0.99 (the threshold maps onto the
  latency histogram's bucket bounds, so "good" counts come straight
  from the cumulative bucket counts).

Objectives are **declared** in :data:`KNOWN_OBJECTIVES`, exactly like
``stats.KNOWN_COUNTERS``: asking the tracker about an undeclared
objective raises, so a typo'd dashboard query dies loudly instead of
silently reporting a healthy nothing.

Burn rate = (bad fraction over a window) / (1 - target). 1.0 means
"spending budget exactly as fast as the SLO allows"; the classic page
condition is a *pair* of windows burning fast simultaneously (the long
window proves it is real, the short window proves it is still
happening). The tracker keeps a bounded ring of cumulative-counter
samples and differences windows out of it; scrapes (obs/http.py) drive
sampling, so a process that nobody watches spends nothing.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import threading
import time

from hyperspace_tpu_torch.obs import events as _events
from hyperspace_tpu_torch.obs import journal as _journal
from hyperspace_tpu_torch.obs import metrics as _metrics

# Default objective targets (`hyperspace.obs.slo.*` keys override).
DEFAULT_AVAILABILITY_TARGET = 0.999
DEFAULT_LATENCY_P99_SECONDS = 1.0
LATENCY_TARGET_RATIO = 0.99  # "p99 under threshold" as a good-ratio SLO

# Multi-window verdict pairs (seconds, burn threshold): page when BOTH
# windows of the page pair burn above 14.4 (i.e. a 99.9% budget gone in
# ~2 days), warn when both warn windows burn above 6. Windows clamp to
# the observed sample span — a young process judges on what it has.
PAGE_WINDOWS = ((60.0, 14.4), (600.0, 14.4))
WARN_WINDOWS = ((300.0, 6.0), (3600.0, 6.0))

KNOWN_OBJECTIVES: dict[str, str] = {
    "serve.availability": "admitted queries that completed (vs failed/timed out/cancelled)",
    "serve.latency_p99": "served queries finishing under the configured latency threshold",
}

_EVT_BURN = _events.declare("slo.burn")


@dataclasses.dataclass(frozen=True)
class _Sample:
    t: float
    good: float
    total: float


class BurnRate:
    """Per-objective sample ring + window math."""

    def __init__(self, name: str, target: float, max_samples: int = 512):
        self.name = name
        self.target = float(target)
        self._lock = threading.Lock()
        self._samples: collections.deque = collections.deque(maxlen=int(max_samples))

    def add(self, good: float, total: float, now: float) -> None:
        with self._lock:
            self._samples.append(_Sample(float(now), float(good), float(total)))

    def window_burn(self, window_s: float, now: float | None = None) -> float | None:
        """Burn rate over the trailing window (None with <2 samples or
        no traffic in the window). Windows clamp to the observed span."""
        with self._lock:
            samples = list(self._samples)
        if len(samples) < 2:
            return None
        if now is None:
            now = samples[-1].t
        # Oldest sample still inside the window (clamped to what we
        # have): cumulative counters difference out to window deltas.
        times = [s.t for s in samples]
        i = bisect.bisect_left(times, now - window_s)
        base, head = samples[min(i, len(samples) - 2)], samples[-1]
        total = head.total - base.total
        if total <= 0:
            return None
        good = head.good - base.good
        bad_fraction = max(0.0, 1.0 - good / total)
        budget = 1.0 - self.target
        if budget <= 0:
            return float("inf") if bad_fraction > 0 else 0.0
        return bad_fraction / budget

    def verdict(self, now: float | None = None) -> dict:
        """{"verdict": ok|warn|page, "windows": {label: burn|None}}."""
        windows: dict[str, float | None] = {}

        def burns(pairs) -> list:
            out = []
            for w, threshold in pairs:
                b = self.window_burn(w, now=now)
                windows[f"{int(w)}s"] = b
                out.append((b, threshold))
            return out

        page = burns(PAGE_WINDOWS)
        warn = burns(WARN_WINDOWS)
        verdict = "ok"
        if all(b is not None and b >= t for b, t in warn):
            verdict = "warn"
        if all(b is not None and b >= t for b, t in page):
            verdict = "page"
        return {"verdict": verdict, "target": self.target, "windows": windows}

    def reset(self) -> None:
        with self._lock:
            self._samples.clear()


class SLOTracker:
    """The process-global tracker over the declared objectives."""

    def __init__(self):
        self._lock = threading.Lock()
        self.availability_target = DEFAULT_AVAILABILITY_TARGET
        self.latency_threshold_s = DEFAULT_LATENCY_P99_SECONDS
        self._rates = {
            "serve.availability": BurnRate("serve.availability", DEFAULT_AVAILABILITY_TARGET),
            "serve.latency_p99": BurnRate("serve.latency_p99", LATENCY_TARGET_RATIO),
        }
        # Burn gauges so a plain /metrics scrape carries the computed
        # short-window burn rate per objective (-1 = not yet computable).
        self._gauges = {
            name: _metrics.gauge(
                f"slo.{name}.burn_rate",
                f"short-window error-budget burn rate: {doc} (-1 until computable)",
            )
            for name, doc in KNOWN_OBJECTIVES.items()
        }
        self._paged: set[str] = set()
        # Last verdict per objective — the journal records verdict
        # TRANSITIONS only (ok→page, page→ok, …), not every evaluate.
        self._last_verdict: dict[str, str] = {}

    def objective(self, name: str) -> BurnRate:
        """The tracker for a DECLARED objective; undeclared names raise
        (the registry contract KNOWN_COUNTERS established)."""
        rate = self._rates.get(name)
        if rate is None:
            raise KeyError(
                f"undeclared SLO objective {name!r} — declare it in "
                f"obs.slo.KNOWN_OBJECTIVES (undeclared objectives reporting "
                f"healthy nothings is the failure mode this registry removes)"
            )
        return rate

    def configure(
        self,
        availability_target: float | None = None,
        latency_threshold_s: float | None = None,
    ) -> None:
        with self._lock:
            if availability_target is not None:
                self.availability_target = float(availability_target)
                self._rates["serve.availability"].target = float(availability_target)
            if latency_threshold_s is not None:
                self.latency_threshold_s = float(latency_threshold_s)

    def sample(self, now: float | None = None) -> None:
        """Record one cumulative sample per objective from the live
        serve metrics. Driven by /metrics and /healthz scrapes; cheap
        enough to run per scrape."""
        if now is None:
            now = time.monotonic()
        reg = _metrics.REGISTRY
        completed = _counter_value(reg, "serve.completed")
        failed = _counter_value(reg, "serve.failed")
        timeouts = _counter_value(reg, "serve.timeouts")
        cancelled = _counter_value(reg, "serve.cancelled")
        total = completed + failed + timeouts + cancelled
        self._rates["serve.availability"].add(completed, total, now)
        good, count = self._latency_good(reg)
        self._rates["serve.latency_p99"].add(good, count, now)

    def _latency_good(self, reg) -> tuple[float, float]:
        """(queries under the threshold, all queries) from the latency
        histogram's cumulative bucket counts. The threshold maps to the
        largest bucket bound at or below it — conservative: a query
        counts as "good" only when its bucket proves it finished under
        the threshold."""
        hist = reg.get("serve.latency.seconds")
        if hist is None or hist.kind != "histogram":
            return 0.0, 0.0
        with self._lock:
            threshold = self.latency_threshold_s
        good = 0
        for le, cum in hist.bucket_counts():
            if le > threshold:
                break
            good = cum
        return float(good), float(hist.count)

    def evaluate(self, now: float | None = None) -> dict:
        """Verdicts for every declared objective; updates the burn
        gauges and emits one ``slo.burn`` event per fresh page verdict
        (re-armed when the objective recovers)."""
        out: dict[str, dict] = {}
        for name in sorted(KNOWN_OBJECTIVES):
            rate = self._rates[name]
            v = rate.verdict(now=now)
            short = next(iter(v["windows"].values()))
            self._gauges[name].set(short if short is not None else -1.0)
            with self._lock:
                fresh_page = v["verdict"] == "page" and name not in self._paged
                if v["verdict"] == "page":
                    self._paged.add(name)
                else:
                    self._paged.discard(name)
                previous = self._last_verdict.get(name, "ok")
                self._last_verdict[name] = v["verdict"]
            if fresh_page:
                _EVT_BURN.emit(objective=name, **{k: w for k, w in v["windows"].items()})
            if previous != v["verdict"]:
                # Durable tap: the page AND the recovery land in the
                # telemetry journal (obs/journal.py) — the incident
                # bundle's evidence that the burn happened and ended.
                _journal.record_slo(name, v["verdict"], previous,
                                    detail={"windows": v["windows"]})
            out[name] = v
        return out

    def reset(self) -> None:
        with self._lock:
            self.availability_target = DEFAULT_AVAILABILITY_TARGET
            self.latency_threshold_s = DEFAULT_LATENCY_P99_SECONDS
            self._paged.clear()
            self._last_verdict.clear()
        for name, rate in self._rates.items():
            rate.reset()
            rate.target = (
                DEFAULT_AVAILABILITY_TARGET
                if name == "serve.availability"
                else LATENCY_TARGET_RATIO
            )


def _counter_value(reg, name: str) -> float:
    m = reg.get(name)
    return float(m.value) if m is not None else 0.0


TRACKER = SLOTracker()


def objective(name: str) -> BurnRate:
    return TRACKER.objective(name)


def sample(now: float | None = None) -> None:
    TRACKER.sample(now=now)


def evaluate(now: float | None = None) -> dict:
    return TRACKER.evaluate(now=now)


def configure(**kwargs) -> None:
    TRACKER.configure(**kwargs)


def reset() -> None:
    """Restore targets and drop sample history (test isolation)."""
    TRACKER.reset()

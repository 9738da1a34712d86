"""Declared process-wide metrics registry: counters, gauges, histograms.

A copy of the JAX package's `obs/metrics.py`. Metrics are **declared**
before use, and re-declaring a name with another kind raises. The
registry is process-global and thread-safe, matching the process-global
caches and device state it describes.

Histograms are **bounded**: fixed bucket boundaries chosen at
declaration, constant memory regardless of observation count, with
p50/p95/p99 estimated by linear interpolation inside the owning bucket
(the Prometheus classic-histogram model).

Stdlib-only, so that `stats.py` and the serving plane import it without
torch.
"""

from __future__ import annotations

import bisect
import threading

# Shared bucket presets (upper bounds; +Inf is implicit).
SECONDS_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 120.0,
)
BYTES_BUCKETS = tuple(float(1 << s) for s in range(10, 37, 2))  # 1 KiB .. 64 GiB
COUNT_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 1024.0, 4096.0)


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "help", "_value", "_lock")

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0

    def snapshot(self):
        return self._value


class Gauge:
    """Point-in-time value (cache bytes, live entries)."""

    __slots__ = ("name", "help", "_value", "_lock")

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def add(self, v: float) -> None:
        with self._lock:
            self._value += v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0.0

    def snapshot(self):
        with self._lock:
            return self._value


class Histogram:
    """Bounded histogram over fixed bucket upper bounds (+Inf implicit).

    Memory is O(len(bounds)) forever. Quantiles interpolate linearly
    within the owning bucket, using the observed min/max to tighten the
    first and last buckets (so a distribution narrower than its bucket
    does not smear across it)."""

    __slots__ = ("name", "help", "bounds", "_counts", "_sum", "_count", "_min", "_max", "_lock")

    kind = "histogram"

    def __init__(self, name: str, help: str = "", buckets: tuple = SECONDS_BUCKETS):
        self.name = name
        self.help = help
        self.bounds = tuple(sorted(float(b) for b in buckets))
        self._counts = [0] * (len(self.bounds) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0
        self._min: float | None = None
        self._max: float | None = None
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> float | None:
        """Estimated q-quantile (0..1); None when empty."""
        with self._lock:
            if self._count == 0:
                return None
            target = q * self._count
            seen = 0.0
            for i, c in enumerate(self._counts):
                if c == 0:
                    continue
                lo = self.bounds[i - 1] if i > 0 else (self._min or 0.0)
                hi = self.bounds[i] if i < len(self.bounds) else (self._max or lo)
                lo = max(lo, self._min or lo)
                hi = min(hi, self._max or hi) if self._max is not None else hi
                if seen + c >= target:
                    frac = (target - seen) / c
                    return lo + (hi - lo) * max(0.0, min(1.0, frac))
                seen += c
            return self._max

    def percentiles(self) -> dict:
        return {
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }

    def _reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.bounds) + 1)
            self._sum = 0.0
            self._count = 0
            self._min = None
            self._max = None

    def snapshot(self):
        with self._lock:
            out = {"count": self._count, "sum": self._sum}
        out.update(self.percentiles())
        return out

    def bucket_counts(self) -> list[tuple[float, int]]:
        """Cumulative (le, count) pairs, Prometheus classic style."""
        out = []
        cum = 0
        with self._lock:
            for b, c in zip(self.bounds, self._counts):
                cum += c
                out.append((b, cum))
            out.append((float("inf"), cum + self._counts[-1]))
        return out


class MetricsRegistry:
    """Name → metric map with declare-or-get semantics. Re-declaring a
    name with a different kind is a bug and raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def _declare(self, cls, name: str, help: str, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already declared as {m.kind}, not {cls.kind}"
                    )
                return m
            m = cls(name, help, **kwargs)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._declare(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._declare(Gauge, name, help)

    def histogram(self, name: str, help: str = "", buckets: tuple = SECONDS_BUCKETS) -> Histogram:
        return self._declare(Histogram, name, help, buckets=buckets)

    def get(self, name: str):
        """The declared metric, or None."""
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def collect(self) -> list:
        """Stable-ordered list of all declared metrics (export API)."""
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def snapshot(self) -> dict:
        """Point-in-time {name: value | histogram summary}."""
        return {m.name: m.snapshot() for m in self.collect()}

    def reset(self) -> None:
        """Zero every metric, keeping declarations (test isolation)."""
        for m in self.collect():
            m._reset()


REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "") -> Counter:
    return REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return REGISTRY.gauge(name, help)


def histogram(name: str, help: str = "", buckets: tuple = SECONDS_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help, buckets=buckets)

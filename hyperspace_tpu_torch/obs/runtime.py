"""Process-health gauges: memory mappings and the peak resident set.

A port of the process gauges of the JAX package's `obs/runtime.py`:
``proc.map_count`` (this process's memory mappings, /proc/self/maps)
and ``proc.rss_watermark.bytes`` (peak RSS), refreshed per /metrics
scrape and /healthz read (obs/http.py).

Left out: the JAX package's per-call-site jit compile accounting and its
``jit.recompile_storm`` detector, with the ``jit.live_executables``
gauge. They watch XLA's jit cache; the port compiles nothing at run
time (its kernels are built once, by a hash of their source,
ops/kernels.py), so there is no cache to watch. The port's /healthz
document therefore has no ``jit`` section, and an incident bundle no
``jit.json``.

Stdlib-only: no torch.
"""

from __future__ import annotations

from hyperspace_tpu_torch.obs import metrics as _metrics

_MAP_COUNT = _metrics.gauge("proc.map_count", "memory mappings of this process (/proc/self/maps)")
_RSS_WATERMARK = _metrics.gauge("proc.rss_watermark.bytes", "peak resident set size")


def map_count() -> int:
    """Memory mappings of this process (0 where /proc is unreadable)."""
    try:
        with open("/proc/self/maps", "rb") as f:
            return sum(1 for _ in f)
    except OSError:
        return 0


def refresh_process_gauges() -> dict:
    """Re-sample the process-health gauges and return their values.
    Called by the /metrics scrape path and the /healthz read."""
    maps = map_count()
    rss = _rss_watermark_bytes()
    _MAP_COUNT.set(maps)
    if rss:
        _RSS_WATERMARK.set(rss)
    return {"map_count": maps, "rss_watermark_bytes": rss}


def _rss_watermark_bytes() -> int:
    """Peak RSS in bytes (ru_maxrss is KiB on Linux); 0 where
    unavailable."""
    try:
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except (ImportError, ValueError, OSError):
        return 0

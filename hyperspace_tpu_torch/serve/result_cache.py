"""Opt-in result cache: identical repeat queries skip execution outright.

A port of the JAX package's `serve/result_cache.py`. Values are whole
:class:`~hyperspace_tpu_torch.execution.table.ColumnTable` results under
the same versioned keys as the plan cache (serve/plan_cache.py): plan
signature + source-data fingerprint + index log versions + enablement. A
refresh (or any index mutation, or a source append) bumps the stamp, so
every entry cached before it becomes unreachable: there is no epoch to
bump and no window where a stale row can hit.

Opt-in (`hyperspace.serve.resultCache.enabled`, default false) because
caching results pins memory per distinct query: on the card, device
memory outside `DEVICE_CACHE`'s budget. Entries are LRU-evicted past
`maxBytes`, and a single result larger than a quarter of the budget is
never admitted.

Cached tables are returned by reference to every hit. Torch tensors,
unlike the JAX package's arrays, can be written in place, so an entry
also records the version counter of every tensor it holds: a hit whose
tensors were written since `put` is a miss, and the entry is dropped
(the same guard `HOST_DERIVED` keys on, execution/device_cache.py).
"""

from __future__ import annotations

import threading

from hyperspace_tpu_torch.execution.device_cache import table_footprint_bytes
from hyperspace_tpu_torch.obs import events as obs_events
from hyperspace_tpu_torch.obs import metrics as obs_metrics
from hyperspace_tpu_torch.serve.plan_cache import versioned_plan_key

# One admission flushing this many resident entries is a storm: the budget
# is far too small for the workload or one huge result is churning the
# whole cache.
EVICTION_STORM_THRESHOLD = 8
_EVT_EVICTION_STORM = obs_events.declare("serve.result_cache.eviction_storm")
_HITS = obs_metrics.counter("serve.result_cache.hits", "result cache hits")
_MISSES = obs_metrics.counter("serve.result_cache.misses", "result cache misses")
_EVICTIONS = obs_metrics.counter("serve.result_cache.evictions", "LRU evictions")
_WRITTEN = obs_metrics.counter(
    "serve.result_cache.written", "entries dropped because a tensor was written in place"
)
_BYTES = obs_metrics.gauge("serve.result_cache.bytes", "resident result bytes")


def table_nbytes(table) -> int:
    """Resident bytes of a ColumnTable: its tensors' bytes (device bytes
    for a table on the card) and its dictionaries' character payload."""
    return table_footprint_bytes(table)


def _versions(table) -> tuple:
    """(id, version counter) of every tensor the table holds."""
    return tuple(
        (id(t), t._version)
        for t in (*table.columns.values(), *table.validity.values())
    )


class ResultCache:
    """Bounded LRU of query results keyed by versioned plan key."""

    def __init__(self, max_bytes: int = 256 << 20):
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        # key -> (nbytes, table, tensor versions at put)
        self._entries: dict[tuple, tuple[int, object, tuple]] = {}
        self._bytes = 0
        # This cache's counts (stats()); the registry's serve.result_cache.*
        # counters are the process's, over every instance.
        self.hits = self.misses = self.evictions = self.written = 0

    def key(self, session, plan) -> tuple:
        return versioned_plan_key(session, plan)

    def get(self, key: tuple):
        """The cached result for `key`, or None (counted as hit/miss). An
        entry whose tensors were written in place since `put` is dropped
        and counts as a miss."""
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None and _versions(hit[1]) != hit[2]:
                del self._entries[key]
                self._bytes -= hit[0]
                _BYTES.set(self._bytes)
                self.written += 1
                _WRITTEN.inc()
                hit = None
            if hit is not None:
                self._entries[key] = self._entries.pop(key)  # LRU touch
                self.hits += 1
                _HITS.inc()
                return hit[1]
            self.misses += 1
            _MISSES.inc()
            return None

    def put(self, key: tuple, table) -> bool:
        """Admit `table` under `key`; False when it is too large to cache
        (more than a quarter of the byte budget) or already present."""
        nb = table_nbytes(table)
        if nb > self.max_bytes // 4:
            return False
        evicted = 0
        with self._lock:
            if key in self._entries:
                return False
            self._entries[key] = (nb, table, _versions(table))
            self._bytes += nb
            while self._bytes > self.max_bytes and len(self._entries) > 1:
                k = next(iter(self._entries))  # oldest = least recently used
                old_nb = self._entries.pop(k)[0]
                self._bytes -= old_nb
                evicted += 1
            self.evictions += evicted
            _BYTES.set(self._bytes)
        if evicted:
            _EVICTIONS.inc(evicted)
            if evicted >= EVICTION_STORM_THRESHOLD:
                _EVT_EVICTION_STORM.emit(evicted=evicted, admitted_bytes=nb)
        return True

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0
            _BYTES.set(0)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "written": self.written,
            }

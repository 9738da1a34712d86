"""Optimized-plan cache: repeat queries skip `optimized_plan()` entirely.

A port of the JAX package's `serve/plan_cache.py`. Plan optimization is
host work (rule matching, index-log reads, pushdown and pruning
rewrites) that runs once per query; for point lookups it can cost more
than the (cached, device-resident) execution. This cache memoizes the
output of `HyperspaceSession.optimized_plan` under a versioned key, so
invalidation is structural rather than event-driven:

    (plan signature,            # canonical-JSON MD5 of the logical plan
     data fingerprint,          # (size, mtime, path) fold of source files
     index log versions,        # (index dir, latest log id) per index
     hyperspace enabled?)

Every mutating index API commits by writing a new log entry, so the
latest log id bumps and old keys never hit again; appended or rewritten
source files change the data fingerprint the same way. The LRU bound only
caps memory.

Left out until the port has what they key on: the quarantine set (the
corruption fallback's `index_health`, ROADMAP queue 1 item 6) and the
pinned snapshot stamp (ingestion, queue 1 item 8). The counters are plain
ints (`stats()`); the JAX package's metrics registry is not ported.
"""

from __future__ import annotations

import threading

from hyperspace_tpu_torch.metadata.log_manager import IndexLogManager
from hyperspace_tpu_torch.signature import FileBasedSignatureProvider, plan_signature


def collection_log_versions(session) -> tuple:
    """(index dir name, latest log id) per index under the system path:
    the metadata-plane stamp every versioned key embeds. Any committed
    index mutation writes a new log entry and bumps it."""
    mgr = session.manager
    return tuple((d.name, IndexLogManager(d).get_latest_id()) for d in mgr.path_resolver.list_index_paths())


def versioned_plan_key(session, plan) -> tuple:
    """The cache key for `plan` under `session`'s current state (module
    docstring). Stat-ing the source files costs one os.stat a file, far
    less than re-optimizing, and makes a hit after an append or a refresh
    impossible."""
    fp = FileBasedSignatureProvider().signature(plan)
    return (
        plan_signature(plan),
        fp.value if fp is not None else None,
        collection_log_versions(session),
        session.is_hyperspace_enabled(),
    )


class PlanCache:
    """Bounded LRU of optimized logical plans keyed by versioned plan key.
    Cached plans are shared across threads: plan nodes are not changed
    after construction (the optimizer builds new trees, the executor only
    reads them)."""

    def __init__(self, max_entries: int = 128):
        self.max_entries = int(max_entries)
        self._lock = threading.Lock()
        self._entries: dict[tuple, object] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get_or_optimize(self, session, plan):
        """The optimized plan for `plan`, from the cache when the versioned
        key matches, else freshly via `session.optimized_plan` (outside the
        lock: optimization reads the index log and stats files)."""
        key = versioned_plan_key(session, plan)
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries[key] = self._entries.pop(key)  # LRU touch
                self.hits += 1
                return hit
            self.misses += 1
        optimized = session.optimized_plan(plan)
        with self._lock:
            if key not in self._entries:
                self._entries[key] = optimized
                while len(self._entries) > self.max_entries:
                    self._entries.pop(next(iter(self._entries)))
                    self.evictions += 1
        return optimized

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions}

"""Disk-backed shared plan/result cache: one cache, N serving processes.

A port of the JAX package's `serve/fleet/shared_cache.py`, with the same
entry names (``md5(repr(key))``) and formats (Arrow IPC results,
canonical plan JSON), so an entry one package publishes under a key the
other reads back. On the card a result crosses the process boundary
through the host: `put` copies its tensors down (`ColumnTable.to_arrow`)
and `get` uploads the entry to the cache's device
(`ColumnTable.from_arrow(..., device=)`).

The in-process serve caches (serve/plan_cache.py, serve/result_cache.py)
already solved invalidation the only way that scales to a fleet:
**versioned keys** — plan signature × source-file fingerprint ×
per-index latest-log-id stamp × quarantine snapshot × enablement. This
module reuses those exact keys for entries that live on SHARED DISK, so
the guarantee crosses process boundaries for free: when any process
commits an index mutation (refresh/optimize/create/...), the log id it
bumps is part of every other process's lookup key — the pre-mutation
entries are not flushed, they become *unreachable* in every process at
once. There is no invalidation message to broadcast and no window in
which process B can serve what process A made stale.

Mechanics (PAPER.md L3's `CachingIndexCollectionManager` is the
single-host ancestor of this: many sessions, one catalog):

- **Entries are content-addressed files**: ``md5(repr(key))`` names the
  entry, results as Arrow IPC files (read back zero-copy via
  ``pa.memory_map`` — N processes share one page-cache copy), optimized
  plans as canonical JSON (`plan_from_json` round-trips them).
- **Atomic publication**: write to a same-directory temp file, fsync,
  ``os.replace`` — a reader sees a whole entry or no entry, never a torn
  one (the metadata plane's write_json discipline).
- **Byte-budgeted eviction under a cross-process file lease**
  (fleet/lease.py): whichever process notices the budget exceeded takes
  the eviction lease and removes oldest-mtime entries; the lease keeps
  two processes from racing the scan, and a crashed evictor's lease is
  reaped after its TTL.
- **Advisory by contract**: every IO failure is counted
  (`fleet.shared_cache.errors`) and answered with a miss — a broken
  shared cache degrades the fleet to per-process work, never to a
  failed query.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from pathlib import Path

from hyperspace_tpu_torch import stats
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.faults import fault_point
from hyperspace_tpu_torch.serve.fleet.lease import FileLease
from hyperspace_tpu_torch.serve.fleet.singleflight import SingleFlight, key_name
from hyperspace_tpu_torch.serve.plan_cache import versioned_plan_key

EVICT_LEASE_NAME = "evict.lease"


class _SharedCacheBase:
    """Directory + budget + lease-held eviction, shared by both caches."""

    suffix = ".bin"

    def __init__(self, root: str | Path, max_bytes: int, lease_ttl_s: float = 10.0):
        self.root = Path(root)
        self.max_bytes = int(max_bytes)
        self.lease_ttl_s = float(lease_ttl_s)
        self.root.mkdir(parents=True, exist_ok=True)

    def entry_path(self, key: tuple) -> Path:
        return self.root / f"{key_name(key)}{self.suffix}"

    def _publish(self, path: Path, data: bytes) -> None:
        """Atomic same-directory publish; the entry appears whole or not
        at all. Raises OSError to the (advisory) caller."""
        fault_point("fleet.cache.write", path)
        fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=".tmp-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def _entries(self) -> list[tuple[float, int, Path]]:
        """(mtime, size, path) of every resident entry, oldest first."""
        out = []
        try:
            for p in self.root.iterdir():
                if p.suffix != self.suffix:
                    continue
                st = p.stat()
                out.append((st.st_mtime, st.st_size, p))
        except OSError:
            return []
        out.sort()
        return out

    def _maybe_evict(self) -> int:
        """Evict oldest entries past the byte budget, under the
        cross-process eviction lease. Advisory: lease contention or IO
        failure just leaves eviction to the next put. Returns the number
        of entries removed."""
        entries = self._entries()
        total = sum(size for _, size, _ in entries)
        if total <= self.max_bytes:
            return 0
        lease = FileLease(self.root / EVICT_LEASE_NAME, self.lease_ttl_s)
        claim = lease.try_acquire()
        if claim is None:
            return 0  # another process is already evicting
        token, _ = claim
        evicted = 0
        try:
            for _, size, path in entries:
                if total <= self.max_bytes:
                    break
                try:
                    fault_point("fleet.cache.evict", path)
                    os.unlink(path)
                except OSError:
                    stats.increment("fleet.shared_cache.errors")
                    continue
                total -= size
                evicted += 1
        finally:
            lease.release(token)
        if evicted:
            stats.increment("fleet.shared_cache.evictions", evicted)
        return evicted

    def stats(self) -> dict:
        entries = self._entries()
        return {"entries": len(entries), "bytes": sum(s for _, s, _ in entries)}

    def clear(self) -> None:
        for _, _, p in self._entries():
            try:
                os.unlink(p)
            except OSError:
                pass


class SharedResultCache(_SharedCacheBase):
    """Whole-result cache on shared disk: ColumnTables as Arrow IPC
    files under versioned plan keys. Drop-in for the in-process
    `ResultCache` in `QueryServer` (same key/get/put surface); with a
    `SingleFlight`, a fleet-wide cold miss executes ONCE (the scheduler
    wires `single_flight` through `_execute`)."""

    suffix = ".arrow"

    def __init__(
        self,
        root: str | Path,
        max_bytes: int = 1 << 30,
        lease_ttl_s: float = 10.0,
        single_flight: SingleFlight | None = None,
        device=None,
    ):
        from hyperspace_tpu_torch.device import resolve_device

        super().__init__(root, max_bytes, lease_ttl_s)
        self.single_flight = single_flight
        # Where `get` uploads an entry: the CUDA card unless the caller
        # asks for the CPU (`shared_caches(session)` passes the session's).
        self.device = resolve_device(device)

    def key(self, session, plan) -> tuple:
        return versioned_plan_key(session, plan)

    def get(self, key: tuple, count_miss: bool = True):
        """The cached ColumnTable for `key`, or None. mmap-backed read:
        the IPC payload stays in the shared page cache, so N processes
        hitting one entry share one resident copy."""
        import pyarrow as pa

        from hyperspace_tpu_torch.execution.table import ColumnTable

        path = self.entry_path(key)
        try:
            fault_point("fleet.cache.read", path)
            if not path.exists():
                if count_miss:
                    stats.increment("fleet.shared_cache.misses")
                return None
            with pa.memory_map(str(path), "r") as source:
                arrow = pa.ipc.open_file(source).read_all()
            out = ColumnTable.from_arrow(arrow, device=self.device)
            os.utime(path)  # LRU touch for the mtime-ordered eviction
        except (OSError, pa.ArrowException, HyperspaceError, ValueError, KeyError):
            # Advisory: a torn/alien/unreadable entry is a miss, never a
            # failed query — the caller recomputes (and re-publishes).
            stats.increment("fleet.shared_cache.errors")
            return None
        stats.increment("fleet.shared_cache.hits")
        return out

    def peek(self, key: tuple):
        """`get` without miss accounting — the single-flight follower's
        poll (one poll loop would otherwise record hundreds of misses
        for one logical lookup)."""
        return self.get(key, count_miss=False)

    def put(self, key: tuple, table) -> bool:
        """Publish `table` under `key`; False when it was too large
        (over a quarter of the budget), already present, or the publish
        failed (advisory)."""
        import pyarrow as pa

        path = self.entry_path(key)
        try:
            arrow = table.to_arrow()
            if int(arrow.nbytes) > self.max_bytes // 4:
                return False
            if path.exists():
                return False  # same versioned key ⇒ same content
            import io as _io

            buf = _io.BytesIO()
            with pa.ipc.new_file(buf, arrow.schema) as writer:
                writer.write(arrow)
            self._publish(path, buf.getvalue())
        except (OSError, pa.ArrowException):
            stats.increment("fleet.shared_cache.errors")
            return False
        self._maybe_evict()
        return True


class SharedPlanCache(_SharedCacheBase):
    """Optimized-plan cache on shared disk: canonical plan JSON under
    versioned plan keys. Drop-in for the in-process `PlanCache` (same
    `get_or_optimize` surface); cold optimizes are single-flighted
    across the fleet when a `SingleFlight` is attached."""

    suffix = ".json"

    def __init__(
        self,
        root: str | Path,
        max_bytes: int = 64 << 20,
        lease_ttl_s: float = 10.0,
        single_flight: SingleFlight | None = None,
    ):
        super().__init__(root, max_bytes, lease_ttl_s)
        self.single_flight = single_flight

    def get_or_optimize(self, session, plan, snapshot=None):
        key = versioned_plan_key(session, plan, snapshot=snapshot)
        path = self.entry_path(key)
        cached = self._read(path)
        if cached is not None:
            stats.increment("fleet.shared_cache.hits")
            return cached
        stats.increment("fleet.shared_cache.misses")
        if self.single_flight is not None:
            return self.single_flight.run(
                f"plan-{key_name(key)}",
                build=lambda: self._optimize_and_publish(session, plan, path, snapshot),
                check=lambda: self._read(path),
            )
        return self._optimize_and_publish(session, plan, path, snapshot)

    def _read(self, path: Path):
        from hyperspace_tpu_torch.plan.nodes import plan_from_json

        try:
            fault_point("fleet.cache.read", path)
            if not path.exists():
                return None
            with open(path, "rb") as f:
                doc = json.loads(f.read())
            out = plan_from_json(doc)
            os.utime(path)
        except (OSError, ValueError, KeyError):
            stats.increment("fleet.shared_cache.errors")
            return None
        return out

    def _optimize_and_publish(self, session, plan, path: Path, snapshot=None):
        optimized = session.optimized_plan(plan, snapshot=snapshot)
        try:
            self._publish(path, json.dumps(optimized.to_json(), sort_keys=True).encode())
        except OSError:
            stats.increment("fleet.shared_cache.errors")
        else:
            self._maybe_evict()
        return optimized


def warm_age_s(path: Path) -> float:
    """Seconds since an entry was last touched (tests/tools)."""
    return time.time() - path.stat().st_mtime  # noqa: HSL007 — cross-process mtime age

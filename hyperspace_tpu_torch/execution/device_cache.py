"""Identity-keyed caches under byte budgets: decoded columns on the device
and arrays derived from them.

A port of the JAX package's `execution/device_cache.py`. `RefCache` is an
LRU memo with a byte budget, single-flight on a missing key, whose entries
hold strong references to their bases, so that a key built from `id()`
stays valid as long as the entry lives. Two instances serve the read path:

- DEVICE_CACHE (default 2 GiB, `HYPERSPACE_DEVICE_CACHE_BYTES`): the
  decoded columns of parquet scans, one entry a (files, their mtimes,
  column, device), so that repeat queries over the same index version or
  source skip the parquet decode and the upload; a table is assembled
  from its columns' entries, and a query reads only the columns it lacks.
  Keyed by column, not by table: a whole lineitem table at SF1 is larger
  than the quarter of the budget an entry may take. It also holds the
  uploads of stable host arrays (`device_put_cached`).
- HOST_DERIVED (default 1 GiB, `HYPERSPACE_DERIVED_CACHE_BYTES`): what a
  query derives from stable inputs — group ids and join key codes on the
  host, and on the device the sorted and bucket-major padded key codes,
  aggregate channels and channel stacks — that would otherwise be
  recomputed per query.

"Stable" means owned by a live entry of one of them (`is_stable`). The
JAX package freezes its numpy arrays; torch has no read-only tensors, so
a derived key names a tensor by `id()` and its `_version` (bumped by every
in-place write): a tensor written in place misses instead of hitting a
stale entry. Host arrays are frozen on insert, as in the JAX package.

An entry larger than a quarter of its cache's budget is not kept (the
JAX package's admission rule). The counters are plain ints (`stats()`),
with hits and misses also counted by the key's first word, its kind.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch


class RefCache:
    """Identity-keyed LRU memo with a byte budget. Entries hold strong
    references to their base arrays, so id()-based keys stay valid for
    the lifetime of the entry."""

    def __init__(self, budget_bytes: int):
        self.budget = int(budget_bytes)
        self._lock = threading.Lock()
        self._entries: dict[tuple, tuple[int, tuple, object]] = {}
        # Single-flight: key -> Event set when that key's build finishes.
        self._building: dict[tuple, threading.Event] = {}
        # id -> [object, entries owning it]: the values is_stable accepts.
        self._owned: dict[int, list] = {}
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._by_kind: dict = {}

    def _count(self, key: tuple, hit: bool) -> None:
        kind = key[0] if key else None
        c = self._by_kind.setdefault(kind, [0, 0])
        c[0 if hit else 1] += 1
        if hit:
            self.hits += 1
        else:
            self.misses += 1

    def get(self, key: tuple):
        """The value under `key` (an LRU touch and a hit), or None (a miss)."""
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries[key] = self._entries.pop(key)
            self._count(key, hit is not None)
            return None if hit is None else hit[2]

    def put(self, key: tuple, value, nbytes: int) -> None:
        """Admit a value with no bases, built after a `get` missed."""
        with self._lock:
            self._insert_locked(key, (), value, nbytes)

    def get_or_build(self, key: tuple, base_refs: tuple, build):
        """`build() -> (value, nbytes)`; value cached under `key` while
        `base_refs` are pinned. Concurrent misses on one key are
        single-flighted: one caller builds, the rest wait and then hit (or
        build in turn, if the value was too large to keep or the build
        failed)."""
        while True:
            with self._lock:
                hit = self._entries.get(key)
                if hit is not None:
                    self._entries[key] = self._entries.pop(key)  # LRU touch
                    self._count(key, True)
                    return hit[2]
                ev = self._building.get(key)
                if ev is None:
                    self._building[key] = threading.Event()
                    self._count(key, False)
                    break  # this caller builds
            ev.wait()
        try:
            value, nbytes = build()
        except BaseException:
            with self._lock:
                self._building.pop(key).set()
            raise
        with self._lock:
            self._insert_locked(key, base_refs, value, nbytes)
            self._building.pop(key).set()
        return value

    def _insert_locked(self, key: tuple, base_refs: tuple, value, nbytes: int) -> None:
        """Admit a built value under the byte budget, evicting the least
        recently used. Caller holds `self._lock`."""
        if nbytes > self.budget // 4 or key in self._entries:
            return
        self._entries[key] = (nbytes, base_refs, value)
        self._bytes += nbytes
        for obj in _arrays_of(value):
            self._owned.setdefault(id(obj), [obj, 0])[1] += 1
        while self._bytes > self.budget and self._entries:
            k = next(iter(self._entries))
            nb, _, old = self._entries.pop(k)
            self._bytes -= nb
            self.evictions += 1
            self._disown(old)

    def _disown(self, value) -> None:
        for obj in _arrays_of(value):
            own = self._owned.get(id(obj))
            if own is not None:
                own[1] -= 1
                if own[1] == 0:
                    del self._owned[id(obj)]

    def owns(self, obj) -> bool:
        with self._lock:
            return id(obj) in self._owned

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._owned.clear()
            self._bytes = 0
            self.hits = 0
            self.misses = 0
            self.evictions = 0
            self._by_kind.clear()

    def stats(self) -> dict:
        with self._lock:
            return {
                "budget": self.budget,
                "entries": len(self._entries),
                "bytes": self._bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "by_kind": {str(k): {"hits": h, "misses": m} for k, (h, m) in self._by_kind.items()},
            }


def _arrays_of(value):
    """The tensors and numpy arrays a cached value holds (tuples, lists
    and dicts are walked)."""
    if isinstance(value, (torch.Tensor, np.ndarray)):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _arrays_of(v)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _arrays_of(v)


DEVICE_CACHE = RefCache(int(os.environ.get("HYPERSPACE_DEVICE_CACHE_BYTES", 2 << 30)))
HOST_DERIVED = RefCache(int(os.environ.get("HYPERSPACE_DERIVED_CACHE_BYTES", 1 << 30)))


def nbytes_of(value) -> int:
    """Bytes of the tensors and arrays in a value; a string array (a
    dictionary) counts its characters and a pointer word an entry, never
    the fixed width a `<U` dtype pads every entry to."""
    total = 0
    for a in _arrays_of(value):
        if isinstance(a, torch.Tensor):
            total += a.numel() * a.element_size()
        elif a.dtype.kind in "OUS":
            total += sum(len(str(s)) for s in a.tolist()) + 8 * len(a)
        else:
            total += int(a.nbytes)
    return total


def table_footprint_bytes(table) -> int:
    """A ColumnTable's bytes: columns, validity masks, and its string
    dictionaries at their character payload (never the decoded per-row
    strings)."""
    return nbytes_of(list(table.columns.values()) + list(table.validity.values())) + sum(
        nbytes_of(d) for d in table.dictionaries.values()
    )


def is_stable(arr) -> bool:
    """True when `arr`'s identity is a valid cache key: it is owned by a
    live entry of DEVICE_CACHE or HOST_DERIVED (a decoded column, an
    upload or a derived value), which pins it."""
    return isinstance(arr, (torch.Tensor, np.ndarray)) and (DEVICE_CACHE.owns(arr) or HOST_DERIVED.owns(arr))


def ident(arr) -> tuple:
    """An array's identity part of a derived key: id and, for a tensor,
    its version counter (an in-place write changes it)."""
    return (id(arr), arr._version) if isinstance(arr, torch.Tensor) else (id(arr),)


def freeze(arr):
    """A host array made read-only (a tensor is returned as it is)."""
    if isinstance(arr, np.ndarray):
        arr.flags.writeable = False
    return arr


_clock = threading.local()


def derive_seconds() -> float:
    """Host seconds this thread has spent in `derived` and
    `device_put_cached`, hits and builds alike (a query's share is the
    difference across it)."""
    return getattr(_clock, "seconds", 0.0)


def _timed(fn):
    t0 = time.perf_counter()
    try:
        return fn()
    finally:
        _clock.seconds = derive_seconds() + time.perf_counter() - t0


def device_put_cached(arr: np.ndarray, device: torch.device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """`arr` on `device` (as `dtype`), through DEVICE_CACHE when `arr` is
    stable."""
    from hyperspace_tpu_torch.execution.table import to_tensor

    def build():
        t = to_tensor(arr, device)
        if dtype is not None:
            t = t.to(dtype)
        return t, nbytes_of(t)

    if not is_stable(arr):
        return _timed(lambda: build()[0])
    return _timed(lambda: DEVICE_CACHE.get_or_build(("raw", id(arr), str(dtype), str(device)), (arr,), build))


def derived(key: tuple, base_refs: tuple, build_value):
    """Memoize a value derived from stable bases in HOST_DERIVED; host
    arrays in it are frozen so that it can serve as a base itself.
    `build_value() -> value` (an array, a tensor or a tuple of them)."""

    def build():
        out = build_value()
        for a in _arrays_of(out):
            freeze(a)
        return out, nbytes_of(out)

    return _timed(lambda: HOST_DERIVED.get_or_build(key, base_refs, build))


def clear_all() -> None:
    DEVICE_CACHE.clear()
    HOST_DERIVED.clear()

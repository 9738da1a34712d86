"""Metadata cache SPI + TTL implementation.

Reference parity: index/Cache.scala:23-41 (get/set/clear SPI) and
index/CachingIndexCollectionManager.scala:117-160
(CreationTimeBasedIndexCache: entries expire `expiry_seconds` after they
were set; every mutating API clears the cache).

Thread-safe: one lock covers the whole get/set/clear surface, so the
stamp check and the expiry eviction in ``get`` are one critical section.
"""

from __future__ import annotations

import threading
import time
from typing import Generic, TypeVar

T = TypeVar("T")


class Cache(Generic[T]):
    def get(self) -> T | None:
        raise NotImplementedError

    def set(self, entry: T) -> None:
        raise NotImplementedError

    def clear(self) -> None:
        raise NotImplementedError


class CreationTimeBasedCache(Cache[T]):
    def __init__(self, expiry_seconds: float):
        self.expiry_seconds = expiry_seconds
        self._lock = threading.Lock()
        self._entry: T | None = None
        self._set_at: float = 0.0

    def get(self) -> T | None:
        with self._lock:
            if self._entry is None:
                return None
            # monotonic, not wall clock: an NTP step backwards must not make
            # a stale entry immortal (nor a forward step expire a fresh one).
            if time.monotonic() - self._set_at > self.expiry_seconds:
                self._entry = None
                self._set_at = 0.0
                return None
            return self._entry

    def set(self, entry: T) -> None:
        with self._lock:
            self._entry = entry
            self._set_at = time.monotonic()

    def clear(self) -> None:
        with self._lock:
            self._entry = None
            self._set_at = 0.0

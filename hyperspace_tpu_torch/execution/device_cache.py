"""Decoded tables kept on the device between queries.

The counterpart of the JAX package's `execution/device_cache.py`: once an
index version's columns are read, they stay on the device as tensors and
repeat queries skip the parquet decode and the upload. A plain dict keyed
by (file list, columns), validated by the files' mtimes; one cache per
session. The JAX package's byte budget and LRU eviction are not ported
yet, so entries live as long as the session (a new index version has new
files, hence new keys).
"""

from __future__ import annotations

import os
import threading

from hyperspace_tpu_torch.execution.table import ColumnTable


class DeviceTableCache:
    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict[tuple, tuple[tuple, ColumnTable]] = {}

    def get_or_read(self, files: list[str], columns: list[str], read) -> tuple[ColumnTable, bool]:
        """(table, hit): the cached table for (files, columns), or
        `read()` stored under that key."""
        key = (tuple(files), tuple(columns))
        mtimes = tuple(os.stat(f).st_mtime_ns for f in files)
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None and hit[0] == mtimes:
                return hit[1], True
        table = read()
        with self._lock:
            self._entries[key] = (mtimes, table)
        return table, False

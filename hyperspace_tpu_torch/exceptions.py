"""Framework exception types (the subset the port's slice raises).

Reference parity: com/microsoft/hyperspace/HyperspaceException.scala:17-19 —
a single exception class carrying a message, plus the typed corruption
error the scan path raises for unreadable index data.
"""

from __future__ import annotations


class HyperspaceError(Exception):
    """Raised for any user-facing framework error."""

    def __init__(self, msg: str):
        super().__init__(msg)
        self.msg = msg


class IndexCorruptionError(HyperspaceError):
    """Index data on disk is unreadable: a truncated/garbage bucket file,
    a torn `_index_manifest.json`, or a missing file the log still
    references. Carries the index root and the failing path."""

    def __init__(self, msg: str, index_root: str | None = None, path: str | None = None):
        super().__init__(msg)
        self.index_root = index_root
        self.path = path

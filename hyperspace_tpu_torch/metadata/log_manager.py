"""Filesystem-backed operation log with optimistic concurrency.

Reference parity: index/IndexLogManager.scala:33-155. Layout:

    <index_path>/_hyperspace_log/<id>        immutable JSON entries, id = 0..n
    <index_path>/_hyperspace_log/latestStable  copy of the latest stable entry

Concurrency contract (IndexLogManager.scala:138-154): `write_log` creates the
entry file with compare-and-swap semantics — if a concurrent writer already
created the same id, the call returns False and the caller must abort
("Could not acquire proper state", actions/Action.scala:75-80).

`get_latest_stable_log` prefers the `latestStable` pointer file and falls
back to a backward scan for an entry in a stable state
(IndexLogManager.scala:92-122).
"""

from __future__ import annotations

import os
from pathlib import Path

from hyperspace_tpu_torch.config import HYPERSPACE_LOG_DIR, LATEST_STABLE_LOG_NAME
from hyperspace_tpu_torch.metadata.log_entry import IndexLogEntry, entry_from_json
from hyperspace_tpu_torch.utils.file_utils import read_json, write_json
from hyperspace_tpu_torch.states import STABLE_STATES


class IndexLogManager:
    def __init__(self, index_path: str | os.PathLike):
        self.index_path = Path(index_path)
        self.log_dir = self.index_path / HYPERSPACE_LOG_DIR

    # -- reads -----------------------------------------------------------
    def get_log(self, id: int) -> IndexLogEntry | None:
        p = self.log_dir / str(id)
        if not p.exists():
            return None
        return entry_from_json(read_json(p))

    def get_latest_id(self) -> int | None:
        if not self.log_dir.is_dir():
            return None
        ids = [int(f.name) for f in self.log_dir.iterdir() if f.name.isdigit()]
        return max(ids) if ids else None

    def get_latest_log(self) -> IndexLogEntry | None:
        latest = self.get_latest_id()
        return None if latest is None else self.get_log(latest)

    def get_latest_stable_log(self) -> IndexLogEntry | None:
        pointer = self.log_dir / LATEST_STABLE_LOG_NAME
        try:
            entry = entry_from_json(read_json(pointer))
            if entry.state in STABLE_STATES:
                return entry
        except (FileNotFoundError, ValueError):
            # Pointer absent, or caught mid delete/recreate by a concurrent
            # Action.end(): fall back to the backward scan.
            pass
        # Backward scan fallback (IndexLogManager.scala:113-122). A torn
        # or garbage entry (crashed writer on a filesystem without atomic
        # create, injected truncation) is skipped, not fatal: the scan's
        # contract is "the last stable state still resolves".
        latest = self.get_latest_id()
        if latest is None:
            return None
        for id in range(latest, -1, -1):
            try:
                entry = self.get_log(id)
            except (ValueError, KeyError, TypeError, OSError):
                # A torn entry is skipped: the last STABLE entry still
                # resolves.
                continue
            if entry is not None and entry.state in STABLE_STATES:
                return entry
        return None

    # -- writes ----------------------------------------------------------
    def write_log(self, id: int, entry: IndexLogEntry) -> bool:
        """CAS-create log entry `id`. False ⇒ a concurrent writer won."""
        entry.id = id
        p = self.log_dir / str(id)
        return write_json(p, entry.to_json(), overwrite=False)

    def create_latest_stable_log(self, id: int) -> bool:
        """Copy entry `id` to the latestStable pointer
        (IndexLogManager.scala:92-111)."""
        entry = self.get_log(id)
        if entry is None or entry.state not in STABLE_STATES:
            return False
        p = self.log_dir / LATEST_STABLE_LOG_NAME
        write_json(p, entry.to_json(), overwrite=True)
        return True

    def delete_latest_stable_log(self) -> bool:
        p = self.log_dir / LATEST_STABLE_LOG_NAME
        try:
            p.unlink(missing_ok=True)
            return True
        except OSError:
            return False

    def quarantine_log(self, id: int) -> bool:
        """Move a torn/garbage log entry aside (recover()'s repair for a
        truncated trailing entry). The renamed file no longer counts for
        `get_latest_id` (non-digit name), so the id becomes writable
        again; the bytes stay on disk for post-mortems."""
        p = self.log_dir / str(id)
        for attempt in range(10):
            suffix = ".corrupt" if attempt == 0 else f".corrupt-{attempt}"
            try:
                os.rename(p, p.with_name(p.name + suffix))
                return True
            except FileExistsError:
                continue
            except OSError:
                return False
        return False

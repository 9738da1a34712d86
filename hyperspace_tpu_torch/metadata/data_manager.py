"""Versioned index data directories.

Reference parity: index/IndexDataManager.scala:38-73. Index data for version
`n` lives at `<index_path>/v__=<n>/` (Hive-partition naming so engines that
understand partition columns see `v__` as one). Refresh writes into
`v__=<latest+1>` and the log swap makes it live; vacuum deletes all versions.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

from hyperspace_tpu_torch.config import DATA_VERSION_PREFIX
from hyperspace_tpu_torch.utils.file_utils import delete_recursively

_VERSION_RE = re.compile(re.escape(DATA_VERSION_PREFIX) + r"(\d+)$")


class IndexDataManager:
    def __init__(self, index_path: str | os.PathLike):
        self.index_path = Path(index_path)

    def get_version_ids(self) -> list[int]:
        if not self.index_path.is_dir():
            return []
        ids = []
        for f in self.index_path.iterdir():
            m = _VERSION_RE.match(f.name)
            if m and f.is_dir():
                ids.append(int(m.group(1)))
        return sorted(ids)

    def get_latest_version_id(self) -> int | None:
        ids = self.get_version_ids()
        return ids[-1] if ids else None

    def get_path(self, id: int) -> Path:
        return self.index_path / f"{DATA_VERSION_PREFIX}{id}"

    def delete(self, id: int) -> None:
        delete_recursively(self.get_path(id))

    def quarantine(self, id: int) -> bool:
        """Move a partial/orphaned version dir aside (failure path of
        Action.run, recover()'s orphan GC). The dotted name no longer
        matches the `v__=N` pattern, so the version id is immediately
        reusable and index listings can never pick the partial data up;
        the bytes stay for post-mortems. No-op (False) when absent."""
        src = self.get_path(id)
        if not src.exists():
            return False
        for attempt in range(10):
            suffix = "" if attempt == 0 else f"-{attempt}"
            dest = self.index_path / f".quarantine-{DATA_VERSION_PREFIX}{id}{suffix}"
            if dest.exists():
                continue
            try:
                os.rename(src, dest)
                return True
            except OSError:
                return False
        return False

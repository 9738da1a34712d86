"""Index path resolution.

Reference parity: index/PathResolver.scala:30-101. The system root comes from
configuration (default `<cwd>/spark-warehouse/indexes`,
PathResolver.scala:65-71); index names resolve case-insensitively by listing
the system directory (PathResolver.scala:39-60) so `MyIdx` and `myidx` are
the same index.
"""

from __future__ import annotations

from pathlib import Path

from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.utils.name_utils import normalize_index_name


class PathResolver:
    def __init__(self, conf: HyperspaceConf):
        self.conf = conf

    @property
    def system_path(self) -> Path:
        return Path(self.conf.system_path)

    def get_index_path(self, name: str) -> Path:
        """Resolve an index name to its directory, matching an existing
        directory case-insensitively, else the normalized name."""
        name = normalize_index_name(name)
        root = self.system_path
        if root.is_dir():
            low = name.lower()
            for d in root.iterdir():
                if d.is_dir() and d.name.lower() == low:
                    return d
        return root / name

    def list_index_paths(self) -> list[Path]:
        """Every index directory under the system path. Underscore-
        prefixed directories are metadata-plane state, not indexes
        (`_hyperspace_log` inside an index dir set the convention; the
        advisor's `_advisor/` ledger dir lives at THIS level), so they
        are excluded — listing one as an index would make lazy recovery
        try to "repair" it on every catalog scan."""
        root = self.system_path
        if not root.is_dir():
            return []
        return sorted(
            d for d in root.iterdir() if d.is_dir() and not d.name.startswith("_")
        )

"""Vector-index version directories and centroids.

The subset of the JAX package's `vector/lifecycle.py` that search needs:
the live version dirs of an entry and the centroids of the newest one.
Refresh (full and incremental) and optimize are not ported yet.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.metadata.log_entry import IndexLogEntry
from hyperspace_tpu_torch.vector.index import CENTROIDS_NAME


def _live_dirs(entry: IndexLogEntry) -> list[Path]:
    return [Path(entry.content.root) / d for d in entry.content.directories]


def load_centroids(entry: IndexLogEntry) -> np.ndarray:
    """Centroids of the newest live version (every version dir carries a
    copy so vacuuming old dirs can never orphan the quantizer)."""
    for d in reversed(_live_dirs(entry)):
        p = d / CENTROIDS_NAME
        if p.exists():
            return np.load(p)
    raise HyperspaceError(f"index {entry.name!r} has no {CENTROIDS_NAME}")

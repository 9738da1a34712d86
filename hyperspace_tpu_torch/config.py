"""Framework configuration: the settings the port's slice reads.

The same defaults and directory-layout constants as the JAX package's
`config.py`, so an index directory written by either package is laid out
identically. The JAX package's string-keyed overrides and the settings of
modules not ported yet are not here.
"""

from __future__ import annotations

import dataclasses
import os

# Directory-layout constants (reference index/IndexConstants.scala:38-39).
HYPERSPACE_LOG_DIR = "_hyperspace_log"
DATA_VERSION_PREFIX = "v__="
LATEST_STABLE_LOG_NAME = "latestStable"

DEFAULT_NUM_BUCKETS = 8
DEFAULT_CACHE_EXPIRY_SECONDS = 300.0


@dataclasses.dataclass
class HyperspaceConf:
    """Per-session configuration."""

    system_path: str = ""
    num_buckets: int = DEFAULT_NUM_BUCKETS

    def __post_init__(self):
        if not self.system_path:
            self.system_path = os.path.join(os.getcwd(), "spark-warehouse", "indexes")

"""Index-name normalization.

Reference parity: util/IndexNameUtils.scala:219-231 — trim and replace
whitespace runs with underscores so names are filesystem-safe.
"""

from __future__ import annotations

import re

_WS = re.compile(r"\s+")


def normalize_index_name(name: str) -> str:
    return _WS.sub("_", name.strip())

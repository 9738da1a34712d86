"""Device resolution for the port's entry points.

The counterpart of the JAX package's backend selection (`compat.py`):
an entry point runs on the CUDA card unless the caller asks for the CPU.
There is no silent fallback — asking for the card where there is none
raises.
"""

from __future__ import annotations

import torch

from hyperspace_tpu_torch.exceptions import HyperspaceError


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """`None` means the CUDA card; `"cpu"` is only used when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise HyperspaceError(
            "no CUDA device is available; pass device='cpu' to run on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise HyperspaceError(f"unsupported device {dev}")
    return dev

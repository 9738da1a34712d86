"""HSL019 spawn-import purity corpus (torch counterpart).

The file declares its own SPAWN_ENTRY_POINTS, making this module a
spawn-domain host: its module-level statements run in every spawned
worker before the task body does. A module-level import of jax or the
JAX package flags, and so does a module-level CUDA touch (a
torch.cuda.*() call, a tensor made on cuda, a kernel build or load).
Function-level imports and CUDA calls are deferred and legal.
"""

SPAWN_ENTRY_POINTS = {
    "hsl019.worker_body": ("task_body", "corpus task body"),
}

import jax  # expect: HSL001 HSL019
from hyperspace_tpu import stats  # expect: HSL001 HSL019
import numpy as np  # clean: numpy is part of the worker vocabulary
import torch  # clean: importing torch touches no card

from hyperspace_tpu_torch.ops import kernels

torch.cuda.init()  # expect: HSL019
_ONES = torch.ones(4, device="cuda")  # expect: HSL019
_HOST = torch.ones(4)  # clean: a CPU tensor
_LIB = kernels.load("topk")  # expect: HSL019
if torch.cuda.is_available():  # expect: HSL019
    _CARDS = 1


def worker_body(path):
    return {"path": str(path), "n": int(np.int64(3))}


def coordinator_only():
    import jax.numpy as jnp  # expect: HSL001

    return jnp, torch.cuda.device_count()  # clean: deferred to the call

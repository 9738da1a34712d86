"""HSL001 corpus: the port imports neither JAX nor the JAX package, and
touches torch's private API only in ops/kernels.py (flagged and clean
forms)."""

import jax  # expect: HSL001
import jax.numpy as jnp  # expect: HSL001
from jaxlib import xla_client  # expect: HSL001
import hyperspace_tpu  # expect: HSL001
from hyperspace_tpu.ops import topk  # expect: HSL001
from torch._C import _cuda_getDevice  # expect: HSL001
from torch import _C  # expect: HSL001

import torch
import hyperspace_tpu_torch
from hyperspace_tpu_torch.ops import topk as port_topk


def current_stream(index):
    return torch._C._cuda_getCurrentRawStream(index)  # expect: HSL001


def lazy_init():
    torch.cuda._lazy_init()  # expect: HSL001


def public_api(index):
    return torch.cuda.current_stream(index), torch.__version__, port_topk

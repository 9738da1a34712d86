"""Borrowed buffers: the copying gateway, and a planted in-place write
through a tensor made over an Arrow-owned array (HSL025)."""

import numpy as np
import torch


def to_tensor(arr, device):
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def fill_nulls(arr):
    t = torch.from_numpy(arr)
    t.nan_to_num_(0.0)
    return t

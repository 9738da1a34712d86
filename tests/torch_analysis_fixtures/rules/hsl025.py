"""HSL025 borrowed-buffer mutation corpus: a tensor made over a buffer
it does not own (torch.from_numpy / frombuffer / as_tensor, also through
an aliasing .to()) takes no in-place op; a clone, or the copying gateway,
owns its memory."""

import numpy as np
import torch


def bad_method(arr):
    t = torch.from_numpy(arr)
    t.add_(1)  # expect: HSL025
    return t


def bad_slice(buf):
    t = torch.frombuffer(buf, dtype=torch.uint8)
    t[0] = 1  # expect: HSL025
    return t


def bad_out(arr, y):
    t = torch.as_tensor(arr)
    torch.add(y, 1, out=t)  # expect: HSL025
    return t


def bad_chain(arr, device):
    t = torch.from_numpy(arr).to(device)
    t += 1  # expect: HSL025
    return t


def rebound(arr):
    t = torch.from_numpy(arr)
    t = t.clone()
    t.add_(1)  # clean: a clone owns its memory
    return t


def to_tensor(arr, device):
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)  # clean: the copying gateway

"""HSL002 corpus: a host sync inside a launch body (a function that
calls count_launch) flags; shape reads there, and syncs outside a launch
body, are fine."""

import torch


class HyperspaceError(Exception):
    pass


def count_launch(wrapper):
    wrapper.launches += 1


def load(name):
    return None


def scale(x: torch.Tensor) -> torch.Tensor:
    if not x.is_cuda:
        return scale_plain(x)
    out = torch.empty_like(x)
    n = int(x.shape[0])  # clean: a shape is host metadata
    total = x.sum().item()  # expect: HSL002
    rows = out.tolist()  # expect: HSL002
    host = out.cpu()  # expect: HSL002
    first = float(x[0])  # expect: HSL002
    torch.cuda.synchronize()  # expect: HSL002
    err = load("scale").hs_scale(x.data_ptr(), out.data_ptr(), n)
    if err != 0:
        raise HyperspaceError(f"scale failed: {err}")
    count_launch(scale)
    return out, total, rows, host, first


def scale_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2


scale.launches = 0


def read_back(x: torch.Tensor) -> float:
    return float(x.sum().item())  # clean: not a launch body

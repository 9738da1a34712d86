"""HSL003 corpus: Python control flow on a tensor's value inside a
launch body flags (an implicit sync); host metadata and identity tests
are fine."""

import torch


class HyperspaceError(Exception):
    pass


def count_launch(wrapper):
    wrapper.launches += 1


def load(name):
    return None


def masked(x: torch.Tensor, mask: torch.Tensor, out=None):
    if x.dim() == 1:  # clean: host metadata
        x = x[None, :]
    if not x.is_cuda:  # clean
        return masked_plain(x, mask)
    if out is None:  # clean: identity, not a truth value
        out = torch.empty_like(x)
    if mask.any():  # expect: HSL003
        out.zero_()
    while x.sum() > 0:  # expect: HSL003
        break
    assert (x >= 0).all()  # expect: HSL003
    assert x.numel() > 0  # clean
    err = load("masked").hs_masked(x.data_ptr(), mask.data_ptr(), out.data_ptr())
    if err != 0:
        raise HyperspaceError(f"masked failed: {err}")
    count_launch(masked)
    return out


def masked_plain(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, x, torch.zeros_like(x))


masked.launches = 0


def host_side(x: torch.Tensor) -> bool:
    return bool(x.any()) if x.numel() else False  # clean: not a launch body

"""A wrapper that retreats to its plain version when the launch fails:
the fallback the port's rules forbid (HSL026 (d))."""

from launchdemo.errors import HyperspaceError
from launchdemo.ops.kernels import count_launch, load


def fallback(x):
    if not x.is_cuda:
        return fallback_plain(x)
    try:
        err = load("fallback").hs_fallback(x.data_ptr())
        if err != 0:
            raise HyperspaceError(f"fallback kernel failed: {err}")
    except HyperspaceError:
        return fallback_plain(x)
    count_launch(fallback)
    return x


def fallback_plain(x):
    return x


fallback.launches = 0

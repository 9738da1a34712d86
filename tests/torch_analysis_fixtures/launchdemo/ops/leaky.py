"""A wrapper whose launch path leaks: a counter bumped in a helper
(HSL023), a grid from a raw shape (HSL024), a plan table filled outside
kernels.memo (HSL015)."""

from launchdemo import stats
from launchdemo.errors import HyperspaceError
from launchdemo.ops.kernels import count_launch, load

_cache: dict = {}


def _plan_for(n):
    stats.increment("plans.built")
    _cache[n] = n
    return n


def leaky(x):
    if not x.is_cuda:
        return leaky_plain(x)
    n = x.shape[0]
    grid = n
    _plan_for(n)
    err = load("leaky").hs_leaky(x.data_ptr(), n, grid)
    if err != 0:
        raise HyperspaceError(f"leaky kernel failed: {err}")
    count_launch(leaky)
    return x


def leaky_plain(x):
    return x


leaky.launches = 0

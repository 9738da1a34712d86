"""A wrapper that keeps its launch contract."""

from launchdemo.errors import HyperspaceError
from launchdemo.ops.kernels import call_on_stream, count_launch, load, memo

TILE = 1024
_plans: dict = {}


def _grid(n, sms):
    return min(sms * 4, -(-n // TILE))


def good(x):
    if not x.is_cuda:
        return good_plain(x)
    n = x.shape[0]
    grid = memo(_plans, (n, 132), lambda: _grid(n, 132))
    err = call_on_stream(x.get_device(), load("good").hs_good, x.data_ptr(), n, grid)
    if err != 0:
        raise HyperspaceError(f"good kernel failed: {err}")
    count_launch(good)
    return x


def good_plain(x):
    return x


good.launches = 0

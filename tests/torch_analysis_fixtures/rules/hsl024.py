"""HSL024 launch-plan boundedness corpus: a decorator cache in a
launch-hosting module flags (plans go through kernels.memo), and so does
a grid or tile width bound from a raw data shape; widths from a rounding
helper, a memo or a module constant are clean."""

import functools
import threading

LAUNCH_SANCTIONED = {
    "hsl024.count_launch": "the launch count",
    "hsl024.memo": "the bounded plan memo",
    "hsl024.load": "the kernel library",
}

TILE = 1024
_plans: dict = {}
_lock = threading.Lock()


class HyperspaceError(Exception):
    pass


def count_launch(wrapper):
    with _lock:
        wrapper.launches += 1


def memo(table, key, build):
    with _lock:
        return table.setdefault(key, build())


def load(name):
    return None


def _tiles(n):
    return -(-n // TILE)


@functools.lru_cache(maxsize=None)  # expect: HSL024
def _cached_plan(n):
    return _tiles(n)


def scale(x):
    if not x.is_cuda:
        return scale_plain(x)
    n = x.shape[0]
    grid = n  # expect: HSL024
    tiles = _tiles(n)  # clean: rounded
    threads = TILE  # clean: a module constant
    window = memo(_plans, (n,), lambda: _cached_plan(n))  # clean: the memo
    err = load("scale").hs_scale(x.data_ptr(), grid, tiles, threads, window)
    if err != 0:
        raise HyperspaceError(f"scale failed: {err}")
    count_launch(scale)
    return x


def scale_plain(x):
    return x * 2


scale.launches = 0

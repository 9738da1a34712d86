"""HSL023 launch-effect purity corpus: host effects reachable on a
kernel's launch path. The effects live in helpers the wrapper's CUDA
side calls, so only the closure walk finds them; the CPU branch and the
sanctioned helpers (this file's own LAUNCH_SANCTIONED) are not the
launch path."""

import threading
import time

from hyperspace_tpu_torch import stats

LAUNCH_SANCTIONED = {
    "hsl023.count_launch": "the launch count: one add under its lock",
    "hsl023.load": "the kernel library, loaded once",
}

_count_lock = threading.Lock()
_plan_lock = threading.Lock()


class HyperspaceError(Exception):
    pass


def count_launch(wrapper):
    with _count_lock:
        wrapper.launches += 1


def load(name):
    return None


def _plan(x):
    stats.increment("retry.attempts")  # expect: HSL023
    return 4


def _stamp():
    return time.perf_counter()  # expect: HSL023


def _guarded(x):
    with _plan_lock:  # expect: HSL023
        return x


def scale(x):
    if not x.is_cuda:
        return scale_plain(x)
    grid = _plan(x)
    t0 = _stamp()
    _guarded(x)
    err = load("scale").hs_scale(x.data_ptr(), grid, t0)
    if err != 0:
        raise HyperspaceError(f"scale failed: {err}")
    count_launch(scale)
    return x


def scale_plain(x):
    stats.increment("retry.attempts")  # clean: the CPU branch is not the launch path
    return x * 2


scale.launches = 0

"""HSL015 corpus: a launch-plan memo key built from a per-call value
never hits (id(), a tensor, a data pointer, a clock, an RNG draw); keys
of shapes, dtypes and devices are clean. The plan-table leg (an ops
module's table filled outside kernels.memo) is planted in launchdemo."""

import time

import numpy as np
import torch

_plans: dict = {}


def memo(table, key, build):
    return table.setdefault(key, build())


def keyed_by_id(x: torch.Tensor):
    return memo(_plans, (id(x), 4), lambda: 4)  # expect: HSL015


def keyed_by_tensor(x: torch.Tensor):
    return memo(_plans, (x, 4), lambda: 4)  # expect: HSL015


def keyed_by_pointer(x):
    return memo(_plans, x.data_ptr(), lambda: 4)  # expect: HSL015


def keyed_by_clock():
    return memo(_plans, time.monotonic(), lambda: 4)  # expect: HSL015


def keyed_by_draw():
    return memo(_plans, int(np.random.default_rng(0).integers(8)), lambda: 4)  # expect: HSL015


def keyed_by_shape(x: torch.Tensor):
    return memo(_plans, (x.shape[0], x.dtype, x.get_device()), lambda: 4)  # clean

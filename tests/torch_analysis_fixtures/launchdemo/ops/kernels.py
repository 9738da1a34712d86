"""The fixture's loader: its sanctioned helpers, as the port's
ops/kernels.py."""

import threading

LAUNCH_SANCTIONED = {
    "launchdemo.ops.kernels.count_launch": "the launch count",
    "launchdemo.ops.kernels.memo": "the bounded plan memo",
    "launchdemo.ops.kernels.load": "the kernel library",
    "launchdemo.ops.kernels.call_on_stream": "the launch on the current stream",
}

SOURCES = {
    "good": "csrc/good.cu",
    "leaky": "csrc/leaky.cu",
    "fallback": "csrc/fallback.cu",
}
MEMO_ENTRIES = 256

_lock = threading.Lock()
_count_lock = threading.Lock()
_memo_lock = threading.Lock()
_loaded: dict = {}


def count_launch(wrapper):
    with _count_lock:
        wrapper.launches += 1


def memo(table, key, build):
    with _memo_lock:
        value = table.get(key)
        if value is None:
            if len(table) >= MEMO_ENTRIES:
                table.clear()
            value = table[key] = build()
        return value


def load(name):
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = object()
        return lib


def call_on_stream(index, fn, *args):
    return fn(*args, index)

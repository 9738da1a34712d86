"""Arrow → card zero-copy staging.

A port of the JAX package's `execution/staging.py`. Before it, every
scalar column of a cold read bound for the card was copied twice: Arrow's
buffer into an owned numpy array on the host (`table.to_tensor`), then
that array to the card. Here a fixed-width, null-free, single-chunk Arrow
column bound for the card goes from Arrow's buffer straight into the
host-to-device copy: a read-only numpy view over the buffer
(`np.frombuffer`, which keeps the buffer alive), wrapped as a CPU tensor
without a copy and copied once, to the card. The tensor on the card owns
its memory, so nothing written through it can reach a buffer Arrow still
owns. A column bound for the CPU is still copied on the host (its tensor
must own its memory too). The copy is a plain synchronous `.to(device)`
from pageable memory; pinned memory and a non-blocking copy would need a
measurement on the card that favours them.

Accounting: every scalar column that crosses this boundary is counted in
``device.stage.bytes_zero_copy`` (straight from Arrow's buffer) or
``device.stage.bytes_copied`` (copied on the host first: nulls, casts,
several chunks, an unaligned view, a column bound for the CPU, staging
off, or a staging fault).

The fault point ``device.stage`` fires before each zero-copy attempt. An
injected transient fault (or any real OSError from the buffer plumbing)
takes that column down the copied path, to the card as before, and the
query still answers. A CrashPoint passes through (a BaseException).

Gated by ``hyperspace.device.staging.enabled`` (process-global, like the
faults and obs switches: the decode path has no session handle).
"""

from __future__ import annotations

import threading
import warnings

import numpy as np
import torch

from hyperspace_tpu_torch import stats
from hyperspace_tpu_torch.faults import fault_point

# The CPU tensor over Arrow's read-only buffer is only ever read (copied
# to the card), so torch's warning about writing through it does not
# apply to the views this module makes.
warnings.filterwarnings(
    "ignore", message="The given NumPy array is not writable", category=UserWarning, module=__name__,
)

# Process-global gate, flipped by config.set(DEVICE_STAGING_ENABLED). A
# stale read steers one column down the other (equally correct) path.
_lock = threading.Lock()
_enabled = True


def set_enabled(enabled: bool) -> None:
    global _enabled
    with _lock:
        _enabled = bool(enabled)


def enabled() -> bool:
    return _enabled


# Arrow fixed-width primitive types that view directly as the port's
# physical dtypes. Bool is bit-packed in Arrow (no view); date32 and
# timestamp[us] are reinterpreted by Arrow's zero-copy .view() first.
_VIEW_DTYPES = {
    "int8": np.int8,
    "int16": np.int16,
    "int32": np.int32,
    "int64": np.int64,
    "uint8": np.uint8,
    "uint16": np.uint16,
    "uint32": np.uint32,
    "uint64": np.uint64,
    "float": np.float32,
    "double": np.float64,
    "date32[day]": np.int32,
    "timestamp[us]": np.int64,
}


def count_copied(nbytes: int) -> None:
    """Account the bytes of a column copied on the host."""
    if nbytes > 0:
        stats.increment("device.stage.bytes_copied", int(nbytes))


def _buffer_view(arr, np_dtype) -> np.ndarray | None:
    """Read-only numpy view over a primitive Arrow array's data buffer,
    or None where the layout cannot be viewed (an offset misaligned to the
    lane width)."""
    bufs = arr.buffers()
    if len(bufs) != 2 or bufs[1] is None:
        return None
    data = bufs[1]
    dt = np.dtype(np_dtype)
    byte_off = arr.offset * dt.itemsize
    if (data.address + byte_off) % dt.itemsize:
        return None
    if byte_off + len(arr) * dt.itemsize > data.size:
        return None
    out = np.frombuffer(data, dtype=dt, count=len(arr), offset=byte_off)
    # A buffer wrapping a caller's live numpy array stays writable unless
    # frozen here; the view holds `data`, so Arrow's allocation outlives it.
    out.flags.writeable = False
    return out


def staged_view(arr, field) -> np.ndarray | None:
    """A read-only numpy view over one fixed-width Arrow column's buffer
    (chunked or plain), or None where it is not eligible: nulls, bool,
    several chunks, a dtype other than the schema's, an unaligned view,
    staging off, or a staging fault (the copied path then runs)."""
    import pyarrow as pa

    if not _enabled:
        return None
    if isinstance(arr, pa.ChunkedArray):
        if arr.num_chunks != 1:
            return None
        arr = arr.chunk(0)
    if arr.null_count:
        return None
    want = np.dtype(field.device_dtype)
    np_dtype = _VIEW_DTYPES.get(str(arr.type))
    if np_dtype is None or np.dtype(np_dtype) != want:
        return None
    try:
        fault_point("device.stage", field.name)
        if str(arr.type) in ("date32[day]", "timestamp[us]"):
            arr = arr.view(pa.int32() if want == np.int32 else pa.int64())
        return _buffer_view(arr, np_dtype)
    except OSError:
        # A transient staging failure (injected or real): this column
        # takes the copied path.
        return None


def stage_column(arr, field, device: torch.device) -> torch.Tensor | None:
    """The column on `device`, copied straight from Arrow's buffer, or
    None where `device` is not the card or the column is not eligible
    (`staged_view`)."""
    if device.type != "cuda":
        return None
    view = staged_view(arr, field)
    if view is None:
        return None
    out = torch.from_numpy(view).to(device)
    stats.increment("device.stage.bytes_zero_copy", int(view.nbytes))
    return out

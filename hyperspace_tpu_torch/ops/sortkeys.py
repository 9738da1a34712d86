"""Order-preserving 32-bit lane decomposition of key columns, and the
stable device sort by those lanes.

Each logical key column decomposes into 1-3 int32/uint32 lanes whose
lexicographic order equals the logical order of the column:

- int8/16/32, date32, bool  → one int32 lane;
- int64, timestamp          → (hi int32, lo uint32) word pair;
- uint64                    → (hi uint32, lo uint32);
- float32                   → one uint32 lane via the IEEE-754 total-order
  bit flip (negatives reversed, sign bit toggled);
- float64                   → the same flip on 64 bits, split hi/lo;
- strings                   → the table's sorted-dictionary codes;
- nullable columns          → a leading validity lane (0 null, 1 valid),
  so nulls sort first.

The decomposition is a copy of the JAX package's `ops/sortkeys.py`
(numpy, on the host). The sort is the port of its `device_lanes_perm` /
`device_sort_perms`: one stable `torch.sort` per lane on the device, least
significant lane first (LSD), which reproduces the JAX package's
`lexsort_lanes` exactly; `order_lanes` and `device_order_perm` order a
table by an ORDER BY list (a DESC key's lanes inverted).
Torch can neither sort nor shift `uint32`, so every lane travels as int64:
unsigned lanes zero-extend and signed lanes sign-extend, which keeps each
lane's own (signed or unsigned) order.

`run_bounds(pk, sk)` is the port of the JAX package's Pallas run-bounds
kernel (K2, `_make_run_bounds_kernel` / `pallas_run_bounds`): the batched
searchsorted the joins take their match runs from. On the card it is one
windowed pass over tiles of primary rows (`csrc/run_bounds.cu`, whose
header says what bounds it on the H100 and how the design answers that),
in the geometry `bounds_plan` gives; on the CPU, `run_bounds_plain`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.obs import trace as obs_trace
from hyperspace_tpu_torch.ops.kernels import count_launch, load, memo


def _flip32(v: np.ndarray) -> np.ndarray:
    """IEEE-754 int32 bit pattern → uint32 whose unsigned order equals the
    float order (negatives reversed, sign toggled)."""
    mask = (v >> 31) | np.int32(-(2**31))  # v>=0: 0x80000000, v<0: 0xFFFFFFFF
    return (v ^ mask).view(np.uint32)


def _flip64(v: np.ndarray) -> np.ndarray:
    mask = (v >> 63) | np.int64(-(2**63))
    return (v ^ mask).view(np.uint64)


def _split64(u: np.ndarray) -> list[np.ndarray]:
    """uint64 → (hi uint32, lo uint32) lanes (unsigned lexicographic)."""
    return [(u >> np.uint64(32)).astype(np.uint32), (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)]


def value_lanes(arr: np.ndarray) -> list[np.ndarray]:
    """Decompose one physical array into order-preserving 32-bit lanes."""
    dt = np.dtype(arr.dtype)
    if dt == np.bool_:
        return [arr.astype(np.int32)]
    if dt.kind == "i" and dt.itemsize <= 4:
        return [arr.astype(np.int32, copy=False)]
    if dt.kind == "u" and dt.itemsize < 4:
        return [arr.astype(np.int32)]
    if dt == np.uint32:
        return [arr]
    if dt == np.int64:
        return [(arr >> 32).astype(np.int32), (arr & 0xFFFFFFFF).astype(np.uint32)]
    if dt == np.uint64:
        return _split64(arr)
    if dt == np.float32:
        return [_flip32(arr.view(np.int32))]
    if dt == np.float64:
        return _split64(_flip64(arr.view(np.int64)))
    raise HyperspaceError(f"unsupported key dtype {dt}")


def column_lanes(table, name: str, force_validity: bool = False) -> list[np.ndarray]:
    """Lanes for a named column of a ColumnTable (validity lane first when
    the column has nulls; null slots zeroed so output is deterministic).
    `force_validity` emits the validity lane even for null-free columns so
    lane layouts match across tables (batched sorts)."""
    f = table.schema.field(name)
    arr = table.host_column(f.name)
    lanes: list[np.ndarray] = []
    valid = table.host_valid_mask(name)
    if valid is not None:
        lanes.append(valid.astype(np.int32))
        zero = np.zeros((), dtype=arr.dtype)
        arr = np.where(valid, arr, zero)
    elif force_validity:
        lanes.append(np.ones(len(arr), dtype=np.int32))
    if f.is_string:
        lanes.append(np.ascontiguousarray(arr, dtype=np.int32))
        return lanes
    lanes.extend(value_lanes(arr))
    return lanes


def key_lanes(table, key_columns: list[str], force_validity: bool = False) -> list[np.ndarray]:
    """All lanes for a key-column list, in sort-significance order."""
    out: list[np.ndarray] = []
    for c in key_columns:
        out.extend(column_lanes(table, c, force_validity=force_validity))
    return out


def lanes_as_unsigned(lanes: list[np.ndarray]) -> np.ndarray:
    """[L, n] uint32 matrix whose unsigned lexicographic order equals the
    lanes' mixed signed/unsigned order (signed lanes get the sign bit
    flipped) — the layout the JAX package's native host sort consumes."""
    out = np.empty((len(lanes), len(lanes[0]) if lanes else 0), dtype=np.uint32)
    for i, l in enumerate(lanes):
        if l.dtype == np.uint32:
            out[i] = l
        else:
            out[i] = l.astype(np.int32).view(np.uint32) ^ np.uint32(0x80000000)
    return out


def lane_tensor(lane: np.ndarray, device: torch.device) -> torch.Tensor:
    """One lane as an int64 tensor on `device`, order-preserving: uint32
    zero-extends, int32 sign-extends."""
    return torch.from_numpy(lane.astype(np.int64)).to(device)


def device_lanes_perm(lanes: list[torch.Tensor]) -> torch.Tensor:
    """Stable permutation sorting rows by int64 lanes (most significant
    first): one stable sort per lane, least significant first."""
    n = len(lanes[0]) if lanes else 0
    perm = torch.arange(n, device=lanes[0].device if lanes else "cpu")
    for lane in reversed(lanes):
        _, p = torch.sort(lane[perm], stable=True)
        perm = perm[p]
    return perm


def invert_lane(lane: np.ndarray) -> np.ndarray:
    """Order-reversing bijection on a lane (~x flips both int32 signed
    order and uint32 unsigned order): DESC sort keys. A flipped validity
    lane also lands nulls last, SQL's nulls-first-ASC / nulls-last-DESC
    convention."""
    return ~lane


def order_lanes(table, by: list[tuple[str, bool]]) -> list[np.ndarray]:
    """Lanes for an ORDER BY (column, ascending) list."""
    out: list[np.ndarray] = []
    for c, asc in by:
        lanes = column_lanes(table, c, force_validity=True)
        if not asc:
            lanes = [invert_lane(l) for l in lanes]
        out.extend(lanes)
    return out


def device_order_perm(table, by: list[tuple[str, bool]]) -> torch.Tensor:
    """Stable permutation ordering `table` by the (column, ascending)
    keys: the stable device sort over the decomposed lanes."""
    if table.num_rows <= 1:
        return torch.arange(table.num_rows, device=table.device)
    return device_lanes_perm([lane_tensor(l, table.device) for l in order_lanes(table, by)])


def device_sort_perm(table, key_columns: list[str], device: torch.device) -> torch.Tensor:
    """Stable key-sort permutation of one table on `device`."""
    if table.num_rows <= 1:
        return torch.arange(table.num_rows, device=device)
    return device_lanes_perm([lane_tensor(l, device) for l in key_lanes(table, key_columns)])


# -- run bounds (K2) ------------------------------------------------------------

ROWS_PER_THREAD = 4  # a thread's consecutive primary rows
THREADS = 256  # a block's threads: a tile of 1,024 rows
SMALL_THREADS = 128  # where 1,024-row tiles would leave SMs without a block
WINDOW_SLACK = 1.25  # the window budget over the keys a sorted tile spans on average
WINDOW_ROUND = 256  # the budget is a multiple of this many keys
MIN_WINDOW = 2048  # keys: never a smaller budget (8 KB)...
MAX_WINDOW = 16384  # ...nor a larger one (64 KB: three blocks an SM)
MAX_GRID = 2**31 - 1  # CUDA's limit on a grid's x dimension


def _check_run_bounds(pk: torch.Tensor, sk: torch.Tensor) -> None:
    if pk.dim() != 2 or sk.dim() != 2 or pk.dtype != torch.int32 or sk.dtype != torch.int32:
        raise HyperspaceError(
            f"run_bounds takes int32 [B, Lp] and [B, Ls] tensors, got {pk.dtype} "
            f"{tuple(pk.shape)} and {sk.dtype} {tuple(sk.shape)}"
        )
    if pk.shape[0] != sk.shape[0]:
        raise HyperspaceError(f"run_bounds: bucket counts differ ({pk.shape[0]} vs {sk.shape[0]})")
    if pk.get_device() != sk.get_device():
        raise HyperspaceError("run_bounds: pk and sk must lie on one device")
    if not (pk.is_contiguous() and sk.is_contiguous()):
        raise HyperspaceError("run_bounds takes contiguous tensors")


def run_bounds_plain(pk: torch.Tensor, sk: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2: per bucket row b, `st = #(sk[b] < pk)`
    and `en = #(sk[b] <= pk)` — searchsorted left and right of every
    primary code in the sorted secondary row, as int32 [B, Lp]."""
    _check_run_bounds(pk, sk)
    st = torch.searchsorted(sk, pk, side="left", out_int32=True)
    en = torch.searchsorted(sk, pk, side="right", out_int32=True)
    return st, en


def bounds_plan(b: int, lp: int, ls: int, sms: int) -> tuple[int, int, int, int, int]:
    """(threads a block, tiles a bucket row, grid, window budget in keys,
    dynamic shared memory bytes) of K2 for pk [b, lp] and sk [b, ls],
    b * lp > 0, on a card with `sms` SMs.

    A thread takes ROWS_PER_THREAD consecutive rows starting on a 16-byte
    boundary of pk, so a bucket row of lp rows starts up to 3 rows before
    its first boundary; a tile is ROWS_PER_THREAD * threads such rows, and
    a bucket takes ceil((lp + 3) / rows) tiles (its last may be empty). A
    block takes one tile: THREADS threads, or SMALL_THREADS where tiles of
    THREADS would not give every SM a block. The grid is the b * tiles
    tiles, folded past MAX_GRID into a block loop (block i takes tiles i,
    i + grid, ...). The window budget is WINDOW_SLACK times the secondary
    keys a sorted tile spans on average (rows * ls / lp), rounded up to
    WINDOW_ROUND and held between MIN_WINDOW and MAX_WINDOW, and never more
    than the row (ls, to 4 keys); a tile whose window is wider searches
    device memory. Shared memory: the window and 4 keys of alignment
    slack."""
    def tiles_of(threads):
        return -(-(lp + 3) // (ROWS_PER_THREAD * threads))

    threads = THREADS if b * tiles_of(THREADS) >= sms else SMALL_THREADS
    rows = ROWS_PER_THREAD * threads
    tiles = tiles_of(threads)
    spans = -(-int(WINDOW_SLACK * rows * ls) // lp)
    window = max(MIN_WINDOW, -(-spans // WINDOW_ROUND) * WINDOW_ROUND)
    window = min(window, MAX_WINDOW, -(-ls // 4) * 4)
    return threads, tiles, min(b * tiles, MAX_GRID), window, 4 * (window + 4)


def run_bounds(pk: torch.Tensor, sk: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(st, en) int32 [B, Lp]: the run of every primary code `pk` [B, Lp]
    in its bucket's sorted secondary codes `sk` [B, Ls] (pads at the int32
    max; `pk` need not be sorted). For a CUDA tensor, one launch of the
    kernel `csrc/run_bounds.cu` in `bounds_plan`'s geometry, at any shape:
    a pass over tiles of primary rows, each searching only the window of
    `sk[b]` its keys span (staged in shared memory where it fits the
    budget, in device memory where not; the kernel picks per tile). For a
    CPU tensor, the plain version. `run_bounds.launches` counts the
    kernel's launches."""
    if not pk.is_cuda:
        if pk.device.type == "cpu":
            return run_bounds_plain(pk, sk)
        raise HyperspaceError(f"run_bounds runs on cuda or cpu, not {pk.device}")
    _check_run_bounds(pk, sk)
    b, lp = pk.shape
    ls = sk.shape[1]
    st, en = torch.empty_like(pk), torch.empty_like(pk)
    if b * lp == 0:
        return st, en
    index = pk.get_device()
    threads, tiles, grid, window, _ = memo(_plans, (b, lp, ls, index), lambda: bounds_plan(b, lp, ls, _sm_count(index)))
    args = (pk.data_ptr(), sk.data_ptr(), st.data_ptr(), en.data_ptr(), b, lp, ls, threads, tiles, grid, window,
            index)
    with obs_trace.span("device.kernel", kernel="cuda-run-bounds", buckets=b, secondary=ls):
        if index == torch._C._cuda_getDevice():
            err = _launch()(*args, torch._C._cuda_getCurrentRawStream(index))
        else:
            with torch.cuda.device(index):
                err = _launch()(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise HyperspaceError(f"run_bounds kernel launch failed at [{b}, {lp}] x [{b}, {ls}]: CUDA error {err}")
    count_launch(run_bounds)
    return st, en


run_bounds.launches = 0


_sms: dict[int, int] = {}
_plans: dict = {}  # (b, lp, ls, device) -> bounds_plan
_fn = []


def _sm_count(index: int) -> int:
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sms[index]


def _launch():
    """hs_run_bounds from the kernel's library, typed once."""
    if not _fn:
        fn = load("run_bounds").hs_run_bounds
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn.append(fn)
    return _fn[0]

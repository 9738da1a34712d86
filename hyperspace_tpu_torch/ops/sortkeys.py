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
(numpy, on the host), with its host order `lexsort_lanes`. The sort is the
port of its `device_lanes_perm`: one stable `torch.sort` per lane on the
device, least significant lane first (LSD), which reproduces
`lexsort_lanes` exactly; `order_lanes` and `device_order_perm` order a
table by an ORDER BY list (a DESC key's lanes inverted).
`device_sort_perms` is the streaming build's batched key sort (the JAX
package's function of that name): every table of a batch padded to one
length, a leading is_pad lane sinking the pads, the lanes packed two to an
int64 key, one stable sort a key over the whole [B, L] batch and one
readback of the permutations.
Torch can neither sort nor shift `uint32`, so every lane travels as int64:
unsigned lanes zero-extend and signed lanes sign-extend, which keeps each
lane's own (signed or unsigned) order.

`distributed_top_n_candidates` is the mesh's top-N selection (each
shard's first n, one threshold, a sharded mask).

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
from hyperspace_tpu_torch.ops.kernels import call_on_stream, count_launch, load, memo
from hyperspace_tpu_torch.parallel.mesh import concat_shards, mesh_size, row_ranges, to_shard


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


def lexsort_lanes(lanes: list[np.ndarray]) -> np.ndarray:
    """Host (numpy) stable argsort by the lanes: the order every sort of
    the port reproduces. np.lexsort keys are LAST-significant first, so
    reverse."""
    if not lanes:
        return np.arange(0)
    return np.lexsort(tuple(reversed(lanes)))


def _packed_keys(lanes_u32: np.ndarray) -> list[np.ndarray]:
    """[L, n] unsigned lanes → ceil(L / 2) int64 keys, most significant
    first, whose signed order is the lanes' lexicographic order: two lanes
    to a key (hi << 32 | lo), the sign bit flipped."""
    keys = []
    flip = np.uint64(1 << 63)
    for i in range(0, lanes_u32.shape[0], 2):
        hi = lanes_u32[i].astype(np.uint64) << np.uint64(32)
        lo = lanes_u32[i + 1].astype(np.uint64) if i + 1 < lanes_u32.shape[0] else np.uint64(0)
        keys.append(((hi | lo) ^ flip).view(np.int64))
    return keys


def distributed_top_n_candidates(lanes_u32: np.ndarray, n: int, mesh) -> np.ndarray | None:
    """Candidate row indices that provably hold the global top n by the
    packed 64-bit key prefix of `lanes_u32` ([1 or 2, rows] uint32, the
    first lane most significant), computed over `mesh` (the JAX package's
    function of that name; the ORDER BY participation the reference gets
    from Spark's TakeOrderedAndProject on every executor). The rows pad to
    a power of two, rounded up to a multiple of the mesh size, and shard i
    takes its contiguous n_pad / D of them: each shard selects its first n
    keys on its device, the n-th smallest over the union of those is an
    inclusive threshold, and each shard masks its rows at or below it
    (prefix ties stay in; the exact sort of the candidates settles the
    order). Returns None where the JAX package does: one shard, n <= 0,
    fewer than 2·n·D rows, fewer than n rows a shard, or fewer than n real
    candidates."""
    d = mesh_size(mesh)
    n_rows = lanes_u32.shape[1]
    if d <= 1 or n <= 0 or n_rows < 2 * n * d:
        return None
    n_pad = 1 << int(n_rows - 1).bit_length()
    if n_pad % d:
        n_pad = -(-n_pad // d) * d
    if n_pad // d < n:
        return None
    # (hi, lo) as one int64 whose signed order is the pair's unsigned order.
    key = (lanes_u32[0].astype(np.int64) - (1 << 31)) << 32
    if lanes_u32.shape[0] > 1:
        key |= lanes_u32[1].astype(np.int64)
    key = torch.from_numpy(key)
    primary = mesh.devices[0]
    shards = [to_shard(key[lo:hi], mesh, i) for i, (lo, hi) in enumerate(row_ranges(n_rows, n_pad // d, d))]
    firsts = [torch.topk(k, min(n, len(k)), largest=False).values for k in shards]
    union = concat_shards(firsts, primary)
    if len(union) < n:
        return None  # fewer real rows than n across the shards: the caller sorts all
    thr = torch.kthvalue(union, n).values
    mask = concat_shards([k <= thr.to(k.device) for k in shards], primary)
    return np.flatnonzero(mask.cpu().numpy())


def device_sort_perms(tables, key_columns: list[str], device: torch.device) -> list[np.ndarray]:
    """Stable key-sort permutation of each table of a batch, computed on
    `device` in one batched pass: each table's rows padded to the batch's
    longest, a leading is_pad lane (pads sink below every real row), the
    lanes packed two to an int64 key; one stable sort a key over the
    [B, L] batch, least significant first, carrying the row ids, and one
    readback. Each permutation equals `lexsort_lanes` of its table's
    lanes (and the pooled build's `host_sort_perm`): equal keys keep
    their order in the table."""
    if not tables:
        return []
    lens = [t.num_rows for t in tables]
    b, width = len(tables), max(max(lens), 1)
    per_table = [lanes_as_unsigned(key_lanes(t, key_columns, force_validity=True)) for t in tables]
    num_lanes = 1 + per_table[0].shape[0]
    stacked = np.zeros((num_lanes, b, width), np.uint32)
    for i, (n, lanes) in enumerate(zip(lens, per_table)):
        stacked[0, i, n:] = 1  # is_pad
        stacked[1:, i, :n] = lanes
    keys = _packed_keys(stacked.reshape(num_lanes, b * width))
    perm = torch.arange(width, device=device).expand(b, width).contiguous()
    with obs_trace.span("device.sort_perms", tables=b, rows=sum(lens), width=width, keys=len(keys)):
        for key in reversed(keys):
            k = torch.from_numpy(key.reshape(b, width)).to(device)
            _, p = torch.sort(torch.gather(k, 1, perm), dim=1, stable=True)
            perm = torch.gather(perm, 1, p)
        perm = perm.cpu().numpy()
    return [perm[i, :n] for i, n in enumerate(lens)]


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
    sms = _sm_count(index)
    threads, tiles, grid, window, _ = memo(_plans, (b, lp, ls, index), lambda: bounds_plan(b, lp, ls, sms))
    args = (pk.data_ptr(), sk.data_ptr(), st.data_ptr(), en.data_ptr(), b, lp, ls, threads, tiles, grid, window,
            index)
    with obs_trace.span("device.kernel", kernel="cuda-run-bounds", buckets=b, secondary=ls):
        err = call_on_stream(index, _launch(), *args)
    if err != 0:
        raise HyperspaceError(f"run_bounds kernel launch failed at [{b}, {lp}] x [{b}, {ls}]: CUDA error {err}")
    count_launch(run_bounds)
    return st, en


run_bounds.launches = 0


_sms: dict = {}  # device -> SM count
_plans: dict = {}  # (b, lp, ls, device) -> bounds_plan
_fn: dict = {}  # symbol -> typed kernel function


def _sm_count(index: int) -> int:
    return memo(_sms, index, lambda: torch.cuda.get_device_properties(index).multi_processor_count)


def _launch():
    """hs_run_bounds from the kernel's library, typed once. The library is
    loaded (built, the first time) outside the memo's lock."""
    lib = load("run_bounds")

    def build():
        fn = lib.hs_run_bounds
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        return fn

    return memo(_fn, "hs_run_bounds", build)

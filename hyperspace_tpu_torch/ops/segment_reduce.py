"""Fused multi-channel segment reduce: the CUDA kernel and its plain twin.

`segment_reduce(vals, gid, num_segments, fns)` reduces channel c of
`vals` [C, n] (float64) by `fns[c]` ∈ {sum, min, max} over the shared
int32 group ids `gid` [n] into a [C, num_segments] float64 tensor. Sums
start at 0, min at +inf, max at -inf; extrema propagate NaN.

It replaces the JAX package's Pallas TPU kernel
`hyperspace_tpu/ops/aggregate.py:81` (`_make_pallas_segment_reduce`).
There the kernel only engages inside an exactness gate with at most 2048
segments; here it serves every shape on the main path, on the card.

On a CUDA tensor the wrapper launches the kernel in
`hyperspace_tpu_torch/csrc/segment_reduce.cu` (whose header says what
bounds it on the H100 and how its design answers that) in the regime
`reduce_plan` picks, or raises; on a CPU tensor it runs
`segment_reduce_plain`. One launch takes up to 64 channels, so a wider
input (more than 32 aggregates) launches once per block of 64 channels;
`segment_reduce.launches` counts those launches, each of which runs
`kernels_per_launch` kernels on the card.

Determinism: integral sums, extrema and counts are exact in any order and
so identical from run to run; non-integral sums come out of float64
atomics in the block and global regimes, whose order varies, so their last
bits may differ between runs (the lanes regime's repeat bit for bit).
"""

from __future__ import annotations

import ctypes

import torch

from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.obs import trace as obs_trace
from hyperspace_tpu_torch.ops.kernels import call_on_stream, count_launch, load, memo

FNS = ("sum", "min", "max")
_FNS = frozenset(FNS)
_CHANNEL_BLOCK = 64  # one launch carries its channels' kinds in two 64-bit masks
THREADS = 256  # threads a block in the block and global regimes
LANE_GROUPS = 8  # the lanes regime keeps a channel's groups in a lane's registers
LANE_TILE = 128  # rows a block of the lanes regime takes at a time (4 a lane)
GLOBAL_UNROLL = 4  # tiles of THREADS rows a block of the global regime takes at a time
MAX_LANE_WARPS = 16  # a lanes block has a warp a channel, at most this many
SMEM_OPTIN = 232_448  # shared memory a block may use on sm_90 (227 KB)
SMEM_SM = 233_472  # shared memory of an SM; each resident block also reserves 1 KB
REGIMES = ("lanes", "block", "global")


def _check(vals: torch.Tensor, gid: torch.Tensor, num_segments: int, fns: tuple) -> None:
    vshape, gshape = vals.shape, gid.shape
    if len(vshape) != 2 or vals.dtype != torch.float64:
        raise HyperspaceError(f"vals must be a [C, n] float64 tensor, got {vals.dtype} {tuple(vshape)}")
    if len(gshape) != 1 or gid.dtype != torch.int32 or gshape[0] != vshape[1]:
        raise HyperspaceError(f"gid must be an int32 [n] tensor matching vals, got {gid.dtype} {tuple(gshape)}")
    if gid.get_device() != vals.get_device():
        raise HyperspaceError("vals and gid must lie on one device")
    if len(fns) != vshape[0] or not _FNS.issuperset(fns):
        raise HyperspaceError(f"fns must name one of {FNS} per channel, got {fns}")
    if num_segments < 0:
        raise HyperspaceError("num_segments must be >= 0")


def segment_reduce_plain(vals: torch.Tensor, gid: torch.Tensor, num_segments: int, fns: tuple) -> torch.Tensor:
    """Plain PyTorch version (index_add_ / scatter_reduce), with the same
    identities and NaN handling as the kernel."""
    _check(vals, gid, num_segments, tuple(fns))
    c_num = vals.shape[0]
    out = torch.empty((c_num, num_segments), dtype=torch.float64, device=vals.device)
    idx = gid.long()
    for c, fn in enumerate(fns):
        v = vals[c]
        if fn == "sum":
            out[c] = torch.zeros(num_segments, dtype=torch.float64, device=vals.device).index_add_(0, idx, v)
            continue
        ident = float("inf") if fn == "min" else float("-inf")
        red = torch.full((num_segments,), ident, dtype=torch.float64, device=vals.device)
        red.scatter_reduce_(0, idx, v, "amin" if fn == "min" else "amax", include_self=True)
        nan = torch.isnan(v)
        red[idx[nan]] = float("nan")  # a NaN input makes its group NaN
        out[c] = red
    return out


def reduce_plan(c_num: int, k: int, n: int, sms: int) -> tuple[str, int, int, int]:
    """(regime, most blocks, threads a block, dynamic shared memory bytes)
    for one launch of 1 <= c_num <= 64 channels over n rows into k >= 1
    groups on a card with `sms` SMs. lanes (k <= LANE_GROUPS): a warp a
    channel, its groups in registers; block (C·K·8 bytes fit a block's
    shared memory): one shared [C, K] a block; global: device atomics into
    out. The grid is what the threads and shared memory let the SMs hold
    at once and no more than the rows fill; the kernel cuts it further
    where registers hold fewer blocks (a grid-wide barrier needs every
    block resident)."""
    if k <= LANE_GROUPS:
        regime, threads, smem, rows = "lanes", 32 * min(c_num, MAX_LANE_WARPS), 0, LANE_TILE
    elif c_num * k * 8 <= SMEM_OPTIN:
        regime, threads, smem, rows = "block", THREADS, c_num * k * 8, THREADS
    else:
        regime, threads, smem, rows = "global", THREADS, 0, THREADS * GLOBAL_UNROLL
    per_sm = min(2048 // threads, 32, SMEM_SM // (smem + 1024))
    return regime, max(1, min(sms * per_sm, -(-n // rows))), threads, smem


def segment_reduce(vals: torch.Tensor, gid: torch.Tensor, num_segments: int, fns: tuple) -> torch.Tensor:
    """[C, num_segments] float64 segment reduce: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    fns = tuple(fns)
    if not vals.is_cuda:
        if vals.device.type == "cpu":
            return segment_reduce_plain(vals, gid, num_segments, fns)
        raise HyperspaceError(f"segment_reduce runs on cuda or cpu, not {vals.device}")
    _check(vals, gid, num_segments, fns)
    c_num, n = vals.shape
    k = num_segments
    index = vals.get_device()
    if c_num == 0 or k == 0:
        return torch.empty((c_num, k), dtype=torch.float64, device=vals.device)
    vals = vals.contiguous()
    gid = gid.contiguous()
    launches, scratch_rows = _launch_plan(fns, k, n, _sm_count(index))
    # The shared regimes' partials ([blocks, C, K] int64) are rows below
    # out in one allocation; channel blocks run in stream order and reuse
    # them.
    full = torch.empty((c_num + scratch_rows, k), dtype=torch.float64, device=vals.device)
    with obs_trace.span("device.kernel", kernel="cuda-segment-reduce", channels=c_num, segments=k):
        call_on_stream(index, _run, launches, vals, gid, full, n, k, c_num)
    return full[:c_num] if scratch_rows else full


def _run(launches, vals, gid, full, n, k, c_num, stream) -> None:
    fn = _launch()
    g, v, o = gid.data_ptr(), vals.data_ptr(), full.data_ptr()
    partial = o + 8 * c_num * k
    for c0, count, min_mask, max_mask, regime, grid, threads in launches:
        err = fn(g, v + 8 * c0 * n, o + 8 * c0 * k, count, n, k, min_mask, max_mask, regime, grid, threads,
                 partial, stream)
        if err != 0:
            raise HyperspaceError(f"segment_reduce kernel launch failed ({REGIMES[regime]} regime): CUDA error {err}")
        count_launch(segment_reduce)


def kernels_per_launch(regime: str, fns: tuple) -> int:
    """Kernels on the card for one launch of channels `fns`: one
    cooperative kernel in the lanes and block regimes; init and reduce in
    the global one, and finish where a channel is a min."""
    if regime != "global":
        return 1
    return 3 if "min" in fns else 2


_plans: dict = {}


def _launch_plan(fns: tuple, k: int, n: int, sms: int):
    """(one (first channel, channels, min mask, max mask, regime index,
    grid, threads) per block of at most 64 channels, the rows of [*, k]
    float64 the partials need) on a card with `sms` SMs, cached."""

    def build():
        launches, words = [], 0
        for c0 in range(0, len(fns), _CHANNEL_BLOCK):
            block = fns[c0 : c0 + _CHANNEL_BLOCK]
            regime, grid, threads, _ = reduce_plan(len(block), k, n, sms)
            min_mask = sum(1 << c for c, f in enumerate(block) if f == "min")
            max_mask = sum(1 << c for c, f in enumerate(block) if f == "max")
            launches.append((c0, len(block), min_mask, max_mask, REGIMES.index(regime), grid, threads))
            if regime != "global":
                words = max(words, grid * len(block) * k)
        return tuple(launches), -(-words // k)

    return memo(_plans, (fns, k, n, sms), build)


segment_reduce.launches = 0


_sms: dict = {}  # device -> SM count
_fn: dict = {}  # symbol -> typed kernel function


def _sm_count(index: int) -> int:
    return memo(_sms, index, lambda: torch.cuda.get_device_properties(index).multi_processor_count)


def _launch():
    """hs_segment_reduce from the kernel's library, typed once. The library is
    loaded (built, the first time) outside the memo's lock."""
    lib = load("segment_reduce")

    def build():
        fn = lib.hs_segment_reduce
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_ulonglong, ctypes.c_ulonglong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        return fn

    return memo(_fn, "hs_segment_reduce", build)

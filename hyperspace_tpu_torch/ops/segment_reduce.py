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
bounds it on the H100 and how its design answers that) or raises; on a
CPU tensor it runs `segment_reduce_plain`. One launch takes up to 64
channels, so a wider input (more than 32 aggregates) launches once per
block of 64 channels; `segment_reduce.launches` counts those launches.

Determinism: integral sums, extrema and counts are exact in any order and
so identical from run to run; non-integral sums come out of float64
atomics whose order varies, so their last bits may differ between runs.
"""

from __future__ import annotations

import ctypes

import torch

from hyperspace_tpu_torch.exceptions import HyperspaceError

FNS = ("sum", "min", "max")
_CHANNEL_BLOCK = 64  # one launch carries its channels' kinds in two 64-bit masks


def _check(vals: torch.Tensor, gid: torch.Tensor, num_segments: int, fns: tuple) -> None:
    if vals.dim() != 2 or vals.dtype != torch.float64:
        raise HyperspaceError(f"vals must be a [C, n] float64 tensor, got {vals.dtype} {tuple(vals.shape)}")
    if gid.dim() != 1 or gid.dtype != torch.int32 or len(gid) != vals.shape[1]:
        raise HyperspaceError(f"gid must be an int32 [n] tensor matching vals, got {gid.dtype} {tuple(gid.shape)}")
    if gid.device != vals.device:
        raise HyperspaceError("vals and gid must lie on one device")
    if len(fns) != vals.shape[0] or any(f not in FNS for f in fns):
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


def segment_reduce(vals: torch.Tensor, gid: torch.Tensor, num_segments: int, fns: tuple) -> torch.Tensor:
    """[C, num_segments] float64 segment reduce: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    fns = tuple(fns)
    if vals.device.type == "cpu":
        return segment_reduce_plain(vals, gid, num_segments, fns)
    if vals.device.type != "cuda":
        raise HyperspaceError(f"segment_reduce runs on cuda or cpu, not {vals.device}")
    _check(vals, gid, num_segments, fns)
    c_num, n = vals.shape
    vals = vals.contiguous()
    gid = gid.contiguous()
    out = torch.empty((c_num, num_segments), dtype=torch.float64, device=vals.device)
    if c_num == 0 or num_segments == 0:
        return out
    lib = _library()
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        # Channels are independent: one launch per block of at most 64.
        for c0 in range(0, c_num, _CHANNEL_BLOCK):
            block = fns[c0 : c0 + _CHANNEL_BLOCK]
            min_mask = sum(1 << c for c, f in enumerate(block) if f == "min")
            max_mask = sum(1 << c for c, f in enumerate(block) if f == "max")
            err = lib.hs_segment_reduce(
                gid.data_ptr(), vals[c0].data_ptr(), out[c0].data_ptr(), len(block), n,
                num_segments, min_mask, max_mask, stream,
            )
            if err != 0:
                raise HyperspaceError(f"segment_reduce kernel launch failed: CUDA error {err}")
            segment_reduce.launches += 1
    return out


segment_reduce.launches = 0


def _library() -> ctypes.CDLL:
    from hyperspace_tpu_torch.ops.kernels import load

    lib = load("segment_reduce")
    if not getattr(lib, "_hs_typed", False):
        lib.hs_segment_reduce.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_ulonglong, ctypes.c_ulonglong,
            ctypes.c_void_p,
        ]
        lib.hs_segment_reduce.restype = ctypes.c_int
        lib._hs_typed = True
    return lib

"""Row-wise top-k selection: the CUDA kernel (K3) and its plain twin.

`topk(scores, k)` returns, for each row of a float32 [q, n] tensor, the k
largest values (float32 [q, k]) and their column indices (int32 [q, k]),
ordered by value descending, with NaN counted as -inf, -0.0 equal to +0.0
and ties going to the lowest column. `k` is cut to `n`; a 1-D input is
one row, and gives 1-D results.

It replaces the JAX package's Pallas TPU kernel
`hyperspace_tpu/ops/topk.py:46` (`_make_tile_kernel`). There the kernel
engages only for k <= 64 and n >= 512, and `lax.top_k` serves every other
shape (and orders +0.0 above -0.0, which the kernel does not). Here the
kernel serves every shape on the card, up to k = `MAX_K`; a larger k
raises.

On a CUDA tensor the wrapper launches `hyperspace_tpu_torch/csrc/topk.cu`
(whose header says what bounds it on the H100 and how its design answers
that) in one or more passes (`pass_plan`) or raises; on a CPU tensor it
runs `topk_plain`. `topk.launches` counts one per call that launches.
"""

from __future__ import annotations

import ctypes

import torch

from hyperspace_tpu_torch.exceptions import HyperspaceError

MAX_TILE = 4096  # keys a block sorts in shared memory (32 KB)
MAX_K = MAX_TILE // 2  # a tile must hold at least 2k keys to shrink a row


def _check(scores: torch.Tensor, k: int) -> None:
    if scores.dim() not in (1, 2) or scores.dtype != torch.float32:
        raise HyperspaceError(
            f"topk takes a float32 [q, n] or [n] tensor, got {scores.dtype} {tuple(scores.shape)}"
        )
    if k < 0:
        raise HyperspaceError(f"topk: k must be >= 0, got {k}")


def topk_plain(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: NaN -> -inf, -0.0 -> +0.0, then a stable
    descending sort (equal values keep column order) and its first k."""
    _check(scores, k)
    if scores.dim() == 1:
        v, i = topk_plain(scores[None, :], k)
        return v[0], i[0]
    x = torch.where(torch.isnan(scores), float("-inf"), scores)
    x = torch.where(x == 0, 0.0, x)  # -0.0 == 0 too: both become +0.0
    k = min(k, x.shape[1])
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32)


def _tile(length: int, k: int) -> int:
    """The smallest power of two holding the row (and 2k), at most
    MAX_TILE."""
    need = max(length, 2 * k, 2)
    return min(MAX_TILE, 1 << (need - 1).bit_length())


def pass_plan(n: int, k: int) -> list[tuple[int, int]]:
    """(row length, tile) of each kernel pass for [q, n] scores and
    1 <= k <= min(n, MAX_K): every pass but the last leaves ceil(length /
    tile) * k keys a row, and the last has one tile a row."""
    plan = []
    length = n
    while True:
        tile = _tile(length, k)
        plan.append((length, tile))
        if length <= tile:
            return plan
        length = -(-length // tile) * k


def topk(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k per row: the CUDA kernel for a CUDA tensor, at every shape up
    to k = MAX_K, and the plain version for a CPU tensor."""
    if scores.device.type == "cpu":
        return topk_plain(scores, k)
    if scores.device.type != "cuda":
        raise HyperspaceError(f"topk runs on cuda or cpu, not {scores.device}")
    _check(scores, k)
    if scores.dim() == 1:
        v, i = topk(scores[None, :], k)
        return v[0], i[0]
    q, n = scores.shape
    k = min(k, n)
    if k > MAX_K:
        raise HyperspaceError(f"topk kernel holds k <= {MAX_K}; got k = {k}")
    vals = torch.empty((q, k), dtype=torch.float32, device=scores.device)
    idx = torch.empty((q, k), dtype=torch.int32, device=scores.device)
    if q == 0 or k == 0:
        return vals, idx
    if n >= 2**32 - 1:
        raise HyperspaceError(f"topk kernel holds rows of fewer than 2^32 - 1 columns; got {n}")
    lib = _library()
    src = scores.contiguous()
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        plan = pass_plan(n, k)
        for p, (length, tile) in enumerate(plan):
            final = p == len(plan) - 1
            keys = None
            if not final:
                keys = torch.empty((q, -(-length // tile) * k), dtype=torch.int64, device=scores.device)
            err = lib.hs_topk_pass(
                src.data_ptr(), int(p > 0), q, length, k, tile,
                None if final else keys.data_ptr(),
                vals.data_ptr() if final else None, idx.data_ptr() if final else None,
                stream,
            )
            if err != 0:
                raise HyperspaceError(f"topk kernel pass {p} failed at [{q}, {length}], k={k}, tile={tile}: error {err}")
            src = keys
    topk.launches += 1
    return vals, idx


topk.launches = 0


def _library() -> ctypes.CDLL:
    from hyperspace_tpu_torch.ops.kernels import load

    lib = load("topk")
    if not getattr(lib, "_hs_typed", False):
        lib.hs_topk_pass.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.hs_topk_pass.restype = ctypes.c_int
        lib._hs_typed = True
    return lib

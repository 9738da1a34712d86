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
kernel serves every shape on the card, every k: up to k = `MAX_K` its last
step sorts the candidates in one block's shared memory, above it a merge
sort in device memory takes that step (`merge_passes`).

On a CUDA tensor the wrapper launches `hyperspace_tpu_torch/csrc/topk.cu`
(whose header says what bounds it on the H100 and how its design answers
that) or raises: a radix select in `launches_per_call(n, k)` launches
over `select_plan`'s split of each row into blocks, or, for a row of at
most `SMALL_N` columns, one launch. On a CPU tensor it runs `topk_plain`.
`topk.launches` counts one per call that launches.
"""

from __future__ import annotations

import ctypes

import torch

from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.obs import trace as obs_trace
from hyperspace_tpu_torch.ops.kernels import call_on_stream, count_launch, load, memo

MAX_K = 2048  # candidates the last step sorts in shared memory (16 KB); a run of the merge sort above
SMALL_N = 4096  # a row this short is sorted whole by one block, in one launch
DIGIT_BITS = (11, 11, 10)  # the radix select's digits of the 32-bit key, high to low
HIST_BINS = 2048  # a block's histogram: 2^max(DIGIT_BITS) counts
LAUNCHES_RADIX = 2 * len(DIGIT_BITS) + 2  # a digit pass and a scan each, gather, sort (k <= MAX_K)
BLOCKS_PER_SM = 4  # the digit and gather blocks (512 threads) an SM holds
MIN_CHUNK = 4096  # fewest columns a block of the radix select takes


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


def select_plan(q: int, n: int, sms: int) -> tuple[int, int]:
    """(blocks a row, columns a block) of the radix select for [q, n]
    scores on a card with `sms` SMs: at most BLOCKS_PER_SM blocks an SM in
    all (where q allows), each taking at least MIN_CHUNK columns, no block empty, chunks a
    multiple of 4 columns where n is. (0, n) for a row of at most SMALL_N
    columns: the one-launch path."""
    if n <= SMALL_N:
        return 0, n
    want = max(1, BLOCKS_PER_SM * sms // q)  # one wave: a second would hold the whole pass
    blocks = max(1, min(want, -(-n // MIN_CHUNK)))
    chunk = -(-n // blocks)
    if n % 4 == 0:  # every chunk then starts on 16 bytes: the kernel loads float4s
        chunk = -(-chunk // 4) * 4
    return -(-n // chunk), chunk


def merge_passes(k: int) -> int:
    """Merge launches after the runs of MAX_K candidates are sorted:
    ceil(log2(runs)), 0 for k <= MAX_K (no runs: one shared-memory sort)."""
    runs = -(-k // MAX_K)
    return (runs - 1).bit_length() if k > MAX_K else 0


def launches_per_call(n: int, k: int) -> int:
    """Kernel launches of one call on rows of n columns for the top k
    (k cut to n): one for a short row; else the radix select's, and for k
    above MAX_K the run sort in place of the sort, plus the merges."""
    if n <= SMALL_N:
        return 1
    return LAUNCHES_RADIX + merge_passes(min(k, n))


def workspace_bytes(q: int, k: int, blocks: int) -> int:
    """The radix select's scratch: k 64-bit candidates a row (twice for k
    > MAX_K: the merge ping-pongs between two buffers), then int32 words:
    a histogram and a tie offset a block, and 4 words of state a row
    (csrc/topk.cu::carve)."""
    return 8 * q * k * (2 if k > MAX_K else 1) + 4 * q * (blocks * HIST_BINS + blocks + 4)


def topk(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k per row: the CUDA kernel for a CUDA tensor, at every shape
    and k, and the plain version for a CPU tensor."""
    if not scores.is_cuda:
        if scores.device.type == "cpu":
            return topk_plain(scores, k)
        raise HyperspaceError(f"topk runs on cuda or cpu, not {scores.device}")
    _check(scores, k)
    if scores.dim() == 1:
        v, i = topk(scores[None, :], k)
        return v[0], i[0]
    q, n = scores.shape
    k = min(k, n)
    dev = scores.device
    vals = torch.empty((q, k), dtype=torch.float32, device=dev)
    idx = torch.empty((q, k), dtype=torch.int32, device=dev)
    if q == 0 or k == 0:
        return vals, idx
    if n >= 2**32 - 1:
        raise HyperspaceError(f"topk kernel holds rows of fewer than 2^32 - 1 columns; got {n}")
    index = scores.get_device()
    src = scores.contiguous()

    sms = _sm_count(index)

    def build():
        blocks, chunk = select_plan(q, n, sms)
        return blocks, chunk, workspace_bytes(q, k, blocks) if blocks else 0

    blocks, chunk, work_bytes = memo(_plans, (q, n, k, index), build)
    work = torch.empty(work_bytes, dtype=torch.uint8, device=dev) if blocks else None
    args = (src.data_ptr(), q, n, k, blocks, chunk, work.data_ptr() if blocks else None,
            vals.data_ptr(), idx.data_ptr())
    with obs_trace.span("device.kernel", kernel="cuda-topk", rows=q, columns=n, k=k):
        err = call_on_stream(index, _launch(), *args)
    if err != 0:
        raise HyperspaceError(f"topk kernel failed at [{q}, {n}], k={k}, {blocks} blocks a row: error {err}")
    count_launch(topk)
    return vals, idx


topk.launches = 0


_sms: dict = {}  # device -> SM count
_plans: dict = {}  # (q, n, k, device) -> (blocks a row, chunk, workspace bytes)
_fn: dict = {}  # symbol -> typed kernel function


def _sm_count(index: int) -> int:
    return memo(_sms, index, lambda: torch.cuda.get_device_properties(index).multi_processor_count)


def _launch():
    """hs_topk from the kernel's library, typed once. The library is
    loaded (built, the first time) outside the memo's lock."""
    lib = load("topk")

    def build():
        fn = lib.hs_topk
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        return fn

    return memo(_fn, "hs_topk", build)

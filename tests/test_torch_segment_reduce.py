"""K1 (fused segment reduce): the port's plain version against the JAX package.

Seeded numpy inputs go to the JAX package's Pallas kernel
`_make_pallas_segment_reduce(fns, k_pad, 256, interpret=True)` (run as its
own CPU tests run it: interpreted, under `run_x64`, inside its
interpret-work bound n_pad * k_pad <= 2^24) and to the port's
`segment_reduce_plain` / `segment_reduce` on the CPU.

- Exact channels — integral sums, min/max with NaN and ±inf, and the 0/1
  count channels — must be bit-equal (NaN matches NaN).
- Non-integral sums are compared with the JAX package's
  `_segment_reduce_many` at rtol 1e-12 of Σ|v| per group: float64 sums
  taken in another order differ in the last bits, and the CUDA kernel's
  atomics make that order vary from run to run.

The CUDA kernel itself is held to the plain version on the card by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from hyperspace_tpu.ops.aggregate import _make_pallas_segment_reduce, _segment_reduce_many
from hyperspace_tpu.parallel.x64 import run_x64
from hyperspace_tpu_torch.ops.segment_reduce import segment_reduce, segment_reduce_plain

TILE = 256
N = 3_000
N_PAD = 4_096  # multiple of the tile; rows past N carry the dead segment


def _inputs(rng, fns, k, integral):
    gid = rng.integers(0, k, N).astype(np.int32)
    vals = np.empty((len(fns), N))
    for c, fn in enumerate(fns):
        if fn == "count":
            vals[c] = (rng.random(N) < 0.8).astype(np.float64)
        elif integral:
            vals[c] = rng.integers(-1000, 1000, N).astype(np.float64)
        else:
            vals[c] = rng.normal(size=N) * 1e3
        if fn in ("min", "max"):
            special = rng.random(N)
            vals[c][special < 0.01] = np.nan
            vals[c][(special >= 0.01) & (special < 0.02)] = np.inf
            vals[c][(special >= 0.02) & (special < 0.03)] = -np.inf
    return gid, vals


def _jax_pallas(vals, gid, k, fns):
    """The JAX package's kernel on the padded layout it takes."""
    k_pad = max(1 << int(k).bit_length(), 128)  # >= K + 1: one dead segment for pads
    assert N_PAD * k_pad <= 1 << 24
    gid2d = np.full((1, N_PAD), k, np.int32)
    gid2d[0, :N] = gid
    padded = np.zeros((len(fns), N_PAD))
    padded[:, :N] = vals
    for c, fn in enumerate(fns):
        padded[c, N:] = {"sum": 0.0, "min": np.inf, "max": -np.inf}[fn]
    run = _make_pallas_segment_reduce(tuple(fns), k_pad, TILE, True)
    out = run_x64(lambda: np.asarray(run(gid2d, padded)))
    return out[:, :k]


def _port(vals, gid, k, fns):
    return segment_reduce(torch.from_numpy(vals), torch.from_numpy(gid), k, tuple(fns)).numpy()


@pytest.mark.parametrize("k", [1, 5, 100])
def test_exact_channels_are_bit_equal_to_the_pallas_kernel(k):
    rng = np.random.default_rng(k)
    labels = ("sum", "count", "min", "max", "min", "max")
    gid, vals = _inputs(rng, labels, k, integral=True)
    fns = tuple("sum" if f == "count" else f for f in labels)
    got = _port(vals, gid, k, fns)
    want = _jax_pallas(vals, gid, k, fns)
    np.testing.assert_array_equal(got, want)
    # Every group with a NaN input is NaN in both.
    assert np.isnan(got[2:]).any()


def test_plain_version_matches_the_pallas_kernel_on_empty_groups():
    rng = np.random.default_rng(11)
    gid = rng.choice([0, 3, 7], N).astype(np.int32)  # groups 1,2,4,5,6 stay empty
    fns = ("sum", "min", "max")
    vals = rng.integers(-50, 50, (3, N)).astype(np.float64)
    got = _port(vals, gid, 9, fns)
    np.testing.assert_array_equal(got, _jax_pallas(vals, gid, 9, fns))
    assert got[0, 1] == 0.0 and got[1, 1] == np.inf and got[2, 1] == -np.inf


@pytest.mark.parametrize("k", [7, 1000])
def test_non_integral_sums_agree_to_rtol_of_abs_sum(k):
    rng = np.random.default_rng(100 + k)
    fns = ("sum", "sum", "min", "max")
    gid, vals = _inputs(rng, fns, k, integral=False)
    got = _port(vals, gid, k, fns)
    k_seg = 1 << int(k).bit_length()
    want = run_x64(lambda: np.asarray(_segment_reduce_many(vals, gid, k_seg, fns)))[:, :k]
    abs_sum = np.stack(
        [np.bincount(gid, weights=np.abs(vals[c]), minlength=k) for c in range(2)]
    )
    assert np.all(np.abs(got[:2] - want[:2]) <= 1e-12 * abs_sum)
    np.testing.assert_array_equal(got[2:], want[2:])


def test_wrapper_counts_no_launch_on_the_cpu():
    before = segment_reduce.launches
    vals = torch.ones((2, 10), dtype=torch.float64)
    out = segment_reduce(vals, torch.zeros(10, dtype=torch.int32), 1, ("sum", "max"))
    assert out.tolist() == [[10.0], [1.0]]
    assert segment_reduce.launches == before


@pytest.mark.parametrize(
    "vals,gid,fns",
    [
        (torch.ones((2, 4), dtype=torch.float32), torch.zeros(4, dtype=torch.int32), ("sum", "sum")),
        (torch.ones((2, 4), dtype=torch.float64), torch.zeros(4, dtype=torch.int64), ("sum", "sum")),
        (torch.ones((2, 4), dtype=torch.float64), torch.zeros(3, dtype=torch.int32), ("sum", "sum")),
        (torch.ones((2, 4), dtype=torch.float64), torch.zeros(4, dtype=torch.int32), ("sum", "mean")),
    ],
    ids=["float32-vals", "int64-gid", "ragged", "unknown-fn"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(vals, gid, fns):
    from hyperspace_tpu_torch.exceptions import HyperspaceError

    with pytest.raises(HyperspaceError):
        segment_reduce_plain(vals, gid, 1, fns)

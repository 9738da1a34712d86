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


# (channels, groups, rows, the regime): the main path's shapes — Q1, the
# join's group folds, revenue and the run extrema — and the edges of
# each regime.
_PLANS = [
    (12, 6, 6_001_991, "lanes"), (11, 7, 1_551_800, "lanes"), (7, 52, 6_225_800, "block"),
    (2, 1_500_000, 6_001_991, "global"), (1, 1_551_800, 1_551_800, "global"), (2, 1_500_000, 6_225_800, "global"),
    (64, 8, 100, "lanes"), (1, 9, 1000, "block"), (64, 454, 10, "block"), (64, 455, 10, "global"),
    (4, 5, 0, "lanes"),
]


@pytest.mark.parametrize("c_num,k,n,regime", _PLANS)
def test_reduce_plan_picks_the_regime_and_a_resident_grid(c_num, k, n, regime):
    from hyperspace_tpu_torch.ops.segment_reduce import (
        GLOBAL_UNROLL, LANE_TILE, SMEM_OPTIN, SMEM_SM, THREADS, reduce_plan,
    )

    sms = 132
    got, grid, threads, smem = reduce_plan(c_num, k, n, sms)
    assert got == regime
    assert threads == (32 * min(c_num, 16) if regime == "lanes" else THREADS)
    assert smem == (c_num * k * 8 if regime == "block" else 0) <= SMEM_OPTIN
    per_sm = min(2048 // threads, (SMEM_SM // (smem + 1024)))
    assert 1 <= grid <= sms * per_sm
    rows = {"lanes": LANE_TILE, "block": THREADS, "global": THREADS * GLOBAL_UNROLL}[regime]
    assert grid <= max(1, -(-n // rows))


@pytest.mark.parametrize("c_num", [1, 64, 65, 140])
def test_launch_plan_splits_channels_into_blocks_of_64_with_their_kinds(c_num):
    from hyperspace_tpu_torch.ops.segment_reduce import REGIMES, _launch_plan

    fns = (("sum", "min", "max", "sum") * 40)[:c_num]
    k, n = 6, 50_000
    launches, scratch_rows = _launch_plan(fns, k, n, 132)
    assert [c0 for c0, *_ in launches] == list(range(0, c_num, 64))
    words = 0
    for c0, count, min_mask, max_mask, regime, grid, _ in launches:
        block = fns[c0 : c0 + count]
        assert count == len(block) <= 64
        assert [c for c in range(count) if min_mask >> c & 1] == [c for c, f in enumerate(block) if f == "min"]
        assert [c for c in range(count) if max_mask >> c & 1] == [c for c, f in enumerate(block) if f == "max"]
        assert REGIMES[regime] == "lanes"
        words = max(words, grid * count * k)
    assert scratch_rows * k >= words  # every launch's partials fit the rows below out


@pytest.mark.parametrize(
    "regime,fns,kernels",
    [("lanes", ("sum", "min"), 1), ("block", ("max",), 1), ("global", ("sum", "sum"), 2),
     ("global", ("max",), 2), ("global", ("min", "max"), 3)],
)
def test_kernels_per_launch_follow_the_regime_and_kinds(regime, fns, kernels):
    """One cooperative kernel in the shared regimes; init and reduce in the
    global one, and finish only where a min channel holds order keys."""
    from hyperspace_tpu_torch.ops.segment_reduce import kernels_per_launch

    assert kernels_per_launch(regime, fns) == kernels

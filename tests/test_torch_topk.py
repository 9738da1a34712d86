"""The port's top-k (K3's plain version, and the wrapper on the CPU) held
exactly to the JAX package's Pallas top-k, run in interpret mode.

Exactly means: the same indices, and values equal under `==`. The order
is by value descending, NaN counted as -inf, ties to the lowest column.
The reference's two venues differ on signed zeros (the Pallas kernel
treats -0.0 and +0.0 as a tie; `lax.top_k` orders +0.0 above -0.0); the
port follows the kernel, and one test pins the difference. They also
differ on a row with fewer than k values above -inf: the Pallas kernel
masks a taken lane by writing -inf into it, so once only -inf is left it
takes the same lane again and again, while `lax.top_k` (and the port)
gives the remaining columns in order. There the port is held to
`lax.top_k`'s indices, and one test pins the kernel's repeats.
"""

import numpy as np
import pytest
import torch

from hyperspace_tpu.ops.topk import topk as ref_topk
from hyperspace_tpu_torch.ops.topk import (
    DIGIT_BITS, HIST_BINS, LAUNCHES_RADIX, MAX_K, MIN_CHUNK, SMALL_N, launches_per_call, merge_passes, select_plan,
    topk, topk_plain, workspace_bytes,
)


def _scores(kind: str, q: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.standard_normal((q, n)).astype(np.float32)
    if kind == "ties":
        # Integer values in [0, 8): long runs of ties inside every
        # 2048-column tile of the reference and across tiles.
        return rng.integers(0, 8, (q, n)).astype(np.float32)
    if kind == "nan":
        x = np.round(rng.standard_normal((q, n)) * 2).astype(np.float32)
        x[0, :] = np.nan  # an all-NaN row
        x[1, rng.integers(0, n, 40)] = np.nan
        x[2, rng.integers(0, n, 40)] = -np.inf
        x[3, :] = -np.inf
        x[3, rng.integers(0, n, 5)] = np.nan
        return x
    if kind == "signed_zeros":
        # Within one reference tile (n <= 2048): zeros of both signs tie.
        x = np.full((q, n), -3.0, np.float32)
        x[:, rng.integers(0, n, 30)] = -0.0
        x[:, rng.integers(0, n, 30)] = 0.0
        x[:, rng.integers(0, n, 3)] = 1.0
        return x
    raise ValueError(kind)


def _both(x: np.ndarray, k: int):
    """(reference Pallas, port plain, port wrapper on the CPU), each as
    numpy (values, indices)."""
    rv, ri = ref_topk(x, k, impl="pallas")
    pv, pi = topk_plain(torch.from_numpy(x), k)
    wv, wi = topk(torch.from_numpy(x), k)
    return (np.asarray(rv), np.asarray(ri)), (pv.numpy(), pi.numpy()), (wv.numpy(), wi.numpy())


def _assert_exact(got, want, inf_idx=None):
    """Indices equal and values equal under ==. With `inf_idx`, the
    indices of the -inf slots are held to `inf_idx` instead of `want`."""
    (gv, gi), (wv, wi) = got, want
    assert gi.shape == wi.shape and gi.dtype == np.int32
    assert np.all((gv == wv) | (np.isnan(gv) & np.isnan(wv))), "values differ under =="
    if inf_idx is not None:
        wi = np.where(np.isneginf(wv), inf_idx, wi)
    np.testing.assert_array_equal(gi, wi)


# (kind, q, n, k): rows of 5000 columns (not a multiple of the reference's
# 2048-column tile) at k = 1, 10, 64 and 100 (impl="pallas" forces the
# kernel past its auto limit of 64); the routing width n = 64; k > n;
# signed zeros inside one tile.
CASES = [
    ("random", 4, 5000, 1), ("random", 4, 5000, 10), ("random", 4, 5000, 64), ("random", 4, 5000, 100),
    ("ties", 4, 5000, 10), ("ties", 4, 5000, 64), ("ties", 4, 5000, 100),
    ("nan", 4, 5000, 10), ("nan", 4, 5000, 100),
    ("random", 4, 64, 8), ("ties", 4, 64, 8), ("ties", 4, 64, 100),
    ("signed_zeros", 4, 1500, 10),
]


@pytest.mark.parametrize("kind,q,n,k", CASES)
def test_port_topk_equals_reference_pallas_exactly(kind, q, n, k):
    x = _scores(kind, q, n, seed=n + k)
    ref, plain, wrapper = _both(x, k)
    assert plain[0].shape == (q, min(k, n))
    # Slots of value -inf: lax.top_k's indices (see the module docstring).
    inf_idx = np.asarray(ref_topk(x, k, impl="xla")[1]) if np.isneginf(ref[0]).any() else None
    _assert_exact(plain, ref, inf_idx)
    _assert_exact(wrapper, ref, inf_idx)


@pytest.mark.parametrize("kind,q,n,k", [c for c in CASES if c[0] != "signed_zeros"])
def test_port_topk_equals_reference_xla_without_signed_zeros(kind, q, n, k):
    x = _scores(kind, q, n, seed=n + k)
    xv, xi = ref_topk(x, k, impl="xla")
    pv, pi = topk_plain(torch.from_numpy(x), k)
    _assert_exact((pv.numpy(), pi.numpy()), (np.asarray(xv), np.asarray(xi)))


def test_port_topk_of_a_1d_row():
    x = _scores("ties", 1, 5000, seed=3)[0]
    rv, ri = ref_topk(x, 10, impl="pallas")
    pv, pi = topk_plain(torch.from_numpy(x), 10)
    wv, wi = topk(torch.from_numpy(x), 10)
    assert pv.shape == (10,) and wv.shape == (10,)
    _assert_exact((pv.numpy(), pi.numpy()), (np.asarray(rv), np.asarray(ri)))
    _assert_exact((wv.numpy(), wi.numpy()), (np.asarray(rv), np.asarray(ri)))


def test_reference_venues_differ_on_signed_zeros_and_the_port_follows_pallas():
    x = np.full((1, 600), -5.0, np.float32)
    x[0, 0], x[0, 1] = -0.0, 0.0
    pv, pi = ref_topk(x, 2, impl="pallas")
    xv, xi = ref_topk(x, 2, impl="xla")
    np.testing.assert_array_equal(np.asarray(pi), [[0, 1]])  # a tie: lowest column first
    np.testing.assert_array_equal(np.asarray(xi), [[1, 0]])  # +0.0 ranked above -0.0
    assert np.signbit(np.asarray(xv)).tolist() == [[False, True]]
    v, i = topk_plain(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(i.numpy(), np.asarray(pi))
    assert (v.numpy() == np.asarray(pv)).all() and not np.signbit(v.numpy()).any()


def test_reference_pallas_repeats_a_lane_once_only_minus_inf_is_left():
    x = np.full((2, 600), np.nan, np.float32)
    x[1, 7] = 2.0
    pv, pi = ref_topk(x, 3, impl="pallas")
    xv, xi = ref_topk(x, 3, impl="xla")
    np.testing.assert_array_equal(np.asarray(pi), [[0, 0, 0], [7, 0, 0]])
    np.testing.assert_array_equal(np.asarray(xi), [[0, 1, 2], [7, 0, 1]])
    v, i = topk_plain(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(xi))
    np.testing.assert_array_equal(v.numpy(), np.asarray(pv))


# (q, n): the routing shape, the one-launch limit and one past it, the
# candidates and brute-force shapes at q = 32, q = 1, a ragged n and a
# row that MIN_CHUNK cuts short of the SMs' share.
@pytest.mark.parametrize(
    "q,n",
    [(32, 64), (1, 1), (32, SMALL_N), (32, SMALL_N + 1), (32, 687_464), (32, 1_000_000), (1, 1_000_000),
     (3, 28_673), (200, 50_000), (1, 20_000)],
)
def test_select_plan_splits_every_row_into_nonempty_chunks(q, n):
    """Block b of a row takes columns [b·chunk, min((b+1)·chunk, n)): the
    blocks cover every column once, none is empty, there are at most
    ceil(n / MIN_CHUNK) of them, and they fill the SMs in one wave (4 an
    SM) once the row is long enough."""
    sms = 132
    blocks, chunk = select_plan(q, n, sms)
    if n <= SMALL_N:
        assert (blocks, chunk) == (0, n) and launches_per_call(n, 10) == launches_per_call(n, n) == 1
        return
    assert launches_per_call(n, 10) == launches_per_call(n, MAX_K) == LAUNCHES_RADIX == 8
    covered = np.zeros(n, np.int32)
    for b in range(blocks):
        lo, hi = b * chunk, min((b + 1) * chunk, n)
        assert lo < hi
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert blocks <= -(-n // MIN_CHUNK)
    assert n % 4 or chunk % 4 == 0  # float4 loads where the row allows them
    assert q * blocks <= max(4 * sms, q)  # one wave of blocks
    if n >= 4 * sms * MIN_CHUNK // q and q <= 4 * sms:
        assert q * blocks > 4 * sms - q  # and a full one
    assert workspace_bytes(q, 10, blocks) == 8 * q * 10 + 4 * q * (blocks * HIST_BINS + blocks + 4)


@pytest.mark.parametrize(
    "k,passes",
    [(1, 0), (MAX_K, 0), (MAX_K + 1, 1), (2 * MAX_K, 1), (2 * MAX_K + 1, 2), (5_000, 2), (4 * MAX_K, 2),
     (4 * MAX_K + 1, 3), (50_000, 5)],
)
def test_merge_passes_pair_the_runs_until_one_is_left(k, passes):
    """Past MAX_K the candidates are sorted in runs of MAX_K and merged in
    pairs: ceil(log2(runs)) passes, each a launch beside the radix select's
    (the run sort takes the sort's place); the workspace doubles the
    candidate list for the merge's second buffer."""
    assert merge_passes(k) == passes
    n = max(k, SMALL_N + 1)
    assert launches_per_call(n, k) == LAUNCHES_RADIX + passes
    assert launches_per_call(n, n + 7) == launches_per_call(n, n)  # k is cut to n
    blocks, _ = select_plan(32, n, 132)
    copies = 2 if k > MAX_K else 1
    assert workspace_bytes(32, k, blocks) == 8 * 32 * k * copies + 4 * 32 * (blocks * HIST_BINS + blocks + 4)


def test_topk_above_max_k_on_the_cpu_cuts_k_to_n():
    rng = np.random.default_rng(11)
    x = torch.from_numpy(np.round(rng.standard_normal((3, 7_000)) * 4).astype(np.float32))
    vals, idx = topk(x, 9_000)
    want_vals, want_idx = topk_plain(x, 7_000)
    assert vals.shape == (3, 7_000)
    assert torch.equal(idx, want_idx) and torch.equal(vals, want_vals)
    assert (np.diff(vals.numpy(), axis=1) <= 0).all()


def test_radix_digits_cover_the_32_bit_key_in_the_histogram():
    assert sum(DIGIT_BITS) == 32
    assert HIST_BINS == 2 ** max(DIGIT_BITS)
    assert LAUNCHES_RADIX == 2 * len(DIGIT_BITS) + 2


def test_topk_rejects_what_it_does_not_take():
    from hyperspace_tpu_torch.exceptions import HyperspaceError

    with pytest.raises(HyperspaceError, match="float32"):
        topk(torch.zeros((2, 3), dtype=torch.float64), 1)
    with pytest.raises(HyperspaceError, match="float32"):
        topk(torch.zeros((2, 3, 4)), 1)

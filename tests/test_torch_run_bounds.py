"""K2 (batched run bounds): the port's plain version against the JAX package.

Seeded numpy codes — duplicates, keys absent from the other side,
negative (null) codes, empty buckets, pads at the int32 max — go to the
JAX package's Pallas kernel `_make_run_bounds_kernel(128, ls, interpret=True)`
(run as its own CPU tests run it: interpreted, inside its interpret-work
bound B·Lp·Ls <= 2^24, with Lp a multiple of its 128-row tile) and to the
port's `run_bounds_plain` and `run_bounds` on the CPU. The bounds are
integers: both must be exactly equal, pads included. Unpadded widths are
held to `np.searchsorted` row by row. Cases in the join's own layout
(primary sorted within each row, nulls first, pads last) cover what the
card's windowed kernel treats apart: runs of equal keys longer than a
tile, a bucket of one key, a primary row of pads.

`bounds_plan`, the kernel's launch geometry, is pinned here too. The CUDA
kernel itself is held to the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from hyperspace_tpu.ops.sortkeys import _make_run_bounds_kernel
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.ops import sortkeys
from hyperspace_tpu_torch.ops.segment_reduce import SMEM_OPTIN
from hyperspace_tpu_torch.ops.sortkeys import ROWS_PER_THREAD, bounds_plan, run_bounds, run_bounds_plain

MAX = np.iinfo(np.int32).max
TILE = 128


def _codes(rng, b, lp, ls, domain, empty_buckets=()):
    """pk [b, lp] unsorted primary codes and sk [b, ls] sorted secondary
    codes, each row holding a random number of real codes then pads; the
    primary's nulls are -2 and the secondary's -1, as the join's
    factorization gives them."""
    pk = np.full((b, lp), MAX, np.int32)
    sk = np.full((b, ls), MAX, np.int32)
    for i in range(b):
        n_p = 0 if i in empty_buckets else int(rng.integers(lp // 2, lp + 1))
        n_s = 0 if i in empty_buckets else int(rng.integers(ls // 2, ls + 1))
        p = rng.integers(0, domain, n_p).astype(np.int32)
        p[rng.random(n_p) < 0.05] = -2
        s = rng.integers(0, domain, n_s).astype(np.int32)
        s[rng.random(n_s) < 0.05] = -1
        pk[i, :n_p] = p
        sk[i, :n_s] = np.sort(s)
    return pk, sk


@pytest.mark.parametrize(
    "b,lp,ls,domain,empty",
    [
        (1, 128, 300, 50, ()),       # heavy duplicates on both sides
        (3, 256, 1000, 4000, (1,)),  # sparse keys, one empty bucket
        (8, 384, 2000, 700, (0, 5)),  # eight buckets, two of them empty
    ],
)
def test_plain_equals_the_jax_package_interpreted_kernel(b, lp, ls, domain, empty):
    assert b * lp * ls <= 1 << 24 and lp % TILE == 0
    pk, sk = _codes(np.random.default_rng(b * 1000 + ls), b, lp, ls, domain, empty)
    want_st, want_en = (np.asarray(a) for a in _make_run_bounds_kernel(TILE, ls, True)(pk, sk))
    for fn in (run_bounds_plain, run_bounds):
        st, en = fn(torch.from_numpy(pk), torch.from_numpy(sk))
        assert st.dtype == en.dtype == torch.int32
        np.testing.assert_array_equal(st.numpy(), want_st)
        np.testing.assert_array_equal(en.numpy(), want_en)
    # The pads' bounds are part of the function: st counts the real
    # entries, en the whole row.
    real_s = (sk < MAX).sum(axis=1)
    pads = pk == MAX
    np.testing.assert_array_equal(want_st[pads], np.broadcast_to(real_s[:, None], pk.shape)[pads])
    assert (want_en[pads] == ls).all()


@pytest.mark.parametrize("b,lp,ls", [(1, 1, 1), (2, 77, 5), (5, 300, 1), (4, 1, 900), (3, 1000, 640)])
def test_unpadded_widths_match_numpy_searchsorted(b, lp, ls):
    pk, sk = _codes(np.random.default_rng(lp + ls), b, lp, ls, max(ls // 3, 2))
    st, en = run_bounds(torch.from_numpy(pk), torch.from_numpy(sk))
    for i in range(b):
        np.testing.assert_array_equal(st[i].numpy(), np.searchsorted(sk[i], pk[i], side="left"))
        np.testing.assert_array_equal(en[i].numpy(), np.searchsorted(sk[i], pk[i], side="right"))


def test_empty_shapes():
    st, en = run_bounds(torch.full((3, 4), 7, dtype=torch.int32), torch.zeros((3, 0), dtype=torch.int32))
    assert st.shape == en.shape == (3, 4) and not st.any() and not en.any()
    st, en = run_bounds(torch.zeros((2, 0), dtype=torch.int32), torch.zeros((2, 5), dtype=torch.int32))
    assert st.shape == en.shape == (2, 0)


def test_the_wrapper_counts_no_launch_on_the_cpu():
    before = run_bounds.launches
    run_bounds(torch.zeros((1, 4), dtype=torch.int32), torch.zeros((1, 4), dtype=torch.int32))
    assert run_bounds.launches == before


@pytest.mark.parametrize(
    "pk,sk",
    [
        (torch.zeros((2, 4), dtype=torch.int64), torch.zeros((2, 4), dtype=torch.int32)),
        (torch.zeros((2, 4), dtype=torch.int32), torch.zeros((3, 4), dtype=torch.int32)),
        (torch.zeros(4, dtype=torch.int32), torch.zeros((1, 4), dtype=torch.int32)),
        (torch.zeros((4, 2), dtype=torch.int32).t(), torch.zeros((2, 4), dtype=torch.int32)),
    ],
    ids=["dtype", "buckets", "rank", "contiguity"],
)
def test_the_wrapper_rejects_what_the_kernel_does_not_take(pk, sk):
    for fn in (run_bounds_plain, run_bounds):
        with pytest.raises(HyperspaceError):
            fn(pk, sk)


def _join_layout(rng, b, lp, ls, domain):
    """pk [b, lp] and sk [b, ls] as the joins give them: each row sorted,
    null codes (-2 primary, -1 secondary) first, pads at the int32 max
    last."""
    pk, sk = _codes(rng, b, lp, ls, domain)
    return np.sort(pk, axis=1), sk


def _long_runs(rng):
    """One bucket whose primary holds a run of 1,500 equal keys from row
    700 (longer than any tile, across two tile edges of 1,024 rows and
    three of 512) matching a run of 2,000 in the secondary."""
    b, lp, ls = 1, 3072, 4096
    p = np.concatenate([rng.integers(-2, 450, 700), np.full(1500, 450), rng.integers(451, 900, lp - 2300)])
    s = np.concatenate([rng.integers(-1, 900, ls - 2000), np.full(2000, 450)])
    pk = np.full((b, lp), MAX, np.int32)
    pk[0, : lp - 100] = np.sort(p)
    return pk, np.sort(s).astype(np.int32)[None, :]


def _one_key_bucket(rng):
    """Three buckets; the middle one holds key 5 alone on both sides."""
    pk, sk = _join_layout(rng, 3, 1024, 2048, 3000)
    pk[1, :] = 5
    sk[1, :] = 5
    return pk, sk


def _pad_row(rng):
    """Three buckets; the last one's primary row is all pads."""
    pk, sk = _join_layout(rng, 3, 1024, 2048, 3000)
    pk[2, :] = MAX
    return pk, sk


@pytest.mark.parametrize(
    "make",
    [
        lambda rng: _join_layout(rng, 4, 512, 2000, 1500),  # sparse keys, duplicates on both sides
        lambda rng: _join_layout(rng, 2, 2048, 1024, 300),  # the primary wider than the secondary
        _long_runs,
        _one_key_bucket,
        _pad_row,
    ],
    ids=["sorted rows", "primary wider", "runs longer than a tile", "one-key bucket", "all-pad primary row"],
)
def test_join_layout_equals_the_jax_package_interpreted_kernel(make):
    pk, sk = make(np.random.default_rng(11))
    b, lp = pk.shape
    if make is _long_runs:
        assert (pk[0, 700:2200] == 450).all() and pk[0, 699] < 450 < pk[0, 2200]
    ls = sk.shape[1]
    assert b * lp * ls <= 1 << 24 and lp % TILE == 0
    assert (np.diff(pk.astype(np.int64), axis=1) >= 0).all() and (np.diff(sk.astype(np.int64), axis=1) >= 0).all()
    want_st, want_en = (np.asarray(a) for a in _make_run_bounds_kernel(TILE, ls, True)(pk, sk))
    for fn in (run_bounds_plain, run_bounds):
        st, en = fn(torch.from_numpy(pk), torch.from_numpy(sk))
        np.testing.assert_array_equal(st.numpy(), want_st)
        np.testing.assert_array_equal(en.numpy(), want_en)


# The main path's shapes (B, Lp, Ls) on the H100's 132 SMs, and the
# geometry they take: J2 aligned (orders searched in lineitem buckets),
# J3 aligned (the reverse) and J2 without the index (one partition).
_MAIN_PATH_PLANS = [
    ((200, 7759, 31129), (256, 8, 1600, 5376, 21520)),
    ((200, 31129, 7759), (256, 31, 6200, 2048, 8208)),
    ((1, 1_500_000, 6_001_991), (256, 1465, 1465, 5376, 21520)),
]


@pytest.mark.parametrize("shape,plan", _MAIN_PATH_PLANS, ids=["J2 aligned", "J3 aligned", "J2 no index"])
def test_bounds_plan_at_the_main_path_shapes(shape, plan):
    assert bounds_plan(*shape, 132) == plan


_SHAPES = [(1, 1, 1), (3, 5, 0), (8, 1000, 700), (2, 50_000, 70_000), (7, 3000, 10), (1, 4096, 1_000_000),
           (200, 7759, 31129), (1, 1_500_000, 6_001_991)]


def _covered(b, lp, plan, lead):
    """How many times the blocks of `plan` take each primary row, with pk
    starting `lead` int32s past a 16-byte boundary: block i takes tiles i,
    i + grid, ... of the b * tiles, and tile k of bucket row j holds its
    rows from k * rows - off to (k + 1) * rows - off, where off is the
    row's start past a 16-byte boundary (csrc/run_bounds.cu)."""
    threads, tiles, grid, _, _ = plan
    rows = ROWS_PER_THREAD * threads
    cover = np.zeros((b, lp), np.int64)
    for block in range(grid):
        for t in range(block, b * tiles, grid):
            j, k = divmod(t, tiles)
            off = (lead + j * lp) % 4
            cover[j, max(0, k * rows - off) : max(0, (k + 1) * rows - off)] += 1
    return cover


@pytest.mark.parametrize("b,lp,ls", [s for s in _SHAPES if s[0] * s[1] <= 2_000_000])
@pytest.mark.parametrize("sms", [1, 132])
def test_bounds_plan_covers_every_primary_row_once(b, lp, ls, sms):
    threads, tiles, grid, _, _ = plan = bounds_plan(b, lp, ls, sms)
    rows = ROWS_PER_THREAD * threads
    assert (tiles - 1) * rows < lp + 3 <= tiles * rows
    assert grid == b * tiles
    for lead in range(4):
        assert (_covered(b, lp, plan, lead) == 1).all()


def test_bounds_plan_folds_a_grid_past_the_limit(monkeypatch):
    """Past MAX_GRID the blocks loop over the tiles, and still take every
    row once."""
    monkeypatch.setattr(sortkeys, "MAX_GRID", 7)
    plan = bounds_plan(5, 3000, 100, 132)
    assert plan[2] == 7 < 5 * plan[1]
    for lead in range(4):
        assert (_covered(5, 3000, plan, lead) == 1).all()


@pytest.mark.parametrize("b,lp,ls", _SHAPES + [(2**20, 2**21, 2**21), (1, 2**31 - 1, 2**31 - 1), (3, 10, 2**31 - 1)])
@pytest.mark.parametrize("sms", [1, 132, 1000])
def test_bounds_plan_stays_within_the_cards_limits(b, lp, ls, sms):
    threads, tiles, grid, window, smem = bounds_plan(b, lp, ls, sms)
    assert threads in (sortkeys.THREADS, sortkeys.SMALL_THREADS) and threads % 32 == 0 and threads >= 96
    assert 1 <= grid <= min(b * tiles, 2**31 - 1)
    # The window budget: what a sorted tile spans with slack, within its
    # bounds and never past the row; staged, it fits the shared memory a
    # block may have.
    assert window <= sortkeys.MAX_WINDOW and window <= -(-ls // 4) * 4
    assert window >= min(sortkeys.MIN_WINDOW, -(-ls // 4) * 4)
    assert smem == 4 * (window + 4) <= SMEM_OPTIN

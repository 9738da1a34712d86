"""K2 (batched run bounds): the port's plain version against the JAX package.

Seeded numpy codes — duplicates, keys absent from the other side,
negative (null) codes, empty buckets, pads at the int32 max — go to the
JAX package's Pallas kernel `_make_run_bounds_kernel(128, ls, interpret=True)`
(run as its own CPU tests run it: interpreted, inside its interpret-work
bound B·Lp·Ls <= 2^24, with Lp a multiple of its 128-row tile) and to the
port's `run_bounds_plain` and `run_bounds` on the CPU. The bounds are
integers: both must be exactly equal, pads included. Unpadded widths are
held to `np.searchsorted` row by row.

The CUDA kernel itself is held to the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from hyperspace_tpu.ops.sortkeys import _make_run_bounds_kernel
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.ops.sortkeys import run_bounds, run_bounds_plain

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

"""Fused Aggregate(Join) channel program: the port against the JAX package.

The same padded inputs — primary codes `pk` [B, Lp] and secondary codes
`sk` [B, Ls] sorted within each bucket row (pads at the int32 max, null
codes -2 / -1), channel values `pvals` / `svals`, group ids `gid` with
pads on the dead group K — go to the JAX package's
`ops.join_agg.fused_join_aggregate(..., fused="auto")` (its Pallas
run-bounds kernel engaged, interpreted on the CPU) and to the port's
`fused_join_aggregate` on the CPU. Every channel kind runs: star, p, s,
pmin, pmax, smin, smax, with NaN and ±inf in the extremum channels.

- star, integral sums and every extremum are bit-equal (NaN matches NaN).
- Non-integral sums are held to the float64 error bound below (u = 2^-53,
  γ_n = n·u/(1 − n·u) <= 1.01·n·u for n·u <= 0.01). Each implementation
  computes a group's sum from per-row terms w_i and folds them:
  * an `s` term is P[en] − P[st] over a per-bucket prefix sum P of the
    secondary values; each prefix is within γ_Ls·S_b of exact (S_b =
    Σ|v| over the bucket row), so the term is within 2·γ_Ls·S_b + u·|w_i|
    — its error scales with the bucket's prefix magnitude, not with the
    run's own sum;
  * a `p` term v_i·runlen_i is within u·|w_i|;
  * folding the group's n rows (plus the B − 1 bucket partials of the
    JAX package's per-bucket fold) adds at most γ_{n+B}·Σ|w_i|.
  Two implementations differ by at most the sum of their two errors, so
  tol = 2·(Σ_i 2·γ_Ls·S_b(i) + γ_{n+B}·Σ_i|w_i|), the first term for `s`
  channels only.
"""

import numpy as np
import pytest
import torch

from hyperspace_tpu import stats
from hyperspace_tpu.ops.join_agg import fused_join_aggregate as jax_fused_join_aggregate
from hyperspace_tpu_torch.ops.join_agg import fused_join_aggregate
from hyperspace_tpu_torch.ops.segment_reduce import segment_reduce
from hyperspace_tpu_torch.ops.sortkeys import run_bounds

MAX = np.iinfo(np.int32).max
U = 2.0**-53

# p/s arrays: 0 integral, 1 non-integral, 2 extremum (min), 3 extremum (max).
CHANNELS = (
    ("star",), ("p", 0), ("p", 1), ("s", 0), ("s", 1),
    ("pmin", 2), ("pmax", 3), ("smin", 2), ("smax", 3), ("pmax", 0), ("smin", 0),
)
EXACT = {0, 1, 3, 5, 6, 7, 8, 9, 10}


def _gamma(n):
    n = np.asarray(n, np.float64)
    assert np.all(n * U <= 0.01)
    return 1.01 * n * U


def _inputs(rng, b, lp, ls, k, domain):
    pk = np.full((b, lp), MAX, np.int32)
    sk = np.full((b, ls), MAX, np.int32)
    gid = np.full((b, lp), k, np.int32)
    for i in range(b):
        n_p = int(rng.integers(lp // 2, lp + 1)) if i != 1 else 0  # bucket 1: empty primary
        n_s = int(rng.integers(ls // 2, ls + 1)) if i != 2 else 0  # bucket 2: empty secondary
        p = rng.integers(0, domain, n_p).astype(np.int32)
        p[rng.random(n_p) < 0.05] = -2
        s = rng.integers(0, domain, n_s).astype(np.int32)
        s[rng.random(n_s) < 0.05] = -1
        pk[i, :n_p] = np.sort(p)
        sk[i, :n_s] = np.sort(s)
        gid[i, :n_p] = rng.integers(0, k, n_p)

    def channels(keys):
        real = keys < MAX
        shape = keys.shape
        out = np.zeros((4, *shape))
        out[0] = rng.integers(-50, 50, shape)
        out[1] = rng.normal(size=shape) * 1e3
        for c, ident in ((2, np.inf), (3, -np.inf)):
            v = rng.normal(size=shape) * 1e3
            special = rng.random(shape)
            v[special < 0.03] = np.nan
            v[(special >= 0.03) & (special < 0.06)] = np.inf
            v[(special >= 0.06) & (special < 0.09)] = -np.inf
            v[special >= 0.97] = ident  # null slots carry the identity
            out[c] = v
        out[0:2][:, ~real] = 0.0  # sum channels: pads are zero
        out[2][~real] = np.inf  # extremum channels: pads are the identity
        out[3][~real] = -np.inf
        return out

    return pk, sk, channels(pk), channels(sk), gid


def _tolerance(pk, sk, pvals, svals, gid, k, ch):
    """The bound of the module docstring for one non-integral channel."""
    b, lp = pk.shape
    ls = sk.shape[1]
    st = np.stack([np.searchsorted(sk[i], pk[i], "left") for i in range(b)])
    en = np.stack([np.searchsorted(sk[i], pk[i], "right") for i in range(b)])
    real = pk < MAX
    runlen = np.where(real, en - st, 0)
    if ch[0] == "p":
        abs_w = np.abs(pvals[ch[1]] * runlen)
        prefix_err = np.zeros_like(abs_w)
    else:
        a = np.abs(svals[ch[1]])
        cum = np.concatenate([np.zeros((b, 1)), np.cumsum(a, axis=1)], axis=1)
        abs_w = np.where(real, np.take_along_axis(cum, en, 1) - np.take_along_axis(cum, st, 1), 0.0)
        s_b = a.sum(axis=1, keepdims=True)
        prefix_err = np.where(real, 2 * _gamma(ls) * s_b, 0.0)
    g = gid.reshape(-1)
    rows = np.bincount(g, minlength=k + 1)[:k]
    sum_abs = np.bincount(g, weights=abs_w.reshape(-1), minlength=k + 1)[:k]
    sum_prefix = np.bincount(g, weights=prefix_err.reshape(-1), minlength=k + 1)[:k]
    return 2 * (sum_prefix + _gamma(rows + b) * sum_abs)


@pytest.mark.parametrize(
    "b,lp,ls,k,domain",
    [(4, 256, 512, 7, 300), (3, 128, 1024, 40, 5000), (6, 384, 256, 1, 60)],
)
def test_port_matches_the_jax_package(b, lp, ls, k, domain):
    pk, sk, pvals, svals, gid = _inputs(np.random.default_rng(b * 100 + k), b, lp, ls, k, domain)
    before = stats.get("device.kernel.fused"), stats.get("device.kernel.fallbacks")
    want = jax_fused_join_aggregate(pk, sk, pvals, svals, gid, k, CHANNELS, fused="auto")
    # The Pallas run bounds ran, with no fallback to the lax searchsorted.
    assert stats.get("device.kernel.fused") > before[0]
    assert stats.get("device.kernel.fallbacks") == before[1]
    t = torch.from_numpy
    got = fused_join_aggregate(t(pk), t(sk), t(pvals), t(svals), t(gid), k, CHANNELS).numpy()
    assert got.shape == want.shape == (len(CHANNELS), k)
    assert want[0].sum() > 0  # the inputs do match
    for c, ch in enumerate(CHANNELS):
        if c in EXACT:
            np.testing.assert_array_equal(got[c], want[c], err_msg=str(ch))
        else:
            tol = _tolerance(pk, sk, pvals, svals, gid, k, ch)
            assert np.all(np.abs(got[c] - want[c]) <= tol), ch


def test_the_port_launches_no_kernel_on_the_cpu():
    pk, sk, pvals, svals, gid = _inputs(np.random.default_rng(5), 2, 16, 32, 3, 20)
    before = (run_bounds.launches, segment_reduce.launches)
    t = torch.from_numpy
    fused_join_aggregate(t(pk), t(sk), t(pvals), t(svals), t(gid), 3, CHANNELS)
    assert (run_bounds.launches, segment_reduce.launches) == before

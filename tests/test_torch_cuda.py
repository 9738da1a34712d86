"""Card-only tests of the port: the CUDA kernel against its plain version,
and the slice on the card against the slice on the CPU.

They skip where there is no CUDA card. This file imports neither JAX nor
the JAX package, so it also runs on a machine without them:

    python -m pytest tests/test_torch_cuda.py -m gpu --noconftest -q
"""

import numpy as np
import pandas as pd
import pytest
import torch

from hyperspace_tpu_torch.ops.segment_reduce import segment_reduce, segment_reduce_plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(rng, n, k, c_num, integral):
    gid = rng.integers(0, k, n).astype(np.int32)
    if integral:
        vals = rng.integers(-1000, 1000, (c_num, n)).astype(np.float64)
    else:
        vals = rng.normal(size=(c_num, n)) * 1e3
    special = rng.integers(0, n, 30)
    vals[2:, special[:10]] = np.nan
    vals[2:, special[10:20]] = np.inf
    vals[2:, special[20:]] = -np.inf
    return gid, vals


FNS = ("sum", "sum", "min", "max", "min", "max")


@pytest.mark.gpu
@pytest.mark.parametrize(
    "n,k,c_num",
    [(1, 1, 6), (1000, 5, 6), (300_000, 6, 6), (300_000, 5_000, 6), (300_000, 200_000, 6),
     # 70 aggregates' worth of channels: three launches of at most 64.
     (200_000, 6, 140), (200_000, 200_000, 140)],
)
def test_kernel_is_bit_equal_to_plain_on_exact_channels(cuda, n, k, c_num):
    fns = (FNS * 24)[:c_num]
    rng = np.random.default_rng(n + k + c_num)
    gid, vals = _inputs(rng, n, k, c_num, integral=True)
    before = segment_reduce.launches
    got = segment_reduce(torch.from_numpy(vals).to(cuda), torch.from_numpy(gid).to(cuda), k, fns)
    torch.cuda.synchronize()
    assert segment_reduce.launches == before + -(-c_num // 64)
    want = segment_reduce_plain(torch.from_numpy(vals), torch.from_numpy(gid), k, fns)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("k", [6, 100_000])
def test_kernel_non_integral_sums_within_rtol_of_abs_sum(cuda, k):
    rng = np.random.default_rng(k)
    n = 500_000
    gid, vals = _inputs(rng, n, k, len(FNS), integral=False)
    got = segment_reduce(torch.from_numpy(vals).to(cuda), torch.from_numpy(gid).to(cuda), k, FNS).cpu().numpy()
    want = segment_reduce_plain(torch.from_numpy(vals), torch.from_numpy(gid), k, FNS).numpy()
    for c in range(2):
        # Two float64 summation orders differ by up to 2(m-1)u·Σ|v| for a
        # group of m rows (u = 2^-53); 1e-12 covers groups below ~4500 rows.
        rows = np.bincount(gid, minlength=k)
        bound = np.maximum(1e-12, 2 * np.maximum(rows - 1, 0) * 2.0**-53)
        tol = bound * np.bincount(gid, weights=np.abs(vals[c]), minlength=k)
        assert np.all(np.abs(got[c] - want[c]) <= tol)
    np.testing.assert_array_equal(got[2:], want[2:])


def _assert_equal_to_plain(vals, gid, k, fns, cuda):
    """The kernel's result bit-equal to the plain version's (NaN = NaN),
    and one launch per block of 64 channels."""
    before = segment_reduce.launches
    got = segment_reduce(torch.from_numpy(vals).to(cuda), torch.from_numpy(gid).to(cuda), k, fns)
    torch.cuda.synchronize()
    assert segment_reduce.launches == before + -(-len(fns) // 64)
    keep = (gid >= 0) & (gid < k)  # the plain version takes only ids in [0, k); the kernel skips the rest
    want = segment_reduce_plain(torch.from_numpy(vals[:, keep]), torch.from_numpy(gid[keep]), k, fns)
    assert got.shape == want.shape == (len(fns), k)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def _runs(rng, n, longest):
    """Non-decreasing group ids in runs of 1 to `longest` rows, as a
    source written in key order gives them. Returns (gid, K)."""
    starts = np.cumsum(rng.integers(1, longest + 1, n))
    gid = np.searchsorted(starts, np.arange(n), side="right").astype(np.int32)
    return gid, int(gid[-1]) + 1


_K1_FNS = ("sum", "min", "max", "sum")


@pytest.mark.gpu
@pytest.mark.parametrize(
    "case",
    ["one group", "one run, many groups", "runs of one", "runs of one to seven", "sorted runs with nan",
     "skipped ids, few groups", "skipped ids, block", "skipped ids, many groups", "no rows", "one group, one row"],
)
def test_segment_reduce_hard_cases_equal_plain(cuda, case):
    """K1's hard cases for its three regimes, bit-equal to the plain
    version on integral sums, extrema (NaN and ±inf included) and counts:
    one group over 6M rows (a run spanning every block) in the lanes
    regime and in the global one (one id among 1.5M groups), runs of one
    row (K = n) and of one to seven, NaN inside a run, ids -1 and K
    (skipped) in each regime, no rows, and K = 1."""
    from hyperspace_tpu_torch.ops.segment_reduce import _sm_count, reduce_plan

    rng = np.random.default_rng(len(case))
    n = {"one group": 6_000_000, "one run, many groups": 6_000_000, "no rows": 0, "one group, one row": 1}.get(case, 1_000_000)
    vals = rng.integers(-1000, 1000, (len(_K1_FNS), n)).astype(np.float64)
    vals[3] = 1.0  # a count channel
    if case == "one group" or case == "one group, one row":
        gid, k = np.zeros(n, np.int32), 1
    elif case == "one run, many groups":
        gid, k = np.full(n, 7, np.int32), 1_500_000
    elif case == "runs of one":
        gid, k = np.arange(n, dtype=np.int32), n
    elif case in ("runs of one to seven", "sorted runs with nan"):
        gid, k = _runs(rng, n, 7)
    elif case == "no rows":
        gid, k = np.zeros(0, np.int32), 5
    else:
        k = {"skipped ids, few groups": 6, "skipped ids, block": 3000, "skipped ids, many groups": 300_000}[case]
        gid = rng.integers(-1, k + 1, n).astype(np.int32)  # -1 and k are outside [0, k)
    if case == "sorted runs with nan":
        at = rng.integers(0, n, 40)
        vals[1:3, at[:20]] = np.nan
        vals[1:3, at[20:30]] = np.inf
        vals[1:3, at[30:]] = -np.inf
    regime = reduce_plan(len(_K1_FNS), k, n, _sm_count(torch.cuda.current_device()))[0]
    assert regime == {"one group": "lanes", "skipped ids, few groups": "lanes", "no rows": "lanes",
                      "one group, one row": "lanes", "skipped ids, block": "block"}.get(case, "global")
    _assert_equal_to_plain(vals, gid, k, _K1_FNS, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("c_num", [64, 65])
@pytest.mark.parametrize("k", [1, 6, 200_000])
def test_segment_reduce_at_64_and_65_channels(cuda, c_num, k):
    """One launch carries 64 channels; 65 take two, each in the regime its
    own channels give."""
    rng = np.random.default_rng(c_num + k)
    n = 300_000
    gid = rng.integers(0, k, n).astype(np.int32)
    vals = rng.integers(-50, 50, (c_num, n)).astype(np.float64)
    vals[:, rng.integers(0, n, 20)] = np.nan
    fns = (_K1_FNS * 17)[:c_num]
    _assert_equal_to_plain(vals, gid, k, fns, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [6, 50_000])
def test_segment_reduce_non_integral_sums_over_runs_within_the_bound(cuda, k):
    """Non-integral sums over sorted runs (combined in the warp before the
    atomic) and over few groups (the lanes regime's registers),
    within the two-order float64 bound of test_kernel_non_integral_sums."""
    rng = np.random.default_rng(k)
    n = 2_000_000
    gid = np.sort(rng.integers(0, k, n)).astype(np.int32)
    vals = rng.normal(size=(2, n)) * 1e3
    got = segment_reduce(torch.from_numpy(vals).to(cuda), torch.from_numpy(gid).to(cuda), k, ("sum", "sum"))
    want = segment_reduce_plain(torch.from_numpy(vals), torch.from_numpy(gid), k, ("sum", "sum")).numpy()
    rows = np.bincount(gid, minlength=k)
    bound = np.maximum(1e-12, 2 * np.maximum(rows - 1, 0) * 2.0**-53)
    for c in range(2):
        tol = bound * np.bincount(gid, weights=np.abs(vals[c]), minlength=k)
        assert np.all(np.abs(got[c].cpu().numpy() - want[c]) <= tol)


@pytest.mark.gpu
def test_segment_reduce_on_the_card_never_calls_a_library_reduce(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a library reduction was called on the card")

    rng = np.random.default_rng(3)
    n = 500_000
    vals = torch.from_numpy(rng.integers(-9, 9, (4, n)).astype(np.float64)).to(cuda)
    gids = {k: torch.from_numpy(rng.integers(0, k, n).astype(np.int32)).to(cuda) for k in (6, 3000, 400_000)}
    for name in ("scatter_reduce_", "scatter_reduce", "index_add_", "index_add", "scatter_add_", "scatter_add"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
        if hasattr(torch, name):
            monkeypatch.setattr(torch, name, refuse)
    for k, gid in gids.items():  # the lanes, block and global regimes
        out = segment_reduce(vals, gid, k, _K1_FNS)
        assert out.shape == (4, k)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_slice_on_the_card_matches_the_cpu(cuda, tmp_path):
    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig, col
    from hyperspace_tpu_torch.datagen import gen_tpch_lineitem

    gen_tpch_lineitem(tmp_path / "li", sf=0.01)
    out = {}
    for dev in ("cuda", "cpu"):
        s = HyperspaceSession(system_path=str(tmp_path / f"idx_{dev}"), num_buckets=16, device=dev)
        df = s.parquet(tmp_path / "li")
        Hyperspace(s).create_index(
            df, IndexConfig("ix", ["l_orderkey"], ["l_quantity", "l_extendedprice"])
        )
        s.enable_hyperspace()
        before = segment_reduce.launches
        out[dev] = (
            s.to_pandas(df.filter(col("l_orderkey").isin([3, 700, 9000])).select("l_orderkey", "l_quantity")),
            s.to_pandas(df.aggregate(["l_returnflag"], [("sum", "l_quantity", "q"), ("count", None, "c")])),
            segment_reduce.launches - before,
        )
    assert out["cuda"][2] == 1 and out["cpu"][2] == 0
    for got, want in zip(out["cuda"][:2], out["cpu"][:2]):
        cols = list(want.columns)
        pd.testing.assert_frame_equal(
            got.sort_values(cols).reset_index(drop=True), want.sort_values(cols).reset_index(drop=True)
        )
    for b in range(16):
        f = f"ix/v__=0/bucket-{b:05d}.parquet"
        assert (tmp_path / "idx_cuda" / f).read_bytes() == (tmp_path / "idx_cpu" / f).read_bytes()


@pytest.mark.gpu
def test_forty_aggregates_on_the_card_match_the_cpu(cuda, tmp_path):
    from hyperspace_tpu_torch import HyperspaceSession
    from hyperspace_tpu_torch.datagen import gen_tpch_lineitem

    gen_tpch_lineitem(tmp_path / "li", sf=0.01)
    cols = [("sum", "l_quantity"), ("min", "l_extendedprice"), ("max", "l_discount"), ("count", None)]
    aggs = [(fn, c, f"a{i}") for i, (fn, c) in enumerate(cols * 10)]
    out = {}
    for dev in ("cuda", "cpu"):
        s = HyperspaceSession(system_path=str(tmp_path / f"idx_{dev}"), device=dev)
        before = segment_reduce.launches
        got = s.to_pandas(s.parquet(tmp_path / "li").aggregate(["l_returnflag", "l_linestatus"], aggs))
        out[dev] = (got.sort_values(["l_returnflag", "l_linestatus"]).reset_index(drop=True),
                    segment_reduce.launches - before)
    assert out["cuda"][1] == 2 and out["cpu"][1] == 0  # 80 channels: two launches
    pd.testing.assert_frame_equal(out["cuda"][0], out["cpu"][0])


def _run_bounds_inputs(rng, b, lp, ls, domain):
    """Unsorted primary codes and sorted secondary rows, pads at the
    int32 max, null codes -2 / -1."""
    big = np.iinfo(np.int32).max
    pk = np.full((b, lp), big, np.int32)
    sk = np.full((b, ls), big, np.int32)
    for i in range(b):
        n_p, n_s = int(rng.integers(lp // 2, lp + 1)), int(rng.integers(ls // 2, ls + 1))
        pk[i, :n_p] = rng.integers(-2, domain, n_p)
        sk[i, :n_s] = np.sort(rng.integers(-1, domain, n_s))
    return pk, sk


# (B, Lp, Ls, the regime the kernel picks). Shared when sk[b] fits the
# opt-in shared memory (about 58k keys) and Lp >= Ls; else global.
_K2_SHAPES = [
    (1, 1, 1, "shared"), (3, 5, 0, "shared"), (8, 1000, 700, "shared"),
    # the join's aligned shapes (200 buckets): J3 (lineitem primary), J2
    (200, 31000, 7600, "shared"), (200, 7600, 31000, "global"),
    # a secondary row past the shared-memory limit
    (2, 50_000, 70_000, "global"), (1, 1_500_000, 6_000_000, "global"),
]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,lp,ls,regime",
    # Each shape as the kernel picks it, and forced into the other regime
    # wherever sk[b] fits shared memory.
    [(b, lp, ls, "auto") for b, lp, ls, _ in _K2_SHAPES]
    + [(b, lp, ls, "global" if pick == "shared" else "shared") for b, lp, ls, pick in _K2_SHAPES if ls < 58_000],
)
def test_run_bounds_kernel_equals_plain_in_both_regimes(cuda, b, lp, ls, regime):
    from hyperspace_tpu_torch.ops.sortkeys import run_bounds, run_bounds_plain

    pk, sk = _run_bounds_inputs(np.random.default_rng(b + lp + ls), b, lp, ls, max(ls // 4, 3))
    pkt, skt = torch.from_numpy(pk).to(cuda), torch.from_numpy(sk).to(cuda)
    before = run_bounds.launches
    st, en = run_bounds(pkt, skt, regime=regime)
    torch.cuda.synchronize()
    assert run_bounds.launches == before + 1
    picked = next(pick for sb, slp, sls, pick in _K2_SHAPES if (sb, slp, sls) == (b, lp, ls))
    assert run_bounds.last_regime == (picked if regime == "auto" else regime)
    want_st, want_en = run_bounds_plain(pkt, skt)
    assert torch.equal(st, want_st) and torch.equal(en, want_en)


@pytest.mark.gpu
def test_join_queries_on_the_card_match_the_cpu(cuda, tmp_path):
    """J1 to J3 at sf=0.001 with the index enabled and disabled: the card
    launches K2 for every join and K1 for the fused aggregates, and gives
    the CPU's answer. Exact columns are equal; the non-integral sums `p`
    (over the secondary side, so prefix differences) are held to the bound
    of tests/test_torch_join.py, 2·(γ_{c+B}·c·max|v| + 2·c·γ_N·Σ|v|) for c
    pairs and a secondary side of N rows, γ_n = 1.01·n·2^-53."""
    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig
    from hyperspace_tpu_torch.datagen import gen_tpch_lineitem, gen_tpch_orders
    from hyperspace_tpu_torch.ops.sortkeys import run_bounds

    gen_tpch_lineitem(tmp_path / "li", sf=0.001)
    gen_tpch_orders(tmp_path / "o", sf=0.001)

    def queries(li, o):
        j = li.select("l_orderkey", "l_quantity", "l_extendedprice").join(
            o.select("o_orderkey", "o_totalprice", "o_orderpriority"), ["l_orderkey"], ["o_orderkey"]
        )
        return {
            "J1": j,
            "J2": j.aggregate(["o_orderpriority"], [("sum", "l_quantity", "q"), ("max", "l_extendedprice", "m"),
                                                   ("sum", "l_extendedprice", "p"), ("count", None, "c")]),
            "J3": j.aggregate(["l_quantity"], [("max", "o_totalprice", "m"), ("sum", "o_totalprice", "p"),
                                              ("count", None, "c")]),
        }

    out = {}
    for dev in ("cuda", "cpu"):
        s = HyperspaceSession(system_path=str(tmp_path / f"idx_{dev}"), num_buckets=8, device=dev)
        li, o = s.parquet(tmp_path / "li"), s.parquet(tmp_path / "o")
        Hyperspace(s).create_index(li, IndexConfig("li", ["l_orderkey"], ["l_quantity", "l_extendedprice"]))
        Hyperspace(s).create_index(o, IndexConfig("o", ["o_orderkey"], ["o_totalprice", "o_orderpriority"]))
        for indexed in (True, False):
            s.enable_hyperspace() if indexed else s.disable_hyperspace()
            for name, plan in queries(li, o).items():
                k2, k1 = run_bounds.launches, segment_reduce.launches
                out[dev, indexed, name] = s.to_pandas(plan)
                if dev == "cuda":
                    assert run_bounds.launches > k2
                    assert (segment_reduce.launches > k1) == (name != "J1")
                assert s.last_query_stats["join_path"] == (
                    "zero-exchange-aligned" if indexed else "single-partition"
                )
    import pyarrow.parquet as pq

    side = {}
    for name, table, column in (("J2", "li", "l_extendedprice"), ("J3", "o", "o_totalprice")):
        v = np.abs(pq.read_table(sorted(str(p) for p in (tmp_path / table).glob("*.parquet")))[column].to_numpy())
        side[name] = (len(v), v.sum(), v.max())
    for (dev, indexed, name), got in out.items():
        if dev != "cuda":
            continue
        want = out["cpu", indexed, name]
        keys = list(want.columns) if name == "J1" else [want.columns[0]]
        got = got.sort_values(keys).reset_index(drop=True)
        want = want.sort_values(keys).reset_index(drop=True)
        assert len(got) == len(want) > 0
        for c in want.columns:
            if name != "J1" and c == "p":
                n, abs_sum, max_abs = side[name]
                cnt = want["c"].to_numpy().astype(np.float64)
                gamma = lambda m: 1.01 * m * 2.0**-53  # noqa: E731
                tol = 2 * (gamma(cnt + 8) * cnt * max_abs + 2 * cnt * gamma(n) * abs_sum)
                assert np.all(np.abs(got[c].to_numpy() - want[c].to_numpy()) <= tol), name
            else:
                np.testing.assert_array_equal(got[c].to_numpy(), want[c].to_numpy(), err_msg=f"{name} {c}")


def _topk_inputs(rng, q, n, kind):
    """float32 [q, n] scores: 'random' normal scores; 'ties' the scores
    rounded to 16 distinct values, with a NaN row, scattered NaN, -inf
    and signed zeros."""
    x = rng.standard_normal((q, n)).astype(np.float32)
    if kind == "ties":
        x = np.round(x * 4).clip(-8, 7).astype(np.float32)
        x[0, :] = np.nan
        pos = rng.integers(0, n, (q, 12))
        rows = np.arange(q)[:, None]
        x[rows, pos[:, :3]] = np.nan
        x[rows, pos[:, 3:6]] = -np.inf
        x[rows, pos[:, 6:9]] = -0.0
        x[rows, pos[:, 9:]] = 0.0
    return x


# (q, n, k): routing [32, 64] k=8, small rows, a row of one tile, rows of
# many tiles at k = 10, 100 and the kernel's limit, and the brute-force
# shape [32, 1M] at k = 10 and 100.
_K3_SHAPES = [
    (32, 64, 8), (1, 1, 1), (3, 5, 9), (4, 4096, 64), (5, 4097, 10), (32, 125_000, 10),
    (8, 50_000, 100), (2, 20_000, 2048), (32, 1_000_000, 10), (32, 1_000_000, 100),
]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("q,n,k", _K3_SHAPES)
def test_topk_kernel_is_bit_equal_to_plain(cuda, q, n, k, kind):
    from hyperspace_tpu_torch.ops.topk import topk, topk_plain

    x = torch.from_numpy(_topk_inputs(np.random.default_rng(q + n + k), q, n, kind)).to(cuda)
    before = topk.launches
    vals, idx = topk(x, k)
    torch.cuda.synchronize()
    assert topk.launches == before + 1
    want_vals, want_idx = topk_plain(x, k)
    assert vals.shape == want_vals.shape == (q, min(k, n))
    assert torch.equal(idx, want_idx)
    assert torch.equal(vals.view(torch.int32), want_vals.view(torch.int32))  # bit-equal


@pytest.mark.gpu
def test_topk_kernel_on_a_1d_row_and_past_its_limit(cuda):
    from hyperspace_tpu_torch.exceptions import HyperspaceError
    from hyperspace_tpu_torch.ops.topk import MAX_K, topk, topk_plain

    x = torch.from_numpy(_topk_inputs(np.random.default_rng(1), 1, 3000, "ties")[0]).to(cuda)
    vals, idx = topk(x, 7)
    want_vals, want_idx = topk_plain(x, 7)
    assert vals.shape == (7,) and torch.equal(idx, want_idx) and torch.equal(vals, want_vals)
    with pytest.raises(HyperspaceError, match=str(MAX_K)):
        topk(torch.zeros((2, MAX_K + 1), device=cuda), MAX_K + 1)


@pytest.mark.gpu
def test_topk_on_the_card_never_calls_a_library_selection(cuda, monkeypatch):
    from hyperspace_tpu_torch.ops.topk import topk

    def refuse(*args, **kwargs):
        raise AssertionError("a library selection was called on the card")

    x = torch.from_numpy(_topk_inputs(np.random.default_rng(2), 32, 300_000, "ties")).to(cuda)
    monkeypatch.setattr(torch, "topk", refuse)
    monkeypatch.setattr(torch, "sort", refuse)
    monkeypatch.setattr(torch.Tensor, "topk", refuse)
    monkeypatch.setattr(torch.Tensor, "sort", refuse)
    for k in (8, 10, 100):
        vals, idx = topk(x, k)
        assert vals.shape == (32, k)
    torch.cuda.synchronize()


def _k3_hard_case(case, plan):
    """(scores [q, n] float32, k) for one hard case of K3; `plan(q, n)`
    is the kernel's (blocks a row, columns a block) on this card."""
    rng = np.random.default_rng(len(case))
    if case == "all equal":
        return np.full((4, 300_000), 2.5, np.float32), 100
    if case == "ties straddle the block split":
        q, n, k = 2, 200_000, 10
        blocks, chunk = plan(q, n)
        assert blocks > 3
        x = rng.uniform(-2, 0, (q, n)).astype(np.float32)
        x[:, rng.integers(0, n, k - 4)] = 5.0  # above the cut
        for b in (1, 2, 3):  # ties at the k-th value on both sides of three splits
            x[:, b * chunk - 3 : b * chunk + 3] = 1.0
        return x, k
    if case == "k = n":
        return rng.standard_normal((3, 2048)).astype(np.float32), 2048
    if case == "k = MAX_K at n = 20,000":
        return np.round(rng.standard_normal((2, 20_000)) * 3).astype(np.float32), 2048
    if case.startswith("n = chunk·m"):
        q, m, d = {"n = chunk·m - 1": (32, 16, -1), "n = chunk·m + 1": (32, 16, 1),
                   "n = chunk·m - 1, q = 1": (1, 7, -1), "n = chunk·m + 1, q = 1": (1, 7, 1)}[case]
        blocks, chunk = plan(q, 4096 * m)
        return np.round(rng.standard_normal((q, blocks * chunk + d)) * 8).astype(np.float32), 100
    if case == "only -inf and only NaN":
        x = np.full((3, 100_000), -np.inf, np.float32)
        x[1] = np.nan
        x[2, ::2] = np.nan  # -inf and NaN alternate: all tie at -inf
        return x, 100
    if case == "subnormals and signed zeros at the cut":
        x = np.full((4, 50_000), -1.0, np.float32)
        pos = rng.permutation(50_000)[:405]
        x[:, pos[400:]] = 3.0
        x[:, pos[:100]] = -0.0
        x[:, pos[100:200]] = 0.0
        x[:, pos[200:300]] = np.float32(1e-45)  # the smallest subnormal
        x[:, pos[300:]] = np.float32(-1e-40)
        return x, 205  # 5 above, 100 subnormals, then 100 of the 200 zeros
    if case == "q = 1 at n = 1M":
        return rng.standard_normal((1, 1_000_000)).astype(np.float32), 10
    raise ValueError(case)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "case",
    ["all equal", "ties straddle the block split", "k = n", "k = MAX_K at n = 20,000", "n = chunk·m - 1",
     "n = chunk·m + 1", "n = chunk·m - 1, q = 1", "n = chunk·m + 1, q = 1", "only -inf and only NaN",
     "subnormals and signed zeros at the cut", "q = 1 at n = 1M"],
)
def test_topk_hard_cases_are_bit_equal_to_plain(cuda, case):
    """K3's radix select where it can go wrong: ties at the k-th key (a
    row all equal, ties across the row's block split, all -inf or NaN),
    k = n and k = MAX_K, ragged chunks, q = 1, subnormals and -0.0/+0.0 at
    the cut. (q = 32 at n = 1M is in test_topk_kernel_is_bit_equal_to_plain.)"""
    from hyperspace_tpu_torch.ops.topk import _sm_count, select_plan, topk, topk_plain

    sms = _sm_count(torch.cuda.current_device())
    x, k = _k3_hard_case(case, lambda q, n: select_plan(q, n, sms))
    scores = torch.from_numpy(x).to(cuda)
    before = topk.launches
    vals, idx = topk(scores, k)
    torch.cuda.synchronize()
    assert topk.launches == before + 1
    want_vals, want_idx = topk_plain(scores, k)
    assert vals.shape == want_vals.shape == (x.shape[0], min(k, x.shape[1]))
    assert torch.equal(idx, want_idx)
    assert torch.equal(vals.view(torch.int32), want_vals.view(torch.int32))


@pytest.mark.gpu
def test_vector_search_on_the_card_matches_the_cpu(cuda, tmp_path):
    """One index (built on the CPU) searched from a card session and a CPU
    session: the card launches K3 twice per indexed search (routing,
    candidates) and once per brute-force search, and finds the CPU's rows.
    Scores agree within 16 units of float32 rounding of (|q| + |x|)², the
    scale of an l2 score's terms; ids agree where the CPU's scores stand
    apart by more than that."""
    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, VectorIndexConfig
    from hyperspace_tpu_torch.datagen import gen_embeddings
    from hyperspace_tpu_torch.ops.topk import topk

    emb = gen_embeddings(tmp_path / "emb", 20_000, 64, clusters=16, seed=3)
    queries = emb[np.random.default_rng(4).choice(len(emb), 8, replace=False)] + 0.01
    out = {}
    for dev in ("cpu", "cuda"):
        s = HyperspaceSession(system_path=str(tmp_path / "idx"), device=dev)
        hs, df = Hyperspace(s), s.parquet(tmp_path / "emb")
        if dev == "cpu":
            hs.create_vector_index(df, VectorIndexConfig("v", "emb", ["id"], num_partitions=16))
        before = topk.launches
        s.enable_hyperspace()
        ann = hs.ann_search(df, queries, k=10, nprobe=4)
        s.disable_hyperspace()
        brute = hs.ann_search(df, queries, k=100)
        out[dev] = (ann, brute, topk.launches - before)
    assert out["cuda"][2] == 3 and out["cpu"][2] == 0
    norms = np.linalg.norm(emb, axis=1)
    qn = np.linalg.norm(queries, axis=1)[:, None]
    for got, want in zip(out["cuda"][:2], out["cpu"][:2]):
        ids = want.rows.host_column("id").reshape(len(queries), -1)
        tol = 16 * 2.0**-24 * (qn + norms[ids]) ** 2
        assert np.all(np.abs(got.scores - want.scores) <= tol)
        apart = np.ones(ids.shape, dtype=bool)
        apart[:, 1:] &= -np.diff(want.scores, axis=1) > 2 * tol[:, 1:]
        apart[:, :-1] &= -np.diff(want.scores, axis=1) > 2 * tol[:, :-1]
        apart[:, -1] = False  # the next row, outside the k, may tie with the last
        got_ids = got.rows.host_column("id").reshape(len(queries), -1)
        np.testing.assert_array_equal(got_ids[apart], ids[apart])

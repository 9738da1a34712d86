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


def _run_bounds_inputs(rng, b, lp, ls, domain, order):
    """Primary codes and sorted secondary rows, pads at the int32 max, null
    codes -2 / -1. `order` "sorted" gives the join's layout (each primary
    row sorted: nulls first, pads last), "shuffled" the same codes
    permuted within each row."""
    big = np.iinfo(np.int32).max
    pk = np.full((b, lp), big, np.int32)
    sk = np.full((b, ls), big, np.int32)
    for i in range(b):
        n_p, n_s = int(rng.integers(lp // 2, lp + 1)), int(rng.integers(ls // 2, ls + 1))
        pk[i, :n_p] = np.sort(rng.integers(-2, domain, n_p))
        sk[i, :n_s] = np.sort(rng.integers(-1, domain, n_s))
    return (pk if order == "sorted" else rng.permuted(pk, axis=1)), sk


# (B, Lp, Ls): the join's aligned shapes (200 buckets) J2 (orders searched
# in lineitem) and J3 (the reverse), J2 on one partition, a secondary row
# past the first design's shared-memory limit (about 58k keys), and edges.
# Sorted, a tile's window fits its shared-memory budget (staged); shuffled,
# it spans the row and the kernel searches device memory.
_K2_SHAPES = [
    (200, 7759, 31129), (200, 31129, 7759), (1, 1_500_000, 6_000_000),
    (2, 50_000, 70_000), (8, 1000, 700), (1, 1, 1), (3, 5, 0), (1, 1, 6_000_000),
]


def _assert_run_bounds_equal_plain(pk, sk, cuda):
    from hyperspace_tpu_torch.ops.sortkeys import run_bounds, run_bounds_plain

    pkt, skt = torch.from_numpy(pk).to(cuda), torch.from_numpy(sk).to(cuda)
    before = run_bounds.launches
    st, en = run_bounds(pkt, skt)
    torch.cuda.synchronize()
    assert run_bounds.launches == before + 1
    want_st, want_en = run_bounds_plain(pkt, skt)
    assert torch.equal(st, want_st) and torch.equal(en, want_en)


@pytest.mark.gpu
@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("b,lp,ls", _K2_SHAPES)
def test_run_bounds_kernel_equals_plain_in_both_regimes(cuda, b, lp, ls, order):
    """Bit-equal to the plain version with the windows staged (sorted
    primary) and searched in device memory (shuffled), one launch a call."""
    pk, sk = _run_bounds_inputs(np.random.default_rng(b + lp + ls), b, lp, ls, max(ls // 4, 3), order)
    _assert_run_bounds_equal_plain(pk, sk, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("b,lp,ls", [(8, 1000, 700), (200, 7759, 31129)])
def test_run_bounds_primary_off_a_16_byte_boundary(cuda, b, lp, ls, offset):
    """pk a view `offset` int32s past a 16-byte boundary: the tiles start
    `offset` rows early, and st and en (fresh, on a boundary) are written
    one int32 at a time."""
    from hyperspace_tpu_torch.ops.sortkeys import run_bounds, run_bounds_plain

    pk, sk = _run_bounds_inputs(np.random.default_rng(lp + offset), b, lp, ls, max(ls // 4, 3), "sorted")
    flat = np.zeros(b * lp + offset, np.int32)
    flat[offset:] = pk.reshape(-1)
    pkt = torch.from_numpy(flat).to(cuda)[offset:].view(b, lp)
    assert pkt.data_ptr() % 16 == 4 * offset
    skt = torch.from_numpy(sk).to(cuda)
    st, en = run_bounds(pkt, skt)
    want_st, want_en = run_bounds_plain(pkt, skt)
    assert torch.equal(st, want_st) and torch.equal(en, want_en)


@pytest.mark.gpu
def test_run_bounds_window_past_the_budget(cuda):
    """A run of 100k equal secondary keys, matched by 3,000 primary rows
    across tile edges: the tiles holding them have windows past any
    shared-memory budget and search device memory, while their neighbours
    stage theirs."""
    from hyperspace_tpu_torch.ops.sortkeys import MAX_WINDOW

    rng = np.random.default_rng(5)
    b, lp, ls, key = 2, 20_000, 300_000, 40_000
    sk = np.sort(rng.integers(-1, 80_000, (b, ls)), axis=1).astype(np.int32)
    sk[0] = np.sort(np.concatenate([sk[0, :200_000], np.full(100_000, key)]))
    pk = rng.integers(-2, 80_000, (b, lp)).astype(np.int32)
    pk[0, :3000] = key
    pk = np.sort(pk, axis=1)
    assert (sk[0] == key).sum() >= 100_000 > MAX_WINDOW
    _assert_run_bounds_equal_plain(pk, sk, cuda)


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
    """A 1-D row gives 1-D results; a k above n is cut to n, on the
    one-launch path and on the radix select past MAX_K alike."""
    from hyperspace_tpu_torch.ops.topk import MAX_K, topk, topk_plain

    x = torch.from_numpy(_topk_inputs(np.random.default_rng(1), 1, 3000, "ties")[0]).to(cuda)
    vals, idx = topk(x, 7)
    want_vals, want_idx = topk_plain(x, 7)
    assert vals.shape == (7,) and torch.equal(idx, want_idx) and torch.equal(vals, want_vals)
    for n in (MAX_K + 1, 3 * MAX_K + 5_000):
        x = torch.from_numpy(_topk_inputs(np.random.default_rng(n), 2, n, "ties")).to(cuda)
        vals, idx = topk(x, n + 100)
        torch.cuda.synchronize()
        want_vals, want_idx = topk_plain(x, n)
        assert vals.shape == (2, n)
        assert torch.equal(idx, want_idx)
        assert torch.equal(vals.view(torch.int32), want_vals.view(torch.int32))


# (q, n, k) past MAX_K: one key over it, k = n at a row that is no power of
# two (its last run padded), the one-launch path's k = 3,000 of 4,000, and
# the brute-force shape at k = 5,000 (three runs, two merges).
_K3_LARGE_K = [(4, 20_000, 2049), (2, 50_000, 50_000), (32, 4_000, 3_000), (32, 1_000_000, 5_000)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("q,n,k", _K3_LARGE_K)
def test_topk_past_max_k_is_bit_equal_to_plain(cuda, q, n, k, kind):
    """K3 for k > MAX_K: the runs of MAX_K candidates sorted in shared
    memory and merged in device memory give the plain version's values
    bit for bit and its columns, ties to the lowest column across run
    boundaries; one call, its launches as launches_per_call says."""
    from hyperspace_tpu_torch.ops.topk import launches_per_call, merge_passes, topk, topk_plain

    x = torch.from_numpy(_topk_inputs(np.random.default_rng(q + n + k), q, n, kind)).to(cuda)
    before = topk.launches
    vals, idx = topk(x, k)
    torch.cuda.synchronize()
    assert topk.launches == before + 1
    assert launches_per_call(n, k) == (1 if n <= 4096 else 8 + merge_passes(k))
    want_vals, want_idx = topk_plain(x, k)
    assert vals.shape == want_vals.shape == (q, k)
    assert torch.equal(idx, want_idx)
    assert torch.equal(vals.view(torch.int32), want_vals.view(torch.int32))


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
    for k in (8, 10, 100, 5_000):
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


@pytest.mark.gpu
def test_vector_search_past_max_k_on_the_card_matches_the_cpu(cuda, tmp_path):
    """ann_search(k=5000) and brute force at k = 5,000 answer on the card
    (K3 past MAX_K) with the CPU's rows: scores within 16 units of float32
    rounding of (|q| + |x|)², ids equal where the CPU's scores stand apart
    by more than twice that."""
    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, VectorIndexConfig
    from hyperspace_tpu_torch.datagen import gen_embeddings

    emb = gen_embeddings(tmp_path / "emb", 20_000, 64, clusters=16, seed=3)
    queries = emb[np.random.default_rng(4).choice(len(emb), 8, replace=False)] + 0.01
    out = {}
    for dev in ("cpu", "cuda"):
        s = HyperspaceSession(system_path=str(tmp_path / "idx"), device=dev)
        hs, df = Hyperspace(s), s.parquet(tmp_path / "emb")
        if dev == "cpu":
            hs.create_vector_index(df, VectorIndexConfig("v", "emb", ["id"], num_partitions=16))
        s.enable_hyperspace()
        ann = hs.ann_search(df, queries, k=5_000, nprobe=8)
        s.disable_hyperspace()
        brute = hs.ann_search(df, queries, k=5_000)
        out[dev] = (ann, brute)
    norms = np.linalg.norm(emb, axis=1)
    qn = np.linalg.norm(queries, axis=1)[:, None]
    for got, want in zip(out["cuda"], out["cpu"]):
        ids = want.rows.host_column("id").reshape(len(queries), -1)
        assert got.scores.shape == want.scores.shape
        tol = 16 * 2.0**-24 * (qn + norms[ids]) ** 2
        assert np.all(np.abs(got.scores - want.scores) <= tol)
        apart = np.ones(ids.shape, dtype=bool)
        apart[:, 1:] &= -np.diff(want.scores, axis=1) > 2 * tol[:, 1:]
        apart[:, :-1] &= -np.diff(want.scores, axis=1) > 2 * tol[:, :-1]
        apart[:, -1] = False
        got_ids = got.rows.host_column("id").reshape(len(queries), -1)
        np.testing.assert_array_equal(got_ids[apart], ids[apart])


# -- the join types: probes, exchange and DPP cut on the card -------------------------


@pytest.mark.gpu
def test_broadcast_and_membership_probes_on_the_card_match_the_cpu(cuda):
    """The broadcast probe (unique and duplicate build keys, null codes,
    both orientations) and the membership probe give the CPU's pairs and
    bits, on the card."""
    from hyperspace_tpu_torch.execution.exec_common import _broadcast_probe, _composite_keys

    rng = np.random.default_rng(31)
    for n_l, n_r, dup in ((200_000, 5_000, False), (200_000, 5_000, True), (3_000, 100_000, True)):
        lc = rng.integers(-2, 6_000, n_l).astype(np.int32)
        rc = (np.repeat(np.arange(n_r // 3), 3)[:n_r] if dup else rng.permutation(n_r)).astype(np.int32)
        rc[rng.integers(0, n_r, 50)] = -1
        got = _broadcast_probe(torch.from_numpy(lc).to(cuda), torch.from_numpy(rc).to(cuda))
        want = _broadcast_probe(torch.from_numpy(lc), torch.from_numpy(rc))
        assert got[0].is_cuda and got[1].is_cuda
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
    offsets = np.array([0, 70_000, 140_000, 200_000], dtype=np.int64)
    roff = np.array([0, 1_000, 3_000, 5_000], dtype=np.int64)
    lc = torch.from_numpy(rng.integers(-2, 3_000, 200_000).astype(np.int32))
    rc = torch.from_numpy(rng.integers(-1, 3_000, 5_000).astype(np.int32))
    for dev in (cuda, torch.device("cpu")):
        comp_r = torch.sort(_composite_keys(rc.to(dev), roff)).values
        comp_l = _composite_keys(lc.to(dev), offsets)
        pos = torch.searchsorted(comp_r, comp_l).clamp_(max=len(comp_r) - 1)
        bits = (comp_r[pos] == comp_l).cpu().numpy()
        if dev == cuda:
            got_bits = bits
    np.testing.assert_array_equal(got_bits, bits)


@pytest.mark.gpu
def test_exchange_and_dpp_cut_on_the_card_match_the_cpu(cuda, tmp_path):
    """The re-bucketing exchange (host row hash, one stable sort of the
    bucket ids on the card) groups rows as on the CPU, and the DPP cut of
    an indexed side (range and key-set) keeps the CPU's rows, on the
    card."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig
    from hyperspace_tpu_torch.execution.executor import Executor
    from hyperspace_tpu_torch.execution.table import ColumnTable
    from hyperspace_tpu_torch.schema import Schema

    rng = np.random.default_rng(8)
    (tmp_path / "f").mkdir()
    pq.write_table(pa.table({"k": rng.integers(0, 50_000, 300_000).astype(np.int64),
                             "v": rng.normal(size=300_000)}), tmp_path / "f" / "p.parquet")
    keys = pa.array([None if i % 9 == 0 else int(i * 7) for i in range(20_000)], type=pa.int64())
    out = {}
    for dev in ("cuda", "cpu"):
        s = HyperspaceSession(system_path=str(tmp_path / f"idx_{dev}"), num_buckets=16, device=dev)
        f = s.parquet(tmp_path / "f")
        Hyperspace(s).create_index(f, IndexConfig("f_k", ["k"], ["v"]))
        ex = Executor(s.device, s.conf)
        t = ColumnTable.from_arrow(pa.table({"k": keys}), Schema.from_arrow(pa.schema([("k", pa.int64())])),
                                   device=s.device)
        side = ex._rebucketize_side(t, ["k"], [f.schema.field("k")], 16)
        assert side.table.device.type == dev and ex.stats["exchange_kernel"] == "device-sort-exchange"
        s.enable_hyperspace()
        scan = s.optimized_plan(f.join(f.select("k"), ["k"])).left
        from hyperspace_tpu_torch.execution.exec_common import AlignedSide

        bounds = ex._table_key_bounds(t, "k")
        cut = ex._side_data(AlignedSide(scan), 16, dpp_bounds=bounds)
        out[dev] = (side, cut, ex.stats["rows_pruned"], ex.stats["files_pruned"])
    for (a, b) in zip(out["cuda"][:2], out["cpu"][:2]):
        np.testing.assert_array_equal(a.offsets, b.offsets)
        for c in a.table.columns:
            np.testing.assert_array_equal(a.table.host_column(c), b.table.host_column(c))
    assert out["cuda"][2:] == out["cpu"][2:] and out["cuda"][2] > 0


@pytest.mark.gpu
def test_outer_and_residual_semi_joins_on_the_card_match_the_cpu(cuda, tmp_path):
    """A full outer join (null-extended strings, the right key coalesced)
    and a residual semi join end to end, index on and off: the card's rows
    equal the CPU's, and the merge joins launch K2."""
    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig, col, lit
    from hyperspace_tpu_torch.datagen import gen_tpch_lineitem, gen_tpch_orders
    from hyperspace_tpu_torch.ops.sortkeys import run_bounds

    gen_tpch_lineitem(tmp_path / "li", sf=0.002)
    gen_tpch_orders(tmp_path / "o", sf=0.002)

    def queries(li, o):
        return {
            "full": li.filter(col("l_discount") >= lit(0.05)).select("l_orderkey", "l_extendedprice").join(
                o.filter(col("o_orderpriority") == lit("1-URGENT")).select("o_orderkey", "o_orderpriority"),
                ["l_orderkey"], ["o_orderkey"], how="full"),
            "semi": o.select("o_orderkey", "o_totalprice", "o_orderpriority").join(
                li.select("l_orderkey", "l_extendedprice"), ["o_orderkey"], ["l_orderkey"], how="semi",
                condition=col("l_extendedprice") > col("o_totalprice") * lit(0.1)),
        }

    out = {}
    for dev in ("cuda", "cpu"):
        s = HyperspaceSession(system_path=str(tmp_path / f"idx_{dev}"), num_buckets=8, device=dev)
        li, o = s.parquet(tmp_path / "li"), s.parquet(tmp_path / "o")
        Hyperspace(s).create_index(li, IndexConfig("li", ["l_orderkey"], ["l_extendedprice", "l_discount"]))
        Hyperspace(s).create_index(o, IndexConfig("o", ["o_orderkey"], ["o_totalprice", "o_orderpriority"]))
        for indexed in (True, False):
            s.enable_hyperspace() if indexed else s.disable_hyperspace()
            for name, plan in queries(li, o).items():
                k2 = run_bounds.launches
                out[dev, indexed, name] = (s.to_pandas(plan), s.last_query_stats["join_path"])
                if dev == "cuda" and s.last_query_stats["join_path"] != "broadcast-hash":
                    assert run_bounds.launches > k2
    for (dev, indexed, name), (got, path) in out.items():
        if dev == "cuda":
            want, want_path = out["cpu", indexed, name]
            assert path == want_path
            keys = list(want.columns)
            pd.testing.assert_frame_equal(got.sort_values(keys).reset_index(drop=True),
                                          want.sort_values(keys).reset_index(drop=True))


@pytest.mark.gpu
def test_sort_top_n_and_windows_on_the_card_match_the_cpu(cuda, tmp_path):
    """Sort (several keys, DESC, NULLs, strings, NaN and signed zeros),
    ORDER BY ... LIMIT on both top-N branches (the int64 selection key on
    the card) and windows under every frame, on the card and on the CPU:
    the same rows in the same order. The float values are integral and
    small, so every sum is exact in any order and the answers are equal
    bit for bit."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import HyperspaceSession, WindowSpec, col

    rng = np.random.default_rng(17)
    n = 20_000
    f = rng.integers(-50, 50, n).astype(np.float64)
    f[rng.random(n) < 0.02] = np.nan
    f[rng.random(n) < 0.02] = -0.0
    t = pa.table({
        "i": np.arange(n, dtype=np.int64),
        "g": rng.integers(0, 40, n).astype(np.int64),
        "o": rng.integers(0, 300, n).astype(np.int32),
        "f": pa.array([None if rng.random() < 0.03 else float(x) for x in f], type=pa.float64()),
        "big": pa.array([None if rng.random() < 0.03 else int(x) for x in
                         (rng.integers(0, 3, n) << 40) + rng.integers(0, 1 << 20, n)], type=pa.int64()),
        "s": pa.array(np.array(["a", "bb", "c", "dd"], dtype=object)[rng.integers(0, 4, n)]),
    })
    (tmp_path / "t").mkdir()
    pq.write_table(t, tmp_path / "t" / "p.parquet")

    def plans(scan):
        spec = WindowSpec.of
        return {
            "sort": scan.sort([("s", False), ("f", True), ("i", True)]),
            "top_n_select": scan.sort([("big", False), ("i", True)]).limit(25),
            "top_n_float": scan.sort([("f", True), ("i", False)]).limit(40),
            "top_n_full": scan.sort([("o", False), ("i", True)]).limit(15_000),
            **{f"window_{frame}": scan.window(
                ["g"], order_by=[] if frame == "partition" else [("o", True)], frame=frame, funcs=[
                    ("sum", "f", "sf"), ("count", "f", "cf"), ("mean", "o", "mo"), ("min", "f", "mn"),
                    ("max", "big", "mx"), ("sum", "big", "sb")])
               for frame in ("partition", "rows", "range")},
            "ranks": scan.window(["g"], order_by=[("f", False), ("s", True)], funcs=[
                ("row_number", None, "rn"), ("rank", None, "rk"), ("dense_rank", None, "dr"),
                spec("lag", "s", "ls", 2), spec("lead", "f", "lf", 1)]),
            "filtered": scan.filter(col("o") < 150).sort([("g", True), ("f", False), ("i", True)]).limit(100),
        }

    out = {}
    for dev in ("cuda", "cpu"):
        s = HyperspaceSession(system_path=str(tmp_path / f"idx_{dev}"), num_buckets=4, device=dev)
        for name, plan in plans(s.parquet(tmp_path / "t")).items():
            out[dev, name] = (s.to_pandas(plan), s.last_query_stats["top_n"])
    for name in plans(HyperspaceSession(system_path=str(tmp_path / "x"), num_buckets=4, device="cpu").parquet(
            tmp_path / "t")):
        (got, gtop), (want, wtop) = out["cuda", name], out["cpu", name]
        assert gtop == wtop, name
        assert list(got.columns) == list(want.columns) and len(got) == len(want) > 0, name
        for c in want.columns:
            a, b = got[c].to_numpy(dtype=object), want[c].to_numpy(dtype=object)
            same = [(x is None and y is None) or (isinstance(x, float) and isinstance(y, float) and np.isnan(x)
                                                  and np.isnan(y)) or x == y for x, y in zip(a, b)]
            assert all(same), (name, c)
    assert out["cuda", "top_n_select"][1]["kernel"] == "partition-select + sort"
    assert out["cuda", "top_n_full"][1]["kernel"] == "full-sort"


@pytest.mark.gpu
def test_lifecycle_on_the_card_is_byte_identical_to_the_cpu(cuda, tmp_path):
    """Create, incremental refresh, optimize (compaction: one stable device
    sort of every live version's rows) and full refresh, each by a card
    session and a CPU session on one source: every bucket file and
    manifest of every version is byte-identical."""
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig
    from hyperspace_tpu_torch.datagen import gen_tpch_lineitem

    src = tmp_path / "li"
    gen_tpch_lineitem(src, sf=0.002, seed=42)
    hs = {}
    for dev in ("cuda", "cpu"):
        s = HyperspaceSession(system_path=str(tmp_path / f"idx_{dev}"), num_buckets=8, device=dev)
        hs[dev] = Hyperspace(s)
        hs[dev].create_index(s.parquet(src), IndexConfig("li", ["l_orderkey"], ["l_quantity", "l_extendedprice"]))
    steps = [("a1", lambda h: h.refresh_index("li", mode="incremental")), (None, lambda h: h.optimize_index("li")),
             ("a2", lambda h: h.refresh_index("li"))]
    for i, (append, action) in enumerate(steps):
        if append:
            stage = tmp_path / f"stage{i}"
            gen_tpch_lineitem(stage, sf=0.001, seed=46 + i, files=1)
            (stage / "part-0.parquet").rename(src / f"{append}.parquet")
        for dev in ("cuda", "cpu"):
            action(hs[dev])
    for d in sorted((tmp_path / "idx_cpu" / "li").glob("v__=*")):
        for f in sorted(d.iterdir()):
            assert (tmp_path / "idx_cuda" / "li" / d.name / f.name).read_bytes() == f.read_bytes(), f"{d.name}/{f.name}"
    assert len(list((tmp_path / "idx_cuda" / "li").glob("v__=*"))) == 4
    assert pq.read_metadata(tmp_path / "idx_cuda" / "li" / "v__=3" / "bucket-00000.parquet").num_rows > 0


@pytest.mark.gpu
def test_hybrid_join_on_the_card_matches_the_cpu(cuda, tmp_path):
    """J2 over a hybrid lineitem side (its index plus an appended file,
    bucketized on the fly) joined with the orders index: the card takes
    the zero-exchange aligned path, launches K2 and K1, and gives the
    CPU's answer (sums within the join bound of
    test_join_queries_on_the_card_match_the_cpu)."""
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig
    from hyperspace_tpu_torch.datagen import gen_tpch_lineitem, gen_tpch_orders
    from hyperspace_tpu_torch.ops.sortkeys import run_bounds

    gen_tpch_lineitem(tmp_path / "li", sf=0.002, seed=42)
    gen_tpch_orders(tmp_path / "o", sf=0.002)
    s = HyperspaceSession(system_path=str(tmp_path / "idx"), num_buckets=8, device=cuda)
    li, o = s.parquet(tmp_path / "li"), s.parquet(tmp_path / "o")
    Hyperspace(s).create_index(li, IndexConfig("li", ["l_orderkey"], ["l_quantity", "l_extendedprice"]))
    Hyperspace(s).create_index(o, IndexConfig("o", ["o_orderkey"], ["o_totalprice", "o_orderpriority"]))
    gen_tpch_lineitem(tmp_path / "stage", sf=0.0004, seed=46, files=1)
    (tmp_path / "stage" / "part-0.parquet").rename(tmp_path / "li" / "append.parquet")
    out = {}
    for dev in ("cuda", "cpu"):
        s = HyperspaceSession(system_path=str(tmp_path / "idx"), num_buckets=8, device=dev)
        li, o = s.parquet(tmp_path / "li"), s.parquet(tmp_path / "o")
        s.conf.set("hyperspace.index.hybridscan.enabled", True)
        s.enable_hyperspace()
        j = li.select("l_orderkey", "l_quantity", "l_extendedprice").join(
            o.select("o_orderkey", "o_totalprice", "o_orderpriority"), ["l_orderkey"], ["o_orderkey"])
        plan = j.aggregate(["o_orderpriority"], [("sum", "l_quantity", "q"), ("max", "l_extendedprice", "m"),
                                                 ("sum", "l_extendedprice", "p"), ("count", None, "c")])
        k2, k1 = run_bounds.launches, segment_reduce.launches
        out[dev] = s.to_pandas(plan).sort_values("o_orderpriority").reset_index(drop=True)
        assert s.last_query_stats["join_path"] == "zero-exchange-aligned"
        if dev == "cuda":
            assert run_bounds.launches > k2 and segment_reduce.launches > k1
    v = np.abs(pq.read_table(sorted(str(p) for p in (tmp_path / "li").glob("*.parquet")))["l_extendedprice"].to_numpy())
    got, want = out["cuda"], out["cpu"]
    assert len(got) == len(want) == 5
    for c in ("o_orderpriority", "q", "m", "c"):
        np.testing.assert_array_equal(got[c].to_numpy(), want[c].to_numpy(), err_msg=c)
    cnt = want["c"].to_numpy().astype(np.float64)
    gamma = lambda m: 1.01 * m * 2.0**-53  # noqa: E731
    tol = 2 * (gamma(cnt + 8) * cnt * v.max() + 2 * cnt * gamma(len(v)) * v.sum())
    assert np.all(np.abs(got["p"].to_numpy() - want["p"].to_numpy()) <= tol)


@pytest.mark.gpu
def test_vector_incremental_refresh_on_the_card(cuda, tmp_path):
    """A card session refreshes a vector index incrementally (the
    appended rows assigned to the existing centroids on the card): every
    appended row lands in its nearest centroid's partition, up to float32
    near ties; the full probe equals brute force, and the searches launch
    K3."""
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, VectorIndexConfig
    from hyperspace_tpu_torch.datagen import gen_embeddings
    from hyperspace_tpu_torch.ops.topk import topk

    emb = gen_embeddings(tmp_path / "emb", 20_000, 32, clusters=16, seed=3)
    s = HyperspaceSession(system_path=str(tmp_path / "idx"), device=cuda)
    hs, df = Hyperspace(s), s.parquet(tmp_path / "emb")
    hs.create_vector_index(df, VectorIndexConfig("v", "emb", ["id"], num_partitions=16))
    extra = gen_embeddings(tmp_path / "emb", 20_000, 32, clusters=16, seed=3, appended=2_000)
    hs.refresh_index("v", mode="incremental")
    vdir = tmp_path / "idx" / "v" / "v__=1"
    c = np.load(vdir / "_centroids.npy").astype(np.float64)
    d2 = ((extra.astype(np.float64)[:, None, :] - c[None]) ** 2).sum(-1)
    nearest = np.argmin(d2, axis=1)
    two = np.sort(d2, axis=1)[:, :2]
    tie = (two[:, 1] - two[:, 0]) / two[:, 1] <= 1e-4
    for p in range(16):
        ids = pq.read_table(vdir / f"bucket-{p:05d}.parquet")["id"].to_numpy() - 20_000
        assert np.all((nearest[ids] == p) | tie[ids])
    allemb = np.concatenate([emb, extra])
    queries = allemb[np.random.default_rng(4).choice(len(allemb), 8, replace=False)] + 0.01
    before = topk.launches
    s.enable_hyperspace()
    full = hs.ann_search(df, queries, k=10, nprobe=16)
    s.disable_hyperspace()
    brute = hs.ann_search(df, queries, k=10)
    assert topk.launches - before == 3
    np.testing.assert_allclose(np.sort(full.scores, axis=1), np.sort(brute.scores, axis=1), rtol=1e-4)


@pytest.mark.gpu
def test_eight_clients_through_a_query_server_on_the_card_give_the_cpus_results(cuda, tmp_path):
    """Point lookups, an aggregate (K1) and the indexed J2 (K2 and K1)
    served by 4 workers to 8 client threads on the card: every result is
    the CPU's serial result (exact columns only: integral sums, extrema,
    counts, selected rows), and each query launched its kernels."""
    import threading

    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig, col
    from hyperspace_tpu_torch.datagen import gen_tpch_lineitem, gen_tpch_orders
    from hyperspace_tpu_torch.ops.sortkeys import run_bounds

    gen_tpch_lineitem(tmp_path / "li", sf=0.002)
    gen_tpch_orders(tmp_path / "o", sf=0.002)

    def queries(li, o):
        j = li.select("l_orderkey", "l_quantity", "l_extendedprice").join(
            o.select("o_orderkey", "o_totalprice", "o_orderpriority"), ["l_orderkey"], ["o_orderkey"]
        )
        out = {f"lookup{k}": li.filter(col("l_orderkey") == k).select("l_orderkey", "l_quantity", "l_extendedprice")
               for k in (1, 7, 33, 100, 2017, 5000)}
        out["agg"] = li.aggregate(["l_returnflag"], [("sum", "l_quantity", "q"), ("min", "l_extendedprice", "lo"),
                                                     ("count", None, "c")])
        out["J2"] = j.aggregate(["o_orderpriority"], [("sum", "l_quantity", "q"), ("max", "l_extendedprice", "m"),
                                                     ("count", None, "c")])
        return out

    sessions, plans = {}, {}
    for dev in ("cuda", "cpu"):
        s = HyperspaceSession(system_path=str(tmp_path / f"idx_{dev}"), num_buckets=8, device=dev)
        li, o = s.parquet(tmp_path / "li"), s.parquet(tmp_path / "o")
        Hyperspace(s).create_index(li, IndexConfig("li", ["l_orderkey"], ["l_quantity", "l_extendedprice",
                                                                         "l_returnflag"]))
        Hyperspace(s).create_index(o, IndexConfig("o", ["o_orderkey"], ["o_totalprice", "o_orderpriority"]))
        s.enable_hyperspace()
        sessions[dev], plans[dev] = s, queries(li, o)
    want = {name: sessions["cpu"].to_pandas(p) for name, p in plans["cpu"].items()}
    names = list(want)
    k1, k2 = segment_reduce.launches, run_bounds.launches
    for p in plans["cuda"].values():  # serial, warming the caches
        sessions["cuda"].run(p)
    serial = (segment_reduce.launches - k1, run_bounds.launches - k2)
    assert serial[0] > 0 and serial[1] > 0
    errors = []
    k1, k2 = segment_reduce.launches, run_bounds.launches
    with sessions["cuda"].serve(workers=4) as server:

        def client(cid):
            try:
                for j in range(len(names)):
                    name = names[(cid + j) % len(names)]
                    h = server.submit(plans["cuda"][name])
                    got = pd.DataFrame(h.result(timeout=300).decode())
                    w = want[name]
                    keys = list(w.columns)
                    got = got.sort_values(keys).reset_index(drop=True)
                    pd.testing.assert_frame_equal(got, w.sort_values(keys).reset_index(drop=True))
                    assert h.profile.venue["platform"] == "gpu"
            except BaseException as e:  # surfaced after join
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads + server._threads)
    # Every client ran every query once: 8 times the serial pass's launches.
    assert (segment_reduce.launches - k1, run_bounds.launches - k2) == (8 * serial[0], 8 * serial[1])


@pytest.mark.gpu
def test_launch_counts_are_exact_under_eight_threads(cuda):
    """K1 and K2 called 50 times from each of 8 threads: each counts 400
    launches, and every result equals its plain version."""
    import threading

    from hyperspace_tpu_torch.ops.sortkeys import run_bounds, run_bounds_plain

    rng = np.random.default_rng(8)
    gid, vals = _inputs(rng, 20_000, 7, 4, integral=True)
    vals_t, gid_t = torch.from_numpy(vals).to(cuda), torch.from_numpy(gid).to(cuda)
    fns = ("sum", "min", "max", "sum")
    want_k1 = segment_reduce_plain(torch.from_numpy(vals), torch.from_numpy(gid), 7, fns)
    pk = torch.from_numpy(rng.integers(0, 500, (4, 3_000)).astype(np.int32))
    sk = torch.sort(torch.from_numpy(rng.integers(0, 500, (4, 2_000)).astype(np.int32)), dim=1).values
    want_k2 = run_bounds_plain(pk, sk)
    pk_c, sk_c = pk.to(cuda), sk.to(cuda)
    errors = []
    k1, k2 = segment_reduce.launches, run_bounds.launches

    def worker():
        try:
            for _ in range(50):
                got = segment_reduce(vals_t, gid_t, 7, fns)
                st, en = run_bounds(pk_c, sk_c)
                torch.testing.assert_close(got.cpu(), want_k1, rtol=0, atol=0, equal_nan=True)
                assert torch.equal(st.cpu(), want_k2[0]) and torch.equal(en.cpu(), want_k2[1])
        except BaseException as e:  # surfaced after join
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    assert segment_reduce.launches - k1 == 400
    assert run_bounds.launches - k2 == 400


@pytest.mark.gpu
def test_profile_dir_on_the_card_writes_the_kernels_trace(cuda, tmp_path):
    """`run(plan, profile_dir=)` on the card: one Chrome trace holding the
    aggregate's K1 kernels, and the query's result."""
    import json

    from hyperspace_tpu_torch import HyperspaceSession
    from hyperspace_tpu_torch.datagen import gen_tpch_lineitem

    gen_tpch_lineitem(tmp_path / "li", sf=0.001)
    s = HyperspaceSession(system_path=str(tmp_path / "idx"), device=cuda)
    plan = s.parquet(tmp_path / "li").aggregate(["l_returnflag"], [("sum", "l_quantity", "q")])
    result = s.run(plan, profile_dir=tmp_path / "trace")
    traces = sorted((tmp_path / "trace").glob("*.json"))
    assert len(traces) == 1 and result.num_rows == 3
    names = {e.get("name", "") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert any("segment_reduce_" in n for n in names), sorted(names)[:50]
    assert s.last_profile().venue["platform"] == "gpu"


def _truncate_buckets(version_dir) -> None:
    for f in sorted(version_dir.glob("bucket-*.parquet")):
        with open(f, "r+b") as fh:
            fh.truncate(7)


@pytest.mark.gpu
def test_corruption_fallback_lookup_on_the_card(cuda, tmp_path):
    """A truncated index on a card session: the lookup re-plans once
    against the source, is quarantined, then plans around it; a full
    refresh lifts the quarantine. Every answer equals the CPU session's
    on the healthy index."""
    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig, col
    from hyperspace_tpu_torch.datagen import gen_tpch_lineitem
    from hyperspace_tpu_torch.execution import device_cache

    src = tmp_path / "li"
    gen_tpch_lineitem(src, sf=0.002, seed=42)
    rows = {}
    for dev in ("cpu", "cuda"):
        s = HyperspaceSession(system_path=str(tmp_path / f"idx_{dev}"), num_buckets=8, device=dev)
        Hyperspace(s).create_index(s.parquet(src), IndexConfig("li", ["l_orderkey"], ["l_extendedprice"]))
        s.enable_hyperspace()
        q = s.parquet(src).filter(col("l_orderkey") == 7).select("l_orderkey", "l_extendedprice")
        d = s.run(q).decode()
        rows[dev] = sorted(zip(d["l_orderkey"].tolist(), d["l_extendedprice"].tolist()))
    assert rows["cuda"] == rows["cpu"] and rows["cpu"]
    s = HyperspaceSession(system_path=str(tmp_path / "idx_cuda"), num_buckets=8, device=cuda)
    s.enable_hyperspace()
    _truncate_buckets(tmp_path / "idx_cuda" / "li" / "v__=0")
    device_cache.clear_all()
    q = s.parquet(src).filter(col("l_orderkey") == 7).select("l_orderkey", "l_extendedprice")
    first = s.run_query(q)
    root = str(tmp_path / "idx_cuda" / "li")
    assert first.replans == 1 and first.stats["degraded_indexes"] == [root]
    assert first.result.columns["l_orderkey"].device.type == "cuda"
    second = s.run_query(q)
    assert second.replans == 0 and list(s.index_health) == [root]
    for out in (first, second):
        d = out.result.decode()
        assert sorted(zip(d["l_orderkey"].tolist(), d["l_extendedprice"].tolist())) == rows["cpu"]
    Hyperspace(s).refresh_index("li")
    third = s.run_query(q)
    assert third.replans == 0 and not s.index_health and third.stats["scan"] == "IndexPointLookup"


@pytest.mark.gpu
def test_crash_and_recover_of_a_create_on_the_card(cuda, tmp_path):
    """A create on the card dies at its second bucket file; recover rolls
    it back and removes the partial version; a second create on the card
    writes the CPU's bytes and serves the CPU's answer."""
    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig, col, faults
    from hyperspace_tpu_torch.datagen import gen_tpch_lineitem

    src = tmp_path / "li"
    gen_tpch_lineitem(src, sf=0.002, seed=42)
    cfg = IndexConfig("li", ["l_orderkey"], ["l_extendedprice"])
    s = HyperspaceSession(system_path=str(tmp_path / "idx_cuda"), num_buckets=8, device=cuda)
    hs = Hyperspace(s)
    faults.inject("bucket.written", crash=True, at_call=2)
    try:
        with pytest.raises(faults.CrashPoint):
            hs.create_index(s.parquet(src), cfg)
    finally:
        faults.reset()
    s2 = HyperspaceSession(system_path=str(tmp_path / "idx_cuda"), num_buckets=8, device=cuda)
    report = Hyperspace(s2).recover("li")
    assert report == {"rolled": True, "quarantined_entries": 0, "orphans_removed": 1}
    assert Hyperspace(s2).recover("li") == {"rolled": False, "quarantined_entries": 0, "orphans_removed": 0}
    Hyperspace(s2).create_index(s2.parquet(src), cfg)
    cpu = HyperspaceSession(system_path=str(tmp_path / "idx_cpu"), num_buckets=8, device="cpu")
    Hyperspace(cpu).create_index(cpu.parquet(src), cfg)
    got = sorted(p.name for p in (tmp_path / "idx_cuda" / "li").glob("v__=*"))
    assert got == ["v__=0"], got  # the partial version was removed, its id reused
    for f in sorted((tmp_path / "idx_cpu" / "li" / "v__=0").iterdir()):
        assert (tmp_path / "idx_cuda" / "li" / "v__=0" / f.name).read_bytes() == f.read_bytes(), f.name
    s2.enable_hyperspace()
    q = s2.parquet(src).filter(col("l_orderkey") == 7).select("l_orderkey", "l_extendedprice")
    assert s2.run(q).decode()["l_extendedprice"].tolist() == cpu.run(q).decode()["l_extendedprice"].tolist()


# -- the build at scale on the card ---------------------------------------------


@pytest.mark.gpu
def test_device_sort_perms_on_the_card_equal_the_host_sort(cuda):
    """The streaming build's batched key sort on the card: each table's
    permutation equals the pooled build's host sort (pads sink, equal keys
    keep their order), at a batch of buckets with one and two lanes'
    keys, nulls and strings."""
    import pyarrow as pa

    from hyperspace_tpu_torch.execution.build_exchange import host_sort_perm
    from hyperspace_tpu_torch.execution.table import ColumnTable
    from hyperspace_tpu_torch.ops.sortkeys import device_sort_perms

    rng = np.random.default_rng(31)
    tables = []
    for n in (0, 1, 17, 30_000, 299_999, 65_536):
        t = pa.table({
            "k": pa.array(rng.integers(-(10**12), 10**12, n) // 1_000_000, mask=rng.random(n) < 0.05),
            "s": pa.array([f"x{i % 13}" for i in range(n)], type=pa.string()),
            "v": pa.array(rng.integers(-5, 5, n).astype(np.float64)),
        })
        tables.append(ColumnTable.from_arrow(t, device="cpu"))
    for cols in (["k"], ["v", "s"], ["s", "k", "v"]):
        perms = device_sort_perms(tables, cols, cuda)
        for t, p in zip(tables, perms):
            np.testing.assert_array_equal(p, host_sort_perm(t, cols))


def _li_source(tmp_path, sf=0.004):
    from hyperspace_tpu_torch.datagen import gen_tpch_lineitem

    src = tmp_path / "li"
    gen_tpch_lineitem(src, sf=sf, seed=42)
    return src


def _same_files(a, b):
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


@pytest.mark.gpu
def test_streaming_and_pooled_builds_on_the_card(cuda, tmp_path):
    """A streaming build on the card (pipeline on and off) is
    byte-identical to the CPU's, and a pooled build from a card session
    (its coordinator holds a CUDA context) to both: no worker initializes
    CUDA."""
    from hyperspace_tpu_torch.dataset import Dataset
    from hyperspace_tpu_torch.execution.builder import DeviceIndexBuilder

    src = _li_source(tmp_path)
    cols, key = ["l_orderkey", "l_partkey", "l_extendedprice"], ["l_orderkey"]
    kw = dict(memory_budget_bytes=200_000, chunk_bytes=150_000)
    torch.zeros(1, device=cuda)  # the coordinator's CUDA context
    outs = {}
    for name, dev, extra in (("cpu", "cpu", {}), ("card", cuda, {}), ("card_serial", cuda, {"pipeline_enabled": False}),
                             ("pooled", cuda, {"workers": 2})):
        b = DeviceIndexBuilder(dev, **kw, **extra)
        d = tmp_path / name / "v__=0"
        b.write(Dataset.parquet(src).scan(), cols, key, 16, d)
        assert b.last_build_stats["path"] == ("pooled" if name == "pooled" else "streaming")
        outs[name] = d
        if name == "pooled":
            assert b.last_build_stats["worker_cuda_initialized"] is False
    for name in ("card", "card_serial", "pooled"):
        _same_files(outs["cpu"], outs[name])


@pytest.mark.gpu
def test_a_staged_column_lands_on_the_card_without_a_host_copy(cuda, tmp_path):
    """A fixed-width null-free column read for the card goes from Arrow's
    buffer straight to the card (counted zero-copy), a nullable one is
    copied; a transient `device.stage` fault takes every column down the
    copied path and the values stay right; staging off copies all."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import faults, stats
    from hyperspace_tpu_torch.execution import io as hio
    from hyperspace_tpu_torch.execution import staging

    n = 100_000
    t = pa.table({
        "a": np.arange(n, dtype=np.int64), "b": np.arange(n, dtype=np.float32),
        "c": pa.array([None if i % 9 == 0 else i for i in range(n)], type=pa.int32()),
    })
    pq.write_table(t, tmp_path / "p.parquet")
    path = [str(tmp_path / "p.parquet")]

    def read():
        zc, cp = stats.get("device.stage.bytes_zero_copy"), stats.get("device.stage.bytes_copied")
        ct = hio.read_parquet(path, device=cuda)
        assert ct.columns["a"].device.type == "cuda"
        np.testing.assert_array_equal(ct.columns["a"].cpu().numpy(), np.arange(n))
        np.testing.assert_array_equal(ct.columns["b"].cpu().numpy(), np.arange(n, dtype=np.float32))
        return stats.get("device.stage.bytes_zero_copy") - zc, stats.get("device.stage.bytes_copied") - cp

    assert read() == (n * (8 + 4), n * 4)
    faults.reset()
    with faults.injected("device.stage"):
        assert read() == (0, n * (8 + 4 + 4))
    faults.reset()
    staging.set_enabled(False)
    try:
        assert read() == (0, n * (8 + 4 + 4))
    finally:
        staging.set_enabled(True)


@pytest.mark.gpu
def test_a_two_member_fleet_serves_on_the_card(cuda, tmp_path):
    """Two fleet members spawned on the card: each opens a CUDA context
    of its own and serves a Q1-shaped aggregate through the fleet's shared
    plan cache, launching K1 in its own process, with the CPU's answer."""
    import sys
    from pathlib import Path

    from hyperspace_tpu_torch import HyperspaceSession
    from hyperspace_tpu_torch.datagen import gen_tpch_lineitem
    from hyperspace_tpu_torch.parallel.procpool import spawn_context
    from hyperspace_tpu_torch.serve.fleet import FleetSupervisor

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import _torch_fleet as members

    gen_tpch_lineitem(tmp_path / "li", sf=0.002)
    cpu = HyperspaceSession(system_path=str(tmp_path / "idx"), device="cpu")
    want = cpu.to_pandas(cpu.parquet(tmp_path / "li").aggregate(["l_returnflag", "l_linestatus"], [
        ("sum", "l_quantity", "q"), ("min", "l_extendedprice", "lo"), ("max", "l_discount", "hi"),
        ("count", None, "c")]))
    out_q = spawn_context().Queue()
    sup = FleetSupervisor(members.card_member, fleet_dir=str(tmp_path / "fleet"), n=2,
                          args=(str(tmp_path / "li"), str(tmp_path / "idx"), out_q), max_restarts=0)
    with sup:
        sup.start()
        got = [out_q.get(timeout=300) for _ in range(2)]
    assert len({g["pid"] for g in got}) == 2
    keys = ["l_returnflag", "l_linestatus"]
    for g in got:
        assert g["cuda_initialized"] and g["device"].startswith("cuda") and g["k1_launches"] > 0
        assert g["forbidden"] == []
        served = pd.DataFrame(g["rows"]).sort_values(keys).reset_index(drop=True)
        pd.testing.assert_frame_equal(served, want.sort_values(keys).reset_index(drop=True), check_dtype=False)


@pytest.mark.gpu
def test_a_thread_mode_commit_then_a_pinned_read_on_the_card(cuda, tmp_path):
    """The ingest daemon in thread mode on a card session: one micro-batch
    commit whose bucket sort ran on the card, then a read pinned before
    the commit repeats the old answer on the card while a live read sees
    the new rows; a zone aggregate launches K1 on the pinned and the live
    read, with the CPU's answers."""
    import json

    import pyarrow as pa
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig, col
    from hyperspace_tpu_torch.obs import events

    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(5)
    n = 20_000
    pq.write_table(pa.table({"id": np.arange(n), "zone": rng.integers(0, 64, n), "fare": rng.random(n) * 50}),
                   src / "part-0.parquet")
    changelog = tmp_path / "changes.jsonl"
    with open(changelog, "w") as f:
        for i in range(n, n + 500):
            f.write(json.dumps({"id": i, "zone": int(i % 64), "fare": float(i % 97)}) + "\n")
    s = HyperspaceSession(system_path=str(tmp_path / "sys"), num_buckets=4, device=cuda)
    s.conf.set("hyperspace.ingest.enabled", "true")
    hs = Hyperspace(s)
    hs.create_index(s.parquet(src), IndexConfig("z", ["zone"], ["id", "fare"]))
    s.enable_hyperspace()
    daemon = hs.ingest().watch("z", changelog=changelog)
    gauge = s.parquet(src).filter(col("zone") == 42).select("zone", "fare")
    agg = s.parquet(src).filter(col("zone").isin([3, 42])).aggregate(["zone"], [("sum", "fare", "s"),
                                                                                ("count", None, "c")])

    def answers(snapshot=None):
        g = s.run(gauge, snapshot=snapshot)
        assert g.columns["fare"].device.type == "cuda"
        before = segment_reduce.launches
        a = s.run(agg, snapshot=snapshot).decode()
        launched = segment_reduce.launches - before
        return len(g.decode()["fare"]), sorted(zip(a["zone"].tolist(), a["c"].tolist(), a["s"].tolist())), launched

    snap = s.pin_snapshot()
    pinned = answers(snap)
    assert daemon.tick()["commits"] == 1
    (committed,) = [e["fields"] for e in events.recent() if e["name"] == "ingest.committed"]
    assert committed["sort_device"].startswith("cuda") and s.last_build_stats["sort_device"].startswith("cuda")
    again, live = answers(snap), answers()
    snap.release()
    assert again[:2] == pinned[:2] and pinned[2] >= 1 and again[2] >= 1 and live[2] >= 1
    added = {z: sum(1 for i in range(n, n + 500) if i % 64 == z) for z in (3, 42)}
    assert live[0] == pinned[0] + added[42]
    assert [r[1] for r in live[1]] == [r[1] + added[r[0]] for r in pinned[1]]
    cpu = HyperspaceSession(system_path=str(tmp_path / "sys"), device="cpu").enable_hyperspace()
    want = cpu.run(agg).decode()
    want = sorted(zip(want["zone"].tolist(), want["c"].tolist(), want["s"].tolist()))
    assert [w[:2] for w in want] == [r[:2] for r in live[1]]
    np.testing.assert_allclose([w[2] for w in want], [r[2] for r in live[1]], rtol=1e-12)


@pytest.mark.gpu
def test_a_four_shard_mesh_on_the_card_equals_one_device(cuda, tmp_path):
    """Four virtual shards of one card: the mesh build's bucket files are
    byte-identical to the one-device build's; an aggregate launches K1
    once a shard (agg_devices 4) and an aligned join K2 once a shard
    (join_devices 4); both equal the one-device session's, sums within
    2·n·u·Σ|v| of them."""
    import hyperspace_tpu_torch as htorch
    from hyperspace_tpu_torch.datagen import gen_tpch_orders
    from hyperspace_tpu_torch.ops.sortkeys import run_bounds
    from hyperspace_tpu_torch.parallel.mesh import make_mesh

    src = _li_source(tmp_path)
    gen_tpch_orders(tmp_path / "o", sf=0.004, seed=43)
    outs = {}
    for name, kw in (("one", {"device": cuda}), ("mesh", {"mesh": make_mesh([torch.device("cuda:0")] * 4)})):
        s = htorch.HyperspaceSession(system_path=str(tmp_path / name), num_buckets=16, **kw)
        hs = htorch.Hyperspace(s)
        li, o = s.parquet(src), s.parquet(tmp_path / "o")
        hs.create_index(li, htorch.IndexConfig("li", ["l_orderkey"], ["l_extendedprice", "l_returnflag"]))
        assert s.last_build_stats["mesh_devices"] == (4 if name == "mesh" else 1)
        hs.create_index(o, htorch.IndexConfig("o", ["o_orderkey"], ["o_totalprice"]))
        s.enable_hyperspace()
        k1, k2 = segment_reduce.launches, run_bounds.launches
        agg = s.to_pandas(li.aggregate(["l_returnflag"], [("sum", "l_extendedprice", "s"), ("count", None, "c")]))
        assert segment_reduce.launches - k1 == (4 if name == "mesh" else 1)
        assert s.last_query_stats.get("agg_devices", 1) == (4 if name == "mesh" else 1)
        j = s.to_pandas(li.select("l_orderkey", "l_extendedprice").join(
            o.select("o_orderkey", "o_totalprice"), ["l_orderkey"], ["o_orderkey"]))
        assert run_bounds.launches - k2 == (4 if name == "mesh" else 1)
        assert s.last_query_stats["join_devices"] == (4 if name == "mesh" else 1)
        outs[name] = (agg.sort_values("l_returnflag").reset_index(drop=True),
                      j.sort_values(["l_orderkey", "l_extendedprice"]).reset_index(drop=True))
    _same_files(tmp_path / "one" / "li" / "v__=0", tmp_path / "mesh" / "li" / "v__=0")
    (a1, j1), (a2, j2) = outs["one"], outs["mesh"]
    pd.testing.assert_frame_equal(j1, j2)
    assert a1["c"].tolist() == a2["c"].tolist()
    src_df = pd.read_parquet(src)
    tol = 2 * len(src_df) * 2.0**-53 * src_df.groupby("l_returnflag")["l_extendedprice"].apply(
        lambda v: v.abs().sum()).sort_index().to_numpy()
    assert (np.abs(a1["s"] - a2["s"]).to_numpy() <= tol).all()


@pytest.mark.gpu
def test_auto_resolves_to_the_device_for_each_operator(cuda, tmp_path, monkeypatch):
    """On the card `auto` picks the device venue for every operator: the
    aggregate launches K1, the aligned join and the fused aggregate over
    it launch K2, the mask, the sort and the build run on the device."""
    import hyperspace_tpu_torch as htorch
    from hyperspace_tpu_torch.datagen import gen_tpch_orders
    from hyperspace_tpu_torch.ops.sortkeys import run_bounds

    monkeypatch.delenv("HYPERSPACE_VENUE", raising=False)
    src = _li_source(tmp_path)
    gen_tpch_orders(tmp_path / "o", sf=0.004, seed=43)
    s = htorch.HyperspaceSession(system_path=str(tmp_path / "idx"), num_buckets=16, device=cuda)
    hs = htorch.Hyperspace(s)
    li, o = s.parquet(src), s.parquet(tmp_path / "o")
    hs.create_index(li, htorch.IndexConfig("li", ["l_orderkey"], ["l_extendedprice", "l_returnflag"]))
    assert s.last_build_stats["sort_venue"] == "device"
    hs.create_index(o, htorch.IndexConfig("o", ["o_orderkey"], ["o_totalprice"]))
    s.enable_hyperspace()
    k1, k2 = segment_reduce.launches, run_bounds.launches
    s.run(li.aggregate(["l_returnflag"], [("sum", "l_extendedprice", "s")]))
    assert s.last_query_stats["agg_path"] == "segment-reduce-cuda" and segment_reduce.launches > k1
    j = li.select("l_orderkey", "l_extendedprice").join(o.select("o_orderkey", "o_totalprice"), ["l_orderkey"],
                                                         ["o_orderkey"])
    s.run(j)
    assert s.last_query_stats["join_kernel"] == "device-searchsorted" and run_bounds.launches > k2
    s.run(j.aggregate([], [("sum", "o_totalprice", "t")]))
    assert s.last_query_stats["join_kernel"] == "device-run-prefix"
    s.run(li.filter(htorch.col("l_extendedprice") > 1000.0).sort([("l_extendedprice", False)]))
    assert s.last_query_stats["mask_kernel"] == "device-mask" and s.last_query_stats["sort_op"] == "DeviceSort"


@pytest.mark.gpu
def test_a_host_venue_aggregate_launches_no_k1(cuda, tmp_path):
    """Q1's shape on the host aggregation venue launches no K1 and equals
    the device venue's answer (counts exactly, sums within 2·n·u·Σ|v|)."""
    import hyperspace_tpu_torch as htorch

    src = _li_source(tmp_path)
    s = htorch.HyperspaceSession(system_path=str(tmp_path / "idx"), num_buckets=16, device=cuda)
    li = s.parquet(src)
    plan = li.aggregate(["l_returnflag", "l_linestatus"], [("sum", "l_extendedprice", "s"), ("count", None, "c"),
                                                          ("min", "l_discount", "mn"), ("max", "l_quantity", "mx")])
    dev = s.to_pandas(plan).sort_values(["l_returnflag", "l_linestatus"]).reset_index(drop=True)
    s.conf.set("hyperspace.agg.venue", "host")
    k1 = segment_reduce.launches
    host = s.to_pandas(plan).sort_values(["l_returnflag", "l_linestatus"]).reset_index(drop=True)
    torch.cuda.synchronize()
    assert segment_reduce.launches == k1 and s.last_query_stats["agg_path"] == "segment-reduce-host"
    pd.testing.assert_frame_equal(host.drop(columns="s"), dev.drop(columns="s"))
    tol = 2 * len(pd.read_parquet(src)) * 2.0**-53 * host["s"].abs()
    assert (np.abs(host["s"] - dev["s"]) <= tol).all()


@pytest.mark.gpu
def test_the_launch_contract_proofs_hold_against_one_launch_of_each_kernel(cuda):
    """The static launch contract (HSL026) against the card: each kernel the
    proofs name, called once on a CUDA tensor, adds exactly one to its
    wrapper's count, agrees with its plain version, and no launch counter
    outside ops.KNOWN_KERNELS exists."""
    import sys
    from pathlib import Path

    from hyperspace_tpu_torch.analysis.callgraph import CallGraph
    from hyperspace_tpu_torch.analysis.program import Program
    from hyperspace_tpu_torch.analysis.raises import Raises
    from hyperspace_tpu_torch.analysis.tracedomain import LaunchDomains
    from hyperspace_tpu_torch.ops import KNOWN_KERNELS
    from hyperspace_tpu_torch.ops.sortkeys import run_bounds, run_bounds_plain
    from hyperspace_tpu_torch.ops.topk import topk, topk_plain

    repo = Path(__file__).resolve().parent.parent
    program = Program.load([repo / "hyperspace_tpu_torch"])
    cg = CallGraph(program)
    proofs = {p["kernel"]: p for p in LaunchDomains(program, cg, Raises(program, cg)).kernel_proofs()}
    assert set(proofs) == set(KNOWN_KERNELS) and all(p["proven"] for p in proofs.values())

    rng = np.random.default_rng(11)
    gid = torch.from_numpy(rng.integers(0, 6, 10_000).astype(np.int32))
    vals = torch.from_numpy(rng.integers(-50, 50, (4, 10_000)).astype(np.float64))
    sk = torch.from_numpy(np.sort(rng.integers(0, 1000, (4, 2048)).astype(np.int32), axis=1))
    pk = torch.from_numpy(np.sort(rng.integers(0, 1000, (4, 512)).astype(np.int32), axis=1))
    scores = torch.from_numpy(rng.standard_normal((8, 5000)).astype(np.float32))
    calls = {
        "ops.segment_reduce.segment_reduce": (
            segment_reduce, lambda d: segment_reduce(vals.to(d), gid.to(d), 6, ("sum", "min", "max", "sum"))
            if d.type == "cuda" else segment_reduce_plain(vals, gid, 6, ("sum", "min", "max", "sum"))),
        "ops.sortkeys.run_bounds": (
            run_bounds, lambda d: run_bounds(pk.to(d), sk.to(d)) if d.type == "cuda" else run_bounds_plain(pk, sk)),
        "ops.topk.topk": (topk, lambda d: topk(scores.to(d), 10) if d.type == "cuda" else topk_plain(scores, 10)),
    }
    assert set(calls) == set(KNOWN_KERNELS)
    for name, (wrapper, call) in calls.items():
        before = wrapper.launches
        got = call(cuda)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1, name
        want = call(torch.device("cpu"))
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
    sys.path.insert(0, str(repo))
    import chip_smoke

    assert set(chip_smoke.runtime_launch_counters()) == set(KNOWN_KERNELS)

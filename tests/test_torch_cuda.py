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

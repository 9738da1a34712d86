"""Window functions of the port against the JAX package and pandas.

Every function (row_number, rank, dense_rank; sum, count, count(*), mean,
min, max; lag and lead) under every frame (the whole partition, ROWS and
RANGE up to the current row) on the cases of tests/test_window.py, and on
order keys with ties, NULLs, NaN, -0.0 and +0.0 (where the stable sort
must keep the input order of equal keys and put NaN last); int64 sums past
2^53, which must be exact; a string lag / lead; and an empty table. Both
packages return rows in input order, so results compare row by row:
integers, ranks, shifts and extrema exactly, float sums and means within
1e-12 of their magnitude.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hjax
import hyperspace_tpu_torch as htorch
from hyperspace_tpu_torch.plan.nodes import plan_from_json

N = 3_000
AGGS = ("sum", "count", "mean", "min", "max")


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("window")
    rng = np.random.default_rng(3)
    null_v = rng.random(N) < 0.1
    f = np.round(rng.normal(size=N) * 7, 1)  # one decimal: many ties
    f[rng.random(N) < 0.03] = np.nan
    f[rng.random(N) < 0.03] = -0.0
    f[rng.random(N) < 0.03] = 0.0
    null_f = rng.random(N) < 0.05
    big = (2**60 + rng.integers(0, 2**40, N)).astype(np.int64)  # past 2^53
    t = pa.table({
        "g": rng.integers(0, 25, N).astype(np.int64),
        "o": rng.integers(0, 500, N).astype(np.int64),
        "v": pa.array([None if z else int(x) for x, z in zip(rng.integers(1, 100, N), null_v)], type=pa.int64()),
        "f": pa.array([None if z else float(x) for x, z in zip(f, null_f)], type=pa.float64()),
        "big": big,
        "s": pa.array(np.array(["a", "b", "c", "d", "e"], dtype=object)[rng.integers(0, 5, N)]),
        "i": np.arange(N, dtype=np.int64),
    })
    for name in ("t", "empty"):
        (tmp / name).mkdir()
    pq.write_table(t, tmp / "t" / "p.parquet")
    pq.write_table(t.slice(0, 0), tmp / "empty" / "p.parquet")
    out = {"df": t.to_pandas()}
    for name, pkg, kw in (("jax", hjax, {}), ("torch", htorch, {"device": "cpu"})):
        s = pkg.HyperspaceSession(system_path=str(tmp / f"idx_{name}"), num_buckets=4, **kw)
        out[name] = (pkg, s, s.parquet(tmp / "t"), s.parquet(tmp / "empty"))
    return out


def _run(both, build, empty=False):
    frames = []
    for name in ("jax", "torch"):
        pkg, s, t, e = both[name]
        frames.append(s.to_pandas(build(pkg, e if empty else t)))
    return frames


def _assert_same(want: pd.DataFrame, got: pd.DataFrame, tolerant=()):
    assert list(got.columns) == list(want.columns) and len(got) == len(want)
    for c in want.columns:
        a = got[c].to_numpy(dtype=object)
        b = want[c].to_numpy(dtype=object)
        na = np.array([v is None or (isinstance(v, float) and np.isnan(v)) for v in a], dtype=bool)
        nb = np.array([v is None or (isinstance(v, float) and np.isnan(v)) for v in b], dtype=bool)
        assert np.array_equal(na, nb), c
        a, b = a[~na], b[~nb]
        if c in tolerant:
            a, b = a.astype(np.float64), b.astype(np.float64)
            assert np.all(np.abs(a - b) <= 1e-12 * np.maximum(np.abs(b), 1.0)), c
        else:
            assert list(a) == list(b), c


@pytest.mark.parametrize("frame", ["partition", "rows", "range"])
@pytest.mark.parametrize("src", ["v", "f"])
def test_every_aggregate_under_every_frame(both, frame, src):
    def build(pkg, t):
        order = [] if frame == "partition" else [("o", True)]
        funcs = [(fn, src, f"{fn}_{src}") for fn in AGGS] + [("count", None, "n")]
        return t.window(["g"], order_by=order, funcs=funcs, frame=frame)

    want, got = _run(both, build)
    _assert_same(want, got, tolerant=(f"sum_{src}", f"mean_{src}", "mean_v"))


@pytest.mark.parametrize("order", [[("o", True)], [("o", False)], [("f", True)], [("f", False)],
                                   [("s", True), ("o", False)]])
def test_ranking_and_shifts_over_ties_nulls_nan_and_signed_zeros(both, order):
    def build(pkg, t):
        spec = pkg.WindowSpec.of
        return t.window(["g"], order_by=order, funcs=[
            ("row_number", None, "rn"), ("rank", None, "rk"), ("dense_rank", None, "dr"),
            spec("lag", "i", "lag_i", 1), spec("lead", "i", "lead2_i", 2), spec("lag", "f", "lag3_f", 3),
        ])

    want, got = _run(both, build)
    # row_number and the shifts of the row index `i` pin the order of
    # equal keys: the stable sort's input order.
    _assert_same(want, got)


@pytest.mark.parametrize("frame", ["rows", "range"])
def test_running_extrema_and_sums_over_a_float_order_key(both, frame):
    def build(pkg, t):
        return t.window(["g"], order_by=[("f", False)], frame=frame, funcs=[
            ("min", "f", "mn"), ("max", "f", "mx"), ("sum", "v", "sv"), ("mean", "f", "mf"), ("count", "f", "cf")])

    want, got = _run(both, build)
    _assert_same(want, got, tolerant=("mf",))


def test_int64_sums_past_two_to_the_53_are_exact(both):
    def build(pkg, t):
        return t.window(["g"], order_by=[("o", True)], frame="rows", funcs=[("sum", "big", "rs")]).window(
            ["g"], funcs=[("sum", "big", "ps")])

    want, got = _run(both, build)
    _assert_same(want, got)
    df = both["df"]
    totals = {g: sum(int(x) for x in part) % 2**64 for g, part in df.groupby("g").big}
    assert [int(x) % 2**64 for x in got.ps] == [totals[g] for g in df.g]


def test_rank_against_pandas(both):
    _, got = _run(both, lambda pkg, t: t.window(["g"], order_by=[("o", True)], funcs=[
        ("rank", None, "rk"), ("dense_rank", None, "dr")]))
    df = both["df"]
    assert got.rk.tolist() == df.groupby("g").o.rank(method="min").astype(np.int64).tolist()
    assert got.dr.tolist() == df.groupby("g").o.rank(method="dense").astype(np.int64).tolist()


def test_lag_lead_against_pandas_shift(both):
    _, got = _run(both, lambda pkg, t: t.window(["g"], order_by=[("o", True)], funcs=[
        ("lag", "v", "lag_v"), pkg.WindowSpec.of("lead", "f", "lead_f", 2), pkg.WindowSpec.of("lag", "o", "lag3", 3)]))
    sdf = both["df"].sort_values("o", kind="stable")
    exp = sdf.groupby("g").o.shift(3).sort_index()
    np.testing.assert_array_equal(got.lag3.astype("Float64").to_numpy(np.float64, na_value=np.nan),
                                  exp.to_numpy(np.float64), strict=False)


def test_string_lag_lead_and_json(both):
    def build(pkg, t):
        return t.window(["g"], order_by=[("o", True), ("i", True)], funcs=[
            ("lag", "s", "prev_s"), pkg.WindowSpec.of("lead", "s", "next_s", 1)])

    want, got = _run(both, build)
    _assert_same(want, got)
    plan = build(htorch, both["torch"][2])
    d = plan.to_json()
    assert plan_from_json(d).to_json() == d == build(hjax, both["jax"][2]).to_json()


def test_windows_without_partitions_and_over_an_empty_table(both):
    def build(pkg, t):
        return t.window([], order_by=[("o", True), ("i", True)], frame="rows", funcs=[
            ("row_number", None, "rn"), ("sum", "v", "sv"), ("max", "f", "mx")])

    want, got = _run(both, build)
    _assert_same(want, got)
    want, got = _run(both, build, empty=True)
    assert len(got) == len(want) == 0 and list(got.columns) == list(want.columns)


def test_window_validation():
    from hyperspace_tpu_torch.plan.nodes import Scan, Window, WindowSpec
    from hyperspace_tpu_torch.schema import Field, Schema

    scan = Scan("/nowhere", "parquet", Schema((Field("g", "int64"), Field("v", "int64"))))
    with pytest.raises(ValueError):
        scan.window(["g"], funcs=[("lag", "v", "lv")])  # needs ORDER BY
    with pytest.raises(ValueError):
        scan.window(["g"], order_by=["v"], funcs=[("lag", "v", "lv", 0)])  # offset >= 1
    with pytest.raises(ValueError):
        Window(scan, ["g"], [], [WindowSpec.of("sum", "v", "s")], frame="rows")  # a frame needs ORDER BY
    with pytest.raises(ValueError):
        scan.window(["g"], order_by=["v"], funcs=[("sum", "v", "g")])  # the alias collides


def test_nan_in_min_max_follows_the_jax_package_frame_by_frame(tmp_path):
    """The JAX package's whole-partition min/max propagate a NaN (numpy's
    reduceat) while its running min/max rank NaN above every number, so
    the ROWS frame's value at a partition's last row is not the partition
    frame's (ROADMAP queue 3). The port follows it frame by frame."""
    (tmp_path / "t").mkdir()
    pq.write_table(pa.table({"g": [0, 0, 0], "o": [1, 2, 3], "f": [2.0, float("nan"), 1.0]}),
                   tmp_path / "t" / "p.parquet")
    out = {}
    for name, pkg, kw in (("jax", hjax, {}), ("torch", htorch, {"device": "cpu"})):
        s = pkg.HyperspaceSession(system_path=str(tmp_path / f"idx_{name}"), num_buckets=2, **kw)
        t = s.parquet(tmp_path / "t")
        whole = s.to_pandas(t.window(["g"], funcs=[("min", "f", "mn"), ("max", "f", "mx")]))
        rows = s.to_pandas(t.window(["g"], order_by=[("o", True)], frame="rows",
                                    funcs=[("min", "f", "mn"), ("max", "f", "mx")]))
        out[name] = (whole, rows)
    for whole, rows in out.values():
        assert np.isnan(whole.mn).all() and np.isnan(whole.mx).all()
        last = rows[rows.o == 3]
        assert last.mn.item() == 1.0 and np.isnan(last.mx.item())

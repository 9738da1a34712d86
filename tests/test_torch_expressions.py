"""LIKE, date parts and math functions in the port, against the JAX
package and against plain Python.

One seeded table (nullable strings with shared prefixes, the empty string
and a trailing underscore; dates from 1900 to 2100, negative days
included; nullable floats and ints) runs through both packages: each
expression in a filter, a computed projection and an aggregate must give
the JAX package's rows. LIKE over an index's key and a year comparison
over a date key prune the same files in both packages. The date parts of
every day of date_dim's range equal the JAX package's `eval_date_part`
(numpy's datetime64).
"""

import datetime
import re

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu as hjax
import hyperspace_tpu_torch as htorch
from hyperspace_tpu.plan.expr import eval_date_part as jax_date_part
from hyperspace_tpu_torch.plan.expr import eval_date_part
from hyperspace_tpu_torch.plan.nodes import plan_from_json

N = 3_000
WORDS = ["", "a", "ab", "abc", "abd", "ab_", "b", "ba", "bab", "special requests", "xspecialyrequestsz", "zz%"]
EPOCH = datetime.date(1970, 1, 1)


def _days(iso: str) -> int:
    return (datetime.date.fromisoformat(iso) - EPOCH).days


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("expr")
    rng = np.random.default_rng(31)
    s = np.array(WORDS, dtype=object)[rng.integers(0, len(WORDS), N)]
    s_null = rng.random(N) < 0.08
    d = rng.integers(_days("1900-01-02"), _days("2100-01-01") + 1, N).astype(np.int32)
    d_null = rng.random(N) < 0.05
    x = np.round(rng.normal(size=N) * 40, 3)
    x_null = rng.random(N) < 0.1
    s_list = [None if z else str(v) for v, z in zip(s, s_null)]
    d_list = [None if z else int(v) for v, z in zip(d, d_null)]
    x_list = [None if z else float(v) for v, z in zip(x, x_null)]
    i = rng.integers(-500, 500, N).astype(np.int64)
    df = pd.DataFrame({"k": np.arange(N, dtype=np.int64), "s": pd.Series(s_list, dtype=object)})
    t = pa.table({
        "k": df["k"].to_numpy(),
        "s": pa.array(s_list, type=pa.string()),
        "d": pa.array(d_list, type=pa.int32()).cast(pa.date32()),
        "x": pa.array(x_list, type=pa.float64()),
        "i": i,
    })
    root = tmp / "t"
    root.mkdir()
    for j in range(4):
        pq.write_table(t.slice(j * N // 4, N // 4), root / f"part-{j}.parquet")
    out = {"df": df}
    for name, pkg, kw in (("jax", hjax, {}), ("torch", htorch, {"device": "cpu"})):
        session = pkg.HyperspaceSession(system_path=str(tmp / f"idx_{name}"), num_buckets=4, **kw)
        scan = session.parquet(root)
        hs = pkg.Hyperspace(session)
        hs.create_index(scan, pkg.IndexConfig("by_s", ["s"], ["k", "x"]))
        hs.create_index(scan, pkg.IndexConfig("by_d", ["d"], ["k", "i"]))
        session.enable_hyperspace()
        out[name] = (pkg, session, scan)
    return out


def _rows(frame: pd.DataFrame) -> list:
    return sorted(
        (tuple(None if pd.isna(v) else v for v in r) for r in frame.itertuples(index=False)),
        key=lambda r: tuple((v is None, str(v)) for v in r),
    )


def _run(both, build):
    """(JAX frame and stats, port frame and stats) of one plan."""
    out = []
    for name in ("jax", "torch"):
        pkg, session, scan = both[name]
        frame = session.to_pandas(build(pkg, scan))
        out.append((frame, dict(session.last_query_stats)))
    return out


def _like(pattern: str):
    rx = re.compile("".join(".*" if c == "%" else "." if c == "_" else re.escape(c) for c in pattern), re.DOTALL)
    return lambda v: v is not None and rx.fullmatch(v) is not None


@pytest.mark.parametrize("pattern", ["ab%", "%b", "%b%", "a_c", "ab_", "abc", "", "%", "_", "%special%requests%"])
def test_like_filter_equals_the_jax_package_and_a_regex(both, pattern):
    (want, _), (got, _) = _run(both, lambda pkg, t: t.filter(pkg.col("s").like(pattern)).select("k", "s"))
    df = both["df"]
    match = df[[_like(pattern)(v) for v in df["s"]]]
    assert _rows(got) == _rows(want) == _rows(match[["k", "s"]])


@pytest.mark.parametrize("pattern", ["ab%", "%special%requests%", "a_c"])
def test_not_like_keeps_nulls_out(both, pattern):
    (want, _), (got, _) = _run(both, lambda pkg, t: t.filter(~pkg.col("s").like(pattern)).select("k"))
    df = both["df"]
    keep = [v is not None and not _like(pattern)(v) for v in df["s"]]
    assert _rows(got) == _rows(want) == _rows(df[keep][["k"]])


def test_like_as_a_projection_and_in_a_case_aggregate(both):
    def build(pkg, t):
        return t.with_column("m", pkg.col("s").like("ab%")).select("k", "m")

    (want, _), (got, _) = _run(both, build)
    assert _rows(got) == _rows(want)

    def agg(pkg, t):
        hit = pkg.when(pkg.col("s").like("%b%"), pkg.col("x")).otherwise(0.0)
        return t.aggregate(["s"], [pkg.AggSpec.of("sum", hit, "sx"), ("count", None, "n")])

    (want, _), (got, _) = _run(both, agg)
    assert list(got.columns) == list(want.columns)
    g, w = got.sort_values("s", na_position="first"), want.sort_values("s", na_position="first")
    assert g["n"].tolist() == w["n"].tolist()
    np.testing.assert_allclose(g["sx"].to_numpy(float), w["sx"].to_numpy(float), rtol=1e-12, atol=1e-9)


def test_like_prefix_prunes_the_same_files(both):
    (want, ws), (got, gs) = _run(both, lambda pkg, t: t.filter(pkg.col("s").like("ab%")).select("k", "s", "x"))
    assert _rows(got) == _rows(want)
    assert gs["files_pruned"] == ws["files_pruned"]


def test_date_parts_of_every_date_dim_day_equal_the_jax_package():
    days = np.arange(_days("1900-01-02"), _days("2100-01-01") + 1, dtype=np.int32)
    for part in ("year", "month", "day"):
        want = jax_date_part(part, days, np)
        got = eval_date_part(part, torch.from_numpy(days)).numpy()
        assert got.dtype == np.int64 and np.array_equal(got, want), part


@pytest.mark.parametrize("where", [
    ("year", "eq", 2000), ("year", "lt", 1950), ("year", "ge", 2080), ("year", "ne", 1999),
    ("month", "eq", 2), ("month", "gt", 10), ("day", "le", 3), ("day", "eq", 29),
])
def test_date_part_filters_equal_the_jax_package(both, where):
    part, op, v = where

    def build(pkg, t):
        dp = getattr(pkg, part)(pkg.col("d"))
        cmp = {"eq": dp == v, "lt": dp < v, "ge": dp >= v, "ne": dp != v, "gt": dp > v, "le": dp <= v}[op]
        return t.filter(cmp).select("k", "d")

    (want, ws), (got, gs) = _run(both, build)
    assert len(want) > 0 and _rows(got) == _rows(want)
    assert gs["files_pruned"] == ws["files_pruned"]


def test_year_over_an_index_key_prunes_like_the_jax_package(both):
    (want, ws), (got, gs) = _run(
        both, lambda pkg, t: t.filter((pkg.year(pkg.col("d")) == 2001) & (pkg.col("i") > 0)).select("k", "i"))
    assert _rows(got) == _rows(want)
    assert (gs["files_pruned"], gs["rows_pruned"]) == (ws["files_pruned"], ws["rows_pruned"])


def test_date_parts_as_projections_and_group_keys(both):
    def build(pkg, t):
        c = pkg.col("d")
        return t.select("k", ("y", pkg.year(c)), ("m", pkg.month(c)), ("dd", pkg.day(c)))

    (want, _), (got, _) = _run(both, build)
    assert _rows(got) == _rows(want)
    assert got["y"].dtype == want["y"].dtype

    def agg(pkg, t):
        return t.with_column("y", pkg.year(pkg.col("d"))).aggregate(
            ["y"], [pkg.AggSpec.of("sum", pkg.month(pkg.col("d")), "sm"), ("count", None, "n")])

    (want, _), (got, _) = _run(both, agg)
    assert _rows(got) == _rows(want)


def test_math_functions_in_filters_projections_and_aggregates(both):
    def proj(pkg, t):
        x, i = pkg.col("x"), pkg.col("i")
        return t.select("k", ("r", pkg.sqrt(pkg.abs_(x))), ("f", pkg.floor(x / 7.0)), ("a", pkg.abs_(i)),
                        ("fi", pkg.floor(i)), ("sq", pkg.sqrt(i)))

    (want, _), (got, _) = _run(both, proj)
    assert list(got.columns) == list(want.columns)
    g, w = got.sort_values("k").reset_index(drop=True), want.sort_values("k").reset_index(drop=True)
    for c in ("f", "a", "fi"):
        assert g[c].tolist() == w[c].tolist(), c
    for c in ("r", "sq"):
        # torch's vectorized float64 sqrt on the CPU is within 1 ulp, not
        # correctly rounded as numpy's (and CUDA's) is.
        a, b = g[c].to_numpy(float), w[c].to_numpy(float)
        assert np.array_equal(np.isnan(a), np.isnan(b)), c
        np.testing.assert_array_max_ulp(a[~np.isnan(a)], b[~np.isnan(b)], maxulp=1)

    (want, _), (got, _) = _run(both, lambda pkg, t: t.filter(pkg.abs_(pkg.col("i")) < 20).select("k"))
    assert _rows(got) == _rows(want)
    (want, _), (got, _) = _run(both, lambda pkg, t: t.filter(pkg.sqrt(pkg.abs_(pkg.col("x"))) > 5.0).select("k"))
    assert _rows(got) == _rows(want)

    def agg(pkg, t):
        return t.aggregate([], [pkg.AggSpec.of("sum", pkg.abs_(pkg.col("i")), "si"),
                                pkg.AggSpec.of("max", pkg.floor(pkg.col("x")), "fx"),
                                pkg.AggSpec.of("mean", pkg.sqrt(pkg.abs_(pkg.col("x"))), "mr")])

    (want, _), (got, _) = _run(both, agg)
    assert got["si"].tolist() == want["si"].tolist() and got["fx"].tolist() == want["fx"].tolist()
    np.testing.assert_allclose(got["mr"].to_numpy(float), want["mr"].to_numpy(float), rtol=1e-12)


def test_arithmetic_probes_keep_numpy_dtypes(both):
    # An int64 column against a float literal compares in float64, as
    # numpy does (torch's own promotion would round through float32).
    def build(pkg, t):
        return t.filter((pkg.col("i") * 0.3) > 100.05).select("k")

    (want, _), (got, _) = _run(both, build)
    assert _rows(got) == _rows(want)
    (want, _), (got, _) = _run(both, lambda pkg, t: t.filter((pkg.col("i") / 3) >= 33.34).select("k"))
    assert _rows(got) == _rows(want)


def test_new_expressions_round_trip_through_json(both):
    _, _, scan = both["torch"]
    c = htorch.col
    plan = scan.filter(c("s").like("a%") & (htorch.year(c("d")) == 2000) & (htorch.abs_(c("i")) > 3)).select(
        "k", ("r", htorch.sqrt(c("x"))), ("m", htorch.month(c("d"))), ("f", htorch.floor(c("x"))),
        ("dl", htorch.date_lit("1999-02-22")))
    d = plan.to_json()
    assert plan_from_json(d).to_json() == d
    pkg, _, jscan = both["jax"]
    jc = pkg.col
    jplan = jscan.filter(jc("s").like("a%") & (pkg.year(jc("d")) == 2000) & (pkg.abs_(jc("i")) > 3)).select(
        "k", ("r", pkg.sqrt(jc("x"))), ("m", pkg.month(jc("d"))), ("f", pkg.floor(jc("x"))),
        ("dl", pkg.date_lit("1999-02-22")))
    assert jplan.to_json() == d

"""The port's join slice end to end on the CPU, against the JAX package.

Two datasets go through both packages with the same seeded inputs:

(a) the fact/dim pair of tests/test_device_staging.py (nullable ints,
    dictionary-coded strings, an int32 key `k`, 8 buckets), plus one
    nullable join-key column per side (`fnk`, `dnk`), indexed on both
    sides, so that null keys must not match;
(b) TPC-H lineitem and orders from the port's generators at sf=0.001,
    each with its covering index on the order key, 8 buckets.

Each query runs with the index enabled (the join rule rewrites both
sides; the port must take the zero-exchange aligned path) and disabled
(one partition). Rows are compared after sorting: keys, counts, integral
sums and extrema exactly. Non-integral sums over the join (J2's and J3's)
are held to the float64 bound that tests/test_torch_join_agg.py derives,
with its per-bucket quantities replaced by upper bounds that hold on
either path: for a group of `count` joined pairs, a column `v` and a
secondary side of N rows,

    tol = 2·(γ_{count+B}·count·max|v| + [s only] 2·count·γ_N·Σ_side|v|)

(γ_n <= 1.01·n·2^-53): Σ|w_i| <= count·max|v|, a bucket holds at most N
secondary rows whose |v| sum to at most Σ_side|v|, and only matched rows
add rounding to the fold. A mean's tolerance is its sum's over count.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hjax
import hyperspace_tpu_torch as htorch
from hyperspace_tpu_torch.datagen import gen_tpch_lineitem, gen_tpch_orders
from hyperspace_tpu_torch.plan.nodes import plan_from_json

SF = 0.001
BUCKETS = 8
U = 2.0**-53
PACKAGES = (("jax", hjax, {}), ("torch", htorch, {"device": "cpu"}))


def _session(pkg, kw, system_path):
    return pkg.HyperspaceSession(system_path=str(system_path), num_buckets=BUCKETS, **kw)


# -- datasets -------------------------------------------------------------------


@pytest.fixture(scope="module")
def tpch(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tpch_join")
    gen_tpch_lineitem(tmp / "lineitem", sf=SF, seed=42)
    gen_tpch_orders(tmp / "orders", sf=SF, seed=43)
    out = {}
    for name, pkg, kw in PACKAGES:
        session = _session(pkg, kw, tmp / f"idx_{name}")
        li, orders = session.parquet(tmp / "lineitem"), session.parquet(tmp / "orders")
        hs = pkg.Hyperspace(session)
        hs.create_index(li, pkg.IndexConfig(
            "li_ok", ["l_orderkey"], ["l_partkey", "l_quantity", "l_extendedprice", "l_discount"]
        ))
        hs.create_index(orders, pkg.IndexConfig("o_ok", ["o_orderkey"], ["o_totalprice", "o_orderpriority"]))
        out[name] = (pkg, session, li, orders)
    out["root"] = tmp
    return out


@pytest.fixture(scope="module")
def factdim(tmp_path_factory):
    """test_device_staging.py's fact/dim pair plus a nullable join key on
    each side (`fnk`, `dnk`): null keys on both sides, keys present on
    one side only, and duplicates on both."""
    tmp = tmp_path_factory.mktemp("factdim")
    n = 4_000
    rng = np.random.default_rng(7)
    fact = pa.table({
        "k": rng.integers(0, 200, n).astype(np.int32),
        "q": rng.integers(0, 1000, n).astype(np.float64),
        "n": pa.array([None if i % 7 == 0 else int(i % 97) for i in range(n)], type=pa.int64()),
        "s": pa.array([f"cat_{i % 13:02d}" for i in range(n)]),
        "fnk": pa.array([None if i % 5 == 0 else int(i % 150) for i in range(n)], type=pa.int64()),
    })
    dim = pa.table({
        "k": np.arange(180, dtype=np.int32),
        "w": rng.integers(0, 50, 180).astype(np.float64),
        "t": pa.array([f"tag_{i % 5}" for i in range(180)]),
        "dnk": pa.array([None if i % 6 == 0 else int(i % 170) for i in range(180)], type=pa.int64()),
    })
    (tmp / "fact").mkdir()
    (tmp / "dim").mkdir()
    pq.write_table(fact, tmp / "fact" / "p.parquet")
    pq.write_table(dim, tmp / "dim" / "p.parquet")
    out = {}
    for name, pkg, kw in PACKAGES:
        session = _session(pkg, kw, tmp / f"idx_{name}")
        fs, ds = session.parquet(tmp / "fact"), session.parquet(tmp / "dim")
        hs = pkg.Hyperspace(session)
        hs.create_index(fs, pkg.IndexConfig("pf_k", ["k"], ["q", "n", "s", "fnk"]))
        hs.create_index(ds, pkg.IndexConfig("pd_k", ["k"], ["w", "t", "dnk"]))
        hs.create_index(fs, pkg.IndexConfig("pf_nk", ["fnk"], ["q", "s"]))
        hs.create_index(ds, pkg.IndexConfig("pd_nk", ["dnk"], ["w", "t"]))
        out[name] = (pkg, session, fs, ds)
    return out


# -- queries --------------------------------------------------------------------


def _j1(li, orders):
    return li.select("l_orderkey", "l_extendedprice").join(
        orders.select("o_orderkey", "o_totalprice", "o_orderpriority"), ["l_orderkey"], ["o_orderkey"]
    )


def _j(li, orders):
    return li.select("l_orderkey", "l_quantity", "l_extendedprice", "l_discount").join(
        orders.select("o_orderkey", "o_totalprice", "o_orderpriority"), ["l_orderkey"], ["o_orderkey"]
    )


def _j2(li, orders):
    """Grouped on the orders side: orders is primary, a lineitem bucket
    is the secondary row."""
    return _j(li, orders).aggregate(["o_orderpriority"], [
        ("sum", "l_extendedprice", "sum_price"),
        ("sum", "l_quantity", "sum_qty"),
        ("min", "l_discount", "min_disc"),
        ("max", "l_extendedprice", "max_price"),
        ("mean", "o_totalprice", "avg_total"),
        ("count", None, "cnt"),
    ])


def _j3(li, orders):
    """Grouped on the lineitem side: lineitem is primary."""
    return _j(li, orders).aggregate(["l_quantity"], [
        ("sum", "o_totalprice", "sum_total"),
        ("max", "o_totalprice", "max_total"),
        ("sum", "l_extendedprice", "sum_price"),
        ("count", None, "cnt"),
    ])


TPCH_QUERIES = {"J1": _j1, "J2": _j2, "J3": _j3}
# Per aggregate query: (group keys, exact columns, {alias: (column, side
# the column lies on relative to the primary, is a mean)}).
TPCH_CHECKS = {
    "J2": (["o_orderpriority"], ["sum_qty", "min_disc", "max_price", "cnt"],
           {"sum_price": ("l_extendedprice", "s", False), "avg_total": ("o_totalprice", "p", True)}),
    "J3": (["l_quantity"], ["max_total", "cnt"],
           {"sum_total": ("o_totalprice", "s", False), "sum_price": ("l_extendedprice", "p", False)}),
}

FACTDIM_QUERIES = {
    "join": lambda fs, ds: fs.join(ds, ["k"]),
    "join_agg": lambda fs, ds: fs.join(ds, ["k"]).aggregate(
        ["s"], [("sum", "w", "sw"), ("count", None, "cnt")]
    ),
    "null_key_join": lambda fs, ds: fs.select("fnk", "q", "s").join(
        ds.select("dnk", "w", "t"), ["fnk"], ["dnk"]
    ),
    "null_key_join_agg": lambda fs, ds: fs.select("fnk", "q", "s").join(
        ds.select("dnk", "w", "t"), ["fnk"], ["dnk"]
    ).aggregate(["t"], [("sum", "q", "sq"), ("max", "w", "mw"), ("min", "q", "mq"), ("count", None, "cnt")]),
}


# -- comparison -----------------------------------------------------------------


def _canon(df: pd.DataFrame, by=None) -> pd.DataFrame:
    return df.sort_values(list(by or df.columns)).reset_index(drop=True)


def _assert_rows_equal(got: pd.DataFrame, want: pd.DataFrame) -> None:
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want) > 0
    pd.testing.assert_frame_equal(_canon(got), _canon(want))


def _gamma(n):
    return 1.01 * np.asarray(n, np.float64) * U


def _assert_aggregate_close(got, want, check, sides):
    """`sides` maps a column to (rows, Σ|v|, max|v|) of its table."""
    keys, exact, tolerant = check
    got, want = _canon(got, keys), _canon(want, keys)
    assert len(got) == len(want) > 0
    for c in keys + exact:
        np.testing.assert_array_equal(got[c].to_numpy(), want[c].to_numpy(), err_msg=c)
    count = want["cnt"].to_numpy().astype(np.float64)
    for alias, (column, kind, is_mean) in tolerant.items():
        n_side, abs_sum, max_abs = sides[column]
        tol = _gamma(count + BUCKETS) * count * max_abs
        if kind == "s":
            tol = tol + 2 * count * _gamma(n_side) * abs_sum
        tol = 2 * tol
        if is_mean:
            tol = tol / count
        diff = np.abs(got[alias].to_numpy() - want[alias].to_numpy())
        assert np.all(diff <= tol), (alias, diff.max(), tol.min())


def _column_stats(root):
    out = {}
    for table, cols in (("lineitem", ["l_extendedprice"]), ("orders", ["o_totalprice"])):
        t = pq.read_table(sorted(str(p) for p in (root / table).glob("*.parquet")))
        for c in cols:
            v = np.abs(t[c].to_numpy())
            out[c] = (len(v), float(v.sum()), float(v.max()))
    return out


def _run(entry, plan_fn, indexed):
    pkg, session, a, b = entry
    session.enable_hyperspace() if indexed else session.disable_hyperspace()
    return session.to_pandas(plan_fn(a, b)), dict(session.last_query_stats)


def _check_port_path(stats, want, indexed, fused):
    """The port's path is the JAX package's (`want`, its stats): aligned
    with the index; without it one partition, or the broadcast probe where
    the JAX package takes it (a side at least 4x the other's rows)."""
    assert stats["join_path"] == want["join_path"]
    if indexed:
        assert stats["join_path"] == "zero-exchange-aligned"
    assert stats["num_buckets"] == (BUCKETS if indexed else 1)
    if fused:
        assert stats["agg_path"] == "fused-join-agg"
        assert stats["join_kernel"] == "device-run-prefix"
    elif stats["join_path"] == "broadcast-hash":
        assert stats["join_kernel"] == "device-broadcast-hash"
    else:
        assert stats["join_kernel"] == "device-searchsorted"


# -- tests ----------------------------------------------------------------------


@pytest.mark.parametrize("indexed", [True, False], ids=["index", "no-index"])
@pytest.mark.parametrize("query", sorted(TPCH_QUERIES))
def test_tpch_join_queries_match_the_jax_package(tpch, query, indexed):
    got, stats = _run(tpch["torch"], TPCH_QUERIES[query], indexed)
    want, want_stats = _run(tpch["jax"], TPCH_QUERIES[query], indexed)
    _check_port_path(stats, want_stats, indexed, fused=query != "J1")
    if query == "J1":
        _assert_rows_equal(got, want)
    else:
        _assert_aggregate_close(got, want, TPCH_CHECKS[query], _column_stats(tpch["root"]))


@pytest.mark.parametrize("indexed", [True, False], ids=["index", "no-index"])
@pytest.mark.parametrize("query", sorted(FACTDIM_QUERIES))
def test_fact_dim_queries_match_the_jax_package(factdim, query, indexed):
    got, stats = _run(factdim["torch"], FACTDIM_QUERIES[query], indexed)
    want, want_stats = _run(factdim["jax"], FACTDIM_QUERIES[query], indexed)
    _check_port_path(stats, want_stats, indexed, fused=query.endswith("_agg"))
    # Every value here is exact: integral sums, extrema, counts, copies.
    _assert_rows_equal(got, want)


def test_null_keys_never_match(factdim):
    _, session, fs, ds = factdim["torch"]
    session.enable_hyperspace()
    got = session.to_pandas(FACTDIM_QUERIES["null_key_join"](fs, ds))
    fact = session.to_pandas(fs.select("fnk", "q", "s"))
    dim = session.to_pandas(ds.select("dnk", "w", "t"))
    want = fact.dropna(subset=["fnk"]).merge(dim.dropna(subset=["dnk"]), left_on="fnk", right_on="dnk")
    assert got["fnk"].notna().all()
    assert len(got) == len(want) > 0


@pytest.mark.parametrize("reader", ["torch", "jax"])
def test_each_package_joins_the_others_indexes(tpch, reader):
    """Indexes built by one package, joined by the other on the
    zero-exchange path, give the building package's own answer."""
    maker = "jax" if reader == "torch" else "torch"
    pkg = htorch if reader == "torch" else hjax
    kw = {"device": "cpu"} if reader == "torch" else {}
    session = _session(pkg, kw, tpch["root"] / f"idx_{maker}").enable_hyperspace()
    li, orders = session.parquet(tpch["root"] / "lineitem"), session.parquet(tpch["root"] / "orders")
    for name, fn in (("J1", _j1), ("J2", _j2)):
        got = session.to_pandas(fn(li, orders))
        assert session.last_query_stats["join_path"] == "zero-exchange-aligned", name
        assert all(s.bucket_spec is not None for s in session.optimized_plan(fn(li, orders)).leaves())
        want, _ = _run(tpch[maker], fn, True)
        if name == "J1":
            _assert_rows_equal(got, want)
        else:
            _assert_aggregate_close(got, want, TPCH_CHECKS[name], _column_stats(tpch["root"]))


def test_one_usable_index_takes_the_jax_packages_path(tpch):
    """orders' index does not cover o_custkey: the rule rewrites the
    lineitem side alone. At this size (5,991 lineitem rows, 1,500 orders)
    orders is more than a quarter of lineitem, so no broadcast: the join
    takes the JAX package's path, the re-bucketing exchange of orders into
    the lineitem index's buckets, with its answer."""
    def plan(li, orders):
        return li.select("l_orderkey", "l_extendedprice").join(
            orders.select("o_orderkey", "o_custkey"), ["l_orderkey"], ["o_orderkey"]
        )

    got, stats = _run(tpch["torch"], plan, True)
    want, want_stats = _run(tpch["jax"], plan, True)
    _, session, _, _ = tpch["torch"]
    assert [s.bucket_spec is not None for s in session.last_optimized_plan.leaves()] == [True, False]
    assert stats["join_path"] == want_stats["join_path"] == "rebucketized-aligned"
    assert stats["exchange_kernel"] == "device-sort-exchange"
    assert stats["num_buckets"] == BUCKETS
    _assert_rows_equal(got, want)


@pytest.mark.parametrize(
    "how,condition", [("left", False), ("semi", False), ("inner", True)], ids=["left", "semi", "residual"]
)
def test_formerly_unported_join_shapes_match_the_jax_package(factdim, how, condition):
    """The three shapes the port once refused (a left join, a semi join,
    an inner join's ON residual) now run, index on and off, with the JAX
    package's rows and path, also under an aggregate."""
    plans = {}
    for name in ("torch", "jax"):
        pkg, _, fs, ds = factdim[name]
        cond = pkg.col("q") > pkg.col("w") if condition else None
        plan = fs.select("k", "q").join(ds.select("k", "w"), ["k"], how=how, condition=cond)
        plans[name] = (plan, plan.aggregate([], [("count", None, "c")]))
    for indexed in (True, False):
        for i in range(2):
            got, stats = _run(factdim["torch"], lambda a, b: plans["torch"][i], indexed)
            want, want_stats = _run(factdim["jax"], lambda a, b: plans["jax"][i], indexed)
            assert stats["join_path"] == want_stats["join_path"]
            _assert_rows_equal(got, want)


def test_join_plans_serialize_as_the_jax_package_does(tpch):
    plans = {name: _j2(entry[2], entry[3]) for name, entry in tpch.items() if name != "root"}
    assert plans["torch"].to_json() == plans["jax"].to_json()
    assert plan_from_json(plans["torch"].to_json()).to_json() == plans["torch"].to_json()

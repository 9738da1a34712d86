"""The port's slice end to end on the CPU, against the JAX package.

A few thousand TPC-H lineitem rows (the port's generator, seed 42) go
through both packages: the `l_orderkey` covering index of `bench.py`
(8 buckets here), twelve point lookups with the index enabled and
disabled, the Q1-shaped grouped aggregate and the per-order revenue
aggregate of the README.

Comparison, after sorting rows: keys, counts, integral sums and extrema
exactly; non-integral sums (and means) within 1e-12 of Σ|v| per group,
because float64 sums taken in another order differ in the last bits.
"""

import numpy as np
import pandas as pd
import pytest

import hyperspace_tpu as hjax
import hyperspace_tpu_torch as htorch
from hyperspace_tpu_torch.datagen import TPCH_SF1_ORDERS_ROWS, gen_tpch_lineitem
from hyperspace_tpu_torch.ops.segment_reduce import segment_reduce

SF = 0.001
INDEXED = ["l_orderkey"]
INCLUDED = ["l_partkey", "l_quantity", "l_extendedprice", "l_discount"]
LOOKUP_COLS = ("l_orderkey", "l_partkey", "l_extendedprice")
Q1_AGGS = [
    ("sum", "l_quantity", "sum_qty"),
    ("sum", "l_extendedprice", "sum_price"),
    ("mean", "l_discount", "avg_disc"),
    ("min", "l_extendedprice", "min_price"),
    ("max", "l_discount", "max_disc"),
    ("count", None, "count_order"),
]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slice")
    gen_tpch_lineitem(tmp / "lineitem", sf=SF, seed=42)
    out = {}
    for name, pkg, kw in (("jax", hjax, {}), ("torch", htorch, {"device": "cpu"})):
        session = pkg.HyperspaceSession(system_path=str(tmp / f"idx_{name}"), num_buckets=8, **kw)
        df = session.parquet(tmp / "lineitem")
        pkg.Hyperspace(session).create_index(
            df, pkg.IndexConfig("lineitem_orderkey", INDEXED, INCLUDED)
        )
        out[name] = (pkg, session, df)
    return out


def _sorted(df: pd.DataFrame, by) -> pd.DataFrame:
    return df.sort_values(list(by)).reset_index(drop=True)


def _lookup_keys():
    rng = np.random.default_rng(7)
    return rng.integers(0, int(TPCH_SF1_ORDERS_ROWS * SF), 12).astype(np.int64)


@pytest.mark.parametrize("indexed", [True, False], ids=["index", "no-index"])
def test_point_lookups_match_the_jax_package(built, indexed):
    results = {}
    for name, (pkg, session, df) in built.items():
        if indexed:
            session.enable_hyperspace()
        else:
            session.disable_hyperspace()
        parts = []
        for k in _lookup_keys():
            q = df.filter(pkg.col("l_orderkey") == int(k)).select(*LOOKUP_COLS)
            parts.append(session.to_pandas(q))
            if name == "torch":
                scan = session.last_optimized_plan.leaves()[0]
                if indexed:
                    # The filter rule fired: a bucket-pruned index scan.
                    assert scan.bucket_spec == (8, INDEXED)
                    assert session.last_query_stats["scan"] == "IndexPointLookup"
                    assert session.last_query_stats["files_pruned"] == 7
                else:
                    assert scan.bucket_spec is None
        results[name] = _sorted(pd.concat(parts, ignore_index=True), LOOKUP_COLS)
    assert len(results["torch"]) > 0
    pd.testing.assert_frame_equal(results["torch"], results["jax"])


def _abs_sum(df, group_by, col):
    return df.assign(_a=df[col].abs()).groupby(group_by)["_a"].sum().to_numpy()


def _check_aggregate(got, want, group_by, exact, sums, means, source):
    got, want = _sorted(got, group_by), _sorted(want, group_by)
    assert len(got) == len(want) > 0
    for c in group_by + exact:
        np.testing.assert_array_equal(got[c].to_numpy(), want[c].to_numpy(), err_msg=c)
    counts = source.groupby(group_by).size().to_numpy()
    for alias, col in sums + means:
        tol = 1e-12 * _abs_sum(source, group_by, col)
        if (alias, col) in means:
            tol = tol / counts
        diff = np.abs(got[alias].to_numpy() - want[alias].to_numpy())
        assert np.all(diff <= tol), alias


def _source(built):
    pkg, session, df = built["jax"]
    return session.to_pandas(df)


@pytest.mark.parametrize("indexed", [True, False], ids=["index", "no-index"])
def test_grouped_aggregates_match_the_jax_package(built, indexed):
    source = _source(built)
    out = {}
    for name, (pkg, session, df) in built.items():
        session.enable_hyperspace() if indexed else session.disable_hyperspace()
        out[name] = (
            session.to_pandas(df.aggregate(["l_returnflag", "l_linestatus"], Q1_AGGS)),
            session.to_pandas(df.aggregate(["l_orderkey"], [("sum", "l_extendedprice", "rev")])),
        )
    _check_aggregate(
        out["torch"][0], out["jax"][0], ["l_returnflag", "l_linestatus"],
        exact=["sum_qty", "min_price", "max_disc", "count_order"],
        sums=[("sum_price", "l_extendedprice")],
        means=[("avg_disc", "l_discount")],
        source=source,
    )
    _check_aggregate(
        out["torch"][1], out["jax"][1], ["l_orderkey"], exact=[],
        sums=[("rev", "l_extendedprice")], means=[], source=source,
    )
    assert built["torch"][1].last_query_stats["agg_path"] == "segment-reduce-cpu"


def test_aggregates_agree_with_numpy(built):
    """An independent check of the port's Q1 shape with pandas."""
    _, session, df = built["torch"]
    source = _source(built)
    got = _sorted(session.to_pandas(df.aggregate(["l_returnflag", "l_linestatus"], Q1_AGGS)),
                  ["l_returnflag", "l_linestatus"])
    g = source.groupby(["l_returnflag", "l_linestatus"])
    np.testing.assert_array_equal(got["sum_qty"], g["l_quantity"].sum().to_numpy())
    np.testing.assert_array_equal(got["count_order"], g.size().to_numpy())
    np.testing.assert_array_equal(got["min_price"], g["l_extendedprice"].min().to_numpy())
    np.testing.assert_allclose(got["sum_price"], g["l_extendedprice"].sum().to_numpy(), rtol=1e-12)


def test_cpu_session_never_launches_the_kernel(built):
    _, session, df = built["torch"]
    before = segment_reduce.launches
    session.run(df.aggregate(["l_orderkey"], [("sum", "l_extendedprice", "rev")]))
    assert segment_reduce.launches == before


def test_session_without_a_card_refuses_the_default_device(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(htorch.HyperspaceError, match="CUDA"):
        htorch.HyperspaceSession(system_path=str(tmp_path))

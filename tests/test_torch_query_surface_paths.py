"""chip_smoke.py's query-surface plans on the CPU, in both packages.

The script's query-surface path holds each query at SF1 to the choices
the JAX package makes (`QUERY_SURFACE_EXPECT`). Here the same plans
(`query_surface_plans`) run at TPC-H sf = 0.005 and TPC-DS sf = 0.01 with
8 buckets through both packages, index on and off: the port must give the
JAX package's rows and make its choices — the last aggregate's branch,
every join's path, the top-N selection, the LIMIT's early-out and the
files pruned. The port's TPC-DS generators must write the JAX package's
benchmarks/tpcds.py files byte for byte.
"""

import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

import hyperspace_tpu as hjax
import hyperspace_tpu_torch as htorch
from hyperspace_tpu_torch import datagen as dg

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from benchmarks import tpcds  # noqa: E402

SF_H, SF_DS = 0.005, 0.01
AGG_OPS = {
    "SegmentReduceAggregate": "segment-reduce", "FusedJoinAggregate": "fused-join-agg",
    "PartialAggPushdown": "PartialAggPushdown", "CountDistinctReaggregate": "CountDistinctReaggregate",
    "DistinctExpandAggregate": "DistinctExpandAggregate", "GroupingSetsReaggregate": "GroupingSetsReaggregate",
    "GroupingSetsDistinct": "GroupingSetsDistinct",
}


def _jax_paths(session) -> dict:
    """The JAX package's choices, from its physical plan: the first
    aggregate node's op (the last to finish), every join's path (its fused
    Aggregate(Join) records its path in the stats only), the TopN and
    LimitEarlyOut details."""
    st = session.last_query_stats
    nodes = list(session.last_physical_plan.walk())
    paths = [n.detail["path"] for n in nodes if "path" in n.detail]
    if st.get("agg_path") == "fused-join-agg":
        paths.append(st["join_path"])
    top = next((n.detail for n in nodes if n.op == "TopN"), None)
    early = next((n.detail for n in nodes if n.op == "LimitEarlyOut"), None)
    return {
        "agg_path": next((AGG_OPS[n.op] for n in nodes if n.op in AGG_OPS), None),
        "join_paths": sorted(paths),
        "top_n": None if top is None else {k: top[k] for k in ("kernel", "candidates") if k in top},
        "limit_early_out": None if early is None else {k: early[k] for k in ("files_scanned", "files_total")},
        "files_pruned": st["files_pruned"],
    }


def _torch_paths(session) -> dict:
    st = session.last_query_stats
    agg, joins, _, early = cs.surface_paths(st)
    return {"agg_path": agg, "join_paths": joins, "top_n": st["top_n"], "limit_early_out": early,
            "files_pruned": st["files_pruned"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("qs_paths")
    dg.gen_tpch_lineitem(tmp / "lineitem", sf=SF_H, seed=42)
    dg.gen_tpch_orders(tmp / "orders", sf=SF_H, seed=43)
    dg.gen_tpch_customer(tmp / "customer", sf=SF_H, seed=45)
    dg.gen_date_dim(tmp / "date_dim")
    dg.gen_item(tmp / "item", SF_DS)
    dg.gen_store(tmp / "store")
    dg.gen_store_sales(tmp / "store_sales", SF_DS)
    out = {}
    for name, pkg, kw in (("jax", hjax, {}), ("torch", htorch, {"device": "cpu"})):
        s = pkg.HyperspaceSession(system_path=str(tmp / f"idx_{name}"), num_buckets=8, **kw)
        t = {k: s.parquet(tmp / k) for k in ("lineitem", "orders", "customer", "store_sales", "date_dim", "item",
                                              "store")}
        hs = pkg.Hyperspace(s)
        hs.create_index(t["lineitem"], pkg.IndexConfig("lineitem_orderkey", cs.INDEXED, cs.INCLUDED))
        hs.create_index(t["orders"], pkg.IndexConfig("orders_orderkey", cs.O_INDEXED, cs.O_INCLUDED))
        hs.create_index(t["customer"], pkg.IndexConfig("customer_custkey", cs.C_INDEXED, cs.C_INCLUDED))
        hs.create_index(t["orders"], pkg.IndexConfig("orders_custkey", cs.OC_INDEXED, cs.OC_INCLUDED))
        hs.create_index(t["store_sales"], pkg.IndexConfig("ss_by_date", *cs.SS_BY_DATE))
        hs.create_index(t["date_dim"], pkg.IndexConfig("dd_by_sk", *cs.DD_BY_SK))
        for mode in ("index", "no_index"):
            s.enable_hyperspace() if mode == "index" else s.disable_hyperspace()
            for q, plan in cs.query_surface_plans(pkg, t).items():
                frame = s.to_pandas(plan)
                out[name, mode, q] = (frame, _jax_paths(s) if name == "jax" else _torch_paths(s))
    out["tmp"] = tmp
    return out


def _same_frames(got: pd.DataFrame, want: pd.DataFrame) -> None:
    assert list(got.columns) == list(want.columns) and len(got) == len(want) > 0
    for c in want.columns:
        a, b = got[c].to_numpy(dtype=object), want[c].to_numpy(dtype=object)
        na = np.array([v is None or (isinstance(v, float) and np.isnan(v)) for v in a])
        nb = np.array([v is None or (isinstance(v, float) and np.isnan(v)) for v in b])
        assert np.array_equal(na, nb), c
        a, b = a[~na], b[~nb]
        if any(isinstance(v, float) for v in b):
            # Float sums of up to a few thousand terms in another order.
            a, b = a.astype(np.float64), b.astype(np.float64)
            assert np.all(np.abs(a - b) <= 1e-9 * np.maximum(np.abs(b), 1.0)), c
        else:
            assert list(a) == list(b), c


@pytest.mark.parametrize("mode", ["index", "no_index"])
@pytest.mark.parametrize("query", sorted(cs.QUERY_SURFACE_EXPECT))
def test_query_surface_plan_takes_the_jax_packages_path(runs, query, mode):
    got, got_paths = runs["torch", mode, query]
    want, want_paths = runs["jax", mode, query]
    assert got_paths == want_paths
    expect = cs.QUERY_SURFACE_EXPECT[query]
    # The branch, the early-out and the index's join paths hold at every
    # scale; the broadcast choices and the top-N turn on row counts.
    assert got_paths["agg_path"] == expect["agg_path"]
    assert got_paths["limit_early_out"] == expect["limit_early_out"]
    if query == "LIM":
        assert len(got) == len(want) == cs.LIMIT_ROWS
        return
    _same_frames(got, want)


def test_the_port_writes_the_jax_packages_tpcds_tables(runs, tmp_path):
    tpcds.gen_date_dim(tmp_path / "date_dim")
    tpcds.gen_item(tmp_path / "item", SF_DS)
    tpcds.gen_store(tmp_path / "store")
    tpcds.gen_store_sales(tmp_path / "store_sales", SF_DS)
    for table in ("date_dim", "item", "store", "store_sales"):
        want = sorted((tmp_path / table).glob("*.parquet"))
        got = sorted((runs["tmp"] / table).glob("*.parquet"))
        assert [p.name for p in got] == [p.name for p in want] and want
        for g, w in zip(got, want):
            assert g.read_bytes() == w.read_bytes(), (table, g.name)

"""chip_smoke.py's join-types queries on the CPU, in both packages.

The script's join-types path holds each query at TPC-H SF1 to the path
the JAX package chooses (`JOIN_TYPE_EXPECT`). The choices turn on row
ratios (a side at most a quarter of the other broadcasts), which TPC-H's
generators keep at every scale, so the same plans at sf = 0.005 must
take the table's paths in both packages, prune the same files and rows,
and give the same rows.
"""

import sys
from pathlib import Path

import pandas as pd
import pytest

import hyperspace_tpu as hjax
import hyperspace_tpu_torch as htorch
from hyperspace_tpu_torch.datagen import gen_tpch_customer, gen_tpch_lineitem, gen_tpch_orders

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

SF = 0.005


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jt_paths")
    gen_tpch_lineitem(tmp / "lineitem", sf=SF, seed=42)
    gen_tpch_orders(tmp / "orders", sf=SF, seed=43)
    gen_tpch_customer(tmp / "customer", sf=SF, seed=45)
    out = {}
    for name, pkg, kw in (("jax", hjax, {}), ("torch", htorch, {"device": "cpu"})):
        s = pkg.HyperspaceSession(system_path=str(tmp / f"idx_{name}"), num_buckets=8, **kw)
        li, o, c = (s.parquet(tmp / t) for t in ("lineitem", "orders", "customer"))
        hs = pkg.Hyperspace(s)
        hs.create_index(li, pkg.IndexConfig("lineitem_orderkey", cs.INDEXED, cs.INCLUDED))
        hs.create_index(o, pkg.IndexConfig("orders_orderkey", cs.O_INDEXED, cs.O_INCLUDED))
        hs.create_index(c, pkg.IndexConfig("customer_custkey", cs.C_INDEXED, cs.C_INCLUDED))
        hs.create_index(o, pkg.IndexConfig("orders_custkey", cs.OC_INDEXED, cs.OC_INCLUDED))
        for mode in ("index", "no_index"):
            s.enable_hyperspace() if mode == "index" else s.disable_hyperspace()
            for q, (plan, rebucketize) in cs.join_type_plans(pkg, li, o, c, SF).items():
                s.conf.set("hyperspace.join.rebucketize", rebucketize)
                df = s.to_pandas(plan)
                s.conf.set("hyperspace.join.rebucketize", "auto")
                st = s.last_query_stats
                out[name, mode, q] = (df, st["join_path"], st["files_pruned"], st["rows_pruned"])
    return out


@pytest.mark.parametrize("mode", ["index", "no_index"])
@pytest.mark.parametrize("query", sorted(cs.JOIN_TYPE_EXPECT))
def test_join_type_query_takes_the_expected_path_in_both_packages(runs, query, mode):
    got, path, files_pruned, rows_pruned = runs["torch", mode, query]
    want, want_path, want_files, want_rows = runs["jax", mode, query]
    expected = cs.JOIN_TYPE_EXPECT[query][0][0 if mode == "index" else 1]
    assert path == want_path == expected
    assert (files_pruned, rows_pruned) == (want_files, want_rows)
    keys = list(want.columns)
    assert list(got.columns) == keys and len(got) == len(want) > 0
    tolerant = {"sum_price", "avg_total"}
    exact = [c for c in keys if c not in tolerant]
    got = got.sort_values(exact).reset_index(drop=True)
    want = want.sort_values(exact).reset_index(drop=True)
    pd.testing.assert_frame_equal(got[exact], want[exact])
    for c in tolerant & set(keys):
        # Positive terms summed in another order: a group of m <= 30,000
        # differs by at most 2(m-1)·2^-53 (below 7e-12) of its sum.
        assert ((got[c] - want[c]).abs() <= 1e-9 * want[c].abs().clip(lower=1.0)).all(), c

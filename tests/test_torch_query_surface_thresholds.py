"""chip_smoke.py's SF1 path expectations, derived from the JAX package.

`QUERY_SURFACE_EXPECT` names, per query of `query_surface_plans`, the
choices the JAX package makes at SF1: the joins' paths, the top-N
selection and the files pruned. Several turn on row counts, so
`test_torch_query_surface_paths.py` (sf 0.005) cannot check them. Here
both packages run every plan at the smallest scale that crosses the same
thresholds as SF1, with the TPC-DS indexes at chip_smoke.py's 64 buckets:

- TPC-H sf 0.25: Q3's second join has a code span (375k order keys)
  past 8x its build side (about 34k joined orders) plus 65,536, so it
  is too sparse for the broadcast table and merges on one partition, as
  at SF1 (from sf 0.16 up);
- TPC-DS sf 0.3: q98's items of three categories are about 1,500 rows,
  past the top-N's max(2n, 1,024), so it takes the partition select, as
  at SF1 (from sf 0.21 up); the 31 days' date keys own 27 of ss_by_date's
  64 buckets at any scale, so dynamic partition pruning skips 37.

Every entry of `QUERY_SURFACE_EXPECT` must be the JAX package's choice
at this scale, and the port must make the same choices.
"""

import sys
from pathlib import Path

import pytest

import hyperspace_tpu as hjax
import hyperspace_tpu_torch as htorch
from hyperspace_tpu_torch import datagen as dg

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from test_torch_query_surface_paths import _jax_paths, _torch_paths  # noqa: E402

SF_H, SF_DS = 0.25, 0.3


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("qs_thresholds")
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
        s.conf.set("hyperspace.index.num.buckets", cs.TPCDS_BUCKETS)
        hs.create_index(t["store_sales"], pkg.IndexConfig("ss_by_date", *cs.SS_BY_DATE))
        hs.create_index(t["date_dim"], pkg.IndexConfig("dd_by_sk", *cs.DD_BY_SK))
        for mode in ("index", "no_index"):
            s.enable_hyperspace() if mode == "index" else s.disable_hyperspace()
            for q, plan in cs.query_surface_plans(pkg, t).items():
                rows = len(s.to_pandas(plan))
                out[name, mode, q] = (rows, _jax_paths(s) if name == "jax" else _torch_paths(s))
    return out


@pytest.mark.parametrize("mode", ["index", "no_index"])
@pytest.mark.parametrize("query", sorted(cs.QUERY_SURFACE_EXPECT))
def test_query_surface_expectations_are_the_jax_packages_choices(paths, query, mode):
    m = 0 if mode == "index" else 1
    expect = cs.QUERY_SURFACE_EXPECT[query]
    rows, jax_paths = paths["jax", mode, query]
    top_n = jax_paths["top_n"]["kernel"] if jax_paths["top_n"] else None
    assert (jax_paths["agg_path"], jax_paths["join_paths"], top_n, jax_paths["limit_early_out"],
            jax_paths["files_pruned"]) == (expect["agg_path"], sorted(expect["join_paths"][m]), expect["top_n"],
                                           expect["limit_early_out"], expect["files_pruned"][m])
    assert paths["torch", mode, query] == (rows, jax_paths)

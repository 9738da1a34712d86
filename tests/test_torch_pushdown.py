"""Predicate pushdown (plan/pushdown.py), the port against the JAX
package: the same plan, built in each package from the same spelling,
rewrites to the same plan (equal `to_json`), and the port's optimized
plan runs the pushed filters on the join sides, where the index rules
cover them."""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hjax
import hyperspace_tpu_torch as htorch
from hyperspace_tpu.plan.pushdown import push_down_filters as jax_push
from hyperspace_tpu_torch.plan.pushdown import push_down_filters as torch_push


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pushdown")
    rng = np.random.default_rng(3)
    f = pd.DataFrame({"k": rng.integers(0, 300, 6_000).astype(np.int64), "a": rng.normal(size=6_000),
                      "s": rng.choice(["p", "q", "r"], 6_000)})
    d = pd.DataFrame({"dk": np.arange(300, dtype=np.int64), "b": rng.normal(size=300),
                      "t": rng.choice(["u", "w"], 300)})
    for name, frame in (("f", f), ("d", d)):
        (tmp / name).mkdir()
        pq.write_table(pa.Table.from_pandas(frame, preserve_index=False), tmp / name / "p.parquet")
    return tmp, f, d


def _plans(pkg, tmp):
    """(name, plan) pairs spelled the same way in `pkg`."""
    col, lit = pkg.col, pkg.lit
    session = pkg.HyperspaceSession(system_path=str(tmp / "unused"), num_buckets=4,
                                    **({"device": "cpu"} if pkg is htorch else {}))
    f, d = session.parquet(tmp / "f"), session.parquet(tmp / "d")
    j = f.join(d, ["k"], ["dk"])
    return {
        "left only": j.filter(col("a") > lit(0.5)),
        "both sides and a residual": j.filter(
            (col("a") > lit(0.0)) & (col("t") == lit("u")) & ((col("a") + col("b")) > lit(1.0))
        ),
        "right only, nested under a project": j.filter(col("b") < lit(0.0)).select("k", "a", "b"),
        "no side-local conjunct": j.filter((col("a") - col("b")) > lit(0.0)),
        "filter over filter": j.filter(col("s") == lit("p")).filter(col("dk") >= lit(100)),
        "inside an aggregate": j.filter((col("a") > lit(0.0)) & (col("b") > lit(0.0))).aggregate(
            ["t"], [("sum", "a", "sa"), ("count", None, "n")]
        ),
        "left join keeps the right filter above": f.join(d, ["k"], ["dk"], how="left").filter(
            (col("a") > lit(0.0)) & (col("b") > lit(0.0))
        ),
        "no join": f.filter(col("a") > lit(0.0)),
    }


@pytest.mark.parametrize(
    "name",
    ["left only", "both sides and a residual", "right only, nested under a project", "no side-local conjunct",
     "filter over filter", "inside an aggregate", "left join keeps the right filter above", "no join"],
)
def test_push_down_filters_rewrites_as_the_jax_package(sources, name):
    tmp, _, _ = sources
    jplan, tplan = _plans(hjax, tmp)[name], _plans(htorch, tmp)[name]
    assert tplan.to_json() == jplan.to_json()
    assert torch_push(tplan).to_json() == jax_push(jplan).to_json()


def test_pushed_filters_reach_the_indexed_join_sides(sources):
    """With both sides indexed on the join key, a filter above the join
    is pushed to the sides in both packages, over the same indexes (built
    by the JAX package): the port's optimized plan equals the JAX
    package's, and the rows equal the pandas reference."""
    tmp, f, d = sources
    out = {}
    for pkg, kw in ((hjax, {}), (htorch, {"device": "cpu"})):
        session = pkg.HyperspaceSession(system_path=str(tmp / "idx"), num_buckets=4, **kw)
        fs, ds = session.parquet(tmp / "f"), session.parquet(tmp / "d")
        if pkg is hjax:
            hs = pkg.Hyperspace(session)
            hs.create_index(fs, pkg.IndexConfig("fk", ["k"], ["a", "s"]))
            hs.create_index(ds, pkg.IndexConfig("dk", ["dk"], ["b", "t"]))
        session.enable_hyperspace()
        q = fs.join(ds, ["k"], ["dk"]).filter((pkg.col("a") > pkg.lit(0.0)) & (pkg.col("t") == pkg.lit("u")))
        opt = session.optimized_plan(q)
        got = session.to_pandas(q).sort_values(["k", "a"]).reset_index(drop=True)
        out[pkg.__name__] = (opt, got, session.last_query_stats)
    (jopt, jgot, _), (topt, tgot, tstats) = out["hyperspace_tpu"], out["hyperspace_tpu_torch"]
    assert tstats["join_path"] == "zero-exchange-aligned"
    assert type(topt).__name__ == "Join"  # no filter left above the join
    m = f.merge(d, left_on="k", right_on="dk")
    m = m[(m.a > 0.0) & (m.t == "u")].sort_values(["k", "a"]).reset_index(drop=True)
    for got in (jgot, tgot):
        assert len(got) == len(m)
        np.testing.assert_array_equal(got["k"].to_numpy(), m["k"].to_numpy())
        np.testing.assert_array_equal(got["a"].to_numpy(), m["a"].to_numpy())  # selected, not computed
    assert topt.to_json() == jopt.to_json()

"""The re-bucketing exchange and bucket-preserved joins on the CPU,
against the JAX package and pandas.

The cases of tests/test_rebucketize.py on the port: one side bucketed on
its join keys pairs with an arbitrary materialized side through an
on-the-fly exchange (host row hash, one stable device sort of the bucket
ids: `rebucketized-aligned`, `exchange_kernel` `device-sort-exchange`),
for every join type the exchange serves; an inner join's bucket-major
output pairs with a later join on the same keys with no exchange
(`bucket-preserved-aligned`); a star chain stays bucket-parallel at every
join; `hyperspace.join.rebucketize = off` keeps one partition; and two
indexes bucketed in different dtype domains fall back to a correct
answer. Paths are held to the JAX package's (its physical plan's `path`
details) and answers to pandas and the JAX package's.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hjax
import hyperspace_tpu_torch as htorch

NB = 8
REBUCKETIZE = "hyperspace.join.rebucketize"


def _write(root, name, df):
    (root / name).mkdir()
    pq.write_table(pa.Table.from_pandas(df, preserve_index=False), root / name / "p.parquet")


def _paths(pkg, session) -> tuple[list[str], list[str]]:
    """(every join's path, every exchange), sorted: the port's stats, or
    the JAX package's physical plan (whose fused Aggregate(Join) records
    its path in the stats only)."""
    stats = session.last_query_stats
    if pkg is htorch:
        return sorted(stats["join_paths"]), sorted(stats["exchanges"])
    nodes = list(session.last_physical_plan.walk())
    paths = [n.detail["path"] for n in nodes if "path" in n.detail]
    if stats.get("agg_path") == "fused-join-agg":
        paths.append(stats["join_path"])
    return sorted(paths), sorted(n.detail["exchange"] for n in nodes if "exchange" in n.detail)


def _run(entry, plan_fn, mode="force"):
    """(frame, stats, (join paths, exchanges)) of one package's run."""
    pkg, s, f, d = entry
    s.conf.set(REBUCKETIZE, mode)
    df = s.to_pandas(plan_fn(pkg, f, d))
    return df, dict(s.last_query_stats), _paths(pkg, s)


def _sorted(df):
    return df.sort_values(list(df.columns)).reset_index(drop=True)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rebucket")
    rng = np.random.default_rng(23)
    n = 12_000
    fact = pd.DataFrame({"k": rng.integers(0, 900, n).astype(np.int64), "v": rng.normal(size=n).round(4)})
    dim = pd.DataFrame({
        "k": np.arange(900, dtype=np.int64),
        "g": (np.arange(900) % 7).astype(np.int64),
        "tag": np.array(["a", "b", "c"], dtype=object)[np.arange(900) % 3],
    })
    _write(tmp, "fact", fact)
    _write(tmp, "dim", dim)
    out = {"fact": fact, "dim": dim}
    for name, pkg, kw in (("torch", htorch, {"device": "cpu"}), ("jax", hjax, {})):
        s = pkg.HyperspaceSession(system_path=str(tmp / f"idx_{name}"), num_buckets=NB, **kw)
        f, d = s.parquet(tmp / "fact"), s.parquet(tmp / "dim")
        pkg.Hyperspace(s).create_index(f, pkg.IndexConfig("f_k", ["k"], ["v"]))
        s.enable_hyperspace()
        out[name] = (pkg, s, f, d)
    return out


def test_rebucketize_one_indexed_side(tables):
    """The dim side is an aggregate (no scan to rewrite): forcing the
    exchange pairs it bucket-parallel against the fact index."""
    def plan(pkg, f, d):
        dim_agg = d.aggregate(["k"], [("sum", "g", "sg")])
        return f.join(dim_agg, ["k"]).aggregate([], [("sum", "v", "sv"), ("count", None, "n"), ("sum", "sg", "ssg")])

    got, stats, paths = _run(tables["torch"], plan)
    want, _, want_paths = _run(tables["jax"], plan)
    assert stats["join_path"] == "rebucketized-aligned"
    assert stats["exchange_kernel"] == "device-sort-exchange"
    assert stats["num_buckets"] == NB
    assert paths == want_paths == (["rebucketized-aligned"], ["rebucketize"])
    fact, dim = tables["fact"], tables["dim"]
    exp = fact.merge(dim.groupby("k").g.sum().rename("sg").reset_index(), on="k")
    assert int(got.loc[0, "n"]) == int(want.loc[0, "n"]) == len(exp)
    assert int(got.loc[0, "ssg"]) == int(exp.sg.sum())
    np.testing.assert_allclose(got.loc[0, "sv"], exp.v.sum(), rtol=1e-9)


@pytest.mark.parametrize("how", ["inner", "left", "right", "full", "semi", "anti"])
def test_rebucketize_join_types_match_the_jax_package(tables, how):
    def plan(pkg, f, d):
        half = d.filter(pkg.col("k") < pkg.lit(450)).aggregate(["k"], [("count", None, "dn")])
        return f.join(half, ["k"], how=how)

    got, stats, paths = _run(tables["torch"], plan)
    want, _, want_paths = _run(tables["jax"], plan)
    assert stats["join_path"] == "rebucketized-aligned"
    assert paths == want_paths
    pd.testing.assert_frame_equal(_sorted(got), _sorted(want))
    fact = tables["fact"]
    matched = int(fact.k.isin(range(450)).sum())
    exp_n = {"inner": matched, "left": len(fact), "right": matched, "full": len(fact),
             "semi": matched, "anti": len(fact) - matched}[how]
    assert len(got) == exp_n


def test_bucket_preserved_chain_same_key(tables):
    """Join(Join(fact, dim1), dim2) on the SAME key: the inner join's
    bucket-major output pairs with the second side with no exchange."""
    def plan(pkg, f, d):
        d1 = d.select("k", "g").aggregate(["k"], [("sum", "g", "sg")])
        d2 = d.select("k", "tag").aggregate(["k"], [("count", None, "c2")])
        return f.join(d1, ["k"]).join(d2, ["k"]).aggregate([], [("count", None, "n"), ("sum", "sg", "ssg")])

    got, stats, paths = _run(tables["torch"], plan)
    want, _, want_paths = _run(tables["jax"], plan)
    # The inner join re-bucketizes d1 into the fact index's layout and
    # stays bucket-grouped; the outer join pairs that grouping with d2,
    # re-bucketized into it: no side of it is read from an index.
    assert paths == want_paths == (["rebucketized-aligned"] * 2, ["preserved+rebucketize", "rebucketize"])
    assert int(got.loc[0, "n"]) == len(tables["fact"])
    pd.testing.assert_frame_equal(got, want)


def test_preserved_grouping_pairs_with_an_index_side(tables):
    """An inner join's bucket-grouped output semi-joined with the fact
    index on the same key: the grouping pairs with the index's buckets
    as it is (`bucket-preserved-aligned`, exchange `preserved`)."""
    def plan(pkg, f, d):
        inner = f.join(d.aggregate(["k"], [("sum", "g", "sg")]), ["k"])
        return inner.join(f.filter(pkg.col("v") > pkg.lit(1.0)).select("k"), ["k"], how="semi")

    got, stats, paths = _run(tables["torch"], plan)
    want, _, want_paths = _run(tables["jax"], plan)
    assert stats["join_path"] == "bucket-preserved-aligned"
    assert stats["join_kernel"] == "device-membership-probe"
    assert paths == want_paths == (["bucket-preserved-aligned", "rebucketized-aligned"], ["preserved", "rebucketize"])
    pd.testing.assert_frame_equal(_sorted(got), _sorted(want))
    fact = tables["fact"]
    assert len(got) == int(fact.k.isin(set(fact.k[fact.v > 1.0])).sum())


def test_star_chain_every_join_bucket_parallel(tmp_path):
    """A 3-table star chain with every dimension indexed: the inner join
    is zero-exchange aligned, the second re-bucketizes the join output
    into the other dimension's layout; no join runs on one partition."""
    rng = np.random.default_rng(41)
    n = 8_000
    fact = pd.DataFrame({"k1": rng.integers(0, 400, n).astype(np.int64),
                         "k2": rng.integers(0, 300, n).astype(np.int64), "v": rng.normal(size=n).round(4)})
    dima = pd.DataFrame({"k1": np.arange(400, dtype=np.int64), "a": np.arange(400) % 5})
    dimb = pd.DataFrame({"k2": np.arange(300, dtype=np.int64), "b": np.arange(300) % 7})
    for name, df in (("fact", fact), ("dima", dima), ("dimb", dimb)):
        _write(tmp_path, name, df)
    res = {}
    for name, pkg, kw in (("torch", htorch, {"device": "cpu"}), ("jax", hjax, {})):
        s = pkg.HyperspaceSession(system_path=str(tmp_path / f"idx_{name}"), num_buckets=NB, **kw)
        f, da, db = (s.parquet(tmp_path / t) for t in ("fact", "dima", "dimb"))
        hs = pkg.Hyperspace(s)
        hs.create_index(f, pkg.IndexConfig("f_k1", ["k1"], ["k2", "v"]))
        hs.create_index(da, pkg.IndexConfig("da_k1", ["k1"], ["a"]))
        hs.create_index(db, pkg.IndexConfig("db_k2", ["k2"], ["b"]))
        s.enable_hyperspace()
        s.conf.set(REBUCKETIZE, "force")
        q = f.join(da.filter(pkg.col("a") == pkg.lit(2)), ["k1"]).join(db, ["k2"]).aggregate(
            ["b"], [("sum", "v", "sv"), ("count", None, "n")])
        df = s.to_pandas(q).sort_values("b").reset_index(drop=True)
        res[name] = (df, _paths(pkg, s))
    got, paths = res["torch"]
    assert paths == res["jax"][1] == (["rebucketized-aligned", "zero-exchange-aligned"], ["rebucketize"])
    j = fact.merge(dima[dima.a == 2], on="k1").merge(dimb, on="k2")
    exp = j.groupby("b").agg(sv=("v", "sum"), n=("v", "size")).reset_index()
    np.testing.assert_array_equal(got.n.to_numpy(), exp.n.to_numpy())
    np.testing.assert_allclose(got.sv.to_numpy(), exp.sv.to_numpy(), rtol=1e-9)
    np.testing.assert_array_equal(got.n.to_numpy(), res["jax"][0].n.to_numpy())


def test_rebucketize_off_keeps_single_partition(tables):
    def plan(pkg, f, d):
        return f.join(d.aggregate(["k"], [("sum", "g", "sg")]), ["k"]).aggregate([], [("count", None, "n")])

    for name in ("torch", "jax"):
        s = tables[name][1]
        s.conf.set("hyperspace.join.broadcast.maxRows", 0)
        try:
            got, stats, _ = _run(tables[name], plan, mode="off")
        finally:
            s.conf.set("hyperspace.join.broadcast.maxRows", 4_000_000)
        assert stats["join_path"] == "single-partition"
        assert int(got.loc[0, "n"]) == len(tables["fact"])


def test_auto_takes_the_broadcast_probe_for_a_small_side(tables):
    """Under `auto`, a side under a quarter of the index's rows is probed
    through the broadcast table instead of re-bucketized, as in the JAX
    package."""
    def plan(pkg, f, d):
        return f.join(d.filter(pkg.col("k") < pkg.lit(100)).aggregate(["k"], [("count", None, "c")]), ["k"])

    got, stats, paths = _run(tables["torch"], plan, mode="auto")
    want, _, want_paths = _run(tables["jax"], plan, mode="auto")
    assert stats["join_path"] == "broadcast-hash"
    assert paths == want_paths
    pd.testing.assert_frame_equal(_sorted(got), _sorted(want))


def test_dtype_mismatched_indexes_fall_back_not_wrong(tmp_path):
    """int32 and int64 bucket columns hash equal values into different
    buckets: the aligned path refuses the pairing and a general join
    gives the right answer, as in the JAX package."""
    rng = np.random.default_rng(5)
    left = pd.DataFrame({"k": rng.integers(0, 300, 3_000).astype(np.int32), "a": rng.normal(size=3_000)})
    right = pd.DataFrame({"k2": np.arange(300, dtype=np.int64), "b": np.arange(300) * 2.0})
    _write(tmp_path, "l", left)
    _write(tmp_path, "r", right)
    out = {}
    for name, pkg, kw in (("torch", htorch, {"device": "cpu"}), ("jax", hjax, {})):
        s = pkg.HyperspaceSession(system_path=str(tmp_path / f"idx_{name}"), num_buckets=4, **kw)
        lt, rt = s.parquet(tmp_path / "l"), s.parquet(tmp_path / "r")
        pkg.Hyperspace(s).create_index(lt, pkg.IndexConfig("l_k", ["k"], ["a"]))
        pkg.Hyperspace(s).create_index(rt, pkg.IndexConfig("r_k", ["k2"], ["b"]))
        s.enable_hyperspace()
        got = s.to_pandas(lt.join(rt, ["k"], ["k2"]).aggregate([], [("count", None, "n"), ("sum", "b", "sb")]))
        out[name] = (got, s.last_query_stats["join_path"])
    assert out["torch"][1] == out["jax"][1] != "zero-exchange-aligned"
    assert int(out["torch"][0].loc[0, "n"]) == len(left)
    assert float(out["torch"][0].loc[0, "sb"]) == float((left.k.astype(np.int64) * 2.0).sum())

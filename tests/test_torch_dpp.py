"""Dynamic partition pruning on the CPU, against the JAX package.

The first five cases of tests/test_dpp_and_column_stats.py on the port:
on the zero-exchange aligned path the filtered side runs first, and its
surviving join keys skip the other side's bucket files (an enumerable key
set or span hashed to its buckets: `files_pruned`) and cut its rows to
the keys' range and set (`rows_pruned`). Each answer equals pandas' and
the JAX package's, and so do `files_pruned` and `rows_pruned`: the port's
one-pass cut over the whole side prunes exactly what the JAX package's
per-bucket slices do.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hjax
import hyperspace_tpu_torch as htorch

NB = 8
PACKAGES = (("torch", htorch, {"device": "cpu"}), ("jax", hjax, {}))


def _write(root, name, df):
    (root / name).mkdir()
    pq.write_table(pa.Table.from_pandas(df, preserve_index=False), root / name / "p.parquet")


@pytest.fixture(scope="module")
def star(tmp_path_factory):
    """A fact bucketed on a date-like contiguous key and a small dimension,
    both indexed with equal bucket counts."""
    tmp = tmp_path_factory.mktemp("dpp")
    rng = np.random.default_rng(17)
    n = 40_000
    fact = pd.DataFrame({
        "dk": rng.integers(0, 2_000, n).astype(np.int64),
        "v": rng.normal(size=n),
        "q": rng.integers(1, 100, n).astype(np.int64),
    })
    dim = pd.DataFrame({"dk": np.arange(2_000, dtype=np.int64), "year": (np.arange(2_000) // 400).astype(np.int64)})
    _write(tmp, "fact", fact)
    _write(tmp, "dim", dim)
    out = {"fact": fact, "dim": dim}
    for name, pkg, kw in PACKAGES:
        s = pkg.HyperspaceSession(system_path=str(tmp / f"idx_{name}"), num_buckets=NB, **kw)
        f, d = s.parquet(tmp / "fact"), s.parquet(tmp / "dim")
        pkg.Hyperspace(s).create_index(f, pkg.IndexConfig("f_dk", ["dk"], ["v", "q"]))
        pkg.Hyperspace(s).create_index(d, pkg.IndexConfig("d_dk", ["dk"], ["year"]))
        s.enable_hyperspace()
        out[name] = (pkg, s, f, d)
    return out


def _both(entries, plan_fn):
    """{package: (frame, stats)} of one plan, run twice on the port (the
    warm run must hit the memoized cut and prune the same)."""
    out = {}
    for name in ("torch", "jax"):
        pkg, s, f, d = entries[name]
        out[name] = (s.to_pandas(plan_fn(pkg, f, d)), dict(s.last_query_stats))
    pkg, s, f, d = entries["torch"]
    warm = s.to_pandas(plan_fn(pkg, f, d))
    pd.testing.assert_frame_equal(warm, out["torch"][0])
    for k in ("files_pruned", "rows_pruned"):
        assert s.last_query_stats[k] == out["torch"][1][k]
    return out


def _same_pruning(res):
    st, want = res["torch"][1], res["jax"][1]
    assert st["join_path"] == want["join_path"] == "zero-exchange-aligned"
    assert (st["files_pruned"], st["rows_pruned"]) == (want["files_pruned"], want["rows_pruned"])
    return st


def test_dpp_prunes_fact_rows_on_aligned_join(star):
    res = _both(star, lambda pkg, f, d: f.join(d.filter(pkg.col("year") == pkg.lit(2)), ["dk"]).aggregate(
        [], [("sum", "q", "sq"), ("count", None, "n")]))
    st = _same_pruning(res)
    # Year 2 spans dk 800..1199: hash bucketing scatters those keys over
    # every bucket file, but within each sorted file they are one run.
    fact, dim = star["fact"], star["dim"]
    j = fact.merge(dim[dim.year == 2], on="dk")
    got = res["torch"][0]
    assert int(got.loc[0, "n"]) == len(j) and int(got.loc[0, "sq"]) == int(j.q.sum())
    assert st["rows_pruned"] == len(fact) - len(j) > 0


def test_dpp_point_filter_prunes_files_and_matches(star):
    res = _both(star, lambda pkg, f, d: f.join(d.filter(pkg.col("dk") == pkg.lit(1_234)), ["dk"]).aggregate(
        [], [("count", None, "n")]))
    st = _same_pruning(res)
    assert int(res["torch"][0].loc[0, "n"]) == int((star["fact"].dk == 1_234).sum())
    assert st["files_pruned"] == NB - 1


def test_dpp_empty_producer_short_circuits(star):
    res = _both(star, lambda pkg, f, d: f.join(d.filter(pkg.col("year") == pkg.lit(99)), ["dk"]).aggregate(
        [], [("count", None, "n")]))
    st = _same_pruning(res)
    assert int(res["torch"][0].loc[0, "n"]) == 0
    assert st["files_pruned"] == NB


def test_dpp_not_applied_to_outer_joins(star):
    """A LEFT join keeps every fact row: pruning the fact side would be
    unsound and must not engage."""
    res = _both(star, lambda pkg, f, d: f.join(d.filter(pkg.col("year") == pkg.lit(2)), ["dk"], how="left").aggregate(
        [], [("count", None, "n")]))
    st = _same_pruning(res)
    assert int(res["torch"][0].loc[0, "n"]) == len(star["fact"])
    assert st["files_pruned"] == st["rows_pruned"] == 0


def test_dpp_disabled_for_nan_float_producer_keys(tmp_path):
    """A float join key with a NaN on the producer side disables DPP (NaN
    bounds would cut every finite row away): the answer stays complete."""
    rng = np.random.default_rng(9)
    fact = pd.DataFrame({"fk": rng.integers(0, 500, 8_000).astype(np.float64), "v": rng.normal(size=8_000)})
    dk = np.arange(500, dtype=np.float64)
    dk[7] = np.nan
    dim = pd.DataFrame({"fk": dk, "w": np.arange(500) * 1.0})
    _write(tmp_path, "fact", fact)
    _write(tmp_path, "dim", dim)
    res = {}
    for name, pkg, kw in PACKAGES:
        s = pkg.HyperspaceSession(system_path=str(tmp_path / f"idx_{name}"), num_buckets=4, **kw)
        f, d = s.parquet(tmp_path / "fact"), s.parquet(tmp_path / "dim")
        pkg.Hyperspace(s).create_index(f, pkg.IndexConfig("fnan", ["fk"], ["v"]))
        pkg.Hyperspace(s).create_index(d, pkg.IndexConfig("dnan", ["fk"], ["w"]))
        s.enable_hyperspace()
        got = s.to_pandas(f.join(d.filter(pkg.col("w") >= pkg.lit(0.0)), ["fk"]).aggregate(
            [], [("count", None, "n")]))
        res[name] = (got, dict(s.last_query_stats))
    st = _same_pruning(res)
    assert st["rows_pruned"] == st["files_pruned"] == 0
    finite = fact.merge(dim[~np.isnan(dim.fk)], on="fk")
    assert int(res["torch"][0].loc[0, "n"]) == int(res["jax"][0].loc[0, "n"]) == len(finite)

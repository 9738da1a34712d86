"""Computed projections (ops/project.py), the port against the JAX package.

The cases of tests/test_project_compute.py run through both packages on
the same seeded parquet: SELECT <expr> AS x with 3-valued nulls, CASE
and boolean projections, SUBSTRING keeping sorted codes, the JSON form,
a projection over an indexed join, with_column with pruning, and an
aggregate over a computed projection. Plus the JAX package's type
promotion, which the port keeps where torch's own differs (numpy's, with
a literal as a 0-d int64 or float64 array: an int64 or float32 column
times a float literal is float64; int / int divides in float64), the
string CASE and a constant string column.

Element-wise results are compared exactly: each package applies the same
IEEE operations in the same dtypes. Sums over groups are held to an rtol
of 1e-9, as the reference test holds its own (groups of about 50 rows
summed in another order differ far less).
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hjax
import hyperspace_tpu_torch as htorch
from hyperspace_tpu.plan.nodes import plan_from_json as jax_from_json
from hyperspace_tpu.plan.prune import prune_columns as jax_prune
from hyperspace_tpu_torch.plan.nodes import plan_from_json as torch_from_json
from hyperspace_tpu_torch.plan.prune import prune_columns as torch_prune

PACKAGES = (("jax", hjax, {}), ("torch", htorch, {"device": "cpu"}))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """test_project_compute.py's table (k int64, a nullable Int64, f
    float64, s a 4-value string) plus i32 int32 and g float32 columns."""
    tmp = tmp_path_factory.mktemp("projdata")
    rng = np.random.default_rng(7)
    n = 2_000
    null_a = rng.random(n) < 0.1
    df = pd.DataFrame({
        "k": rng.integers(0, 40, n).astype(np.int64),
        "a": pd.array(np.where(null_a, 0, rng.integers(1, 90, n)), dtype="Int64"),
        "f": np.round(rng.normal(size=n) * 5, 3),
        "s": np.array(["AIR", "MAIL", "RAIL", "SHIP"], dtype=object)[rng.integers(0, 4, n)],
        "i32": rng.integers(-50, 50, n).astype(np.int32),
        "g": rng.normal(size=n).astype(np.float32),
    })
    df.loc[null_a, "a"] = pd.NA
    root = tmp / "t"
    root.mkdir()
    pq.write_table(pa.Table.from_pandas(df, preserve_index=False), root / "p.parquet")
    out = {}
    for label, pkg, kw in PACKAGES:
        session = pkg.HyperspaceSession(system_path=str(tmp / f"idx_{label}"), num_buckets=4, **kw)
        out[label] = (pkg, session, session.parquet(root))
    out["df"] = df
    return out


def _both(data, make_query, sort_by=None):
    """The query's result in each package as pandas (sorted by `sort_by`
    when given)."""
    out = {}
    for label in ("jax", "torch"):
        pkg, session, ds = data[label]
        got = session.to_pandas(make_query(pkg, ds))
        out[label] = got.sort_values(sort_by).reset_index(drop=True) if sort_by else got
    return out["jax"], out["torch"]


def _assert_frames_equal(j, t):
    assert list(t.columns) == list(j.columns) and len(t) == len(j)
    for c in j.columns:
        jn, tn = j[c].isna().to_numpy(), t[c].isna().to_numpy()
        np.testing.assert_array_equal(tn, jn, err_msg=c)
        np.testing.assert_array_equal(t[c][~tn].to_numpy(), j[c][~jn].to_numpy(), err_msg=c)


def test_arithmetic_projection_nulls(data):
    df = data["df"]
    j, t = _both(
        data, lambda p, ds: ds.select("k", ("x", p.col("a") * p.lit(2) + p.col("k")), ("r", p.col("f") / p.lit(2.0))),
        ["k", "x", "r"],
    )
    _assert_frames_equal(j, t)
    assert t.x.isna().sum() == int(df.a.isna().sum()) > 0
    exp = pd.DataFrame({"k": df.k, "x": df.a * 2 + df.k, "r": df.f / 2.0}).sort_values(["k", "x", "r"])
    np.testing.assert_allclose(t.r.to_numpy(), exp.r.to_numpy())


@pytest.mark.parametrize(
    "name",
    ["int64 times a float literal", "int32 plus an int literal", "int over int", "int64 mod int",
     "float32 times a float literal", "float32 plus float64", "int32 minus int64", "literal minus column"],
)
def test_numeric_promotion_follows_numpy(data, name):
    """The port computes each expression in the dtype the JAX package's
    host evaluation does, bit for bit; the output column is the dtype
    expr_dtype gives it in both."""
    expr = {
        "int64 times a float literal": lambda p: p.col("k") * p.lit(2.5),
        "int32 plus an int literal": lambda p: p.col("i32") + p.lit(7),
        "int over int": lambda p: p.col("k") / p.col("i32"),
        "int64 mod int": lambda p: p.col("k") % p.lit(7),
        "float32 times a float literal": lambda p: p.col("g") * p.lit(0.1),
        "float32 plus float64": lambda p: p.col("g") + p.col("f"),
        "int32 minus int64": lambda p: p.col("i32") - p.col("k"),
        "literal minus column": lambda p: p.lit(100) - p.col("a"),
    }[name]
    j, t = _both(data, lambda p, ds: ds.select(("x", expr(p))))
    assert t.x.dtype == j.x.dtype
    _assert_frames_equal(j, t)


def test_case_and_bool_projection(data):
    df = data["df"]
    j, t = _both(data, lambda p, ds: ds.select(
        ("big", p.col("a") > 40), ("bucket", p.when(p.col("a") > 40, 1).otherwise(0)),
        ("tiered", p.when(p.col("f") > 3.0, p.col("f")).when(p.col("a") < 10, p.col("a") * p.lit(1.5)).otherwise(-1.0)),
    ))
    _assert_frames_equal(j, t)
    known = df.a.notna()
    assert t.big.isna().sum() == int((~known).sum())
    np.testing.assert_array_equal(t.bucket.to_numpy(dtype=np.int64), np.where(df.a.fillna(0) > 40, 1, 0))


def test_substr_projection_keeps_sorted_codes(data):
    df = data["df"]
    j, t = _both(data, lambda p, ds: ds.select(("pfx", p.col("s").substr(1, 2)), "s").filter(p.col("pfx") == "MA"),
                 ["s"])
    _assert_frames_equal(j, t)
    assert set(t.s) == {"MAIL"} and len(t) == int((df.s == "MAIL").sum())
    j, t = _both(data, lambda p, ds: ds.select(("pfx", p.col("s").substr(2, 2))).filter(p.col("pfx") >= "AI"),
                 ["pfx"])
    _assert_frames_equal(j, t)


def test_string_case_and_constant_string(data):
    j, t = _both(data, lambda p, ds: ds.select(
        "k", ("mode", p.when(p.col("k") < 10, p.col("s")).otherwise("OTHER")), ("label", p.lit("chan"))
    ).filter(p.col("mode") <= "OTHER"), ["k", "mode"])
    _assert_frames_equal(j, t)
    assert set(t.label) == {"chan"}


def test_projection_json_roundtrip(data):
    tplan = data["torch"][2].select("k", ("x", (htorch.col("a") + htorch.lit(1)) * htorch.col("k")),
                                    ("c", htorch.when(htorch.col("f") > 0, 1).otherwise(0)),
                                    ("p", htorch.col("s").substr(1, 2)))
    jplan = data["jax"][2].select("k", ("x", (hjax.col("a") + hjax.lit(1)) * hjax.col("k")),
                                  ("c", hjax.when(hjax.col("f") > 0, 1).otherwise(0)),
                                  ("p", hjax.col("s").substr(1, 2)))
    d = tplan.to_json()
    assert d == jplan.to_json()
    assert torch_from_json(d).to_json() == d and jax_from_json(d).to_json() == d
    assert torch_from_json(d).schema.names == jplan.schema.names
    assert [f.dtype for f in torch_from_json(d).schema.fields] == [f.dtype for f in jplan.schema.fields]


def test_projection_over_index_join(data, tmp_path):
    """A computed projection above a join with an indexed side: the
    aligned path does not absorb the expression, the join runs whole, and
    the rows match the JAX package's and pandas'."""
    df = data["df"]
    out = {}
    for label, pkg, kw in PACKAGES:
        session = pkg.HyperspaceSession(system_path=str(tmp_path / "idx"), num_buckets=4, **kw)
        ds = session.parquet(data["torch"][2].root)
        if label == "jax":
            pkg.Hyperspace(session).create_index(ds, pkg.IndexConfig("pj_k", ["k"], ["a"]))
        other = ds.select("k", "f").aggregate(["k"], [("sum", "f", "sf")])
        q = ds.join(other, ["k"]).select("k", ("score", pkg.col("a") + pkg.col("sf")))
        session.enable_hyperspace()
        out[label] = session.to_pandas(q).sort_values(["k", "score"]).reset_index(drop=True)
    j, t = out["jax"], out["torch"]
    merged = df.merge(df.groupby("k").f.sum().rename("sf").reset_index(), on="k")
    assert len(t) == len(j) == len(merged)
    assert t.score.isna().sum() == j.score.isna().sum() == merged.a.isna().sum()
    np.testing.assert_allclose(np.sort(t.score.dropna().to_numpy(dtype=np.float64)),
                               np.sort(j.score.dropna().to_numpy(dtype=np.float64)), rtol=1e-9)


def test_with_column_and_pruning(data):
    df = data["df"]
    j, t = _both(data, lambda p, ds: ds.with_column("half", p.col("f") / p.lit(2.0)).select("half"))
    _assert_frames_equal(j, t)
    np.testing.assert_allclose(np.sort(t.half.to_numpy()), np.sort(df.f.to_numpy() / 2))
    # Pruning: the scan under the projection reads only f, in both.
    tq = data["torch"][2].with_column("half", htorch.col("f") / htorch.lit(2.0)).select("half")
    jq = data["jax"][2].with_column("half", hjax.col("f") / hjax.lit(2.0)).select("half")
    assert torch_prune(tq).to_json() == jax_prune(jq).to_json()
    assert torch_prune(tq).child.child.scan_schema.names == ["f"]


def test_aggregate_over_computed_projection(data):
    df = data["df"]
    j, t = _both(data, lambda p, ds: ds.select("k", ("ab", p.col("a") * p.col("f"))).aggregate(
        ["k"], [("sum", "ab", "s_ab"), ("count", None, "n")]), ["k"])
    np.testing.assert_array_equal(t.k.to_numpy(), j.k.to_numpy())
    np.testing.assert_array_equal(t.n.to_numpy(), j.n.to_numpy())
    np.testing.assert_allclose(t.s_ab.to_numpy(dtype=np.float64), j.s_ab.to_numpy(dtype=np.float64), rtol=1e-9)
    dfx = df.assign(ab=df.a.astype("Float64") * df.f)
    exp = dfx.groupby("k").agg(s_ab=("ab", "sum"), n=("ab", "size")).reset_index()
    np.testing.assert_allclose(t.s_ab.to_numpy(dtype=np.float64), exp.s_ab.to_numpy(dtype=np.float64), rtol=1e-9)

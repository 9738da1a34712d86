"""The aggregation surface of the port against the JAX package (and
pandas): CASE aggregates, count-distinct, GROUPING SETS / ROLLUP / CUBE
with grouping(), and the partial-aggregation pushdown.

Each plan runs through both packages on the same seeded parquet; the port
must give the JAX package's rows and record the branch the JAX package's
physical plan names (`stats["agg_path"]`): `CountDistinctReaggregate` or
`DistinctExpandAggregate`, `GroupingSetsReaggregate` or
`GroupingSetsDistinct`, `PartialAggPushdown` where it engages and the
plain or fused path where it bails. The cases of tests/test_grouping_sets.py
and the group_agg / zero_row_agg classes of tests/test_device_staging.py
run here on the port.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hjax
import hyperspace_tpu_torch as htorch
from hyperspace_tpu_torch.plan.nodes import plan_from_json

N = 4_000
AGG_OPS = {
    "SegmentReduceAggregate": "segment-reduce", "FusedJoinAggregate": "fused-join-agg",
    "PartialAggPushdown": "PartialAggPushdown", "CountDistinctReaggregate": "CountDistinctReaggregate",
    "DistinctExpandAggregate": "DistinctExpandAggregate", "GroupingSetsReaggregate": "GroupingSetsReaggregate",
    "GroupingSetsDistinct": "GroupingSetsDistinct",
}


def _write(root, name, table: pa.Table, parts: int = 1):
    (root / name).mkdir()
    per = (table.num_rows + parts - 1) // parts
    for i in range(parts):
        pq.write_table(table.slice(i * per, per), root / name / f"p{i}.parquet")


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("aggsurf")
    rng = np.random.default_rng(5)
    null_q = rng.random(N) < 0.1
    null_w = rng.random(N) < 0.07
    gs = pa.table({
        "state": pa.array(np.array(["CA", "NY", "TX", "WA"], dtype=object)[rng.integers(0, 4, N)]),
        "cat": pa.array([None if z else v for v, z in zip(
            np.array(["food", "toys", "tools"], dtype=object)[rng.integers(0, 3, N)], rng.random(N) < 0.05)]),
        "q": pa.array([None if z else int(v) for v, z in zip(rng.integers(1, 30, N), null_q)], type=pa.int64()),
        "amt": np.round(rng.normal(size=N) * 50 + 100, 2),
        "w": pa.array([None if z else float(v) for v, z in zip(np.round(rng.random(N) * 10, 1), null_w)]),
    })
    _write(tmp, "gs", gs)
    # A fact/dim pair: the fact keyed on k (200 values, 20 rows each on
    # average), the dim holding one row per key with a tag and a group.
    fact = pa.table({
        "k": rng.integers(0, 200, N).astype(np.int64),
        "v": np.round(rng.normal(size=N) * 10, 3),
        "u": rng.integers(0, N, N).astype(np.int64),  # near-unique: no shrink
    })
    dim = pa.table({
        "dk": np.arange(200, dtype=np.int64),
        "tag": pa.array(np.array(["a", "b", "c", "d"], dtype=object)[np.arange(200) % 4]),
        "grp": (np.arange(200) % 7).astype(np.int64),
    })
    _write(tmp, "fact", fact, parts=4)
    _write(tmp, "dim", dim)
    # The device-staging pair (tests/test_device_staging.py).
    sfact = pa.table({
        "k": rng.integers(0, 200, N).astype(np.int32),
        "q": rng.integers(0, 1000, N).astype(np.float64),
        "n": pa.array([None if i % 7 == 0 else int(i % 97) for i in range(N)], type=pa.int64()),
        "s": pa.array([f"cat_{i % 13:02d}" for i in range(N)]),
    })
    _write(tmp, "sfact", sfact)
    out = {"gs": gs.to_pandas()}
    for name, pkg, kw in (("jax", hjax, {}), ("torch", htorch, {"device": "cpu"})):
        s = pkg.HyperspaceSession(system_path=str(tmp / f"idx_{name}"), num_buckets=4, **kw)
        scans = {t: s.parquet(tmp / t) for t in ("gs", "fact", "dim", "sfact")}
        hs = pkg.Hyperspace(s)
        hs.create_index(scans["fact"], pkg.IndexConfig("f_k", ["k"], ["v", "u"]))
        hs.create_index(scans["dim"], pkg.IndexConfig("d_k", ["dk"], ["tag", "grp"]))
        hs.create_index(scans["sfact"], pkg.IndexConfig("pf_k", ["k"], ["q", "n", "s"]))
        s.enable_hyperspace()
        out[name] = (pkg, s, scans)
    return out


def _agg_path(name: str, session) -> str | None:
    if name == "torch":
        p = session.last_query_stats["agg_path"]
        return "segment-reduce" if p and p.startswith("segment-reduce") else p
    return next((AGG_OPS[n.op] for n in session.last_physical_plan.walk() if n.op in AGG_OPS), None)


def _run(both, build, index: bool = True):
    """{package: (frame, agg path)} of one plan."""
    out = {}
    for name in ("jax", "torch"):
        pkg, s, scans = both[name]
        s.enable_hyperspace() if index else s.disable_hyperspace()
        out[name] = (s.to_pandas(build(pkg, scans)), _agg_path(name, s))
        s.enable_hyperspace()
    return out


def _norm(frame: pd.DataFrame) -> list:
    rows = [tuple(None if pd.isna(v) else (round(float(v), 6) if isinstance(v, float) else v) for v in r)
            for r in frame.itertuples(index=False)]
    return sorted(rows, key=lambda r: tuple((v is None, str(v)) for v in r))


def _same(both, build, path: str | None = None, index: bool = True):
    out = _run(both, build, index)
    (want, wpath), (got, gpath) = out["jax"], out["torch"]
    assert list(got.columns) == list(want.columns)
    assert _norm(got) == _norm(want)
    assert gpath == wpath
    if path is not None:
        assert gpath == path
    return got


# -- CASE aggregates ----------------------------------------------------------


def test_case_aggregates_with_null_conditions_and_legs(both):
    def build(pkg, t):
        c, w = pkg.col, pkg.when
        return t["gs"].aggregate(["state"], [
            pkg.AggSpec.of("sum", w(c("q") > 10, c("amt")).otherwise(0.0), "big_amt"),
            pkg.AggSpec.of("sum", w(c("cat") == "toys", c("w")).otherwise(c("q")), "mixed"),
            pkg.AggSpec.of("mean", w(c("q").is_null(), 1.0).otherwise(c("w")), "m"),
            pkg.AggSpec.of("max", w(c("cat").isin(["food", "tools"]), c("q")).otherwise(-1), "mx"),
            pkg.AggSpec.of("count", w(c("w") > 5.0, c("w")).otherwise(c("q")), "n"),
        ])

    got = _same(both, build, "segment-reduce")
    df = both["gs"]
    exp = df.assign(b=np.where(df.q.fillna(0) > 10, df.amt, 0.0)).groupby("state").b.sum()
    np.testing.assert_allclose(got.set_index("state").big_amt[exp.index], exp, rtol=1e-12)


def test_expression_aggregates(both):
    def build(pkg, t):
        c = pkg.col
        return t["gs"].aggregate(["cat"], [
            pkg.AggSpec.of("sum", c("amt") * (pkg.lit(1.0) - c("w") / 100.0), "net"),
            pkg.AggSpec.of("min", c("q") * 2 + 1, "mn"),
            pkg.AggSpec.of("mean", c("amt") / c("q"), "ratio"),
            ("count", None, "n"),
        ])

    _same(both, build, "segment-reduce")


# -- count-distinct -------------------------------------------------------------


def test_count_distinct_two_phase_with_nulls(both):
    def build(pkg, t):
        return t["gs"].aggregate(["state"], [
            ("count_distinct", "q", "dq"), ("sum", "amt", "s"), ("count", "w", "nw"), ("min", "q", "mn")])

    got = _same(both, build, "CountDistinctReaggregate")
    exp = both["gs"].groupby("state").q.nunique()
    assert got.set_index("state").dq[exp.index].tolist() == exp.tolist()


def test_count_distinct_expansion(both):
    def build(pkg, t):
        return t["gs"].aggregate(["cat"], [
            ("count_distinct", "q", "dq"), ("count_distinct", "state", "ds"), ("mean", "amt", "m")])

    got = _same(both, build, "DistinctExpandAggregate")
    exp = both["gs"].groupby("cat", dropna=False).q.nunique(dropna=True)
    assert sorted(got.dq.tolist()) == sorted(exp.tolist())


@pytest.mark.parametrize("distinct_cols", [["q"], ["q", "state"]])
def test_count_distinct_over_zero_rows(both, distinct_cols):
    def build(pkg, t):
        aggs = [("count_distinct", c, f"d_{c}") for c in distinct_cols] + [("count", None, "n")]
        return t["gs"].filter(pkg.col("amt") > 1e9).aggregate([], aggs)

    _same(both, build)

    def grouped(pkg, t):
        aggs = [("count_distinct", c, f"d_{c}") for c in distinct_cols] + [("sum", "amt", "s")]
        return t["gs"].filter(pkg.col("amt") > 1e9).aggregate(["state"], aggs)

    assert len(_same(both, grouped)) == 0


def test_count_distinct_over_a_join(both):
    def build(pkg, t):
        return t["fact"].join(t["dim"], ["k"], ["dk"]).aggregate(
            ["tag"], [("count_distinct", "u", "du"), ("sum", "v", "sv")])

    for index in (True, False):
        _same(both, build, "CountDistinctReaggregate", index=index)


# -- grouping sets ---------------------------------------------------------------


def test_rollup(both):
    _same(both, lambda pkg, t: t["gs"].rollup(["state", "cat"], [
        ("sum", "amt", "s"), ("count", None, "n"), ("mean", "q", "mq")]), "GroupingSetsReaggregate")


def test_grouping_flags_and_min_max(both):
    got = _same(both, lambda pkg, t: t["gs"].rollup(["state", "cat"], [
        ("min", "amt", "lo"), ("max", "amt", "hi"), ("grouping", "cat", "g_cat"), ("grouping", "state", "g_state"),
    ]), "GroupingSetsReaggregate")
    df = both["gs"]
    assert len(got[(got.g_cat == 1) & (got.g_state == 1)]) == 1
    assert len(got[(got.g_cat == 0) & (got.g_state == 0)]) == df.groupby(["state", "cat"], dropna=False).ngroups


def test_cube(both):
    got = _same(both, lambda pkg, t: t["gs"].cube(["state", "cat"], [
        ("count", None, "n"), ("sum", "q", "sq"), ("grouping", "state", "gs")]), "GroupingSetsReaggregate")
    assert got.n.sum() == 4 * N


def test_explicit_grouping_sets_and_json(both):
    def build(pkg, t):
        return t["gs"].aggregate(["state", "cat"], [("sum", "amt", "s")], grouping_sets=[["state"], ["cat"]])

    _same(both, build, "GroupingSetsReaggregate")
    plan = build(htorch, both["torch"][2])
    d = plan.to_json()
    assert plan_from_json(d).to_json() == d == build(hjax, both["jax"][2]).to_json()


def test_rollup_over_filter(both):
    _same(both, lambda pkg, t: t["gs"].filter(pkg.col("state") == "CA").rollup(["cat"], [("sum", "q", "sq")]),
          "GroupingSetsReaggregate")
    with pytest.raises(ValueError):
        both["torch"][2]["gs"].aggregate(["state"], [("sum", "amt", "s")], grouping_sets=[["cat"]])
    with pytest.raises(ValueError):
        both["torch"][2]["gs"].aggregate(["state"], [("grouping", "state", "g")])


def test_rollup_count_distinct(both):
    _same(both, lambda pkg, t: t["gs"].rollup(["state"], [
        ("count_distinct", "cat", "dcat"), ("count_distinct", "q", "dq"), ("sum", "amt", "s"),
        ("grouping", "state", "g")]), "GroupingSetsDistinct")


def test_grouping_sets_count_distinct_with_null_group(both):
    _same(both, lambda pkg, t: t["gs"].aggregate(
        ["state", "cat"], [("count_distinct", "q", "dq"), ("count", None, "n")],
        grouping_sets=[["state", "cat"], ["cat"], []]), "GroupingSetsDistinct")


def test_rollup_over_a_join_keeps_dictionaries(both):
    def build(pkg, t):
        return t["fact"].join(t["dim"], ["k"], ["dk"]).rollup(["tag", "grp"], [
            ("sum", "v", "sv"), ("count", None, "n"), ("grouping", "grp", "g")])

    for index in (True, False):
        got = _same(both, build, "GroupingSetsReaggregate", index=index)
        assert set(got.tag.dropna()) == {"a", "b", "c", "d"}


# -- partial-aggregation pushdown --------------------------------------------------


def _pivot(pkg, t):
    c = pkg.col
    return t["fact"].join(t["dim"].select("dk", "tag"), ["k"], ["dk"]).aggregate(["tag"], [
        pkg.AggSpec.of("sum", pkg.when(c("tag") == "a", c("v")).otherwise(0.0), "a_v"),
        pkg.AggSpec.of("sum", pkg.when(c("tag") == "b", c("v")).otherwise(0), "b_v"),
        ("count", None, "n"), ("mean", "v", "mv"), ("max", "v", "hi")])


def test_pushdown_engages_on_the_pivot(both):
    # 200 partial rows of 4,000: a 20x shrink.
    for index in (True, False):
        _same(both, _pivot, "PartialAggPushdown", index=index)


def test_pushdown_bails_where_the_left_side_does_not_shrink(both):
    def build(pkg, t):
        c = pkg.col
        return t["fact"].join(t["dim"], ["k"], ["dk"]).aggregate(["u", "tag"], [
            pkg.AggSpec.of("sum", pkg.when(c("tag") == "a", c("v")).otherwise(0.0), "a_v")])

    for index in (True, False):
        out = _run(both, build, index)
        assert out["torch"][1] == out["jax"][1] != "PartialAggPushdown"
        assert _norm(out["torch"][0]) == _norm(out["jax"][0])


def test_pushdown_bail_over_a_deep_left_side_splices_it(both):
    # The left side is itself a join (not a scan): its materialized table
    # is spliced into the plan the bail hands back.
    def build(pkg, t):
        c = pkg.col
        left = t["fact"].join(t["dim"].select("dk", "grp"), ["k"], ["dk"])
        return left.join(t["dim"].select("dk", "tag"), ["k"], ["dk"]).aggregate(["u", "tag"], [
            pkg.AggSpec.of("sum", pkg.when(c("tag") == "a", c("v")).otherwise(0.0), "a_v")])

    for index in (True, False):
        out = _run(both, build, index)
        assert out["torch"][1] == out["jax"][1]
        assert _norm(out["torch"][0]) == _norm(out["jax"][0])


def test_pushdown_partials_are_never_memoized(both):
    # Two runs over the same tables: the per-query partial table must not
    # serve a later query from an identity cache.
    first = _run(both, _pivot)["torch"][0]

    def other(pkg, t):
        c = pkg.col
        return t["fact"].filter(c("v") > 0.0).join(t["dim"].select("dk", "tag"), ["k"], ["dk"]).aggregate(
            ["tag"], [pkg.AggSpec.of("sum", pkg.when(c("tag") == "a", c("v")).otherwise(0.0), "a_v")])

    out = _run(both, other)
    assert _norm(out["torch"][0]) == _norm(out["jax"][0])
    assert _norm(_run(both, _pivot)["torch"][0]) == _norm(first)


# -- the device-staging classes ------------------------------------------------------


@pytest.mark.parametrize("qname", ["group_agg", "zero_row_agg"])
def test_device_staging_aggregate_classes(both, qname):
    def build(pkg, t):
        fs, spec = t["sfact"], pkg.AggSpec.of
        if qname == "group_agg":
            return fs.aggregate(["s"], [spec("sum", "q", "sq"), spec("count", None, "cnt"), spec("min", "q", "mn"),
                                        spec("max", "n", "mx")])
        return fs.filter(pkg.col("q") > 1e9).aggregate(["s"], [spec("sum", "q", "sq")])

    got = _same(both, build, "segment-reduce")
    if qname == "zero_row_agg":
        assert len(got) == 0


def test_a_computed_projection_under_an_aggregate_over_a_join(both):
    """with_column replacing a join column, then an aggregate over it: the
    port fuses Aggregate(Join) only through passthrough projections, so it
    sums the projected values (the SQL answer). The JAX package's fused
    path skips any projection and sums the column as the join gives it
    (ROADMAP queue 3)."""
    def build(pkg, t):
        j = t["fact"].join(t["dim"].select("dk", "tag"), ["k"], ["dk"])
        return j.with_column("v", pkg.col("v") * pkg.lit(2.0)).aggregate(["tag"], [("sum", "v", "sv")])

    out = _run(both, build)
    got, want = out["torch"][0].sort_values("tag"), out["jax"][0].sort_values("tag")
    fact = pq.read_table(both["torch"][2]["fact"].root).to_pandas()
    dim = pq.read_table(both["torch"][2]["dim"].root).to_pandas()
    sql = fact.merge(dim, left_on="k", right_on="dk").assign(v=lambda f: f.v * 2.0).groupby("tag").v.sum()
    np.testing.assert_allclose(got.sv.to_numpy(), sql[got.tag].to_numpy(), rtol=1e-12)
    assert out["jax"][1] == "fused-join-agg" and out["torch"][1] == "segment-reduce"
    np.testing.assert_allclose(want.sv.to_numpy(), sql[want.tag].to_numpy() / 2.0, rtol=1e-12)

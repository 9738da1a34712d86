"""The port's plan validator against the JAX package's.

The cases of tests/test_analysis.py's `TestValidatorMalformedPlans`,
`TestValidatorMoreRules` and `TestExecutorIntegration`, each run through
both packages (`pkg` is "jax" or "torch") with the same assertions, then
compared: both packages give the same diagnostics (rule, node, path,
severity), exactly. Then the port's own cases:

- the malformed queries of ROADMAP.md queue 3 item 1 on small tables,
  through `session.run` in both packages: each raises
  `PlanValidationError` with the JAX package's code and path, and the
  int-with-string join returns no rows;
- the deliberate difference: a column-pruned index scan whose bucket
  column was pruned away is served by the port (equal to the source scan)
  and refused by the JAX package (`PlanRewriteError`);
- every plan of chip_smoke.py's `query_surface_plans` and
  `join_type_plans` at TPC-H sf 0.005 / TPC-DS sf 0.01 validates clean in
  both packages, index on and off (the rewritten plan too).
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hjax
import hyperspace_tpu_torch as htorch
from hyperspace_tpu import analysis as jax_analysis
from hyperspace_tpu import exceptions as jax_exc
from hyperspace_tpu.config import HyperspaceConf as JaxConf
from hyperspace_tpu.execution.executor import Executor as JaxExecutor
from hyperspace_tpu.plan import expr as jax_expr
from hyperspace_tpu.plan import nodes as jax_nodes
from hyperspace_tpu.plan.prune import prune_columns as jax_prune
from hyperspace_tpu.plan.pushdown import push_down_filters as jax_push
from hyperspace_tpu_torch import analysis as torch_analysis
from hyperspace_tpu_torch import datagen as dg
from hyperspace_tpu_torch import exceptions as torch_exc
from hyperspace_tpu_torch.config import HyperspaceConf as TorchConf
from hyperspace_tpu_torch.execution.executor import Executor as TorchExecutor
from hyperspace_tpu_torch.plan import expr as torch_expr
from hyperspace_tpu_torch.plan import nodes as torch_nodes
from hyperspace_tpu_torch.plan.prune import prune_columns as torch_prune
from hyperspace_tpu_torch.plan.pushdown import push_down_filters as torch_push

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


class _Pkg:
    """One package's validator surface under the names the cases use."""

    def __init__(self, name):
        self.name = name
        jax = name == "jax"
        self.pkg = hjax if jax else htorch
        self.v = jax_analysis if jax else torch_analysis
        self.exc = jax_exc if jax else torch_exc
        self.x = jax_expr if jax else torch_expr
        self.n = jax_nodes if jax else torch_nodes
        self.prune = jax_prune if jax else torch_prune
        self.push = jax_push if jax else torch_push
        self.Conf = JaxConf if jax else TorchConf
        self.session_kw = {} if jax else {"device": "cpu"}

    def executor(self, conf=None):
        if self.name == "jax":
            return JaxExecutor(conf=conf)
        return TorchExecutor("cpu", conf)

    def schema(self):
        F, S = self.pkg.Field, self.pkg.Schema
        return S.of(F("k", "int32"), F("v", "float64"), F("s", "string"), F("d", "date"),
                    F("emb", "vector", dim=4))

    def scan(self, schema=None, **kw):
        return self.n.Scan("/data/t", "parquet", schema or self.schema(), **kw)

    def uscan(self, *fields, **kw):
        F, S = self.pkg.Field, self.pkg.Schema
        return self.n.Scan("/data/u", "parquet", S.of(*[F(*f[:2], **(f[2] if len(f) > 2 else {}))
                                                        for f in fields]), **kw)

    def diags(self, plan):
        return [(d.rule, d.node, d.path, d.severity) for d in self.v.validate_plan(plan)]


PKG_NAMES = ("jax", "torch")
PKGS = {name: _Pkg(name) for name in PKG_NAMES}


# -- the cases of tests/test_analysis.py ------------------------------------
#
# Each case takes a _Pkg, makes the reference's assertions in it, and
# returns what the two packages must agree on.


def case_clean_plan_validates(P):
    c = P.x.col
    plan = P.n.Filter(P.scan(), (c("k") > 5) & (c("v") <= 2.5)).select("k", "v")
    assert P.v.validate_plan(plan) == []
    P.v.check_plan(plan)
    return P.diags(plan)


def case_mismatched_join_bucket_specs(P):
    left = P.scan(bucket_spec=(8, ["k"]))
    right = P.uscan(("k", "int32"), ("w", "float32"), bucket_spec=(16, ["k"]))
    plan = P.n.Join(left, right, ["k"], ["k"])
    diags = P.v.validate_plan(plan)
    assert [d.rule for d in diags] == ["join-bucket-mismatch"]
    assert diags[0].node == "Join"
    assert "8" in diags[0].message and "16" in diags[0].message
    P.v.check_plan(plan)
    with pytest.raises(P.exc.PlanValidationError) as ei:
        P.v.check_plan(plan, fail_on="warning")
    assert "join-bucket-mismatch" in str(ei.value)
    return P.diags(plan)


def case_mismatched_bucket_hash_domains(P):
    left = P.scan(bucket_spec=(8, ["k"]))
    right = P.uscan(("k", "int64"), ("w", "float32"), bucket_spec=(8, ["k"]))
    diags = P.v.validate_plan(P.n.Join(left, right, ["k"], ["k"]))
    assert [d.rule for d in diags] == ["join-bucket-mismatch"]
    assert "dtype domain" in diags[0].message
    return [(d.rule, d.path, d.message) for d in diags]


def case_unresolved_column(P):
    plan = P.n.Filter(P.scan(), P.x.col("missing") > 5)
    diags = P.v.validate_plan(plan)
    assert [d.rule for d in diags] == ["unresolved-column"]
    assert diags[0].node == "Filter"
    assert "'missing'" in diags[0].message
    with pytest.raises(P.exc.PlanValidationError):
        P.v.check_plan(plan)
    return P.diags(plan)


def case_unresolved_join_key(P):
    plan = P.n.Join(P.scan(), P.uscan(("k", "int32")), ["k"], ["nope"])
    diags = P.v.validate_plan(plan)
    assert [d.rule for d in diags] == ["unresolved-column"]
    assert diags[0].node == "Join"
    return P.diags(plan)


def case_dtype_incompatible_predicate(P):
    diags = P.v.validate_plan(P.n.Filter(P.scan(), P.x.col("s") > 5))
    assert [d.rule for d in diags] == ["dtype-incompatible-predicate"]
    assert "string" in diags[0].message
    return [(d.rule, d.path, d.message) for d in diags]


def case_non_boolean_predicate(P):
    diags = P.v.validate_plan(P.n.Filter(P.scan(), P.x.col("k") + 1))
    assert [d.rule for d in diags] == ["dtype-incompatible-predicate"]
    assert "expected bool" in diags[0].message
    return [(d.rule, d.path, d.message) for d in diags]


def case_string_arithmetic(P):
    diags = P.v.validate_plan(P.n.Project(P.scan(), [("x", P.x.col("s") * 2)]))
    assert [d.rule for d in diags] == ["dtype-incompatible-predicate"]
    assert "arithmetic" in diags[0].message
    return [(d.rule, d.path, d.message) for d in diags]


def case_bad_sort_key(P):
    plan = P.n.Sort(P.scan(), [("emb", True)])
    diags = P.v.validate_plan(plan)
    assert [d.rule for d in diags] == ["unsortable-key"]
    assert diags[0].node == "Sort"
    with pytest.raises(P.exc.PlanValidationError):
        P.v.check_plan(plan)
    return P.diags(plan)


def case_illegal_pushdown(P):
    right = P.uscan(("k", "int32"), ("w", "float32"))
    pred = P.x.col("w") > 1.0
    original = P.n.Filter(P.n.Join(P.scan(), right, ["k"], ["k"], how="left"), pred)
    bad_rewrite = P.n.Join(P.scan(), P.n.Filter(right, pred), ["k"], ["k"], how="left")
    with pytest.raises(P.exc.PlanRewriteError) as ei:
        P.v.validate_rewrite(original, bad_rewrite)
    d = ei.value.diagnostics[0]
    assert d.rule == "illegal-pushdown"
    assert "right" in d.path
    return [(x.rule, x.path) for x in ei.value.diagnostics]


def case_illegal_prune(P):
    F, S = P.pkg.Field, P.pkg.Schema
    base = P.scan(S.of(F("k", "int32"), F("v", "float64")))
    original = P.n.Filter(base, P.x.col("v") > 1.0).select("k", "v")
    pruned = dataclasses.replace(base, scan_schema=base.scan_schema.select(["k"]))
    bad_rewrite = P.n.Filter(pruned, P.x.col("v") > 1.0).select("k")
    with pytest.raises(P.exc.PlanRewriteError) as ei:
        P.v.validate_rewrite(original, bad_rewrite)
    assert any(d.rule == "unresolved-column" for d in ei.value.diagnostics)
    return [(x.rule, x.path) for x in ei.value.diagnostics]


def case_rewrite_schema_change(P):
    with pytest.raises(P.exc.PlanRewriteError) as ei:
        P.v.validate_rewrite(P.scan().select("k", "v"), P.scan().select("k"))
    assert ei.value.diagnostics[0].rule == "rewrite-schema-change"
    return [(x.rule, x.path, x.message) for x in ei.value.diagnostics]


def case_legal_rewrite_passes(P):
    c = P.x.col
    right = P.uscan(("k", "int32"), ("w", "float32"))
    plan = P.n.Filter(P.n.Join(P.scan(), right, ["k"], ["k"]), (c("v") > 0.5) & (c("w") > 1.0)).select("k", "v", "w")
    P.v.validate_rewrite(plan, P.prune(P.push(plan)))
    return P.diags(P.prune(P.push(plan)))


def case_bad_bucket_spec_count(P):
    diags = P.v.validate_plan(P.scan(bucket_spec=(0, ["k"])))
    assert [d.rule for d in diags] == ["bad-bucket-spec"]
    return P.diags(P.scan(bucket_spec=(0, ["k"])))


def case_bucket_column_missing(P):
    diags = P.v.validate_plan(P.scan(bucket_spec=(8, ["zz"])))
    assert [d.rule for d in diags] == ["unresolved-column"]
    assert diags[0].node == "Scan"
    return P.diags(P.scan(bucket_spec=(8, ["zz"])))


def case_join_key_domain_mismatch(P):
    plan = P.n.Join(P.scan(), P.uscan(("name", "string")), ["k"], ["name"])
    assert [d.rule for d in P.v.validate_plan(plan)] == ["join-key-type-mismatch"]
    return P.diags(plan)


def case_outer_join_vector_null_extension_warns(P):
    right = P.uscan(("k", "int32"), ("e2", "vector", {"dim": 8}))
    diags = P.v.validate_plan(P.n.Join(P.scan(), right, ["k"], ["k"], how="left"))
    assert [(d.rule, d.severity) for d in diags] == [("null-extension-vector", "warning")]
    return P.diags(P.n.Join(P.scan(), right, ["k"], ["k"], how="left"))


def case_aggregate_sum_over_string(P):
    plan = P.n.Aggregate(P.scan(), ["k"], [P.n.AggSpec.of("sum", "s", "bad")])
    assert [d.rule for d in P.v.validate_plan(plan)] == ["dtype-incompatible-aggregate"]
    return P.diags(plan)


def case_aggregate_unresolved_group_by(P):
    plan = P.n.Aggregate(P.scan(), ["zz"], [P.n.AggSpec.of("count", None, "n")])
    assert "unresolved-column" in [d.rule for d in P.v.validate_plan(plan)]
    return P.diags(plan)


def case_window_order_by_vector(P):
    plan = P.n.Window(P.scan(), ["k"], [("emb", True)], [P.n.WindowSpec.of("row_number", None, "rn")], "partition")
    assert "unsortable-key" in [d.rule for d in P.v.validate_plan(plan)]
    return P.diags(plan)


def case_in_list_domain_mismatch(P):
    c = P.x.col
    a = P.v.validate_plan(P.n.Filter(P.scan(), c("k").isin(["a", "b"])))
    assert [d.rule for d in a] == ["dtype-incompatible-predicate"]
    b = P.v.validate_plan(P.n.Filter(P.scan(), c("s").isin([1, 2])))
    assert [d.rule for d in b] == ["dtype-incompatible-predicate"]
    return [(d.rule, d.path, d.message) for d in a + b]


def case_like_over_non_string(P):
    diags = P.v.validate_plan(P.n.Filter(P.scan(), P.x.col("k").like("a%")))
    assert [d.rule for d in diags] == ["dtype-incompatible-predicate"]
    return [(d.rule, d.path, d.message) for d in diags]


def case_datepart_over_non_date(P):
    diags = P.v.validate_plan(P.n.Filter(P.scan(), P.x.year(P.x.col("k")) == 1998))
    assert [d.rule for d in diags] == ["dtype-incompatible-predicate"]
    return [(d.rule, d.path, d.message) for d in diags]


def case_diagnostics_carry_provenance_path(P):
    right = P.uscan(("k", "int32"), ("w", "float32"))
    plan = P.n.Join(P.scan(), P.n.Filter(right, P.x.col("nope") > 1), ["k"], ["k"])
    diags = P.v.validate_plan(plan)
    assert len(diags) == 1
    assert diags[0].path == "Join/right:Filter"
    return P.diags(plan)


def case_all_diagnostics_reported_at_once(P):
    plan = P.n.Filter(P.n.Sort(P.scan(), [("emb", True)]), P.x.col("missing").isin([1]))
    assert set(d.rule for d in P.v.validate_plan(plan)) == {"unresolved-column", "unsortable-key"}
    return P.diags(plan)


def case_diagnostic_str_format(P):
    d = P.exc.PlanDiagnostic("unresolved-column", "Filter", "Join/left:Filter", "msg")
    assert "[unresolved-column]" in str(d)
    assert "Join/left:Filter" in str(d)
    return str(d)


CASES = {name[len("case_"):]: fn for name, fn in dict(globals()).items() if name.startswith("case_")}


@pytest.mark.parametrize("pkg", PKG_NAMES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_validator_case(case, pkg):
    CASES[case](PKGS[pkg])


@pytest.mark.parametrize("case", sorted(CASES))
def test_validator_case_gives_the_jax_packages_diagnostics(case):
    assert CASES[case](PKGS["torch"]) == CASES[case](PKGS["jax"])


# -- TestExecutorIntegration --------------------------------------------------


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_execute_rejects_unresolved_column(tmp_path, pkg):
    P = PKGS[pkg]
    root = tmp_path / "t"
    root.mkdir()
    pq.write_table(pa.table({"k": pa.array(np.arange(4, dtype=np.int32))}), root / "part-0.parquet")
    F, S = P.pkg.Field, P.pkg.Schema
    plan = P.n.Filter(P.n.Scan(str(root), "parquet", S.of(F("k", "int32"))), P.x.col("missing") > 1)
    with pytest.raises(P.exc.PlanValidationError) as ei:
        P.executor().execute(plan)
    assert ei.value.diagnostics[0].rule == "unresolved-column"
    assert ei.value.diagnostics[0].path == "Filter"


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_validation_can_be_disabled(pkg):
    P = PKGS[pkg]
    conf = P.Conf()
    conf.set("hyperspace.analysis.validate", "false")
    assert conf.validate_plans is False
    assert conf.get("hyperspace.analysis.validate") == "false"
    plan = P.n.Filter(P.scan(), P.x.col("missing") > 1)
    try:
        P.executor(conf).execute(plan)
    except P.exc.PlanValidationError:  # pragma: no cover - the regression
        pytest.fail("validator ran despite hyperspace.analysis.validate=false")
    except Exception:
        pass  # any later failure is fine; only the bypass matters


def test_validation_is_on_by_default():
    assert TorchConf().validate_plans is True and TorchConf().get("hyperspace.analysis.validate") is True


# -- ROADMAP queue 3 item 1, through session.run ------------------------------


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """f (k int64, v, s string; 20 rows) and u (s string, w; 16 rows),
    both packages' sessions on them, index off."""
    tmp = tmp_path_factory.mktemp("q3")
    rng = np.random.default_rng(5)
    (tmp / "f").mkdir()
    (tmp / "u").mkdir()
    pq.write_table(pa.table({"k": np.arange(20, dtype=np.int64), "v": rng.random(20),
                             "s": [str(i) for i in range(20)]}), tmp / "f" / "a.parquet")
    pq.write_table(pa.table({"s": [str(i) for i in range(16)], "w": rng.random(16)}), tmp / "u" / "a.parquet")
    out = {}
    for name in PKG_NAMES:
        P = PKGS[name]
        s = P.pkg.HyperspaceSession(system_path=str(tmp / f"sys_{name}"), **P.session_kw)
        out[name] = (P, s, s.parquet(tmp / "f"), s.parquet(tmp / "u"))
    return out


QUEUE3 = {
    # name: (plan builder, the JAX package's code, its node path)
    "int-with-string join": (lambda P, f, u: f.join(u, ["k"], ["s"]), "join-key-type-mismatch", "Join"),
    "missing column in a filter": (lambda P, f, u: f.filter(P.x.col("zz") > 1), "unresolved-column", "Filter"),
    "missing column in an aggregate": (lambda P, f, u: f.aggregate(["zz"], [("sum", "v", "t")]),
                                       "unresolved-column", "Aggregate"),
    "missing column in an aggregate's input": (lambda P, f, u: f.aggregate(["k"], [("sum", "zz", "t")]),
                                               "unresolved-column", "Aggregate"),
    "missing column in a sort": (lambda P, f, u: f.sort(["zz"]), "unresolved-column", "Sort"),
    "missing join key": (lambda P, f, u: f.join(u, ["zz"], ["s"]), "unresolved-column", "Join"),
    "limit(-1)": (lambda P, f, u: f.limit(-1), "bad-limit", "Limit"),
    "sum over a string": (lambda P, f, u: f.aggregate(["k"], [("sum", "s", "t")]),
                          "dtype-incompatible-aggregate", "Aggregate"),
    "string compared with an int": (lambda P, f, u: f.filter(P.x.col("s") > 5), "dtype-incompatible-predicate",
                                    "Filter"),
    "int/string CASE": (lambda P, f, u: f.with_column("c", P.x.when(P.x.col("k") > 3, 1).otherwise("x")),
                        "dtype-incompatible-predicate", "Project"),
}


@pytest.mark.parametrize("index", [False, True])
@pytest.mark.parametrize("case", sorted(QUEUE3))
def test_malformed_query_raises_the_jax_packages_code(small, case, index):
    build, code, path = QUEUE3[case]
    got = {}
    for name in PKG_NAMES:
        P, s, f, u = small[name]
        s.enable_hyperspace() if index else s.disable_hyperspace()
        with pytest.raises(P.exc.PlanValidationError) as ei:
            s.run(build(P, f, u))
        got[name] = [(d.rule, d.node, d.path, d.severity) for d in ei.value.diagnostics]
        assert (got[name][0][0], got[name][0][2]) == (code, path), (name, got[name])
    assert got["torch"] == got["jax"]


def test_int_with_string_join_returns_no_rows(small):
    """Validation on (the default), the port returns no rows for the
    int-with-string join: the plan is refused before execution. With
    validation off, both packages pair each integer with its decimal text
    alike (16 rows): the executor is the JAX package's there too."""
    for index in (False, True):
        for name in PKG_NAMES:
            P, s, f, u = small[name]
            s.enable_hyperspace() if index else s.disable_hyperspace()
            with pytest.raises(P.exc.PlanValidationError):
                s.run(f.join(u, ["k"], ["s"]))
    rows = {}
    for name in PKG_NAMES:
        P, s, f, u = small[name]
        s.disable_hyperspace()
        s.conf.set("hyperspace.analysis.validate", False)
        try:
            d = s.run(f.join(u, ["k"], ["s"])).decode()
        finally:
            s.conf.set("hyperspace.analysis.validate", True)
        rows[name] = sorted(zip(np.asarray(d["k"]).tolist(), [str(x) for x in np.asarray(d["w"]).tolist()]))
    assert rows["torch"] == rows["jax"] and len(rows["torch"]) == 16


# -- the deliberate difference: a pruned index scan ---------------------------


def test_pruned_index_scan_served_by_the_port_refused_by_the_jax_package(tmp_path):
    rng = np.random.default_rng(3)
    n = 400
    (tmp_path / "src").mkdir()
    pq.write_table(pa.table({"k": rng.integers(0, 40, n).astype(np.int64),
                             "s": [f"s{i % 7}" for i in range(n)], "v": rng.random(n)}),
                   tmp_path / "src" / "a.parquet")
    rows = {}
    for name in PKG_NAMES:
        P = PKGS[name]
        s = P.pkg.HyperspaceSession(system_path=str(tmp_path / f"sys_{name}"), num_buckets=4, **P.session_kw)
        df = s.parquet(tmp_path / "src")
        P.pkg.Hyperspace(s).create_index(df, P.pkg.IndexConfig("ks", ["k", "s"], ["v"]))
        q = df.filter(P.x.col("k").isin([1, 2])).select("k", "v")
        raw = s.run(q).decode()
        s.enable_hyperspace()
        if name == "jax":
            with pytest.raises(P.exc.PlanRewriteError, match="bucket column 's' does not exist"):
                s.run(q)
            continue
        got = s.run(q).decode()
        assert s.last_query_stats["scan"] == "IndexRangeScan"
        key = lambda d: sorted(zip(np.asarray(d["k"]).tolist(), np.asarray(d["v"]).tolist()))
        assert key(got) == key(raw) and len(key(got)) > 0
        rows[name] = key(got)
    assert rows["torch"]


def test_pruned_scan_without_a_pinned_file_list_still_fails():
    P = PKGS["torch"]
    F, S = P.pkg.Field, P.pkg.Schema
    scan = P.n.Scan("/data/t", "parquet", S.of(F("k", "int32")), bucket_spec=(8, ["k", "s"]))
    assert [d.rule for d in P.v.validate_plan(scan)] == ["unresolved-column"]
    pinned = dataclasses.replace(scan, files=["/data/t/bucket-00000.parquet"])
    assert P.v.validate_plan(pinned) == []


# -- the query-surface and join-types plans validate clean ---------------------

SF_H, SF_DS = 0.005, 0.01


@pytest.fixture(scope="module")
def surface_plans(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("validator_surface")
    dg.gen_tpch_lineitem(tmp / "lineitem", sf=SF_H, seed=42)
    dg.gen_tpch_orders(tmp / "orders", sf=SF_H, seed=43)
    dg.gen_tpch_customer(tmp / "customer", sf=SF_H, seed=45)
    dg.gen_date_dim(tmp / "date_dim")
    dg.gen_item(tmp / "item", SF_DS)
    dg.gen_store(tmp / "store")
    dg.gen_store_sales(tmp / "store_sales", SF_DS)
    out = {}
    for name in PKG_NAMES:
        P = PKGS[name]
        s = P.pkg.HyperspaceSession(system_path=str(tmp / f"idx_{name}"), num_buckets=8, **P.session_kw)
        t = {k: s.parquet(tmp / k) for k in ("lineitem", "orders", "customer", "store_sales", "date_dim", "item",
                                              "store")}
        hs = P.pkg.Hyperspace(s)
        hs.create_index(t["lineitem"], P.pkg.IndexConfig("lineitem_orderkey", cs.INDEXED, cs.INCLUDED))
        hs.create_index(t["orders"], P.pkg.IndexConfig("orders_orderkey", cs.O_INDEXED, cs.O_INCLUDED))
        hs.create_index(t["customer"], P.pkg.IndexConfig("customer_custkey", cs.C_INDEXED, cs.C_INCLUDED))
        hs.create_index(t["orders"], P.pkg.IndexConfig("orders_custkey", cs.OC_INDEXED, cs.OC_INCLUDED))
        hs.create_index(t["store_sales"], P.pkg.IndexConfig("ss_by_date", *cs.SS_BY_DATE))
        hs.create_index(t["date_dim"], P.pkg.IndexConfig("dd_by_sk", *cs.DD_BY_SK))
        plans = dict(cs.query_surface_plans(P.pkg, t))
        for q, (p, _) in cs.join_type_plans(P.pkg, t["lineitem"], t["orders"], t["customer"], SF_H).items():
            plans["JT_" + q] = p
        s.enable_hyperspace()
        out[name] = {q: (p, s.optimized_plan(p)) for q, p in plans.items()}
    return out


SURFACE = sorted(cs.QUERY_SURFACE_EXPECT) + sorted("JT_" + q for q in cs.JOIN_TYPE_EXPECT)


@pytest.mark.parametrize("query", SURFACE)
def test_surface_plan_validates_clean_in_both_packages(surface_plans, query):
    for name in PKG_NAMES:
        P = PKGS[name]
        plan, optimized = surface_plans[name][query]
        for p in (plan, optimized):
            assert [d for d in P.v.validate_plan(p) if d.severity == "error"] == [], (name, query)
            P.v.check_plan(p)
            P.v.validate_rewrite(p, P.prune(P.push(p)))
        assert PKGS["torch"].diags(surface_plans["torch"][query][1]) == PKGS["jax"].diags(
            surface_plans["jax"][query][1]), query

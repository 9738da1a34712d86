"""The port's executed physical plan and explain against the JAX package's.

The cases of tests/test_physical_explain.py and tests/test_explain.py,
run through both packages on the same data (CPU, small):

- the physical plan's label trees (`PhysicalNode.label()`: op, details,
  rows) equal the JAX package's for a point lookup, a range scan, a join,
  a query without the index and a hybrid-scan filter, and for every plan
  of chip_smoke.py's query-surface and join-types phases (each aggregate
  branch, every join path, TopN, Sort, LimitEarlyOut) index on and off at
  TPC-H sf = 0.005 / TPC-DS sf = 0.01. Detail values that name a kernel,
  a venue or a mesh (`kernel`, `venue`, `mesh`) are the port's own and
  are left out; every other detail (files, bytes, pruning, paths,
  buckets, exchanges) must be equal. Both packages start each query cold
  (their decoded-data caches differ in grain, so warm `files` would not);
- `explain_string` is the JAX package's text character for character in
  the plaintext, console and html modes, verbose included, with both
  sessions on one system path (the index built by the JAX package);
- `explain(physical=True)` and `explain(mode="analyze")` render, and
  `run(plan, profile_dir=)` writes a Chrome trace.
"""

import json
import re
import sys
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hjax
import hyperspace_tpu_torch as htorch
from hyperspace_tpu.execution import io as jio
from hyperspace_tpu_torch import datagen as dg
from hyperspace_tpu_torch.execution import device_cache as tdc
from hyperspace_tpu_torch.explain.display_mode import (
    EXPLAIN_DISPLAY_MODE,
    ConsoleMode,
    HTMLMode,
    PlainTextMode,
    display_mode_from_conf,
)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

PORT_OWN = ("kernel", "venue", "mesh")
SF_H, SF_DS = 0.005, 0.01
PKGS = (("jax", hjax, {}, jio.clear_table_cache), ("torch", htorch, {"device": "cpu"}, tdc.clear_all))


def labels(node, depth: int = 0) -> list[str]:
    """The label tree without the port's own detail values."""
    detail = {k: v for k, v in node.detail.items() if k not in PORT_OWN}
    parts = [node.op] + [f"{k}={detail[k]}" for k in sorted(detail)]
    if node.rows_out is not None:
        parts.append(f"rows={node.rows_out}")
    out = ["  " * depth + " ".join(str(p) for p in parts)]
    for c in node.children:
        out += labels(c, depth + 1)
    return out


def _strip_port_own(text: str) -> str:
    """Explain text with the `kernel=` / `venue=` detail values cut out of
    each rendered physical label (values hold spaces, never ` key=`)."""
    return re.sub(r" (?:kernel|venue|mesh)=.*?(?= [a-z_]+=|$)", "", text, flags=re.M)


# -- label trees on the sample table -----------------------------------------


def _run_both(tmp_system_path, sample_parquet, body):
    """`body(pkg, session, hs, df)` in both packages, cold; returns the
    label trees of each package's last physical plan."""
    out = {}
    for name, pkg, kw, clear in PKGS:
        session = pkg.HyperspaceSession(system_path=f"{tmp_system_path}/{name}", num_buckets=8, **kw)
        clear()
        body(pkg, session, pkg.Hyperspace(session), session.parquet(sample_parquet))
        out[name] = (labels(session.last_physical_plan), session)
    return out


def test_physical_plan_point_lookup(tmp_system_path, sample_parquet):
    def body(pkg, session, hs, df):
        hs.create_index(df, pkg.IndexConfig("p_key", ["key"], ["id", "value"]))
        session.enable_hyperspace()
        session.run(df.filter(pkg.col("key") == pkg.lit(7)).select("id", "value"))

    got = _run_both(tmp_system_path, sample_parquet, body)
    assert got["torch"][0] == got["jax"][0]
    phys = got["torch"][1].last_physical_plan
    lookup = next(n for n in phys.walk() if n.op == "IndexPointLookup")
    assert lookup.detail["kernel"].startswith("bucket-hash-prune")
    j = phys.to_json()
    assert j["op"] == "Project" and j["children"]


def test_physical_plan_range_scan_and_join(tmp_system_path, sample_parquet):
    def range_scan(pkg, session, hs, df):
        hs.create_index(df, pkg.IndexConfig("r_key", ["key"], ["id", "value"]))
        session.enable_hyperspace()
        session.run(df.filter(pkg.col("key") > pkg.lit(90)).select("id", "value"))

    got = _run_both(tmp_system_path, sample_parquet, range_scan)
    assert got["torch"][0] == got["jax"][0]
    assert "IndexRangeScan" in {n.op for n in got["torch"][1].last_physical_plan.walk()}

    def join(pkg, session, hs, df):
        session.enable_hyperspace()
        session.run(df.select("key", "value").join(df.select("key", "id"), ["key"]))

    got = _run_both(tmp_system_path, sample_parquet, join)
    assert got["torch"][0] == got["jax"][0]
    smj = next(n for n in got["torch"][1].last_physical_plan.walk() if n.op == "SortMergeJoin")
    assert smj.detail["path"] == "zero-exchange-aligned" and smj.detail["buckets"] == 8


def test_physical_plan_without_index_uses_table_scan(tmp_system_path, sample_parquet):
    def body(pkg, session, hs, df):
        session.run(df.filter(pkg.col("key") == pkg.lit(7)))

    got = _run_both(tmp_system_path, sample_parquet, body)
    assert got["torch"][0] == got["jax"][0]
    scan = next(n for n in got["torch"][1].last_physical_plan.walk() if n.op == "TableScan")
    assert scan.detail["files"] == 2


def test_physical_plan_hybrid_scan_filter(tmp_system_path, sample_parquet, tmp_path):
    extra = pa.table({
        "id": np.arange(5000, 5100, dtype=np.int64),
        "key": np.full(100, 7, dtype=np.int64),
        "value": np.zeros(100),
        "name": ["x"] * 100,
    })
    roots = {}
    # Each package indexes its own copy of the source, then gains the same
    # appended file.
    for name, pkg, kw, clear in PKGS:
        root = tmp_path / f"src_{name}"
        root.mkdir()
        for f in Path(sample_parquet).glob("*.parquet"):
            (root / f.name).write_bytes(f.read_bytes())
        session = pkg.HyperspaceSession(system_path=f"{tmp_system_path}/{name}", num_buckets=8, **kw)
        hs = pkg.Hyperspace(session)
        df = session.parquet(root)
        hs.create_index(df, pkg.IndexConfig("h_key", ["key"], ["id", "value"]))
        pq.write_table(extra, root / "part-2.parquet")
        session.conf.set("hyperspace.index.hybridscan.enabled", True)
        session.conf.set("hyperspace.index.hybridscan.maxAppendedRatio", 10.0)
        session.enable_hyperspace()
        clear()
        session.run(session.parquet(root).filter(pkg.col("key") == pkg.lit(7)).select("id", "value"))
        roots[name] = session.last_physical_plan
    assert labels(roots["torch"]) == labels(roots["jax"])
    hybrid = [n for n in roots["torch"].walk() if n.op == "HybridScanFilter"]
    assert hybrid and hybrid[0].detail["files_pruned"] > 0


SMALL_PLANS = {
    "rollup_distinct": lambda pkg, df: df.rollup(["key"], [("count_distinct", "name", "n"), ("sum", "value", "s")]),
    "distinct_expand": lambda pkg, df: df.aggregate(["key"], [("count_distinct", "name", "n"),
                                                             ("mean", "value", "m")]),
    "computed": lambda pkg, df: df.filter(pkg.col("key") < 20).with_column("v2", pkg.col("value") * pkg.lit(2.0)),
    "distinct": lambda pkg, df: df.select("key", "name").distinct(),
    "limit": lambda pkg, df: df.select("id", "key").limit(30),
    "union": lambda pkg, df: sys.modules[f"{pkg.__name__}.plan.nodes"].Union(
        [df.filter(pkg.col("key") == 3).select("id", "key"), df.filter(pkg.col("key") == 4).select("id", "key")]),
}


@pytest.mark.parametrize("indexed", [False, True])
@pytest.mark.parametrize("name", sorted(SMALL_PLANS))
def test_physical_label_trees_of_the_other_operators(tmp_system_path, sample_parquet, name, indexed):
    """The operators the chip_smoke.py plans leave out: grouping sets with a
    distinct count, the distinct expansion, a computed projection, a
    DISTINCT, a LIMIT and a UNION ALL."""

    def body(pkg, session, hs, df):
        if indexed:
            hs.create_index(df, pkg.IndexConfig("o_key", ["key"], ["id", "value", "name"]))
            session.enable_hyperspace()
        session.run(SMALL_PLANS[name](pkg, df))

    got = _run_both(tmp_system_path, sample_parquet, body)
    assert got["torch"][0] == got["jax"][0]


# -- label trees on chip_smoke.py's plans -------------------------------------


@pytest.fixture(scope="module")
def surface(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("phys_paths")
    dg.gen_tpch_lineitem(tmp / "lineitem", sf=SF_H, seed=42)
    dg.gen_tpch_orders(tmp / "orders", sf=SF_H, seed=43)
    dg.gen_tpch_customer(tmp / "customer", sf=SF_H, seed=45)
    dg.gen_date_dim(tmp / "date_dim")
    dg.gen_item(tmp / "item", SF_DS)
    dg.gen_store(tmp / "store")
    dg.gen_store_sales(tmp / "store_sales", SF_DS)
    out = {}
    for name, pkg, kw, clear in PKGS:
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
        plans = {q: (p, "auto") for q, p in cs.query_surface_plans(pkg, t).items()}
        for q, (p, rebucketize) in cs.join_type_plans(pkg, t["lineitem"], t["orders"], t["customer"], SF_H).items():
            plans["JT_" + q] = (p, rebucketize)
        for mode in ("index", "no_index"):
            s.enable_hyperspace() if mode == "index" else s.disable_hyperspace()
            for q, (plan, rebucketize) in plans.items():
                s.conf.set("hyperspace.join.rebucketize", rebucketize)
                clear()
                s.run(plan)
                s.conf.set("hyperspace.join.rebucketize", "auto")
                out[name, mode, q] = labels(s.last_physical_plan)
                if name == "torch":
                    out["stats", mode, q] = (s.last_query_stats, s.last_physical_plan)
    return out


SURFACE_QUERIES = sorted(cs.QUERY_SURFACE_EXPECT) + sorted("JT_" + q for q in cs.JOIN_TYPE_EXPECT)


@pytest.mark.parametrize("mode", ["index", "no_index"])
@pytest.mark.parametrize("query", SURFACE_QUERIES)
def test_physical_label_tree_is_the_jax_packages(surface, query, mode):
    assert surface["torch", mode, query] == surface["jax", mode, query]


AGG_OPS = {
    "SegmentReduceAggregate": "segment-reduce-cpu", "FusedJoinAggregate": "fused-join-agg",
    "PartialAggPushdown": "PartialAggPushdown", "CountDistinctReaggregate": "CountDistinctReaggregate",
    "DistinctExpandAggregate": "DistinctExpandAggregate", "GroupingSetsReaggregate": "GroupingSetsReaggregate",
    "GroupingSetsDistinct": "GroupingSetsDistinct",
}
SCAN_OPS = ("IndexPointLookup", "IndexRangeScan", "HybridScanFilter", "IndexScan", "TableScan")


@pytest.mark.parametrize("mode", ["index", "no_index"])
@pytest.mark.parametrize("query", SURFACE_QUERIES)
def test_the_ports_stats_agree_with_its_physical_plan(surface, query, mode):
    """`stats` keep their keys (chip_smoke.py reads them) and name what the
    physical plan's details name: the last aggregate's branch (the root-most
    aggregate node), every join's path, the exchanges, the top-N and the
    early-out."""
    stats, phys = surface["stats", mode, query]
    nodes = list(phys.walk())
    aggs = [AGG_OPS[n.op] for n in nodes if n.op in AGG_OPS]
    assert stats["agg_path"] == (aggs[0] if aggs else None)
    paths = [n.detail["path"] for n in nodes if "path" in n.detail]
    paths += [n.detail["join_path"] for n in nodes if n.op == "FusedJoinAggregate"]
    assert sorted(stats["join_paths"]) == sorted(paths)
    assert sorted(stats["exchanges"]) == sorted(n.detail["exchange"] for n in nodes if "exchange" in n.detail)
    top = [n.detail for n in nodes if n.op == "TopN"]
    assert stats["top_n"] == ({k: top[0][k] for k in ("kernel", "candidates") if k in top[0]} if top else None)
    early = [n.detail for n in nodes if n.op == "LimitEarlyOut"]
    assert stats["limit_early_out"] == (
        {k: early[0][k] for k in ("files_scanned", "files_total")} if early else None)
    scans = [n.op for n in nodes if n.op in SCAN_OPS]
    assert stats["scan"] in scans if scans else stats["scan"] is None


def test_the_plans_cover_every_operator_branch(surface):
    ops = {line.split()[0] for key, tree in surface.items() if key[0] == "torch" for line in tree}
    assert {
        "SegmentReduceAggregate", "FusedJoinAggregate", "PartialAggPushdown", "CountDistinctReaggregate",
        "DistinctExpandAggregate", "GroupingSetsReaggregate", "SortMergeJoin", "BroadcastHashJoin",
        "TopN", "DeviceSort", "LimitEarlyOut", "IndexScan", "TableScan", "WindowSortedSegments",
    } <= ops


# -- explain text ----------------------------------------------------------------


@pytest.fixture
def explain_pair(tmp_system_path, sample_parquet):
    """Both packages' sessions on one system path, over an index the JAX
    package built: the scan roots explain prints are the same paths."""
    jsession = hjax.HyperspaceSession(system_path=tmp_system_path, num_buckets=8)
    hjax.Hyperspace(jsession).create_index(jsession.parquet(sample_parquet), hjax.IndexConfig("eidx", ["key"], ["value"]))
    out = {}
    for name, pkg, kw, _ in PKGS:
        session = jsession if name == "jax" else pkg.HyperspaceSession(system_path=tmp_system_path, num_buckets=8, **kw)
        out[name] = (pkg, session, pkg.Hyperspace(session), session.parquet(sample_parquet))
    return out


@pytest.mark.parametrize("display", ["plaintext", "console", "html"])
@pytest.mark.parametrize("verbose", [False, True])
def test_explain_text_is_the_jax_packages(explain_pair, display, verbose):
    text = {}
    for name, (pkg, session, hs, df) in explain_pair.items():
        session.conf.set(EXPLAIN_DISPLAY_MODE, display)
        text[name] = hs.explain(df.filter(pkg.col("key") == 1).select("key", "value"), verbose=verbose)
    assert text["torch"] == text["jax"]
    assert "eidx" in text["torch"]
    if display == "plaintext":
        marked = [line for line in text["torch"].splitlines() if line.endswith("<----")]
        assert any("IndexScan" in line for line in marked)
        assert not any("Project" in line for line in marked)
    if verbose:
        assert "IndexScan: 0 -> 1" in text["torch"]
        assert "ShuffleExchange-equivalents eliminated: 1" in text["torch"]


def test_explain_of_a_join_and_an_aggregate_is_the_jax_packages(explain_pair):
    text = {}
    for name, (pkg, session, hs, df) in explain_pair.items():
        q = df.select("key", "value").join(df.select("key", "id"), ["key"]).aggregate(["key"], [("sum", "value", "s")])
        text[name] = hs.explain(q, verbose=True) + hs.explain(df.sort([("key", False)]).limit(5))
    assert text["torch"] == text["jax"]


def test_explain_shared_node_marks_only_rewritten_occurrence(explain_pair):
    text = {}
    for name, (pkg, session, hs, df) in explain_pair.items():
        from_nodes = sys.modules[f"{pkg.__name__}.plan.nodes"]
        q = from_nodes.Join(
            from_nodes.Project(from_nodes.Filter(df, pkg.col("key") == 1), ["key", "value"]),
            from_nodes.Project(df, ["key", "name"]),
            ["key"],
            ["key"],
        )
        text[name] = hs.explain(q)
    assert text["torch"] == text["jax"]
    without = text["torch"].split("Plan without indexes:")[1].split("=" * 64)[0]
    assert [line for line in without.splitlines() if line.endswith("<----")]
    assert [line for line in without.splitlines() if "Scan" in line and not line.endswith("<----")]


def test_explain_physical_diffs_executed_plans(explain_pair):
    text = {}
    for name, (pkg, session, hs, df) in explain_pair.items():
        text[name] = (
            hs.explain(df.filter(pkg.col("key") == pkg.lit(3)).select("key", "value"), physical=True)
            + hs.explain(df.aggregate(["key"], [("sum", "value", "s")]), physical=True)
        )
    out = text["torch"]
    assert "Executed plan with indexes:" in out and "IndexPointLookup" in out and "TableScan" in out
    assert "Indexes used:" in out and "eidx" in out and "files read:" in out
    assert "SegmentReduceAggregate" in out
    assert _strip_port_own(out) == _strip_port_own(text["jax"])


def test_explain_analyze_lists_the_executed_operators(explain_pair):
    ops = {}
    for name, (pkg, session, hs, df) in explain_pair.items():
        session.enable_hyperspace()
        text = hs.explain(df.filter(pkg.col("key") == 7).select("key", "value"), mode="analyze")
        ops[name] = [line.split()[0] for line in text.split("=" * 64)[-1].split("-" * 64)[0].splitlines() if line]
        assert "EXPLAIN ANALYZE" in text and "indexes used: eidx" in text
    assert ops["torch"] == ops["jax"] == ["Project", "IndexPointLookup"]


def test_display_mode_selection(explain_pair):
    session = explain_pair["torch"][1]
    assert isinstance(display_mode_from_conf(session.conf), PlainTextMode)
    session.conf.set(EXPLAIN_DISPLAY_MODE, "console")
    assert isinstance(display_mode_from_conf(session.conf), ConsoleMode)
    session.conf.set(EXPLAIN_DISPLAY_MODE, "html")
    assert isinstance(display_mode_from_conf(session.conf), HTMLMode)
    session.conf.set(EXPLAIN_DISPLAY_MODE, "bogus")
    with pytest.raises(ValueError, match="unknown"):
        display_mode_from_conf(session.conf)


def test_profile_dir_writes_a_chrome_trace(tmp_system_path, sample_parquet, tmp_path):
    session = htorch.HyperspaceSession(system_path=tmp_system_path, device="cpu")
    df = session.parquet(sample_parquet)
    trace_dir = tmp_path / "trace"
    result = session.run(df.filter(htorch.col("key") == htorch.lit(1)), profile_dir=trace_dir)
    found = sorted(trace_dir.glob("*.json"))
    assert len(found) == 1
    events = json.loads(found[0].read_text())["traceEvents"]
    assert events and result.num_rows > 0
    assert session.last_physical_plan is not None and session.last_profile() is not None

"""Hybrid scan on the CPU, the port against the JAX package.

An index whose source has gained files (within
`hyperspace.index.hybridscan.maxAppendedRatio` of the indexed bytes)
still serves: the rules union the index scan with a raw scan of the
appended files. Each package runs on its own index of one source, after
one append: the hybrid cases of tests/test_incremental.py (the filter
with bucket and range pruning of the index input, the join with its
deltas bucketized on the fly, the ratio gate, deleted files) give equal
rows, `files_pruned`, `rows_pruned`, `files_read` and join path; dynamic
partition pruning cuts only the index rows of a hybrid side; the plan
cache misses after an append; and the device and derived caches never
serve a superseded version.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hjax
import hyperspace_tpu_torch as htorch
from hyperspace_tpu.plan.nodes import Union as JaxUnion
from hyperspace_tpu_torch.execution import device_cache as dc
from hyperspace_tpu_torch.plan.nodes import Union as TorchUnion

NB = 8
PACKAGES = (("jax", hjax, {}), ("torch", htorch, {"device": "cpu"}))
HYBRID = "hyperspace.index.hybridscan.enabled"
RATIO = "hyperspace.index.hybridscan.maxAppendedRatio"


def _rows(n, seed, first_id):
    rng = np.random.default_rng(seed)
    return pa.table({
        "id": pa.array(np.arange(first_id, first_id + n, dtype=np.int64)),
        "key": pa.array(rng.integers(0, 100, size=n, dtype=np.int64)),
        "value": pa.array(rng.standard_normal(n), mask=rng.random(n) < 0.05),
        "name": pa.array([f"name_{i % 37}" for i in range(n)]),
    })


def _append(src, fname="part-appended.parquet", seed=7, n=300):
    pq.write_table(_rows(n, seed, 100_000 + 1_000 * seed), src / fname)


@pytest.fixture
def hybrid(tmp_path):
    """A fact source and a dimension, an index of each built by each
    package (its own system path), then one file appended to the fact;
    hybrid scan on (ratio 10), hyperspace enabled."""
    src, dim = tmp_path / "src", tmp_path / "dim"
    src.mkdir()
    dim.mkdir()
    t = _rows(2000, 42, 0)
    pq.write_table(t.slice(0, 1000), src / "part-0.parquet")
    pq.write_table(t.slice(1000), src / "part-1.parquet")
    pq.write_table(pa.table({"key": np.arange(100, dtype=np.int64), "label": [f"l{i}" for i in range(100)]}),
                   dim / "d.parquet")
    out = {"src": src, "dim": dim, "tmp": tmp_path}
    for label, pkg, kw in PACKAGES:
        s = pkg.HyperspaceSession(system_path=str(tmp_path / f"sys_{label}"), num_buckets=NB, **kw)
        hs = pkg.Hyperspace(s)
        hs.create_index(s.parquet(src), pkg.IndexConfig("hf", ["key"], ["value", "id", "name"]))
        hs.create_index(s.parquet(dim), pkg.IndexConfig("hd", ["key"], ["label"]))
        out[label] = (pkg, s, hs)
    _append(src)
    for label, _, _ in PACKAGES:
        s = out[label][1]
        s.conf.set(HYBRID, True)
        s.conf.set(RATIO, 10.0)
        s.enable_hyperspace()
    return out


def _has_union(plan) -> bool:
    return isinstance(plan, (JaxUnion, TorchUnion)) or any(_has_union(c) for c in plan.children())


def _index_used(plan) -> bool:
    return any(getattr(s, "bucket_spec", None) is not None for s in plan.leaves())


def _run(pkg, s, q):
    frame = s.to_pandas(q)
    cols = sorted(frame.columns)
    frame = frame[cols].sort_values(cols).reset_index(drop=True)
    st = s.last_query_stats
    return frame, {k: st.get(k) for k in ("files_pruned", "rows_pruned", "files_read", "join_path")}


def _both(hybrid, make_query):
    out = {}
    for label, _, _ in PACKAGES:
        pkg, s, _ = hybrid[label]
        q = make_query(pkg, s.parquet(hybrid["src"]), s.parquet(hybrid["dim"]))
        frame, st = _run(pkg, s, q)
        ops = None if label == "torch" else [n.op for n in s.last_physical_plan.walk()]
        scan = s.last_query_stats["scan"] if label == "torch" else None
        out[label] = (frame, st, s.optimized_plan(q), scan or ops)
    return out


def _no_index(hybrid, make_query):
    pkg, s, _ = hybrid["torch"]
    s.disable_hyperspace()
    try:
        return _run(pkg, s, make_query(pkg, s.parquet(hybrid["src"]), s.parquet(hybrid["dim"])))[0]
    finally:
        s.enable_hyperspace()


def _assert_parity(got, want_frame):
    (tf, tst, tplan, _), (jf, jst, jplan, _) = got["torch"], got["jax"]
    pd.testing.assert_frame_equal(tf, jf, check_dtype=False)
    pd.testing.assert_frame_equal(tf, want_frame, check_dtype=False)
    assert tst == jst
    assert _index_used(tplan) and _has_union(tplan)
    assert _index_used(jplan) and _has_union(jplan)


FILTERS = {
    "point": lambda pkg, f, d: f.filter(pkg.col("key") == 42).select("key", "value", "name"),
    "in": lambda pkg, f, d: f.filter(pkg.col("key").isin([3, 42, 77])).select("key", "id"),
    "range": lambda pkg, f, d: f.filter((pkg.col("key") >= 10) & (pkg.col("key") <= 14)).select("key", "value"),
    "range+residual": lambda pkg, f, d: f.filter(
        (pkg.col("key") > 90) & (pkg.col("value") > 0)).select("key", "value", "id"),
    "no-projection": lambda pkg, f, d: f.filter(pkg.col("key") == 5),
}


@pytest.mark.parametrize("name", list(FILTERS))
def test_hybrid_filter_matches_the_jax_package(hybrid, name):
    got = _both(hybrid, FILTERS[name])
    _assert_parity(got, _no_index(hybrid, FILTERS[name]))
    assert got["torch"][3] == "HybridScanFilter"
    assert "HybridScanFilter" in got["jax"][3]
    if name in ("point", "in", "no-projection"):  # bucket pruning of the index input
        assert got["torch"][1]["files_pruned"] > 0


def test_stale_index_needs_hybrid_scan(hybrid):
    """Without hybrid scan the appended file breaks the signature match."""
    for label, _, _ in PACKAGES:
        pkg, s, _ = hybrid[label]
        s.conf.set(HYBRID, False)
        q = FILTERS["point"](pkg, s.parquet(hybrid["src"]), None)
        assert not _index_used(s.optimized_plan(q))


JOINS = {
    "join": lambda pkg, f, d: f.select("key", "value").join(d.select("key", "label"), ["key"]),
    "dim-first": lambda pkg, f, d: d.select("key", "label").join(f.select("key", "id"), ["key"]),
    "dpp-dim-producer": lambda pkg, f, d: f.select("key", "value").join(
        d.filter(pkg.col("key") < 10).select("key", "label"), ["key"]),
    "dpp-hybrid-producer": lambda pkg, f, d: f.filter(pkg.col("value") > 1.0).select("key", "value").join(
        d.select("key", "label"), ["key"]),
    "left-outer": lambda pkg, f, d: d.filter(pkg.col("key") < 20).select("key", "label").join(
        f.select("key", "id"), ["key"], how="left"),
    # Grouped on the hybrid side's unique id: the partial-aggregation
    # pushdown bails (no shrink) and the fused Aggregate(Join) runs.
    "aggregate": lambda pkg, f, d: f.select("key", "value", "id").join(d.select("key", "label"), ["key"]).aggregate(
        ["id"], [("count", "label", "n"), ("max", "key", "top"), ("min", "value", "lo")]),
    # Grouped on the dimension: the pushdown aggregates the hybrid side
    # first, and its output joins through the exchange.
    "pushdown": lambda pkg, f, d: f.select("key", "value", "id").join(d.select("key", "label"), ["key"]).aggregate(
        ["label"], [("count", "id", "n"), ("max", "id", "top"), ("min", "value", "lo")]),
}
JOIN_PATHS = {"pushdown": "rebucketized-aligned"}


@pytest.mark.parametrize("name", list(JOINS))
def test_hybrid_join_matches_the_jax_package(hybrid, name):
    got = _both(hybrid, JOINS[name])
    _assert_parity(got, _no_index(hybrid, JOINS[name]))
    assert got["torch"][1]["join_path"] == JOIN_PATHS.get(name, "zero-exchange-aligned")
    if name.startswith("dpp"):
        assert got["torch"][1]["rows_pruned"] > 0


def test_hybrid_join_merges_deltas_into_buckets(hybrid):
    """The hybrid side's buckets hold the index rows, then the delta rows
    that hash there, unsorted within: the join sorts them before the merge."""
    from hyperspace_tpu_torch.execution.executor import Executor
    from hyperspace_tpu_torch.plan.nodes import Join
    from hyperspace_tpu_torch.plan.prune import prune_columns

    pkg, s, _ = hybrid["torch"]
    plan = prune_columns(s.optimized_plan(JOINS["join"](pkg, s.parquet(hybrid["src"]), s.parquet(hybrid["dim"]))))
    ex = Executor(s.device, s.conf)
    join = next(n for n in _walk(plan) if isinstance(n, Join))
    lside, rside = ex._join_sides(join)
    assert not lside.sorted_within and rside.sorted_within
    assert lside.offsets[-1] == 2300 and len(lside.offsets) == NB + 1
    keys = lside.table.host_column("key")
    from hyperspace_tpu_torch.ops.hashing import bucket_ids, hash_int_column

    bucket = bucket_ids(hash_int_column(keys), NB)
    assert np.array_equal(bucket, np.repeat(np.arange(NB), np.diff(lside.offsets)))


def _walk(plan):
    yield plan
    for c in plan.children():
        yield from _walk(c)


def test_ratio_gate(hybrid):
    for label, _, _ in PACKAGES:
        pkg, s, _ = hybrid[label]
        s.conf.set(RATIO, 1e-9)  # the appended bytes exceed this
        assert not _index_used(s.optimized_plan(FILTERS["point"](pkg, s.parquet(hybrid["src"]), None)))


def test_deleted_source_file_is_no_hybrid_match(hybrid):
    (hybrid["src"] / "part-1.parquet").unlink()
    for label, _, _ in PACKAGES:
        pkg, s, _ = hybrid[label]
        assert not _index_used(s.optimized_plan(FILTERS["point"](pkg, s.parquet(hybrid["src"]), None)))


def test_plan_cache_misses_after_an_append(hybrid):
    pkg, s, _ = hybrid["torch"]
    cache = htorch.PlanCache()
    q = FILTERS["point"](pkg, s.parquet(hybrid["src"]), None)
    first = s.run_query(q, plan_cache=cache)
    s.run_query(q, plan_cache=cache)
    assert cache.stats()["hits"] == 1
    extra = _rows(50, 9, 500_000)
    extra = extra.set_column(1, "key", pa.array(np.full(50, 42, dtype=np.int64)))
    pq.write_table(extra, hybrid["src"] / "part-appended-2.parquet")
    second = s.run_query(q, plan_cache=cache)
    st = cache.stats()
    assert (st["hits"], st["misses"]) == (1, 2)
    assert second.result.num_rows == first.result.num_rows + 50
    assert second.stats["scan"] == "HybridScanFilter"


def test_caches_never_serve_a_superseded_version(hybrid):
    """A hybrid query warms both caches; after an incremental refresh
    (plain index scan of two versions) and an optimize (one new version),
    every answer is the new data's and no file of a superseded version
    is read."""
    pkg, s, hs = hybrid["torch"]
    join = JOINS["aggregate"](pkg, s.parquet(hybrid["src"]), s.parquet(hybrid["dim"]))
    point = FILTERS["point"](pkg, s.parquet(hybrid["src"]), None)
    want_join, want_point = _no_index(hybrid, JOINS["aggregate"]), _no_index(hybrid, FILTERS["point"])
    for _ in range(2):
        pd.testing.assert_frame_equal(_run(pkg, s, join)[0], want_join, check_dtype=False)
        pd.testing.assert_frame_equal(_run(pkg, s, point)[0], want_point, check_dtype=False)
    assert dc.HOST_DERIVED.stats()["by_kind"].get("hybrid", {}).get("hits", 0) >= 1
    for action in (lambda: hs.refresh_index("hf", mode="incremental"), lambda: hs.optimize_index("hf")):
        action()
        assert dc.DEVICE_CACHE.stats()["entries"] == 0 and dc.HOST_DERIVED.stats()["entries"] == 0
        n_files = len(list(hybrid["src"].iterdir()))
        _append(hybrid["src"], f"part-more-{n_files}.parquet", seed=n_files)
        want_join, want_point = _no_index(hybrid, JOINS["aggregate"]), _no_index(hybrid, FILTERS["point"])
        for _ in range(2):
            pd.testing.assert_frame_equal(_run(pkg, s, join)[0], want_join, check_dtype=False)
            frame, _ = _run(pkg, s, point)
            pd.testing.assert_frame_equal(frame, want_point, check_dtype=False)
        live = set(next(e for e in s.manager.get_indexes() if e.name == "hf").content.directories)
        cached = {k[1] for k in dc.DEVICE_CACHE._entries if k[0] == "col"}
        read_dirs = {f.split("/")[-2] for files in cached for f in files if "/hf/" in f}
        assert read_dirs <= live, f"read {read_dirs}, live {live}"


# -- chip_smoke.py's lifecycle plans on TPC-H, in both packages -------------------

SF = 0.004


@pytest.fixture(scope="module")
def tpch_hybrid(tmp_path_factory):
    """chip_smoke.py's phase 3d at sf 0.004 with 8 buckets: the lineitem
    index (`INDEXED`, `INCLUDED`) and the orders index, then the 10%
    append (seed 46); a session of each package over one system path
    each, hybrid scan on."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from hyperspace_tpu_torch import datagen as dg

    tmp = tmp_path_factory.mktemp("tpch_hybrid")
    dg.gen_tpch_lineitem(tmp / "li", sf=SF, seed=42)
    dg.gen_tpch_orders(tmp / "o", sf=SF, seed=43)
    out = {"cs": cs, "tmp": tmp}
    for label, pkg, kw in PACKAGES:
        s = pkg.HyperspaceSession(system_path=str(tmp / f"sys_{label}"), num_buckets=NB, **kw)
        li, o = s.parquet(tmp / "li"), s.parquet(tmp / "o")
        pkg.Hyperspace(s).create_index(li, pkg.IndexConfig("li_live", cs.INDEXED, cs.INCLUDED))
        pkg.Hyperspace(s).create_index(o, pkg.IndexConfig("orders_orderkey", cs.O_INDEXED, cs.O_INCLUDED))
        out[label] = (pkg, s)
    frac, seed = cs.LIVE_APPENDS[0]
    dg.gen_tpch_lineitem(tmp / "stage", sf=frac * SF, seed=seed, files=1)
    (tmp / "stage" / "part-0.parquet").rename(tmp / "li" / "append-0.parquet")
    for label, _, _ in PACKAGES:
        out[label][1].conf.set(HYBRID, True)
        out[label][1].enable_hyperspace()
    return out


@pytest.mark.parametrize("name", ["lookups", "range", "range_agg", "J2"])
def test_chip_smoke_lifecycle_plans_take_the_jax_packages_paths(tpch_hybrid, name):
    """Each hybrid query of chip_smoke.py's lifecycle phase takes the JAX
    package's path (the HybridScanFilter; J2 zero-exchange aligned, the
    deltas bucketized on the fly, fused) with equal rows and pruning."""
    cs = tpch_hybrid["cs"]
    got = {}
    for label, _, _ in PACKAGES:
        pkg, s = tpch_hybrid[label]
        li, o = s.parquet(tpch_hybrid["tmp"] / "li"), s.parquet(tpch_hybrid["tmp"] / "o")
        plans, _ = cs.lifecycle_plans(pkg, li, o, SF)
        frames, stats = [], []
        for plan in plans[name]:
            assert _has_union(s.optimized_plan(plan))
            f, st = _run(pkg, s, plan)
            frames.append(f)
            ops = [n.op for n in s.last_physical_plan.walk()] if label == "jax" else [s.last_query_stats["scan"]]
            # files_read is left out: the packages' read caches differ in
            # grain (a file; a set of files), and this fixture is shared.
            st.pop("files_read")
            agg = s.last_query_stats["agg_path"]
            stats.append((st, "HybridScanFilter" in ops, agg if agg == "fused-join-agg" else None))
        got[label] = (frames, stats)
    for tf, jf in zip(got["torch"][0], got["jax"][0]):
        if name in ("range_agg", "J2"):  # float sums: another order of the same terms
            pd.testing.assert_frame_equal(tf, jf, check_dtype=False, rtol=1e-12)
        else:
            pd.testing.assert_frame_equal(tf, jf, check_dtype=False)
        assert len(tf) > 0
    assert got["torch"][1] == got["jax"][1]
    if name == "J2":
        assert got["torch"][1][0][0]["join_path"] == "zero-exchange-aligned"
        assert got["torch"][1][0][2] == "fused-join-agg"
    else:
        assert all(hybrid for _, hybrid, _ in got["torch"][1])

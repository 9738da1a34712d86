"""The port's warm-query caches against the JAX package's semantics.

- execution/device_cache.py: the semantics of tests/test_device_cache.py
  (repeat filter, lookup and join hits, a repeat join that skips the key
  factorization, a repeat fused Aggregate(Join) served from the caches,
  the byte budget), plus what torch needs: a tensor written in place
  misses its derived entries instead of hitting them.
- serve/plan_cache.py: the semantics of tests/test_serve.py::TestPlanCache
  (a repeat hits, a new index log entry or a rewritten source misses,
  distinct plans get distinct entries) and `run_query` leaving the
  session's view alone.
- Warm repeats give the JAX package's results: exactly where the result
  is selected or integral, sums within 1e-12 relative (the other CPU
  parity tests' tolerance: groups of at most a few thousand rows, summed
  in another order, differ far less).
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu as hjax
import hyperspace_tpu_torch as htorch
from hyperspace_tpu_torch.execution import device_cache as dc
from hyperspace_tpu_torch.execution import exec_common
from hyperspace_tpu_torch.metadata.log_manager import IndexLogManager
from hyperspace_tpu_torch.serve import PlanCache, collection_log_versions, versioned_plan_key

BUCKETS = 4


def _write(root, frame):
    root.mkdir(parents=True, exist_ok=True)
    pq.write_table(pa.Table.from_pandas(frame, preserve_index=False), root / "p.parquet")


def _session(path, pkg=htorch):
    kw = {"device": "cpu"} if pkg is htorch else {}
    return pkg.HyperspaceSession(system_path=str(path), num_buckets=BUCKETS, **kw)


@pytest.fixture()
def indexed(tmp_path):
    """test_device_cache.py's source: an int32 key over 5,000 values and a
    float column, 30,000 rows, indexed on the key (4 buckets)."""
    rng = np.random.default_rng(31)
    n = 30_000
    df = pd.DataFrame({"k": rng.integers(0, 5_000, n).astype(np.int32), "v": rng.normal(size=n)})
    _write(tmp_path / "src", df)
    session = _session(tmp_path / "idx")
    hs = htorch.Hyperspace(session)
    ds = session.parquet(tmp_path / "src")
    hs.create_index(ds, htorch.IndexConfig("dc_k", ["k"], ["v"]))
    session.enable_hyperspace()
    dc.clear_all()
    return session, ds, df, tmp_path


@pytest.fixture()
def fact_dim(tmp_path):
    """test_device_cache.py's join pair: a fact of 40,000 rows over 1,000
    keys and a dimension of 900, each indexed on k (4 buckets)."""
    rng = np.random.default_rng(32)
    f = pd.DataFrame({"k": rng.integers(0, 1000, 40_000).astype(np.int64), "a": rng.normal(size=40_000),
                      "g": rng.integers(0, 7, 40_000).astype(np.int64)})
    d = pd.DataFrame({"k": np.arange(900, dtype=np.int64), "b": rng.normal(size=900),
                      "t": rng.choice(["u", "w", "z"], 900)})
    _write(tmp_path / "f", f)
    _write(tmp_path / "d", d)
    out = {}
    for pkg in (hjax, htorch):
        session = _session(tmp_path / "idx", pkg)
        fs, ds = session.parquet(tmp_path / "f"), session.parquet(tmp_path / "d")
        if pkg is hjax:
            hs = pkg.Hyperspace(session)
            hs.create_index(fs, pkg.IndexConfig("fk", ["k"], ["a", "g"]))
            hs.create_index(ds, pkg.IndexConfig("dk", ["k"], ["b", "t"]))
        session.enable_hyperspace()
        out[pkg.__name__] = (pkg, session, fs, ds)
    dc.clear_all()
    return out, f, d


def _sorted(frame, by):
    return frame.sort_values(by).reset_index(drop=True)


# -- the device cache ------------------------------------------------------------


def test_repeat_filter_hits_device_cache(indexed):
    """A rewritten filter with no key bounds reads whole bucket files; the
    repeat serves every column from the device cache, reads no file, and
    a raw repeat adds no entry."""
    session, ds, df, _ = indexed
    q = ds.filter(((htorch.col("k") % 2) == 0) & (htorch.col("v") > 0.0))
    first = session.to_pandas(q)
    assert session.last_query_stats["scan"] == "IndexScan" and session.last_query_stats["files_read"] == BUCKETS
    h0 = dc.DEVICE_CACHE.stats()["hits"]
    second = session.to_pandas(q)
    assert dc.DEVICE_CACHE.stats()["hits"] > h0
    assert session.last_query_stats["files_read"] == 0
    pd.testing.assert_frame_equal(_sorted(first, ["k", "v"]), _sorted(second, ["k", "v"]))
    assert len(second) == int(((df.k % 2 == 0) & (df.v > 0.0)).sum())

    session.disable_hyperspace()
    session.to_pandas(q)
    e0 = dc.DEVICE_CACHE.stats()["entries"] + dc.HOST_DERIVED.stats()["entries"]
    session.to_pandas(q)
    assert dc.DEVICE_CACHE.stats()["entries"] + dc.HOST_DERIVED.stats()["entries"] == e0
    assert session.last_query_stats["files_read"] == 0


def test_repeat_point_lookup_hits_device_cache(indexed):
    session, ds, df, _ = indexed
    q = ds.filter(htorch.col("k") == 1234)
    first = session.to_pandas(q)
    assert session.last_query_stats["files_read"] == 1
    h0 = dc.DEVICE_CACHE.stats()["hits"]
    second = session.to_pandas(q)
    assert dc.DEVICE_CACHE.stats()["hits"] > h0 and session.last_query_stats["files_read"] == 0
    assert len(first) == len(second) == int((df.k == 1234).sum())


def test_rewritten_source_file_misses(indexed):
    """The device cache keys every column on its files' mtimes: a source
    rewritten in place is decoded again, never served stale."""
    session, ds, df, tmp = indexed
    session.disable_hyperspace()
    q = ds.aggregate([], [("sum", "k", "s"), ("count", None, "n")])
    assert int(session.to_pandas(q).s[0]) == int(df.k.sum())
    df2 = df.assign(k=df.k + 1)
    _write(tmp / "src", df2)
    got = session.to_pandas(q)
    assert session.last_query_stats["files_read"] == 1
    assert int(got.s[0]) == int(df2.k.sum()) and int(got.n[0]) == len(df2)


def test_repeat_join_skips_factorization(fact_dim, monkeypatch):
    both, f, d = fact_dim
    pkg, session, fs, ds = both["hyperspace_tpu_torch"]
    q = fs.join(ds, ["k"])
    r1 = session.to_pandas(q)
    assert session.last_query_stats["join_path"] == "zero-exchange-aligned"
    calls = []
    real = exec_common._factorize_keys
    monkeypatch.setattr(exec_common, "_factorize_keys", lambda *a, **k: calls.append(1) or real(*a, **k))
    m0 = dc.HOST_DERIVED.stats()
    r2 = session.to_pandas(q)
    m1 = dc.HOST_DERIVED.stats()
    assert calls == [], "the repeat join factorized its keys again"
    assert m1["by_kind"]["fact"]["hits"] == m0["by_kind"]["fact"]["hits"] + 1
    assert m1["by_kind"]["padbm"]["hits"] >= m0["by_kind"]["padbm"]["hits"] + 2
    assert len(r1) == len(r2) == len(f.merge(d, on="k"))
    pd.testing.assert_frame_equal(_sorted(r1, ["k", "a"]), _sorted(r2, ["k", "a"]))


def test_repeat_fused_join_agg_hits_the_caches(fact_dim, monkeypatch):
    """The fused Aggregate(Join) serves its group ids, channels, pads and
    channel stacks from the caches on a repeat, recomputing none."""
    both, f, d = fact_dim
    pkg, session, fs, ds = both["hyperspace_tpu_torch"]
    q = fs.join(ds, ["k"]).aggregate(["t"], [("sum", "a", "sa"), ("max", "a", "ma"), ("mean", "b", "mb"),
                                             ("count", None, "n")])
    r1 = session.to_pandas(q)
    assert session.last_query_stats["agg_path"] == "fused-join-agg"
    calls = []
    for name in ("group_ids", "_agg_channels", "_pad_bucket_major", "_factorize_keys"):
        real = getattr(exec_common, name)
        monkeypatch.setattr(exec_common, name, lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))
    s0 = dc.HOST_DERIVED.stats()["by_kind"]
    r2 = session.to_pandas(q)
    s1 = dc.HOST_DERIVED.stats()["by_kind"]
    assert calls == []
    for kind in ("gid", "aggin", "padbm", "stack", "fact"):
        assert s1[kind]["hits"] > s0[kind]["hits"], kind
    pd.testing.assert_frame_equal(r1, r2)
    m = f.merge(d, on="k")
    exp = m.groupby("t").agg(sa=("a", "sum"), n=("a", "size")).reset_index()
    np.testing.assert_allclose(_sorted(r2, ["t"]).sa.to_numpy(), exp.sa.to_numpy(), rtol=1e-12)


def test_repeat_aggregate_skips_group_ids_and_matches_the_jax_package(fact_dim, monkeypatch):
    both, f, _ = fact_dim
    results = {}
    for name, (pkg, session, fs, _) in both.items():
        q = fs.aggregate(["g"], [("sum", "a", "sa"), ("min", "a", "lo"), ("count", None, "n")])
        session.to_pandas(q)
        if pkg is htorch:
            calls = []
            real = exec_common.group_ids
            monkeypatch.setattr(exec_common, "group_ids", lambda *a, **k: calls.append(1) or real(*a, **k))
            g0 = dc.HOST_DERIVED.stats()["by_kind"]["gid"]["hits"]
        results[name] = _sorted(session.to_pandas(q), ["g"])
        if pkg is htorch:
            assert calls == [] and dc.HOST_DERIVED.stats()["by_kind"]["gid"]["hits"] == g0 + 1
    j, t = results["hyperspace_tpu"], results["hyperspace_tpu_torch"]
    np.testing.assert_array_equal(t.g.to_numpy(), j.g.to_numpy())
    np.testing.assert_array_equal(t.n.to_numpy(), j.n.to_numpy())
    np.testing.assert_array_equal(t.lo.to_numpy(), j.lo.to_numpy())
    np.testing.assert_allclose(t.sa.to_numpy(), j.sa.to_numpy(), rtol=1e-12)


@pytest.mark.parametrize("query", ["join", "fused aggregate", "lookup", "range", "aggregate"])
def test_warm_repeats_equal_the_jax_package(fact_dim, query):
    both, _, _ = fact_dim
    out = {}
    for name, (pkg, session, fs, ds) in both.items():
        col, lit = pkg.col, pkg.lit
        q = {
            "join": lambda: fs.join(ds, ["k"]),
            "fused aggregate": lambda: fs.join(ds, ["k"]).aggregate(["t"], [("sum", "b", "sb"), ("count", None, "n")]),
            "lookup": lambda: fs.filter(col("k").isin([3, 500, 977])),
            "range": lambda: fs.filter((col("k") >= lit(100)) & (col("k") < lit(180))),
            "aggregate": lambda: fs.aggregate(["g"], [("max", "a", "ma"), ("count", None, "n")]),
        }[query]()
        session.to_pandas(q)
        out[name] = session.to_pandas(q)  # warm
    j, t = out["hyperspace_tpu"], out["hyperspace_tpu_torch"]
    keys = [c for c in j.columns if j[c].dtype != object or c in ("t",)]
    j, t = _sorted(j, keys), _sorted(t, keys)
    assert list(t.columns) == list(j.columns) and len(t) == len(j) > 0
    for c in j.columns:
        if query == "fused aggregate" and c == "sb":
            np.testing.assert_allclose(t[c].to_numpy(), j[c].to_numpy(), rtol=1e-12)
        else:
            np.testing.assert_array_equal(t[c].to_numpy(), j[c].to_numpy(), err_msg=c)


def test_in_place_write_misses_instead_of_hitting(fact_dim):
    """Torch has no read-only tensors: a derived key holds the tensor's
    version, so an in-place write to a cached column makes the next
    derivation miss (and see the new values) instead of hitting."""
    both, f, _ = fact_dim
    _, session, fs, _ = both["hyperspace_tpu_torch"]
    q = fs.aggregate(["g"], [("count", None, "n")])
    session.to_pandas(q)
    session.to_pandas(q)
    table = session.run(fs.select("g"))  # the cached column itself
    assert dc.is_stable(table.columns["g"])
    m0 = dc.HOST_DERIVED.stats()["by_kind"]["gid"]
    table.columns["g"].mul_(1)  # same values, new version
    got = session.to_pandas(q)
    m1 = dc.HOST_DERIVED.stats()["by_kind"]["gid"]
    assert m1["misses"] == m0["misses"] + 1 and m1["hits"] == m0["hits"]
    np.testing.assert_array_equal(_sorted(got, ["g"]).n.to_numpy(), f.groupby("g").size().to_numpy())


def test_derived_host_arrays_are_frozen(fact_dim):
    both, _, _ = fact_dim
    _, session, fs, ds = both["hyperspace_tpu_torch"]
    session.to_pandas(fs.join(ds, ["k"]).aggregate(["t"], [("count", None, "n")]))
    values = [v for _, _, v in dc.HOST_DERIVED._entries.values()]
    arrays = [a for v in values for a in dc._arrays_of(v) if isinstance(a, np.ndarray)]
    assert arrays and not any(a.flags.writeable for a in arrays)
    assert not dc.is_stable(torch.zeros(3)) and not dc.is_stable(np.zeros(3))


def test_cache_budget_bounds_memory():
    c = dc.RefCache(budget_bytes=1000)
    base = np.arange(10)
    base.flags.writeable = False
    for i in range(50):
        c.get_or_build(("x", i), (base,), lambda: (np.zeros(30), 240))
    st = c.stats()
    assert st["bytes"] <= 1000
    assert st["entries"] <= 1000 // 240 + 1
    assert st["evictions"] == 50 - st["entries"] and st["misses"] == 50
    # The oldest go first; an entry above a quarter of the budget is never kept.
    assert c.get(("x", 49)) is not None and c.get(("x", 0)) is None
    c.get_or_build(("big",), (), lambda: (np.zeros(40), 251))
    assert c.get(("big",)) is None


def test_concurrent_misses_build_once_and_keep_the_budget():
    """Single flight under threads: 16 threads (more than the cores here)
    asking for 8 keys at once build each key once, count every call as a
    hit or a miss, and keep the budget; with a budget of 3 entries the
    builds evict and every caller still gets its key's value."""
    import sys
    import threading

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for budget, keys in ((10_000, 8), (3 * 400, 8)):
            c = dc.RefCache(budget_bytes=budget)
            builds, wrong = [], []
            start = threading.Barrier(16)

            def work(t):
                start.wait(timeout=30)
                for i in range(200):
                    key = ("k", (t + i) % keys)
                    v = c.get_or_build(key, (), lambda key=key: (builds.append(key) or np.full(50, key[1]), 400))
                    if int(v[0]) != key[1]:
                        wrong.append(key)

            threads = [threading.Thread(target=work, args=(t,)) for t in range(16)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in threads) and not wrong
            st = c.stats()
            assert st["hits"] + st["misses"] == 16 * 200 and st["bytes"] <= budget
            if budget == 10_000:
                assert sorted(builds) == sorted(set(builds)) and len(builds) == keys
    finally:
        sys.setswitchinterval(old)


def test_table_footprint_counts_dictionaries_at_their_payload(fact_dim):
    """The JAX package's byte accounting: codes, validity, and a string
    dictionary at its characters plus a word an entry."""
    from hyperspace_tpu.execution import device_cache as jdc

    both, _, _ = fact_dim
    jt = both["hyperspace_tpu"][1].run(both["hyperspace_tpu"][3])
    tt = both["hyperspace_tpu_torch"][1].run(both["hyperspace_tpu_torch"][3])
    assert dc.table_footprint_bytes(tt) == jdc.table_footprint_bytes(jt) > 0


def test_device_cache_budget_holds_on_the_query_path(indexed, monkeypatch):
    """With a budget of a few columns (300 KB: a column of the whole table
    is 120-240 KB, above the quarter an entry may take; of one bucket
    30-60 KB), repeat full scans and lookups over every bucket keep the
    resident bytes within it, evict the least recently used, and still
    answer right."""
    session, ds, df, _ = indexed
    monkeypatch.setattr(dc.DEVICE_CACHE, "budget", 300_000)
    keys = [int(k) for k in df.k.unique()[:12]]
    for _ in range(2):
        for enabled in (False, True):
            session.enable_hyperspace() if enabled else session.disable_hyperspace()
            got = session.to_pandas(ds.aggregate([], [("sum", "k", "s"), ("count", None, "n")]))
            assert int(got.s[0]) == int(df.k.sum()) and int(got.n[0]) == len(df)
            assert dc.DEVICE_CACHE.stats()["bytes"] <= 300_000
        for k in keys:
            got = session.to_pandas(ds.filter(htorch.col("k") == k))
            assert len(got) == int((df.k == k).sum())
            assert dc.DEVICE_CACHE.stats()["bytes"] <= 300_000
    assert dc.DEVICE_CACHE.stats()["evictions"] > 0


# -- the plan cache ------------------------------------------------------------------


def test_repeat_query_hits_and_a_new_log_entry_misses(indexed):
    session, ds, df, tmp = indexed
    q = ds.filter(htorch.col("k") == 3).select("k", "v")
    cache = PlanCache(max_entries=8)
    first = session.run_query(q, plan_cache=cache)
    s0 = cache.stats()
    assert s0["misses"] == 1 and s0["entries"] == 1
    second = session.run_query(q, plan_cache=cache)
    s1 = cache.stats()
    assert s1["hits"] == s0["hits"] + 1
    assert second.optimized_plan is first.optimized_plan
    assert second.stats["scan"] == "IndexPointLookup"
    pd.testing.assert_frame_equal(pd.DataFrame(first.result.decode()), pd.DataFrame(second.result.decode()))
    # A new index commits a log entry: the version stamp moves and the
    # old key never hits again.
    htorch.Hyperspace(session).create_index(ds, htorch.IndexConfig("dc_v", ["v"], ["k"]))
    third = session.run_query(q, plan_cache=cache)
    s2 = cache.stats()
    assert (s2["misses"], s2["hits"]) == (s1["misses"] + 1, s1["hits"])
    pd.testing.assert_frame_equal(pd.DataFrame(first.result.decode()), pd.DataFrame(third.result.decode()))


def test_a_rewritten_source_or_a_new_log_id_moves_the_key(indexed):
    session, ds, df, tmp = indexed
    q = ds.filter(htorch.col("k") == 3)
    k0 = versioned_plan_key(session, q)
    assert versioned_plan_key(session, q) == k0
    vers = dict(collection_log_versions(session))
    assert vers == {"dc_k": IndexLogManager(tmp / "idx" / "dc_k").get_latest_id()}
    _write(tmp / "src", df.assign(v=df.v + 1.0))
    k1 = versioned_plan_key(session, q)
    assert k1[1] != k0[1] and k1[0] == k0[0]
    session.disable_hyperspace()
    assert versioned_plan_key(session, q)[4] is False


def test_distinct_plans_get_distinct_entries_and_disabled_skips_the_cache(indexed):
    session, ds, _, _ = indexed
    cache = PlanCache(max_entries=8)
    for k in (1, 2, 1):
        session.run_query(ds.filter(htorch.col("k") == k).select("k", "v"), plan_cache=cache)
    assert cache.stats()["entries"] == 2 and cache.stats()["hits"] == 1
    session.disable_hyperspace()
    session.run_query(ds.filter(htorch.col("k") == 5), plan_cache=cache)
    assert cache.stats()["entries"] == 2 and cache.stats()["misses"] == 2


def test_plan_cache_is_a_bounded_lru(indexed):
    session, ds, _, _ = indexed
    cache = PlanCache(max_entries=2)
    for k in (1, 2, 3):
        session.run_query(ds.filter(htorch.col("k") == k), plan_cache=cache)
    assert cache.stats()["entries"] == 2 and cache.stats()["evictions"] == 1


def test_run_query_does_not_touch_session_view(indexed):
    session, ds, _, _ = indexed
    q = ds.filter(htorch.col("k") == 4).select("k")
    outcome = session.run_query(q)
    assert outcome.result is not None and outcome.stats["files_read"] == 1
    assert session.last_query_stats == {} and session.last_optimized_plan is None
    assert set(outcome.stats["host_s"]) == {"plan", "read", "derive", "execute"}
    session.run(q)
    assert session.last_query_stats["scan"] == "IndexPointLookup"
    assert session.last_optimized_plan.to_json() == outcome.optimized_plan.to_json()


def test_plan_signature_matches_the_jax_package(fact_dim):
    from hyperspace_tpu.signature import plan_signature as jax_signature
    from hyperspace_tpu_torch.signature import plan_signature as torch_signature

    both, _, _ = fact_dim
    plans = {}
    for name, (pkg, _, fs, ds) in both.items():
        plans[name] = [
            fs.filter(pkg.col("k") == 3).select("k", "a"),
            fs.join(ds, ["k"]).aggregate(["t"], [("sum", "a", "sa")]),
            fs.select("k", ("x", pkg.col("a") * pkg.lit(2))),
        ]
    for j, t in zip(plans["hyperspace_tpu"], plans["hyperspace_tpu_torch"]):
        assert torch_signature(t) == jax_signature(j)
    assert len({torch_signature(p) for p in plans["hyperspace_tpu_torch"]}) == 3


@pytest.mark.parametrize("variant", ["limit n", "sort direction", "window frame", "grouping sets"])
def test_plans_that_differ_only_in_a_new_nodes_field_get_distinct_entries(fact_dim, variant):
    """Limit's n, a sort key's direction, a window's frame and an
    aggregate's grouping sets are part of `to_json`, so of the plan cache's
    key: two such plans never share an entry, and each gets its own
    answer (the JAX package's)."""
    from hyperspace_tpu_torch.signature import plan_signature

    both, _, _ = fact_dim

    def plans(pkg, fs, ds):
        j = fs.join(ds, ["k"])
        if variant == "limit n":
            return [j.sort([("a", True), ("k", True)]).limit(n) for n in (5, 9)]
        if variant == "sort direction":
            return [j.sort([("a", asc), ("k", True)]).limit(7) for asc in (True, False)]
        if variant == "window frame":
            # Peers (equal g) share the RANGE frame's sum, not the ROWS'.
            return [j.window(["t"], order_by=[("g", True)], funcs=[("sum", "g", "rs")], frame=f)
                    .select("k", "t", "rs") for f in ("rows", "range")]
        return [fs.aggregate(["g", "k"], [("count", None, "n")], grouping_sets=s) for s in ([["g"]], [["g"], []])]

    pkg, session, fs, ds = both["hyperspace_tpu_torch"]
    mine = plans(pkg, fs, ds)
    assert plan_signature(mine[0]) != plan_signature(mine[1])
    cache = PlanCache(max_entries=8)
    got = [session.run_query(p, plan_cache=cache).result for p in mine]
    again = [session.run_query(p, plan_cache=cache).result for p in mine]
    assert cache.stats()["entries"] == 2 and cache.stats()["hits"] == 2
    jpkg, jsession, jfs, jds = both["hyperspace_tpu"]
    want = [jsession.to_pandas(p) for p in plans(jpkg, jfs, jds)]
    frames = [pd.DataFrame(r.decode()) for r in got]
    assert not frames[0].equals(frames[1])
    for g, a, w in zip(frames, again, want):
        assert g.equals(pd.DataFrame(a.decode()))
        assert list(g.columns) == list(w.columns) and len(g) == len(w)
        for c in w.columns:
            if w[c].dtype.kind == "f":
                np.testing.assert_allclose(g[c].to_numpy(float), w[c].to_numpy(float), rtol=1e-12)
            else:
                assert g[c].tolist() == w[c].tolist(), c

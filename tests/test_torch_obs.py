"""The port's observability plane against the JAX package's: tracer
spans, the metrics registry, per-query profiles and EXPLAIN ANALYZE.

The cases of tests/test_obs.py that the port covers, run through the port
(on the CPU) beside the JAX package on the same inputs: the span trees,
histogram percentiles and the profiles' operator trees with their
`rows_out` must equal the JAX package's; the span names a query, a join,
an aggregate and an index build open must be the JAX package's.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hjax
import hyperspace_tpu_torch as htorch
from hyperspace_tpu.execution import io as jio
from hyperspace_tpu.obs import metrics as jmetrics
from hyperspace_tpu.obs import trace as jtrace
from hyperspace_tpu_torch import stats
from hyperspace_tpu_torch.execution import device_cache as tdc
from hyperspace_tpu_torch.obs import events, metrics, trace


@pytest.fixture(autouse=True)
def _port_obs_reset():
    """The port's process-global observability state, zeroed around each
    test (tests/conftest.py resets the JAX package's)."""
    stats.reset()
    metrics.REGISTRY.reset()
    trace.reset()
    trace.set_enabled(True)
    events.reset()
    yield
    trace.set_enabled(True)
    trace.reset()


@pytest.fixture
def tables(tmp_path):
    rng = np.random.default_rng(11)
    n = 5_000
    fact = pd.DataFrame({"k": rng.integers(0, 100, n).astype(np.int64), "v": rng.normal(size=n).round(4)})
    dim = pd.DataFrame({"k": np.arange(100, dtype=np.int64), "g": (np.arange(100) % 7).astype(np.int64)})
    for name, df in (("fact", fact), ("dim", dim)):
        (tmp_path / name).mkdir()
        pq.write_table(pa.Table.from_pandas(df, preserve_index=False), tmp_path / name / "p.parquet")
    out = {"fact": fact, "dim": dim}
    for name, pkg, kw in (("jax", hjax, {}), ("torch", htorch, {"device": "cpu"})):
        session = pkg.HyperspaceSession(system_path=str(tmp_path / f"idx_{name}"), num_buckets=4, **kw)
        hs = pkg.Hyperspace(session)
        f = session.parquet(tmp_path / "fact")
        d = session.parquet(tmp_path / "dim")
        hs.create_index(f, pkg.IndexConfig("f_k", ["k"], ["v"]))
        session.enable_hyperspace()
        out[name] = (session, hs, f, d, pkg)
    return out


def _cold(name):
    (jio.clear_table_cache if name == "jax" else tdc.clear_all)()


def _op_tree(profile) -> list:
    def walk(op, depth):
        yield depth, op.op, op.rows_out
        for c in op.children:
            yield from walk(c, depth + 1)

    return list(walk(profile.root, 0))


def _names(span_json) -> list:
    out = [span_json["name"]]
    for c in span_json.get("children", ()):
        out += _names(c)
    return out


# -- tracer basics ---------------------------------------------------------


def _record(tr):
    with tr.trace("root", q=1) as root:
        with tr.span("a", x=1):
            with tr.span("a.b") as inner:
                inner.set(rows=7)
            tr.event("tick", n=1)
        with tr.span("c"):
            pass
    return root


def _shape(span) -> tuple:
    return (span.name, dict(span.attrs), list(span.events), [_shape(c) for c in span.children])


def test_span_nesting_and_attrs():
    root = _record(trace)
    assert [c.name for c in root.children] == ["a", "c"]
    a = root.children[0]
    assert [c.name for c in a.children] == ["a.b"]
    assert a.children[0].attrs == {"rows": 7}
    assert a.events == [{"name": "tick", "n": 1}]
    assert all(s.wall_s is not None and s.wall_s >= 0 for s in root.walk())
    # Self times telescope to the root.
    assert sum(s.self_s() for s in root.walk()) == pytest.approx(root.wall_s, rel=0.02)
    assert trace.last_trace() is root and trace.recent_roots() == [root]
    assert _shape(root) == _shape(_record(jtrace))


def test_untraced_spans_are_noops():
    assert trace.span("orphan") is trace.NOOP
    trace.event("orphan-event")  # must not raise
    trace.annotate(x=1)
    assert trace.last_trace() is None


def test_disabled_mode_allocates_nothing():
    trace.set_enabled(False)
    assert trace.span("x") is trace.NOOP
    with trace.trace("t") as root:
        assert root is trace.NOOP
        assert trace.span("y") is trace.NOOP
    assert trace.last_trace() is None


def test_worker_threads_inherit_active_span():
    with trace.trace("root") as root:
        with trace.span("parent"):

            def task(i):
                with trace.span(f"child-{i}"):
                    return i

            with ThreadPoolExecutor(max_workers=4) as ex:
                assert sorted(ex.map(trace.wrap(task), range(4))) == [0, 1, 2, 3]
    parent = root.children[0]
    assert sorted(c.name for c in parent.children) == [f"child-{i}" for i in range(4)]


def test_spans_close_with_error():
    with pytest.raises(ValueError):
        with trace.trace("root") as root:
            with trace.span("inner"):
                raise ValueError("boom")
    assert root.error == "ValueError: boom" and root.children[0].error == "ValueError: boom"
    assert all(s.wall_s is not None for s in root.walk())


# -- metrics registry ------------------------------------------------------


def test_undeclared_counter_raises():
    with pytest.raises(KeyError, match="retyr.attempts"):
        stats.increment("retyr.attempts")
    stats.increment("metadata.cache.hits")
    assert stats.get("metadata.cache.hits") == 1
    assert stats.snapshot()["metadata.cache.hits"] == 1
    stats.reset()
    assert stats.get("metadata.cache.hits") == 0


def test_histogram_percentiles_bounded():
    bounds = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)
    h = metrics.Histogram("t", buckets=bounds)
    ref = jmetrics.Histogram("t", buckets=bounds)
    values = np.random.default_rng(3).uniform(0.5, 200.0, 1000)
    for v in range(1, 101):
        h.observe(float(v))
        ref.observe(float(v))
    assert h.count == 100
    assert h.sum == pytest.approx(5050.0)
    p = h.percentiles()
    assert 30 <= p["p50"] <= 70
    assert p["p95"] >= p["p50"]
    assert p["p99"] <= 100.0
    for v in values:
        h.observe(float(v))
        ref.observe(float(v))
    assert h.snapshot() == ref.snapshot()
    assert h.bucket_counts() == ref.bucket_counts()
    h._reset()
    assert h.count == 0 and h.quantile(0.5) is None


def test_registry_kind_conflict_raises():
    metrics.REGISTRY.counter("obs_test.metric")
    with pytest.raises(ValueError, match="already declared"):
        metrics.REGISTRY.gauge("obs_test.metric")


def test_event_ring_is_declared_and_bounded(tables):
    session = tables["torch"][0]
    with pytest.raises(KeyError, match="undeclared event"):
        events.declare("serve.admision_rejected")
    ev = events.declare("serve.shed")
    session.conf.set("hyperspace.obs.events.maxEvents", 3)
    assert session.conf.get("hyperspace.obs.events.maxEvents") == 3
    with trace.trace("root") as root:
        for i in range(5):
            ev.emit(depth=i)
    got = events.recent()
    assert [e["fields"]["depth"] for e in got] == [2, 3, 4]
    assert {e["trace_id"] for e in got} == {root.trace_id}
    assert metrics.REGISTRY.get("obs.events.dropped").value == 2


# -- per-query profiles ----------------------------------------------------


def test_filter_query_profile(tables):
    fact = tables["fact"]
    trees = {}
    for name in ("jax", "torch"):
        session, hs, f, d, pkg = tables[name]
        _cold(name)
        res = session.run(f.filter(pkg.col("k") == 7).select("k", "v"))
        trees[name] = _op_tree(session.last_profile())
    prof = session.last_profile()
    assert prof is not None and prof is session.last_profile()
    assert trees["torch"] == trees["jax"]
    ops = {o.op: o for o in prof.operators()}
    lookup = ops["IndexPointLookup"]
    assert lookup.rows_out == res.num_rows == int((fact.k == 7).sum())
    assert lookup.detail["files"] == 1  # bucket-pruned point lookup
    assert lookup.detail["bytes"] > 0
    assert prof.stats["bytes_scanned"] == lookup.detail["bytes"]
    # The tree telescopes, and the root frame fits inside the total.
    assert prof.root.wall_s > 0
    assert prof.operator_total_s() == pytest.approx(prof.root.wall_s, rel=0.05)
    assert prof.root.wall_s <= prof.total_s
    assert prof.venue["platform"] == "cpu"
    assert prof.cache["table_misses"] >= 1
    assert prof.fallback == {"replans": 0, "degraded_indexes": [], "used_indexes": True}
    names = _names(prof.trace)
    assert "plan.optimize" in names and "execute.IndexPointLookup" in names
    assert any(n.startswith("rule.") for n in names)


def test_join_query_profile(tables):
    fact, dim = tables["fact"], tables["dim"]
    trees = {}
    for name in ("jax", "torch"):
        session, hs, f, d, pkg = tables[name]
        _cold(name)
        res = session.run(f.join(d, ["k"]))
        trees[name] = _op_tree(session.last_profile())
    assert trees["torch"] == trees["jax"]
    prof = session.last_profile()
    joins = [o for o in prof.operators() if "Join" in o.op]
    assert joins, [o.op for o in prof.operators()]
    assert prof.root.rows_out == res.num_rows == len(fact.merge(dim, on="k"))
    assert joins[0].rows_in == len(fact) + len(dim)
    assert prof.operator_total_s() == pytest.approx(prof.root.wall_s, rel=0.05)
    assert prof.stats["join_path"] is not None


def test_profile_available_with_tracing_disabled(tables):
    session, hs, f, d, pkg = tables["torch"]
    session.conf.set("hyperspace.obs.enabled", False)
    assert session.conf.get("hyperspace.obs.enabled") is False
    last = trace.last_trace()  # the index build's
    res = session.run(f.filter(pkg.col("k") == 3).select("k", "v"))
    prof = session.last_profile()
    assert prof.trace is None and trace.last_trace() is last
    assert prof.root is not None and prof.root.wall_s > 0
    assert prof.root.rows_out == res.num_rows


def test_explain_analyze_renders(tables):
    session, hs, f, d, pkg = tables["torch"]
    text = hs.explain(f.filter(pkg.col("k") == 7).select("k", "v"), mode="analyze")
    assert "EXPLAIN ANALYZE" in text
    assert "IndexPointLookup" in text
    assert "total:" in text and "cache:" in text and "venue: platform=cpu" in text
    assert "indexes used: f_k" in text
    with pytest.raises(htorch.HyperspaceError, match="unknown explain mode"):
        hs.explain(f, mode="bogus")


def test_metrics_fed_from_profiles(tables):
    session, hs, f, d, pkg = tables["torch"]
    before = metrics.REGISTRY.get("query.count").value
    session.run(f.filter(pkg.col("k") == 5).select("k", "v"))
    assert metrics.REGISTRY.get("query.count").value == before + 1
    assert metrics.REGISTRY.get("query.operator.seconds").count > 0
    assert metrics.REGISTRY.get("query.bucket_fanout").count >= 1


@pytest.mark.parametrize("query", ["lookup", "join", "aggregate", "create"])
def test_span_names_equal_the_jax_packages(tables, query):
    got = {}
    for name, tr in (("jax", jtrace), ("torch", trace)):
        session, hs, f, d, pkg = tables[name]
        _cold(name)
        if query == "create":
            hs.create_index(d, pkg.IndexConfig("d_g", ["g"], ["k"]))
        else:
            plan = {
                "lookup": f.filter(pkg.col("k") == 7).select("k", "v"),
                "join": f.join(d, ["k"]),
                "aggregate": f.aggregate(["k"], [("sum", "v", "s")]),
            }[query]
            session.run(plan)
        got[name] = tr.last_trace()
    assert {s.name for s in got["torch"].walk()} == {s.name for s in got["jax"].walk()}
    assert [c.name for c in got["torch"].children] == [c.name for c in got["jax"].children]


def test_sink_gets_one_line_a_query(tables, tmp_path):
    import json

    session, hs, f, d, pkg = tables["torch"]
    sink = tmp_path / "events.jsonl"
    session.conf.set("hyperspace.obs.sink", str(sink))
    assert session.conf.get("hyperspace.obs.sink") == str(sink)
    session.run(f.filter(pkg.col("k") == 7).select("k", "v"))
    session.run(f.join(d, ["k"]))
    lines = [json.loads(line) for line in sink.read_text().splitlines()]
    assert [line["trace"]["name"] for line in lines] == ["query", "query"]
    assert all(line["trace"]["trace_id"] for line in lines)

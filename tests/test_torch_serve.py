"""The port's serving plane (CPU): the QueryServer, its plan and result
caches, per-query state and the metadata cache's counters.

The cases of tests/test_serve.py through the port. The hammer is the
gate: 16 client threads against one session give the port's serial
results exactly, and those equal the JAX package's serial results on the
same data (rows as multisets; integral values exactly, float sums within
1e-12 relative). Added here: a tensor written in place in a cached result
makes the next lookup miss; the kernel wrappers' launch counter stays
exact under threads; the pieces left out (the operations controller's
ingest pause and the ingest keys) raise as not ported.
"""

from __future__ import annotations

import sys
import threading
import time

import numpy as np
import pytest
import torch

import hyperspace_tpu as hjax
from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig, col, stats
from hyperspace_tpu_torch.exceptions import AdmissionRejected, HyperspaceError, QueryTimeout
from hyperspace_tpu_torch.obs import events, metrics, trace
from hyperspace_tpu_torch.serve import PlanCache, QueryServer, ResultCache


@pytest.fixture(autouse=True)
def _port_obs_reset():
    stats.reset()
    metrics.REGISTRY.reset()
    trace.reset()
    trace.set_enabled(True)
    events.reset()
    yield


def _session(tmp_system_path) -> HyperspaceSession:
    return HyperspaceSession(system_path=tmp_system_path, device="cpu")


def _assert_same(a, b, label=""):
    """Decoded results match exactly (floats to 1e-9), in order."""
    da, db = a.decode(), b.decode()
    assert set(da) == set(db), (label, set(da), set(db))
    for c in da:
        av, bv = np.asarray(da[c]), np.asarray(db[c])
        assert len(av) == len(bv), (label, c, len(av), len(bv))
        if av.dtype.kind in "fc":
            np.testing.assert_allclose(av, bv, rtol=1e-9, err_msg=f"{label}.{c}")
        else:
            assert (av == bv).all(), (label, c)


def _rows(table) -> list:
    d = table.decode()
    names = sorted(d)
    return sorted(zip(*(np.asarray(d[c]).tolist() for c in names)))


def _query_set(pkg, df):
    """Distinct plan shapes a serving workload mixes: point lookup, range
    scan, aggregation, order/limit."""
    return [
        df.filter(pkg.col("key") == 7).select("key", "value"),
        df.filter(pkg.col("key") == 23).select("key", "value"),
        df.filter((pkg.col("key") >= 10) & (pkg.col("key") < 20)).select("key", "value", "id"),
        df.aggregate(["key"], [("sum", "value", "s"), ("count", None, "n")]).sort(["key"]),
        df.select("id", "key").sort([("id", False)]).limit(50),
    ]


# -- the hammer: N concurrent clients == serial results ----------------------


class TestHammer:
    def test_16_clients_match_serial_and_the_jax_package(self, sample_parquet, tmp_system_path):
        jsession = hjax.HyperspaceSession(system_path=tmp_system_path + "/jax")
        jdf = jsession.parquet(sample_parquet)
        hjax.Hyperspace(jsession).create_index(jdf, hjax.IndexConfig("serve_idx", ["key"], ["value", "id"]))
        jsession.enable_hyperspace()
        reference = [jsession.run(q) for q in _query_set(hjax, jdf)]

        session = _session(tmp_system_path)
        hs = Hyperspace(session)
        df = session.parquet(sample_parquet)
        hs.create_index(df, IndexConfig("serve_idx", ["key"], ["value", "id"]))
        session.enable_hyperspace()
        queries = _query_set(sys.modules["hyperspace_tpu_torch"], df)
        serial = [session.run(q) for q in queries]
        for q, (got, want) in enumerate(zip(serial, reference)):
            g, w = _rows(got), _rows(want)
            assert len(g) == len(w) > 0, q
            for rg, rw in zip(g, w):
                assert rg == pytest.approx(rw, rel=1e-12), q

        n_clients = 16
        errors: list[BaseException] = []
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            with session.serve(workers=4, max_queue_depth=256) as server:

                def client(cid: int):
                    try:
                        for j in range(len(queries)):
                            qi = (cid + j) % len(queries)
                            out = server.submit(queries[qi]).result(timeout=300)
                            _assert_same(serial[qi], out, label=f"client{cid}/q{qi}")
                    except BaseException as e:  # surfaced after join
                        errors.append(e)

                threads = [threading.Thread(target=client, args=(i,)) for i in range(n_clients)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=600)
                assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(old)
        assert not errors, errors
        assert all(not t.is_alive() for t in server._threads)

    def test_hammer_with_result_cache(self, sample_parquet, tmp_system_path):
        session = _session(tmp_system_path)
        hs = Hyperspace(session)
        df = session.parquet(sample_parquet)
        hs.create_index(df, IndexConfig("serve_idx2", ["key"], ["value", "id"]))
        session.enable_hyperspace()
        q = df.filter(col("key") == 5).select("key", "value")
        serial = session.run(q)
        with session.serve(workers=4, result_cache=True) as server:
            handles = [server.submit(q) for _ in range(24)]
            for h in handles:
                _assert_same(serial, h.result(timeout=300))
            rc = server.result_cache.stats()
        assert rc["hits"] > 0
        assert metrics.REGISTRY.get("serve.result_cache.hits").value == rc["hits"]


# -- admission control / scheduling (deterministic via the run_fn seam) ------


class TestAdmission:
    def test_rejects_at_max_queue_depth(self, tmp_system_path):
        session = _session(tmp_system_path)
        started, release = threading.Event(), threading.Event()

        def blocking_run(plan):
            started.set()
            assert release.wait(30)
            return plan

        server = QueryServer(session, workers=1, max_queue_depth=2, plan_cache=False, run_fn=blocking_run)
        try:
            h1 = server.submit("q1")
            assert started.wait(10)
            h2 = server.submit("q2")
            h3 = server.submit("q3")
            with pytest.raises(AdmissionRejected) as ei:
                server.submit("q4")
            assert ei.value.depth == 2 and ei.value.max_depth == 2
            assert events.recent()[-1]["name"] == "serve.admission_rejected"
            release.set()
            assert h1.result(timeout=30) == "q1"
            assert h2.result(timeout=30) == "q2"
            assert h3.result(timeout=30) == "q3"
        finally:
            release.set()
            server.shutdown()
        snap = server.metrics_snapshot()
        assert snap["serve.rejected"] == 1 and snap["serve.admitted"] == 3 and snap["serve.completed"] == 3

    def test_shed_depth_refuses_non_priority_first(self, tmp_system_path):
        session = _session(tmp_system_path)
        started, release = threading.Event(), threading.Event()

        def blocking_run(plan):
            started.set()
            assert release.wait(30)
            return plan

        server = QueryServer(session, workers=1, max_queue_depth=4, shed_depth_ratio=0.5, plan_cache=False,
                             run_fn=blocking_run)
        try:
            server.submit("head")
            assert started.wait(10)
            server.submit("a")
            server.submit("b")
            assert server.saturation() == {"workers": 1, "inflight": 1, "queue_depth": 2, "max_queue_depth": 4,
                                           "shed_depth": 2, "accepting": True}
            with pytest.raises(AdmissionRejected, match="load shed"):
                server.submit("c")
            hp = server.submit("p", priority=True)
            release.set()
            assert hp.result(timeout=30) == "p"
        finally:
            release.set()
            server.shutdown()

    def test_priority_lane_dequeues_first(self, tmp_system_path):
        session = _session(tmp_system_path)
        order: list[str] = []
        release = threading.Event()
        started = threading.Event()

        def run_fn(plan):
            started.set()
            assert release.wait(30)
            order.append(plan)
            return plan

        server = QueryServer(session, workers=1, max_queue_depth=16, plan_cache=False, run_fn=run_fn)
        try:
            server.submit("head")
            assert started.wait(10)
            ha = server.submit("a")
            hb = server.submit("b")
            hp = server.submit("p", priority=True)
            release.set()
            for h in (ha, hb, hp):
                h.result(timeout=30)
            assert order == ["head", "p", "a", "b"]
        finally:
            release.set()
            server.shutdown()

    def test_queue_timeout_discards_unexecuted(self, tmp_system_path):
        session = _session(tmp_system_path)
        release = threading.Event()
        started = threading.Event()
        ran: list[str] = []

        def run_fn(plan):
            started.set()
            ran.append(plan)
            assert release.wait(30)
            return plan

        server = QueryServer(session, workers=1, max_queue_depth=16, plan_cache=False, run_fn=run_fn)
        try:
            server.submit("slow")
            assert started.wait(10)
            h = server.submit("expires", timeout=0.05)
            time.sleep(0.2)
            release.set()
            with pytest.raises(QueryTimeout):
                h.result(timeout=30)
            assert h.timed_out and "expires" not in ran
        finally:
            release.set()
            server.shutdown()

    def test_result_wait_timeout_leaves_query_running(self, tmp_system_path):
        session = _session(tmp_system_path)
        release = threading.Event()

        def run_fn(plan):
            assert release.wait(30)
            return plan

        server = QueryServer(session, workers=1, max_queue_depth=4, plan_cache=False, run_fn=run_fn)
        try:
            h = server.submit("slow")
            with pytest.raises(QueryTimeout):
                h.result(timeout=0.05)
            assert not h.done()
            release.set()
            assert h.result(timeout=30) == "slow"
        finally:
            release.set()
            server.shutdown()

    def test_drain_waits_then_resumes_admission(self, tmp_system_path):
        session = _session(tmp_system_path)
        server = QueryServer(session, workers=2, max_queue_depth=16, plan_cache=False, run_fn=lambda p: p)
        try:
            handles = [server.submit(i) for i in range(8)]
            assert server.drain(timeout=30)
            assert all(h.done() for h in handles)
            assert server.submit("after").result(timeout=30) == "after"
        finally:
            server.shutdown()
        assert not any(t.is_alive() for t in server._threads)

    def test_shutdown_nowait_cancels_queued(self, tmp_system_path):
        session = _session(tmp_system_path)
        release = threading.Event()
        started = threading.Event()

        def run_fn(plan):
            started.set()
            assert release.wait(30)
            return plan

        server = QueryServer(session, workers=1, max_queue_depth=16, plan_cache=False, run_fn=run_fn)
        server.submit("running")
        assert started.wait(10)
        queued = server.submit("queued")
        release.set()
        server.shutdown(wait=False)
        with pytest.raises(AdmissionRejected):
            queued.result(timeout=30)
        assert queued.cancelled
        with pytest.raises(AdmissionRejected):
            server.submit("late")

    def test_errors_surface_on_handle_not_worker(self, tmp_system_path):
        session = _session(tmp_system_path)

        def run_fn(plan):
            raise ValueError(f"boom:{plan}")

        server = QueryServer(session, workers=1, max_queue_depth=4, plan_cache=False, run_fn=run_fn)
        try:
            h = server.submit("x")
            with pytest.raises(ValueError, match="boom:x"):
                h.result(timeout=30)
            h2 = server.submit("y")
            with pytest.raises(ValueError, match="boom:y"):
                h2.result(timeout=30)
        finally:
            server.shutdown()

    def test_result_preserves_original_traceback(self, tmp_system_path):
        import traceback

        session = _session(tmp_system_path)

        def deep_failure():
            raise ValueError("boom:traceback")

        def run_fn(plan):
            deep_failure()

        server = QueryServer(session, workers=1, max_queue_depth=4, plan_cache=False, run_fn=run_fn)
        try:
            h = server.submit("x")
            with pytest.raises(ValueError) as excinfo:
                h.result(timeout=30)
            frames = [f.name for f in traceback.extract_tb(excinfo.value.__traceback__)]
            assert "deep_failure" in frames and "run_fn" in frames
        finally:
            server.shutdown()

    def test_what_is_not_ported_raises(self, tmp_system_path):
        from hyperspace_tpu_torch import Hyperspace

        session = _session(tmp_system_path)
        with pytest.raises(HyperspaceError, match="not ported"):
            Hyperspace(session).controller(ingest=object())
        for key in ("hyperspace.ingest.enabled", "hyperspace.ingest.pollSeconds"):
            with pytest.raises(HyperspaceError, match="not ported"):
                session.conf.set(key, True)

    def test_a_session_asked_for_the_card_needs_one(self, tmp_system_path):
        if torch.cuda.is_available():
            assert HyperspaceSession(system_path=tmp_system_path).device.type == "cuda"
        else:
            with pytest.raises(HyperspaceError, match="no CUDA device"):
                HyperspaceSession(system_path=tmp_system_path)


def test_launch_counter_is_exact_under_threads():
    """count_launch under 8 threads and a short switch interval: a lost
    update would leave the count short."""
    from hyperspace_tpu_torch.ops.kernels import count_launch

    def wrapper():
        pass

    wrapper.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [count_launch(wrapper) for _ in range(5_000)]) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == 40_000


# -- plan cache ---------------------------------------------------------------


class TestPlanCache:
    def test_repeat_query_hits_and_refresh_invalidates(self, sample_parquet, tmp_system_path):
        session = _session(tmp_system_path)
        hs = Hyperspace(session)
        df = session.parquet(sample_parquet)
        hs.create_index(df, IndexConfig("pc_idx", ["key"], ["value"]))
        session.enable_hyperspace()
        q = df.filter(col("key") == 3).select("key", "value")
        cache = PlanCache(max_entries=8)
        with session.serve(workers=1, plan_cache=cache) as server:
            first = server.submit(q).result(timeout=300)
            s0 = cache.stats()
            assert s0["misses"] >= 1 and s0["entries"] == 1
            second = server.submit(q).result(timeout=300)
            s1 = cache.stats()
            assert s1["hits"] == s0["hits"] + 1
            _assert_same(first, second)
            hs.refresh_index("pc_idx")
            third = server.submit(q).result(timeout=300)
            s2 = cache.stats()
            assert s2["misses"] == s1["misses"] + 1
            assert s2["hits"] == s1["hits"]
            _assert_same(first, third)
        assert metrics.REGISTRY.get("serve.plan_cache.hits").value == s2["hits"]
        assert metrics.REGISTRY.get("serve.plan_cache.misses").value == s2["misses"]

    def test_distinct_plans_get_distinct_entries(self, sample_parquet, tmp_system_path):
        session = _session(tmp_system_path)
        hs = Hyperspace(session)
        df = session.parquet(sample_parquet)
        hs.create_index(df, IndexConfig("pc_idx2", ["key"], ["value"]))
        session.enable_hyperspace()
        cache = PlanCache(max_entries=8)
        q1 = df.filter(col("key") == 1).select("key", "value")
        q2 = df.filter(col("key") == 2).select("key", "value")
        with session.serve(workers=1, plan_cache=cache) as server:
            server.submit(q1).result(timeout=300)
            server.submit(q2).result(timeout=300)
        assert cache.stats()["entries"] == 2


# -- result cache -------------------------------------------------------------


class TestResultCache:
    def test_refresh_mid_flight_never_serves_stale_rows(self, sample_parquet, tmp_system_path):
        import pyarrow as pa
        import pyarrow.parquet as pq

        session = _session(tmp_system_path)
        hs = Hyperspace(session)
        df = session.parquet(sample_parquet)
        hs.create_index(df, IndexConfig("rc_idx", ["key"], ["value", "id"]))
        session.enable_hyperspace()
        q = df.filter(col("key") == 77).select("id", "key", "value")
        rc = ResultCache(max_bytes=64 << 20)
        with session.serve(workers=2, result_cache=rc) as server:
            before = server.submit(q).result(timeout=300)
            again = server.submit(q).result(timeout=300)
            _assert_same(before, again)
            assert rc.stats()["hits"] >= 1
            n_before = len(before.decode()["id"])
            extra = pa.table({
                "id": np.arange(10_000, 10_008, dtype=np.int64),
                "key": np.full(8, 77, dtype=np.int64),
                "value": np.linspace(0.0, 1.0, 8),
                "name": [f"late_{i}" for i in range(8)],
            })
            pq.write_table(extra, f"{sample_parquet}/part-2.parquet")
            hs.refresh_index("rc_idx")
            after = server.submit(q).result(timeout=300)
            ids = set(np.asarray(after.decode()["id"]).tolist())
            assert len(after.decode()["id"]) == n_before + 8
            assert {10_000, 10_007} <= ids
            hits_before = rc.stats()["hits"]
            once_more = server.submit(q).result(timeout=300)
            _assert_same(after, once_more)
            assert rc.stats()["hits"] == hits_before + 1

    def test_byte_budget_evicts_lru(self, sample_parquet, tmp_system_path):
        session = _session(tmp_system_path)
        df = session.parquet(sample_parquet)
        session.enable_hyperspace()
        rc = ResultCache(max_bytes=1)  # everything is "too large"
        with session.serve(workers=1, result_cache=rc) as server:
            q = df.filter(col("key") == 1).select("key")
            server.submit(q).result(timeout=300)
            server.submit(q).result(timeout=300)
        st = rc.stats()
        assert st["entries"] == 0 and st["hits"] == 0

    def test_lru_evicts_the_least_recently_used(self, sample_parquet, tmp_system_path):
        from hyperspace_tpu_torch.serve import table_nbytes

        session = _session(tmp_system_path)
        df = session.parquet(sample_parquet)
        t = session.run(df.filter(col("key") == 1).select("id", "key", "value"))
        rc = ResultCache(max_bytes=4 * table_nbytes(t))  # four entries fit
        for i in range(4):
            assert rc.put(("k", i), t)
        assert rc.get(("k", 0)) is t  # touched: now the most recent
        assert rc.put(("k", 4), t)
        assert rc.get(("k", 1)) is None and rc.get(("k", 0)) is t
        st = rc.stats()
        assert st["entries"] == 4 and st["evictions"] == 1 and st["bytes"] == 4 * table_nbytes(t)

    def test_a_tensor_written_in_place_misses(self, sample_parquet, tmp_system_path):
        session = _session(tmp_system_path)
        hs = Hyperspace(session)
        df = session.parquet(sample_parquet)
        hs.create_index(df, IndexConfig("rw_idx", ["key"], ["value", "id"]))
        session.enable_hyperspace()
        q = df.filter(col("key") == 11).select("id", "key", "value")
        rc = ResultCache(max_bytes=64 << 20)
        with session.serve(workers=1, result_cache=rc) as server:
            first = server.submit(q).result(timeout=300)
            want = {c: np.array(v, copy=True) for c, v in first.decode().items()}
            h = server.submit(q)
            hit = h.result(timeout=300)
            assert h.cache_hit and hit is first
            hit.columns["value"].add_(1.0)  # a client writes the shared result
            h2 = server.submit(q)
            fresh = h2.result(timeout=300)
            assert not h2.cache_hit and fresh is not hit
            np.testing.assert_array_equal(fresh.decode()["value"], want["value"])
            assert rc.stats()["written"] == 1
            h3 = server.submit(q)
            assert h3.result(timeout=300) is fresh and h3.cache_hit


# -- per-query handle state / session view ------------------------------------


class TestPerQueryState:
    def test_handle_carries_profile_and_stats(self, sample_parquet, tmp_system_path):
        session = _session(tmp_system_path)
        df = session.parquet(sample_parquet)
        q = df.filter(col("key") == 9).select("key", "value")
        with session.serve(workers=1) as server:
            h = server.submit(q)
            h.result(timeout=300)
        assert h.profile is not None and h.stats is not None
        assert h.stats.get("files_read", 0) >= 1
        assert session.last_profile() is not None

    def test_run_query_does_not_touch_session_view(self, sample_parquet, tmp_system_path):
        session = _session(tmp_system_path)
        df = session.parquet(sample_parquet)
        q = df.filter(col("key") == 4).select("key")
        outcome = session.run_query(q)
        assert outcome.result is not None and outcome.profile is not None
        assert outcome.physical_plan is not None and outcome.replans == 0 and outcome.used_indexes is False
        assert session.last_profile() is None
        session._publish(outcome)
        assert session.last_profile() is outcome.profile
        assert session.last_physical_plan is outcome.physical_plan

    def test_concurrent_direct_runs_keep_view_consistent(self, sample_parquet, tmp_system_path):
        session = _session(tmp_system_path)
        df = session.parquet(sample_parquet)
        q1 = df.filter(col("key") == 1).select("key")
        q2 = df.aggregate(["key"], [("count", None, "n")])
        errs: list[BaseException] = []

        def run_many(q):
            try:
                for _ in range(5):
                    session.run(q)
                    with session._state_lock:  # one query's stats, plan and profile
                        assert session.last_profile().root.op == session.last_physical_plan.op
                        assert session.last_profile().stats == session.last_query_stats
            except BaseException as e:
                errs.append(e)

        ts = [threading.Thread(target=run_many, args=(q,)) for q in (q1, q2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=600)
        assert not errs, errs
        assert session.last_profile() is not None


# -- metadata TTL cache ----------------------------------------------------------


class TestMetadataCache:
    def test_hit_miss_counters(self):
        from hyperspace_tpu_torch.metadata.cache import CreationTimeBasedCache

        c = CreationTimeBasedCache(expiry_seconds=60)
        h0, m0 = stats.get("metadata.cache.hits"), stats.get("metadata.cache.misses")
        assert c.get() is None
        c.set([1, 2])
        assert c.get() == [1, 2]
        assert stats.get("metadata.cache.hits") == h0 + 1
        assert stats.get("metadata.cache.misses") == m0 + 1

    def test_expiry_counts_as_miss(self):
        from hyperspace_tpu_torch.metadata.cache import CreationTimeBasedCache

        c = CreationTimeBasedCache(expiry_seconds=0.0)
        c.set("entry")
        time.sleep(0.01)
        m0 = stats.get("metadata.cache.misses")
        assert c.get() is None
        assert stats.get("metadata.cache.misses") == m0 + 1

    def test_concurrent_get_set_clear_no_torn_state(self):
        from hyperspace_tpu_torch.metadata.cache import CreationTimeBasedCache

        c = CreationTimeBasedCache(expiry_seconds=0.005)
        stop = time.monotonic() + 0.5
        errs: list[BaseException] = []

        def reader():
            try:
                while time.monotonic() < stop:
                    got = c.get()
                    assert got is None or got == ("payload", 123)
            except BaseException as e:
                errs.append(e)

        def writer():
            while time.monotonic() < stop:
                c.set(("payload", 123))

        def clearer():
            while time.monotonic() < stop:
                c.clear()

        threads = [threading.Thread(target=f) for f in (reader, reader, writer, clearer)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errs, errs

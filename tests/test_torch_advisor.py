"""The port's advisor (hyperspace_tpu_torch/advisor/) against the JAX package's.

tests/test_advisor.py's what-if, cost-model, routing, lifecycle and
workload cases, each run through both packages (`P` is "jax" or "torch")
on the same seeded sources with the same assertions (the pinned reader's
routing waits for the port's pinned snapshot). Then the parity cases:

- the same plans give the same signatures in both packages, and the same
  recorded walls the same routing decisions; a `routing.json` written by
  one package is read by the other;
- from the same workload records and the same fitted cost model, both
  analyzers give equal recommendations (kind, target, columns, bucket
  count; benefit and confidence within float64 rounding) over one store
  holding a hot table, a cold index, a fragmented index and two joined
  indexes of unequal bucket counts;
- an index the lifecycle sweep auto-creates has bucket files
  byte-identical to the JAX package's;
- a crash inside an auto-create left by one package is recovered by the
  other;
- importing the port's advisor loads neither JAX nor the JAX package, and
  the advisor keys read the JAX package's defaults while the ingest and
  venue keys still raise as not ported.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hjax
import hyperspace_tpu_torch as htorch
from hyperspace_tpu import faults as jfaults
from hyperspace_tpu import states as jstates
from hyperspace_tpu.advisor import routing as jrouting
from hyperspace_tpu.advisor.cost import CostModel as JCostModel
from hyperspace_tpu.advisor.whatif import Recommendation as JRecommendation
from hyperspace_tpu.advisor.whatif import WhatIfAnalyzer as JWhatIfAnalyzer
from hyperspace_tpu.obs import metrics as jmetrics
from hyperspace_tpu.signature import plan_signature as jplan_signature
from hyperspace_tpu.utils import file_utils as jfile_utils
from hyperspace_tpu_torch import faults as tfaults
from hyperspace_tpu_torch import states as tstates
from hyperspace_tpu_torch.advisor import routing as trouting
from hyperspace_tpu_torch.advisor.cost import CostModel as TCostModel
from hyperspace_tpu_torch.advisor.whatif import Recommendation as TRecommendation
from hyperspace_tpu_torch.advisor.whatif import WhatIfAnalyzer as TWhatIfAnalyzer
from hyperspace_tpu_torch.execution import device_cache as tdc
from hyperspace_tpu_torch.obs import metrics as tmetrics
from hyperspace_tpu_torch.signature import plan_signature as tplan_signature
from hyperspace_tpu_torch.utils import file_utils as tfile_utils


class _Pkg:
    """One package's advisor surface under the names the cases use."""

    def __init__(self, name):
        jax = name == "jax"
        self.name = name
        self.pkg = hjax if jax else htorch
        self.faults = jfaults if jax else tfaults
        self.states = jstates if jax else tstates
        self.metrics = jmetrics if jax else tmetrics
        self.routing = jrouting if jax else trouting
        self.CostModel = JCostModel if jax else TCostModel
        self.Recommendation = JRecommendation if jax else TRecommendation
        self.WhatIfAnalyzer = JWhatIfAnalyzer if jax else TWhatIfAnalyzer
        self.plan_signature = jplan_signature if jax else tplan_signature
        self.file_utils = jfile_utils if jax else tfile_utils
        self.kw = {} if jax else {"device": "cpu"}

    def session(self, system_path, num_buckets=8):
        return self.pkg.HyperspaceSession(system_path=str(system_path), num_buckets=num_buckets, **self.kw)


PKGS = {n: _Pkg(n) for n in ("jax", "torch")}
JAX, TORCH = PKGS["jax"], PKGS["torch"]


@pytest.fixture(params=tuple(PKGS))
def P(request):
    return PKGS[request.param]


@pytest.fixture(autouse=True)
def _clean():
    for p in PKGS.values():
        p.faults.reset()
    tdc.clear_all()
    yield
    for p in PKGS.values():
        p.faults.reset()


def _write(tmp_path, name, table: pa.Table, parts: int = 1):
    root = tmp_path / name
    root.mkdir()
    n = len(table)
    step = max(1, n // parts)
    for i in range(parts):
        pq.write_table(table.slice(i * step, step), root / f"p{i}.parquet")
    return root


def _hot_table(tmp_path, n=20_000, seed=7):
    rng = np.random.default_rng(seed)
    return _write(tmp_path, "hot", pa.table({
        "k": rng.integers(0, 500, n),
        "v": rng.standard_normal(n),
        "tag": pa.array([f"t{i % 37}" for i in range(n)]),
    }), parts=2)


def _cold_root(tmp_path, name="coldidx"):
    rng = np.random.default_rng(3)
    return _write(tmp_path, f"cold_{name}", pa.table({
        "x": rng.integers(0, 9, 1000),
        "y": rng.standard_normal(1000),
    }))


def _cold_index(P, session, tmp_path, name="coldidx"):
    root = _cold_root(tmp_path, name)
    P.pkg.Hyperspace(session).create_index(session.parquet(root), P.pkg.IndexConfig(name, ["x"], ["y"]))
    return root


def _fragment(P, session, hs, root, name="fragidx"):
    """`name` on `root`, then maxDeltas + 1 appended files each refreshed
    incrementally: one version dir more than maxDeltas allows."""
    hs.create_index(session.parquet(root), P.pkg.IndexConfig(name, ["k"], ["v"]))
    rng = np.random.default_rng(11)
    for i in range(session.conf.advisor_lifecycle_max_deltas + 1):
        pq.write_table(pa.table({
            "k": rng.integers(0, 500, 200),
            "v": rng.standard_normal(200),
            "tag": pa.array([f"d{i}"] * 200),
        }), root / f"delta{i}.parquet")
        hs.refresh_index(name, mode="incremental")


def _sorted_v(result):
    return np.sort(np.asarray(result.decode()["v"]))


# -- what-if -----------------------------------------------------------------

class TestWhatIf:
    def test_hot_predicate_earns_create_rec(self, P, tmp_path):
        session = P.session(tmp_path / "idx")
        root = _hot_table(tmp_path)
        df = session.parquet(root)
        session.enable_hyperspace()
        for i in range(6):
            session.run(df.filter(P.pkg.col("k") == (i * 17) % 500).select("k", "v"))
        recs = P.pkg.Hyperspace(session).recommend()
        creates = [r for r in recs if r.kind == "create"]
        assert creates, [r.to_json() for r in recs]
        rec = creates[0]
        assert rec.source_root == str(root)
        assert [c.lower() for c in rec.index_config.indexed_columns] == ["k"]
        assert "v" in [c.lower() for c in rec.index_config.included_columns]
        assert rec.estimated_benefit_s > 0
        assert 0.0 < rec.confidence <= 1.0
        assert rec.queries_matched == 6

    def test_never_hit_index_earns_drop_rec(self, P, tmp_path):
        session = P.session(tmp_path / "idx")
        _cold_index(P, session, tmp_path)
        df = session.parquet(_hot_table(tmp_path))
        session.enable_hyperspace()
        for i in range(4):
            session.run(df.filter(P.pkg.col("k") == i).select("k", "v"))
        drops = [r for r in P.pkg.Hyperspace(session).recommend() if r.kind == "drop"]
        assert [r.index_name for r in drops] == ["coldidx"]
        assert drops[0].estimated_benefit_s > 0

    def test_empty_workload_never_recommends_drops(self, P, tmp_path):
        session = P.session(tmp_path / "idx")
        _cold_index(P, session, tmp_path)
        assert P.pkg.Hyperspace(session).recommend() == []

    def test_covered_predicate_earns_no_create_rec(self, P, tmp_path):
        session = P.session(tmp_path / "idx")
        hs = P.pkg.Hyperspace(session)
        df = session.parquet(_hot_table(tmp_path))
        hs.create_index(df, P.pkg.IndexConfig("kidx", ["k"], ["v"]))
        session.enable_hyperspace()
        for i in range(5):
            session.run(df.filter(P.pkg.col("k") == i).select("k", "v"))
        recs = hs.recommend()
        assert not [r for r in recs if r.kind == "create"], [r.to_json() for r in recs]
        assert not [r for r in recs if r.kind == "drop"]

    def test_fragmented_index_earns_optimize_rec(self, P, tmp_path):
        session = P.session(tmp_path / "idx")
        hs = P.pkg.Hyperspace(session)
        root = _hot_table(tmp_path, n=4000)
        _fragment(P, session, hs, root)
        session.enable_hyperspace()
        session.run(session.parquet(root).filter(P.pkg.col("k") == 1).select("k", "v"))
        opts = [r for r in hs.recommend() if r.kind == "optimize"]
        assert [r.index_name for r in opts] == ["fragidx"]

    def test_mismatched_join_buckets_earn_rebucket_rec(self, P, tmp_path):
        session = P.session(tmp_path / "idx")
        hs = P.pkg.Hyperspace(session)
        facts, dims = _join_pair(P, session, hs, tmp_path)
        session.enable_hyperspace()
        for _ in range(3):
            session.run(facts.join(dims, ["fk"], ["dk"]))
        rb = [r for r in hs.recommend() if r.kind == "rebucket"]
        assert rb
        assert rb[0].index_name == "dim_by_dk"  # the smaller one re-buckets
        assert rb[0].num_buckets == 8

    def test_recommend_fault_point_fires(self, P, tmp_path):
        session = P.session(tmp_path / "idx")
        df = session.parquet(_hot_table(tmp_path, n=2000))
        session.run(df.filter(P.pkg.col("k") == 1).select("k", "v"))
        hs = P.pkg.Hyperspace(session)
        with P.faults.injected("advisor.recommend"):
            with pytest.raises(OSError):
                hs.recommend()
        assert isinstance(hs.recommend(), list)


def _join_pair(P, session, hs, tmp_path):
    """facts (8,000 rows, `fact_by_fk` at 8 buckets) and dims (200 rows,
    `dim_by_dk` at 4): a join the ranker cannot give its zero-exchange
    pair. Sources are written once; a second call reuses them."""
    rng = np.random.default_rng(13)
    lroot, rroot = tmp_path / "facts", tmp_path / "dims"
    if not lroot.exists():
        _write(tmp_path, "facts", pa.table({"fk": rng.integers(0, 200, 8000), "amt": rng.standard_normal(8000)}))
        _write(tmp_path, "dims", pa.table({"dk": np.arange(200, dtype=np.int64),
                                           "label": pa.array([f"d{i}" for i in range(200)])}))
    facts, dims = session.parquet(lroot), session.parquet(rroot)
    hs.create_index(facts, P.pkg.IndexConfig("fact_by_fk", ["fk"], ["amt"]))
    session.conf.num_buckets = 4  # the second index lands at a different count
    hs.create_index(dims, P.pkg.IndexConfig("dim_by_dk", ["dk"], ["label"]))
    session.conf.num_buckets = 8
    return facts, dims


# -- cost model --------------------------------------------------------------

class TestCostModel:
    def test_estimates_monotonic_in_bytes(self, P):
        m = P.CostModel()
        sizes = [0, 1, 10**3, 10**6, 10**9, 10**12]
        scans = [m.estimate_scan_s(b) for b in sizes]
        assert scans == sorted(scans)
        queries = [m.estimate_query_s(b, 3) for b in sizes]
        assert queries == sorted(queries)
        assert all(b >= 0 for b in scans + queries)

    def test_indexed_benefit_positive_and_monotonic(self, P):
        m = P.CostModel()
        benefits = [m.indexed_benefit_s(b, 8) for b in (10**6, 10**8, 10**10)]
        assert benefits == sorted(benefits)
        assert benefits[-1] > 0
        assert m.indexed_benefit_s(10**9, 64) >= m.indexed_benefit_s(10**9, 8)

    def test_fit_from_measured_profiles(self, P, tmp_path):
        session = P.session(tmp_path / "idx")
        df = session.parquet(_hot_table(tmp_path, n=8000))
        for i in range(3):
            session.run(df.filter(P.pkg.col("k") == i).select("k", "v"))
        m = P.CostModel.fit([r.profile for r in session.workload.snapshot()])
        assert m.samples >= 1
        assert m.scan_seconds_per_byte > 0
        assert m.estimate_scan_s(2e9) > m.estimate_scan_s(1e6)


# -- adaptive routing --------------------------------------------------------

class TestRouting:
    def _setup(self, P, tmp_path):
        session = P.session(tmp_path / "idx")
        hs = P.pkg.Hyperspace(session)
        df = session.parquet(_hot_table(tmp_path, n=5000))
        hs.create_index(df, P.pkg.IndexConfig("kidx", ["k"], ["v"]))
        session.conf.set("hyperspace.advisor.routing.enabled", True)
        return session, hs, df.filter(P.pkg.col("k") == 3).select("k", "v")

    def test_demotion_and_repromotion_on_mutation(self, P, tmp_path):
        session, hs, q = self._setup(P, tmp_path)
        sig = P.plan_signature(q)
        led = session.routing_ledger()
        session.disable_hyperspace()
        r_raw = session.run(q)
        session.enable_hyperspace()
        led.record(sig, "indexed", 10.0)  # the indexed path "measured" slower
        assert led.decide(sig) == "raw"
        r_routed = session.run(q)
        assert dict(session.last_query_stats)["advisor_routing"] == {"decision": "raw", "demoted": True}
        np.testing.assert_allclose(_sorted_v(r_routed), _sorted_v(r_raw))
        # Structural re-promotion: an index mutation moves the stamp.
        hs.refresh_index("kidx")
        assert led.decide(sig) == "indexed"
        session.run(q)
        st = dict(session.last_query_stats)
        assert st["advisor_routing"] == {"decision": "indexed", "demoted": False}

    def test_fast_indexed_path_keeps_its_plan(self, P, tmp_path):
        session, _, q = self._setup(P, tmp_path)
        sig = P.plan_signature(q)
        led = session.routing_ledger()
        led.record(sig, "raw", 1.0)
        led.record(sig, "indexed", 0.2)
        assert led.decide(sig) == "indexed"

    def test_ledger_persists_and_reloads(self, P, tmp_path):
        session, _, q = self._setup(P, tmp_path)
        sig = P.plan_signature(q)
        led = session.routing_ledger()
        led.record(sig, "raw", 1.0)
        led.record(sig, "indexed", 5.0)  # the verdict's flip persists at once
        assert led.path.exists()
        s2 = P.session(session.conf.system_path)
        s2.conf.set("hyperspace.advisor.routing.enabled", True)
        assert s2.routing_ledger().decide(sig) == "raw"

    def test_persist_failure_is_advisory(self, P, tmp_path, monkeypatch):
        session, _, q = self._setup(P, tmp_path)
        led = session.routing_ledger()

        def boom(path, obj, **kw):
            raise OSError("disk on fire")

        monkeypatch.setattr(P.file_utils, "write_json", boom)
        before = P.metrics.counter("advisor.routing.persist_failed").value
        led.record(P.plan_signature(q), "raw", 1.0)
        led.flush()  # both writes fail, neither raises
        assert P.metrics.counter("advisor.routing.persist_failed").value > before

    def test_explain_shows_routing_decision(self, P, tmp_path):
        session, hs, q = self._setup(P, tmp_path)
        sig = P.plan_signature(q)
        led = session.routing_ledger()
        session.enable_hyperspace()
        assert "Adaptive routing: indexed" in hs.explain(q)
        led.record(sig, "raw", 0.01)
        led.record(sig, "indexed", 10.0)
        assert "Adaptive routing: raw" in hs.explain(q)

    def test_underscore_dirs_invisible_to_catalog(self, P, tmp_path):
        session, _, _ = self._setup(P, tmp_path)
        session.routing_ledger().flush()
        names = [p.name for p in session.manager.path_resolver.list_index_paths()]
        assert "_advisor" not in names and "kidx" in names
        with pytest.raises(Exception):
            P.pkg.IndexConfig("_sneaky", ["k"])


# -- lifecycle ---------------------------------------------------------------

class TestLifecycle:
    def _workload(self, P, session, tmp_path, queries=6):
        df = session.parquet(_hot_table(tmp_path))
        session.enable_hyperspace()
        for i in range(queries):
            session.run(df.filter(P.pkg.col("k") == (i * 17) % 500).select("k", "v"))
        return df

    @staticmethod
    def _gates(session, vacuum=True):
        session.conf.set("hyperspace.advisor.lifecycle.autoCreate", True)
        if vacuum:
            session.conf.set("hyperspace.advisor.lifecycle.autoVacuum", True)
        session.conf.set("hyperspace.advisor.minConfidence", 0.1)

    def test_gates_off_sweep_applies_nothing(self, P, tmp_path):
        session = P.session(tmp_path / "idx")
        _cold_index(P, session, tmp_path)
        self._workload(P, session, tmp_path)
        report = P.pkg.Hyperspace(session).lifecycle().sweep()
        assert report["applied"] == [] and report["failed"] == []
        assert len(report["skipped"]) >= 2  # create + drop both gated off

    def test_auto_create_and_auto_vacuum(self, P, tmp_path):
        session = P.session(tmp_path / "idx")
        _cold_index(P, session, tmp_path)
        df = self._workload(P, session, tmp_path)
        self._gates(session)
        report = P.pkg.Hyperspace(session).lifecycle().sweep()
        kinds = [a["kind"] for a in report["applied"]]
        assert "create" in kinds and "drop" in kinds, report
        session.run(df.filter(P.pkg.col("k") == 17).select("k", "v"))
        assert session.workload.snapshot()[-1].used_indexes
        assert session.workload.snapshot()[-1].index_names
        every = session.manager.get_indexes(states_filter=tuple(P.states.ALL_STATES))
        cold = [e for e in every if e.name == "coldidx"]
        assert not cold or cold[0].state == P.states.DOESNOTEXIST

    def test_auto_optimize_compacts_fragmented(self, P, tmp_path):
        session = P.session(tmp_path / "idx")
        hs = P.pkg.Hyperspace(session)
        root = _hot_table(tmp_path, n=4000)
        _fragment(P, session, hs, root)
        session.enable_hyperspace()
        session.run(session.parquet(root).filter(P.pkg.col("k") == 1).select("k", "v"))
        session.conf.set("hyperspace.advisor.lifecycle.autoOptimize", True)
        report = hs.lifecycle().sweep()
        assert "optimize" in [a["kind"] for a in report["applied"]], report
        entry = next(e for e in session.manager.get_indexes() if e.name == "fragidx")
        assert len(entry.content.directories) == 1

    def test_apply_crash_is_crash_safe(self, P, tmp_path):
        """A CrashPoint at advisor.apply: the sweep dies before mutating,
        recover() has nothing to roll, and a later sweep does the work."""
        session = P.session(tmp_path / "idx")
        hs = P.pkg.Hyperspace(session)
        _cold_index(P, session, tmp_path)
        df = self._workload(P, session, tmp_path)
        self._gates(session)
        with P.faults.injected("advisor.apply", crash=True):
            with pytest.raises(P.faults.CrashPoint):
                hs.lifecycle().sweep()
        assert all(not r["rolled"] for r in hs.recover().values())
        assert hs.lifecycle().sweep()["applied"]
        session.run(df.filter(P.pkg.col("k") == 17).select("k", "v"))
        assert session.workload.snapshot()[-1].used_indexes

    def test_apply_crash_mid_create_recovers(self, P, tmp_path):
        """A CrashPoint inside the auto-created index's build: the
        transient entry rolls back through recover() and queries run."""
        session = P.session(tmp_path / "idx")
        hs = P.pkg.Hyperspace(session)
        df = self._workload(P, session, tmp_path)
        self._gates(session, vacuum=False)
        with P.faults.injected("log.write", crash=True, at_call=1):
            with pytest.raises(P.faults.CrashPoint):
                hs.lifecycle().sweep()
        hs.recover()
        assert session.run(df.filter(P.pkg.col("k") == 17).select("k", "v")).num_rows >= 0

    def test_apply_transient_fault_recorded_not_fatal(self, P, tmp_path):
        session = P.session(tmp_path / "idx")
        self._workload(P, session, tmp_path)
        self._gates(session, vacuum=False)
        with P.faults.injected("advisor.apply"):
            with pytest.raises(OSError):
                P.pkg.Hyperspace(session).lifecycle().sweep()

    def test_rebucket_is_report_only(self, P, tmp_path):
        session = P.session(tmp_path / "idx")
        for gate in ("autoCreate", "autoVacuum", "autoOptimize"):
            session.conf.set(f"hyperspace.advisor.lifecycle.{gate}", True)
        rec = P.Recommendation(kind="rebucket", estimated_benefit_s=99.0, confidence=1.0, reason="test",
                               index_name="whatever", num_buckets=64)
        report = P.pkg.Hyperspace(session).lifecycle().sweep([rec])
        assert report["applied"] == [] and len(report["skipped"]) == 1


# -- workload log ------------------------------------------------------------

class TestWorkload:
    def test_records_are_bounded_and_accurate(self, P, tmp_path):
        session = P.session(tmp_path / "idx")
        df = session.parquet(_hot_table(tmp_path, n=3000))
        P.pkg.Hyperspace(session).create_index(df, P.pkg.IndexConfig("kidx", ["k"], ["v"]))
        session.enable_hyperspace()
        q = df.filter(P.pkg.col("k") == 3).select("k", "v")
        session.run(q)
        rec = session.workload.snapshot()[-1]
        assert rec.signature == P.plan_signature(q)
        assert rec.used_indexes and rec.index_names == ("kidx",)
        assert rec.total_s > 0 and rec.bytes_scanned >= 0
        session.disable_hyperspace()
        session.run(q)
        rec = session.workload.snapshot()[-1]
        assert not rec.used_indexes and rec.index_names == ()

    def test_ring_is_bounded(self, P, tmp_path):
        session = P.session(tmp_path / "idx")
        session.conf.set("hyperspace.advisor.workload.maxRecords", 4)
        assert session.workload._records.maxlen == 4


# -- parity with the JAX package ------------------------------------------------


def _plans(P, session, tmp_path):
    """The same plans built in `P`'s package: lookups, a range, an
    aggregate, a join and an aggregate over it."""
    col, lit = P.pkg.col, P.pkg.lit
    df = session.parquet(tmp_path / "hot")
    facts, dims = session.parquet(tmp_path / "facts"), session.parquet(tmp_path / "dims")
    plans = [df.filter(col("k") == k).select("k", "v") for k in (3, 17, 499)]
    plans.append(df.filter((col("k") >= lit(10)) & (col("k") < lit(40))).select("k", "v", "tag"))
    plans.append(df.aggregate(["tag"], [("sum", "v", "sv"), ("count", None, "n")]))
    plans.append(facts.join(dims, ["fk"], ["dk"]))
    plans.append(facts.join(dims, ["fk"], ["dk"]).aggregate(["label"], [("sum", "amt", "s")]))
    return plans


def test_signatures_and_decisions_equal_across_packages(tmp_path):
    """The same plans sign alike in both packages, both collections stamp
    alike over one store, and the same seeded walls give the same routing
    decision after every record."""
    _hot_table(tmp_path)
    j_session = JAX.session(tmp_path / "idx")
    _join_pair(JAX, j_session, hjax.Hyperspace(j_session), tmp_path)
    t_session = TORCH.session(tmp_path / "idx")
    sigs = [JAX.plan_signature(p) for p in _plans(JAX, j_session, tmp_path)]
    assert sigs == [TORCH.plan_signature(p) for p in _plans(TORCH, t_session, tmp_path)]
    assert len(set(sigs)) == len(sigs)
    assert jrouting.collection_stamp(j_session) == trouting.collection_stamp(t_session)
    rng = np.random.default_rng(5)
    for s in (j_session, t_session):
        s.conf.set("hyperspace.advisor.routing.minSamples", 2)
        s.conf.set("hyperspace.advisor.routing.alpha", 0.3)
    leds = (j_session.routing_ledger(), t_session.routing_ledger())
    for _ in range(120):
        sig = sigs[int(rng.integers(0, len(sigs)))]
        mode = "indexed" if rng.random() < 0.5 else "raw"
        wall = float(rng.lognormal(-4.0, 1.0))
        for led in leds:
            led.record(sig, mode, wall)
        assert leds[0].decide(sig) == leds[1].decide(sig)
    assert leds[0].snapshot() == leds[1].snapshot()
    assert leds[0].demoted_signatures() == leds[1].demoted_signatures()
    assert leds[0].demoted_signatures()  # some signatures were demoted


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_routing_json_is_read_across_packages(tmp_path, writer):
    """A ledger one package persists is the other's: the same entries, the
    same stamp, the same decisions; a routed run of the reader demotes."""
    reader = "torch" if writer == "jax" else "jax"
    W, R = PKGS[writer], PKGS[reader]
    w_session = W.session(tmp_path / "idx")
    df = w_session.parquet(_hot_table(tmp_path, n=5000))
    W.pkg.Hyperspace(w_session).create_index(df, W.pkg.IndexConfig("kidx", ["k"], ["v"]))
    q = df.filter(W.pkg.col("k") == 3).select("k", "v")
    sig = W.plan_signature(q)
    led = w_session.routing_ledger()
    led.record(sig, "raw", 0.01)
    led.record(sig, "indexed", 0.5)
    led.record("other", "indexed", 0.1)
    led.flush()
    r_session = R.session(tmp_path / "idx")
    r_session.conf.set("hyperspace.advisor.routing.enabled", True)
    r_led = r_session.routing_ledger()
    assert r_led.snapshot() == led.snapshot()
    assert r_led.decide(sig) == "raw" and r_led.decide("other") == "indexed"
    r_session.enable_hyperspace()
    r_q = r_session.parquet(tmp_path / "hot").filter(R.pkg.col("k") == 3).select("k", "v")
    r_session.run(r_q)
    assert r_session.last_query_stats["advisor_routing"] == {"decision": "raw", "demoted": True}


def _rec_key(r) -> tuple:
    cfg = r.index_config
    return (r.kind, r.index_name, r.source_root, r.num_buckets, r.queries_matched,
            None if cfg is None else (cfg.index_name, tuple(cfg.indexed_columns), tuple(cfg.included_columns)))


def test_recommendations_equal_across_packages(tmp_path):
    """One store (indexes built by the JAX package and by the port), one
    workload run in each package: the records sign and name their indexes
    alike; given the JAX package's bytes and walls and one fitted cost
    model, both analyzers return the same ranked create / drop /
    rebucket / optimize recommendations."""
    root = _hot_table(tmp_path)
    frag_root = _write(tmp_path, "frag", pq.read_table(root / "p0.parquet").slice(0, 4000))
    j_session, t_session = JAX.session(tmp_path / "idx"), TORCH.session(tmp_path / "idx")
    j_hs, t_hs = hjax.Hyperspace(j_session), htorch.Hyperspace(t_session)
    _cold_index(JAX, j_session, tmp_path)
    _join_pair(TORCH, t_session, t_hs, tmp_path)
    _fragment(JAX, j_session, j_hs, frag_root)
    records = {}
    for P, session in ((JAX, j_session), (TORCH, t_session)):
        session.enable_hyperspace()
        for plan in _plans(P, session, tmp_path):
            session.run(plan)
        session.run(session.parquet(frag_root).filter(P.pkg.col("k") == 1).select("k", "v"))
        records[P.name] = session.workload.snapshot()
    jrecs, trecs = records["jax"], records["torch"]
    assert [(r.signature, r.index_names, r.used_indexes) for r in jrecs] == \
        [(r.signature, r.index_names, r.used_indexes) for r in trecs]
    for j, t in zip(jrecs, trecs):
        t.bytes_scanned, t.total_s = j.bytes_scanned, j.total_s
    fitted = JCostModel.fit(r.profile for r in jrecs)
    j_out = JWhatIfAnalyzer(j_session, cost_model=fitted).recommend(jrecs)
    t_out = TWhatIfAnalyzer(t_session, cost_model=TCostModel(**fitted.to_json())).recommend(trecs)
    assert {r.kind for r in j_out} == {"create", "drop", "rebucket", "optimize"}, [r.to_json() for r in j_out]
    assert [_rec_key(r) for r in t_out] == [_rec_key(r) for r in j_out]
    for j, t in zip(j_out, t_out):
        assert t.estimated_benefit_s == pytest.approx(j.estimated_benefit_s, rel=1e-12, abs=1e-15)
        assert t.confidence == pytest.approx(j.confidence, rel=1e-12)
        assert t.to_json() == j.to_json()


def test_auto_created_index_is_byte_identical_to_the_jax_packages(tmp_path):
    """The same workload in each package, each over its own store, then a
    sweep with autoCreate: the created index's bucket files and its log's
    index columns are the JAX package's, byte for byte."""
    _hot_table(tmp_path)
    made = {}
    for P in (JAX, TORCH):
        session = P.session(tmp_path / f"idx_{P.name}")
        df = session.parquet(tmp_path / "hot")
        session.enable_hyperspace()
        for i in range(6):
            session.run(df.filter(P.pkg.col("k") == (i * 17) % 500).select("k", "v"))
        session.conf.set("hyperspace.advisor.lifecycle.autoCreate", True)
        report = P.pkg.Hyperspace(session).lifecycle().sweep()
        assert [a["kind"] for a in report["applied"]] == ["create"], report
        made[P.name] = (report["applied"][0]["index_config"], tmp_path / f"idx_{P.name}")
    assert made["jax"][0] == made["torch"][0]
    name = made["jax"][0]["name"]
    j_files = sorted(made["jax"][1].glob(f"{name}/v__=*/*.parquet"))
    t_files = sorted(made["torch"][1].glob(f"{name}/v__=*/*.parquet"))
    assert j_files and [f.relative_to(made["jax"][1]) for f in j_files] == \
        [f.relative_to(made["torch"][1]) for f in t_files]
    for a, b in zip(j_files, t_files):
        assert a.read_bytes() == b.read_bytes(), a.name


@pytest.mark.parametrize("crasher", ["jax", "torch"])
def test_a_crash_mid_auto_create_is_recovered_by_the_other_package(tmp_path, crasher):
    """The sweep of one package dies inside the auto-created index's log
    write; the other package's recover() rolls the transient entry back,
    its own sweep then builds the index, and its lookup uses it."""
    C = PKGS[crasher]
    R = PKGS["torch" if crasher == "jax" else "jax"]
    _hot_table(tmp_path)
    c_session = C.session(tmp_path / "idx")
    df = c_session.parquet(tmp_path / "hot")
    c_session.enable_hyperspace()
    for i in range(6):
        c_session.run(df.filter(C.pkg.col("k") == (i * 17) % 500).select("k", "v"))
    c_session.conf.set("hyperspace.advisor.lifecycle.autoCreate", True)
    with C.faults.injected("log.written", crash=True, at_call=1):
        with pytest.raises(C.faults.CrashPoint):
            C.pkg.Hyperspace(c_session).lifecycle().sweep()
    r_session = R.session(tmp_path / "idx")
    r_hs = R.pkg.Hyperspace(r_session)
    reports = r_hs.recover()
    assert any(r["rolled"] for r in reports.values()), reports
    assert r_session.manager.get_indexes() == []
    r_df = r_session.parquet(tmp_path / "hot")
    r_session.enable_hyperspace()
    for i in range(6):
        r_session.run(r_df.filter(R.pkg.col("k") == (i * 17) % 500).select("k", "v"))
    r_session.conf.set("hyperspace.advisor.lifecycle.autoCreate", True)
    assert [a["kind"] for a in r_hs.lifecycle().sweep()["applied"]] == ["create"]
    r_session.run(r_df.filter(R.pkg.col("k") == 17).select("k", "v"))
    assert r_session.workload.snapshot()[-1].index_names == ("adv_hot_k",)


def test_importing_the_advisor_loads_no_jax():
    code = ("import sys; import hyperspace_tpu_torch.advisor, hyperspace_tpu_torch.hyperspace; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'hyperspace_tpu.')) "
            "or m == 'hyperspace_tpu']; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=Path(__file__).resolve().parents[1])


def test_advisor_keys_are_ported_and_ingest_keys_still_raise(tmp_path):
    from hyperspace_tpu_torch.config import PORTED_KEYS, UNPORTED_KEYS

    moved = [k for k in PORTED_KEYS if k.startswith("hyperspace.advisor.")] + [
        "hyperspace.controller.demotionClusterSize", "hyperspace.controller.demotionWindowSeconds",
        "hyperspace.controller.stormResponse"]
    assert len(moved) == 14 and set(moved) <= set(PORTED_KEYS)
    port, ref = TORCH.session(tmp_path), JAX.session(tmp_path)
    for key in moved:
        assert port.conf.get(key) == ref.conf.get(key), key
    port.conf.set("hyperspace.advisor.routing.demoteRatio", "2.5")
    port.conf.set("hyperspace.controller.stormResponse", "false")
    assert (port.conf.advisor_routing_demote_ratio, port.conf.controller_storm_response) == (2.5, False)
    assert UNPORTED_KEYS == {k for k in UNPORTED_KEYS if k.startswith("hyperspace.ingest.") or k.endswith(
        ("venue", "venueMinMbps", "fusedKernels"))}
    for key in sorted(UNPORTED_KEYS):
        with pytest.raises(htorch.HyperspaceError, match="not ported yet"):
            port.conf.set(key, "1")

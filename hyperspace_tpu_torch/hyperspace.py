"""User facade and session integration.

Reference parity: com/microsoft/hyperspace/Hyperspace.scala:24-133 (user
APIs delegating to the collection manager) and package.scala:34-77
(enable/disable toggling the optimizer rule batch). `HyperspaceSession`
owns the configuration, the device and the enable/disable switch;
`session.run(plan)` is the query entry point that applies the rewrite
rules when enabled.

A port of the JAX package's `hyperspace.py` (`HyperspaceSession.parquet /
enable_hyperspace / disable_hyperspace / run / to_pandas` and the
`Hyperspace` facade: `create_index`, `create_vector_index`, `ann_search`
and the lifecycle — `delete_index`, `restore_index`, `vacuum_index`,
`refresh_index(name, mode)`, `optimize_index`, `cancel`, `recover`,
`indexes` and `explain`), with `run_query(plan, plan_cache=)`,
`QueryOutcome`, `last_profile()` and `serve()`. The session runs on the
CUDA card unless the caller passes `device="cpu"`.
`last_query_stats` reports what ran: the scan kind (`HybridScanFilter`
for a filter over a hybrid scan), files read or pruned, rows pruned by a
range slice or a join's dynamic partition pruning and whether a range
slice was exact, the aggregate path, for a join its path
(`zero-exchange-aligned`, `single-partition`, `broadcast-hash`,
`rebucketized-aligned` or `bucket-preserved-aligned`; `join_paths` lists
every join's), kernel, exchange kernel and bucket count, and the host's
seconds by step (`host_s`: plan, read, derive, execute). Decoded columns
and derived arrays are cached per process (execution/device_cache.py).
With `hyperspace.index.hybridscan.enabled`, an index whose source has
gained files still serves, through a hybrid scan of the index and the
appended files.

Every query yields its executed physical plan and a profile
(obs/profile.py); `session.serve()` builds the concurrent QueryServer
(serve/scheduler.py). `run_query` is safe to call from many threads: a
query's state lives in its QueryOutcome, and the session's view of the
most recent one (`last_query_stats`, `last_optimized_plan`,
`last_physical_plan`, `last_profile()`) is installed under one lock
(`_publish`). Profile and span times are host walls; with
`run(plan, profile_dir=...)` the query runs under `torch.profiler`, whose
Chrome trace holds the card's own times.

Corruption fallback (`hyperspace.fallback.enabled`, default on): when an
index scan hits unreadable index data mid-query (a typed
`IndexCorruptionError` naming the index), the failing index is
quarantined in `session.index_health` and the query re-plans, first
through the remaining healthy indexes, then, if corruption persists or
has no provenance, straight against the source. The query answers either
way; `QueryOutcome.replans` counts the re-plans, the stats'
`degraded_indexes` name the quarantined roots, the `fallback.queries`
counter and the `fallback.replan` / `index.quarantined` events record
it. The quarantine is sticky for the session until a refresh, optimize
or `recover()` lifts it.

The advisor (advisor/): every `run_query` appends a `WorkloadRecord` to
the session's bounded `workload` log. With
`hyperspace.advisor.routing.enabled`, `run_query` first asks the routing
ledger (`routing_ledger()`) for the plan signature's route: a signature
whose indexed path measured slower than its raw path (EMAs, both sides
sampled) runs against the source (`advisor.routing.demoted`), and the
measured wall is folded back into the ledger; the stats' `advisor_routing`
holds the decision. `Hyperspace.recommend()` and `.lifecycle()` give the
what-if analyzer's recommendations and the opt-in policy that applies
them.

Continuous ingestion (ingest/): `session.pin_snapshot()` captures every
active index's latest stable entry; `run(..., snapshot=)` and
`run_query(..., snapshot=)` then read that world repeatably while
micro-batches commit underneath (`ingest.pinned_reads`).
`Hyperspace.ingest()` builds the daemon that tails, commits and compacts.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import os
import threading
import time
from pathlib import Path

import torch

from hyperspace_tpu_torch import stats as _stats
from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.dataset import Dataset
from hyperspace_tpu_torch.device import resolve_device
from hyperspace_tpu_torch.exceptions import HyperspaceError, IndexCorruptionError
from hyperspace_tpu_torch.index.collection_manager import CachingIndexCollectionManager
from hyperspace_tpu_torch.index.index_config import IndexConfig
from hyperspace_tpu_torch.obs import events as obs_events
from hyperspace_tpu_torch.obs import trace as obs_trace
from hyperspace_tpu_torch.parallel.mesh import mesh_size, normalize_device
from hyperspace_tpu_torch.plan.nodes import LogicalPlan, Scan
from hyperspace_tpu_torch.plan.prune import prune_columns
from hyperspace_tpu_torch.plan.pushdown import push_down_filters
from hyperspace_tpu_torch.rules.base import apply_rules


_profile_seq = itertools.count(1)

# The query plane's degradations as structured events (obs/events.py),
# each carrying the active trace id.
_EVT_FALLBACK = obs_events.declare("fallback.replan")
_EVT_QUARANTINED = obs_events.declare("index.quarantined")
_EVT_DEMOTED = obs_events.declare("advisor.routing.demoted")


@dataclasses.dataclass
class QueryOutcome:
    """Everything one query produced, owned by the caller rather than
    the session: the result (a ColumnTable), the executor's stats, the
    optimized plan that ran, the executed physical plan and the query's
    profile. `run` publishes one into the session's view
    (`_publish`); `run_query` does not. `replans` counts the corruption
    fallback's re-plans; `used_indexes` is false when the session's
    switch is off or the fallback turned indexes off for the query."""

    result: object
    stats: dict
    optimized_plan: LogicalPlan
    physical_plan: object = None
    profile: object = None
    replans: int = 0
    used_indexes: bool = True


class HyperspaceSession:
    """The engine session: configuration + device + rule toggle.

    Thread-safety: `run_query()` may be called from N threads (the
    serving plane does exactly that). Each query's state lives in its
    QueryOutcome; the session view and the lazy manager are guarded by
    one reentrant lock."""

    def __init__(
        self,
        system_path: str | None = None,
        num_buckets: int | None = None,
        mesh=None,
        device: "str | torch.device | None" = None,
    ):
        kwargs = {}
        if system_path is not None:
            kwargs["system_path"] = str(system_path)
        if num_buckets is not None:
            kwargs["num_buckets"] = int(num_buckets)
        self.conf = HyperspaceConf(**kwargs)
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
        else:
            # Tables live on the mesh's first device; the others are shards.
            self.device = mesh.devices[0]
            if device is not None and normalize_device(resolve_device(device)) != self.device:
                raise HyperspaceError(f"the session's device {device} is not the mesh's first device {self.device}")
        self._enabled = False
        self._manager: CachingIndexCollectionManager | None = None
        self._last_writer = None
        # Guards the session view below and the lazy manager.
        self._state_lock = threading.RLock()
        # Executed-plan evidence of the most recent run().
        self.last_query_stats: dict = {}
        self.last_optimized_plan: LogicalPlan | None = None
        self.last_physical_plan = None
        self._last_profile = None
        # Per-index health map (index root -> failure record). An index
        # that served corrupt data is quarantined from the rewrite rules
        # for the rest of the session; queries fall back to the healthy
        # indexes or the source. A refresh, optimize or recover() lifts it.
        # Mutations go through _state_lock.
        self.index_health: dict[str, dict] = {}
        # The advisor: the bounded workload ring every run_query appends
        # to, and the routing ledger; both built at first use.
        self._workload = None
        self._routing = None

    # -- rule toggle (package.scala:46-70) --------------------------------
    def enable_hyperspace(self) -> "HyperspaceSession":
        self._enabled = True
        return self

    def disable_hyperspace(self) -> "HyperspaceSession":
        self._enabled = False
        return self

    def is_hyperspace_enabled(self) -> bool:
        return self._enabled

    # -- wiring -----------------------------------------------------------
    @property
    def manager(self) -> CachingIndexCollectionManager:
        if self._manager is None:
            with self._state_lock:
                if self._manager is None:

                    def writer_factory():
                        from hyperspace_tpu_torch.execution.builder import DeviceIndexBuilder

                        self._last_writer = DeviceIndexBuilder(
                            self.device,
                            mesh=self.mesh,
                            memory_budget_bytes=self.conf.build_memory_budget_bytes,
                            chunk_bytes=self.conf.build_chunk_bytes or None,
                            pipeline_enabled=self.conf.build_pipeline_enabled,
                            pipeline_max_inflight_bytes=self.conf.build_pipeline_max_inflight_bytes,
                            workers=self.conf.build_workers,
                            exchange_dir=self.conf.build_exchange_dir or None,
                            venue=self.conf.build_venue,
                        )
                        return self._last_writer

                    def vector_builder_factory():
                        from hyperspace_tpu_torch.vector.index import VectorIndexBuilder

                        self._last_writer = VectorIndexBuilder(self.device)
                        return self._last_writer

                    self._manager = CachingIndexCollectionManager(self.conf, writer_factory, vector_builder_factory)
        return self._manager

    @property
    def workload(self):
        """The session's bounded workload log: one
        :class:`~hyperspace_tpu_torch.advisor.workload.WorkloadRecord` per
        run_query, the advisor's learning input."""
        if self._workload is None:
            with self._state_lock:
                if self._workload is None:
                    from hyperspace_tpu_torch.advisor.workload import WorkloadLog

                    self._workload = WorkloadLog(self.conf.advisor_workload_max_records)
        return self._workload

    def routing_ledger(self):
        """The adaptive-routing outcome ledger (advisor/routing.py),
        built at first use; sessions that never enable
        ``hyperspace.advisor.routing.enabled`` still get a readable view
        of it for reports."""
        if self._routing is None:
            with self._state_lock:
                if self._routing is None:
                    from hyperspace_tpu_torch.advisor.routing import RoutingLedger

                    self._routing = RoutingLedger(self)
        return self._routing

    @property
    def last_build_stats(self) -> dict:
        """Stats of the most recent index build in this session, including
        the path and the per-phase wall times (a covering index in memory:
        decode / hash_lanes / partition_sort / carve_encode_write;
        streaming: p1_decode_hash_spill / p1_decode_wait /
        p2_sort_encode_write; pooled: the two phases; a vector index: read
        / kmeans / assign / carve)."""
        return dict(getattr(self._last_writer, "last_build_stats", {}) or {})

    # -- data access ------------------------------------------------------
    def parquet(self, root: str | Path) -> Scan:
        """Register a parquet dataset and return its scan plan."""
        return Dataset.parquet(root).scan()

    def orc(self, root: str | Path) -> Scan:
        return Dataset.orc(root).scan()

    def csv(self, root: str | Path) -> Scan:
        return Dataset.csv(root).scan()

    def json(self, root: str | Path) -> Scan:
        """Register a line-delimited JSON dataset."""
        return Dataset.json(root).scan()

    def optimized_plan(self, plan: LogicalPlan, snapshot=None) -> LogicalPlan:
        if not self._enabled:
            return plan
        # Predicate pushdown and column pruning FIRST (the analog of Spark
        # running PushDownPredicate/ColumnPruning before the
        # extraOptimizations batch): side-local filters reach the join
        # sides, where the index rules cover them, and scans narrow to
        # what the query needs, which is what index coverage is checked
        # against. A pinned read (ingest/snapshot.py) takes its candidate
        # set from the entries captured at admission, not the live
        # listing: versions a concurrent micro-batch commits are invisible.
        indexes = snapshot.entries() if snapshot is not None else self.manager.get_indexes()
        with self._state_lock:
            unhealthy = set(self.index_health)
        if unhealthy:
            # Indexes that served corrupt data are out of the candidate
            # set until lifted: degradation is sticky per session, not
            # re-discovered (and re-failed) on every query.
            indexes = [e for e in indexes if str(Path(e.content.root)) not in unhealthy]
        return apply_rules(prune_columns(push_down_filters(plan)), indexes, conf=self.conf)

    def run(self, plan: LogicalPlan, profile_dir: str | Path | None = None, snapshot=None):
        """Execute a plan (rewriting through indexes when enabled);
        returns a ColumnTable on the session's device. With `profile_dir`,
        the query runs under one `torch.profiler.profile` (the card's
        activity too, on the card) and its Chrome trace (`*.json`) is
        written there: the card's own times, which no span or profile
        wall holds. With `snapshot` (a PinnedSnapshot from
        :meth:`pin_snapshot`), the read repeats against the pinned version
        stamp whatever commits concurrently."""
        outcome = self.run_query(plan, profile_dir=profile_dir, snapshot=snapshot)
        self._publish(outcome)
        return outcome.result

    def pin_snapshot(self):
        """Pin a repeatable-read view of the collection at the current
        per-index version stamp (ingest/snapshot.py). Pass the handle to
        `run(..., snapshot=snap)`; release it, or use it as a context
        manager, when done."""
        from hyperspace_tpu_torch.ingest.snapshot import PinnedSnapshot

        return PinnedSnapshot(self)

    def run_query(self, plan: LogicalPlan, profile_dir: str | Path | None = None, plan_cache=None,
                  snapshot=None) -> QueryOutcome:
        """Execute a plan into a QueryOutcome without touching the
        session's view: the concurrency-safe entry point the serving
        plane uses. `plan_cache` (a serve.PlanCache) memoizes
        `optimized_plan` per versioned plan key while hyperspace is
        enabled. The outcome's stats carry the host's seconds by step
        (`host_s`): plan (the rewrite or a cache hit), read (decoded
        columns: the device cache, or parquet), derive (derived arrays:
        their cache, or the derivation) and execute (everything after
        planning, read and derive included; the device's work is not
        waited for). The query is one `query` trace (`plan.optimize`,
        `rule.*`, `execute.*`, `io.read`, `device.kernel` spans) when
        `hyperspace.obs.enabled`. With `hyperspace.advisor.routing.enabled`
        the routing ledger decides first whether the plan runs indexed or
        against its source, and the query's wall is recorded under the
        route it took (stats' `advisor_routing`). With `snapshot`, every raw
        source leaf is pinned to the snapshot's file lists before planning,
        the candidate indexes are the pinned entries and the plan cache and
        the routing ledger key on the snapshot's stamp."""
        from hyperspace_tpu_torch.advisor.workload import WorkloadRecord, used_index_names
        from hyperspace_tpu_torch.execution import device_cache
        from hyperspace_tpu_torch.execution.executor import Executor
        from hyperspace_tpu_torch.obs import profile as obs_profile
        from hyperspace_tpu_torch.signature import plan_signature

        cache_before = self._cache_counts()
        if snapshot is not None:
            # Pinned before planning: the rewrite rules then exact-match the
            # pinned entries and a raw fallback scans the pinned files.
            plan = snapshot.pin_plan(plan)
            _stats.increment("ingest.pinned_reads")
        replans = 0
        use_indexes = True
        # The plan's structural signature keys both the workload record and
        # the routing ledger. Routing (opt-in) consults measured history
        # before planning: a signature whose indexed path measured slower
        # than raw runs straight against the source.
        sig = plan_signature(plan)
        routed = routing_stamp = ledger = None
        if self.conf.advisor_routing_enabled:
            from hyperspace_tpu_torch.advisor.routing import collection_stamp, snapshot_stamp

            ledger = self.routing_ledger()
            # A pinned query keys the ledger on its own read point: the live
            # stamp moves under commits the pinned view cannot see, and a
            # moved stamp empties the ledger.
            routing_stamp = snapshot_stamp(snapshot) if snapshot is not None else collection_stamp(self)
            if self._enabled:
                routed = ledger.decide(sig, stamp=routing_stamp)
                if routed == "raw":
                    use_indexes = False
                    obs_trace.event("advisor.routing.demoted", signature=sig)
                    _EVT_DEMOTED.emit(signature=sig)
        t0 = time.perf_counter()
        plan_s = 0.0
        with obs_trace.trace("query") as root_span:
            while True:
                tp = time.perf_counter()
                with obs_trace.span("plan.optimize", indexes_enabled=self._enabled):
                    if not use_indexes:
                        optimized = plan
                    elif plan_cache is not None and self._enabled:
                        optimized = plan_cache.get_or_optimize(self, plan, snapshot=snapshot)
                    else:
                        optimized = self.optimized_plan(plan, snapshot=snapshot)
                    if use_indexes and self._enabled and self.conf.scan_prefetch_enabled:
                        # The query-tail prefetch: footers and the first
                        # chunk of the index files the pruner keeps start
                        # loading on a background pool now (advisory).
                        from hyperspace_tpu_torch.execution import prefetch

                        prefetch.prefetch_plan(optimized)
                t1 = time.perf_counter()
                plan_s += t1 - tp
                derive0 = device_cache.derive_seconds()
                executor = Executor(self.device, self.conf, mesh=self.mesh)
                try:
                    if profile_dir is not None:
                        result = self._profiled(executor, optimized, Path(profile_dir))
                    else:
                        result = executor.execute(optimized)
                    break
                except IndexCorruptionError as e:
                    if not (self._enabled and use_indexes and self.conf.fallback_enabled):
                        raise
                    if not self._quarantine(e):
                        # No provenance to quarantine by, or quarantining
                        # it did not help: indexes go off for this query,
                        # so the loop ends.
                        use_indexes = False
                    replans += 1
        total_s = time.perf_counter() - t0
        with self._state_lock:
            degraded = sorted(self.index_health)
        stats = executor.stats
        # The host's seconds by step: plan over every attempt, the rest
        # for the attempt that answered.
        stats["host_s"] = {
            "plan": plan_s,
            "read": stats.pop("read_s"),
            "derive": device_cache.derive_seconds() - derive0,
            "execute": time.perf_counter() - t1,
        }
        if degraded:
            stats["degraded_indexes"] = degraded
        used = self._enabled and use_indexes
        if ledger is not None:
            # The measured outcome folds back into the ledger (an EMA a
            # signature a route): the demotion evidence of later runs.
            mode = "indexed" if used else "raw"
            ledger.record(sig, mode, total_s, stamp=routing_stamp)
            stats["advisor_routing"] = {"decision": mode, "demoted": routed == "raw"}
        cache_after = self._cache_counts()
        profile = obs_profile.build_profile(
            total_s=total_s,
            physical_plan=executor.physical_plan,
            stats=stats,
            venue=self._venue_info(),
            cache={k: cache_after[k] - cache_before[k] for k in cache_after},
            fallback={"replans": replans, "degraded_indexes": degraded, "used_indexes": used},
            trace_root=root_span if isinstance(root_span, obs_trace.Span) else None,
        )
        self.workload.record(WorkloadRecord(
            signature=sig,
            plan=plan,
            total_s=total_s,
            bytes_scanned=int(stats.get("bytes_scanned", 0) or 0),
            used_indexes=used,
            index_names=used_index_names(optimized),
            profile=profile,
            routed=routed,
        ))
        return QueryOutcome(result, stats, optimized, executor.physical_plan, profile, replans, used)

    def _quarantine(self, e: IndexCorruptionError) -> bool:
        """Record the index an `IndexCorruptionError` names as unhealthy,
        count the re-plan (`fallback.queries`, `fallback.replan`; the
        first failure of a root also emits `index.quarantined`). True when
        the root was newly quarantined, so a re-plan through the other
        indexes can help."""
        root = str(Path(e.index_root)) if e.index_root is not None else None
        with self._state_lock:
            newly = root is not None and root not in self.index_health
            if root is not None:
                self.index_health[root] = {"reason": e.msg, "path": e.path}
        _stats.increment("fallback.queries")
        obs_trace.event("fallback.replan", index=root, reason=e.msg)
        _EVT_FALLBACK.emit(index=root, reason=e.msg)
        if newly:
            _EVT_QUARANTINED.emit(index=root, reason=e.msg)
        logging.getLogger("hyperspace_tpu_torch").warning(
            "index data unreadable (%s); re-planning query against source", e.msg
        )
        return newly

    def _profiled(self, executor, optimized: LogicalPlan, profile_dir: Path):
        """`executor.execute(optimized)` under torch.profiler; the Chrome
        trace goes to `profile_dir`. On the card the run ends in a
        synchronize, so the trace holds all of its kernels."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            result = executor.execute(optimized)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        profile_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(profile_dir / f"query-{os.getpid()}-{next(_profile_seq)}.json"))
        return result

    def _publish(self, outcome: QueryOutcome) -> None:
        """Install a finished query's outcome as the session view in one
        locked step, so a reader never sees the stats of one query next
        to the profile of another."""
        with self._state_lock:
            self.last_query_stats = outcome.stats
            self.last_optimized_plan = outcome.optimized_plan
            self.last_physical_plan = outcome.physical_plan
            self._last_profile = outcome.profile

    @staticmethod
    def _cache_counts() -> dict:
        """Hit and miss counts of the decoded-column entries (`table`),
        the whole device cache and the derived cache."""
        from hyperspace_tpu_torch.execution.device_cache import DEVICE_CACHE, HOST_DERIVED

        d, h = DEVICE_CACHE.stats(), HOST_DERIVED.stats()
        col = d["by_kind"].get("col", {"hits": 0, "misses": 0})
        return {
            "table_hits": col["hits"], "table_misses": col["misses"],
            "device_hits": d["hits"], "device_misses": d["misses"],
            "derived_hits": h["hits"], "derived_misses": h["misses"],
        }

    def _venue_info(self) -> dict:
        """Where this session's queries physically run (profile evidence)."""
        mesh = self.mesh is not None
        if self.device.type == "cuda":
            index = self.device.index if self.device.index is not None else torch.cuda.current_device()
            return {
                "mesh": mesh,
                "platform": "gpu",
                "device_kind": torch.cuda.get_device_name(index),
                "device_count": mesh_size(self.mesh) if mesh else torch.cuda.device_count(),
            }
        return {"mesh": mesh, "platform": "cpu", "device_kind": None,
                "device_count": mesh_size(self.mesh) if mesh else 1}

    def last_profile(self):
        """The QueryProfile of the most recent run() in this session (None
        before the first query). Render it with
        `Hyperspace.explain(plan, mode="analyze")` or inspect `.to_json()`.
        Under concurrent serving, per-query profiles ride the QueryHandle
        instead; this view is only "the most recent"."""
        with self._state_lock:
            return self._last_profile

    def serve(self, **kwargs):
        """A concurrent QueryServer over this session: a bounded worker
        pool, admission control and the versioned plan / result caches.
        Keyword arguments override the `hyperspace.serve.*` defaults."""
        from hyperspace_tpu_torch.serve import QueryServer

        return QueryServer(self, **kwargs)

    def to_pandas(self, plan: LogicalPlan):
        import pandas as pd

        return pd.DataFrame(self.run(plan).decode())


class Hyperspace:
    """The user API (Hyperspace.scala:32-104): index creation, the
    lifecycle actions, `ann_search`, `explain`, the advisor
    (`recommend`, `lifecycle`), the operations controller and the ingest
    daemon."""

    def __init__(self, session: HyperspaceSession):
        self.session = session

    def create_index(self, plan: LogicalPlan, index_config: IndexConfig) -> None:
        self.session.manager.create(plan, index_config)

    def create_vector_index(self, plan: LogicalPlan, config) -> None:
        """Build an ANN index over an embedding column (VectorIndexConfig)."""
        self.session.manager.create_vector(plan, config)

    def ann_search(self, plan: LogicalPlan, queries, k: int, nprobe: int | None = None,
                   embedding_column: str | None = None, metric: str | None = None):
        """Top-k nearest neighbours; probes a matching vector index when
        hyperspace is enabled, else brute-forces the source (exact)."""
        from hyperspace_tpu_torch.vector.search import ann_search

        return ann_search(self.session, plan, queries, k, nprobe, embedding_column, metric)

    def delete_index(self, name: str) -> None:
        self.session.manager.delete(name)

    def restore_index(self, name: str) -> None:
        self.session.manager.restore(name)

    def vacuum_index(self, name: str) -> None:
        self.session.manager.vacuum(name)

    def refresh_index(self, name: str, mode: str = "full") -> None:
        """Rebuild an index. mode="full" re-executes the logged lineage;
        mode="incremental" indexes only appended source files into per-
        bucket delta files (pair with optimize_index to compact). Lifts the
        session's corruption quarantine of the index."""
        self.session.manager.refresh(name, mode)
        self._lift_quarantine(name)

    def optimize_index(self, name: str) -> None:
        """Compact every live version of an index into one file a bucket
        (a vector index: retrain its centroids and re-partition). Lifts
        the session's corruption quarantine of the index."""
        self.session.manager.optimize(name)
        self._lift_quarantine(name)

    def _lift_quarantine(self, name: str) -> None:
        """A successful rebuild supersedes whatever corruption got the
        index quarantined in this session: let it serve queries again."""
        root = str(self.session.manager.path_resolver.get_index_path(name))
        with self.session._state_lock:
            self.session.index_health.pop(root, None)

    def cancel(self, name: str) -> None:
        self.session.manager.cancel(name)

    def recover(self, name: str | None = None) -> dict:
        """Crash recovery: quarantine torn log entries, roll a transient
        latest entry to the last stable state (cancel semantics), refresh
        the latestStable pointer, and GC version dirs no stable entry
        references. With no name, every index under the system path is
        recovered (a report per index name). Also lifts the session's
        corruption quarantine (`session.index_health`) of what it
        recovered, so repaired indexes serve queries again. Idempotent."""
        mgr = self.session.manager
        if name is not None:
            report = mgr.recover(name)
            root = str(mgr.path_resolver.get_index_path(name))
            with self.session._state_lock:
                self.session.index_health.pop(root, None)
            return report
        reports = {d.name: mgr.recover(d.name) for d in mgr.path_resolver.list_index_paths()}
        with self.session._state_lock:
            self.session.index_health.clear()
        return reports

    def indexes(self):
        """Every index under the system path, in any state, as a pandas
        DataFrame (name, kind, columns, buckets, location, state)."""
        return self.session.manager.indexes()

    # -- advisor ---------------------------------------------------------
    def recommend(self):
        """Ranked create / drop / rebucket / optimize recommendations for
        the session's observed workload: the what-if analyzer replaying
        recorded plans through the real rewrite rules against hypothetical
        indexes. Pure analysis; nothing is mutated."""
        from hyperspace_tpu_torch.advisor.whatif import WhatIfAnalyzer

        return WhatIfAnalyzer(self.session).recommend()

    def lifecycle(self):
        """The autonomous lifecycle policy over this API
        (advisor/lifecycle.py). All its gates
        (`hyperspace.advisor.lifecycle.*`) default off: construct it and
        call `.sweep()` after opting in."""
        from hyperspace_tpu_torch.advisor.lifecycle import LifecyclePolicy

        return LifecyclePolicy(self)

    def controller(self, server=None, **kwargs):
        """The self-driving operations controller over this API
        (serve/controller.py): a reconciliation loop consuming SLO burn
        verdicts and the quarantine map, actuating only through the
        crash-safe protocols this facade exposes. Gated by
        `hyperspace.controller.enabled` (default off) — construct it, opt
        in, and call `.start()` (or drive `.step()` yourself)."""
        from hyperspace_tpu_torch.serve.controller import OpsController

        return OpsController(self, server=server, **kwargs)

    def ingest(self, **kwargs):
        """The continuous-ingestion daemon over this API (ingest/): CDC
        tailing, micro-batch commits through the two-phase refresh action
        and gated compaction. Register indexes with `.watch(name,
        changelog=...)`, then `.start()` / `.drain()` / `.stop()`, or drive
        `.tick()` yourself. Gated by `hyperspace.ingest.enabled` (default
        off): every tick is a no-op until you opt in."""
        from hyperspace_tpu_torch.ingest.daemon import IngestDaemon

        return IngestDaemon(self, **kwargs)

    def explain(self, plan: LogicalPlan, verbose: bool = False, physical: bool = False,
                mode: str | None = None) -> str:
        """Rules-off/on plan diff. physical=True EXECUTES both variants and
        diffs the physical plans that actually ran (files read, kernels,
        bucket counts, rows per operator). mode="analyze" EXECUTES the
        query once under the session's current enablement and renders its
        QueryProfile: per-operator wall time, rows in/out, bytes, venue,
        cache outcomes. Its times are host walls; the card's time is
        `torch.profiler`'s (`session.run(plan, profile_dir=...)`)."""
        from hyperspace_tpu_torch.explain.plan_analyzer import explain_analyze, explain_executed, explain_string

        if mode == "analyze":
            return explain_analyze(plan, self.session)
        if mode not in (None, "diff"):
            raise HyperspaceError(f"unknown explain mode {mode!r} (diff|analyze)")
        if physical:
            return explain_executed(plan, self.session)
        return explain_string(plan, self.session, verbose=verbose)

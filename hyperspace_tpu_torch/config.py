"""Framework configuration: the settings the port's slices read.

The same defaults, directory-layout constants and string keys as the JAX
package's `config.py`, so an index directory written by either package
is laid out identically and a session is configured with the same
`session.conf.set(key, value)` calls. The port reads
`hyperspace.system.path`, `hyperspace.index.num.buckets`,
`hyperspace.join.broadcast.maxRows`, `hyperspace.join.rebucketize`, the
two hybrid-scan keys, the two lazy-recovery keys, the tracer's
`hyperspace.obs.enabled` / `.sink` and the event ring's
`hyperspace.obs.events.maxEvents` (process-global, as in the JAX
package), the serving plane's `hyperspace.serve.*` defaults (workers,
maxQueueDepth, queryTimeoutSeconds, the plan and result caches,
shedDepthRatio), the three explain display keys, the plan validator's
`hyperspace.analysis.validate`, the fault-injection harness's
`hyperspace.faults.enabled` / `.maxDelaySeconds` and the retry layer's
`hyperspace.retry.maxAttempts` / `.backoffBaseSeconds` / `.casAttempts`
(process-global, as in the JAX package), the corruption fallback's
`hyperspace.fallback.enabled`, the index-entry cache's
`hyperspace.index.cache.expiryDurationInSeconds`, and the build at scale:
`hyperspace.index.build.memoryBudgetBytes` / `.chunkBytes`,
`hyperspace.build.pipeline.enabled` / `.maxInflightBytes`,
`hyperspace.build.workers` / `.exchange.dir`,
`hyperspace.scan.prefetch.enabled` and the process-global
`hyperspace.device.staging.enabled`; and the rest of the serving plane:
`hyperspace.obs.http.*`, `hyperspace.obs.slo.*` and
`hyperspace.obs.journal.*` (the last two process-global),
`hyperspace.serve.tenant.quota.*`, `hyperspace.fleet.*` and
`hyperspace.controller.*`; the advisor's `hyperspace.advisor.*`
(routing, the workload ring, the lifecycle gates and floors); and
continuous ingestion's `hyperspace.ingest.*`.
A key the JAX package declares but the port does not read yet raises,
naming it as not ported; an undeclared `hyperspace.*` key raises with a
did-you-mean suggestion, as the JAX package's `check_known_key` does.
Keys outside the `hyperspace.` namespace pass through as overrides.
"""

from __future__ import annotations

import dataclasses
import difflib
import os
from typing import Any

from hyperspace_tpu_torch.exceptions import HyperspaceError, UnknownConfigKeyError

# Directory-layout constants (reference index/IndexConstants.scala:38-39).
HYPERSPACE_LOG_DIR = "_hyperspace_log"
DATA_VERSION_PREFIX = "v__="
LATEST_STABLE_LOG_NAME = "latestStable"

INDEX_SYSTEM_PATH = "hyperspace.system.path"
INDEX_NUM_BUCKETS = "hyperspace.index.num.buckets"
# TTL of the caching collection manager's ACTIVE index-entry listing.
INDEX_CACHE_EXPIRY_SECONDS = "hyperspace.index.cache.expiryDurationInSeconds"
# Broadcast hash join: a single-partition join whose smaller side has at
# most this many rows (and is at least 4x smaller than the other) probes
# the large side against a dense table of the small side's codes instead
# of sorting both for a merge. 0 disables.
JOIN_BROADCAST_MAX_ROWS = "hyperspace.join.broadcast.maxRows"
# Query-time re-bucketing exchange: when exactly one join side is an index
# bucketed on its join keys, the other side is re-bucketized on the fly
# (host row hash, one stable device sort of the bucket ids) so that the
# merge stays bucket-parallel. "auto" engages it where the broadcast probe
# does not apply; "force" always; "off" keeps the single-partition path.
JOIN_REBUCKETIZE = "hyperspace.join.rebucketize"
INDEX_HYBRID_SCAN_ENABLED = "hyperspace.index.hybridscan.enabled"
# Hybrid scan only applies while appended bytes stay below this fraction of
# the indexed source (past it, scanning deltas unindexed beats the index).
INDEX_HYBRID_SCAN_MAX_APPENDED_RATIO = "hyperspace.index.hybridscan.maxAppendedRatio"
# Index listing lazily repairs crash damage (recover()) on access; a
# transient entry is left alone until it is at least graceSeconds stale,
# so a listing cannot cancel a live writer's in-flight action.
RECOVER_ON_ACCESS = "hyperspace.recover.onAccess"
RECOVER_GRACE_SECONDS = "hyperspace.recover.graceSeconds"
# Observability: obs.enabled gates the tracer (False makes span()/trace()
# shared no-ops; per-query profiles remain available either way); obs.sink
# is a JSON-lines path receiving one line per finished root trace; the
# structured-event ring keeps at most maxEvents. All three are
# process-global, like the registry and tracer they configure.
OBS_ENABLED = "hyperspace.obs.enabled"
OBS_SINK = "hyperspace.obs.sink"
OBS_EVENTS_MAX = "hyperspace.obs.events.maxEvents"
# The QueryServer (`session.serve()`) reads these as its defaults: the
# worker pool, the admission-control limit (submits beyond it raise
# AdmissionRejected), the per-query timeout (0 = none), the plan cache,
# the opt-in byte-bounded result cache, and the fraction of maxQueueDepth
# past which non-priority submits are shed (1.0 = only the hard limit).
SERVE_WORKERS = "hyperspace.serve.workers"
SERVE_MAX_QUEUE_DEPTH = "hyperspace.serve.maxQueueDepth"
SERVE_QUERY_TIMEOUT_SECONDS = "hyperspace.serve.queryTimeoutSeconds"
SERVE_PLAN_CACHE_ENABLED = "hyperspace.serve.planCache.enabled"
SERVE_PLAN_CACHE_MAX_ENTRIES = "hyperspace.serve.planCache.maxEntries"
SERVE_RESULT_CACHE_ENABLED = "hyperspace.serve.resultCache.enabled"
SERVE_RESULT_CACHE_MAX_BYTES = "hyperspace.serve.resultCache.maxBytes"
SERVE_SHED_DEPTH_RATIO = "hyperspace.serve.shedDepthRatio"
# Explain rendering: `plaintext`, `console` (ANSI) or `html`, and the html
# mode's highlight tags.
EXPLAIN_DISPLAY_MODE = "hyperspace.explain.displayMode"
EXPLAIN_HIGHLIGHT_BEGIN = "hyperspace.explain.displayMode.highlight.beginTag"
EXPLAIN_HIGHLIGHT_END = "hyperspace.explain.displayMode.highlight.endTag"
# Pre-execution plan validation (analysis/validator.py): reject malformed
# plans with structured diagnostics before any device work.
ANALYSIS_VALIDATE = "hyperspace.analysis.validate"
# The fault-injection harness (faults.py): a kill switch that makes every
# fault point inert even with rules registered, and the clamp on any one
# injected brownout delay. Process-global.
FAULTS_ENABLED = "hyperspace.faults.enabled"
FAULTS_MAX_DELAY_SECONDS = "hyperspace.faults.maxDelaySeconds"
# The transient-IO retry (utils/retry.py): attempts per call site (1
# disables retry), the first backoff (doubling per attempt, capped), and
# the whole-protocol retries of Action.run when its begin() CAS loses (1 =
# abort, the reference's single-writer behavior). Process-global.
RETRY_MAX_ATTEMPTS = "hyperspace.retry.maxAttempts"
RETRY_BACKOFF_BASE = "hyperspace.retry.backoffBaseSeconds"
RETRY_CAS_ATTEMPTS = "hyperspace.retry.casAttempts"
# Query-plane corruption fallback: an index scan over unreadable data
# quarantines the index (session.index_health) and re-plans the query
# against healthy indexes, then the source, instead of failing.
FALLBACK_ENABLED = "hyperspace.fallback.enabled"
# Out-of-core build: a source whose uncompressed estimate exceeds the
# memory budget streams through chunks of at most chunkBytes (0 = derive
# from the budget).
INDEX_BUILD_MEMORY_BUDGET = "hyperspace.index.build.memoryBudgetBytes"
INDEX_BUILD_CHUNK_BYTES = "hyperspace.index.build.chunkBytes"
# The streaming build's pipeline: phase 1 overlaps decode and hash with the
# spill encode, and phase 2 runs spill read, key sort (on the card) and
# final write as three stages behind a byte-bounded window of
# maxInflightBytes (0 = 4x chunkBytes). Off, the serial two-phase build.
BUILD_PIPELINE_ENABLED = "hyperspace.build.pipeline.enabled"
BUILD_PIPELINE_MAX_INFLIGHT_BYTES = "hyperspace.build.pipeline.maxInflightBytes"
# The pooled build: N spawned worker PROCESSES split the build by bucket
# owner, exchanging rows through spill files under exchange.dir ("" =
# next to the version dir). 0 keeps the build in this process.
BUILD_WORKERS = "hyperspace.build.workers"
BUILD_EXCHANGE_DIR = "hyperspace.build.exchange.dir"
# The query-tail prefetch (execution/prefetch.py): footers and the first
# chunk of the index files the pruner keeps are read on a background pool
# while the query plans. Advisory.
SCAN_PREFETCH_ENABLED = "hyperspace.scan.prefetch.enabled"
# Zero-copy staging of card-bound columns (execution/staging.py).
# Process-global: the decode path has no session handle.
DEVICE_STAGING_ENABLED = "hyperspace.device.staging.enabled"
# The runtime health plane (obs/http.py): /metrics, /healthz and /debug/*
# on a stdlib server riding the QueryServer's lifecycle (port 0 =
# ephemeral). Off: no thread, no socket.
OBS_HTTP_ENABLED = "hyperspace.obs.http.enabled"
OBS_HTTP_HOST = "hyperspace.obs.http.host"
OBS_HTTP_PORT = "hyperspace.obs.http.port"
# SLO objectives (obs/slo.py), process-global: the availability target and
# the latency threshold the p99 objective holds served queries under.
OBS_SLO_AVAILABILITY_TARGET = "hyperspace.obs.slo.availabilityTarget"
OBS_SLO_LATENCY_P99_SECONDS = "hyperspace.obs.slo.latencyP99Seconds"
# The durable telemetry journal (obs/journal.py), process-global: segments
# under <dir>/<pid>/ ("" = <system path>/_obs), sealed at segmentBytes,
# at most maxBytes a process, a metrics snapshot at most every
# snapshotSeconds.
OBS_JOURNAL_ENABLED = "hyperspace.obs.journal.enabled"
OBS_JOURNAL_DIR = "hyperspace.obs.journal.dir"
OBS_JOURNAL_SEGMENT_BYTES = "hyperspace.obs.journal.segmentBytes"
OBS_JOURNAL_MAX_BYTES = "hyperspace.obs.journal.maxBytes"
OBS_JOURNAL_SNAPSHOT_SECONDS = "hyperspace.obs.journal.snapshotSeconds"
# Per-tenant token-bucket admission in front of the QueryServer
# (serve/fleet/quota.py): opt-in, then every tenant-keyed submit takes a
# token (ratePerSecond refill up to burst).
SERVE_TENANT_QUOTA_ENABLED = "hyperspace.serve.tenant.quota.enabled"
SERVE_TENANT_QUOTA_RATE = "hyperspace.serve.tenant.quota.ratePerSecond"
SERVE_TENANT_QUOTA_BURST = "hyperspace.serve.tenant.quota.burst"
# The multi-process fleet (serve/fleet/): the shared on-disk root ("" =
# <system path>/_fleet) and its cache budget, the lease TTL and the
# single-flight wait, and the supervisor's member count, floor, restart
# budget and crash-loop back-off base.
FLEET_CACHE_DIR = "hyperspace.fleet.cache.dir"
FLEET_CACHE_MAX_BYTES = "hyperspace.fleet.cache.maxBytes"
FLEET_LEASE_SECONDS = "hyperspace.fleet.lease.seconds"
FLEET_SINGLEFLIGHT_WAIT_SECONDS = "hyperspace.fleet.singleflight.waitSeconds"
FLEET_WORKERS = "hyperspace.fleet.workers"
FLEET_MIN_WORKERS = "hyperspace.fleet.minWorkers"
FLEET_MAX_RESTARTS = "hyperspace.fleet.maxRestarts"
FLEET_RESTART_BACKOFF_SECONDS = "hyperspace.fleet.restartBackoffSeconds"
# The operations controller (serve/controller.py): off by default; its
# loop interval, per-actuation cooldown, engage / release hysteresis,
# lifetime actuation budget, the shed ratio and quota factor of the
# overload response, the heal's rebuild and fleet coordination, the fleet
# scaling's saturation, ceiling and step, and the incident recorder.
CONTROLLER_ENABLED = "hyperspace.controller.enabled"
CONTROLLER_INTERVAL_SECONDS = "hyperspace.controller.intervalSeconds"
CONTROLLER_COOLDOWN_SECONDS = "hyperspace.controller.cooldownSeconds"
CONTROLLER_HYSTERESIS_TICKS = "hyperspace.controller.hysteresisTicks"
CONTROLLER_RECOVERY_TICKS = "hyperspace.controller.recoveryTicks"
CONTROLLER_ACTUATION_BUDGET = "hyperspace.controller.actuationBudget"
CONTROLLER_SHED_RATIO = "hyperspace.controller.shedRatio"
CONTROLLER_QUOTA_FACTOR = "hyperspace.controller.quotaFactor"
CONTROLLER_HEAL_REBUILD = "hyperspace.controller.heal.rebuild"
CONTROLLER_HEAL_COORDINATE = "hyperspace.controller.heal.coordinate"
CONTROLLER_SCALE_SATURATION = "hyperspace.controller.scale.saturation"
CONTROLLER_SCALE_MAX_WORKERS = "hyperspace.controller.scale.maxWorkers"
CONTROLLER_SCALE_STEP = "hyperspace.controller.scale.step"
CONTROLLER_INCIDENT_ENABLED = "hyperspace.controller.incident.enabled"
CONTROLLER_INCIDENT_DIR = "hyperspace.controller.incident.dir"
CONTROLLER_INCIDENT_MAX_BUNDLES = "hyperspace.controller.incident.maxBundles"
CONTROLLER_INCIDENT_SEGMENTS = "hyperspace.controller.incident.segments"
# The controller's advisor sweep (a cluster of routing demotions inside a
# trailing window triggers `LifecyclePolicy.sweep()`) and its storm
# response (a `jit.recompile_storm` event pins the key's signature raw).
CONTROLLER_DEMOTION_CLUSTER_SIZE = "hyperspace.controller.demotionClusterSize"
CONTROLLER_DEMOTION_WINDOW_SECONDS = "hyperspace.controller.demotionWindowSeconds"
CONTROLLER_STORM_RESPONSE = "hyperspace.controller.stormResponse"
# Workload-driven index advisor (advisor/). routing.* gate the adaptive
# query router: a per-plan-signature ledger of measured indexed vs raw
# wall times that demotes rewrites which measured slower — off by default
# because it changes plan choice. workload.maxRecords bounds the
# in-memory workload ring the what-if analyzer learns from. lifecycle.*
# gate the autonomous policy engine: all three default off; minConfidence
# / minBenefitSeconds are the evidence floor any auto-applied
# recommendation must clear; lifecycle.maxDeltas is the fragmentation
# threshold past which an optimize recommendation fires.
ADVISOR_ROUTING_ENABLED = "hyperspace.advisor.routing.enabled"
ADVISOR_ROUTING_DEMOTE_RATIO = "hyperspace.advisor.routing.demoteRatio"
ADVISOR_ROUTING_ALPHA = "hyperspace.advisor.routing.alpha"
ADVISOR_ROUTING_MIN_SAMPLES = "hyperspace.advisor.routing.minSamples"
ADVISOR_WORKLOAD_MAX_RECORDS = "hyperspace.advisor.workload.maxRecords"
ADVISOR_AUTO_CREATE = "hyperspace.advisor.lifecycle.autoCreate"
ADVISOR_AUTO_VACUUM = "hyperspace.advisor.lifecycle.autoVacuum"
ADVISOR_AUTO_OPTIMIZE = "hyperspace.advisor.lifecycle.autoOptimize"
ADVISOR_LIFECYCLE_MAX_DELTAS = "hyperspace.advisor.lifecycle.maxDeltas"
ADVISOR_MIN_CONFIDENCE = "hyperspace.advisor.minConfidence"
ADVISOR_MIN_BENEFIT_SECONDS = "hyperspace.advisor.minBenefitSeconds"
# Continuous ingestion (ingest/): enabled is the daemon's kill switch (off:
# every tick is a no-op); pollSeconds the tailer cadence; cdcBatchRows the
# rows one materialized CDC batch file holds; autoCompact gates compaction
# (the advisor's lifecycle gates apply on top); processWorker moves the
# loop into a spawned worker process; maxLagSeconds the advisory freshness
# objective past which the daemon emits `ingest.lagging`.
INGEST_ENABLED = "hyperspace.ingest.enabled"
INGEST_POLL_SECONDS = "hyperspace.ingest.pollSeconds"
INGEST_CDC_BATCH_ROWS = "hyperspace.ingest.cdcBatchRows"
INGEST_AUTO_COMPACT = "hyperspace.ingest.autoCompact"
INGEST_PROCESS_WORKER = "hyperspace.ingest.processWorker"
INGEST_MAX_LAG_SECONDS = "hyperspace.ingest.maxLagSeconds"

DEFAULT_NUM_BUCKETS = 8
DEFAULT_CACHE_EXPIRY_SECONDS = 300.0
DEFAULT_JOIN_BROADCAST_MAX_ROWS = 4_000_000
DEFAULT_JOIN_REBUCKETIZE = "auto"
DEFAULT_HYBRID_SCAN_MAX_APPENDED_RATIO = 0.3
DEFAULT_RECOVER_GRACE_SECONDS = 300.0
DEFAULT_SERVE_WORKERS = 4
DEFAULT_SERVE_MAX_QUEUE_DEPTH = 32
DEFAULT_SERVE_PLAN_CACHE_MAX_ENTRIES = 128
DEFAULT_SERVE_RESULT_CACHE_MAX_BYTES = 256 << 20
DEFAULT_SERVE_SHED_DEPTH_RATIO = 1.0
DEFAULT_BUILD_MEMORY_BUDGET = 4 << 30
DEFAULT_SERVE_TENANT_QUOTA_RATE = 100.0
DEFAULT_SERVE_TENANT_QUOTA_BURST = 200
DEFAULT_FLEET_CACHE_MAX_BYTES = 1 << 30
DEFAULT_FLEET_LEASE_SECONDS = 10.0
DEFAULT_FLEET_SINGLEFLIGHT_WAIT_SECONDS = 15.0
DEFAULT_FLEET_WORKERS = 2
DEFAULT_FLEET_MIN_WORKERS = 1
DEFAULT_FLEET_MAX_RESTARTS = 3
DEFAULT_FLEET_RESTART_BACKOFF_SECONDS = 0.5
DEFAULT_CONTROLLER_INTERVAL_SECONDS = 1.0
DEFAULT_CONTROLLER_COOLDOWN_SECONDS = 30.0
DEFAULT_CONTROLLER_HYSTERESIS_TICKS = 2
DEFAULT_CONTROLLER_RECOVERY_TICKS = 2
DEFAULT_CONTROLLER_ACTUATION_BUDGET = 32
DEFAULT_CONTROLLER_SHED_RATIO = 0.5
DEFAULT_CONTROLLER_QUOTA_FACTOR = 0.5
DEFAULT_CONTROLLER_SCALE_SATURATION = 0.75
DEFAULT_CONTROLLER_SCALE_MAX_WORKERS = 8
DEFAULT_CONTROLLER_SCALE_STEP = 1
DEFAULT_CONTROLLER_INCIDENT_MAX_BUNDLES = 16
DEFAULT_CONTROLLER_INCIDENT_SEGMENTS = 4
DEFAULT_CONTROLLER_DEMOTION_CLUSTER_SIZE = 3
DEFAULT_CONTROLLER_DEMOTION_WINDOW_SECONDS = 300.0
DEFAULT_ADVISOR_ROUTING_DEMOTE_RATIO = 1.0
DEFAULT_ADVISOR_ROUTING_ALPHA = 0.5
DEFAULT_ADVISOR_ROUTING_MIN_SAMPLES = 1
DEFAULT_ADVISOR_WORKLOAD_MAX_RECORDS = 512
DEFAULT_ADVISOR_LIFECYCLE_MAX_DELTAS = 4
DEFAULT_ADVISOR_MIN_CONFIDENCE = 0.5
DEFAULT_INGEST_POLL_SECONDS = 1.0
DEFAULT_INGEST_CDC_BATCH_ROWS = 65536
DEFAULT_INGEST_MAX_LAG_SECONDS = 30.0

# The keys the port reads.
PORTED_KEYS = (
    INDEX_SYSTEM_PATH, INDEX_NUM_BUCKETS, JOIN_BROADCAST_MAX_ROWS, JOIN_REBUCKETIZE,
    INDEX_HYBRID_SCAN_ENABLED, INDEX_HYBRID_SCAN_MAX_APPENDED_RATIO, RECOVER_ON_ACCESS,
    RECOVER_GRACE_SECONDS, OBS_ENABLED, OBS_SINK, OBS_EVENTS_MAX, SERVE_WORKERS, SERVE_MAX_QUEUE_DEPTH,
    SERVE_QUERY_TIMEOUT_SECONDS, SERVE_PLAN_CACHE_ENABLED, SERVE_PLAN_CACHE_MAX_ENTRIES,
    SERVE_RESULT_CACHE_ENABLED, SERVE_RESULT_CACHE_MAX_BYTES, SERVE_SHED_DEPTH_RATIO, EXPLAIN_DISPLAY_MODE,
    EXPLAIN_HIGHLIGHT_BEGIN, EXPLAIN_HIGHLIGHT_END, ANALYSIS_VALIDATE, FAULTS_ENABLED, FAULTS_MAX_DELAY_SECONDS,
    RETRY_MAX_ATTEMPTS, RETRY_BACKOFF_BASE, RETRY_CAS_ATTEMPTS, FALLBACK_ENABLED, INDEX_CACHE_EXPIRY_SECONDS,
    INDEX_BUILD_MEMORY_BUDGET, INDEX_BUILD_CHUNK_BYTES, BUILD_PIPELINE_ENABLED, BUILD_PIPELINE_MAX_INFLIGHT_BYTES,
    BUILD_WORKERS, BUILD_EXCHANGE_DIR, SCAN_PREFETCH_ENABLED, DEVICE_STAGING_ENABLED,
    OBS_HTTP_ENABLED, OBS_HTTP_HOST, OBS_HTTP_PORT, OBS_SLO_AVAILABILITY_TARGET, OBS_SLO_LATENCY_P99_SECONDS,
    OBS_JOURNAL_ENABLED, OBS_JOURNAL_DIR, OBS_JOURNAL_SEGMENT_BYTES, OBS_JOURNAL_MAX_BYTES,
    OBS_JOURNAL_SNAPSHOT_SECONDS, SERVE_TENANT_QUOTA_ENABLED, SERVE_TENANT_QUOTA_RATE, SERVE_TENANT_QUOTA_BURST,
    FLEET_CACHE_DIR, FLEET_CACHE_MAX_BYTES, FLEET_LEASE_SECONDS, FLEET_SINGLEFLIGHT_WAIT_SECONDS, FLEET_WORKERS,
    FLEET_MIN_WORKERS, FLEET_MAX_RESTARTS, FLEET_RESTART_BACKOFF_SECONDS, CONTROLLER_ENABLED,
    CONTROLLER_INTERVAL_SECONDS, CONTROLLER_COOLDOWN_SECONDS, CONTROLLER_HYSTERESIS_TICKS, CONTROLLER_RECOVERY_TICKS,
    CONTROLLER_ACTUATION_BUDGET, CONTROLLER_SHED_RATIO, CONTROLLER_QUOTA_FACTOR, CONTROLLER_HEAL_REBUILD,
    CONTROLLER_HEAL_COORDINATE, CONTROLLER_SCALE_SATURATION, CONTROLLER_SCALE_MAX_WORKERS, CONTROLLER_SCALE_STEP,
    CONTROLLER_INCIDENT_ENABLED, CONTROLLER_INCIDENT_DIR, CONTROLLER_INCIDENT_MAX_BUNDLES, CONTROLLER_INCIDENT_SEGMENTS,
    CONTROLLER_DEMOTION_CLUSTER_SIZE, CONTROLLER_DEMOTION_WINDOW_SECONDS, CONTROLLER_STORM_RESPONSE,
    ADVISOR_ROUTING_ENABLED, ADVISOR_ROUTING_DEMOTE_RATIO, ADVISOR_ROUTING_ALPHA, ADVISOR_ROUTING_MIN_SAMPLES,
    ADVISOR_WORKLOAD_MAX_RECORDS, ADVISOR_AUTO_CREATE, ADVISOR_AUTO_VACUUM, ADVISOR_AUTO_OPTIMIZE,
    ADVISOR_LIFECYCLE_MAX_DELTAS, ADVISOR_MIN_CONFIDENCE, ADVISOR_MIN_BENEFIT_SECONDS,
    INGEST_ENABLED, INGEST_POLL_SECONDS, INGEST_CDC_BATCH_ROWS, INGEST_AUTO_COMPACT, INGEST_PROCESS_WORKER,
    INGEST_MAX_LAG_SECONDS,
)
# The JAX package's other declared keys (its `config.KNOWN_KEYS`), whose
# modules are not ported yet: the host venues and the fused kernels.
UNPORTED_KEYS = frozenset((
    'hyperspace.join.venue', 'hyperspace.join.venueMinMbps', 'hyperspace.build.venue', 'hyperspace.agg.venue',
    'hyperspace.sort.venue', 'hyperspace.filter.venue', 'hyperspace.device.fusedKernels',
))


def check_known_key(key: str) -> None:
    """Reject a `hyperspace.*` key the port does not read: one the JAX
    package declares is named as not ported; any other is unknown, with a
    did-you-mean suggestion. Keys outside the namespace pass through."""
    if not key.startswith("hyperspace.") or key in PORTED_KEYS:
        return
    if key in UNPORTED_KEYS:
        raise HyperspaceError(f"config key {key!r} is not ported yet")
    close = difflib.get_close_matches(key, PORTED_KEYS + tuple(sorted(UNPORTED_KEYS)), n=1, cutoff=0.6)
    raise UnknownConfigKeyError(key, close[0] if close else None)


def _as_bool(value: Any) -> bool:
    return bool(value) if not isinstance(value, str) else value.lower() == "true"


@dataclasses.dataclass
class HyperspaceConf:
    """Per-session configuration with string-key overrides."""

    system_path: str = ""
    num_buckets: int = DEFAULT_NUM_BUCKETS
    join_broadcast_max_rows: int = DEFAULT_JOIN_BROADCAST_MAX_ROWS
    join_rebucketize: str = DEFAULT_JOIN_REBUCKETIZE
    hybrid_scan_enabled: bool = False
    hybrid_scan_max_appended_ratio: float = DEFAULT_HYBRID_SCAN_MAX_APPENDED_RATIO
    recover_on_access: bool = True
    recover_grace_seconds: float = DEFAULT_RECOVER_GRACE_SECONDS
    serve_workers: int = DEFAULT_SERVE_WORKERS
    serve_max_queue_depth: int = DEFAULT_SERVE_MAX_QUEUE_DEPTH
    serve_query_timeout_seconds: float = 0.0  # 0 = no per-query timeout
    serve_plan_cache_enabled: bool = True
    serve_plan_cache_max_entries: int = DEFAULT_SERVE_PLAN_CACHE_MAX_ENTRIES
    serve_result_cache_enabled: bool = False  # opt-in: results pin device memory
    serve_result_cache_max_bytes: int = DEFAULT_SERVE_RESULT_CACHE_MAX_BYTES
    serve_shed_depth_ratio: float = DEFAULT_SERVE_SHED_DEPTH_RATIO
    cache_expiry_seconds: float = DEFAULT_CACHE_EXPIRY_SECONDS
    validate_plans: bool = True
    fallback_enabled: bool = True
    build_memory_budget_bytes: int = DEFAULT_BUILD_MEMORY_BUDGET
    build_chunk_bytes: int = 0  # 0 = derived from the budget
    build_pipeline_enabled: bool = True
    build_pipeline_max_inflight_bytes: int = 0  # 0 = derived from chunkBytes
    build_workers: int = 0  # 0 = the build runs in this process
    build_exchange_dir: str = ""  # "" = <dest>.exchange next to the version dir
    scan_prefetch_enabled: bool = True
    obs_http_enabled: bool = False  # opt-in: binds a socket
    obs_http_host: str = "127.0.0.1"
    obs_http_port: int = 0  # 0 = ephemeral
    serve_tenant_quota_enabled: bool = False  # opt-in: meters tenant-keyed submits
    serve_tenant_quota_rate: float = DEFAULT_SERVE_TENANT_QUOTA_RATE
    serve_tenant_quota_burst: int = DEFAULT_SERVE_TENANT_QUOTA_BURST
    fleet_cache_dir: str = ""  # "" = <system_path>/_fleet
    fleet_cache_max_bytes: int = DEFAULT_FLEET_CACHE_MAX_BYTES
    fleet_lease_seconds: float = DEFAULT_FLEET_LEASE_SECONDS
    fleet_singleflight_wait_seconds: float = DEFAULT_FLEET_SINGLEFLIGHT_WAIT_SECONDS
    fleet_workers: int = DEFAULT_FLEET_WORKERS
    fleet_min_workers: int = DEFAULT_FLEET_MIN_WORKERS
    fleet_max_restarts: int = DEFAULT_FLEET_MAX_RESTARTS
    fleet_restart_backoff_seconds: float = DEFAULT_FLEET_RESTART_BACKOFF_SECONDS
    controller_enabled: bool = False  # opt-in: the controller mutates serving state
    controller_interval_seconds: float = DEFAULT_CONTROLLER_INTERVAL_SECONDS
    controller_cooldown_seconds: float = DEFAULT_CONTROLLER_COOLDOWN_SECONDS
    controller_hysteresis_ticks: int = DEFAULT_CONTROLLER_HYSTERESIS_TICKS
    controller_recovery_ticks: int = DEFAULT_CONTROLLER_RECOVERY_TICKS
    controller_actuation_budget: int = DEFAULT_CONTROLLER_ACTUATION_BUDGET
    controller_shed_ratio: float = DEFAULT_CONTROLLER_SHED_RATIO
    controller_quota_factor: float = DEFAULT_CONTROLLER_QUOTA_FACTOR
    controller_heal_rebuild: bool = True
    controller_heal_coordinate: bool = True
    controller_scale_saturation: float = DEFAULT_CONTROLLER_SCALE_SATURATION
    controller_scale_max_workers: int = DEFAULT_CONTROLLER_SCALE_MAX_WORKERS
    controller_scale_step: int = DEFAULT_CONTROLLER_SCALE_STEP
    controller_incident_enabled: bool = True
    controller_incident_dir: str = ""  # "" = <fleet root>/incidents
    controller_incident_max_bundles: int = DEFAULT_CONTROLLER_INCIDENT_MAX_BUNDLES
    controller_incident_segments: int = DEFAULT_CONTROLLER_INCIDENT_SEGMENTS
    controller_demotion_cluster_size: int = DEFAULT_CONTROLLER_DEMOTION_CLUSTER_SIZE
    controller_demotion_window_seconds: float = DEFAULT_CONTROLLER_DEMOTION_WINDOW_SECONDS
    controller_storm_response: bool = True
    advisor_routing_enabled: bool = False  # opt-in: routing changes plan choice
    advisor_routing_demote_ratio: float = DEFAULT_ADVISOR_ROUTING_DEMOTE_RATIO
    advisor_routing_alpha: float = DEFAULT_ADVISOR_ROUTING_ALPHA
    advisor_routing_min_samples: int = DEFAULT_ADVISOR_ROUTING_MIN_SAMPLES
    advisor_workload_max_records: int = DEFAULT_ADVISOR_WORKLOAD_MAX_RECORDS
    advisor_auto_create: bool = False
    advisor_auto_vacuum: bool = False
    advisor_auto_optimize: bool = False
    advisor_lifecycle_max_deltas: int = DEFAULT_ADVISOR_LIFECYCLE_MAX_DELTAS
    advisor_min_confidence: float = DEFAULT_ADVISOR_MIN_CONFIDENCE
    advisor_min_benefit_seconds: float = 0.0
    ingest_enabled: bool = False  # opt-in: the daemon mutates index state
    ingest_poll_seconds: float = DEFAULT_INGEST_POLL_SECONDS
    ingest_cdc_batch_rows: int = DEFAULT_INGEST_CDC_BATCH_ROWS
    ingest_auto_compact: bool = True
    ingest_process_worker: bool = False  # opt-in: spawns a worker process
    ingest_max_lag_seconds: float = DEFAULT_INGEST_MAX_LAG_SECONDS
    overrides: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.system_path:
            self.system_path = os.path.join(os.getcwd(), "spark-warehouse", "indexes")

    def set(self, key: str, value: Any) -> None:
        check_known_key(key)
        self.overrides[key] = value
        if key == INDEX_SYSTEM_PATH:
            self.system_path = str(value)
        elif key == INDEX_NUM_BUCKETS:
            self.num_buckets = int(value)
        elif key == JOIN_BROADCAST_MAX_ROWS:
            self.join_broadcast_max_rows = int(value)
        elif key == JOIN_REBUCKETIZE:
            self.join_rebucketize = str(value)
        elif key == INDEX_HYBRID_SCAN_ENABLED:
            self.hybrid_scan_enabled = _as_bool(value)
        elif key == INDEX_HYBRID_SCAN_MAX_APPENDED_RATIO:
            self.hybrid_scan_max_appended_ratio = float(value)
        elif key == RECOVER_ON_ACCESS:
            self.recover_on_access = _as_bool(value)
        elif key == RECOVER_GRACE_SECONDS:
            self.recover_grace_seconds = float(value)
        elif key == OBS_ENABLED:
            from hyperspace_tpu_torch.obs import trace as _obs_trace

            _obs_trace.set_enabled(_as_bool(value))
        elif key == OBS_SINK:
            from hyperspace_tpu_torch.obs import trace as _obs_trace

            _obs_trace.configure(sink=str(value) if value else None)
        elif key == OBS_EVENTS_MAX:
            from hyperspace_tpu_torch.obs import events as _obs_events

            _obs_events.configure(max_events=int(value))
        elif key == SERVE_WORKERS:
            self.serve_workers = int(value)
        elif key == SERVE_MAX_QUEUE_DEPTH:
            self.serve_max_queue_depth = int(value)
        elif key == SERVE_QUERY_TIMEOUT_SECONDS:
            self.serve_query_timeout_seconds = float(value)
        elif key == SERVE_PLAN_CACHE_ENABLED:
            self.serve_plan_cache_enabled = _as_bool(value)
        elif key == SERVE_PLAN_CACHE_MAX_ENTRIES:
            self.serve_plan_cache_max_entries = int(value)
        elif key == SERVE_RESULT_CACHE_ENABLED:
            self.serve_result_cache_enabled = _as_bool(value)
        elif key == SERVE_RESULT_CACHE_MAX_BYTES:
            self.serve_result_cache_max_bytes = int(value)
        elif key == SERVE_SHED_DEPTH_RATIO:
            self.serve_shed_depth_ratio = float(value)
        elif key == INDEX_CACHE_EXPIRY_SECONDS:
            self.cache_expiry_seconds = float(value)
        elif key == ANALYSIS_VALIDATE:
            self.validate_plans = _as_bool(value)
        elif key == FALLBACK_ENABLED:
            self.fallback_enabled = _as_bool(value)
        elif key == INDEX_BUILD_MEMORY_BUDGET:
            self.build_memory_budget_bytes = int(value)
        elif key == INDEX_BUILD_CHUNK_BYTES:
            self.build_chunk_bytes = int(value)
        elif key == BUILD_PIPELINE_ENABLED:
            self.build_pipeline_enabled = _as_bool(value)
        elif key == BUILD_PIPELINE_MAX_INFLIGHT_BYTES:
            self.build_pipeline_max_inflight_bytes = int(value)
        elif key == BUILD_WORKERS:
            self.build_workers = int(value)
        elif key == BUILD_EXCHANGE_DIR:
            self.build_exchange_dir = str(value)
        elif key == SCAN_PREFETCH_ENABLED:
            self.scan_prefetch_enabled = _as_bool(value)
        elif key == DEVICE_STAGING_ENABLED:
            from hyperspace_tpu_torch.execution import staging

            staging.set_enabled(_as_bool(value))
        elif key == OBS_HTTP_ENABLED:
            self.obs_http_enabled = _as_bool(value)
        elif key == OBS_HTTP_HOST:
            self.obs_http_host = str(value)
        elif key == OBS_HTTP_PORT:
            self.obs_http_port = int(value)
        elif key == SERVE_TENANT_QUOTA_ENABLED:
            self.serve_tenant_quota_enabled = _as_bool(value)
        elif key == SERVE_TENANT_QUOTA_RATE:
            self.serve_tenant_quota_rate = float(value)
        elif key == SERVE_TENANT_QUOTA_BURST:
            self.serve_tenant_quota_burst = int(value)
        elif key == FLEET_CACHE_DIR:
            self.fleet_cache_dir = str(value)
        elif key == FLEET_CACHE_MAX_BYTES:
            self.fleet_cache_max_bytes = int(value)
        elif key == FLEET_LEASE_SECONDS:
            self.fleet_lease_seconds = float(value)
        elif key == FLEET_SINGLEFLIGHT_WAIT_SECONDS:
            self.fleet_singleflight_wait_seconds = float(value)
        elif key == FLEET_WORKERS:
            self.fleet_workers = int(value)
        elif key == FLEET_MIN_WORKERS:
            self.fleet_min_workers = int(value)
        elif key == FLEET_MAX_RESTARTS:
            self.fleet_max_restarts = int(value)
        elif key == FLEET_RESTART_BACKOFF_SECONDS:
            self.fleet_restart_backoff_seconds = float(value)
        elif key == CONTROLLER_ENABLED:
            self.controller_enabled = _as_bool(value)
        elif key == CONTROLLER_INTERVAL_SECONDS:
            self.controller_interval_seconds = float(value)
        elif key == CONTROLLER_COOLDOWN_SECONDS:
            self.controller_cooldown_seconds = float(value)
        elif key == CONTROLLER_HYSTERESIS_TICKS:
            self.controller_hysteresis_ticks = int(value)
        elif key == CONTROLLER_RECOVERY_TICKS:
            self.controller_recovery_ticks = int(value)
        elif key == CONTROLLER_ACTUATION_BUDGET:
            self.controller_actuation_budget = int(value)
        elif key == CONTROLLER_SHED_RATIO:
            self.controller_shed_ratio = float(value)
        elif key == CONTROLLER_QUOTA_FACTOR:
            self.controller_quota_factor = float(value)
        elif key == CONTROLLER_HEAL_REBUILD:
            self.controller_heal_rebuild = _as_bool(value)
        elif key == CONTROLLER_HEAL_COORDINATE:
            self.controller_heal_coordinate = _as_bool(value)
        elif key == CONTROLLER_SCALE_SATURATION:
            self.controller_scale_saturation = float(value)
        elif key == CONTROLLER_SCALE_MAX_WORKERS:
            self.controller_scale_max_workers = int(value)
        elif key == CONTROLLER_SCALE_STEP:
            self.controller_scale_step = int(value)
        elif key == CONTROLLER_INCIDENT_ENABLED:
            self.controller_incident_enabled = _as_bool(value)
        elif key == CONTROLLER_INCIDENT_DIR:
            self.controller_incident_dir = str(value)
        elif key == CONTROLLER_INCIDENT_MAX_BUNDLES:
            self.controller_incident_max_bundles = int(value)
        elif key == CONTROLLER_INCIDENT_SEGMENTS:
            self.controller_incident_segments = int(value)
        elif key == CONTROLLER_DEMOTION_CLUSTER_SIZE:
            self.controller_demotion_cluster_size = int(value)
        elif key == CONTROLLER_DEMOTION_WINDOW_SECONDS:
            self.controller_demotion_window_seconds = float(value)
        elif key == CONTROLLER_STORM_RESPONSE:
            self.controller_storm_response = _as_bool(value)
        elif key == ADVISOR_ROUTING_ENABLED:
            self.advisor_routing_enabled = _as_bool(value)
        elif key == ADVISOR_ROUTING_DEMOTE_RATIO:
            self.advisor_routing_demote_ratio = float(value)
        elif key == ADVISOR_ROUTING_ALPHA:
            self.advisor_routing_alpha = float(value)
        elif key == ADVISOR_ROUTING_MIN_SAMPLES:
            self.advisor_routing_min_samples = int(value)
        elif key == ADVISOR_WORKLOAD_MAX_RECORDS:
            self.advisor_workload_max_records = int(value)
        elif key == ADVISOR_AUTO_CREATE:
            self.advisor_auto_create = _as_bool(value)
        elif key == ADVISOR_AUTO_VACUUM:
            self.advisor_auto_vacuum = _as_bool(value)
        elif key == ADVISOR_AUTO_OPTIMIZE:
            self.advisor_auto_optimize = _as_bool(value)
        elif key == ADVISOR_LIFECYCLE_MAX_DELTAS:
            self.advisor_lifecycle_max_deltas = int(value)
        elif key == ADVISOR_MIN_CONFIDENCE:
            self.advisor_min_confidence = float(value)
        elif key == ADVISOR_MIN_BENEFIT_SECONDS:
            self.advisor_min_benefit_seconds = float(value)
        elif key == INGEST_ENABLED:
            self.ingest_enabled = _as_bool(value)
        elif key == INGEST_POLL_SECONDS:
            self.ingest_poll_seconds = float(value)
        elif key == INGEST_CDC_BATCH_ROWS:
            self.ingest_cdc_batch_rows = int(value)
        elif key == INGEST_AUTO_COMPACT:
            self.ingest_auto_compact = _as_bool(value)
        elif key == INGEST_PROCESS_WORKER:
            self.ingest_process_worker = _as_bool(value)
        elif key == INGEST_MAX_LAG_SECONDS:
            self.ingest_max_lag_seconds = float(value)
        elif key == OBS_SLO_AVAILABILITY_TARGET:
            from hyperspace_tpu_torch.obs import slo as _obs_slo

            _obs_slo.configure(availability_target=float(value))
        elif key == OBS_SLO_LATENCY_P99_SECONDS:
            from hyperspace_tpu_torch.obs import slo as _obs_slo

            _obs_slo.configure(latency_threshold_s=float(value))
        elif key == OBS_JOURNAL_ENABLED:
            # Process-global like the rings it taps (obs/journal.py);
            # enabling without an explicit dir derives the default root
            # from this conf's system path.
            from hyperspace_tpu_torch.obs import journal as _obs_journal

            _obs_journal.configure(enabled=_as_bool(value))
            if _as_bool(value):
                _obs_journal.ensure_root(os.path.join(self.system_path, "_obs"))
        elif key == OBS_JOURNAL_DIR:
            from hyperspace_tpu_torch.obs import journal as _obs_journal

            _obs_journal.configure(root=str(value) if value else "")
        elif key == OBS_JOURNAL_SEGMENT_BYTES:
            from hyperspace_tpu_torch.obs import journal as _obs_journal

            _obs_journal.configure(segment_bytes=int(value))
        elif key == OBS_JOURNAL_MAX_BYTES:
            from hyperspace_tpu_torch.obs import journal as _obs_journal

            _obs_journal.configure(max_bytes=int(value))
        elif key == OBS_JOURNAL_SNAPSHOT_SECONDS:
            from hyperspace_tpu_torch.obs import journal as _obs_journal

            _obs_journal.configure(snapshot_s=float(value))
        elif key == FAULTS_ENABLED:
            # Process-global kill switch for the injection harness, like the
            # filesystem state it guards (imported here: faults imports no
            # config, so there is no cycle).
            from hyperspace_tpu_torch import faults

            faults.set_enabled(_as_bool(value))
        elif key == FAULTS_MAX_DELAY_SECONDS:
            from hyperspace_tpu_torch import faults

            faults.set_max_delay(float(value))
        elif key == RETRY_MAX_ATTEMPTS:
            from hyperspace_tpu_torch.utils import retry

            retry.configure(max_attempts=int(value))
        elif key == RETRY_BACKOFF_BASE:
            from hyperspace_tpu_torch.utils import retry

            retry.configure(backoff_base=float(value))
        elif key == RETRY_CAS_ATTEMPTS:
            from hyperspace_tpu_torch.utils import retry

            retry.configure(cas_attempts=int(value))

    def get(self, key: str, default: Any = None) -> Any:
        check_known_key(key)
        if key in self.overrides:
            return self.overrides[key]
        if key == INDEX_SYSTEM_PATH:
            return self.system_path
        if key == INDEX_NUM_BUCKETS:
            return self.num_buckets
        if key == JOIN_BROADCAST_MAX_ROWS:
            return self.join_broadcast_max_rows
        if key == JOIN_REBUCKETIZE:
            return self.join_rebucketize
        if key == INDEX_HYBRID_SCAN_ENABLED:
            return self.hybrid_scan_enabled
        if key == INDEX_HYBRID_SCAN_MAX_APPENDED_RATIO:
            return self.hybrid_scan_max_appended_ratio
        if key == RECOVER_ON_ACCESS:
            return self.recover_on_access
        if key == RECOVER_GRACE_SECONDS:
            return self.recover_grace_seconds
        if key == OBS_ENABLED:
            from hyperspace_tpu_torch.obs import trace as _obs_trace

            return _obs_trace.enabled()
        if key == OBS_SINK:
            from hyperspace_tpu_torch.obs import trace as _obs_trace

            return _obs_trace.sink_path()
        if key == OBS_EVENTS_MAX:
            from hyperspace_tpu_torch.obs import events as _obs_events

            return _obs_events.max_events()
        if key == SERVE_WORKERS:
            return self.serve_workers
        if key == SERVE_MAX_QUEUE_DEPTH:
            return self.serve_max_queue_depth
        if key == SERVE_QUERY_TIMEOUT_SECONDS:
            return self.serve_query_timeout_seconds
        if key == SERVE_PLAN_CACHE_ENABLED:
            return self.serve_plan_cache_enabled
        if key == SERVE_PLAN_CACHE_MAX_ENTRIES:
            return self.serve_plan_cache_max_entries
        if key == SERVE_RESULT_CACHE_ENABLED:
            return self.serve_result_cache_enabled
        if key == SERVE_RESULT_CACHE_MAX_BYTES:
            return self.serve_result_cache_max_bytes
        if key == SERVE_SHED_DEPTH_RATIO:
            return self.serve_shed_depth_ratio
        if key == INDEX_CACHE_EXPIRY_SECONDS:
            return self.cache_expiry_seconds
        if key == ANALYSIS_VALIDATE:
            return self.validate_plans
        if key == FALLBACK_ENABLED:
            return self.fallback_enabled
        if key == INDEX_BUILD_MEMORY_BUDGET:
            return self.build_memory_budget_bytes
        if key == INDEX_BUILD_CHUNK_BYTES:
            return self.build_chunk_bytes
        if key == BUILD_PIPELINE_ENABLED:
            return self.build_pipeline_enabled
        if key == BUILD_PIPELINE_MAX_INFLIGHT_BYTES:
            return self.build_pipeline_max_inflight_bytes
        if key == BUILD_WORKERS:
            return self.build_workers
        if key == BUILD_EXCHANGE_DIR:
            return self.build_exchange_dir
        if key == SCAN_PREFETCH_ENABLED:
            return self.scan_prefetch_enabled
        if key == DEVICE_STAGING_ENABLED:
            from hyperspace_tpu_torch.execution import staging

            return staging.enabled()
        if key == OBS_HTTP_ENABLED:
            return self.obs_http_enabled
        if key == OBS_HTTP_HOST:
            return self.obs_http_host
        if key == OBS_HTTP_PORT:
            return self.obs_http_port
        if key == SERVE_TENANT_QUOTA_ENABLED:
            return self.serve_tenant_quota_enabled
        if key == SERVE_TENANT_QUOTA_RATE:
            return self.serve_tenant_quota_rate
        if key == SERVE_TENANT_QUOTA_BURST:
            return self.serve_tenant_quota_burst
        if key == FLEET_CACHE_DIR:
            return self.fleet_cache_dir
        if key == FLEET_CACHE_MAX_BYTES:
            return self.fleet_cache_max_bytes
        if key == FLEET_LEASE_SECONDS:
            return self.fleet_lease_seconds
        if key == FLEET_SINGLEFLIGHT_WAIT_SECONDS:
            return self.fleet_singleflight_wait_seconds
        if key == FLEET_WORKERS:
            return self.fleet_workers
        if key == FLEET_MIN_WORKERS:
            return self.fleet_min_workers
        if key == FLEET_MAX_RESTARTS:
            return self.fleet_max_restarts
        if key == FLEET_RESTART_BACKOFF_SECONDS:
            return self.fleet_restart_backoff_seconds
        if key == CONTROLLER_ENABLED:
            return self.controller_enabled
        if key == CONTROLLER_INTERVAL_SECONDS:
            return self.controller_interval_seconds
        if key == CONTROLLER_COOLDOWN_SECONDS:
            return self.controller_cooldown_seconds
        if key == CONTROLLER_HYSTERESIS_TICKS:
            return self.controller_hysteresis_ticks
        if key == CONTROLLER_RECOVERY_TICKS:
            return self.controller_recovery_ticks
        if key == CONTROLLER_ACTUATION_BUDGET:
            return self.controller_actuation_budget
        if key == CONTROLLER_SHED_RATIO:
            return self.controller_shed_ratio
        if key == CONTROLLER_QUOTA_FACTOR:
            return self.controller_quota_factor
        if key == CONTROLLER_HEAL_REBUILD:
            return self.controller_heal_rebuild
        if key == CONTROLLER_HEAL_COORDINATE:
            return self.controller_heal_coordinate
        if key == CONTROLLER_SCALE_SATURATION:
            return self.controller_scale_saturation
        if key == CONTROLLER_SCALE_MAX_WORKERS:
            return self.controller_scale_max_workers
        if key == CONTROLLER_SCALE_STEP:
            return self.controller_scale_step
        if key == CONTROLLER_INCIDENT_ENABLED:
            return self.controller_incident_enabled
        if key == CONTROLLER_INCIDENT_DIR:
            return self.controller_incident_dir
        if key == CONTROLLER_INCIDENT_MAX_BUNDLES:
            return self.controller_incident_max_bundles
        if key == CONTROLLER_INCIDENT_SEGMENTS:
            return self.controller_incident_segments
        if key == CONTROLLER_DEMOTION_CLUSTER_SIZE:
            return self.controller_demotion_cluster_size
        if key == CONTROLLER_DEMOTION_WINDOW_SECONDS:
            return self.controller_demotion_window_seconds
        if key == CONTROLLER_STORM_RESPONSE:
            return self.controller_storm_response
        if key == ADVISOR_ROUTING_ENABLED:
            return self.advisor_routing_enabled
        if key == ADVISOR_ROUTING_DEMOTE_RATIO:
            return self.advisor_routing_demote_ratio
        if key == ADVISOR_ROUTING_ALPHA:
            return self.advisor_routing_alpha
        if key == ADVISOR_ROUTING_MIN_SAMPLES:
            return self.advisor_routing_min_samples
        if key == ADVISOR_WORKLOAD_MAX_RECORDS:
            return self.advisor_workload_max_records
        if key == ADVISOR_AUTO_CREATE:
            return self.advisor_auto_create
        if key == ADVISOR_AUTO_VACUUM:
            return self.advisor_auto_vacuum
        if key == ADVISOR_AUTO_OPTIMIZE:
            return self.advisor_auto_optimize
        if key == ADVISOR_LIFECYCLE_MAX_DELTAS:
            return self.advisor_lifecycle_max_deltas
        if key == ADVISOR_MIN_CONFIDENCE:
            return self.advisor_min_confidence
        if key == ADVISOR_MIN_BENEFIT_SECONDS:
            return self.advisor_min_benefit_seconds
        if key == INGEST_ENABLED:
            return self.ingest_enabled
        if key == INGEST_POLL_SECONDS:
            return self.ingest_poll_seconds
        if key == INGEST_CDC_BATCH_ROWS:
            return self.ingest_cdc_batch_rows
        if key == INGEST_AUTO_COMPACT:
            return self.ingest_auto_compact
        if key == INGEST_PROCESS_WORKER:
            return self.ingest_process_worker
        if key == INGEST_MAX_LAG_SECONDS:
            return self.ingest_max_lag_seconds
        if key == OBS_SLO_AVAILABILITY_TARGET:
            from hyperspace_tpu_torch.obs import slo as _obs_slo

            return _obs_slo.TRACKER.availability_target
        if key == OBS_SLO_LATENCY_P99_SECONDS:
            from hyperspace_tpu_torch.obs import slo as _obs_slo

            return _obs_slo.TRACKER.latency_threshold_s
        if key == OBS_JOURNAL_ENABLED:
            from hyperspace_tpu_torch.obs import journal as _obs_journal

            return _obs_journal.configured_enabled()
        if key == OBS_JOURNAL_DIR:
            from hyperspace_tpu_torch.obs import journal as _obs_journal

            return _obs_journal.root()
        if key == OBS_JOURNAL_SEGMENT_BYTES:
            from hyperspace_tpu_torch.obs import journal as _obs_journal

            return _obs_journal.segment_bytes()
        if key == OBS_JOURNAL_MAX_BYTES:
            from hyperspace_tpu_torch.obs import journal as _obs_journal

            return _obs_journal.max_bytes()
        if key == OBS_JOURNAL_SNAPSHOT_SECONDS:
            from hyperspace_tpu_torch.obs import journal as _obs_journal

            return _obs_journal.snapshot_seconds()
        return default

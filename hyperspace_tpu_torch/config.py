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
continuous ingestion's `hyperspace.ingest.*`; and the execution venues:
`hyperspace.{join,build,agg,sort,filter}.venue` (`auto`, `device`,
`host`; any other value raises at the operator's first use, as in the JAX
package; `auto` is the device), `hyperspace.join.venueMinMbps`
(accepted, read by nothing: the port measures no link) and
`hyperspace.device.fusedKernels` (`auto`: the port's device venue is its
hand-written kernels, so `off` raises). That is every key the JAX package
declares (`KNOWN_KEYS`, with its rendered defaults; `docs_table` renders
them); an undeclared `hyperspace.*` key raises with a did-you-mean
suggestion, as the JAX package's `check_known_key` does.
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
# The execution venues (parallel/bandwidth.py::pick_venue): each operator
# whose output lands on the host runs "device" (torch ops and the CUDA
# kernels on the session's device) or "host" (numpy and the native C++
# library); "auto" is the device. venueMinMbps, the JAX package's link
# floor for its "auto", is accepted and read by nothing. The join venue
# also picks the re-bucketing exchange's sort and the fused
# Aggregate(Join)'s channel pass.
JOIN_VENUE = "hyperspace.join.venue"
JOIN_VENUE_MIN_MBPS = "hyperspace.join.venueMinMbps"
BUILD_VENUE = "hyperspace.build.venue"
AGG_VENUE = "hyperspace.agg.venue"
SORT_VENUE = "hyperspace.sort.venue"
FILTER_VENUE = "hyperspace.filter.venue"
# The device venue's hand-written kernels: "auto" is the only value (the
# port's device venue has no un-fused path to turn them off for).
DEVICE_FUSED_KERNELS = "hyperspace.device.fusedKernels"
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
DEFAULT_JOIN_VENUE = "auto"
DEFAULT_JOIN_VENUE_MIN_MBPS = 200.0
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


@dataclasses.dataclass(frozen=True)
class ConfKey:
    """One declared config key: its rendered default and its one-line doc
    (`docs_table` renders the registry as a markdown table)."""

    default: str
    doc: str


# The declared-key registry: the JAX package's keys, in its order, with its
# rendered defaults. `HyperspaceConf.get/set` reject any `hyperspace.*` key
# not declared here (UnknownConfigKeyError, with a did-you-mean suggestion).
KNOWN_KEYS: dict[str, ConfKey] = {
    INDEX_SYSTEM_PATH: ConfKey(
        "`<cwd>/spark-warehouse/indexes`",
        "Root directory holding every index (log + data versions)."),
    INDEX_NUM_BUCKETS: ConfKey(
        "8",
        "Bucket count for new covering indexes (= build/query parallelism; the analog of "
        "`spark.hyperspace.index.num.buckets`)."),
    INDEX_CACHE_EXPIRY_SECONDS: ConfKey(
        "300",
        "TTL of the read-path metadata cache; every mutating API clears it."),
    INDEX_HYBRID_SCAN_ENABLED: ConfKey(
        "false",
        "Serve stale indexes by unioning the index scan with a pinned scan of appended files."),
    INDEX_HYBRID_SCAN_MAX_APPENDED_RATIO: ConfKey(
        "0.3",
        "Hybrid scan applies only while appended bytes stay below this fraction of the indexed "
        "source."),
    INDEX_BUILD_MEMORY_BUDGET: ConfKey(
        "4 GiB",
        "Sources whose uncompressed footer estimate exceeds this stream through the out-of-core "
        "build."),
    INDEX_BUILD_CHUNK_BYTES: ConfKey(
        "0 (derived)",
        "Row-group chunk size of the streaming build; 0 derives it from the budget."),
    JOIN_VENUE: ConfKey(
        "`auto`",
        "Where the materialized join's merge runs: `device` (the run-bounds kernel; also what "
        "`auto` means in this package) or `host` (the threaded C++ merge); unknown values raise. "
        "Also picks the re-bucketing exchange's sort and the fused Aggregate(Join)'s channel "
        "pass."),
    JOIN_VENUE_MIN_MBPS: ConfKey(
        "200",
        "Accepted for configurations written for the JAX package, whose `auto` venues take the "
        "host below this card→host link speed; read by nothing here, where `auto` is always the "
        "device (the columns already lie on the card)."),
    BUILD_VENUE: ConfKey(
        "`auto`",
        "Where the build's bucketize+sort permutation is computed: the threaded C++ counting "
        "sort and per-bucket key sort on the host vs the stable sort by (bucket, key lanes) on "
        "the card (`auto`)."),
    BUILD_PIPELINE_ENABLED: ConfKey(
        "true",
        "Streaming-build pipeline: overlap p1 decode/hash with pooled spill encode, and run p2 "
        "as a 3-stage spill-read ‖ key-sort ‖ final-write pipeline behind a bounded bucket- "
        "completion queue. `false` restores the serial two-phase build (the byte-for-byte "
        "reference path)."),
    BUILD_PIPELINE_MAX_INFLIGHT_BYTES: ConfKey(
        "0 (derived)",
        "Byte budget of decoded spill buckets resident across the p2 pipeline stages (the "
        "memory bound on small hosts); 0 derives 4x `hyperspace.index.build.chunkBytes`. A "
        "single bucket above the budget is still admitted alone. The pooled build derives each "
        "p2 owner's one-ahead spill-read window from the same budget."),
    BUILD_WORKERS: ConfKey(
        "0 (in-process)",
        "Scale-out pooled build: split the build across this many spawn-context worker "
        "processes — p1 shards each decode a contiguous file slice and spill per destination "
        "bucket-owner, p2 owners sort/encode/write their buckets in parallel (bucket id → owner "
        "is the shard key, the analogue of Spark's hash shuffle), byte-identical to the in- "
        "process streaming build. 0 keeps the in-process paths."),
    BUILD_EXCHANGE_DIR: ConfKey(
        "`` (derived)",
        "Root of the pooled build's cross-process spill exchange; empty derives "
        "`<dest>.exchange` next to the index version dir (same filesystem as the output). "
        "Always swept when the build ends, success or abort."),
    SCAN_PREFETCH_ENABLED: ConfKey(
        "true",
        "Async index bucket-file prefetch at plan-optimize time: footers (and the first row- "
        "group chunk) of the files the pruner keeps are read on a background pool so the "
        "executor's cold reads start warm. Advisory — prefetch failures are counted, never "
        "surfaced."),
    AGG_VENUE: ConfKey(
        "`auto`",
        "Where the grouped segment reduce runs: numpy bincount / reduceat on the host vs the "
        "CUDA segment-reduce kernel on the card (`auto`; one launch a shard on a mesh)."),
    SORT_VENUE: ConfKey(
        "`auto`",
        "Where ORDER BY and the join's regrouping sort run: numpy lexsort on the host vs one "
        "stable torch sort over the order lanes on the card (`auto`)."),
    FILTER_VENUE: ConfKey(
        "`auto`",
        "Where predicate masks evaluate (filters, join conditions, and the masks of projections, "
        "CASE inputs and window inputs): exact numpy with Kleene logic on the host vs torch ops "
        "on the card (`auto`; rows sharded on a mesh)."),
    DEVICE_STAGING_ENABLED: ConfKey(
        "true",
        "Arrow→device zero-copy staging (execution/staging.py): fixed-width null-free columns "
        "on the cache-destined read path stay read-only views over the Arrow buffers instead of "
        "owned host copies, counted in `device.stage.bytes_zero_copy` vs "
        "`device.stage.bytes_copied`. Process-global; `false` restores the always-copy decode."),
    DEVICE_FUSED_KERNELS: ConfKey(
        "`auto`",
        "The hand-written CUDA kernels of the device venue (segment reduce, run bounds). `auto` "
        "is the only value: the port's device venue has no un-fused path, so `off` raises."),
    JOIN_BROADCAST_MAX_ROWS: ConfKey(
        "4,000,000",
        "A non-aligned join whose smaller side is under this row count (and ≥4x smaller than "
        "the other) takes the broadcast hash path — dense code table from the small side, "
        "vectorized gather probe, large side never sorted. 0 disables."),
    JOIN_REBUCKETIZE: ConfKey(
        "`auto`",
        "Query-time re-bucketing exchange when exactly one join side is an index bucketed on "
        "its join keys: the other side re-groups into the index's bucket layout (native "
        "counting sort on host / one device sort on the device venue). `auto` engages it when "
        "the broadcast probe does not apply; `force` always; `off` keeps the single-partition "
        "fallback."),
    EXPLAIN_DISPLAY_MODE: ConfKey(
        "`plaintext`",
        "Explain rendering: `plaintext`, `console` (ANSI), or `html`."),
    EXPLAIN_HIGHLIGHT_BEGIN: ConfKey(
        "`<b>`",
        "Custom highlight tag opening replaced subtrees in html explain output (notebook use)."),
    EXPLAIN_HIGHLIGHT_END: ConfKey(
        "`</b>`",
        "Custom highlight tag closing replaced subtrees in html explain output (notebook use)."),
    ANALYSIS_VALIDATE: ConfKey(
        "true",
        "Pre-execution plan validation (analysis/validator.py): reject malformed plans with "
        "structured diagnostics before any device work."),
    FAULTS_ENABLED: ConfKey(
        "true",
        "Kill switch for the fault-injection harness (`faults.py`): false makes every "
        "`fault_point` inert even with rules registered. See "
        "[fault_tolerance.md](fault_tolerance.md)."),
    FAULTS_MAX_DELAY_SECONDS: ConfKey(
        "30",
        "Clamp on any single injected brownout delay (base + jitter of a `delay_s` fault rule): "
        "a typo'd rule slows a call by at most this long, so deadline-carrying paths surface "
        "their typed timeouts instead of wedging."),
    RETRY_MAX_ATTEMPTS: ConfKey(
        "3",
        "Attempts per transient-IO call site (log/pointer/manifest writes, parquet data/footer "
        "reads); 1 disables retry."),
    RETRY_BACKOFF_BASE: ConfKey(
        "0.005",
        "First-retry delay; doubles per attempt (capped, deterministic — jitter is an explicit "
        "hook)."),
    RETRY_CAS_ATTEMPTS: ConfKey(
        "1",
        "Whole-protocol retries when `Action.begin()` loses its CAS to a concurrent writer; 1 = "
        "abort (the reference's single-writer behavior)."),
    FALLBACK_ENABLED: ConfKey(
        "true",
        "Query-plane corruption fallback: an index scan over unreadable data quarantines the "
        "index (`session.index_health`) and re-plans the query against healthy indexes / the "
        "source instead of failing."),
    OBS_ENABLED: ConfKey(
        "true",
        "Tracer gate (process-global, [observability.md](observability.md)): false makes "
        "`span()`/`trace()` shared no-ops (nothing allocated on the query hot path); per-query "
        'profiles (`session.last_profile()`, `explain(mode="analyze")`) remain available either '
        "way."),
    OBS_SINK: ConfKey(
        "unset",
        "JSON-lines path receiving one event per finished root trace (query or action) — the "
        "export feed for `python -m hyperspace_tpu_torch.obs.export --sink <path>`."),
    OBS_HTTP_ENABLED: ConfKey(
        "false",
        "Runtime health plane ([observability.md](observability.md)): serve `/metrics`, "
        "`/healthz`, `/debug/events`, and `/debug/trace` over a zero-dependency HTTP server "
        "that starts/stops with the QueryServer lifecycle. Off ⇒ no thread, no socket, nothing "
        "imported."),
    OBS_HTTP_HOST: ConfKey(
        "`127.0.0.1`",
        "Bind address of the health endpoints (loopback by default — expose deliberately, not "
        "accidentally)."),
    OBS_HTTP_PORT: ConfKey(
        "0 (ephemeral)",
        "Port of the health endpoints; 0 binds an ephemeral port, read back from "
        "`QueryServer.health_endpoint.port`."),
    OBS_EVENTS_MAX: ConfKey(
        "256",
        "Bound of the structured event ring (`/debug/events`): old events age out (counted in "
        "`obs.events.dropped`), memory stays constant."),
    OBS_SLO_AVAILABILITY_TARGET: ConfKey(
        "0.999",
        "Availability objective over admitted queries (completed vs failed/timed- "
        "out/cancelled); burn rates are computed against 1 - target (obs/slo.py)."),
    OBS_SLO_LATENCY_P99_SECONDS: ConfKey(
        "1.0",
        "Latency threshold of the `serve.latency_p99` objective: 99% of served queries must "
        "finish under it (measured from the latency histogram's bucket bounds)."),
    OBS_JOURNAL_ENABLED: ConfKey(
        "false",
        "Durable telemetry journal (process-global, [observability.md](observability.md) "
        '"telemetry journal"): append events, completed root spans, periodic metric snapshots, '
        "and SLO verdict transitions to a segment-rotated JSONL journal under `<dir>/<pid>/`. "
        "Advisory — IO failures are counted (`obs.journal.errors`), never raised. Pooled/fleet "
        "workers inherit it and journal under their own pid."),
    OBS_JOURNAL_DIR: ConfKey(
        "unset (`<system.path>/_obs`)",
        "Root of the telemetry journal; one `<pid>/` subdirectory per journaling process. The "
        "fleet merge reads this root (`python -m hyperspace_tpu_torch.obs.export --format "
        "chrome --fleet <dir>`)."),
    OBS_JOURNAL_SEGMENT_BYTES: ConfKey(
        "65536",
        "Active-segment size at which the journal seals: flush + fsync + atomic rename to "
        "`segment-<n>.jsonl` (readers only ever see whole segments; a crash tears at most the "
        "unsealed tail)."),
    OBS_JOURNAL_MAX_BYTES: ConfKey(
        "4194304",
        "Per-process byte budget over sealed segments; exceeded ⇒ oldest-first eviction "
        "(`obs.journal.evictions`). The journal is a flight recorder, not an archive."),
    OBS_JOURNAL_SNAPSHOT_SECONDS: ConfKey(
        "5.0",
        "Minimum spacing of periodic counter/gauge snapshot records — taken opportunistically "
        "on the journal write path, no background thread."),
    RECOVER_ON_ACCESS: ConfKey(
        "true",
        "Index listing lazily repairs a crashed writer's log (torn entries immediately, "
        "transient tails after the grace)."),
    RECOVER_GRACE_SECONDS: ConfKey(
        "300",
        "Minimum staleness of a transient entry before lazy recovery touches it — keeps a "
        "listing from cancelling a LIVE writer's in-flight action. Explicit `recover()` ignores "
        "it."),
    SERVE_WORKERS: ConfKey(
        "4",
        "Worker threads of the concurrent query server ([serving.md](serving.md)); the "
        "subsystem is off unless a `QueryServer` is constructed (`session.serve()`)."),
    SERVE_MAX_QUEUE_DEPTH: ConfKey(
        "32",
        "Admission-control limit: submits beyond it raise `AdmissionRejected`."),
    SERVE_QUERY_TIMEOUT_SECONDS: ConfKey(
        "0 (off)",
        "Per-query deadline — expires queries still waiting in the queue and bounds "
        "`QueryHandle.result()` waits (`QueryTimeout`)."),
    SERVE_PLAN_CACHE_ENABLED: ConfKey(
        "true",
        "Serving-plane plan cache: memoize `optimized_plan()` under versioned keys that index "
        "mutations / source appends invalidate structurally."),
    SERVE_PLAN_CACHE_MAX_ENTRIES: ConfKey(
        "128",
        "Plan-cache LRU bound."),
    SERVE_RESULT_CACHE_ENABLED: ConfKey(
        "false",
        "Opt-in whole-result cache under the same versioned keys (never serves pre-refresh "
        "rows)."),
    SERVE_RESULT_CACHE_MAX_BYTES: ConfKey(
        "256 MiB",
        "Result-cache byte budget; LRU eviction past it, no single entry above a quarter of it."),
    SERVE_TENANT_QUOTA_ENABLED: ConfKey(
        "false",
        'Per-tenant token-bucket admission ([serving.md](serving.md) "fleet topology"): a '
        "`submit(..., tenant=id)` whose bucket is dry raises `QuotaExceeded` (an "
        "`AdmissionRejected` carrying `retry_after_s`) before costing a queue slot. Tenant-less "
        "submits are unmetered."),
    SERVE_TENANT_QUOTA_RATE: ConfKey(
        "100",
        "Default refill rate (queries/second) of each tenant's token bucket; override per "
        "tenant via `TenantQuotas.set_limit`."),
    SERVE_TENANT_QUOTA_BURST: ConfKey(
        "200",
        "Default bucket capacity: how many queries a tenant may burst above its sustained rate."),
    SERVE_SHED_DEPTH_RATIO: ConfKey(
        "1.0 (off)",
        "Graceful saturation: non-priority submits are shed (typed `AdmissionRejected`) once "
        "the queue reaches this fraction of `hyperspace.serve.maxQueueDepth`, keeping a bounded "
        "p99 for the priority lane instead of collapsing under overload. 1.0 disables early "
        "shedding (only the hard depth limit applies)."),
    FLEET_CACHE_DIR: ConfKey(
        "`<system.path>/_fleet`",
        "Root of the fleet's shared on-disk state (plan/result cache entries, single-flight "
        "leases, worker registrations). Underscore-prefixed, so index listing never mistakes it "
        "for an index."),
    FLEET_CACHE_MAX_BYTES: ConfKey(
        "1 GiB",
        "Byte budget of the shared result cache; past it the oldest entries are evicted under a "
        "cross-process file lease (plans get 1/16 of the budget). No single result above a "
        "quarter of the budget is admitted."),
    FLEET_LEASE_SECONDS: ConfKey(
        "10",
        "TTL of cross-process lease files (single-flight claims, eviction lease): a holder that "
        "dies is presumed dead after this long and its lease is reaped by the next claimant — a "
        "crashed process can never wedge the fleet."),
    FLEET_SINGLEFLIGHT_WAIT_SECONDS: ConfKey(
        "15",
        "How long a cold process waits for another process's in-flight build before giving up "
        "and building locally (correct either way — the wait only dedups work)."),
    FLEET_WORKERS: ConfKey(
        "2",
        "Default worker-process count of a `FleetSupervisor` (serve/fleet/supervisor.py)."),
    FLEET_MIN_WORKERS: ConfKey(
        "1",
        "Floor of `FleetSupervisor.set_target_workers`: no scale-down (manual or controller- "
        "actuated) drops the fleet below this many members."),
    FLEET_MAX_RESTARTS: ConfKey(
        "3",
        "How many times the supervisor respawns a crashed worker before leaving its slot down "
        "(counted in `fleet.supervisor.restarts`)."),
    FLEET_RESTART_BACKOFF_SECONDS: ConfKey(
        "0.5",
        "Base of the exponential backoff between restarts of the SAME fleet member (delay = "
        "base x 2^(restarts-1), deterministic jitter, capped): a crash-looping worker cannot "
        "burn its whole `hyperspace.fleet.maxRestarts` budget in milliseconds. The first "
        "respawn is immediate; when backoff engages a WARN `fleet.worker.crash_loop` event "
        "names the member."),
    CONTROLLER_ENABLED: ConfKey(
        "false",
        "Kill switch of the self-driving operations controller "
        '([fault_tolerance.md](fault_tolerance.md) "self-driving operations"): false (the '
        "default) means the reconciliation loop observes nothing and actuates nothing; "
        "disarming a RUNNING controller mid-loop releases any overrides it holds (shed depth, "
        "quota throttle) and stands down."),
    CONTROLLER_INTERVAL_SECONDS: ConfKey(
        "1.0",
        "Reconciliation-loop tick interval of `OpsController.start()`; each tick samples the "
        "SLO tracker, drains new structured events, and runs one `step()`."),
    CONTROLLER_COOLDOWN_SECONDS: ConfKey(
        "30",
        "Minimum controller-clock seconds between two firings of the SAME actuation (per healed "
        "index, per sweep, per shed engage) — the anti-flap floor on top of the verdict "
        "hysteresis."),
    CONTROLLER_HYSTERESIS_TICKS: ConfKey(
        "2",
        "Consecutive page-verdict ticks required before the overload response engages: a single "
        "verdict flicker never actuates."),
    CONTROLLER_RECOVERY_TICKS: ConfKey(
        "2",
        "Consecutive non-page ticks required before an engaged overload response releases "
        "(restoring the original shed depth and quota rates)."),
    CONTROLLER_ACTUATION_BUDGET: ConfKey(
        "32",
        "Global mutation budget of one controller lifetime. Exhaustion degrades the controller "
        "to observe-only — decisions are still computed and audited, nothing mutates — "
        "announced once by an ERROR `controller.observe_only` event. Releases of held overrides "
        "stay free, so the system is always left as found."),
    CONTROLLER_SHED_RATIO: ConfKey(
        "0.5",
        "Shed-depth tightening applied while serve SLOs page: the queue's shed threshold drops "
        "to this fraction of `hyperspace.serve.maxQueueDepth` (non-priority submits refused "
        "earlier, typed), restored on recovery."),
    CONTROLLER_QUOTA_FACTOR: ConfKey(
        "0.5",
        "Tenant-quota tightening applied while serve SLOs page: every tenant's token-bucket "
        "refill rate is scaled by this factor (`TenantQuotas.set_throttle`), restored on "
        "recovery."),
    CONTROLLER_HEAL_REBUILD: ConfKey(
        "true",
        "After healing a quarantined index via `recover()`, also rebuild it "
        '(`refresh_index(mode="full")` — the crash-safe Action protocol) so on-disk corruption '
        "is actually repaired, not just re-served until the next quarantine. false limits "
        "healing to log recovery."),
    CONTROLLER_DEMOTION_CLUSTER_SIZE: ConfKey(
        "3",
        "How many `advisor.routing.demoted` events must cluster inside `demotionWindowSeconds` "
        "before the controller triggers an advisor lifecycle sweep (the sweep itself stays "
        "gated by the `hyperspace.advisor.lifecycle.*` opt-ins)."),
    CONTROLLER_DEMOTION_WINDOW_SECONDS: ConfKey(
        "300",
        "Trailing controller-clock window over which routing-demotion events are counted toward "
        "the sweep-trigger cluster."),
    CONTROLLER_HEAL_COORDINATE: ConfKey(
        "true",
        "Route heal actuations through the fleet single-flight lease "
        "(serve/fleet/singleflight.py) so exactly ONE member rebuilds a quarantined index "
        "fleet-wide; followers observe the published heal marker and only lift their local "
        "quarantine. Engages only when a fleet directory is discoverable; false keeps every "
        "heal process-local."),
    CONTROLLER_SCALE_SATURATION: ConfKey(
        "0.75",
        "Queue-fullness ratio (worst of the fleet-health aggregate and the local server) at or "
        "above which a controller tick counts toward the scale-up hysteresis."),
    CONTROLLER_SCALE_MAX_WORKERS: ConfKey(
        "8",
        "Ceiling of controller-actuated fleet scale-up (`FleetSupervisor.set_target_workers`); "
        "recovery restores the pre-episode member count."),
    CONTROLLER_SCALE_STEP: ConfKey(
        "1",
        "How many members each scale-up actuation adds (each addition is a separate audited, "
        "budgeted, cooled-down actuation)."),
    CONTROLLER_STORM_RESPONSE: ConfKey(
        "true",
        "Actuate on `jit.recompile_storm` events: pin the storming key's signature to the raw- "
        "scan route (`RoutingLedger.pin`). The port compiles no query code, so it emits no such "
        "event. false keeps storms observe-only telemetry."),
    CONTROLLER_INCIDENT_ENABLED: ConfKey(
        "true",
        "Incident bundles: on an SLO page engage, a fresh quarantine, or observe-only entry the "
        "controller opens a forensic bundle under `<dir>/<ts>-<trigger>/` (event ring dump, "
        "process report, config snapshot, routing ledger, actuation audit trail) and closes it "
        "on recovery with every reachable member's journal segments. Advisory: capture failures "
        "count `controller.incident_errors`, never raise."),
    CONTROLLER_INCIDENT_DIR: ConfKey(
        "unset (`<fleet root>/incidents`)",
        "Where incident bundles land; defaults next to the fleet coordination root "
        "(`hyperspace.fleet.cacheDir` or `<system.path>/_fleet`). Served read-only at "
        "`/debug/incidents`."),
    CONTROLLER_INCIDENT_MAX_BUNDLES: ConfKey(
        "16",
        "On-disk bundle retention: opening a bundle beyond this count evicts the oldest bundle "
        "directory first."),
    CONTROLLER_INCIDENT_SEGMENTS: ConfKey(
        "4",
        "How many of each reachable member's newest sealed journal segments the closing bundle "
        "copies in — the cross-process evidence window."),
    ADVISOR_ROUTING_ENABLED: ConfKey(
        "false",
        "Adaptive query routing ([advisor.md](advisor.md)): a per-plan-signature ledger of "
        "measured indexed vs raw wall times demotes rewrites that measured slower to source "
        "scans. Changes plan choice, so explicit opt-in; the ledger invalidates structurally on "
        "any index mutation."),
    ADVISOR_ROUTING_DEMOTE_RATIO: ConfKey(
        "1.0",
        "Demotion threshold: a signature routes raw once its indexed EMA exceeds ratio x its "
        "raw EMA (both sides sampled)."),
    ADVISOR_ROUTING_ALPHA: ConfKey(
        "0.5",
        "EMA smoothing of the routing ledger's wall-time estimates (higher = newer samples "
        "dominate)."),
    ADVISOR_ROUTING_MIN_SAMPLES: ConfKey(
        "1",
        "Evidence floor: both the indexed and raw path need at least this many samples before a "
        "signature can be demoted."),
    ADVISOR_WORKLOAD_MAX_RECORDS: ConfKey(
        "512",
        "Bound of the in-memory per-session workload ring the what-if analyzer learns from; old "
        "traffic ages out."),
    ADVISOR_AUTO_CREATE: ConfKey(
        "false",
        "Lifecycle gate: let `LifecyclePolicy.sweep()` build recommended indexes autonomously "
        "(crash-safe through the normal create action)."),
    ADVISOR_AUTO_VACUUM: ConfKey(
        "false",
        "Lifecycle gate: let the sweep delete+vacuum indexes the observed workload never "
        "touched."),
    ADVISOR_AUTO_OPTIMIZE: ConfKey(
        "false",
        "Lifecycle gate: let the sweep compact indexes fragmented past "
        "`hyperspace.advisor.lifecycle.maxDeltas`."),
    ADVISOR_LIFECYCLE_MAX_DELTAS: ConfKey(
        "4",
        "Fragmentation threshold: an index spanning more version dirs than this earns an "
        "optimize recommendation."),
    ADVISOR_MIN_CONFIDENCE: ConfKey(
        "0.5",
        "Policy floor: recommendations below this confidence are reported but never auto- "
        "applied."),
    ADVISOR_MIN_BENEFIT_SECONDS: ConfKey(
        "0",
        "Policy floor: recommendations whose estimated benefit is below this many seconds are "
        "reported but never auto-applied."),
    INGEST_ENABLED: ConfKey(
        "false",
        "Continuous-ingestion daemon ([ingestion.md](ingestion.md)): source watchers feed "
        "micro-batch incremental refreshes through the two-phase Action protocol as a "
        "background service. Off by default — nothing polls or mutates without opt-in; "
        "`Hyperspace.ingest()` constructs the daemon either way."),
    INGEST_POLL_SECONDS: ConfKey(
        "1.0",
        "Tailer cadence: how often the daemon polls its sources for new files / appended CDC "
        "rows (and re-reads its pause control file)."),
    INGEST_CDC_BATCH_ROWS: ConfKey(
        "65536",
        "Row bound of one materialized CDC batch file: a changelog tail longer than this is "
        "split into multiple deterministic batch files (each commits through its own micro- "
        "batch)."),
    INGEST_AUTO_COMPACT: ConfKey(
        "true",
        "Gate the daemon's background compaction: once an index spans more delta version dirs "
        "than `hyperspace.advisor.lifecycle.maxDeltas`, trigger the optimize action (deferred "
        "while serve SLOs burn; the advisor lifecycle gates still bound WHAT may compact)."),
    INGEST_PROCESS_WORKER: ConfKey(
        "false",
        "Run the ingest loop in a spawn-context worker PROCESS (parallel/procpool.py) instead "
        "of the default in-process daemon thread — the crash-isolation deployment shape (a "
        "SIGKILLed worker leaves only a transient log the next recover() converges)."),
    INGEST_MAX_LAG_SECONDS: ConfKey(
        "30.0",
        "Advisory freshness objective: when data observed by the tailer has waited longer than "
        "this without reaching a committed index version, the daemon emits a WARN "
        "`ingest.lagging` event (never blocks)."),
}
# Every declared key is read by the port.
PORTED_KEYS = tuple(KNOWN_KEYS)


def check_known_key(key: str) -> None:
    """Reject an undeclared `hyperspace.*` key with a did-you-mean
    suggestion. Keys outside the namespace pass through (the overrides map
    doubles as a scratch space for tests and embedding apps)."""
    if not key.startswith("hyperspace.") or key in KNOWN_KEYS:
        return
    close = difflib.get_close_matches(key, KNOWN_KEYS, n=1, cutoff=0.6)
    raise UnknownConfigKeyError(key, close[0] if close else None)


def docs_table() -> str:
    """The registry as a markdown table: key, default, meaning."""
    lines = ["| Key | Default | Meaning |", "|---|---|---|"]
    for key, spec in KNOWN_KEYS.items():
        lines.append(f"| `{key}` | {spec.default} | {spec.doc} |")
    return "\n".join(lines)


def check_fused_kernels(value: str) -> str:
    """`hyperspace.device.fusedKernels`: `auto` is the port's only device
    path (its hand-written kernels); any other value raises."""
    if value == "auto":
        return value
    if value == "off":
        raise HyperspaceError(
            "hyperspace.device.fusedKernels=off: the port's device venue has no un-fused path "
            "(its kernels are the device venue); use auto, or a host venue"
        )
    raise HyperspaceError(f"unknown hyperspace.device.fusedKernels={value!r} (auto)")


def _as_bool(value: Any) -> bool:
    return bool(value) if not isinstance(value, str) else value.lower() == "true"


@dataclasses.dataclass
class HyperspaceConf:
    """Per-session configuration with string-key overrides."""

    system_path: str = ""
    num_buckets: int = DEFAULT_NUM_BUCKETS
    join_broadcast_max_rows: int = DEFAULT_JOIN_BROADCAST_MAX_ROWS
    join_rebucketize: str = DEFAULT_JOIN_REBUCKETIZE
    join_venue: str = DEFAULT_JOIN_VENUE
    join_venue_min_mbps: float = DEFAULT_JOIN_VENUE_MIN_MBPS
    build_venue: str = DEFAULT_JOIN_VENUE
    agg_venue: str = DEFAULT_JOIN_VENUE
    sort_venue: str = DEFAULT_JOIN_VENUE
    filter_venue: str = DEFAULT_JOIN_VENUE
    device_fused_kernels: str = "auto"
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
        if key == DEVICE_FUSED_KERNELS:
            check_fused_kernels(str(value))  # a refused value leaves no override
        self.overrides[key] = value
        if key == INDEX_SYSTEM_PATH:
            self.system_path = str(value)
        elif key == INDEX_NUM_BUCKETS:
            self.num_buckets = int(value)
        elif key == JOIN_BROADCAST_MAX_ROWS:
            self.join_broadcast_max_rows = int(value)
        elif key == JOIN_REBUCKETIZE:
            self.join_rebucketize = str(value)
        elif key == JOIN_VENUE:
            self.join_venue = str(value)
        elif key == JOIN_VENUE_MIN_MBPS:
            self.join_venue_min_mbps = float(value)
        elif key == BUILD_VENUE:
            self.build_venue = str(value)
        elif key == AGG_VENUE:
            self.agg_venue = str(value)
        elif key == SORT_VENUE:
            self.sort_venue = str(value)
        elif key == FILTER_VENUE:
            self.filter_venue = str(value)
        elif key == DEVICE_FUSED_KERNELS:
            self.device_fused_kernels = str(value)
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
        if key == JOIN_VENUE:
            return self.join_venue
        if key == JOIN_VENUE_MIN_MBPS:
            return self.join_venue_min_mbps
        if key == BUILD_VENUE:
            return self.build_venue
        if key == AGG_VENUE:
            return self.agg_venue
        if key == SORT_VENUE:
            return self.sort_venue
        if key == FILTER_VENUE:
            return self.filter_venue
        if key == DEVICE_FUSED_KERNELS:
            return self.device_fused_kernels
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

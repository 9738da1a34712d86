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
`hyperspace.device.staging.enabled`.
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
)
# The JAX package's other declared keys (its `config.KNOWN_KEYS`), whose
# modules are not ported yet.
UNPORTED_KEYS = frozenset((
    'hyperspace.join.venue', 'hyperspace.join.venueMinMbps', 'hyperspace.build.venue', 'hyperspace.agg.venue',
    'hyperspace.sort.venue', 'hyperspace.filter.venue', 'hyperspace.device.fusedKernels',
    'hyperspace.obs.http.enabled', 'hyperspace.obs.http.host',
    'hyperspace.obs.http.port', 'hyperspace.obs.slo.availabilityTarget',
    'hyperspace.obs.slo.latencyP99Seconds', 'hyperspace.obs.journal.enabled', 'hyperspace.obs.journal.dir',
    'hyperspace.obs.journal.segmentBytes', 'hyperspace.obs.journal.maxBytes',
    'hyperspace.obs.journal.snapshotSeconds', 'hyperspace.serve.tenant.quota.enabled',
    'hyperspace.serve.tenant.quota.ratePerSecond', 'hyperspace.serve.tenant.quota.burst',
    'hyperspace.fleet.cache.dir', 'hyperspace.fleet.cache.maxBytes', 'hyperspace.fleet.lease.seconds',
    'hyperspace.fleet.singleflight.waitSeconds', 'hyperspace.fleet.workers', 'hyperspace.fleet.minWorkers',
    'hyperspace.fleet.maxRestarts', 'hyperspace.fleet.restartBackoffSeconds', 'hyperspace.controller.enabled',
    'hyperspace.controller.intervalSeconds', 'hyperspace.controller.cooldownSeconds',
    'hyperspace.controller.hysteresisTicks', 'hyperspace.controller.recoveryTicks',
    'hyperspace.controller.actuationBudget', 'hyperspace.controller.shedRatio',
    'hyperspace.controller.quotaFactor', 'hyperspace.controller.heal.rebuild',
    'hyperspace.controller.demotionClusterSize', 'hyperspace.controller.demotionWindowSeconds',
    'hyperspace.controller.heal.coordinate', 'hyperspace.controller.scale.saturation',
    'hyperspace.controller.scale.maxWorkers', 'hyperspace.controller.scale.step',
    'hyperspace.controller.stormResponse', 'hyperspace.controller.incident.enabled',
    'hyperspace.controller.incident.dir', 'hyperspace.controller.incident.maxBundles',
    'hyperspace.controller.incident.segments', 'hyperspace.advisor.routing.enabled',
    'hyperspace.advisor.routing.demoteRatio', 'hyperspace.advisor.routing.alpha',
    'hyperspace.advisor.routing.minSamples', 'hyperspace.advisor.workload.maxRecords',
    'hyperspace.advisor.lifecycle.autoCreate', 'hyperspace.advisor.lifecycle.autoVacuum',
    'hyperspace.advisor.lifecycle.autoOptimize', 'hyperspace.advisor.lifecycle.maxDeltas',
    'hyperspace.advisor.minConfidence', 'hyperspace.advisor.minBenefitSeconds', 'hyperspace.ingest.enabled',
    'hyperspace.ingest.pollSeconds', 'hyperspace.ingest.cdcBatchRows', 'hyperspace.ingest.autoCompact',
    'hyperspace.ingest.processWorker', 'hyperspace.ingest.maxLagSeconds',
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
        return default

"""Framework configuration: the settings the port's slices read.

The same defaults, directory-layout constants and string keys as the JAX
package's `config.py`, so an index directory written by either package
is laid out identically and a session is configured with the same
`session.conf.set(key, value)` calls. The port reads four keys:
`hyperspace.system.path`, `hyperspace.index.num.buckets`,
`hyperspace.join.broadcast.maxRows` and `hyperspace.join.rebucketize`.
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

DEFAULT_NUM_BUCKETS = 8
DEFAULT_CACHE_EXPIRY_SECONDS = 300.0
DEFAULT_JOIN_BROADCAST_MAX_ROWS = 4_000_000
DEFAULT_JOIN_REBUCKETIZE = "auto"

# The keys the port reads.
PORTED_KEYS = (INDEX_SYSTEM_PATH, INDEX_NUM_BUCKETS, JOIN_BROADCAST_MAX_ROWS, JOIN_REBUCKETIZE)
# The JAX package's other declared keys (its `config.KNOWN_KEYS`), whose
# modules are not ported yet.
UNPORTED_KEYS = frozenset((
    'hyperspace.index.cache.expiryDurationInSeconds', 'hyperspace.index.hybridscan.enabled',
    'hyperspace.index.hybridscan.maxAppendedRatio', 'hyperspace.index.build.memoryBudgetBytes',
    'hyperspace.index.build.chunkBytes', 'hyperspace.join.venue', 'hyperspace.join.venueMinMbps',
    'hyperspace.build.venue', 'hyperspace.build.pipeline.enabled',
    'hyperspace.build.pipeline.maxInflightBytes', 'hyperspace.build.workers',
    'hyperspace.build.exchange.dir', 'hyperspace.scan.prefetch.enabled', 'hyperspace.agg.venue',
    'hyperspace.sort.venue', 'hyperspace.filter.venue', 'hyperspace.device.staging.enabled',
    'hyperspace.device.fusedKernels', 'hyperspace.explain.displayMode',
    'hyperspace.explain.displayMode.highlight.beginTag',
    'hyperspace.explain.displayMode.highlight.endTag', 'hyperspace.analysis.validate',
    'hyperspace.faults.enabled', 'hyperspace.faults.maxDelaySeconds',
    'hyperspace.retry.maxAttempts', 'hyperspace.retry.backoffBaseSeconds',
    'hyperspace.retry.casAttempts', 'hyperspace.fallback.enabled', 'hyperspace.obs.enabled',
    'hyperspace.obs.sink', 'hyperspace.obs.http.enabled', 'hyperspace.obs.http.host',
    'hyperspace.obs.http.port', 'hyperspace.obs.events.maxEvents',
    'hyperspace.obs.slo.availabilityTarget', 'hyperspace.obs.slo.latencyP99Seconds',
    'hyperspace.obs.journal.enabled', 'hyperspace.obs.journal.dir',
    'hyperspace.obs.journal.segmentBytes', 'hyperspace.obs.journal.maxBytes',
    'hyperspace.obs.journal.snapshotSeconds', 'hyperspace.recover.onAccess',
    'hyperspace.recover.graceSeconds', 'hyperspace.serve.workers',
    'hyperspace.serve.maxQueueDepth', 'hyperspace.serve.queryTimeoutSeconds',
    'hyperspace.serve.planCache.enabled', 'hyperspace.serve.planCache.maxEntries',
    'hyperspace.serve.resultCache.enabled', 'hyperspace.serve.resultCache.maxBytes',
    'hyperspace.serve.tenant.quota.enabled', 'hyperspace.serve.tenant.quota.ratePerSecond',
    'hyperspace.serve.tenant.quota.burst', 'hyperspace.serve.shedDepthRatio',
    'hyperspace.fleet.cache.dir', 'hyperspace.fleet.cache.maxBytes',
    'hyperspace.fleet.lease.seconds', 'hyperspace.fleet.singleflight.waitSeconds',
    'hyperspace.fleet.workers', 'hyperspace.fleet.minWorkers', 'hyperspace.fleet.maxRestarts',
    'hyperspace.fleet.restartBackoffSeconds', 'hyperspace.controller.enabled',
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
    'hyperspace.advisor.minConfidence', 'hyperspace.advisor.minBenefitSeconds',
    'hyperspace.ingest.enabled', 'hyperspace.ingest.pollSeconds', 'hyperspace.ingest.cdcBatchRows',
    'hyperspace.ingest.autoCompact', 'hyperspace.ingest.processWorker',
    'hyperspace.ingest.maxLagSeconds',
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


@dataclasses.dataclass
class HyperspaceConf:
    """Per-session configuration with string-key overrides."""

    system_path: str = ""
    num_buckets: int = DEFAULT_NUM_BUCKETS
    join_broadcast_max_rows: int = DEFAULT_JOIN_BROADCAST_MAX_ROWS
    join_rebucketize: str = DEFAULT_JOIN_REBUCKETIZE
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
        return default

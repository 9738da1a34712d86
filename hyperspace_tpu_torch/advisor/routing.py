"""Adaptive query routing: measured-outcome demotion of index rewrites.

A port of the JAX package's `advisor/routing.py`. The rewrite rules fire
on every eligible plan, but the rewrite is a bet, and for some plans the
bet loses. This ledger makes the bet empirical: per plan
signature it keeps EMA-smoothed wall times of the *indexed* and *raw*
paths as actually measured by ``session.run_query``, and once both sides
have evidence it **demotes** a signature whose indexed path measured
slower — the query thereafter plans straight against the source, while
queries the index speeds up keep their indexed plans.

Invalidation is versioned like the serve caches (serve/plan_cache.py):
the ledger state is stamped with the index-collection log versions; any
committed index mutation (create/refresh/optimize/delete/restore/vacuum)
bumps a log id, the stamp mismatches, and ALL entries drop — a demotion
earned against the old index generation never outlives it (re-promotion
on mutation is structural, not event-driven). The stamp is the JAX
package's, over the same (index dir, latest log id) pairs, so one
`routing.json` serves both packages.

Persistence: ``<system_path>/_advisor/routing.json`` through the atomic,
retried ``file_utils.write_json`` — but the ledger is ADVISORY by
contract: a persistence failure is counted
(``advisor.routing.persist_failed``) and never fails a query.

Knobs: ``hyperspace.advisor.routing.enabled`` (off by default — routing
changes plans, so it is an explicit opt-in), ``.demoteRatio`` (demote
when indexed EMA > ratio x raw EMA), ``.alpha`` (EMA smoothing),
``.minSamples`` (evidence floor per side). A pinned reader
(ingest/snapshot.py) keys the ledger on its snapshot's own stamp
(`snapshot_stamp`), so a concurrent commit it cannot see does not wipe
its evidence.
"""

from __future__ import annotations

import hashlib
import threading
from pathlib import Path

from hyperspace_tpu_torch.obs import metrics as obs_metrics

ADVISOR_DIR = "_advisor"
LEDGER_FILE = "routing.json"

_RECORDS = obs_metrics.counter(
    "advisor.routing.records", "outcome samples recorded into the routing ledger"
)
_DEMOTIONS = obs_metrics.counter(
    "advisor.routing.demotions", "queries routed to source scan by the ledger"
)
_PERSIST_FAILED = obs_metrics.counter(
    "advisor.routing.persist_failed", "advisory ledger writes that failed"
)
_INVALIDATIONS = obs_metrics.counter(
    "advisor.routing.invalidations", "ledger wipes on index-collection mutation"
)


def collection_stamp(session) -> str:
    """Version stamp of the whole index collection — the MD5 fold of
    (index dir, latest log id) pairs the serve caches also key on. Any
    committed index mutation changes it."""
    from hyperspace_tpu_torch.serve.plan_cache import collection_log_versions

    payload = repr(collection_log_versions(session)).encode()
    return hashlib.md5(payload).hexdigest()


def snapshot_stamp(snapshot) -> str:
    """Version stamp of a pinned snapshot's admitted world: the same MD5
    fold over the snapshot's own (index dir, log id) pairs, so a pinned
    query keys the ledger on its read point instead of the live versions."""
    payload = repr(snapshot.stamp).encode()
    return hashlib.md5(payload).hexdigest()


class RoutingLedger:
    """Per-plan-signature outcome ledger with versioned invalidation.

    Persistence is debounced: a record() persists immediately when it
    CHANGES the signature's routing verdict (a demotion earned must
    survive the process), else every PERSIST_EVERY samples — an atomic
    fsync'd write per query would tax exactly the hot path routing
    exists to speed up. `flush()` forces the write (bench/shutdown)."""

    PERSIST_EVERY = 32

    def __init__(self, session):
        self._session = session
        self._lock = threading.Lock()
        # signature -> {"indexed": [ema, n], "raw": [ema, n]}
        self._entries: dict[str, dict] = {}
        self._stamp: str | None = None
        self._loaded = False
        self._unpersisted = 0

    @property
    def path(self) -> Path:
        return Path(self._session.conf.system_path) / ADVISOR_DIR / LEDGER_FILE

    # -- state ------------------------------------------------------------
    def _load_locked(self) -> None:
        """Lazy one-time load of the persisted ledger (under self._lock)."""
        if self._loaded:
            return
        self._loaded = True
        from hyperspace_tpu_torch.utils import file_utils

        try:
            doc = file_utils.read_json(self.path)
            self._stamp = doc.get("stamp")
            self._entries = dict(doc.get("entries", {}))
        except (OSError, ValueError):
            # No ledger yet (first run) or an unreadable one — start
            # empty; the ledger re-earns its evidence.
            self._stamp = None
            self._entries = {}

    def _sync_stamp_locked(self, stamp: str) -> None:
        """Drop every entry when the index collection mutated since the
        ledger last recorded (structural re-promotion)."""
        if self._stamp != stamp:
            if self._stamp is not None and self._entries:
                _INVALIDATIONS.inc()
            self._entries = {}
            self._stamp = stamp

    # -- API ---------------------------------------------------------------
    def decide(self, signature: str, stamp: str | None = None) -> str:
        """Route `signature`: ``"indexed"`` (default — the rewrite keeps
        the benefit of the doubt) or ``"raw"`` once BOTH paths have
        enough samples and the indexed EMA measured slower than
        demoteRatio x the raw EMA. An operator/controller `pin`
        overrides the measured verdict outright."""
        conf = self._session.conf
        stamp = collection_stamp(self._session) if stamp is None else stamp
        with self._lock:
            self._load_locked()
            self._sync_stamp_locked(stamp)
            entry = self._entries.get(signature)
            if entry is not None and entry.get("pinned") in ("indexed", "raw"):
                if entry["pinned"] == "raw":
                    _DEMOTIONS.inc()
                return entry["pinned"]
            if entry is not None and self._demoted_locked(entry, conf):
                _DEMOTIONS.inc()
                return "raw"
            return "indexed"

    def pin(self, signature: str, mode: str = "raw",
            stamp: str | None = None) -> None:
        """Pin `signature` to a route unconditionally (the OpsController's
        recompile-storm response pins to ``"raw"``). Pins ride the same
        versioned stamp as the measured evidence: any committed index
        mutation wipes them — structural re-promotion, exactly like
        demotions. Persisted immediately (a pin must survive the
        process)."""
        if mode not in ("indexed", "raw"):
            raise ValueError(f"unknown routing mode {mode!r} (indexed|raw)")
        stamp = collection_stamp(self._session) if stamp is None else stamp
        with self._lock:
            self._load_locked()
            self._sync_stamp_locked(stamp)
            self._entries.setdefault(signature, {})["pinned"] = mode
            self._unpersisted = 0
            doc = self._doc_locked()
        self._persist(doc)

    def record(self, signature: str, mode: str, wall_s: float,
               stamp: str | None = None) -> None:
        """Fold one measured outcome (`mode` is ``"indexed"``/``"raw"``)
        into the EMA for `signature` and persist. Advisory: persistence
        failures are counted, never raised."""
        if mode not in ("indexed", "raw"):
            raise ValueError(f"unknown routing mode {mode!r} (indexed|raw)")
        conf = self._session.conf
        alpha = float(conf.advisor_routing_alpha)
        stamp = collection_stamp(self._session) if stamp is None else stamp
        with self._lock:
            self._load_locked()
            self._sync_stamp_locked(stamp)
            entry = self._entries.setdefault(signature, {})
            verdict_before = self._demoted_locked(entry, conf)
            cell = entry.get(mode)
            if cell is None:
                entry[mode] = [float(wall_s), 1]
            else:
                cell[0] = alpha * float(wall_s) + (1.0 - alpha) * cell[0]
                cell[1] = int(cell[1]) + 1
            self._unpersisted += 1
            verdict_changed = self._demoted_locked(entry, conf) != verdict_before
            if not verdict_changed and self._unpersisted < self.PERSIST_EVERY:
                doc = None
            else:
                self._unpersisted = 0
                doc = self._doc_locked()
        _RECORDS.inc()
        if doc is not None:
            self._persist(doc)

    def _doc_locked(self) -> dict:
        """Deep copy of the state (under self._lock): the persist write
        runs outside the lock, and a peer thread's record() must not
        mutate what json is serializing."""
        return {
            "stamp": self._stamp,
            "entries": {
                k: {m: (list(c) if isinstance(c, list) else c) for m, c in v.items()}
                for k, v in self._entries.items()
            },
        }

    @staticmethod
    def _demoted_locked(entry: dict, conf) -> bool:
        idx, raw = entry.get("indexed"), entry.get("raw")
        n_min = max(int(conf.advisor_routing_min_samples), 1)
        if not idx or not raw or idx[1] < n_min or raw[1] < n_min:
            return False
        return idx[0] > float(conf.advisor_routing_demote_ratio) * raw[0]

    def flush(self) -> None:
        """Force-persist the in-memory state (advisory like every other
        ledger write)."""
        with self._lock:
            self._load_locked()
            self._unpersisted = 0
            doc = self._doc_locked()
        self._persist(doc)

    def _persist(self, doc: dict) -> None:
        from hyperspace_tpu_torch.obs import trace as obs_trace
        from hyperspace_tpu_torch.utils import file_utils

        try:
            file_utils.write_json(self.path, doc)
        except Exception as e:
            # Advisory by contract: the ledger influences plan CHOICE,
            # never correctness — a failed write only delays learning.
            _PERSIST_FAILED.inc()
            obs_trace.event("advisor.routing.persist_failed", error=str(e))

    def snapshot(self) -> dict:
        """Copy of the ledger state (tests / smoke evidence)."""
        with self._lock:
            self._load_locked()
            return {
                "stamp": self._stamp,
                "entries": {k: dict(v) for k, v in self._entries.items()},
            }

    def demoted_signatures(self) -> list[str]:
        """Signatures decide() would currently route raw — measured
        demotions plus raw pins (report evidence; does not bump the
        demotion counter)."""
        conf = self._session.conf
        out = []
        with self._lock:
            self._load_locked()
            for sig, entry in self._entries.items():
                if entry.get("pinned") == "raw" or (
                    entry.get("pinned") != "indexed"
                    and self._demoted_locked(entry, conf)
                ):
                    out.append(sig)
        return sorted(out)

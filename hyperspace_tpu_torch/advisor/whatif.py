"""What-if analyzer: hypothetical indexes replayed through the REAL rules.

A port of the JAX package's `advisor/whatif.py`. The honest way to
answer "would an index on (root, cols) help this workload?" is to
construct a hypothetical :class:`IndexLogEntry` for it and push the
observed plans through the *production* rewrite machinery —
``rules/base.apply_rules`` (JoinIndexRule + FilterIndexRule, including
:class:`~hyperspace_tpu_torch.rules.ranker.JoinIndexRanker`) and the plan
validator — exactly as the optimizer would at query time. A candidate
only survives if the real rules actually rewrite the plan with it and
the rewritten plan validates; the calibrated cost model (cost.py) then
prices the rewrite. No parallel "would it match" reimplementation exists
to drift from the rules. Each distinct plan (by signature) replays once,
where the JAX package replays every record; the verdicts are the same,
and a workload of repeated queries costs a replay a query shape.

Recommendation kinds:

- ``create``  — a hot filter/join predicate over a raw scan, uncovered
  by any ACTIVE index, whose replay rewrote and whose estimated benefit
  is positive;
- ``drop``    — an ACTIVE index no observed query touched (paying
  refresh/storage rent for nothing);
- ``rebucket``— two ACTIVE indexes joined by the workload whose bucket
  counts differ, so the ranker can never give the join its zero-exchange
  pair (JoinIndexRanker.score ranks equal counts first);
- ``optimize``— an ACTIVE index fragmented past
  ``hyperspace.advisor.lifecycle.maxDeltas`` delta directories.

Entry point contract: :meth:`WhatIfAnalyzer.recommend` hosts the
``advisor.recommend`` fault point — the injection harness can kill a
recommendation pass at its head and the crash sweeps prove nothing
downstream is left half-applied (recommendation is pure analysis; only
lifecycle.py mutates, behind its own fault point).
"""

from __future__ import annotations

import dataclasses
import tempfile
from collections import defaultdict
from pathlib import Path

from hyperspace_tpu_torch import faults
from hyperspace_tpu_torch import states
from hyperspace_tpu_torch.advisor.cost import CostModel
from hyperspace_tpu_torch.advisor.workload import (
    WorkloadRecord,
    mine_predicate_shapes,
)
from hyperspace_tpu_torch.index.index_config import IndexConfig
from hyperspace_tpu_torch.metadata.log_entry import (
    Content,
    CoveringIndex,
    IndexLogEntry,
    Source,
)
from hyperspace_tpu_torch.obs import metrics as obs_metrics
from hyperspace_tpu_torch.obs import trace as obs_trace
from hyperspace_tpu_torch.plan.nodes import Join, LogicalPlan, Scan
from hyperspace_tpu_torch.plan.prune import prune_columns
from hyperspace_tpu_torch.plan.pushdown import push_down_filters
from hyperspace_tpu_torch.rules.base import apply_rules
from hyperspace_tpu_torch.rules.join_index_rule import _side_scan
from hyperspace_tpu_torch.rules.ranker import JoinIndexRanker
from hyperspace_tpu_torch.signature import FileBasedSignatureProvider, collect_leaf_files

_RECOMMENDATIONS = obs_metrics.counter(
    "advisor.recommendations", "recommendations emitted by the what-if analyzer"
)
_REPLAYS = obs_metrics.counter(
    "advisor.replays", "hypothetical-index rule replays executed"
)


@dataclasses.dataclass
class Recommendation:
    """One ranked advisor verdict. `estimated_benefit_s` is the summed
    per-workload-replay saving the cost model predicts; `confidence`
    folds evidence volume (queries matched, calibration samples) into
    [0, 1] so the lifecycle policy can gate on it."""

    kind: str  # create | drop | rebucket | optimize
    estimated_benefit_s: float
    confidence: float
    reason: str
    index_name: str | None = None  # drop/rebucket/optimize target
    index_config: IndexConfig | None = None  # create spec
    source_root: str | None = None
    source_plan: LogicalPlan | None = None  # create lineage (in-memory)
    num_buckets: int | None = None  # rebucket target
    queries_matched: int = 0

    def to_json(self) -> dict:
        return {
            "kind": self.kind,
            "estimated_benefit_s": round(self.estimated_benefit_s, 6),
            "confidence": round(self.confidence, 3),
            "reason": self.reason,
            "index_name": self.index_name,
            "index_config": (
                {
                    "name": self.index_config.index_name,
                    "indexedColumns": list(self.index_config.indexed_columns),
                    "includedColumns": list(self.index_config.included_columns),
                }
                if self.index_config is not None
                else None
            ),
            "source_root": self.source_root,
            "num_buckets": self.num_buckets,
            "queries_matched": self.queries_matched,
        }


def hypothetical_entry(
    scan: Scan, indexed: list[str], included: list[str], num_buckets: int,
    content_root: str, name: str = "__whatif__",
) -> IndexLogEntry | None:
    """A log entry for an index that does not exist: real signature
    (computed live over the scan's files — the rules' match test), real
    schema, but content rooted at an empty scratch dir. The rules can
    match and rewrite with it; nothing can (or does) execute it. Returns
    None when the source cannot be fingerprinted."""
    fp = FileBasedSignatureProvider().signature(scan)
    if fp is None:
        return None
    cols = [scan.scan_schema.field(c).name for c in [*indexed, *included]]
    schema = scan.scan_schema.select(cols)
    vdir = Path(content_root) / "v__=0"
    vdir.mkdir(parents=True, exist_ok=True)
    return IndexLogEntry(
        id=0,
        state=states.ACTIVE,
        name=name,
        derived_dataset=CoveringIndex(
            indexed_columns=[scan.scan_schema.field(c).name for c in indexed],
            included_columns=[scan.scan_schema.field(c).name for c in included],
            schema=schema.to_json(),
            num_buckets=int(num_buckets),
        ),
        content=Content(root=str(content_root), directories=["v__=0"]),
        source=Source(
            plan=scan.to_json(),
            fingerprint=fp,
            files=collect_leaf_files(scan),
        ),
    )


def _validates(optimized: LogicalPlan) -> bool:
    from hyperspace_tpu_torch.analysis.validator import validate_plan

    try:
        return not any(d.severity == "error" for d in validate_plan(optimized))
    except Exception:
        return False


@dataclasses.dataclass(frozen=True)
class _CreateKey:
    root: str
    indexed: tuple[str, ...]  # lowercased
    included: tuple[str, ...]  # lowercased


class WhatIfAnalyzer:
    """Replay-based recommendation engine over a session's workload."""

    def __init__(self, session, cost_model: CostModel | None = None):
        self.session = session
        self._cost = cost_model

    # -- entry point ------------------------------------------------------
    def recommend(self, records: list[WorkloadRecord] | None = None) -> list[Recommendation]:
        """Ranked recommendations for the observed workload (most
        beneficial first). With no `records`, the session's own workload
        log is used. Pure analysis: no index is touched."""
        faults.fault_point("advisor.recommend")
        with obs_trace.span("advisor.recommend"):
            if records is None:
                records = self.session.workload.snapshot()
            cost = self._cost or CostModel.fit(r.profile for r in records)
            existing = self.session.manager.get_indexes()
            recs: list[Recommendation] = []
            recs += self._create_recs(records, existing, cost)
            recs += self._drop_recs(records, existing, cost)
            recs += self._rebucket_recs(records, existing, cost)
            recs += self._optimize_recs(existing, cost)
            recs.sort(key=lambda r: -r.estimated_benefit_s)
            _RECOMMENDATIONS.inc(len(recs))
            obs_trace.annotate(
                recommendations=len(recs), workload_records=len(records)
            )
            return recs

    # -- create -----------------------------------------------------------
    def _create_recs(self, records, existing, cost: CostModel) -> list[Recommendation]:
        """Hot filter shapes over raw scans → replay a hypothetical
        covering index through the real rules; keep candidates that
        rewrote, validated, and priced positive."""
        groups: dict[_CreateKey, dict] = defaultdict(
            lambda: {"records": [], "scan": None, "bytes": 0.0}
        )
        for rec in records:
            optimizable = prune_columns(push_down_filters(rec.plan))
            for shape, scan in mine_predicate_shapes(optimizable):
                key = _CreateKey(
                    shape.root,
                    shape.filter_columns,
                    tuple(c for c in shape.required_columns if c not in shape.filter_columns),
                )
                g = groups[key]
                g["records"].append(rec)
                g["scan"] = scan
                # MAX observed bytes, not the mean: repeat queries served
                # from the decoded-table cache record 0 bytes scanned,
                # but the index exists precisely for the cold case the
                # first run measured (production working sets do not fit
                # the cache).
                g["bytes"] = max(g["bytes"], float(rec.bytes_scanned))
        num_buckets = int(self.session.conf.num_buckets)
        out: list[Recommendation] = []
        for i, (key, g) in enumerate(sorted(groups.items(), key=lambda kv: repr(kv[0]))):
            scan: Scan = g["scan"]
            n = len(g["records"])
            benefit_per_query = cost.indexed_benefit_s(g["bytes"], num_buckets)
            if benefit_per_query <= 0.0:
                continue
            # Records of one signature replay alike (the rules see the
            # same plan and catalog), so each distinct plan replays once.
            distinct: dict = {}
            for r in g["records"]:
                distinct.setdefault(r.signature, r.plan)
            replay_ok = self._replay_filter(
                scan, list(key.indexed), list(key.included),
                num_buckets, list(distinct.values()), existing, i,
            )
            if not replay_ok:
                continue
            name = f"adv_{Path(key.root).name}_{'_'.join(key.indexed)}"[:64]
            config = IndexConfig(
                name,
                [scan.scan_schema.field(c).name for c in key.indexed],
                [scan.scan_schema.field(c).name for c in key.included],
            )
            out.append(Recommendation(
                kind="create",
                estimated_benefit_s=benefit_per_query * n,
                confidence=self._confidence(n, cost),
                reason=(
                    f"{n} observed queries filter {key.indexed} on "
                    f"{key.root} with no covering index; replay through "
                    f"the rewrite rules confirms an index would serve them "
                    f"(est. {benefit_per_query * 1e3:.2f}ms/query saved at "
                    f"{num_buckets} buckets)"
                ),
                index_config=config,
                source_root=key.root,
                source_plan=scan,
                num_buckets=num_buckets,
                queries_matched=n,
            ))
        return out

    def _replay_filter(
        self, scan, indexed, included, num_buckets, plans, existing, seq: int
    ) -> bool:
        """True iff the REAL rules rewrite at least one observed plan
        with the hypothetical entry (and not already with an existing
        index) and the rewritten plan validates."""
        _REPLAYS.inc()
        with tempfile.TemporaryDirectory(prefix="hs_whatif_") as td:
            entry = hypothetical_entry(
                scan, indexed, included, num_buckets, td, name=f"__whatif_{seq}__"
            )
            if entry is None:
                return False
            for plan in plans:
                optimizable = prune_columns(push_down_filters(plan))
                # Already served by a real index? Then this shape needs no
                # new one — replay against the EXISTING catalog first.
                already = apply_rules(optimizable, list(existing), conf=self.session.conf)
                if any(s.bucket_spec is not None for s in already.leaves()):
                    continue
                rewritten = apply_rules(
                    optimizable, [*existing, entry], conf=self.session.conf
                )
                hit = any(
                    s.bucket_spec is not None and str(s.root) == str(td)
                    for s in rewritten.leaves()
                )
                if hit and _validates(rewritten):
                    return True
        return False

    # -- drop -------------------------------------------------------------
    def _drop_recs(self, records, existing, cost: CostModel) -> list[Recommendation]:
        """ACTIVE indexes the workload never touched. Needs a non-empty
        workload — with zero observed queries, "unused" is vacuous and
        recommending drops would be destructive guesswork."""
        if not records:
            return []
        used: set[str] = set()
        for rec in records:
            used.update(rec.index_names)
        out: list[Recommendation] = []
        for entry in existing:
            dir_name = Path(entry.content.root).name
            if dir_name in used:
                continue
            src_bytes = float(sum(f.size for f in entry.source.files))
            # Rent the index pays per refresh cycle: rebuilding it scans
            # the source again; storage rides along in the reason only.
            benefit = cost.estimate_scan_s(src_bytes)
            out.append(Recommendation(
                kind="drop",
                estimated_benefit_s=benefit,
                confidence=self._confidence(len(records), cost),
                reason=(
                    f"index {entry.name!r} served none of the "
                    f"{len(records)} observed queries; each refresh "
                    f"re-scans {src_bytes / 1e6:.1f}MB of source for "
                    f"nothing"
                ),
                index_name=entry.name,
                source_root=str(entry.content.root),
                queries_matched=0,
            ))
        return out

    # -- rebucket ---------------------------------------------------------
    def _rebucket_recs(self, records, existing, cost: CostModel) -> list[Recommendation]:
        """Workload-joined index pairs with unequal bucket counts: the
        ranker (JoinIndexRanker.score) can never hand the join its
        zero-exchange pair, so every such query pays a query-time
        re-bucketing exchange. Recommend re-bucketing the smaller index
        to the larger count."""
        by_root: dict[str, list[IndexLogEntry]] = defaultdict(list)
        for entry in existing:
            if entry.derived_dataset.kind != "CoveringIndex":
                continue
            src_root = (entry.source.plan or {}).get("root")
            if src_root:
                by_root[str(src_root)].append(entry)

        def candidate(root: str, keys: set[str]) -> IndexLogEntry | None:
            # A root can carry several indexes (the fact table does);
            # only one bucketed on exactly the join keys is join-usable.
            for e in by_root.get(root, ()):
                if {c.lower() for c in e.indexed_columns} == keys:
                    return e
            return None

        joined: dict[tuple[str, str], int] = defaultdict(int)
        for rec in records:
            for l_scan, r_scan, join in self._joined_scans(rec.plan):
                le = candidate(str(l_scan.root), {c.lower() for c in join.left_on})
                re_ = candidate(str(r_scan.root), {c.lower() for c in join.right_on})
                if le is None or re_ is None:
                    continue
                if le.num_buckets != re_.num_buckets:
                    joined[(le.name, re_.name)] += 1
        out: list[Recommendation] = []
        entries = {e.name: e for e in existing}
        for (lname, rname), n in sorted(joined.items()):
            le, re_ = entries[lname], entries[rname]
            # The ranker itself justifies the verdict: the aligned pair
            # must outrank the current mismatched one.
            target = max(le.num_buckets, re_.num_buckets)
            small = le if le.num_buckets < re_.num_buckets else re_
            aligned_beats = JoinIndexRanker.score((le, le)) < JoinIndexRanker.score((le, re_))
            if not aligned_beats:
                continue
            src_bytes = float(sum(f.size for f in small.source.files))
            # Saving per query: the mismatched side's re-bucketing
            # exchange (hash + regroup of its rows) goes away.
            benefit = n * (cost.per_operator_seconds + 0.25 * cost.estimate_scan_s(src_bytes))
            out.append(Recommendation(
                kind="rebucket",
                estimated_benefit_s=benefit,
                confidence=self._confidence(n, cost),
                reason=(
                    f"{n} observed joins pair {lname!r} ({le.num_buckets} "
                    f"buckets) with {rname!r} ({re_.num_buckets}); the "
                    f"ranker prefers equal counts (zero-exchange) — "
                    f"re-bucket {small.name!r} to {target}"
                ),
                index_name=small.name,
                num_buckets=target,
                queries_matched=n,
            ))
        return out

    @staticmethod
    def _joined_scans(plan: LogicalPlan):
        """(left raw-or-index source scan, right ditto, join) triples."""
        out = []

        def walk(p):
            if isinstance(p, Join):
                ls = _side_scan(p.left) or next(
                    (s for s in p.left.leaves()), None
                )
                rs = _side_scan(p.right) or next(
                    (s for s in p.right.leaves()), None
                )
                if isinstance(ls, Scan) and isinstance(rs, Scan):
                    out.append((ls, rs, p))
            for c in p.children():
                walk(c)

        walk(plan)
        return out

    # -- optimize ---------------------------------------------------------
    def _optimize_recs(self, existing, cost: CostModel) -> list[Recommendation]:
        """Fragmented indexes: incremental refresh appends delta dirs;
        past the policy threshold every query unions that many extra
        bucket-file sets."""
        max_deltas = int(self.session.conf.advisor_lifecycle_max_deltas)
        out: list[Recommendation] = []
        for entry in existing:
            n_dirs = len(entry.content.directories)
            if n_dirs <= max_deltas:
                continue
            src_bytes = float(sum(f.size for f in entry.source.files))
            benefit = (n_dirs - 1) * cost.per_operator_seconds + 0.1 * cost.estimate_scan_s(src_bytes)
            out.append(Recommendation(
                kind="optimize",
                estimated_benefit_s=benefit,
                confidence=1.0,  # fragmentation is directly observed, not inferred
                reason=(
                    f"index {entry.name!r} spans {n_dirs} version dirs "
                    f"(> maxDeltas={max_deltas}); compaction merges the "
                    f"delta buckets back into one set of files"
                ),
                index_name=entry.name,
                queries_matched=0,
            ))
        return out

    # -- shared -----------------------------------------------------------
    @staticmethod
    def _confidence(n_queries: int, cost: CostModel) -> float:
        """Evidence volume → [0, 1]: half from how many observed queries
        back the verdict (saturating at 8), half from how calibrated the
        cost model is (saturating at 4 contributing profiles)."""
        q = min(1.0, n_queries / 8.0)
        c = min(1.0, cost.samples / 4.0)
        return round(0.5 * q + 0.5 * c, 3)

"""Autonomous index lifecycle: the opt-in engine that ACTS on advice.

A port of the JAX package's `advisor/lifecycle.py`.
``LifecyclePolicy.sweep()`` asks the what-if analyzer for ranked
recommendations and executes the ones the policy gates allow:

- ``create``   — when ``hyperspace.advisor.lifecycle.autoCreate`` is on:
  build the recommended covering index (hot predicates get their index
  without an operator in the loop);
- ``drop``     — when ``autoVacuum`` is on: delete THEN vacuum the cold
  index (both through the normal two-phase actions);
- ``optimize`` — when ``autoOptimize`` is on: compact a fragmented
  index's delta dirs;
- ``rebucket`` — always report-only: changing a bucket count rebuilds
  the index under a different layout, a capacity decision the policy
  surfaces but does not take autonomously.

Every mutation goes through the existing ``Hyperspace`` API and
therefore the crash-safe ``Action`` two-phase protocol — a process dying
mid-apply leaves a transient log entry that ``recover()`` repairs, same
as any human-initiated action. The ``advisor.apply`` fault point fires
in ``sweep()`` IMMEDIATELY BEFORE each mutation: an injected
``CrashPoint`` there proves the sweep itself never leaves partial state
(nothing has mutated yet), and an injected transient ``FaultError``
surfaces through the declared error contract. A mutation that fails with
an ordinary ``Exception`` is recorded (``advisor.apply_failed`` counter
+ trace event) and the sweep continues — one broken recommendation must
not starve the rest — while a ``CrashPoint`` propagates like the process
death it simulates.

All three gates default OFF: the advisor observes by default and acts
only by explicit opt-in.
"""

from __future__ import annotations

from hyperspace_tpu_torch import faults
from hyperspace_tpu_torch.advisor.whatif import Recommendation, WhatIfAnalyzer
from hyperspace_tpu_torch.obs import metrics as obs_metrics
from hyperspace_tpu_torch.obs import trace as obs_trace

_APPLIED = obs_metrics.counter(
    "advisor.applied", "lifecycle mutations executed from recommendations"
)
_APPLY_FAILED = obs_metrics.counter(
    "advisor.apply_failed", "lifecycle mutations that raised and were recorded"
)
_SKIPPED = obs_metrics.counter(
    "advisor.skipped", "recommendations below the policy gates"
)


class LifecyclePolicy:
    """Policy gates + executor over advisor recommendations."""

    def __init__(self, hyperspace, analyzer: WhatIfAnalyzer | None = None):
        # `hyperspace` is the user-facing API facade (hyperspace.Hyperspace):
        # every mutation below goes through its public surface, so the
        # advisor has exactly the powers an operator has — no private
        # side doors into the log.
        self.hyperspace = hyperspace
        self.session = hyperspace.session
        self.analyzer = analyzer or WhatIfAnalyzer(self.session)

    def _allowed(self, rec: Recommendation) -> bool:
        conf = self.session.conf
        if rec.kind == "create":
            allowed = conf.advisor_auto_create
        elif rec.kind == "drop":
            allowed = conf.advisor_auto_vacuum
        elif rec.kind == "optimize":
            allowed = conf.advisor_auto_optimize
        else:  # rebucket: report-only by design (module docstring)
            return False
        if not allowed:
            return False
        if rec.confidence < float(conf.advisor_min_confidence):
            return False
        return rec.estimated_benefit_s >= float(conf.advisor_min_benefit_seconds)

    def sweep(self, recommendations: list[Recommendation] | None = None) -> dict:
        """One policy pass: recommend (unless given), gate, apply.
        Returns a report of applied / skipped / failed entries; every
        applied mutation is individually crash-safe (module docstring)."""
        with obs_trace.span("advisor.sweep"):
            if recommendations is None:
                recommendations = self.analyzer.recommend()
            report: dict = {"applied": [], "skipped": [], "failed": []}
            for rec in recommendations:
                if not self._allowed(rec):
                    _SKIPPED.inc()
                    report["skipped"].append(rec.to_json())
                    continue
                faults.fault_point("advisor.apply")
                try:
                    with obs_trace.span(
                        "advisor.apply", kind=rec.kind, index=rec.index_name
                    ):
                        self._apply(rec)
                except Exception as e:
                    # One failed mutation (its own Action already rolled
                    # back / quarantined) must not starve the remaining
                    # recommendations — record and continue. CrashPoint
                    # is a BaseException and propagates: a dying process
                    # does not keep sweeping.
                    _APPLY_FAILED.inc()
                    obs_trace.event(
                        "advisor.apply_failed", kind=rec.kind, error=str(e)
                    )
                    failed = rec.to_json()
                    failed["error"] = f"{type(e).__name__}: {e}"
                    report["failed"].append(failed)
                    continue
                _APPLIED.inc()
                report["applied"].append(rec.to_json())
            return report

    def _apply(self, rec: Recommendation) -> None:
        if rec.kind == "create":
            self.hyperspace.create_index(rec.source_plan, rec.index_config)
        elif rec.kind == "drop":
            # Cold index: delete (reversible via restore) then vacuum
            # (physical removal) — the two-step the manual API requires,
            # each its own crash-safe action.
            self.hyperspace.delete_index(rec.index_name)
            self.hyperspace.vacuum_index(rec.index_name)
        elif rec.kind == "optimize":
            self.hyperspace.optimize_index(rec.index_name)
        else:
            raise ValueError(f"unapplicable recommendation kind {rec.kind!r}")

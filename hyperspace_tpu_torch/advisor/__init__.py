"""Workload-driven index advisor.

A port of the JAX package's `advisor/` (host code: it reads plans,
profiles and index logs, and mutates only through the facade). Three
cooperating layers close the self-tuning loop over the evidence the
observability and serving planes already record:

- **What-if analyzer** (`advisor/whatif.py` + `advisor/cost.py`): replay
  the observed workload (per-query :class:`WorkloadRecord`\\ s carrying
  plan + measured profile) through the real rewrite rules and plan
  validator against *hypothetical* index specs mined from the filter /
  join predicates, cost them with a model calibrated from measured
  per-operator wall/bytes, and emit ranked create / drop / re-bucket /
  optimize recommendations with estimated benefit and confidence.
- **Adaptive query routing** (`advisor/routing.py`): a per-plan-
  signature outcome ledger (indexed vs raw wall, EMA-smoothed, persisted
  under ``<system_path>/_advisor/``, versioned-key invalidated on index
  mutation like the serve caches) demotes a rewrite to source scan when
  the indexed path has MEASURED slower.
- **Autonomous lifecycle** (`advisor/lifecycle.py`): an opt-in policy
  engine that executes recommendations — auto-create hot indexes,
  auto-vacuum cold ones, auto-optimize fragmented ones — every mutation
  crash-safe through the existing `Action` state machine, with the
  ``advisor.recommend`` / ``advisor.apply`` fault points wired into the
  injection harness.
"""

from hyperspace_tpu_torch.advisor.cost import CostModel
from hyperspace_tpu_torch.advisor.lifecycle import LifecyclePolicy
from hyperspace_tpu_torch.advisor.routing import RoutingLedger
from hyperspace_tpu_torch.advisor.whatif import Recommendation, WhatIfAnalyzer
from hyperspace_tpu_torch.advisor.workload import WorkloadLog, WorkloadRecord

__all__ = [
    "CostModel",
    "LifecyclePolicy",
    "Recommendation",
    "RoutingLedger",
    "WhatIfAnalyzer",
    "WorkloadLog",
    "WorkloadRecord",
]

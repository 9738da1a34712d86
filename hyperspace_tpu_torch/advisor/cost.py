"""Calibrated cost model: measured profiles in, what-if estimates out.

A port of the JAX package's `advisor/cost.py`. The model is deliberately
small and *fitted from this session's own measurements* rather than
hand-tuned constants: every completed
:class:`~hyperspace_tpu_torch.obs.profile.QueryProfile` carries
per-operator measured wall time and bytes scanned, and the advisor feeds
those samples here. Calibration derives

- ``scan_seconds_per_byte`` — median wall/bytes over scan operators that
  actually decoded data (the IO+decode throughput of THIS machine);
- ``per_operator_seconds`` — median self-time of non-scan operators (the
  fixed per-operator overhead a rewrite cannot remove);
- ``plan_overhead_s`` — median gap between end-to-end wall and operator
  self-time (optimizer + marshalling, the cost an indexed plan pays on
  top of its operators).

Profile times are host walls (the card's work is not waited for inside
an operator), so on the card the model prices the host's share of a
query; the relative verdicts it feeds are what the advisor acts on.

Estimates are **monotonic in bytes by construction** (a * bytes + b with
a, b >= 0) — tests pin this, because a non-monotonic cost model can
"justify" any recommendation.
"""

from __future__ import annotations

import dataclasses
import statistics


_SCAN_OPS = ("TableScan", "IndexScan", "Scan")


@dataclasses.dataclass
class CostModel:
    """Fitted throughput/overhead constants (seconds, bytes)."""

    scan_seconds_per_byte: float = 5e-10  # ~2 GB/s decode: pre-fit default
    per_operator_seconds: float = 1e-4
    plan_overhead_s: float = 1e-3
    samples: int = 0

    @staticmethod
    def fit(profiles) -> "CostModel":
        """Calibrate from measured QueryProfiles; falls back to the
        defaults above until enough evidence exists (samples counts the
        profiles that contributed at least one operator sample)."""
        scan_rates: list[float] = []
        op_selfs: list[float] = []
        overheads: list[float] = []
        used = 0
        for prof in profiles:
            if prof is None or getattr(prof, "root", None) is None:
                continue
            contributed = False
            for op in prof.operators():
                b = op.detail.get("bytes")
                if op.op.startswith(_SCAN_OPS) and b:
                    scan_rates.append(op.self_s() / float(b))
                    contributed = True
                elif not op.op.startswith(_SCAN_OPS):
                    op_selfs.append(op.self_s())
                    contributed = True
            overheads.append(max(0.0, prof.total_s - prof.operator_total_s()))
            if contributed:
                used += 1
        model = CostModel(samples=used)
        if scan_rates:
            model.scan_seconds_per_byte = max(statistics.median(scan_rates), 1e-12)
        if op_selfs:
            model.per_operator_seconds = max(statistics.median(op_selfs), 0.0)
        if overheads:
            model.plan_overhead_s = max(statistics.median(overheads), 0.0)
        return model

    # -- estimates --------------------------------------------------------
    def estimate_scan_s(self, nbytes: float) -> float:
        """Wall seconds to scan+decode `nbytes` (linear, monotonic)."""
        return self.scan_seconds_per_byte * max(float(nbytes), 0.0)

    def estimate_query_s(self, nbytes: float, n_operators: int = 1) -> float:
        """End-to-end estimate for a plan scanning `nbytes` through
        `n_operators` operators."""
        return (
            self.estimate_scan_s(nbytes)
            + self.per_operator_seconds * max(int(n_operators), 0)
            + self.plan_overhead_s
        )

    def indexed_benefit_s(
        self, raw_bytes: float, num_buckets: int, n_operators: int = 1
    ) -> float:
        """Estimated per-query saving of a bucketed covering index over a
        raw scan for a point/selective predicate on the first indexed
        column: bucket pruning reads ~1/num_buckets of the data (the
        executor prunes whole bucket files on point predicates), while
        the indexed plan pays one extra plan overhead for the rewrite.
        Never negative-from-noise: callers treat <= 0 as "no benefit"."""
        raw = self.estimate_query_s(raw_bytes, n_operators)
        pruned = max(float(raw_bytes), 0.0) / max(int(num_buckets), 1)
        indexed = self.estimate_query_s(pruned, n_operators) + self.plan_overhead_s
        return raw - indexed

    def to_json(self) -> dict:
        return {
            "scan_seconds_per_byte": self.scan_seconds_per_byte,
            "per_operator_seconds": self.per_operator_seconds,
            "plan_overhead_s": self.plan_overhead_s,
            "samples": self.samples,
        }

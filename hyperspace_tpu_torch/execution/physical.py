"""Executed physical plan: what a query ACTUALLY ran.

A copy of the JAX package's `execution/physical.py`. There is no separate
compile step (the executor IS the physical layer), so the physical plan
is recorded as the query runs: one node per executed operator carrying
the evidence (files read, rows pruned, kernel/path chosen, bucket
counts, rows out). `explain(physical=True)` executes both variants and
diffs these trees.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class PhysicalNode:
    """One executed operator. `detail` holds operator-specific evidence
    (files=, rows_pruned=, path=, kernel=...); children in execution
    order."""

    op: str
    detail: dict = dataclasses.field(default_factory=dict)
    children: list = dataclasses.field(default_factory=list)
    rows_out: int | None = None
    # Measured wall time of this operator's frame (children included).
    # Deliberately NOT part of label(): explain's plan diff matches
    # labels across two runs, and wall times never match.
    wall_s: float | None = None

    def label(self) -> str:
        parts = [self.op]
        for k in sorted(self.detail):
            parts.append(f"{k}={self.detail[k]}")
        if self.rows_out is not None:
            parts.append(f"rows={self.rows_out}")
        return " ".join(str(p) for p in parts)

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()

    def to_json(self) -> dict:
        return {
            "op": self.op,
            "detail": dict(self.detail),
            "rows": self.rows_out,
            "wall_s": self.wall_s,
            "children": [c.to_json() for c in self.children],
        }

"""Per-query profiles: what one query did, operator by operator.

A port of the JAX package's `obs/profile.py`. A :class:`QueryProfile` is
assembled by ``session.run_query()`` after every query from (a) the
executed physical plan, whose
:class:`~hyperspace_tpu_torch.execution.physical.PhysicalNode` nodes
carry their wall time next to the rows, files and kernel evidence they
recorded, and (b) the query's span tree when tracing is enabled
(``hyperspace.obs.enabled``). The physical side is always present (two
``perf_counter`` calls an operator), so every query yields a profile even
with tracing off.

Every time here is a host wall: CUDA launches return before the card
finishes, and no operator waits for the card, so an operator's wall is
the host work and the launches of its frame, and the card's time is
`torch.profiler`'s (``session.run(plan, profile_dir=...)``).

``session.last_profile()`` returns the most recent profile;
``explain(mode="analyze")`` renders it (explain/plan_analyzer.py);
completed profiles also feed the process metrics registry (operator
wall-time, bytes-scanned, and bucket-fan-out histograms).
"""

from __future__ import annotations

import dataclasses

from hyperspace_tpu_torch.obs import metrics

OPERATOR_SECONDS = metrics.histogram(
    "query.operator.seconds", "per-operator wall time", buckets=metrics.SECONDS_BUCKETS
)
QUERY_SECONDS = metrics.histogram(
    "query.seconds", "end-to-end session.run wall time", buckets=metrics.SECONDS_BUCKETS
)
BYTES_SCANNED = metrics.histogram(
    "query.bytes_scanned", "physical bytes decoded per query", buckets=metrics.BYTES_BUCKETS
)
BUCKET_FANOUT = metrics.histogram(
    "query.bucket_fanout", "files read per scan operator", buckets=metrics.COUNT_BUCKETS
)
QUERY_COUNT = metrics.counter("query.count", "queries executed via session.run")


@dataclasses.dataclass
class OperatorProfile:
    """One executed operator: identity + measured cost. `detail` carries
    the operator-specific evidence the executor recorded (files, bytes,
    kernel, venue, prune counts, ...)."""

    op: str
    wall_s: float
    rows_out: int | None
    detail: dict
    children: list["OperatorProfile"]

    @property
    def rows_in(self) -> int | None:
        """Rows flowing in from child operators (None for leaves)."""
        if not self.children:
            return None
        return sum(c.rows_out or 0 for c in self.children)

    def self_s(self) -> float:
        return max(0.0, self.wall_s - sum(c.wall_s for c in self.children))

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()

    def to_json(self) -> dict:
        return {
            "op": self.op,
            "wall_s": self.wall_s,
            "rows_out": self.rows_out,
            "rows_in": self.rows_in,
            "detail": dict(self.detail),
            "children": [c.to_json() for c in self.children],
        }


@dataclasses.dataclass
class QueryProfile:
    """Everything one query did: operator tree with measured wall times,
    executor totals, venue/device placement, cache and fallback
    outcomes, and (when tracing was on) the full span tree."""

    total_s: float
    root: OperatorProfile | None
    stats: dict  # executor.stats copy (files read/pruned, paths, kernels)
    venue: dict  # platform/devices + per-family path choices
    cache: dict  # decoded-table + device-cache hit/miss deltas for THIS query
    fallback: dict  # replan attempts + degraded indexes
    trace: dict | None = None  # span tree (None when obs disabled)

    def operators(self) -> list[OperatorProfile]:
        return list(self.root.walk()) if self.root is not None else []

    def operator_total_s(self) -> float:
        """Sum of per-operator SELF times ≈ root wall time (the invariant
        tests pin: attribution loses nothing)."""
        return sum(op.self_s() for op in self.operators())

    def to_json(self) -> dict:
        return {
            "total_s": self.total_s,
            "operators": self.root.to_json() if self.root is not None else None,
            "stats": dict(self.stats),
            "venue": dict(self.venue),
            "cache": dict(self.cache),
            "fallback": dict(self.fallback),
            "trace": self.trace,
        }


def _from_physical(node) -> OperatorProfile:
    return OperatorProfile(
        op=node.op,
        wall_s=float(getattr(node, "wall_s", None) or 0.0),
        rows_out=node.rows_out,
        detail=dict(node.detail),
        children=[_from_physical(c) for c in node.children],
    )


def build_profile(
    *,
    total_s: float,
    physical_plan,
    stats: dict,
    venue: dict,
    cache: dict,
    fallback: dict,
    trace_root=None,
) -> QueryProfile:
    """Assemble the profile and feed the completed query's numbers into
    the process metrics registry."""
    root = _from_physical(physical_plan) if physical_plan is not None else None
    profile = QueryProfile(
        total_s=total_s,
        root=root,
        stats=dict(stats),
        venue=dict(venue),
        cache=dict(cache),
        fallback=dict(fallback),
        trace=trace_root.to_json() if trace_root is not None else None,
    )
    QUERY_COUNT.inc()
    QUERY_SECONDS.observe(total_s)
    BYTES_SCANNED.observe(float(stats.get("bytes_scanned", 0) or 0))
    for op in profile.operators():
        OPERATOR_SECONDS.observe(op.self_s())
        if "files" in op.detail and op.op.startswith(("IndexScan", "TableScan", "Index")):
            BUCKET_FANOUT.observe(float(op.detail["files"]))
    return profile


def render(profile: QueryProfile) -> str:
    """Text rendering for ``explain(mode="analyze")``: the operator tree
    annotated with measured wall time / rows / bytes, then the totals,
    venue, cache, and fallback sections. Times are host walls: the
    operators launch their work on the card and do not wait for it."""
    out = ["=" * 64, "EXPLAIN ANALYZE", "=" * 64]
    total = max(profile.total_s, 1e-12)

    def fmt_bytes(n: float) -> str:
        for unit in ("B", "KiB", "MiB", "GiB"):
            if n < 1024 or unit == "GiB":
                return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
            n /= 1024
        return f"{n:.1f}GiB"

    def walk(op: OperatorProfile, indent: int) -> None:
        parts = [f"{'  ' * indent}{op.op}"]
        parts.append(f"time={op.wall_s * 1e3:.2f}ms ({100 * op.wall_s / total:.1f}%)")
        if op.rows_out is not None:
            rin = op.rows_in
            parts.append(f"rows={rin if rin is not None else '-'}→{op.rows_out}")
        if "bytes" in op.detail:
            parts.append(f"bytes={fmt_bytes(op.detail['bytes'])}")
        for k in sorted(op.detail):
            if k == "bytes":
                continue
            parts.append(f"{k}={op.detail[k]}")
        out.append("  ".join(str(p) for p in parts))
        for c in op.children:
            walk(c, indent + 1)

    if profile.root is not None:
        walk(profile.root, 0)
    out.append("-" * 64)
    out.append(
        f"total: {profile.total_s * 1e3:.2f}ms  "
        f"(operator self-time {profile.operator_total_s() * 1e3:.2f}ms)"
    )
    out.append("times: host walls; the card's own: session.run(plan, profile_dir=...) (torch.profiler)")
    st = profile.stats
    out.append(
        f"io: files read {st.get('files_read', 0)}, pruned {st.get('files_pruned', 0)}; "
        f"rows pruned {st.get('rows_pruned', 0)}; "
        f"bytes scanned {fmt_bytes(st.get('bytes_scanned', 0) or 0)}"
    )
    v = profile.venue
    vparts = [f"platform={v.get('platform')}"]
    for fam in ("join_path", "join_kernel", "agg_path"):
        if st.get(fam):
            vparts.append(f"{fam}={st[fam]}")
    if st.get("join_devices"):
        vparts.append(f"devices={st['join_devices']}")
    out.append("venue: " + "  ".join(vparts))
    c = profile.cache
    out.append(
        "cache: table {t_hits}h/{t_miss}m  device {d_hits}h/{d_miss}m  derived {h_hits}h/{h_miss}m".format(
            t_hits=c.get("table_hits", 0), t_miss=c.get("table_misses", 0),
            d_hits=c.get("device_hits", 0), d_miss=c.get("device_misses", 0),
            h_hits=c.get("derived_hits", 0), h_miss=c.get("derived_misses", 0),
        )
    )
    fb = profile.fallback
    if fb.get("replans") or fb.get("degraded_indexes"):
        out.append(
            f"fallback: replans={fb.get('replans', 0)} "
            f"degraded={fb.get('degraded_indexes', [])}"
        )
    if profile.trace is None:
        out.append("(tracing disabled — set hyperspace.obs.enabled for span detail)")
    return "\n".join(out)

"""Plan-diff explain.

A port of the JAX package's `explain/plan_analyzer.py`
(index/plananalysis/PlanAnalyzer.scala:34-410 of the reference): compile
the query twice (rules off / rules on), diff the plans highlighting
replaced subtrees, list the indexes actually used (matching scan roots
against the catalog), and in verbose mode report the per-operator
occurrence diff, whose headline here is how many scans became bucketed
index scans (each is an exchange the executor never runs).
`explain_executed` runs the query twice and diffs the executed physical
plans; `explain_analyze` runs it once and renders its profile. With adaptive
routing on, the diff ends with the routing ledger's verdict for the plan
(`Adaptive routing: indexed`, or `raw` where the indexed path measured
slower and the rewrite shown would not run).
"""

from __future__ import annotations

from collections import Counter

from hyperspace_tpu_torch.plan.nodes import Filter, Join, LogicalPlan, Project, Scan, Union


def _node_label(plan: LogicalPlan) -> str:
    """One-line description of a node WITHOUT its children."""
    if isinstance(plan, Scan):
        kind = "IndexScan" if plan.bucket_spec is not None else "Scan"
        extra = ""
        if plan.bucket_spec is not None:
            extra = f" buckets={plan.bucket_spec[0]} bucketCols={plan.bucket_spec[1]}"
        return f"{kind} root={plan.root} cols={plan.scan_schema.names}{extra}"
    if isinstance(plan, Filter):
        return f"Filter {plan.predicate.to_json()}"
    if isinstance(plan, Project):
        return f"Project {plan.output_names}"
    if isinstance(plan, Join):
        return f"Join on {list(zip(plan.left_on, plan.right_on))}"
    if isinstance(plan, Union):
        return "HybridScanUnion"
    from hyperspace_tpu_torch.plan.nodes import Aggregate, Limit, Sort, Window

    if isinstance(plan, Aggregate):
        aggs = [f"{a.fn}({a.alias})" for a in plan.aggs]
        return f"Aggregate groupBy={plan.group_by} aggs={aggs}"
    if isinstance(plan, Window):
        funcs = [f"{f.fn}({f.alias})" for f in plan.funcs]
        return (
            f"Window partitionBy={plan.partition_by} orderBy={plan.order_by} "
            f"frame={plan.frame} funcs={funcs}"
        )
    if isinstance(plan, Sort):
        return f"Sort by={plan.by}"
    if isinstance(plan, Limit):
        return f"Limit {plan.n}"
    return type(plan).__name__


def _render_lines(plan: LogicalPlan, indent: int = 0, path: tuple = ()):
    """[(occurrence path, rendered line)] in pre-order. Paths (child-index
    tuples from the root) identify OCCURRENCES, not objects — plans are
    DAGs when a dataframe is reused, and a shared node highlighted in one
    leg must not light up its aliases elsewhere."""
    out = [(path, "  " * indent + _node_label(plan))]
    for i, c in enumerate(plan.children()):
        out.extend(_render_lines(c, indent + 1, path + (i,)))
    return out


def pretty_plan(plan: LogicalPlan, indent: int = 0) -> str:
    return "\n".join(
        line for _, line in _render_lines(plan, indent)
    )


def _mark_diff_trees(
    a, b, marked_a: set, marked_b: set, label, children, path: tuple = ()
) -> None:
    """Queue-style pairwise walk (PlanAnalyzer.scala:56-101): nodes whose
    labels match recurse into their children; any mismatch marks BOTH
    whole subtrees (by occurrence path) as differing. Shared by the
    logical and executed-physical diffs via (label, children) accessors."""

    def mark_subtree(p, acc: set, at: tuple) -> None:
        acc.add(at)
        for i, c in enumerate(children(p)):
            mark_subtree(c, acc, at + (i,))

    ca, cb = children(a), children(b)
    if label(a) != label(b) or len(ca) != len(cb):
        mark_subtree(a, marked_a, path)
        mark_subtree(b, marked_b, path)
        return
    for i, (x, y) in enumerate(zip(ca, cb)):
        _mark_diff_trees(x, y, marked_a, marked_b, label, children, path + (i,))


def _mark_diff(a: LogicalPlan, b: LogicalPlan, marked_a: set, marked_b: set) -> None:
    _mark_diff_trees(a, b, marked_a, marked_b, _node_label, lambda p: p.children())


def _render_highlighted(plan: LogicalPlan, marked: set, mode) -> str:
    lines = []
    for at, line in _render_lines(plan):
        lines.append(mode.highlight(line) if at in marked else line)
    return "\n".join(lines)


def _operator_counts(plan: LogicalPlan) -> Counter:
    c: Counter = Counter()

    def walk(p: LogicalPlan):
        if isinstance(p, Scan):
            c["IndexScan" if p.bucket_spec is not None else "Scan"] += 1
        else:
            c[type(p).__name__] += 1
        for ch in p.children():
            walk(ch)

    walk(plan)
    return c


def _used_indexes(plan: LogicalPlan, session) -> list[str]:
    """Match index-scan roots against the catalog
    (PlanAnalyzer.scala:129-152,209-221)."""
    roots = {s.root for s in plan.leaves() if s.bucket_spec is not None}
    used = []
    for entry in session.manager.get_indexes():
        if str(entry.content.root) in roots:
            used.append(entry.name)
    return used


def _physical_counts(root) -> Counter:
    c: Counter = Counter()
    for n in root.walk():
        c[n.op] += 1
    return c


def _render_physical(root, marked: set, mode, path: tuple = (), indent: int = 0) -> list:
    line = "  " * indent + root.label()
    out = [mode.highlight(line) if path in marked else line]
    for i, c in enumerate(root.children):
        out.extend(_render_physical(c, marked, mode, path + (i,), indent + 1))
    return out


def explain_executed(plan: LogicalPlan, session, mode=None) -> str:
    """EXECUTE the query twice (rules off / on) and diff the physical
    plans that actually ran — files read, kernels chosen, bucket/device
    counts, rows per operator. The analog of the reference diffing
    executedPlans (PlanAnalyzer.scala:163-178) with per-operator stats
    (PhysicalOperatorAnalyzer.scala:39-56); here the evidence is
    measured, not estimated, because the executor IS the physical layer.
    Note: this runs the query (twice); use explain() for a no-IO diff."""
    from hyperspace_tpu_torch.explain.display_mode import display_mode_from_conf

    if mode is None:
        mode = display_mode_from_conf(getattr(session, "conf", None))

    was_enabled = session.is_hyperspace_enabled()
    try:
        from hyperspace_tpu_torch.execution import device_cache

        # COLD evidence on both sides: files_read counts physical (miss)
        # reads, so the shared device cache must not let either run ride
        # the other's warm state — the "files read: X -> Y" line exists
        # to show the INDEX's IO reduction.
        session.disable_hyperspace()
        device_cache.clear_all()
        session.run(plan)
        phys_without = session.last_physical_plan
        stats_without = session.last_query_stats
        session.enable_hyperspace()
        device_cache.clear_all()
        session.run(plan)
        phys_with = session.last_physical_plan
        stats_with = session.last_query_stats
        rewritten = session.optimized_plan(plan)
    finally:
        session._enabled = was_enabled

    marked_before: set = set()
    marked_after: set = set()
    _mark_diff_trees(
        phys_without, phys_with, marked_before, marked_after,
        lambda n: n.label(), lambda n: n.children,
    )

    out = []
    out.append("=" * 64)
    out.append("Executed plan with indexes:")
    out.extend(_render_physical(phys_with, marked_after, mode))
    out.append("=" * 64)
    out.append("Executed plan without indexes:")
    out.extend(_render_physical(phys_without, marked_before, mode))
    out.append("=" * 64)
    out.append("Indexes used:")
    for name in _used_indexes(rewritten, session):
        out.append(f"  {name}")
    out.append("=" * 64)
    out.append("Physical operator stats:")
    cb, ca = _physical_counts(phys_without), _physical_counts(phys_with)
    for op in sorted(set(cb) | set(ca)):
        out.append(f"  {op}: {cb.get(op, 0)} -> {ca.get(op, 0)}")
    out.append(
        f"  files read: {stats_without['files_read']} -> {stats_with['files_read']}"
    )
    out.append(
        f"  files pruned: {stats_without['files_pruned']} -> {stats_with['files_pruned']}"
    )
    out.append(
        f"  rows pruned: {stats_without['rows_pruned']} -> {stats_with['rows_pruned']}"
    )
    if stats_with.get("join_path"):
        out.append(
            f"  join path: {stats_without.get('join_path')} -> {stats_with['join_path']} "
            f"({stats_with.get('join_devices', 1)} device(s))"
        )
    return mode.finalize("\n".join(out))


def explain_analyze(plan: LogicalPlan, session) -> str:
    """EXPLAIN ANALYZE: run the query ONCE under the session's current
    enablement and render the measured QueryProfile — the operator tree
    that actually executed, annotated with per-operator wall time (and %
    of total), rows in/out, bytes decoded, kernel/venue choices, cache
    hit/miss deltas, and any corruption-fallback outcome. The analog of
    Postgres's EXPLAIN ANALYZE over the reference's static explain
    (PlanAnalyzer.scala only *estimates*; here the executor measures).

    Unlike explain(physical=True) this does not force a rules-off
    comparison run — it profiles the plan the session would really
    execute, which is what a production latency investigation wants.
    Its times are host walls: the operators launch their work on the
    card and do not wait for it (the card's time is `torch.profiler`'s,
    `session.run(plan, profile_dir=...)`)."""
    from hyperspace_tpu_torch.obs import profile as obs_profile

    session.run(plan)
    prof = session.last_profile()
    out = [obs_profile.render(prof)]
    rewritten = session.optimized_plan(plan)
    used = _used_indexes(rewritten, session)
    if used:
        out.append("indexes used: " + ", ".join(used))
    return "\n".join(out)


def explain_string(
    plan: LogicalPlan, session, verbose: bool = False, mode=None
) -> str:
    """Run the rewriter off and on, diff with differing subtrees
    highlighted in the configured display mode
    (PlanAnalyzer.scala:45-126, DisplayMode.scala:24-89)."""
    from hyperspace_tpu_torch.explain.display_mode import display_mode_from_conf

    if mode is None:
        mode = display_mode_from_conf(getattr(session, "conf", None))

    from hyperspace_tpu_torch.plan.prune import prune_columns
    from hyperspace_tpu_torch.plan.pushdown import push_down_filters

    # Adaptive routing's verdict: keyed on the ORIGINAL plan's signature,
    # exactly as run_query keys the ledger.
    routing_line = None
    conf = getattr(session, "conf", None)
    if conf is not None and getattr(conf, "advisor_routing_enabled", False):
        from hyperspace_tpu_torch.signature import plan_signature

        demoted = plan_signature(plan) in set(session.routing_ledger().demoted_signatures())
        routing_line = (
            "Adaptive routing: raw (indexed path measured slower; the rewrite below would NOT run)"
            if demoted
            else "Adaptive routing: indexed"
        )

    was_enabled = session.is_hyperspace_enabled()
    try:
        session.enable_hyperspace()
        with_plan = session.optimized_plan(plan)
    finally:
        if not was_enabled:
            session.disable_hyperspace()

    # Diff against the pushed-down, column-pruned baseline: those passes
    # run on BOTH sides (they are not index effects), so highlights show
    # only index rewrites.
    plan = prune_columns(push_down_filters(plan))
    marked_before: set = set()
    marked_after: set = set()
    _mark_diff(plan, with_plan, marked_before, marked_after)

    out = []
    out.append("=" * 64)
    out.append("Plan with indexes:")
    out.append(_render_highlighted(with_plan, marked_after, mode))
    out.append("=" * 64)
    out.append("Plan without indexes:")
    out.append(_render_highlighted(plan, marked_before, mode))
    out.append("=" * 64)
    out.append("Indexes used:")
    for name in _used_indexes(with_plan, session):
        out.append(f"  {name}")
    if routing_line is not None:
        out.append("=" * 64)
        out.append(routing_line)
    if verbose:
        cb = _operator_counts(plan)
        ca = _operator_counts(with_plan)
        out.append("=" * 64)
        out.append("Physical operator stats:")
        for op in sorted(set(cb) | set(ca)):
            out.append(f"  {op}: {cb.get(op, 0)} -> {ca.get(op, 0)}")
        # The headline: every source scan turned into a bucketed index scan
        # is one exchange the executor never has to run. Delta, not the
        # absolute after-count — a plan already holding index scans did not
        # have them "eliminated" by this rewrite.
        eliminated = ca.get("IndexScan", 0) - cb.get("IndexScan", 0)
        out.append(f"  ShuffleExchange-equivalents eliminated: {eliminated}")
    return mode.finalize("\n".join(out))

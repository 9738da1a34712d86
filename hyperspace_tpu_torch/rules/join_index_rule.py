"""JoinIndexRule: rewrite equi-joins to bucket-aligned index scans.

Reference parity: index/rules/JoinIndexRule.scala:54-595. The plan IR
makes several of its checks structural: the equi-join CNF and base-table
attribute requirements (JoinIndexRule.scala:179-185, 278-317) are
guaranteed by the `Join` node shape. What remains:

- sides must be linear sub-plans over a single source relation
  (JoinIndexRule.scala:210-211): here Scan / Project(Scan) / Filter(Scan);
- the key mapping must be 1:1 (no column repeated on either side);
- a side's candidate indexes are those whose signature matches the side's
  relation (JoinIndexRule.scala:328-353); usable iff indexed columns are
  set-equal to the side's join columns AND the index covers the side's
  required output columns (JoinIndexRule.scala:515-524);
- a compatible pair lists indexed columns in the same mapped order
  (JoinIndexRule.scala:547-594);
- the best pair is chosen by JoinIndexRanker (equal bucket counts first —
  zero-exchange, then more buckets);
- the rewrite swaps both sides' relations for bucketed index scans so the
  executor's per-bucket merge join needs no exchange
  (JoinIndexRule.scala:124-153).

A copy of the JAX package's rule. A side matches an index when its
signature equals the source's or, with hybrid scan enabled, when the
source has only gained files within the ratio (rules/base.py); a hybrid
side becomes the index scan unioned with the appended files, which the
executor bucketizes on the fly. When only one side has a usable index,
that side alone is rewritten (as in the JAX package); the executor then
re-bucketizes the other side into the index's bucket layout (the
re-bucketing exchange) or, where that side is small, probes a broadcast
table of it (execution/exec_side.py).
"""

from __future__ import annotations

import dataclasses

from hyperspace_tpu_torch.metadata.log_entry import IndexLogEntry
from hyperspace_tpu_torch.plan.nodes import Aggregate, Filter, Join, Limit, LogicalPlan, Project, Scan, Sort, Union, Window
from hyperspace_tpu_torch.rules.base import IndexMatch, Rule, SignatureMatcher, hybrid_scan_for, index_scan_for
from hyperspace_tpu_torch.rules.ranker import JoinIndexRanker


def _side_scan(plan: LogicalPlan) -> Scan | None:
    """The single source relation of a linear side, if any."""
    node = plan
    while True:
        if isinstance(node, Scan):
            return node if node.bucket_spec is None else None
        if isinstance(node, (Project, Filter)):
            node = node.child
            continue
        return None


def _side_required_columns(plan: LogicalPlan, join_cols: list[str]) -> set[str]:
    """Columns the side must produce: its output + its own predicates +
    the join keys (analog of JoinIndexRule.scala:399-457). The outermost
    Project defines the side's output."""
    required = {c.lower() for c in join_cols}
    node = plan
    saw_project = False
    while not isinstance(node, Scan):
        if isinstance(node, Filter):
            required |= {c.lower() for c in node.predicate.references()}
        elif isinstance(node, Project) and not saw_project:
            required |= node.input_columns()
            saw_project = True
        node = node.child
    if not saw_project:
        required |= {c.lower() for c in plan.schema.names}
    return required


def _replace_scan(plan: LogicalPlan, new_scan: LogicalPlan) -> LogicalPlan:
    if isinstance(plan, Scan):
        return new_scan
    if isinstance(plan, Project):
        return Project(_replace_scan(plan.child, new_scan), plan.columns)
    if isinstance(plan, Filter):
        return Filter(_replace_scan(plan.child, new_scan), plan.predicate)
    raise AssertionError("non-linear side")


class JoinIndexRule(Rule):
    name = "JoinIndexRule"

    def apply(self, plan: LogicalPlan, indexes: list[IndexLogEntry]) -> LogicalPlan:
        return self._rewrite(plan, indexes, SignatureMatcher(self.conf))

    def _rewrite(self, plan: LogicalPlan, indexes, matcher) -> LogicalPlan:
        if isinstance(plan, Join):
            rewritten = self._try_rewrite_join(plan, indexes, matcher)
            if rewritten is not None:
                return rewritten
            return dataclasses.replace(
                plan,
                left=self._rewrite(plan.left, indexes, matcher),
                right=self._rewrite(plan.right, indexes, matcher),
            )
        if isinstance(plan, Project):
            return Project(self._rewrite(plan.child, indexes, matcher), plan.columns)
        if isinstance(plan, Filter):
            return Filter(self._rewrite(plan.child, indexes, matcher), plan.predicate)
        if isinstance(plan, (Aggregate, Sort, Limit, Window)):
            return dataclasses.replace(plan, child=self._rewrite(plan.child, indexes, matcher))
        if isinstance(plan, Union):
            # User-written UNION ALL branches each get their own rewrite.
            return Union([self._rewrite(c, indexes, matcher) for c in plan.inputs])
        return plan

    def _try_rewrite_join(self, plan: Join, indexes, matcher) -> LogicalPlan | None:
        # 1:1 mapping: no repeated columns on either side.
        if len({c.lower() for c in plan.left_on}) != len(plan.left_on):
            return None
        if len({c.lower() for c in plan.right_on}) != len(plan.right_on):
            return None

        lscan = _side_scan(plan.left)
        rscan = _side_scan(plan.right)
        if (lscan is None and rscan is None) or lscan is rscan:
            return None

        lcands = rcands = []
        if lscan is not None:
            lreq = _side_required_columns(plan.left, plan.left_on)
            lcands = self._usable(indexes, lscan, plan.left_on, lreq, matcher)
        if rscan is not None:
            rreq = _side_required_columns(plan.right, plan.right_on)
            rcands = self._usable(indexes, rscan, plan.right_on, rreq, matcher)
        if not lcands and not rcands:
            return None

        pairs = (
            self._compatible_pairs(lcands, rcands, plan.left_on, plan.right_on)
            if lcands and rcands
            else []
        )
        if not pairs:
            # One-sided rewrite: a lone usable index still serves the join
            # (in the JAX package through its re-bucketing exchange). Prefer
            # more buckets, comparing across BOTH sides.
            best_l = max(lcands, key=lambda m: m.entry.num_buckets) if lcands else None
            best_r = max(rcands, key=lambda m: m.entry.num_buckets) if rcands else None
            if best_l is not None and (
                best_r is None or best_l.entry.num_buckets >= best_r.entry.num_buckets
            ):
                new_left = _replace_scan(plan.left, _side_plan(best_l, lscan))
                return dataclasses.replace(
                    plan, left=new_left, right=self._rewrite(plan.right, indexes, matcher)
                )
            new_right = _replace_scan(plan.right, _side_plan(best_r, rscan))
            return dataclasses.replace(
                plan, left=self._rewrite(plan.left, indexes, matcher), right=new_right
            )
        best_l, best_r = JoinIndexRanker.rank([(lm.entry, rm.entry) for lm, rm in pairs])[0]
        lmatch = next(lm for lm, _ in pairs if lm.entry is best_l)
        rmatch = next(rm for _, rm in pairs if rm.entry is best_r)
        return dataclasses.replace(
            plan,
            left=_replace_scan(plan.left, _side_plan(lmatch, lscan)),
            right=_replace_scan(plan.right, _side_plan(rmatch, rscan)),
        )

    def _usable(self, indexes, scan: Scan, join_cols, required: set[str], matcher) -> list[IndexMatch]:
        out = []
        jset = {c.lower() for c in join_cols}
        for entry in indexes:
            if entry.derived_dataset.kind != "CoveringIndex":
                continue  # vector indexes serve ann_search, not joins
            iset = {c.lower() for c in entry.indexed_columns}
            cover = {c.lower() for c in entry.derived_dataset.all_columns}
            if iset == jset and required <= cover:
                m = matcher.match(entry, scan)
                if m is not None:
                    out.append(m)
        return out

    def _compatible_pairs(self, lcands, rcands, left_on, right_on):
        """Pairs whose indexed column order respects the key mapping
        (JoinIndexRule.scala:547-594)."""
        l2r = {l.lower(): r.lower() for l, r in zip(left_on, right_on)}
        pairs = []
        for lm in lcands:
            expected_r = [l2r[c.lower()] for c in lm.entry.indexed_columns]
            for rm in rcands:
                if [c.lower() for c in rm.entry.indexed_columns] == expected_r:
                    pairs.append((lm, rm))
        return pairs


def _side_plan(match: IndexMatch, scan: Scan) -> LogicalPlan:
    """Exact match ⇒ the bucketed index scan; hybrid ⇒ index ∪ appended
    (the executor bucketizes the appended rows on the fly)."""
    if match.is_exact:
        return index_scan_for(match.entry)
    return hybrid_scan_for(match, scan)

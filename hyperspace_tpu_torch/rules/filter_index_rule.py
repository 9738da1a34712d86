"""FilterIndexRule: rewrite filter queries to scan a covering index.

Reference parity: index/rules/FilterIndexRule.scala:41-229. Matches
`Project(Filter(Scan))` or `Filter(Scan)` where the scan is a source
relation (FilterIndexRule.scala:47-56); an index applies iff

  (a) its stored signature matches the scan's recomputed fingerprint,
  (b) it covers every column the filter + projection reference,
  (c) the filter references the FIRST indexed column
      (FilterIndexRule.scala:203-215);

the rewrite swaps only the relation for the bucketed index scan
(FilterIndexRule.scala:114-128). The index Scan carries the bucket spec —
the executor uses it for bucket pruning on point predicates.

A copy of the JAX package's rule over the plan nodes the port has; a
hybrid match (rules/base.py) replaces the scan with the index scan
unioned with the appended files.
"""

from __future__ import annotations

import dataclasses

from hyperspace_tpu_torch.metadata.log_entry import IndexLogEntry
from hyperspace_tpu_torch.plan.nodes import Aggregate, Filter, Join, Limit, LogicalPlan, Project, Scan, Sort, Union, Window
from hyperspace_tpu_torch.rules.base import Rule, SignatureMatcher, hybrid_scan_for, index_scan_for


class FilterIndexRule(Rule):
    name = "FilterIndexRule"

    def apply(self, plan: LogicalPlan, indexes: list[IndexLogEntry]) -> LogicalPlan:
        return self._rewrite(plan, indexes, SignatureMatcher(self.conf))

    def _rewrite(self, plan: LogicalPlan, indexes, matcher) -> LogicalPlan:
        if isinstance(plan, Project) and isinstance(plan.child, Filter) and isinstance(plan.child.child, Scan):
            scan = plan.child.child
            new_scan = self._replacement(scan, plan.child.predicate, plan.input_columns(), indexes, matcher)
            if new_scan is not None:
                return Project(Filter(new_scan, plan.child.predicate), plan.columns)
            return plan
        if isinstance(plan, Filter) and isinstance(plan.child, Scan):
            scan = plan.child
            required = scan.scan_schema.names  # no projection: full output
            new_scan = self._replacement(scan, plan.predicate, required, indexes, matcher)
            if new_scan is not None:
                return Filter(new_scan, plan.predicate)
            return plan
        if (
            isinstance(plan, Filter)
            and isinstance(plan.child, Project)
            and isinstance(plan.child.child, Scan)
        ):
            # Filter(Project(Scan)) — the select-then-filter spelling of
            # the same shape.
            proj = plan.child
            new_scan = self._replacement(
                proj.child, plan.predicate, proj.input_columns(), indexes, matcher
            )
            if new_scan is not None:
                return Filter(Project(new_scan, proj.columns), plan.predicate)
            return plan
        # Recurse into children.
        if isinstance(plan, Project):
            return Project(self._rewrite(plan.child, indexes, matcher), plan.columns)
        if isinstance(plan, Filter):
            return Filter(self._rewrite(plan.child, indexes, matcher), plan.predicate)
        if isinstance(plan, (Aggregate, Sort, Limit, Window)):
            return dataclasses.replace(plan, child=self._rewrite(plan.child, indexes, matcher))
        if isinstance(plan, Union):
            # User-written UNION ALL branches each get their own rewrite.
            return Union([self._rewrite(c, indexes, matcher) for c in plan.inputs])
        if isinstance(plan, Join):
            return dataclasses.replace(
                plan,
                left=self._rewrite(plan.left, indexes, matcher),
                right=self._rewrite(plan.right, indexes, matcher),
            )
        return plan

    def _replacement(self, scan: Scan, predicate, output_columns, indexes, matcher) -> LogicalPlan | None:
        if scan.bucket_spec is not None:
            return None  # already an index scan — never rewrite twice
        filter_cols = {c.lower() for c in predicate.references()}
        required = filter_cols | {c.lower() for c in output_columns}
        for entry in indexes:
            if entry.derived_dataset.kind != "CoveringIndex":
                continue  # vector indexes serve ann_search, not filters
            idx_cols = {c.lower() for c in entry.derived_dataset.all_columns}
            first_indexed = entry.indexed_columns[0].lower()
            if required <= idx_cols and first_indexed in filter_cols:
                m = matcher.match(entry, scan)
                if m is None:
                    continue
                # First matching candidate wins (FilterIndexRule.scala:222-228).
                if m.is_exact:
                    return index_scan_for(entry)
                return hybrid_scan_for(m, scan)
        return None

"""Rule infrastructure for transparent plan rewriting.

The analog of the reference's Catalyst rule batch
(`JoinIndexRule :: FilterIndexRule` registered at package.scala:34). The
ordering is load-bearing and preserved: join first, then filter, because a
source already rewritten to an index scan cannot be rewritten again
(package.scala:23-33). Rules never throw: any failure downgrades to a
no-op (reference behavior at FilterIndexRule.scala:76-80).

A copy of the JAX package's module, hybrid scan included: with
`hyperspace.index.hybridscan.enabled`, an index whose source has only
gained files (within `maxAppendedRatio` of the indexed bytes) still
matches, and the rewrite unions the index scan with a raw scan of the
appended files (`hybrid_scan_for`).
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path

from hyperspace_tpu_torch.dataset import list_data_files
from hyperspace_tpu_torch.execution import io as hio
from hyperspace_tpu_torch.metadata.log_entry import IndexLogEntry
from hyperspace_tpu_torch.obs import trace as obs_trace
from hyperspace_tpu_torch.plan.nodes import LogicalPlan, Project, Scan, Union
from hyperspace_tpu_torch.schema import Schema
from hyperspace_tpu_torch.signature import create_signature_provider

logger = logging.getLogger("hyperspace_tpu_torch")


class Rule:
    name: str = "rule"

    def __init__(self, conf=None):
        self.conf = conf

    def apply(self, plan: LogicalPlan, indexes: list[IndexLogEntry]) -> LogicalPlan:
        raise NotImplementedError


def apply_rules(plan: LogicalPlan, indexes: list[IndexLogEntry], rules=None, conf=None) -> LogicalPlan:
    if rules is None:
        from hyperspace_tpu_torch.rules.filter_index_rule import FilterIndexRule
        from hyperspace_tpu_torch.rules.join_index_rule import JoinIndexRule

        rules = [JoinIndexRule(conf), FilterIndexRule(conf)]
    for rule in rules:
        with obs_trace.span(f"rule.{rule.name}", candidates=len(indexes)):
            try:
                plan = rule.apply(plan, indexes)
            except Exception as e:  # noqa: BLE001 — rules must never break a query
                # The span records the failure, the query proceeds.
                obs_trace.annotate(error=f"{type(e).__name__}: {e}")
                logger.warning("rule %s failed, skipping: %s", rule.name, e)
    return plan


def index_scan_for(entry: IndexLogEntry) -> Scan:
    """Build the bucketed index Scan replacing a source relation — the
    analog of constructing the index-backed HadoopFsRelation with a
    BucketSpec (JoinIndexRule.scala:124-153). All version dirs listed in
    `content.directories` participate: bucket b's data is the union of the
    bucket-b files across dirs (base + incremental-refresh deltas)."""
    root = Path(entry.content.root)
    schema = Schema.from_json(entry.derived_dataset.schema)
    files: list[str] = []
    for d in entry.content.directories:
        files.extend(fi.path for fi in list_data_files(root / d))
    first_dir = root / entry.content.directories[0]
    manifest = hio.read_manifest(first_dir)
    num_buckets = manifest["numBuckets"] if manifest else entry.derived_dataset.num_buckets
    return Scan(
        str(root),
        "parquet",
        schema,
        files=sorted(files),
        bucket_spec=(num_buckets, list(entry.derived_dataset.indexed_columns)),
    )


def hybrid_scan_for(match: "IndexMatch", source_scan: Scan):
    """Plan fragment for a hybrid match: the bucketed index scan unioned
    with a raw scan pinned to the appended source files, projected to the
    index's column set so both union inputs line up."""
    entry = match.entry
    idx_scan = index_scan_for(entry)
    delta_scan = Scan(
        source_scan.root,
        source_scan.format,
        source_scan.scan_schema,
        files=sorted(f.path for f in match.appended),
    )
    # The source scan may be column-pruned (pruning runs before rules);
    # narrow the index side to the same columns so the union aligns.
    src_cols = {c.lower() for c in source_scan.scan_schema.names}
    idx_cols = [
        c for c in entry.derived_dataset.all_columns
        if source_scan.scan_schema.names and c.lower() in src_cols
    ]
    idx_schema = idx_scan.scan_schema.select(
        [idx_scan.scan_schema.field(c).name for c in idx_cols]
    )
    idx_scan = dataclasses.replace(idx_scan, scan_schema=idx_schema)
    cols = [source_scan.scan_schema.field(c).name for c in idx_cols]
    return Union([idx_scan, Project(delta_scan, cols)])


@dataclasses.dataclass
class IndexMatch:
    """How an index applies to a source relation: exactly (signature equal)
    or via hybrid scan (index data + `appended` source files scanned raw)."""

    entry: IndexLogEntry
    appended: list  # FileInfo; empty ⇒ exact match

    @property
    def is_exact(self) -> bool:
        return not self.appended


class SignatureMatcher:
    """Memoized plan-fingerprint matching (the reference memoizes per
    provider within one optimizer invocation, JoinIndexRule.scala:328-353).
    With hybrid scan enabled, a signature mismatch can still match when the
    only divergence is appended source files within the configured ratio."""

    def __init__(self, conf=None):
        self._provider = create_signature_provider()
        self._cache: dict[int, str | None] = {}
        self._files_cache: dict[int, list] = {}
        self._hybrid = bool(conf.hybrid_scan_enabled) if conf is not None else False
        self._max_ratio = (
            float(conf.hybrid_scan_max_appended_ratio) if conf is not None else 0.0
        )

    def match(self, entry: IndexLogEntry, source: LogicalPlan) -> IndexMatch | None:
        key = id(source)
        if key not in self._cache:
            fp = self._provider.signature(source)
            self._cache[key] = None if fp is None else fp.value
        value = self._cache[key]
        if value is not None and value == entry.signature.value:
            return IndexMatch(entry, [])
        if not self._hybrid:
            return None
        from hyperspace_tpu_torch.signature import collect_leaf_files, diff_source_files

        # One live listing per source plan, reused across candidate entries.
        if key not in self._files_cache:
            current = []
            for leaf in source.leaves():
                current.extend(collect_leaf_files(leaf))
            self._files_cache[key] = current
        appended, deleted = diff_source_files(entry, source, current=self._files_cache[key])
        if deleted or not appended:
            return None
        logged_bytes = sum(f.size for f in entry.source.files) or 1
        if sum(f.size for f in appended) > self._max_ratio * logged_bytes:
            return None
        return IndexMatch(entry, appended)

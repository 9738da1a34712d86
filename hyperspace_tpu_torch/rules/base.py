"""Rule infrastructure for transparent plan rewriting.

The analog of the reference's Catalyst rule batch
(`JoinIndexRule :: FilterIndexRule` registered at package.scala:34). The
ordering is load-bearing and preserved: join first, then filter, because a
source already rewritten to an index scan cannot be rewritten again
(package.scala:23-33). Rules never throw: any failure downgrades to a
no-op (reference behavior at FilterIndexRule.scala:76-80).

A trimmed copy of the JAX package's module: hybrid scan is not ported
yet, so an index matches only when its signature equals the source's.
"""

from __future__ import annotations

import logging
from pathlib import Path

from hyperspace_tpu_torch.dataset import list_data_files
from hyperspace_tpu_torch.execution import io as hio
from hyperspace_tpu_torch.metadata.log_entry import IndexLogEntry
from hyperspace_tpu_torch.plan.nodes import LogicalPlan, Scan
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
        try:
            plan = rule.apply(plan, indexes)
        except Exception as e:  # noqa: BLE001 — rules must never break a query
            logger.warning("rule %s failed, skipping: %s", rule.name, e)
    return plan


def index_scan_for(entry: IndexLogEntry) -> Scan:
    """Build the bucketed index Scan replacing a source relation — the
    analog of constructing the index-backed HadoopFsRelation with a
    BucketSpec (JoinIndexRule.scala:124-153). All version dirs listed in
    `content.directories` participate."""
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


class SignatureMatcher:
    """Memoized plan-fingerprint matching (the reference memoizes per
    provider within one optimizer invocation, JoinIndexRule.scala:328-353)."""

    def __init__(self):
        self._provider = create_signature_provider()
        self._cache: dict[int, str | None] = {}

    def match(self, entry: IndexLogEntry, source: LogicalPlan) -> bool:
        key = id(source)
        if key not in self._cache:
            fp = self._provider.signature(source)
            self._cache[key] = None if fp is None else fp.value
        value = self._cache[key]
        return value is not None and value == entry.signature.value

"""Ranking of candidate index pairs for the join rewrite.

Reference parity: index/rankers/JoinIndexRanker.scala:24-56 — prefer pairs
with EQUAL bucket counts (zero-exchange join), then larger bucket counts
(more parallelism).

A copy of the JAX package's ranker, consumed by the join rule
(rules/join_index_rule.py).
"""

from __future__ import annotations

from hyperspace_tpu_torch.metadata.log_entry import IndexLogEntry


class JoinIndexRanker:
    @staticmethod
    def score(pair: tuple[IndexLogEntry, IndexLogEntry]) -> tuple[int, int]:
        """Sort key of a candidate pair — smaller ranks first: equal
        bucket counts beat unequal (the merge needs no re-bucketing
        exchange), then more total buckets beat fewer (parallelism)."""
        l, r = pair
        equal = l.num_buckets == r.num_buckets
        return (0 if equal else 1, -(l.num_buckets + r.num_buckets))

    @staticmethod
    def rank(pairs: list[tuple[IndexLogEntry, IndexLogEntry]]) -> list[tuple[IndexLogEntry, IndexLogEntry]]:
        return sorted(pairs, key=JoinIndexRanker.score)

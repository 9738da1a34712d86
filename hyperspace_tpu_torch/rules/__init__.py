from hyperspace_tpu_torch.rules.base import apply_rules, index_scan_for
from hyperspace_tpu_torch.rules.filter_index_rule import FilterIndexRule
from hyperspace_tpu_torch.rules.join_index_rule import JoinIndexRule
from hyperspace_tpu_torch.rules.ranker import JoinIndexRanker

__all__ = ["apply_rules", "index_scan_for", "FilterIndexRule", "JoinIndexRule", "JoinIndexRanker"]

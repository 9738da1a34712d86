from hyperspace_tpu_torch.vector.index import (
    VectorCreateAction,
    VectorIndexBuilder,
    VectorIndexConfig,
)
from hyperspace_tpu_torch.vector.search import ann_search, brute_force_search

__all__ = [
    "VectorCreateAction",
    "VectorIndexBuilder",
    "VectorIndexConfig",
    "ann_search",
    "brute_force_search",
]

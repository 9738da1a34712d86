from hyperspace_tpu_torch.index.index_config import IndexConfig

__all__ = ["IndexConfig"]

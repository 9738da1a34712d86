from hyperspace_tpu_torch.actions import states
from hyperspace_tpu_torch.actions.base import Action
from hyperspace_tpu_torch.actions.create import CreateAction, IndexWriter

__all__ = ["states", "Action", "CreateAction", "IndexWriter"]

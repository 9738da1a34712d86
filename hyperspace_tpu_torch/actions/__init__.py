from hyperspace_tpu_torch.actions import states
from hyperspace_tpu_torch.actions.base import Action
from hyperspace_tpu_torch.actions.cancel import CancelAction
from hyperspace_tpu_torch.actions.create import CreateAction, IndexWriter
from hyperspace_tpu_torch.actions.delete import DeleteAction
from hyperspace_tpu_torch.actions.optimize import IndexCompactor, OptimizeAction
from hyperspace_tpu_torch.actions.refresh import RefreshAction, RefreshIncrementalAction
from hyperspace_tpu_torch.actions.restore import RestoreAction
from hyperspace_tpu_torch.actions.vacuum import VacuumAction

__all__ = [
    "states", "Action", "CancelAction", "CreateAction", "DeleteAction", "IndexCompactor",
    "IndexWriter", "OptimizeAction", "RefreshAction", "RefreshIncrementalAction",
    "RestoreAction", "VacuumAction",
]

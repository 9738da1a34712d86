"""VacuumAction: hard delete (VACUUMING → DOESNOTEXIST).

Reference parity: actions/VacuumAction.scala:23-52 — valid from DELETED; op
deletes every data version directory newest → 0 (VacuumAction.scala:45-51).
The log itself stays so the name's history survives.

A copy of the JAX package's module.
"""

from __future__ import annotations

import dataclasses

from hyperspace_tpu_torch.actions import states
from hyperspace_tpu_torch.actions.base import Action
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.metadata.data_manager import IndexDataManager
from hyperspace_tpu_torch.metadata.log_entry import IndexLogEntry
from hyperspace_tpu_torch.metadata.log_manager import IndexLogManager


class VacuumAction(Action):
    transient_state = states.VACUUMING
    final_state = states.DOESNOTEXIST

    def __init__(self, log_manager: IndexLogManager, data_manager: IndexDataManager):
        super().__init__(log_manager)
        self.data_manager = data_manager
        self.previous_entry = log_manager.get_latest_log()
        if self.previous_entry is None:
            raise HyperspaceError("no index to vacuum")

    def validate(self) -> None:
        if self.previous_entry.state != states.DELETED:
            raise HyperspaceError(
                f"vacuum is only supported in {states.DELETED} state "
                f"(found {self.previous_entry.state})"
            )

    def op(self) -> None:
        for vid in reversed(self.data_manager.get_version_ids()):
            self.data_manager.delete(vid)

    def build_log_entry(self) -> IndexLogEntry:
        return dataclasses.replace(self.previous_entry)

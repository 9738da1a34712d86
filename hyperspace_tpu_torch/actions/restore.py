"""RestoreAction: undo a soft delete (RESTORING → ACTIVE).

Reference parity: actions/RestoreAction.scala:27-47 — op is a no-op; valid
from DELETED.

A copy of the JAX package's module.
"""

from __future__ import annotations

import dataclasses

from hyperspace_tpu_torch.actions import states
from hyperspace_tpu_torch.actions.base import Action
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.metadata.log_entry import IndexLogEntry
from hyperspace_tpu_torch.metadata.log_manager import IndexLogManager


class RestoreAction(Action):
    transient_state = states.RESTORING
    final_state = states.ACTIVE

    def __init__(self, log_manager: IndexLogManager):
        super().__init__(log_manager)
        self.previous_entry = log_manager.get_latest_log()
        if self.previous_entry is None:
            raise HyperspaceError("no index to restore")

    def validate(self) -> None:
        if self.previous_entry.state != states.DELETED:
            raise HyperspaceError(
                f"restore is only supported in {states.DELETED} state "
                f"(found {self.previous_entry.state})"
            )

    def build_log_entry(self) -> IndexLogEntry:
        return dataclasses.replace(self.previous_entry)

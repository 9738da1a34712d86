"""DeleteAction: soft delete (DELETING → DELETED).

Reference parity: actions/DeleteAction.scala:24-44 — op is a no-op; only the
log transitions, so the index data stays on disk for `restore`. Valid from
ACTIVE.

A copy of the JAX package's module.
"""

from __future__ import annotations

import dataclasses

from hyperspace_tpu_torch.actions import states
from hyperspace_tpu_torch.actions.base import Action
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.metadata.log_entry import IndexLogEntry
from hyperspace_tpu_torch.metadata.log_manager import IndexLogManager


class DeleteAction(Action):
    transient_state = states.DELETING
    final_state = states.DELETED

    def __init__(self, log_manager: IndexLogManager):
        super().__init__(log_manager)
        self.previous_entry = log_manager.get_latest_log()
        if self.previous_entry is None:
            raise HyperspaceError("no index to delete")

    def validate(self) -> None:
        if self.previous_entry.state != states.ACTIVE:
            raise HyperspaceError(
                f"delete is only supported in {states.ACTIVE} state "
                f"(found {self.previous_entry.state})"
            )

    def build_log_entry(self) -> IndexLogEntry:
        return dataclasses.replace(self.previous_entry)

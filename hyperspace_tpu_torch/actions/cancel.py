"""CancelAction: crash recovery for actions that died mid-flight.

Reference parity: actions/CancelAction.scala:34-66 — from any transient
state, roll *forward* to the state of the last stable log entry (or
DOESNOTEXIST if none; a dying VACUUMING cancels forward to DOESNOTEXIST);
rejected when the index is already in a stable state
(CancelAction.scala:54-60). Partial data files from the failed job are left
behind (same acknowledged limitation as the reference).

A copy of the JAX package's module.
"""

from __future__ import annotations

import dataclasses

from hyperspace_tpu_torch.actions import states
from hyperspace_tpu_torch.actions.base import Action
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.metadata.log_entry import IndexLogEntry
from hyperspace_tpu_torch.metadata.log_manager import IndexLogManager


class CancelAction(Action):
    transient_state = states.DOESNOTEXIST  # overridden below; begin() skipped

    def __init__(self, log_manager: IndexLogManager):
        super().__init__(log_manager)
        self.previous_entry = log_manager.get_latest_log()
        if self.previous_entry is None:
            raise HyperspaceError("no index to cancel")

    @property
    def final_state(self) -> str:  # type: ignore[override]
        if self.previous_entry.state == states.VACUUMING:
            return states.DOESNOTEXIST
        stable = self.log_manager.get_latest_stable_log()
        return stable.state if stable is not None else states.DOESNOTEXIST

    def validate(self) -> None:
        if self.previous_entry.state in states.STABLE_STATES:
            raise HyperspaceError(
                f"cancel is not supported in stable state {self.previous_entry.state}"
            )

    def begin(self) -> None:
        # Cancel is a single forward transition — no transient phase.
        pass

    def end(self) -> None:
        entry = self.log_entry.with_state(self.final_state)
        final_id = self.base_id + 1
        self._save_entry(final_id, entry)
        # Atomic pointer overwrite — same no-delete rule as Action.end().
        self.log_manager.create_latest_stable_log(final_id)

    def build_log_entry(self) -> IndexLogEntry:
        stable = self.log_manager.get_latest_stable_log()
        base = stable if stable is not None else self.previous_entry
        return dataclasses.replace(base)

"""The Action protocol: a two-phase commit over the operation log.

Reference parity: actions/Action.scala:33-96. Every lifecycle operation runs

    run() = validate(); begin(); op(); end()

where `begin` CAS-writes log id `base_id + 1` in the transient state and
`end` CAS-writes `base_id + 2` in the final state, then swaps the
`latestStable` pointer (Action.scala:47-73). If either CAS write loses to a
concurrent writer, the action aborts with "Could not acquire proper state"
(Action.scala:75-80) — single-writer optimistic concurrency.

A copy of the JAX package's protocol, so the op log each package writes
reads the same in the other. An `op()` that raises an ordinary Exception
is rolled back in-process: a roll-back entry restoring the last stable
state is CAS-written at `base_id + 2` and the action's partial data is
quarantined. A hard crash (process death, simulated by
`faults.CrashPoint`, a BaseException this handler deliberately does not
catch) leaves the transient entry behind, and `recover()`
(index/collection_manager.py) repairs it from the next process. With
`hyperspace.retry.casAttempts` > 1, a begin() that loses its CAS re-reads
the log and retries the whole protocol. Each phase is a tracing span
(`action.validate / begin / op / rollback / end`) under an
`action.<Action>` trace; spans close on a BaseException too, so a
simulated crash still records which phase died.
"""

from __future__ import annotations

import dataclasses

from hyperspace_tpu_torch import states
from hyperspace_tpu_torch import stats as _stats
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.metadata.log_entry import IndexLogEntry
from hyperspace_tpu_torch.metadata.log_manager import IndexLogManager
from hyperspace_tpu_torch.obs import trace as obs_trace
from hyperspace_tpu_torch.utils import retry


class Action:
    transient_state: str
    final_state: str

    def __init__(self, log_manager: IndexLogManager):
        self.log_manager = log_manager
        self._base_id: int | None = None
        self._log_entry: IndexLogEntry | None = None

    # -- extension points -------------------------------------------------
    def validate(self) -> None:
        """Raise HyperspaceError if this action is not permitted now."""

    def op(self) -> None:
        """Do the work (data plane). Default: metadata-only transition."""

    def build_log_entry(self) -> IndexLogEntry:
        """Construct the entry this action commits (lazily, once)."""
        raise NotImplementedError

    def cleanup_failed_op(self) -> None:
        """Quarantine/remove partial data a failed `op()` left behind.
        Default: nothing. Must never raise."""

    # -- protocol ---------------------------------------------------------
    @property
    def base_id(self) -> int:
        if self._base_id is None:
            latest = self.log_manager.get_latest_id()
            self._base_id = -1 if latest is None else latest
        return self._base_id

    @property
    def log_entry(self) -> IndexLogEntry:
        if self._log_entry is None:
            self._log_entry = self.build_log_entry()
        return self._log_entry

    def _save_entry(self, id: int, entry: IndexLogEntry) -> None:
        if not self.log_manager.write_log(id, entry):
            raise HyperspaceError(
                "Could not acquire proper state: concurrent writer committed "
                f"log id {id} first"
            )

    def begin(self) -> None:
        entry = self.log_entry.with_state(self.transient_state)
        self._save_entry(self.base_id + 1, entry)

    def end(self) -> None:
        entry = self.log_entry.with_state(self.final_state)
        final_id = self.base_id + 2
        self._save_entry(final_id, entry)
        # Atomic overwrite of the pointer (temp file + os.replace).
        self.log_manager.create_latest_stable_log(final_id)

    def run(self) -> None:
        """Execute the two-phase protocol, with rollback on op() failure.

        CAS contention at begin() aborts by default (single-writer
        optimistic concurrency, Action.scala:75-80); when
        `hyperspace.retry.casAttempts` > 1 the whole protocol re-reads
        the log and retries.
        """
        # A root trace when called bare, a child span when a trace is
        # already open. Spans close on BaseException too, so a simulated
        # crash (CrashPoint) still records which phase died.
        with obs_trace.trace(f"action.{type(self).__name__}"):
            attempts = retry.cas_attempts()
            for attempt in range(attempts):
                with obs_trace.span("action.validate"):
                    self.validate()
                try:
                    with obs_trace.span("action.begin", attempt=attempt + 1):
                        self.begin()
                except HyperspaceError:
                    if attempt + 1 >= attempts:
                        raise
                    # A concurrent writer won this id: re-read the world
                    # and re-validate from scratch.
                    self._base_id = None
                    self._log_entry = None
                    continue
                break
            try:
                with obs_trace.span("action.op"):
                    self.op()
            except Exception:
                # Software failure mid-op (NOT a crash: CrashPoint is a
                # BaseException and skips this handler by design).
                with obs_trace.span("action.rollback"):
                    self._rollback_failed_op()
                raise
            try:
                with obs_trace.span("action.end"):
                    self.end()
            except HyperspaceError:
                # Lost the final CAS: the winner's entry stands — only our
                # partial data needs quarantining.
                self.cleanup_failed_op()
                raise

    def _rollback_failed_op(self) -> None:
        """Best-effort in-process recovery for a failed op(): CAS-write a
        roll-back entry at `base_id + 2` restoring the last stable state
        (DOESNOTEXIST when there is none, or for a dying vacuum — the
        rules of cancel.py), repoint `latestStable`, quarantine partial
        data. Every step tolerates failure: whatever this leaves undone,
        `recover()` finishes from the next process."""
        try:
            stable = self.log_manager.get_latest_stable_log()
            if self.transient_state == states.VACUUMING:
                state = states.DOESNOTEXIST
            else:
                state = stable.state if stable is not None else states.DOESNOTEXIST
            base = stable if stable is not None else self.log_entry
            rollback = dataclasses.replace(base).with_state(state)
            rollback_id = self.base_id + 2
            if self.log_manager.write_log(rollback_id, rollback):
                self.log_manager.create_latest_stable_log(rollback_id)
                _stats.increment("action.rolled_back")
        except Exception as rb_err:
            # Must not raise, but never silently: a failed rollback means
            # recover() owns the repair.
            _stats.increment("action.rollback_failed")
            obs_trace.event("action.rollback_failed", error=str(rb_err))
        try:
            self.cleanup_failed_op()
        except Exception as cl_err:
            _stats.increment("action.cleanup_failed")
            obs_trace.event("action.cleanup_failed", error=str(cl_err))

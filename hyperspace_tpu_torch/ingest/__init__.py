"""Continuous ingestion: CDC tailing, micro-batch commits and pinned
snapshot reads.

A port of the JAX package's `ingest/`. The package turns the batch-era
refresh into a service:

- `tailer`   — poll-based source watchers: new-file arrival detection and
  a CDC changelog tailer that materializes appended rows into
  deterministic batch files, with an atomically persisted cursor.
- `writer`   — micro-batch commits through the unchanged two-phase action
  protocol (one incremental refresh a batch, one crash-safe delta
  bucket), and gated background compaction.
- `snapshot` — `PinnedSnapshot`: a query pins the per-index version stamp
  it was admitted under and re-reads repeatably against it while
  micro-batches commit underneath.
- `daemon`   — the `IngestDaemon` service loop tying them together: a
  thread by default, or a spawned worker process
  (`hyperspace.ingest.processWorker`) on the device the parent names;
  pausable by the controller through an atomically written control file;
  registered on `/healthz`.

Cursors, batch files, the control file and every index version are laid
out as the JAX package lays them out, so either package continues what
the other started.
"""

from hyperspace_tpu_torch.ingest.daemon import IngestDaemon
from hyperspace_tpu_torch.ingest.snapshot import PinnedSnapshot
from hyperspace_tpu_torch.ingest.tailer import CdcTailer, FileArrivalWatcher

__all__ = ["IngestDaemon", "PinnedSnapshot", "CdcTailer", "FileArrivalWatcher"]

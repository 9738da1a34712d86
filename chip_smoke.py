"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--sf 1.0] [--seed 42]

What it does, in order (any failure raises and exits non-zero):

1. starts nvidia-smi's query of the card's name and power limit in the
   background (read at the end), then builds every CUDA kernel of the port from `hyperspace_tpu_torch/csrc/` (one nvcc per
   source, started together) into `build/kernels/`;
2. aggregate path, through the user entry points: generates TPC-H
   lineitem (16 columns; 6,001,991 rows at SF1 with seed 42, where
   TPC-H's own table holds 6,001,215), builds the `l_orderkey` covering
   index with 200 buckets, runs 12 point lookups with the index enabled
   and disabled, and runs the Q1-shaped group-by and the per-order
   revenue aggregate, each checked against an independent pyarrow
   computation on the same parquet. Every query of the run goes through
   `HyperspaceSession.run_query` and one `PlanCache`, once cold and once
   warm: the warm run must hit the plan cache (index enabled), read no
   file (the device cache), hit HOST_DERIVED for its group ids or join
   codes, and give the cold run's result; it prints its host time by
   step (plan, read, derive, the rest). Each aggregate runs twice more
   under `torch.profiler`, for the kernels' device time inside the warm
   query (the second run: the profiler can miss kernels launched soon
   after it starts).
   Then the range queries on the index's sorted key, index on and off,
   against pyarrow: `l_orderkey` between two literals 1% of the key
   domain apart, a strict open range over its top 1%, and the computed
   projection `l_extendedprice * (1 - l_discount)` over the first, with
   files read and pruned, rows pruned and the slice's exactness. The two
   caches' bytes, entries, hits, misses and evictions print after each
   path, and the run fails if either holds more than its budget;
3. join path, on the same lineitem index: generates TPC-H orders (9
   columns, 1.5M rows at SF1, seed 43), builds the `o_orderkey` index
   with `o_totalprice, o_orderpriority, o_orderdate` (200 buckets), and
   runs J1 (the lineitem ⋈ orders join of benchmarks/bench_join.py), J2
   (an aggregate over the join grouped on the orders side) and J3
   (grouped on the lineitem side), each cold and warm with the index
   enabled (the zero-exchange aligned path) and disabled (one partition;
   J1 the broadcast probe, lineitem being at least 4x orders), each checked
   against pyarrow's join and group-by on the same parquet (J1 pair by
   pair); J2 and J3 run three times more, the last two under
   `torch.profiler` (indexed, and J2 also without the index), and once
   more with K1's inputs recorded;
3a'. mesh path (`mesh_path`), on the aggregate and join paths' lineitem
   and orders: a session over `make_mesh([card] * 4)`, four virtual
   shards of the one card, builds config 1's lineitem index and config
   2's orders index (200 buckets), and orders again over the (2, 2)
   multi-slice mesh, every file byte-identical to the one-device build's;
   then Q1 and revenue (agg_devices 4, one K1 a shard a run), J1 indexed
   (join_devices 4, one K2 a shard a run), the 1% range index on and off
   (unindexed through the shard masks), ORDER BY l_extendedprice DESC
   LIMIT 100 and Q3 (mesh-sharded-select), each cold and warm on the mesh
   and on the one-device session, equal to the one device's answers (sums
   within 2·N·u) and to pyarrow where the earlier paths hold them to it;
3b. join-types path, on the join path's session, lineitem and orders:
   generates TPC-H customer (150,000 rows, seed 45), builds
   `customer_custkey` (with `c_nationkey, c_acctbal`) and
   `orders_custkey` (with `o_orderkey, o_totalprice, o_comment`), 200
   buckets, and
   runs Q13 (customer LEFT JOIN orders with the residual `o_totalprice >
   400000`, then two aggregates), a RIGHT and a FULL outer join of J1's
   columns on filtered sides, Q4's SEMI / ANTI joins and Q21's with the
   residual `l_extendedprice > o_totalprice * 0.1` (counted by priority),
   INTERSECT and EXCEPT, an aggregate over a join with one indexed side
   under `hyperspace.join.rebucketize = force` (REB), a semi join chained
   on J1's bucket-grouped output (CHAIN), and J2's aggregates over orders
   filtered to a quarter (DPPq) or to 12 keys (DPPk), each cold and warm,
   index on and off, each against pyarrow (rows exactly; non-integral
   sums within the join bound), each on the JAX package's path
   (`JOIN_TYPE_EXPECT`) with K2 and K1 launched where that path runs
   them and the membership probes launching no K2; one line a query;
3c. query-surface path, on the join-types path's session, lineitem,
   orders and customer (`orders_custkey` also holds `o_comment`):
   generates the TPC-DS store channel at the same scale (date_dim 73,049
   rows, item 18,000, store 12, store_sales 2,879,987 at SF1), builds
   `ss_by_date` and `dd_by_sk` as benchmarks/tpcds.py defines them (64
   buckets), and runs `query_surface_plans`: TPC-H Q1 as written with its
   ORDER BY, Q3 (top 10 by revenue), Q12 (the CASE counts on
   `o_orderpriority`), Q13 (LEFT JOIN on `o_comment NOT LIKE
   '%special%requests%'`), YEAR (a date part in a projection), LIM (a
   LIMIT's early-out), TPC-DS q43 (the pushdown), q36 and q67 (ROLLUP
   with a rank window), q98 (a partition-frame window sum), WIN (every
   frame, shift and ranking), CD1 and CD2 (count-distinct's two
   branches) and CUBE; each cold and warm, index on and off, against
   pandas on the same parquet (rows in the ORDER BY's order; non-integral
   sums within the float64 join bound, and rows whose float order key
   ties within it may swap), on the JAX package's path
   (`QUERY_SURFACE_EXPECT`: the aggregate's branch, the joins' paths, the
   top-N selection, the early-out) with K1 in every query but LIM, K2
   where that path merges and K3 in none; one line a query;
3v. venue path (`venue_path`), on the join-types path's session and the
   lineitem, orders and customer indexes (200 buckets): the card→host link
   read as the JAX package's probe reads it (one 4 MB copy; the port's
   `auto` reads no link) beside 4 MB pinned and 64 MB pageable copies;
   Q1, revenue,
   the 1% range (index on and off), J1 indexed, J2, REB (the forced
   exchange) and Q3, each cold and warm with every venue key `host`, then
   `device`, then `auto`; then config 1's lineitem index built again on
   the host build venue. Host answers equal the device's (exactly;
   non-integral sums within 2·N·u) and pyarrow's; the host build's bucket
   files are byte-identical to the main path's; host runs launch neither
   K1 nor K2 and show the JAX package's host names; `auto` launches what
   `device` launches, with the same names; one `venue_query` line each;
3d. lifecycle path, on the join path's session and orders: BASELINE
   config 3 (hybrid scan, as benchmarks/bench_hybrid.py runs it on
   lineitem): hard-links lineitem's files into a directory of its own,
   builds `li_live` on it (`l_orderkey`, 200 buckets), appends the port's
   lineitem at a tenth of the scale (seed 46: about 600,000 rows at SF1)
   and, with hybrid scan on, runs `lifecycle_plans` (the 12 lookups, the
   1% range, an aggregate over it and J2 with orders) cold and warm,
   index on and off, against pyarrow on the grown data: the filters
   through `HybridScanFilter`, J2 zero-exchange aligned with the appended
   rows bucketized on the fly and sorted per bucket before K2; appends a
   second file (a twentieth, seed 47), whose next run misses the plan
   cache; then times an incremental refresh (two version dirs), optimize
   (one file a bucket, no bucket sorted before K2) and a full refresh,
   each followed by the queries; then BASELINE config 4, the NYC-Taxi
   loop of benchmarks/bench_refresh.py at one month of trips a batch
   (six batches of 3,000,000 rows, `trips_zone` with 32 buckets: create,
   five appends with an incremental refresh and two queries against
   pyarrow, optimize after batch 3, a full refresh, the
   `taxi_incremental_ingest_throughput`); then delete / restore, a
   recover of the superseded versions, a crashed refresh (a REFRESHING
   entry and a partial version dir) recovered, delete / vacuum, with
   `indexes()` listing each state; K1's and K2's inputs from one hybrid
   J2 run join the kernel phase; K1 and K2 launch, K3 does not;
3e. serving path, on the lifecycle path's session and indexes
   (`lineitem_orderkey`, `orders_orderkey`, the customer indexes,
   `ss_by_date`, `dd_by_sk`, and `li_live` re-created): the mix of 12
   point lookups with distinct keys (benchmarks/bench_serve.py's
   workload) and the earlier phases' Q1, revenue, J2, J3, Q13 and q43
   (`serve_mix`) runs serially through `run_query`, then through
   `session.serve()` (4 workers, the result cache off) at 1, 4 and 16
   clients, each with a cold plan cache and then a warm one, the
   submissions split as bench_serve.py's `_run_phase` splits them: every
   result equals its serial run (bit-equal but the non-integral sums and
   means, within 2·N·u of it, `SERVE_SUMS`), K1's and K2's launches in
   each pass equal the serial pass's, every handle's profile holds the
   physical tree of `SERVE_EXPECT` (the JAX package's op names) with its
   operator walls telescoping to the root; qps and p50 / p95 / p99 print
   for each client count and cache state. Then the result cache: a repeat
   J2 hits, launching no kernel and reading no column; a tensor written
   in place misses; 16 clients loop 12 lookups on `li_live` while the
   main thread appends a file (a fiftieth, seed 48) and refreshes
   incrementally: every answer is pyarrow's before or after, and after
   for every lookup submitted once the refresh returned. Then admission
   (16 instant submits at max_queue_depth 4: typed refusals only; a queue
   timeout discarded unexecuted; drain; shutdown leaves no worker), warm
   Q1 and J2 with `hyperspace.obs.enabled` on and off (median of 5), and
   explain (diff, physical, analyze) of Q1 and J2; K1 and K2 launch, K3
   does not;
3f. validation and faults (`faults_path`), on the serving path's tables
   and indexes: (a) `check_plan` + `validate_rewrite` alone on the
   optimized plans of Q1, J2, q67 and Q13 (host ms, median of 5), warm Q1
   and J2 with `hyperspace.analysis.validate` on and off (200 and 20
   repeats, on and off alternating in order within each: medians,
   quartiles and the median of the paired differences), and the malformed queries of `VALIDATE_EXPECT` on lineitem, orders and
   customer, each refused with the JAX package's code and path and no
   kernel launched; (b) the corruption fallback: li_live's newest
   version's bucket files truncated to 7 bytes with both caches dropped,
   the 12 lookups and the Q1-shaped aggregate over its source against
   pyarrow (the first lookup re-plans once, li_live quarantined with one
   `fallback.replan` and one `index.quarantined` event; the rest plan
   around it), J2 in a fresh session re-planning once and keeping
   orders_orderkey, a fresh session's server (result cache on) not
   caching the re-planned lookup, `IndexCorruptionError` with
   `hyperspace.fallback.enabled` off, a full refresh lifting the
   quarantine (the lookups and J2 through the index again, K2), and a
   transient `bucket.read` fault (twice) under a cold J2, retried twice;
   (c) the crash sweep on orders at the run's scale (200 buckets, a
   system path of its own): the fault points create, an incremental
   refresh of one appended file (a twentieth, seed 49), optimize and
   vacuum fire, each replayed from its set-up state (restored from a copy)
   with a `CrashPoint` at its first call, and create's `bucket.written`
   call 100, `log.write` call 2 and `file.write_json` call 2; after each,
   the latest stable entry resolves, recover converges with no orphan
   version dir and a second recover does nothing, and an `o_orderkey`
   lookup and an aggregate by `o_orderpriority` equal pyarrow; one
   `faults_sweep` line an action; also a streaming create (a
   budget of a fifth of the input) and a pooled create (2 workers), each
   replayed at its points of `BUILD_POINTS` as a crash (a CrashPoint, or a
   WorkerCrashed where a worker died), the streaming create's also as a
   transient fault (`SWEEP_TRANSIENTS`), no spill
   or exchange dir left after any, and `prefetch.issue` /
   `device.stage` around a cold lookup (a crash, then advisory transient
   faults with the answer unchanged); K1 and K2 launch, K3 does not;
3g. the build at scale (`build_scale_path`): TPC-H lineitem at SF5
   (`--build-sf`; about 30M rows, generated by one process a core), the
   start-up of 4 spawned pool workers (the worker module's import),
   BASELINE config 1's index (`l_orderkey` with `l_partkey, l_quantity,
   l_extendedprice, l_discount`, 200 buckets) built five ways through
   `create_index`, each timed by phase: (a) in memory at the default 4 GiB
   budget, (b) streaming at a fifth of the input (256 MiB at SF5) with the
   pipeline off, (c) with it on, (d) pooled with 2 and (e) 4 workers;
   (b)-(e) byte-identical (every bucket file and the manifest), (a) with
   (b)'s row counts, rows and keys sorted in every bucket; no spill or
   exchange dir left, no worker with a CUDA context. On (b) the 12
   lookups (1 of 200 files), the 1% range and the revenue over it by
   `l_orderkey` (K1), cold and warm, index on and off, against pyarrow;
   then a twentieth appended (seed 50), an incremental refresh and an
   optimize at the budget (the streaming compactor, one file a bucket),
   the queries again. Then on the aggregate path's index the 12 cold
   lookups with zero-copy staging and with the query-tail prefetch on and
   off (`STAGE_REPEATS` pairs, the first setting alternating), the
   staging counters of a cold pass, and a cold pass under a transient
   `device.stage` fault; K1 launches, K2 and K3 do not. Then phase 3d's
   incremental refresh and taxi loop with the hash path they ran on
   (`native_hash_refresh_and_taxi`, against the numpy hash's records in
   PERF.md);
3h. the fleet (`fleet_path`), on the earlier phases' store and 3e's mix:
   the mix serially (each result also written as Arrow IPC), then 16
   client threads pulling 4 passes of it from one shared work queue,
   served by this process (`session.serve()`, 4 workers), by a fleet of 2
   and a fleet of 4 spawned members (`FleetSupervisor`; each member opens
   its own CUDA context, loads the kernels phase 1 built, and serves
   through `shared_caches(session)`'s plan cache with 4 workers): qps,
   p50 / p99, every served result equal to its serial run's (strings as
   strings, the sums of `SERVE_SUMS` within 2·N·u), the members' summed
   K1 / K2 launches 4x the serial pass's, each member's start-up (spawn
   to entry, context, kernel load, the mix's cold pass), memory and
   HOST_DERIVED hits and misses; (b) the shared result cache: J2 computed
   by one member served by the other with no launch and no column read;
   (c) li_live re-created and looped by both members across an append (a
   fiftieth, seed 51) and an incremental refresh: no stale answer; (d) on
   the fleet of 4 an instant burst against tenant quotas and a shed ratio
   (typed refusals only, p99 bounded), `fleet_health` with every member's
   saturation, one member SIGKILLed and respawned, a single-flight lease
   holder SIGKILLed and taken over; (e) the fleet of 2 with the
   controller, the journal and the HTTP plane on: a `bucket.read` error
   burst pages, each controller sheds and throttles, clean traffic
   releases both; orders_orderkey's newest bucket files truncated, both
   members quarantine it, exactly one heals it (recover and a full
   refresh) and the other observes the marker; J2 aligned again with K2;
   an incident bundle holds both members' journal segments. One line a
   regime (`fleet_pass`, `fleet_startup`, `fleet_overload`,
   `fleet_shared_result_cache`, `fleet_refresh_churn`,
   `fleet_controller`); the members' launches are read in their own
   processes and join the kernels line as `fleet_members`;
3i. the advisor (`advisor_path`), on the same session, store and plans
   (`advisor_plans`: the 12 lookups, the 1% range, Q1, revenue, J1-J3,
   Q13, DPPk, q43, q67) at SF1, the workload log emptied first: (a)
   benchmarks/bench_advisor.py's three phases with adaptive routing on
   (minSamples 2): raw (index off), indexed (demotion suppressed), routed
   (demoteRatio 1), each plan 2 untimed runs with the ledger off, then 3
   recorded; every routed run takes the decision the ledger's EMAs give
   just before it, a demoted run the raw run's physical operators, join
   paths and K1 / K2 launches and no index scan, a kept one the indexed
   run's; routed, raw and indexed answers agree (`same_rows`, q43 / q67
   against the query surface's reference) and explain's routing line
   agrees with the ledger; medians, routed / raw and the number demoted
   print, no time is gated (one `advisor_query` line a plan); (b) a full
   refresh of `customer_custkey` moves the collection stamp: one
   invalidation, every decision indexed again; (c) a cold index over a
   table of its own and 12 cold `l_partkey` lookups: `recommend()` gives
   their create and the cold index's drop, a sweep with autoCreate and
   autoVacuum builds `adv_lineitem_l_partkey` on the card through the
   Action log and vacuums the cold index, and the next lookup reads 1 of
   200 bucket files and equals pyarrow; (d) the operations controller, the
   lifecycle gates off: one step drains (a)'s demotions from the event
   ring and makes exactly one audited `advisor.sweep`, which mutates
   nothing; K1 and K2 launch, K3 does not;
3j. continuous ingestion (`ingest_path`), at benchmarks/bench_ingest.py's
   full workload with nothing cut, on a store of its own: (a) a seed
   batch of 500,000 trips (`gen_trips_batch`, seed 50) indexed as
   `trips_zone` (`zone` with `fare`, `distance`; 16 buckets), the daemon
   in thread mode on the card (pollSeconds 0.02, maxLagSeconds 60,
   cdcBatchRows 10,000, the advisor's autoOptimize on so that compaction
   runs past maxDeltas 4), bench_ingest's producer (8 more batches
   published by `os.replace`, each with a CDC wave of 10,000 JSON rows)
   and a querier alternating the gauge (`zone == 42`) with a zone
   aggregate over 12 zones (K1), re-reading both through a snapshot
   pinned before the first commit; /healthz read once while it runs:
   every pinned read the admission answer (sums within 2·N·u), no live
   answer backwards or stale past the lag bound, no untyped error, p99
   under 5 s, after the drain the gauge the expected total and the
   aggregate pyarrow's over every file, at least 8 commits, a
   compaction, every action's version dirs, each build's sort on the
   card, K1 in every aggregate and none in a lookup; the throughput
   prints beside bench_ingest's 0.11 GB/s floor, ungated; (b) on that
   index, two more batches with `hyperspace.ingest.processWorker` on:
   the worker (its session on the card) commits the first and is
   SIGKILLed, recover converges (no transient tail, no orphan version
   dir), a restarted worker drains the rest exactly once, both workers'
   journaled commits sorted on the card, no launch in this process
   during the workers' window; K1 launches, K2 and K3 do not;
4. vector path, at the shape of SIFT1M: generates 1,000,000 clustered
   128-d float32 embeddings (seed 7, 64 clusters), builds a vector index
   with `id` included (64 partitions, l2; timed by phase: read, k-means,
   assign, carve), checks its partition row counts against the manifest,
   runs brute force (index disabled) at k = 10 and k = 100 and
   `ann_search` at nprobe 8 and 64, each cold and warm, for 32 queries
   (rows drawn with seed 9, plus 0.01), two more nprobe-8 queries under
   `torch.profiler`, and one nprobe-8 and one brute-force query with
   K3's inputs recorded; brute force and full probe are checked against a
   float64 top-k on the host, and recall@10 at nprobe 8 must reach 0.8;
   brute force and nprobe 8 run once more at k = 5,000 (past K3's
   shared-memory sort), brute force against the exact top 5,000 and
   nprobe 8 with every score its row's exact distance;
4b. vector lifecycle, on the vector path's index: appends 100,000 rows
   from the same clusters (`gen_embeddings(..., appended=)`), refreshes
   incrementally (two version dirs, the centroids unchanged) and
   optimizes (retrained, one version), each followed by brute force,
   nprobe 8 and full probe (k = 10) against a float64 top-10 over the
   1,100,000 rows: full probe equal to brute force, recall@10 at nprobe 8
   at least 0.8; K3 launches;
   kernel launch counts are zeroed just before each path and read just
   after it: every kernel a path runs must have launched in it, and no
   other;
5. kernel phase: holds each kernel against its plain PyTorch version on
   the card at the shapes the paths gave it (K1: the aggregates' row
   count, group counts and channels on seeded channels with uniformly
   random group ids, the very inputs the two aggregates gave it, and
   those of its four launches in the indexed J2 and J3 — the secondary
   run extrema and the group fold — and of the hybrid J2's two, of the
   query surface's q67 re-fold, CD1 inner and q43 partial aggregates, and
   of 3f's: the Q1-shaped aggregate over li_live's source answered through
   the fallback, and the crash sweep's aggregate by `o_orderpriority`
   after create's and the incremental refresh's first replay, of 3g's
   revenue over the streamed index's 1% range, and of 3j's zone aggregate
   over the drained index; K2: the
   join's real key codes at the aligned J2 and J3 shapes, the hybrid
   J2's and the un-indexed J2 shape, and the aligned J2 codes with each
   primary row shuffled, so that the kernel's windows
   span the row and it searches device memory; K3: the vector
   path's routing, candidate and brute-force score matrices, and a
   tie-heavy matrix at the brute-force shape, bit-equal; and at
   k = 5,000 on the candidate and brute-force matrices), and times
   kernel, plain version and the library yardstick with CUDA events
   (median of 12 runs after warm-up; for K2 also a device copy moving as
   many bytes), and each call's kernels alone with torch.profiler (one
   window for all the kernels' calls);
   a profiled window that misses a kernel it should hold fails the run;
6. prints one JSON line describing every kernel, the card's name and
   power limit (nvidia-smi's answer; through NVML, the library it reads,
   if it gave none), the script's wall, and, last,
   `{"ok": true, "device": {...}}`.

A phase that fails prints `{"failed_phase": "<name>", "error": "<type:
message>"}` to stdout and stderr before the exception propagates (`phase`).

It needs a CUDA card and the repository around it; without either it
fails before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

# H100 SXM (NVIDIA data sheet): 3.35 TB/s HBM3, 34 TFLOP/s float64 and
# 67 TFLOP/s float32 outside the tensor cores; K2's int32 compares are
# counted at the 32-bit rate.
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12
INT32_OPS = 67e12
REPEATS = 12
BIG_K = 5000  # a vector search's k past K3's shared-memory sort (2,048)
UNIT_ROUNDOFF = 2.0**-53  # float64
INDEXED = ["l_orderkey"]
INCLUDED = ["l_partkey", "l_quantity", "l_extendedprice", "l_discount"]
Q1_GROUP = ["l_returnflag", "l_linestatus"]
Q1_AGGS = [
    ("sum", "l_quantity", "sum_qty"),
    ("sum", "l_extendedprice", "sum_price"),
    ("mean", "l_discount", "avg_disc"),
    ("min", "l_extendedprice", "min_price"),
    ("max", "l_discount", "max_disc"),
    ("count", None, "count_order"),
]
# The channels aggregate_arrays stacks for Q1_AGGS: a value channel and a
# non-null count channel per aggregate.
Q1_FNS = ("sum", "sum", "sum", "sum", "sum", "sum", "min", "sum", "max", "sum", "sum", "sum")
O_INDEXED = ["o_orderkey"]
O_INCLUDED = ["o_totalprice", "o_orderpriority", "o_orderdate"]
J2_AGGS = [
    ("sum", "l_extendedprice", "sum_price"),
    ("sum", "l_quantity", "sum_qty"),
    ("min", "l_discount", "min_disc"),
    ("max", "l_extendedprice", "max_price"),
    ("mean", "o_totalprice", "avg_total"),
    ("count", None, "cnt"),
]
J3_AGGS = [
    ("sum", "o_totalprice", "sum_total"),
    ("max", "o_totalprice", "max_total"),
    ("sum", "l_extendedprice", "sum_price"),
    ("count", None, "cnt"),
]


def sum_tolerance(rows, abs_sum):
    """How far two float64 sums of the same values, taken in different
    orders, may differ: each is within (m-1)·u·Σ|v| of the exact sum for a
    group of m rows (recursive summation, u = 2^-53), so the two are within
    twice that. Floored at 1e-12·Σ|v|, the tolerance of the CPU parity
    tests, whose groups are small enough for the floor to hold."""
    rows = np.asarray(rows, dtype=np.float64)
    return np.maximum(1e-12, 2 * np.maximum(rows - 1, 0) * UNIT_ROUNDOFF) * np.asarray(abs_sum)


@contextlib.contextmanager
def phase(name: str):
    """Names the phase a failure came from: an exception inside first
    prints one JSON line, {"failed_phase": name, "error": "<type: message>"},
    to stdout and to stderr, then propagates unchanged (reported once,
    by the innermost phase)."""
    try:
        yield
    except BaseException as e:
        if not getattr(e, "_chip_smoke_phase", None):
            line = json.dumps({"failed_phase": name, "error": f"{type(e).__name__}: {e}"[:4000]})
            print(line, flush=True)
            print(line, file=sys.stderr, flush=True)
            try:
                e._chip_smoke_phase = name
            except AttributeError:
                pass
        raise


def log(*args) -> None:
    print(*args, flush=True)


NVIDIA_SMI = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]


def start_card_query() -> subprocess.Popen | None:
    """Start nvidia-smi's query of the card's name and power limit in the
    background. On a card whose driver is not kept loaded, nvidia-smi may
    take minutes to answer, so it runs beside the whole smoke run and is
    read at its end (`card_line`). None where there is no nvidia-smi."""
    try:
        return subprocess.Popen(NVIDIA_SMI, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    except FileNotFoundError:
        return None


def stop_process(proc: subprocess.Popen | None) -> None:
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.wait()


def _smi_line(proc: subprocess.Popen, wait_s: float) -> str | None:
    """nvidia-smi's first line, or None if it failed or gave no answer
    within `wait_s` seconds (and was then stopped)."""
    try:
        out, _ = proc.communicate(timeout=wait_s)
    except subprocess.TimeoutExpired:
        stop_process(proc)
        return None
    lines = out.strip().splitlines()
    return lines[0] if proc.returncode == 0 and lines else None


def nvml_card_line() -> str:
    """The same two fields in nvidia-smi's format, read through NVML, the
    library nvidia-smi itself reads (power.limit is NVML's power
    management limit, in milliwatts)."""
    import ctypes

    nvml = ctypes.CDLL("libnvidia-ml.so.1")

    def check(rc: int, what: str) -> None:
        if rc != 0:
            raise RuntimeError(f"NVML {what} returned {rc}")

    check(nvml.nvmlInit_v2(), "nvmlInit_v2")
    try:
        handle = ctypes.c_void_p()
        check(nvml.nvmlDeviceGetHandleByIndex_v2(0, ctypes.byref(handle)), "nvmlDeviceGetHandleByIndex_v2")
        name = ctypes.create_string_buffer(96)
        check(nvml.nvmlDeviceGetName(handle, name, ctypes.c_uint(96)), "nvmlDeviceGetName")
        milliwatts = ctypes.c_uint()
        check(nvml.nvmlDeviceGetPowerManagementLimit(handle, ctypes.byref(milliwatts)),
              "nvmlDeviceGetPowerManagementLimit")
    finally:
        nvml.nvmlShutdown()
    return f"{name.value.decode()}, {milliwatts.value / 1000:.2f} W"


def card_line(query: subprocess.Popen | None) -> str:
    """The card's name and power limit as nvidia-smi gives them: the
    background query's answer, waited for up to 180 s more; else a second
    nvidia-smi, which finds the driver loaded by now, for up to 120 s;
    else the same fields through NVML."""
    line = _smi_line(query, 180) if query is not None else None
    if line is None:
        retry = start_card_query()
        line = _smi_line(retry, 120) if retry is not None else None
    return line if line is not None else nvml_card_line()


def cuda_ms(fn, repeats: int = REPEATS) -> float:
    """Median milliseconds of `fn` on the card (CUDA events), after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# -- kernel phase -------------------------------------------------------------


def _k1_inputs(rng, n: int, k: int, fns: tuple, kinds: tuple):
    """Channels shaped like the main path's: kinds name each channel's
    data ('qty' integral, 'price'/'disc' non-integral, 'ind' 0/1)."""
    gid = rng.integers(0, k, n).astype(np.int32)
    vals = np.empty((len(fns), n))
    for c, (fn, kind) in enumerate(zip(fns, kinds)):
        if kind == "qty":
            vals[c] = rng.integers(1, 51, n)
        elif kind == "price":
            vals[c] = np.round(rng.integers(1, 51, n) * (900 + rng.random(n) * 100_000) / 100, 2)
        elif kind == "disc":
            vals[c] = np.round(rng.integers(0, 11, n) / 100.0, 2)
        else:
            vals[c] = (rng.random(n) < 0.999).astype(np.float64)
        if fn in ("min", "max"):
            special = rng.integers(0, n, 30)
            vals[c][special[:10]] = np.nan
            vals[c][special[10:20]] = np.inf
            vals[c][special[20:]] = -np.inf
    return gid, vals


def _k1_exact(kinds: tuple, fns: tuple) -> list[bool]:
    return [fn != "sum" or kind in ("qty", "ind") for fn, kind in zip(fns, kinds)]


def _k1_exact_from_data(vals_np: np.ndarray, fns: tuple) -> list[bool]:
    """Which channels any summation order gives bit-equal: extrema, and
    sums of integral values whose Σ|v| stays below 2^53."""
    return [
        fn != "sum" or bool(np.all(np.mod(v, 1) == 0) and np.abs(v).sum() < 2.0**53)
        for fn, v in zip(fns, vals_np)
    ]


def k1_synthetic(device, n: int, k: int, fns: tuple, kinds: tuple, seed: int) -> dict:
    """k1_phase on seeded channels shaped like an aggregate's (`kinds`)."""
    import torch

    gid_np, vals_np = _k1_inputs(np.random.default_rng(seed), n, k, fns, kinds)
    gid = torch.from_numpy(gid_np).to(device)
    vals = torch.from_numpy(vals_np).to(device)
    return k1_phase(device, vals, gid, k, fns, _k1_exact(kinds, fns))


def k1_phase(device, vals, gid, k: int, fns: tuple, exact: list[bool]) -> dict:
    """K1 against its plain version on the card at one main-path shape
    (vals float64 [C, n], gid int32 [n] on the card): `exact` channels
    (integral sums, extrema with NaN and ±inf, counts) bit-equal, other
    sums within `sum_tolerance` (float64 atomics add in another order than
    index_add_). For few groups it also reports each non-integral sum's
    error against the exact (math.fsum) sum."""
    import math

    import torch

    from hyperspace_tpu_torch.ops.segment_reduce import (
        _sm_count, kernels_per_launch, reduce_plan, segment_reduce, segment_reduce_plain,
    )

    gid_np, vals_np = gid.cpu().numpy(), vals.cpu().numpy()
    n = len(gid_np)
    got = segment_reduce(vals, gid, k, fns).cpu().numpy()
    want = segment_reduce_plain(vals, gid, k, fns).cpu().numpy()
    rows = np.bincount(gid_np, minlength=k)
    rel_err = {}
    for c, is_exact in enumerate(exact):
        if is_exact:
            np.testing.assert_array_equal(got[c], want[c], err_msg=f"exact channel {c} ({fns[c]})")
            continue
        abs_sum = np.bincount(gid_np, weights=np.abs(vals_np[c]), minlength=k)
        if k <= 64:
            truth = np.array([math.fsum(vals_np[c][gid_np == g]) for g in range(k)])
            some = abs_sum > 0  # a group of zeros (the fold's dead group) has no relative error
            rel_err[c] = {
                "kernel": float(np.max(np.abs(got[c] - truth)[some] / abs_sum[some], initial=0.0)),
                "plain": float(np.max(np.abs(want[c] - truth)[some] / abs_sum[some], initial=0.0)),
            }
        if not np.all(np.abs(got[c] - want[c]) <= sum_tolerance(rows, abs_sum)):
            raise AssertionError(
                f"channel {c}: kernel and plain sums differ beyond the float64 summation bound "
                f"(relative errors against the exact sum: {rel_err.get(c)})"
            )
    both = ~(np.isnan(got) & np.isnan(want))
    with np.errstate(invalid="ignore"):
        diff = np.abs(got - want)[both]
    finite = diff[np.isfinite(diff)]
    max_abs_err = float(finite.max()) if len(finite) else 0.0

    c_num = len(fns)
    nbytes = n * 4 + c_num * n * 8 + c_num * k * 8
    flops = c_num * n
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = flops / FP64_FLOPS * 1e3
    ms = cuda_ms(lambda: segment_reduce(vals, gid, k, fns))
    plain_ms = cuda_ms(lambda: segment_reduce_plain(vals, gid, k, fns))

    # Library yardstick: torch's scatter_reduce, one call per reduce kind
    # (one call in all when every channel is a sum).
    idx = gid.long().expand(c_num, n)
    groups = {f: [c for c in range(c_num) if fns[c] == f] for f in ("sum", "min", "max")}
    groups = {f: cs for f, cs in groups.items() if cs}
    blocks = {f: (vals[cs].contiguous(), idx[: len(cs)]) for f, cs in groups.items()}
    ident = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}
    red = {"sum": "sum", "min": "amin", "max": "amax"}

    def library():
        for f, (v, ix) in blocks.items():
            torch.full((v.shape[0], k), ident[f], dtype=torch.float64, device=device).scatter_reduce_(
                1, ix, v, red[f], include_self=True
            )

    library_calls_ms = cuda_ms(library)
    regime = reduce_plan(c_num, k, n, _sm_count(torch.cuda.current_device()))[0]  # c_num <= 64 here
    return {
        "n": n, "k": k, "channels": c_num, "regime": regime, "kernels_per_call": kernels_per_launch(regime, fns),
        "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_calls_ms if len(blocks) == 1 else None,
        "library_calls": len(blocks), "library_calls_ms": library_calls_ms,
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "bytes": nbytes, "max_abs_err": max_abs_err, "rel_err_vs_exact": rel_err,
        "deterministic_channels": sum(exact),
        # One call, for device_ms_each.
        "call": lambda: segment_reduce(vals, gid, k, fns),
    }


# -- main path ----------------------------------------------------------------


def _pa_group(table, keys, aggs):
    """pyarrow's group-by, sorted by the keys — the independent reference."""
    out = table.group_by(keys).aggregate(aggs)
    return out.sort_by([(k, "ascending") for k in keys]).to_pandas()


def check_q1(got, source) -> None:
    import pyarrow.compute as pc

    src = source.append_column("abs_price", pc.abs(source["l_extendedprice"]))
    src = src.append_column("abs_disc", pc.abs(source["l_discount"]))
    ref = _pa_group(src, Q1_GROUP, [
        ("l_quantity", "sum"), ("l_extendedprice", "sum"), ("l_discount", "sum"),
        ("l_extendedprice", "min"), ("l_discount", "max"), ("l_orderkey", "count"),
        ("abs_price", "sum"), ("abs_disc", "sum"),
    ])
    got = got.sort_values(Q1_GROUP).reset_index(drop=True)
    if len(got) != len(ref) or len(got) == 0:
        raise AssertionError(f"Q1 groups: {len(got)} vs reference {len(ref)}")
    for c in Q1_GROUP:
        if list(got[c]) != list(ref[c]):
            raise AssertionError(f"Q1 group keys differ in {c}")
    np.testing.assert_array_equal(got["count_order"], ref["l_orderkey_count"])
    np.testing.assert_array_equal(got["sum_qty"], ref["l_quantity_sum"])
    np.testing.assert_array_equal(got["min_price"], ref["l_extendedprice_min"])
    np.testing.assert_array_equal(got["max_disc"], ref["l_discount_max"])
    cnt = ref["l_orderkey_count"].to_numpy()
    tol_price = sum_tolerance(cnt, ref["abs_price_sum"].to_numpy())
    if not np.all(np.abs(got["sum_price"] - ref["l_extendedprice_sum"]) <= tol_price):
        raise AssertionError("Q1 sum_price beyond the float64 summation bound")
    tol_disc = sum_tolerance(cnt, ref["abs_disc_sum"].to_numpy()) / cnt
    if not np.all(np.abs(got["avg_disc"] - ref["l_discount_sum"] / cnt) <= tol_disc):
        raise AssertionError("Q1 avg_disc beyond the float64 summation bound / count")


def check_revenue(got, source) -> None:
    import pyarrow.compute as pc

    src = source.append_column("abs_price", pc.abs(source["l_extendedprice"]))
    ref = _pa_group(src, ["l_orderkey"], [
        ("l_extendedprice", "sum"), ("abs_price", "sum"), ("l_orderkey", "count"),
    ])
    got = got.sort_values("l_orderkey").reset_index(drop=True)
    if len(got) != len(ref) or len(got) == 0:
        raise AssertionError(f"revenue groups: {len(got)} vs reference {len(ref)}")
    np.testing.assert_array_equal(got["l_orderkey"], ref["l_orderkey"])
    tol = sum_tolerance(ref["l_orderkey_count"].to_numpy(), ref["abs_price_sum"].to_numpy())
    if not np.all(np.abs(got["rev"] - ref["l_extendedprice_sum"]) <= tol):
        raise AssertionError("revenue beyond the float64 summation bound")


def _profiled_kernels(fn, twice: bool = False) -> tuple[list, float]:
    """Runs `fn` under torch.profiler and returns (start, us, name) of
    every device activity it recorded, in start order, and the wall
    milliseconds of `fn` (the profiler's own start and stop left out).
    With `twice`, `fn` runs two times and only the second run is kept:
    the profiler can miss kernels launched soon after it starts, which a
    call with little host work before its first kernel does."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    card = torch.cuda.is_available()  # a CPU rehearsal has no card to wait for

    def run():
        t0 = time.perf_counter()
        fn()
        if card:
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if twice:
            run()
            with record_function("chip_smoke_kept_run"):
                wall_ms = run()
        else:
            wall_ms = run()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    start = 0
    if twice:  # the kept run's range on the host; its copy on the card's timeline spans its kernels
        start = min(e.time_range.start for e in events if e.name == "chip_smoke_kept_run" and e.device_type != cuda)
    kernels = sorted(
        (e.time_range.start, e.time_range.elapsed_us(), e.name)
        for e in events
        if e.device_type == cuda and e.time_range.start >= start and e.name != "chip_smoke_kept_run"
    )
    return kernels, wall_ms


def device_time(fn, prefixes: tuple) -> dict:
    """Runs `fn` twice under torch.profiler and sums over the second run,
    per name prefix, the device time (and count) of the kernels whose
    names hold it, and the time of all device work; `kernel_ms_each`
    lists each such kernel's time in the order they started. The times
    are None when the profiler recorded no device activity, which only a
    CPU rehearsal may do: on the card, a profile without device activity
    or without a kernel of every prefix fails the run."""
    import torch

    kernels, wall_ms = _profiled_kernels(fn, twice=True)
    each = {p: [us for _, us, name in kernels if p in name] for p in prefixes}
    matched = {p: len(each[p]) for p in prefixes}
    if torch.cuda.is_available() and not (kernels and all(matched.values())):
        raise AssertionError(f"the profiler saw {len(kernels)} device activities; kernels by prefix: {matched}")
    if not kernels:
        return {"kernel_ms": dict.fromkeys(prefixes), "kernel_ms_each": dict.fromkeys(prefixes),
                "device_busy_ms": None, "profiled_wall_ms": wall_ms, "kernels": matched}
    return {
        "kernel_ms": {p: sum(each[p]) / 1e3 for p in prefixes},
        "kernel_ms_each": {p: [us / 1e3 for us in each[p]] for p in prefixes},
        "device_busy_ms": sum(us for _, us, _ in kernels) / 1e3, "profiled_wall_ms": wall_ms, "kernels": matched,
    }


def device_ms_each(calls: dict) -> dict:
    """Each call's kernels alone on the card. `calls` maps a key to (the
    call, its kernel count, the prefix its kernels' names hold). Every
    call runs once, in order, and then the whole sequence once more,
    inside ONE torch.profiler window for all of them (the profiler hands
    back no device events after some sessions in one process, and can
    miss kernels launched soon after it starts); for each prefix, the last
    pass's kernels whose names hold it are dealt to its calls in start
    order by each call's kernel count. Returns key -> ms."""
    import torch

    def run_all():
        for _ in range(2):
            for fn, _, _ in calls.values():
                fn()
                torch.cuda.synchronize()

    profiled = _profiled_kernels(run_all)[0]
    out = {}
    for prefix in dict.fromkeys(p for _, _, p in calls.values()):
        mine = {key: count for key, (_, count, p) in calls.items() if p == prefix}
        kernels = [(us, name) for _, us, name in profiled if prefix in name]
        want = sum(mine.values())
        last = kernels[-want:]
        if len(kernels) < want or (len(kernels) == 2 * want and [n for _, n in kernels[:want]] != [n for _, n in last]):
            names = [name[:70] for _, name in kernels]
            raise AssertionError(
                f"the profiler saw {len(kernels)} kernels named {prefix}*, two passes launch {2 * want}: {names}"
            )
        at = 0
        for key, count in mine.items():
            out[key] = sum(us for us, _ in last[at : at + count]) / 1e3
            at += count
    return out


def cache_stats() -> dict:
    """The two caches' budgets, resident bytes, entries, hits, misses and
    evictions; fails if either holds more bytes than its budget."""
    from hyperspace_tpu_torch.execution import device_cache as dc

    out = {}
    for name, cache in (("device_cache", dc.DEVICE_CACHE), ("host_derived", dc.HOST_DERIVED)):
        st = cache.stats()
        if st["bytes"] > st["budget"]:
            raise AssertionError(f"{name} holds {st['bytes']} bytes, over its budget of {st['budget']}")
        out[name] = {k: st[k] for k in ("budget", "bytes", "entries", "hits", "misses", "evictions")}
    return out


def same_result(name: str, a, b, tolerant=()) -> None:
    """Two results of one query (ColumnTables on one device): the same
    schema, rows and validity, every column bit-equal but the `tolerant`
    ones (non-integral sums and means, whose last bits vary with K1's
    float64 atomics; the path's pyarrow check bounds each run's)."""
    import torch

    if a.schema.names != b.schema.names or a.num_rows != b.num_rows:
        raise AssertionError(f"{name}: the warm run gave {b.num_rows} rows of {b.schema.names}, "
                             f"the cold {a.num_rows} of {a.schema.names}")
    for f in a.schema.fields:
        if f.name in tolerant:
            continue
        if not torch.equal(a.columns[f.name], b.columns[f.name]):
            raise AssertionError(f"{name}: the warm run differs from the cold in {f.name}")
        va, vb = a.validity.get(f.name), b.validity.get(f.name)
        if (va is None) != (vb is None) or (va is not None and not torch.equal(va, vb)):
            raise AssertionError(f"{name}: the warm run's nulls differ from the cold's in {f.name}")
        if not np.array_equal(a.dictionaries.get(f.name, []), b.dictionaries.get(f.name, [])):
            raise AssertionError(f"{name}: the warm run's dictionary differs in {f.name}")


def cold_warm(name: str, session, plans: list, cache, sync, derived=(), tolerant=()) -> tuple[list, list, dict]:
    """Runs `plans` once cold and once warm through `run_query` and the
    PlanCache `cache`. The warm pass must hit the plan cache on every
    plan (where hyperspace is enabled), hit HOST_DERIVED on every kind in
    `derived` and miss none of them, read no file, and give the cold
    pass's results, bit-equal but in the `tolerant` columns. Returns (the
    warm results, the cold results, the cold and warm walls with the warm
    pass's host time by step: plan, read, derive, and the rest up to the
    synchronized wall)."""
    from hyperspace_tpu_torch.execution import device_cache as dc

    def run_all():
        out, host = [], dict.fromkeys(("plan", "read", "derive"), 0.0)
        t0 = time.perf_counter()
        for plan in plans:
            outcome = session.run_query(plan, plan_cache=cache)
            for step in host:
                host[step] += outcome.stats["host_s"][step]
            out.append(outcome)
        sync()
        return out, time.perf_counter() - t0, host

    cold, cold_s, _ = run_all()
    p0, d0, r0 = cache.stats(), dc.HOST_DERIVED.stats()["by_kind"], dc.DEVICE_CACHE.stats()
    warm, warm_s, host = run_all()
    p1, d1, r1 = cache.stats(), dc.HOST_DERIVED.stats()["by_kind"], dc.DEVICE_CACHE.stats()
    if session.is_hyperspace_enabled() and p1["hits"] - p0["hits"] != len(plans):
        raise AssertionError(f"{name}: {p1['hits'] - p0['hits']} of {len(plans)} warm plans hit the plan cache")
    for kind in derived:
        hits = d1.get(kind, {}).get("hits", 0) - d0.get(kind, {}).get("hits", 0)
        misses = d1.get(kind, {}).get("misses", 0) - d0.get(kind, {}).get("misses", 0)
        if hits < len(plans) or misses:
            raise AssertionError(f"{name}: the warm pass hit HOST_DERIVED {hits} times and missed {misses} on {kind}")
    read = sum(o.stats["files_read"] for o in warm)
    if read:
        raise AssertionError(f"{name}: the warm pass read {read} files")
    for c, w in zip(cold, warm):
        same_result(name, c.result, w.result, tolerant)
    split = {**host, "rest": warm_s - sum(host.values())}
    return [o.result for o in warm], [o.result for o in cold], {
        "cold_s": cold_s, "warm_s": warm_s, "warm_host_s": split,
        "plan_cache": "hit" if session.is_hyperspace_enabled() else "not used (hyperspace off)",
        "device_cache_hits": r1["hits"] - r0["hits"], "device_cache_misses": r1["misses"] - r0["misses"],
        "derived_hits": sum(v["hits"] for v in d1.values()) - sum(v["hits"] for v in d0.values()),
        "derived_misses": sum(v["misses"] for v in d1.values()) - sum(v["misses"] for v in d0.values()),
        "warm_stats": {k: warm[-1].stats.get(k) for k in ("scan", "files_read", "files_pruned", "rows_pruned",
                                                         "range_exact", "agg_path", "agg_devices", "join_path",
                                                         "join_paths", "join_kernel", "join_devices",
                                                         "exchange_kernel", "top_n", "limit_early_out",
                                                         "mask_kernel", "sort_op")},
    }


def main_path(device, sf: float, seed: int, workdir: Path, num_buckets: int = 200) -> tuple[dict, dict]:
    """The port's aggregate path through its user entry points; returns
    (the phase wall times and row counts, what the join path reuses: the
    session, the lineitem scan, its pyarrow source and the work
    directory)."""
    import pandas as pd
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    import torch

    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig, PlanCache, col
    from hyperspace_tpu_torch.datagen import TPCH_SF1_ORDERS_ROWS, gen_tpch_lineitem
    from hyperspace_tpu_torch.ops import aggregate

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    phases: dict = {}
    t0 = time.perf_counter()
    data = workdir / "lineitem"
    gen_tpch_lineitem(data, sf=sf, seed=seed)
    phases["datagen_s"] = time.perf_counter() - t0

    session = HyperspaceSession(system_path=str(workdir / "indexes"), num_buckets=num_buckets, device=device)
    hs = Hyperspace(session)
    df = session.parquet(data)
    t0 = time.perf_counter()
    hs.create_index(df, IndexConfig("lineitem_orderkey", INDEXED, INCLUDED))
    sync()
    phases["build_s"] = time.perf_counter() - t0
    phases["build_phases_s"] = session.last_build_stats["phases_s"]
    rows = session.last_build_stats["rows"]

    keys = np.random.default_rng(7).integers(0, int(TPCH_SF1_ORDERS_ROWS * sf), 12).astype(np.int64)
    lookup_plans = [df.filter(col("l_orderkey") == int(k)).select("l_orderkey", "l_partkey", "l_extendedprice")
                    for k in keys]
    # One plan cache for every query of the run, as a server keeps one.
    plan_cache = PlanCache()
    counts = {}
    for mode in ("index", "no_index"):
        session.enable_hyperspace() if mode == "index" else session.disable_hyperspace()
        got, _, phases[f"lookups_{mode}"] = cold_warm(f"lookups {mode}", session, lookup_plans, plan_cache, sync)
        counts[mode] = [g.num_rows for g in got]
        stats = phases[f"lookups_{mode}"]["warm_stats"]
        # The rule rewrite alone (signature, index listing, manifest): the
        # host's share of each lookup without the plan cache.
        t0 = time.perf_counter()
        for k in keys:
            session.optimized_plan(df.filter(col("l_orderkey") == int(k)).select("l_orderkey"))
        phases[f"lookups_{mode}_plan_s"] = time.perf_counter() - t0
        if mode == "index" and (stats["scan"] != "IndexPointLookup" or stats["files_pruned"] != num_buckets - 1):
            raise AssertionError(f"the filter rule did not prune to one bucket: {stats}")
    if counts["index"] != counts["no_index"] or sum(counts["index"]) == 0:
        raise AssertionError(f"lookup rows differ or are empty: {counts}")
    files = sorted(str(p) for p in data.glob("*.parquet"))
    source = pq.read_table(files)
    want_rows = int(pc.sum(pc.is_in(source["l_orderkey"], value_set=pa.array(keys))).as_py())
    if sum(counts["index"]) != want_rows:
        raise AssertionError(f"lookups found {sum(counts['index'])} rows, the source holds {want_rows}")
    phases["caches_after_lookups"] = cache_stats()

    session.enable_hyperspace()
    k1_inputs = {}
    for name, plan, check, tolerant in (
        ("q1", df.aggregate(Q1_GROUP, Q1_AGGS), check_q1, ("sum_price", "avg_disc")),
        ("revenue", df.aggregate(["l_orderkey"], [("sum", "l_extendedprice", "rev")]), check_revenue, ("rev",)),
    ):
        # Cold (reads the columns onto the device, derives the group ids),
        # then warm: the group ids must come from HOST_DERIVED.
        (result,), _, phases[f"agg_{name}"] = cold_warm(name, session, [plan], plan_cache, sync, ("gid",), tolerant)
        phases[f"agg_{name}_s"] = phases[f"agg_{name}"]["warm_s"]
        check(pd.DataFrame(result.decode()), source)
        phases[f"agg_{name}_groups"] = result.num_rows
        # K1's device time inside the warm query (the kernels of
        # segment_reduce.cu are all named segment_reduce_*).
        phases[f"agg_{name}_profiled"] = device_time(
            lambda: session.run_query(plan, plan_cache=plan_cache), ("segment_reduce_",)
        )
        # K1's inputs as the query gives them, from one more run.
        calls = capture_k1(lambda: session.run(plan), aggregate)
        if len(calls) != 1:
            raise AssertionError(f"{name}: expected one K1 call, got {len(calls)}")
        k1_inputs[f"{name} (path ids)"] = calls[0]
    phases["caches_after_aggregates"] = cache_stats()
    phases["range"] = range_queries(session, df, source, plan_cache, sync, sf)
    phases["caches_after_range"] = cache_stats()
    result = {"rows": rows, "lookup_rows": sum(counts["index"]), "phases": phases}
    return result, {"session": session, "lineitem": df, "source": source, "workdir": workdir,
                    "k1_inputs": k1_inputs, "plan_cache": plan_cache}


def range_queries(session, df, source, plan_cache, sync, sf: float) -> dict:
    """Range predicates on the lineitem index's sorted key, index on and
    off, each checked against pyarrow on the same parquet: l_orderkey
    between two literals 1% of the key domain apart, a strict open range
    over the domain's top 1%, and the computed projection
    l_extendedprice * (1 - l_discount) over the first range. Records the
    files read and pruned, the rows pruned and whether the slice was the
    predicate (the mask skipped)."""
    import pyarrow as pa
    import pyarrow.compute as pc

    from hyperspace_tpu_torch import col, lit
    from hyperspace_tpu_torch.datagen import TPCH_SF1_ORDERS_ROWS

    domain = int(TPCH_SF1_ORDERS_ROWS * sf)
    lo, hi = int(domain * 0.47), int(domain * 0.48)
    top = int(domain * 0.99)
    cols = ["l_orderkey", "l_partkey", "l_extendedprice"]
    between = (col("l_orderkey") >= lit(lo)) & (col("l_orderkey") <= lit(hi))
    queries = {
        "between": (df.filter(between).select(*cols),
                    pc.and_(pc.greater_equal(source["l_orderkey"], lo), pc.less_equal(source["l_orderkey"], hi))),
        "open_strict": (df.filter(col("l_orderkey") > lit(top)).select(*cols), pc.greater(source["l_orderkey"], top)),
        "projection": (df.filter(between).select(
            "l_orderkey", ("disc_price", col("l_extendedprice") * (lit(1) - col("l_discount")))),
            pc.and_(pc.greater_equal(source["l_orderkey"], lo), pc.less_equal(source["l_orderkey"], hi))),
    }
    out = {"bounds": {"between": [lo, hi], "open_strict_above": top}}
    # What the device cache's mtime check costs: one os.stat a bucket file.
    files = sorted(Path(session.conf.system_path).glob("lineitem_orderkey/*/bucket-*.parquet"))
    t0 = time.perf_counter()
    for f in files:
        os.stat(f)
    out["stat_bucket_files"] = {"files": len(files), "s": time.perf_counter() - t0}
    for mode in ("index", "no_index"):
        session.enable_hyperspace() if mode == "index" else session.disable_hyperspace()
        for name, (plan, mask) in queries.items():
            (result,), _, timing = cold_warm(f"range {name} {mode}", session, [plan], plan_cache, sync)
            want = source.filter(mask)
            if name == "projection":
                want = pa.table({"l_orderkey": want["l_orderkey"], "disc_price": pc.multiply(
                    want["l_extendedprice"], pc.subtract(1, want["l_discount"]))})
            else:
                want = want.select(cols)
            got = result.decode()
            order = np.lexsort([got[c] for c in reversed(want.column_names)])
            ref = want.sort_by([(c, "ascending") for c in want.column_names])
            if result.num_rows != want.num_rows or result.num_rows == 0:
                raise AssertionError(f"range {name} {mode}: {result.num_rows} rows, pyarrow {want.num_rows}")
            for c in want.column_names:
                if not np.array_equal(got[c][order], ref[c].to_numpy()):
                    raise AssertionError(f"range {name} {mode}: column {c} differs from pyarrow")
            stats = timing["warm_stats"]
            if mode == "index" and (stats["scan"] != "IndexRangeScan" or stats["rows_pruned"] == 0):
                raise AssertionError(f"range {name}: the index scan did not slice: {stats}")
            out[f"{name}_{mode}"] = {"rows": result.num_rows, **timing}
    session.enable_hyperspace()
    return out


# -- join path ----------------------------------------------------------------


def join_sum_tolerance(count, max_abs, buckets: int, ls=None, bucket_abs_sum=None):
    """How far two float64 sums over an inner join's groups may differ
    (tests/test_torch_join_agg.py derives it; γ_n = 1.01·n·u): a group of
    `count` pairs folds at most `count` terms (plus one partial per
    bucket) whose |w| sum to at most count·max|v|, and a term over the
    secondary side (`ls` given) is a difference of per-bucket prefix sums,
    each within γ_Ls·Σ_bucket|v| of exact. Twice one side's error covers
    both."""
    count = np.asarray(count, dtype=np.float64)
    gamma = 1.01 * UNIT_ROUNDOFF
    tol = gamma * (count + buckets) * count * max_abs
    if ls is not None:
        tol = tol + 2 * count * gamma * ls * bucket_abs_sum
    return 2 * tol


def _index_buckets(system_path: Path, name: str, columns: list[str]) -> list:
    """The index's bucket files in bucket order, as pyarrow tables."""
    import pyarrow.parquet as pq

    files = sorted((system_path / name).rglob("bucket-*.parquet"))
    return [pq.ParquetFile(f).read(columns=columns) for f in files]


def _bucket_stats(buckets, column: str) -> dict:
    """Widest bucket and largest per-bucket Σ|v| of a column (aligned
    path), and the side's row count, Σ|v| and max|v| (one partition)."""
    import pyarrow.compute as pc

    rows = [t.num_rows for t in buckets]
    abs_sums = [pc.sum(pc.abs(t[column])).as_py() or 0.0 for t in buckets]
    return {
        "widest": max(rows), "max_bucket_abs_sum": max(abs_sums),
        "rows": sum(rows), "abs_sum": sum(abs_sums),
        "max_abs": max(pc.max(pc.abs(t[column])).as_py() or 0.0 for t in buckets),
    }


def _check_join_aggregate(name, got, ref, keys, exact, tolerant, stats, aligned, buckets):
    """got (pandas) against pyarrow's group-by of the joined table: keys,
    counts, integral sums and extrema exactly; the `tolerant` sums (alias
    → (reference column, side "p"/"s", is a mean)) within
    join_sum_tolerance."""
    got = got.sort_values(keys).reset_index(drop=True)
    ref = ref.sort_values(keys).reset_index(drop=True)
    if len(got) != len(ref) or len(got) == 0:
        raise AssertionError(f"{name} groups: {len(got)} vs reference {len(ref)}")
    for c in keys:
        if list(got[c]) != list(ref[c]):
            raise AssertionError(f"{name} group keys differ in {c}")
    for alias, ref_col in exact.items():
        np.testing.assert_array_equal(got[alias].to_numpy(), ref[ref_col].to_numpy(), err_msg=f"{name} {alias}")
    count = ref["l_orderkey_count"].to_numpy()
    for alias, (ref_col, side, is_mean) in tolerant.items():
        st = stats[ref_col.rsplit("_", 1)[0]]
        if side == "s":
            ls = st["widest"] if aligned else st["rows"]
            sb = st["max_bucket_abs_sum"] if aligned else st["abs_sum"]
            tol = join_sum_tolerance(count, st["max_abs"], buckets, ls, sb)
        else:
            tol = join_sum_tolerance(count, st["max_abs"], buckets)
        want = ref[ref_col].to_numpy()
        if is_mean:
            tol, want = tol / count, want / count
        diff = np.abs(got[alias].to_numpy() - want)
        if not np.all(diff <= tol):
            raise AssertionError(f"{name} {alias} beyond the float64 join bound ({diff.max()} > {tol.min()})")


def join_path(device, ctx: dict, sf: float) -> tuple[dict, dict]:
    """The port's join path through its user entry points, on the lineitem
    index of the aggregate path. Returns (the phase wall times with the
    row and group counts, the K2 inputs at the path's shapes: real key
    codes, for the kernel phase)."""
    import pandas as pd
    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    import torch

    from hyperspace_tpu_torch import Hyperspace, IndexConfig
    from hyperspace_tpu_torch.datagen import gen_tpch_orders
    from hyperspace_tpu_torch.ops import join_agg
    from hyperspace_tpu_torch.ops.segment_reduce import segment_reduce
    from hyperspace_tpu_torch.ops.sortkeys import run_bounds

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    session, li, workdir = ctx["session"], ctx["lineitem"], ctx["workdir"]
    num_buckets = session.conf.num_buckets
    phases: dict = {}
    t0 = time.perf_counter()
    gen_tpch_orders(workdir / "orders", sf=sf, seed=43)
    phases["orders_datagen_s"] = time.perf_counter() - t0
    orders = session.parquet(workdir / "orders")
    t0 = time.perf_counter()
    Hyperspace(session).create_index(orders, IndexConfig("orders_orderkey", O_INDEXED, O_INCLUDED))
    sync()
    phases["orders_build_s"] = time.perf_counter() - t0
    phases["orders_build_phases_s"] = session.last_build_stats["phases_s"]

    j = li.select("l_orderkey", "l_quantity", "l_extendedprice", "l_discount").join(
        orders.select("o_orderkey", "o_totalprice", "o_orderpriority"), ["l_orderkey"], ["o_orderkey"]
    )
    queries = {
        "J1": li.select("l_orderkey", "l_extendedprice").join(
            orders.select("o_orderkey", "o_totalprice", "o_orderpriority"), ["l_orderkey"], ["o_orderkey"]
        ),
        "J2": j.aggregate(["o_orderpriority"], J2_AGGS),
        "J3": j.aggregate(["l_quantity"], J3_AGGS),
    }

    # The independent reference: pyarrow's join and group-by of the parquet.
    o_source = pq.read_table(sorted(str(p) for p in (workdir / "orders").glob("*.parquet")))
    ref = ctx["source"].select(["l_orderkey", "l_quantity", "l_extendedprice", "l_discount"]).join(
        o_source.select(["o_orderkey", "o_totalprice", "o_orderpriority"]),
        keys="l_orderkey", right_keys="o_orderkey", join_type="inner",
    )
    ref_j2 = ref.group_by(["o_orderpriority"]).aggregate([
        ("l_extendedprice", "sum"), ("l_quantity", "sum"), ("l_discount", "min"),
        ("l_extendedprice", "max"), ("o_totalprice", "sum"), ("l_orderkey", "count"),
    ]).to_pandas()
    ref_j3 = ref.group_by(["l_quantity"]).aggregate([
        ("o_totalprice", "sum"), ("o_totalprice", "max"), ("l_extendedprice", "sum"), ("l_orderkey", "count"),
    ]).to_pandas()

    # J1's pairs, sorted: o_orderkey is unique, so each pair's o_totalprice
    # is its order's, and any mispairing shows in the sorted columns.
    j1_cols = ["l_orderkey", "l_extendedprice", "o_totalprice"]
    ref_j1 = ref.select(j1_cols).sort_by([(c, "ascending") for c in j1_cols])
    ref_j1 = [ref_j1[c].to_numpy() for c in j1_cols]

    # What phase 3v holds its host venue's answers to.
    ctx["venue_refs"] = {"J1": ref_j1, "J2": ref_j2}
    li_buckets = _index_buckets(Path(session.conf.system_path), "lineitem_orderkey", ["l_orderkey", "l_extendedprice"])
    o_buckets = _index_buckets(Path(session.conf.system_path), "orders_orderkey", ["o_orderkey", "o_totalprice"])
    stats = {"l_extendedprice": _bucket_stats(li_buckets, "l_extendedprice"),
             "o_totalprice": _bucket_stats(o_buckets, "o_totalprice")}
    # What the join-types and serving paths reuse.
    ctx.update(orders=orders, o_source=o_source, bucket_stats=stats, join_queries=queries)

    def check(name, result, aligned):
        buckets = num_buckets if aligned else 1
        if name == "J1":
            n = result.num_rows
            if n != ref.num_rows or n == 0:
                raise AssertionError(f"J1 rows: {n} vs reference {ref.num_rows}")
            # Every pair, exactly: sorted on the device by the three columns.
            cols = [result.column(c) for c in j1_cols]
            perm = torch.arange(n, device=cols[0].device)
            for c in reversed(cols):
                perm = perm[torch.sort(c[perm], stable=True).indices]
            for c, got, want in zip(j1_cols, cols, ref_j1):
                if not np.array_equal(got[perm].cpu().numpy(), want):
                    raise AssertionError(f"J1 pairs differ from the reference in {c}")
            return
        got = pd.DataFrame(result.decode())
        if name == "J2":
            _check_join_aggregate(
                name, got, ref_j2, ["o_orderpriority"],
                {"sum_qty": "l_quantity_sum", "min_disc": "l_discount_min",
                 "max_price": "l_extendedprice_max", "cnt": "l_orderkey_count"},
                {"sum_price": ("l_extendedprice_sum", "s", False), "avg_total": ("o_totalprice_sum", "p", True)},
                stats, aligned, buckets,
            )
        else:
            _check_join_aggregate(
                name, got, ref_j3, ["l_quantity"],
                {"max_total": "o_totalprice_max", "cnt": "l_orderkey_count"},
                {"sum_total": ("o_totalprice_sum", "s", False), "sum_price": ("l_extendedprice_sum", "p", False)},
                stats, aligned, buckets,
            )

    counts: dict = {}
    tolerant = {"J1": (), "J2": ("sum_price", "avg_total"), "J3": ("sum_total", "sum_price")}
    for mode in ("index", "no_index"):
        session.enable_hyperspace() if mode == "index" else session.disable_hyperspace()
        for name, plan in queries.items():
            # Without the index, J1's lineitem (6,001,991 rows at SF1) is at
            # least 4x orders (1.5M): the JAX package's broadcast probe. The
            # fused J2 and J3 never broadcast.
            want_path = ("zero-exchange-aligned" if mode == "index"
                         else "broadcast-hash" if name == "J1" else "single-partition")
            k2, k1 = run_bounds.launches, segment_reduce.launches
            # Cold (reads the index or source columns onto the device, derives
            # the key codes and group ids), then warm: the join codes, and a
            # fused aggregate's group ids, must come from HOST_DERIVED.
            derived = ("fact",) if name == "J1" else ("fact", "gid")
            (result,), _, timing = cold_warm(f"{name} {mode}", session, [plan], ctx["plan_cache"], sync, derived,
                                          tolerant[name])
            phases[f"{name}_{mode}"] = timing
            phases[f"{name}_{mode}_cold_s"], phases[f"{name}_{mode}_s"] = timing["cold_s"], timing["warm_s"]
            stats_q = timing["warm_stats"]
            if stats_q["join_path"] != want_path:
                raise AssertionError(f"{name} {mode}: join path {stats_q['join_path']}, expected {want_path}")
            if name != "J1" and stats_q["agg_path"] != "fused-join-agg":
                raise AssertionError(f"{name} {mode}: aggregate path {stats_q['agg_path']}, expected fused-join-agg")
            # On the card every merge join launches K2 and every fused
            # aggregate K1 (a CPU rehearsal runs their plain versions).
            if device.type == "cuda" and want_path != "broadcast-hash" and run_bounds.launches == k2:
                raise AssertionError(f"{name} {mode}: K2 never launched")
            if device.type == "cuda" and name != "J1" and segment_reduce.launches == k1:
                raise AssertionError(f"{name} {mode}: K1 never launched")
            check(name, result, mode == "index")
            counts[f"{name}_{mode}"] = result.num_rows
        phases[f"caches_after_{mode}"] = cache_stats()
    for name, mode in (("J2", "index"), ("J3", "index"), ("J2", "no_index")):
        session.enable_hyperspace() if mode == "index" else session.disable_hyperspace()
        label = f"{name}_profiled" if mode == "index" else f"{name}_{mode}_profiled"
        # Warm: one run first rebuilds what HOST_DERIVED evicted since the
        # query's own warm run (J2's and J3's derivations pass its budget).
        session.run_query(queries[name], plan_cache=ctx["plan_cache"])
        phases[label] = device_time(
            lambda: session.run_query(queries[name], plan_cache=ctx["plan_cache"]), ("run_bounds_", "segment_reduce_")
        )
    session.enable_hyperspace()
    # K1's inputs at the fused aggregates' shapes, from one more indexed run
    # of each: the secondary run extrema, then the group fold.
    k1_inputs = {}
    for name in ("J2", "J3"):
        calls = capture_k1(lambda: session.run(queries[name]), join_agg)
        if len(calls) != 2:
            raise AssertionError(f"{name}: expected K1 calls for the run extrema and the fold, got {len(calls)}")
        k1_inputs[f"{name} run extrema"], k1_inputs[f"{name} fold"] = calls

    # K2's inputs at the path's shapes, from the indexes' real keys: codes
    # are the keys shifted by their minimum (the factorization's fast
    # path), each bucket sorted, pads at the int32 max.
    lo = min(min(pc.min(t["l_orderkey"]).as_py() for t in li_buckets if t.num_rows),
             min(pc.min(t["o_orderkey"]).as_py() for t in o_buckets if t.num_rows))

    def padded(buckets, column):
        rows = [t[column].to_numpy().astype(np.int64) - lo for t in buckets]
        out = np.full((len(rows), max(len(r) for r in rows)), np.iinfo(np.int32).max, np.int32)
        for b, r in enumerate(rows):
            out[b, : len(r)] = r
        return out

    li_pad, o_pad = padded(li_buckets, "l_orderkey"), padded(o_buckets, "o_orderkey")
    li_all = np.sort(np.concatenate([t["l_orderkey"].to_numpy() for t in li_buckets]) - lo).astype(np.int32)[None]
    o_all = np.sort(np.concatenate([t["o_orderkey"].to_numpy() for t in o_buckets]) - lo).astype(np.int32)[None]
    k2_inputs = {"J2 aligned": (o_pad, li_pad), "J3 aligned": (li_pad, o_pad), "J2 no index": (o_all, li_all)}
    return {"groups": {"J2": len(ref_j2), "J3": len(ref_j3)}, "rows": counts, "phases": phases}, k1_inputs, k2_inputs


# -- mesh path ------------------------------------------------------------------

MESH_SHARDS = 4  # virtual shards of the one card


def _only_version(index_dir: Path) -> Path:
    dirs = sorted(index_dir.glob("v__=*"))
    if len(dirs) != 1:
        raise AssertionError(f"{index_dir.name}: {len(dirs)} version dirs, expected one")
    return dirs[0]


def same_device_rows(name: str, a, b, keys: list) -> None:
    """Two results (ColumnTables on one device) with the same rows as
    multisets: each sorted on the device by `keys`, every column, null
    mask and dictionary equal."""
    import torch

    def perm(t):
        p = torch.arange(t.num_rows, device=t.device)
        for c in reversed(keys):
            p = p[torch.sort(t.column(c)[p], stable=True).indices]
        return p

    if a.schema.names != b.schema.names or a.num_rows != b.num_rows or a.num_rows == 0:
        raise AssertionError(f"{name}: {a.num_rows} rows of {a.schema.names}, the one device's "
                             f"{b.num_rows} of {b.schema.names}")
    pa_, pb = perm(a), perm(b)
    for f in a.schema.fields:
        if not torch.equal(a.columns[f.name][pa_], b.columns[f.name][pb]):
            raise AssertionError(f"{name}: column {f.name} differs from the one device's")
        va, vb = a.validity.get(f.name), b.validity.get(f.name)
        if (va is None) != (vb is None) or (va is not None and not torch.equal(va[pa_], vb[pb])):
            raise AssertionError(f"{name}: the nulls of {f.name} differ from the one device's")
        if not np.array_equal(a.dictionaries.get(f.name, []), b.dictionaries.get(f.name, [])):
            raise AssertionError(f"{name}: the dictionary of {f.name} differs from the one device's")


def mesh_path(device, ctx: dict, sf: float, one_device_builds: dict) -> dict:
    """Phase 3a' (`mesh_path`): the device mesh through the user entry
    points, `HyperspaceSession(mesh=make_mesh([card] * 4))`: four virtual
    shards of the one card, on the aggregate and join paths' SF1 lineitem
    and orders. (a) Config 1's lineitem index (200 buckets) and config 2's
    orders index built over the mesh, and orders again over the (2, 2)
    multi-slice mesh: every file of each version dir byte-identical to the
    one-device build's. (b) Q1 and revenue cold and warm: agg_devices 4 and
    4 K1 launches a run, equal to the one-device session's (sums within
    2·N·u) and to pyarrow. (c) J1 indexed: join_devices 4 and 4 K2
    launches a run, its pairs the one-device J1's. (d) The 1% range, index
    on and off, exact against pyarrow; unindexed through the shard masks
    (6.0M rows pad to 2^23, so 3 of the 4 shards hold rows). (e) ORDER BY
    l_extendedprice DESC LIMIT 100 and Q3 (customer generated here, seed
    45): the top-N is mesh-sharded-select, the answers the one-device
    session's. Each mesh build follows a one-device build of its config in
    the phase, and every query also runs cold and warm on the one-device
    session, so the walls stand side by side; `one_device_builds` holds
    the earlier paths' (first) build walls. The phase's indexes are
    deleted at the end. Returns the record."""
    import shutil

    import pandas as pd
    import pyarrow.compute as pc
    import torch

    import hyperspace_tpu_torch as htorch
    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig, PlanCache, col, lit
    from hyperspace_tpu_torch.datagen import TPCH_SF1_ORDERS_ROWS, gen_tpch_customer
    from hyperspace_tpu_torch.ops import filter as filter_ops
    from hyperspace_tpu_torch.ops.segment_reduce import segment_reduce
    from hyperspace_tpu_torch.ops.sortkeys import run_bounds
    from hyperspace_tpu_torch.parallel.mesh import make_mesh, make_multislice_mesh, row_ranges

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    one, workdir, source = ctx["session"], ctx["workdir"], ctx["source"]
    one_root = Path(one.conf.system_path)
    num_buckets = one.conf.num_buckets
    shards = [device] * MESH_SHARDS
    dirs = [workdir / "mesh_indexes", workdir / "multislice_indexes", workdir / "mesh_customer",
            workdir / "one_device_rebuild"]
    out: dict = {"shards": MESH_SHARDS, "num_buckets": num_buckets}
    try:
        # (a) The builds, each against the one-device index of its config.
        session = HyperspaceSession(system_path=str(dirs[0]), num_buckets=num_buckets, mesh=make_mesh(shards))
        multi = HyperspaceSession(system_path=str(dirs[1]), num_buckets=num_buckets,
                                  mesh=make_multislice_mesh(2, shards))
        rebuild = HyperspaceSession(system_path=str(dirs[3]), num_buckets=num_buckets, device=device)
        builds = {}
        for label, s, name, data, config in (
            ("lineitem", session, "lineitem_orderkey", "lineitem", (INDEXED, INCLUDED)),
            ("orders", session, "orders_orderkey", "orders", (O_INDEXED, O_INCLUDED)),
            ("orders_multislice", multi, "orders_orderkey", "orders", (O_INDEXED, O_INCLUDED)),
        ):
            one_s = None
            if s is session:
                # The one-device build again, just before the mesh's, for a
                # wall taken as warm as the mesh's (the earlier path's was
                # the card's and the files' first).
                t0 = time.perf_counter()
                Hyperspace(rebuild).create_index(rebuild.parquet(workdir / data), IndexConfig(name, *config))
                sync()
                one_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            Hyperspace(s).create_index(s.parquet(workdir / data), IndexConfig(name, *config))
            sync()
            wall = time.perf_counter() - t0
            st = s.last_build_stats
            if st["path"] != "in-memory" or st["mesh_devices"] != MESH_SHARDS:
                raise AssertionError(f"mesh build {label}: path {st['path']} over {st['mesh_devices']} shards")
            ref, got = _only_version(one_root / name), _only_version(Path(s.conf.system_path) / name)
            if ref.name != got.name:
                raise AssertionError(f"mesh build {label}: version dir {got.name}, the one device's {ref.name}")
            builds[label] = {"s": wall, "one_device_s": one_s,
                             "one_device_first_s": one_device_builds[label.split("_")[0]],
                             "phases_s": st["phases_s"], "identical_bytes": _same_index_files(ref, got, label)}
        shutil.rmtree(dirs[1])
        shutil.rmtree(dirs[3])
        out["builds"] = builds

        # (b)-(e): each query cold and warm over the mesh, then on one device.
        one.enable_hyperspace()
        session.enable_hyperspace()
        cache = PlanCache()
        n_rows = source.num_rows
        gen_tpch_customer(dirs[2], sf=sf, seed=45)
        domain = int(TPCH_SF1_ORDERS_ROWS * sf)
        lo, hi = int(domain * 0.47), int(domain * 0.48)
        between = (col("l_orderkey") >= lit(lo)) & (col("l_orderkey") <= lit(hi))

        def plans(s):
            li, orders = s.parquet(workdir / "lineitem"), s.parquet(workdir / "orders")
            return {
                "Q1": li.aggregate(Q1_GROUP, Q1_AGGS),
                "revenue": li.aggregate(["l_orderkey"], [("sum", "l_extendedprice", "rev")]),
                "J1": li.select("l_orderkey", "l_extendedprice").join(
                    orders.select("o_orderkey", "o_totalprice", "o_orderpriority"), ["l_orderkey"], ["o_orderkey"]),
                "range": li.filter(between).select("l_orderkey", "l_partkey", "l_extendedprice"),
                "topN": li.select("l_orderkey", "l_extendedprice").sort([("l_extendedprice", False)]).limit(100),
                "Q3": q3_plan(htorch, li, orders, s.parquet(dirs[2])),
            }

        mesh_plans, one_plans = plans(session), plans(one)
        # name: (K1, K2 launches a run over the mesh, the derived kinds a warm
        # run must hit, the columns whose sums may differ in their last bits)
        expect = {
            "Q1": (MESH_SHARDS, 0, ("gid",), ("sum_price", "avg_disc")),
            "revenue": (MESH_SHARDS, 0, ("gid",), ("rev",)),
            "J1": (0, MESH_SHARDS, ("fact",), ()),
            "topN": (0, 0, (), ()),
            "Q3": (MESH_SHARDS, None, (), ("revenue",)),
        }
        queries = {}
        masks: list = []
        real_mask = filter_ops._mask

        def counting_mask(table, predicate):
            masks.append(table.num_rows)
            return real_mask(table, predicate)

        for name in ("Q1", "revenue", "J1", "range", "topN", "Q3"):
            modes = ("index", "no_index") if name == "range" else ("index",)
            for mode in modes:
                for s in (session, one):
                    s.enable_hyperspace() if mode == "index" else s.disable_hyperspace()
                k1, k2, derived, tolerant = expect.get(name, (0, 0, (), ()))
                label = name if mode == "index" else f"{name} {mode}"
                l1, l2 = segment_reduce.launches, run_bounds.launches
                masks.clear()
                filter_ops._mask = counting_mask
                try:
                    (got,), _, timing = cold_warm(f"mesh {label}", session, [mesh_plans[name]], cache, sync, derived,
                                                  tolerant)
                finally:
                    filter_ops._mask = real_mask
                launched = {"segment_reduce": segment_reduce.launches - l1, "run_bounds": run_bounds.launches - l2}
                shard_masks = list(masks)
                (want,), _, one_timing = cold_warm(f"one-device {label}", one, [one_plans[name]], ctx["plan_cache"],
                                                   sync, derived, tolerant)
                stats = timing["warm_stats"]
                if device.type == "cuda" and (launched["segment_reduce"] != 2 * k1
                                              or (k2 is not None and launched["run_bounds"] != 2 * k2)):
                    raise AssertionError(f"mesh {label}: {launched} launched cold and warm, expected K1 {k1} "
                                         f"and K2 {k2} a run")
                if k1 and stats["agg_devices"] != MESH_SHARDS:
                    raise AssertionError(f"mesh {label}: agg_devices {stats['agg_devices']}")
                if name == "J1" and (stats["join_devices"] != MESH_SHARDS
                                     or stats["join_path"] != "zero-exchange-aligned"):
                    raise AssertionError(f"mesh J1: {stats['join_path']} over {stats['join_devices']} shards")
                if name in ("topN", "Q3"):
                    top = stats["top_n"] or {}
                    if top.get("kernel") != "mesh-sharded-select + sort" or top.get("devices") != MESH_SHARDS:
                        raise AssertionError(f"mesh {name}: top-N {top}")
                # The answers: the one device's (sums within 2·N·u), and pyarrow's.
                if name == "J1":
                    same_device_rows("mesh J1", got, want, ["l_orderkey", "l_extendedprice", "o_totalprice"])
                elif name == "topN":
                    if not got.to_arrow().equals(want.to_arrow()):
                        raise AssertionError("mesh top-N: the rows differ from the one device's")
                else:
                    same_rows(f"mesh {label}", sorted_rows(got, tolerant), sorted_rows(want, tolerant), tolerant,
                              n_rows)
                if name == "Q1":
                    check_q1(pd.DataFrame(got.decode()), source)
                elif name == "revenue":
                    check_revenue(pd.DataFrame(got.decode()), source)
                elif name == "range":
                    ref = source.filter(pc.and_(pc.greater_equal(source["l_orderkey"], lo),
                                                pc.less_equal(source["l_orderkey"], hi)))
                    ref = ref.select(["l_orderkey", "l_partkey", "l_extendedprice"])
                    same_rows(f"mesh {label} against pyarrow", sorted_rows(got, ()),
                              ref.sort_by([(c, "ascending") for c in ref.column_names]), (), n_rows)
                    # The rows pad to a power of two and shard by n_pad / 4, as
                    # the JAX package's mask shards them: 6.0M rows fill 3 of 4.
                    per = filter_ops._pow2(n_rows) // MESH_SHARDS
                    want_masks = 2 * sum(hi_ > lo_ for lo_, hi_ in row_ranges(n_rows, per, MESH_SHARDS))
                    if mode == "no_index" and (len(shard_masks) != want_masks or want_masks < 4):
                        raise AssertionError(f"mesh {label}: {len(shard_masks)} shard masks cold and warm, "
                                             f"expected {want_masks}")
                queries[label] = {
                    "rows": got.num_rows, "cold_s": timing["cold_s"], "warm_s": timing["warm_s"],
                    "one_device_cold_s": one_timing["cold_s"], "one_device_warm_s": one_timing["warm_s"],
                    "warm_host_s": timing["warm_host_s"], "one_device_warm_host_s": one_timing["warm_host_s"],
                    "launches_cold_and_warm": launched, "shard_masks_cold_and_warm": shard_masks,
                    "warm_stats": stats,
                }
        session.disable_hyperspace()
        session.run(mesh_plans["topN"])
        plan_repr = repr(session.last_physical_plan)
        if "mesh-sharded-select" not in plan_repr:
            raise AssertionError(f"the top-N's physical plan does not name mesh-sharded-select: {plan_repr}")
        out["queries"] = queries
    finally:
        one.enable_hyperspace()
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
    return out


# -- join-types path -----------------------------------------------------------

C_INDEXED, C_INCLUDED = ["c_custkey"], ["c_nationkey", "c_acctbal"]
OC_INDEXED, OC_INCLUDED = ["o_custkey"], ["o_orderkey", "o_totalprice", "o_comment"]
SET_KEYS = 12  # DPPk: orders keys drawn with seed 11


def _days(iso: str) -> int:
    import datetime

    return (datetime.date.fromisoformat(iso) - datetime.date(1970, 1, 1)).days


def dpp_keys(sf: float) -> list[int]:
    """DPPk's order keys: SET_KEYS drawn with seed 11 from the domain."""
    return np.random.default_rng(11).integers(0, int(1_500_000 * sf), SET_KEYS).tolist()


def join_type_plans(pkg, li, orders, customer, sf: float) -> dict:
    """The join-types path's plans, built with `pkg`'s `col` and `lit` so
    that the same function builds them for either package. Returns name
    -> (plan, rebucketize mode)."""
    col, lit = pkg.col, pkg.lit
    urgent = orders.filter(col("o_orderpriority") == lit("1-URGENT"))
    j1 = li.select("l_orderkey", "l_extendedprice").join(
        orders.select("o_orderkey", "o_totalprice", "o_orderpriority"), ["l_orderkey"], ["o_orderkey"])
    li_j = li.select("l_orderkey", "l_quantity", "l_extendedprice", "l_discount")
    o_j = ("o_orderkey", "o_totalprice", "o_orderpriority")
    keys = dpp_keys(sf)
    q4_right = li.filter(col("l_discount") >= lit(0.08))
    q13 = customer.select("c_custkey").join(
        orders.select("o_custkey", "o_orderkey", "o_totalprice"), ["c_custkey"], ["o_custkey"], how="left",
        condition=col("o_totalprice") > lit(400000.0),
    ).aggregate(["c_custkey"], [("count", "o_orderkey", "c_count")]).aggregate(
        ["c_count"], [("count", None, "custdist")])
    out = {"Q13": (q13, "auto")}
    for name, how in (("ROJ", "right"), ("FOJ", "full")):
        out[name] = (li.filter(col("l_discount") >= lit(0.05)).select("l_orderkey", "l_extendedprice").join(
            urgent.select(*o_j), ["l_orderkey"], ["o_orderkey"], how=how), "auto")
    for name, how in (("Q4s", "semi"), ("Q4a", "anti")):
        out[name] = (orders.select("o_orderkey", "o_orderpriority").join(
            q4_right.select("l_orderkey"), ["o_orderkey"], ["l_orderkey"], how=how,
        ).aggregate(["o_orderpriority"], [("count", None, "cnt")]), "auto")
    for name, how in (("Q21s", "semi"), ("Q21a", "anti")):
        out[name] = (orders.select("o_orderkey", "o_orderpriority", "o_totalprice").join(
            q4_right.select("l_orderkey", "l_extendedprice"), ["o_orderkey"], ["l_orderkey"], how=how,
            condition=col("l_extendedprice") > col("o_totalprice") * lit(0.1),
        ).aggregate(["o_orderpriority"], [("count", None, "cnt")]), "auto")
    sets_right = li.filter(col("l_discount") == lit(0.10)).select("l_orderkey")
    out["INTERSECT"] = (urgent.select("o_orderkey").intersect(sets_right), "auto")
    out["EXCEPT"] = (urgent.select("o_orderkey").except_(sets_right), "auto")
    out["REB"] = (li.select("l_orderkey", "l_extendedprice").join(
        orders.select("o_orderkey", "o_orderstatus"), ["l_orderkey"], ["o_orderkey"],
    ).aggregate(["o_orderstatus"], [("sum", "l_extendedprice", "sum_price"), ("count", None, "cnt")]), "force")
    out["CHAIN"] = (j1.join(li.filter(col("l_discount") == lit(0.10)).select("l_orderkey", "l_discount"),
                            ["l_orderkey"], ["l_orderkey"], how="semi"), "auto")
    quarter = (col("o_orderdate") >= lit(_days("1995-01-01"))) & (col("o_orderdate") < lit(_days("1995-04-01")))
    out["DPPq"] = (li_j.join(orders.filter(quarter).select(*o_j), ["l_orderkey"], ["o_orderkey"]).aggregate(
        ["o_orderpriority"], J2_AGGS), "auto")
    out["DPPk"] = (li_j.join(orders.filter(col("o_orderkey").isin(keys)).select(*o_j), ["l_orderkey"],
                             ["o_orderkey"]).aggregate(["o_orderpriority"], J2_AGGS), "auto")
    return out


# Per query: the path expected (index, no index) — the JAX package's
# choice at SF1's row counts —, whether K2 (index, no index) and K1 launch,
# and whether the join is a membership probe (no pairs: K2 must not run).
JOIN_TYPE_EXPECT = {
    # Without the index customer (150k) is under a quarter of orders: the
    # broadcast probe; so are the filtered sides of ROJ / FOJ.
    "Q13": (("zero-exchange-aligned", "broadcast-hash"), (True, False), True),
    "ROJ": (("zero-exchange-aligned", "broadcast-hash"), (True, False), False),
    "FOJ": (("zero-exchange-aligned", "broadcast-hash"), (True, False), False),
    "Q4s": (("zero-exchange-aligned", "single-partition"), (False, False), True),
    "Q4a": (("zero-exchange-aligned", "single-partition"), (False, False), True),
    # lineitem at l_discount >= 0.08 (about 1.64M rows) is no quarter of
    # orders' 1.5M: one partition, merged.
    "Q21s": (("zero-exchange-aligned", "single-partition"), (True, True), True),
    "Q21a": (("zero-exchange-aligned", "single-partition"), (True, True), True),
    # The set operations' left side is a DISTINCT (no scan), under a
    # quarter of lineitem's index: probed on one partition, no pairs.
    "INTERSECT": (("single-partition", "single-partition"), (False, False), False),
    "EXCEPT": (("single-partition", "single-partition"), (False, False), False),
    "REB": (("rebucketized-aligned", "single-partition"), (True, True), True),
    # Without the index J1 broadcasts and the semi join is a probe.
    "CHAIN": (("bucket-preserved-aligned", "single-partition"), (True, False), False),
    "DPPq": (("zero-exchange-aligned", "single-partition"), (True, True), True),
    "DPPk": (("zero-exchange-aligned", "single-partition"), (True, True), True),
}
MEMBERSHIP_PROBES = ("Q4s", "Q4a", "INTERSECT", "EXCEPT")


def _row_columns(columns: list) -> np.ndarray:
    """Rows as a lexicographically sorted float64 matrix: each column a
    float64 array with NaN for a null (string columns their rank in a
    sorted dictionary). Exact for the integers and prices compared here."""
    mat = np.stack(columns)
    order = np.lexsort(mat[::-1])
    return mat[:, order]


def _result_columns(result, names: list, dictionary: dict) -> list:
    """A ColumnTable's columns for _row_columns; strings ranked in
    `dictionary[name]` (a sorted array holding every value)."""
    out = []
    for c in names:
        f = result.schema.field(c)
        v = result.host_column(c)
        if f.is_string:
            v = np.searchsorted(dictionary[c], result.dictionaries[f.name].astype(str))[v]
        v = v.astype(np.float64)
        valid = result.host_valid_mask(c)
        if valid is not None:
            v[~valid] = np.nan
        out.append(v)
    return out


def _arrow_columns(table, names: list, dictionary: dict) -> list:
    import pyarrow.compute as pc

    out = []
    for c in names:
        a = table[c].combine_chunks()
        if c in dictionary:
            enc = pc.dictionary_encode(a)
            ranks = np.searchsorted(dictionary[c], np.asarray(enc.dictionary.to_pylist(), dtype=str))
            v = ranks[np.asarray(enc.indices.fill_null(0))].astype(np.float64)
        else:
            v = np.array(a.fill_null(0).to_numpy(zero_copy_only=False), dtype=np.float64)
        valid = np.asarray(pc.is_valid(a))
        v[~valid] = np.nan
        out.append(v)
    return out


def _check_rows(name: str, result, ref, names: list, strings: dict | None = None, cache: dict | None = None) -> None:
    """Every row of `result` (a ColumnTable) against pyarrow's `ref`,
    exactly, order aside. `strings` maps each string column to a sorted
    array holding every value; `cache` keeps `ref`'s sorted rows for the
    next check of the same query."""
    strings = strings or {}
    if result.num_rows != ref.num_rows or result.num_rows == 0:
        raise AssertionError(f"{name}: {result.num_rows} rows, pyarrow {ref.num_rows}")
    got = _row_columns(_result_columns(result, names, strings))
    want = None if cache is None else cache.get(name)
    if want is None:
        want = _row_columns(_arrow_columns(ref, names, strings))
        if cache is not None:
            cache[name] = want
    for i, c in enumerate(names):
        if not np.array_equal(got[i], want[i], equal_nan=True):
            raise AssertionError(f"{name}: column {c} differs from pyarrow")


def join_types_path(device, ctx: dict, sf: float) -> dict:
    """The join types beyond the inner join at SF1 through the user entry
    points, on the session, lineitem and orders of the join path: Q13's
    left join with an ON residual under two aggregates; a right and a full
    outer join; Q4's semi / anti joins and Q21's with a residual; INTERSECT
    and EXCEPT; an aggregate over a join with one indexed side under the
    forced exchange; a semi join chained on J1's bucket-grouped output;
    and two joins pruned dynamically (a quarter's orders, 12 order keys).
    Each runs cold and warm, index on and off, checked against pyarrow on
    the same parquet; each prints one line. Returns the per-query
    records."""
    import pandas as pd
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    import torch

    import hyperspace_tpu_torch as htorch
    from hyperspace_tpu_torch import Hyperspace, IndexConfig
    from hyperspace_tpu_torch.datagen import gen_tpch_customer
    from hyperspace_tpu_torch.ops.segment_reduce import segment_reduce
    from hyperspace_tpu_torch.ops.sortkeys import run_bounds

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    session, li, orders, workdir = ctx["session"], ctx["lineitem"], ctx["orders"], ctx["workdir"]
    out: dict = {}
    t0 = time.perf_counter()
    gen_tpch_customer(workdir / "customer", sf=sf, seed=45)
    out["customer_datagen_s"] = time.perf_counter() - t0
    customer = session.parquet(workdir / "customer")
    hs = Hyperspace(session)
    t0 = time.perf_counter()
    hs.create_index(customer, IndexConfig("customer_custkey", C_INDEXED, C_INCLUDED))
    hs.create_index(orders, IndexConfig("orders_custkey", OC_INDEXED, OC_INCLUDED))
    sync()
    out["indexes_build_s"] = time.perf_counter() - t0

    # The independent reference: pyarrow on the same parquet.
    li_src, o_src = ctx["source"], ctx["o_source"]
    c_src = pq.read_table(sorted(str(p) for p in (workdir / "customer").glob("*.parquet")))
    urgent = o_src.filter(pc.equal(o_src["o_orderpriority"], "1-URGENT"))
    j_cols = ["l_orderkey", "l_extendedprice", "o_totalprice", "o_orderpriority"]
    o_j = ["o_orderkey", "o_totalprice", "o_orderpriority"]
    li5 = li_src.filter(pc.greater_equal(li_src["l_discount"], 0.05)).select(["l_orderkey", "l_extendedprice"])
    li8 = li_src.filter(pc.greater_equal(li_src["l_discount"], 0.08)).select(["l_orderkey", "l_extendedprice"])
    li10_keys = pc.unique(li_src.filter(pc.equal(li_src["l_discount"], 0.10))["l_orderkey"])
    by_priority = lambda t: t.group_by("o_orderpriority").aggregate([("o_orderkey", "count")])  # noqa: E731
    refs = {}
    per = c_src.select(["c_custkey"]).join(
        o_src.filter(pc.greater(o_src["o_totalprice"], 400000.0)).select(["o_custkey", "o_orderkey"]),
        keys="c_custkey", right_keys="o_custkey", join_type="left outer",
    ).group_by("c_custkey").aggregate([("o_orderkey", "count")])
    refs["Q13"] = per.group_by("o_orderkey_count").aggregate([("c_custkey", "count")]).rename_columns(
        ["c_count", "custdist"])
    for name, how in (("ROJ", "right outer"), ("FOJ", "full outer")):
        t = li5.join(urgent.select(o_j), keys="l_orderkey", right_keys="o_orderkey", join_type=how)
        # pyarrow names a right outer join's key after the right side.
        refs[name] = t.rename_columns(["l_orderkey" if c == "o_orderkey" else c for c in t.column_names])
    orders_p = o_src.select(["o_orderkey", "o_orderpriority", "o_totalprice"])
    in8 = pc.is_in(orders_p["o_orderkey"], value_set=pc.unique(li8["l_orderkey"]))
    pairs = orders_p.join(li8, keys="o_orderkey", right_keys="l_orderkey", join_type="inner")
    pairs = pairs.filter(pc.greater(pairs["l_extendedprice"], pc.multiply(pairs["o_totalprice"], 0.1)))
    in21 = pc.is_in(orders_p["o_orderkey"], value_set=pc.unique(pairs["o_orderkey"]))
    refs["Q4s"], refs["Q4a"] = by_priority(orders_p.filter(in8)), by_priority(orders_p.filter(pc.invert(in8)))
    refs["Q21s"], refs["Q21a"] = by_priority(orders_p.filter(in21)), by_priority(orders_p.filter(pc.invert(in21)))
    left_keys = pc.unique(urgent["o_orderkey"])
    in_sets = pc.is_in(left_keys, value_set=li10_keys)
    refs["INTERSECT"] = pa.table({"o_orderkey": left_keys.filter(in_sets)})
    refs["EXCEPT"] = pa.table({"o_orderkey": left_keys.filter(pc.invert(in_sets))})
    full = li_src.select(["l_orderkey", "l_quantity", "l_extendedprice", "l_discount"]).join(
        o_src.select(["o_orderkey", "o_totalprice", "o_orderpriority", "o_orderstatus", "o_orderdate"]),
        keys="l_orderkey", right_keys="o_orderkey", join_type="inner")
    refs["REB"] = full.group_by(["o_orderstatus"]).aggregate([("l_extendedprice", "sum"), ("l_orderkey", "count")])
    ctx["venue_refs"]["REB"] = refs["REB"].to_pandas()
    j1 = full.select(j_cols)
    refs["CHAIN"] = j1.filter(pc.is_in(j1["l_orderkey"], value_set=li10_keys))
    plans = join_type_plans(htorch, li, orders, customer, sf)
    days = pc.cast(full["o_orderdate"], pa.int32())
    j2_aggs = [("l_extendedprice", "sum"), ("l_quantity", "sum"), ("l_discount", "min"),
               ("l_extendedprice", "max"), ("o_totalprice", "sum"), ("l_orderkey", "count")]
    refs["DPPq"] = full.filter(pc.and_(pc.greater_equal(days, _days("1995-01-01")),
                                       pc.less(days, _days("1995-04-01")))).group_by(["o_orderpriority"]).aggregate(j2_aggs)
    refs["DPPk"] = full.filter(pc.is_in(full["l_orderkey"], value_set=pa.array(dpp_keys(sf), pa.int64()))).group_by(
        ["o_orderpriority"]).aggregate(j2_aggs)
    del full, j1, pairs

    priorities = {"o_orderpriority": np.unique(np.asarray(pc.unique(o_src["o_orderpriority"]).to_pylist(), dtype=str))}
    sorted_refs: dict = {}

    def check(name: str, result) -> None:
        ref = refs[name]
        if name in ("ROJ", "FOJ", "CHAIN"):
            _check_rows(name, result, ref, j_cols, priorities, sorted_refs)
        elif name in ("INTERSECT", "EXCEPT"):
            _check_rows(name, result, ref, ["o_orderkey"], cache=sorted_refs)
        elif name == "Q13":
            _check_rows(name, result, ref, ["c_count", "custdist"])
        elif name.startswith("Q"):
            _check_rows(name, result, ref.rename_columns(["o_orderpriority", "cnt"]), ["o_orderpriority", "cnt"],
                        priorities)
        elif name == "REB":
            _check_join_aggregate(name, pd.DataFrame(result.decode()), ref.to_pandas(), ["o_orderstatus"],
                                  {"cnt": "l_orderkey_count"}, {"sum_price": ("l_extendedprice_sum", "s", False)},
                                  ctx["bucket_stats"], True, session.conf.num_buckets)
        else:
            _check_join_aggregate(
                name, pd.DataFrame(result.decode()), ref.to_pandas(), ["o_orderpriority"],
                {"sum_qty": "l_quantity_sum", "min_disc": "l_discount_min",
                 "max_price": "l_extendedprice_max", "cnt": "l_orderkey_count"},
                {"sum_price": ("l_extendedprice_sum", "s", False), "avg_total": ("o_totalprice_sum", "p", True)},
                ctx["bucket_stats"], True, session.conf.num_buckets,
            )

    tolerant = {"REB": ("sum_price",), "DPPq": ("sum_price", "avg_total"), "DPPk": ("sum_price", "avg_total")}
    for mode in ("index", "no_index"):
        session.enable_hyperspace() if mode == "index" else session.disable_hyperspace()
        m = 0 if mode == "index" else 1
        for name, (plan, rebucketize) in plans.items():
            paths, k2_wanted, k1_wanted = JOIN_TYPE_EXPECT[name]
            session.conf.set("hyperspace.join.rebucketize", rebucketize)
            k2, k1 = run_bounds.launches, segment_reduce.launches
            try:
                (result,), _, timing = cold_warm(f"{name} {mode}", session, [plan], ctx["plan_cache"], sync,
                                              tolerant=tolerant.get(name, ()))
            finally:
                session.conf.set("hyperspace.join.rebucketize", "auto")
            stats = timing.pop("warm_stats")
            if stats["join_path"] != paths[m]:
                raise AssertionError(f"{name} {mode}: join path {stats['join_path']}, expected {paths[m]}")
            launched = {"run_bounds": run_bounds.launches - k2, "segment_reduce": segment_reduce.launches - k1}
            if device.type == "cuda":
                if (launched["run_bounds"] > 0) != k2_wanted[m]:
                    raise AssertionError(f"{name} {mode}: K2 launched {launched['run_bounds']} times")
                if (launched["segment_reduce"] > 0) != k1_wanted:
                    raise AssertionError(f"{name} {mode}: K1 launched {launched['segment_reduce']} times")
            check(name, result)
            record = {"query": name, "mode": mode, "rows": result.num_rows, **timing,
                      **{k: stats[k] for k in ("join_path", "join_paths", "join_kernel", "exchange_kernel",
                                               "files_pruned", "rows_pruned")},
                      "launches": launched}
            out[f"{name}_{mode}"] = record
            log(json.dumps({"join_types_query": record}))
        out[f"caches_after_{mode}"] = cache_stats()
    session.enable_hyperspace()
    ctx.update(customer=customer)
    for name, floor in (("DPPk", ("files_pruned", session.conf.num_buckets - SET_KEYS)), ("DPPq", ("rows_pruned", 1))):
        got = out[f"{name}_index"][floor[0]]
        if got < floor[1]:
            raise AssertionError(f"{name}: {floor[0]} {got}, expected at least {floor[1]}")
    return out


# The query surface's TPC-DS store channel: the indexes of
# benchmarks/tpcds.py::tpcds_indexes that its queries read, at the bucket
# count of benchmarks/bench_tpcds.py.
SS_BY_DATE = (["ss_sold_date_sk"], [
    "ss_item_sk", "ss_store_sk", "ss_customer_sk", "ss_cdemo_sk", "ss_hdemo_sk", "ss_addr_sk",
    "ss_ticket_number", "ss_quantity", "ss_list_price", "ss_sales_price", "ss_ext_sales_price",
    "ss_ext_wholesale_cost", "ss_coupon_amt", "ss_net_profit"])
DD_BY_SK = (["d_date_sk"], ["d_date", "d_year", "d_moy", "d_dom", "d_qoy", "d_day_name", "d_month_seq",
                            "d_week_seq", "d_dow"])
TPCDS_BUCKETS = 64
LIMIT_ROWS = 1000


def q3_plan(pkg, li, orders, customer):
    """TPC-H Q3: lineitem ⋈ (orders ⋈ customer), so l_orderkey names the
    key; the top 10 by revenue."""
    col, lit, date_lit = pkg.col, pkg.lit, pkg.date_lit
    disc_price = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    building = orders.filter(col("o_orderdate") < date_lit("1995-03-15")).select(
        "o_orderkey", "o_custkey", "o_orderdate", "o_shippriority").join(
        customer.filter(col("c_mktsegment") == lit("BUILDING")).select("c_custkey"), ["o_custkey"], ["c_custkey"])
    return li.filter(col("l_shipdate") > date_lit("1995-03-15")).select(
        "l_orderkey", "l_extendedprice", "l_discount").join(building, ["l_orderkey"], ["o_orderkey"]).aggregate(
        ["l_orderkey", "o_orderdate", "o_shippriority"], [pkg.AggSpec.of("sum", disc_price, "revenue")]).sort(
        [("revenue", False), ("o_orderdate", True)]).limit(10)


def query_surface_plans(pkg, tables: dict) -> dict:
    """The query-surface phase's plans, built with `pkg`'s expression and
    plan builders so that the same function builds them for either
    package. `tables` holds the scans: lineitem, orders, customer,
    store_sales, date_dim, item and store. Returns name -> plan."""
    col, lit, when, date_lit, year, spec = pkg.col, pkg.lit, pkg.when, pkg.date_lit, pkg.year, pkg.AggSpec.of
    li, orders, customer = tables["lineitem"], tables["orders"], tables["customer"]
    ss, dd, item, store = tables["store_sales"], tables["date_dim"], tables["item"], tables["store"]
    disc_price = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    out = {}
    # TPC-H Q1 as written.
    out["Q1"] = li.filter(col("l_shipdate") <= date_lit("1998-09-02")).aggregate(
        ["l_returnflag", "l_linestatus"], [
            ("sum", "l_quantity", "sum_qty"),
            ("sum", "l_extendedprice", "sum_base_price"),
            spec("sum", disc_price, "sum_disc_price"),
            spec("sum", disc_price * (lit(1.0) + col("l_tax")), "sum_charge"),
            ("mean", "l_quantity", "avg_qty"),
            ("mean", "l_extendedprice", "avg_price"),
            ("mean", "l_discount", "avg_disc"),
            ("count", None, "count_order"),
        ]).sort(["l_returnflag", "l_linestatus"])
    out["Q3"] = q3_plan(pkg, li, orders, customer)
    # TPC-H Q12 with its real predicates.
    high = col("o_orderpriority").isin(["1-URGENT", "2-HIGH"])
    out["Q12"] = li.filter(
        col("l_shipmode").isin(["MAIL", "SHIP"]) & (col("l_commitdate") < col("l_receiptdate"))
        & (col("l_shipdate") < col("l_commitdate")) & (year(col("l_receiptdate")) == lit(1994))
    ).select("l_orderkey", "l_shipmode").join(
        orders.select("o_orderkey", "o_orderpriority"), ["l_orderkey"], ["o_orderkey"]).aggregate(
        ["l_shipmode"], [spec("sum", when(high, 1).otherwise(0), "high_line_count"),
                         spec("sum", when(~high, 1).otherwise(0), "low_line_count")]).sort(["l_shipmode"])
    # TPC-H Q13 as written.
    out["Q13"] = customer.select("c_custkey").join(
        orders.select("o_custkey", "o_orderkey", "o_comment"), ["c_custkey"], ["o_custkey"], how="left",
        condition=~col("o_comment").like("%special%requests%"),
    ).aggregate(["c_custkey"], [("count", "o_orderkey", "c_count")]).aggregate(
        ["c_count"], [("count", None, "custdist")]).sort([("custdist", False), ("c_count", False)])
    # Q9's year grouping, without part, supplier or nation.
    out["YEAR"] = li.select("l_orderkey", "l_extendedprice", "l_discount").join(
        orders.select("o_orderkey", "o_orderdate"), ["l_orderkey"], ["o_orderkey"]).with_column(
        "o_year", year(col("o_orderdate"))).aggregate(["o_year"], [spec("sum", disc_price, "volume")]).sort(["o_year"])
    out["LIM"] = li.filter(col("l_discount") >= lit(0.05)).select("l_orderkey", "l_extendedprice").limit(LIMIT_ROWS)

    # TPC-DS (benchmarks/tpcds.py): q43's weekly pivot.
    def day_sum(name, alias):
        return spec("sum", when(col("d_day_name") == lit(name), col("ss_sales_price")).otherwise(0.0), alias)

    days = ("Sunday", "Monday", "Tuesday", "Wednesday", "Thursday", "Friday", "Saturday")
    out["q43"] = ss.select("ss_sold_date_sk", "ss_store_sk", "ss_sales_price").join(
        dd.select("d_date_sk", "d_year", "d_day_name").filter(col("d_year") == lit(2000)),
        ["ss_sold_date_sk"], ["d_date_sk"],
    ).join(store.select("s_store_sk", "s_store_id", "s_store_name"), ["ss_store_sk"], ["s_store_sk"]).aggregate(
        ["s_store_name", "s_store_id"], [day_sum(d, f"{d[:3].lower()}_sales") for d in days],
    ).sort(["s_store_name", "s_store_id"]).limit(100)
    # q36: the gross-margin rollup with the rank within its parent.
    out["q36"] = ss.select("ss_sold_date_sk", "ss_item_sk", "ss_store_sk", "ss_net_profit", "ss_ext_sales_price").join(
        dd.select("d_date_sk", "d_year").filter(col("d_year") == lit(2001)), ["ss_sold_date_sk"], ["d_date_sk"],
    ).join(
        store.select("s_store_sk", "s_state").filter(col("s_state").isin(["TX", "OH", "OR", "CA", "WA", "NM", "KY", "VA"])),
        ["ss_store_sk"], ["s_store_sk"],
    ).join(item.select("i_item_sk", "i_category", "i_class"), ["ss_item_sk"], ["i_item_sk"]).rollup(
        ["i_category", "i_class"], [
            spec("sum", "ss_net_profit", "sum_np"), spec("sum", "ss_ext_sales_price", "sum_esp"),
            spec("grouping", "i_category", "g_cat"), spec("grouping", "i_class", "g_class"),
        ],
    ).select(
        "i_category", "i_class",
        ("gross_margin", col("sum_np") / col("sum_esp")),
        ("lochierarchy", col("g_cat") + col("g_class")),
        ("parent_cat", when(col("g_class") == lit(0), col("i_category")).otherwise(lit(""))),
    ).window(["lochierarchy", "parent_cat"], order_by=[("gross_margin", True)],
             funcs=[("rank", None, "rank_within_parent")]).select(
        "gross_margin", "i_category", "i_class", "lochierarchy", "rank_within_parent",
    ).sort([("lochierarchy", False), ("i_category", True), ("rank_within_parent", True)]).limit(100)
    # q67: the 8-level rollup with the top 100 per category.
    out["q67"] = ss.select("ss_sold_date_sk", "ss_item_sk", "ss_store_sk", "ss_quantity", "ss_sales_price").join(
        dd.select("d_date_sk", "d_year", "d_qoy", "d_moy", "d_month_seq").filter(col("d_month_seq").between(1200, 1211)),
        ["ss_sold_date_sk"], ["d_date_sk"],
    ).join(store.select("s_store_sk", "s_store_id"), ["ss_store_sk"], ["s_store_sk"]).join(
        item.select("i_item_sk", "i_category", "i_class", "i_brand", "i_item_id"), ["ss_item_sk"], ["i_item_sk"],
    ).rollup(
        ["i_category", "i_class", "i_brand", "i_item_id", "d_year", "d_qoy", "d_moy", "s_store_id"],
        [spec("sum", col("ss_sales_price") * col("ss_quantity"), "sumsales")],
    ).window(["i_category"], order_by=[("sumsales", False)], funcs=[("rank", None, "rk")]).filter(
        col("rk") <= lit(100),
    ).select("i_category", "i_class", "i_brand", "i_item_id", "d_year", "d_qoy", "d_moy", "s_store_id", "sumsales",
             "rk").sort([("i_category", True), ("rk", True)]).limit(100)
    # q98: item revenue share within its class over 30 days; WIN orders
    # the same items within their category under every frame.
    items = ss.select("ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price").join(
        dd.select("d_date_sk", "d_date").filter(
            (col("d_date") >= date_lit("1999-02-22")) & (col("d_date") <= date_lit("1999-03-24"))),
        ["ss_sold_date_sk"], ["d_date_sk"],
    ).join(
        item.select("i_item_sk", "i_item_id", "i_item_desc", "i_category", "i_class", "i_current_price").filter(
            col("i_category").isin(["Sports", "Books", "Home"])),
        ["ss_item_sk"], ["i_item_sk"],
    ).aggregate(["i_item_id", "i_item_desc", "i_category", "i_class", "i_current_price"],
                [spec("sum", "ss_ext_sales_price", "itemrevenue")])
    out["q98"] = items.window(["i_class"], funcs=[("sum", "itemrevenue", "class_revenue")]).select(
        "i_item_id", "i_item_desc", "i_category", "i_class", "i_current_price", "itemrevenue",
        ("revenueratio", col("itemrevenue") * lit(100.0) / col("class_revenue")),
    ).sort([("i_category", True), ("i_class", True), ("i_item_id", True), ("i_item_desc", True),
            ("revenueratio", True)]).limit(100)
    by_revenue = [("itemrevenue", False)]
    out["WIN"] = items.window(["i_category"], order_by=by_revenue, frame="rows", funcs=[
        ("row_number", None, "rn"), ("dense_rank", None, "drk"), ("sum", "itemrevenue", "run_revenue"),
        pkg.WindowSpec.of("lag", "itemrevenue", "prev_revenue", 1),
        pkg.WindowSpec.of("lead", "itemrevenue", "next2_revenue", 2),
    ]).window(["i_category"], order_by=by_revenue, frame="range", funcs=[
        ("max", "i_current_price", "run_max_price"),
    ]).sort([("i_category", True), ("rn", True)])
    # Distinct counts and a cube over the store sales of one year.
    def store_year(y, *cols):
        return ss.select("ss_sold_date_sk", "ss_store_sk", *cols).join(
            dd.select("d_date_sk", "d_year", "d_qoy").filter(col("d_year") == lit(y)), ["ss_sold_date_sk"], ["d_date_sk"],
        ).join(store.select("s_store_sk", "s_store_id", "s_state"), ["ss_store_sk"], ["s_store_sk"])

    out["CD1"] = store_year(2000, "ss_customer_sk", "ss_net_profit").aggregate(
        ["s_store_id"], [("count_distinct", "ss_customer_sk", "customers"), ("sum", "ss_net_profit", "profit")],
    ).sort(["s_store_id"])
    out["CD2"] = store_year(2000, "ss_customer_sk", "ss_item_sk", "ss_sales_price").aggregate(
        ["s_store_id"], [("count_distinct", "ss_customer_sk", "customers"), ("count_distinct", "ss_item_sk", "items"),
                         ("mean", "ss_sales_price", "avg_price")],
    ).sort(["s_store_id"])
    out["CUBE"] = store_year(2001, "ss_net_profit").cube(
        ["s_state", "d_qoy"], [("sum", "ss_net_profit", "profit"), ("count", None, "cnt"),
                               ("grouping", "s_state", "g_state")],
    ).sort(["s_state", "d_qoy"])
    return out


# Per query at SF1: the JAX package's choices — the last aggregate's
# branch, the joins' paths (index on, index off), the top-N selection, the
# early-out (files scanned of files listed) and the files pruned (index on,
# off) — and whether K2 launches (index on, off). K1 launches in every
# query but LIM; K3 in none. tests/test_torch_query_surface_thresholds.py
# holds every choice to the JAX package's at the smallest scale that
# crosses SF1's thresholds (TPC-H sf 0.25, TPC-DS sf 0.3).
def _expect(agg, joins, top_n=None, early=None, k2=(False, False), pruned=(0, 0)) -> dict:
    return {"agg_path": agg, "join_paths": joins, "top_n": top_n, "limit_early_out": early, "k2": k2,
            "files_pruned": pruned}


BH, ZA, SP = "broadcast-hash", "zero-exchange-aligned", "single-partition"
QUERY_SURFACE_EXPECT = {
    "Q1": _expect("segment-reduce", ([], [])),
    # Customer's BUILDING rows are under a quarter of the orders they
    # join: a broadcast. The joined orders are too, of lineitem, but their
    # codes span the ~1.5M order keys of both sides, past 8x the build
    # side's rows: too sparse for the broadcast table, a merge on one
    # partition. The ~11k groups are past max(2n, 1,024) rows: the
    # partition select.
    "Q3": _expect("segment-reduce", ([BH, SP], [BH, SP]), "partition-select + sort", k2=(True, True)),
    # The pivot's condition reads orders, but the partial grouping by
    # (l_orderkey, l_shipmode) shrinks lineitem less than 8x and its side
    # is a scan: the pushdown bails, the fused Aggregate(Join) merges.
    "Q12": _expect("fused-join-agg", ([SP], [SP]), k2=(True, True)),
    "Q13": _expect("segment-reduce", ([ZA], [BH]), k2=(True, False)),
    "YEAR": _expect("segment-reduce", ([ZA], [BH]), k2=(True, False)),
    "LIM": _expect(None, ([], []), early={"files_scanned": 1, "files_total": 8}),
    # Store's 12 keys: the partial aggregate by ss_store_sk has 12 rows.
    "q43": _expect("PartialAggPushdown", ([SP, ZA], [BH, SP]), "full-sort", k2=(True, True)),
    "q36": _expect("GroupingSetsReaggregate", ([BH, SP, ZA], [BH, BH, SP]), "full-sort", k2=(True, True)),
    # rk <= 100 in each of 10 categories (and the grand total's one row)
    # leaves about 1,001 rows: under 1,024, the full sort.
    "q67": _expect("GroupingSetsReaggregate", ([BH, BH, ZA], [BH, BH, BH]), "full-sort", k2=(True, False)),
    # About 5,400 items of three categories: past 1,024, the partition
    # select. The 31 days' date keys own 27 of ss_by_date's 64 buckets:
    # dynamic partition pruning skips the other 37.
    "q98": _expect("fused-join-agg", ([SP, ZA], [BH, SP]), "partition-select + sort", k2=(True, True),
                   pruned=(37, 0)),
    "WIN": _expect("fused-join-agg", ([SP, ZA], [BH, SP]), k2=(True, True), pruned=(37, 0)),
    "CD1": _expect("CountDistinctReaggregate", ([BH, ZA], [BH, BH]), k2=(True, False)),
    "CD2": _expect("DistinctExpandAggregate", ([BH, ZA], [BH, BH]), k2=(True, False)),
    "CUBE": _expect("GroupingSetsReaggregate", ([BH, ZA], [BH, BH]), k2=(True, False)),
}


# The queries whose rows are ordered or ranked by a float sum: two runs may
# swap rows whose sums tie within tolerance (q67's rollup gives a brand and
# its only item the same sum by two summation orders).
FLOAT_ORDERED = ("Q3", "q36", "q67", "q98", "WIN")


def surface_paths(stats: dict) -> tuple:
    """A query's choices from the port's stats, in QUERY_SURFACE_EXPECT's
    terms (the device suffix of a plain aggregate's path dropped)."""
    agg = stats["agg_path"]
    if agg is not None and agg.startswith("segment-reduce"):
        agg = "segment-reduce"
    top_n = stats["top_n"]["kernel"] if stats["top_n"] else None
    return agg, sorted(stats["join_paths"]), top_n, stats["limit_early_out"]


def _null(v) -> bool:
    return v is None or (isinstance(v, float) and np.isnan(v))


def _sort_rows(rows: list, order: list) -> list:
    """Rows (dicts) in an ORDER BY's order: nulls first ascending, last
    descending; stable, one pass per key from the least significant."""
    for c, asc in reversed(order):
        rows = sorted(rows, key=lambda r: (0, 0) if _null(r[c]) else (1, r[c]), reverse=not asc)
    return rows


def check_ordered(name: str, got, ref, ids: list, order: list, tol: dict, limit: int | None = None,
                  near_ties: dict | None = None) -> None:
    """A result (pandas) against the full reference (pandas, before any
    LIMIT): every row found in the reference by its `ids` columns, each
    other column equal but the `tol` ones (column → tolerance column of the
    reference), which may differ by their tolerance; rows in the ORDER BY's
    order, where two rows may swap only on a float key whose values lie
    within tolerance; under a LIMIT, the reference's first rows, but for
    rows whose float key ties the last one within tolerance. `near_ties`
    maps a rank column to (its float column, its partition columns): the
    rank may differ from the reference's within the ranks of the rows of
    the partition whose values lie within tolerance of the row's."""
    near_ties = near_ties or {}
    refrows = ref.to_dict("records")
    index = {}
    for r in refrows:
        key = tuple(None if _null(r[c]) else r[c] for c in ids)
        if key in index:
            raise AssertionError(f"{name}: the reference repeats the row {key}")
        index[key] = r
    want_n = len(refrows) if limit is None else min(limit, len(refrows))
    rows = got.to_dict("records")
    if len(rows) != want_n:
        raise AssertionError(f"{name}: {len(rows)} rows, the reference {want_n}")
    cols = [c for c in got.columns if c not in ids]
    for r in rows:
        key = tuple(None if _null(r[c]) else r[c] for c in ids)
        w = index.get(key)
        if w is None:
            raise AssertionError(f"{name}: row {key} is not in the reference")
        for c in cols:
            a, b = r[c], w[c]
            if _null(a) or _null(b):
                ok = _null(a) and _null(b)
            elif c in tol:
                ok = abs(a - b) <= w[tol[c]]
            elif c in near_ties:
                # A rank over a float: the rows of the partition whose
                # values lie within tolerance of this one's (itself among
                # them) may take their places in any order, so the rank
                # lies between the least of their reference ranks and
                # that plus their number less one.
                f, part = near_ties[c]
                group = [o for o in refrows if o is w or (
                    all(o[p] == w[p] or (_null(o[p]) and _null(w[p])) for p in part)
                    and not _null(o[f]) and not _null(w[f])
                    and abs(o[f] - w[f]) <= max(o[tol[f]], w[tol[f]]))]
                least = min(o[c] for o in group)
                ok = least <= a <= least + len(group) - 1
            else:
                ok = a == b
            if not ok:
                raise AssertionError(f"{name}: row {key} column {c}: {a!r}, the reference {b!r}")

    def tie(a, b, c) -> bool:  # a float key within tolerance
        return c in tol and not _null(a[c]) and not _null(b[c]) and abs(a[c] - b[c]) <= max(
            index_of(a)[tol[c]], index_of(b)[tol[c]])

    def index_of(r):
        return index[tuple(None if _null(r[c]) else r[c] for c in ids)]

    def before(a, b) -> bool:  # a may precede b
        for c, asc in order:
            x, y = a[c], b[c]
            if (_null(x) and _null(y)) or x == y:
                continue
            if tie(a, b, c):
                return True
            if _null(x) or _null(y):
                return _null(x) == asc
            return (x < y) == asc
        return True

    for i in range(len(rows) - 1):
        if not before(rows[i], rows[i + 1]):
            raise AssertionError(f"{name}: rows {i} and {i + 1} are out of the ORDER BY's order")
    if limit is not None and want_n < len(refrows):
        top = _sort_rows(refrows, order)[:want_n]
        want_ids = {tuple(None if _null(r[c]) else r[c] for c in ids) for r in top}
        got_ids = {tuple(None if _null(r[c]) else r[c] for c in ids) for r in rows}
        last = top[-1]
        for key in want_ids ^ got_ids:
            r = index[key]
            if not any(tie(r, last, c) for c, _ in order):
                raise AssertionError(f"{name}: row {key} is on the wrong side of the LIMIT")


def _join_tol(frame, value_col: str, key_cols: list, out: str, buckets: int, side=None) -> "pd.DataFrame":
    """Per group of `key_cols`: the join-sum tolerance (join_sum_tolerance)
    of a float column summed over a join, from the group's count and max
    |v|; `side` (the values of the join's side they are read from) adds
    the term of a sum taken as a difference of that side's prefix sums,
    which the fused Aggregate(Join) does on its secondary side."""
    g = frame.assign(__abs=frame[value_col].abs()).groupby(key_cols, dropna=False).agg(
        __n=(value_col, "size"), __m=("__abs", "max"))
    ls, abs_sum = (None, None) if side is None else (len(side), float(np.abs(side).sum()))
    g[out] = join_sum_tolerance(g["__n"].to_numpy(), g["__m"].to_numpy(), buckets, ls, abs_sum)
    return g.drop(columns=["__n", "__m"])


def surface_references(tables: dict, sf: float, buckets: int) -> dict:
    """The query-surface phase's answers, computed by pandas on the same
    parquet (the full result before any LIMIT, with a tolerance column
    beside each non-integral sum): name -> (frame, ids, order, tol,
    limit, near_ties)."""
    import pandas as pd

    def day(iso):
        return pd.Timestamp(iso)

    li, o, c = tables["lineitem"], tables["orders"], tables["customer"]
    ss, dd, item, store = tables["store_sales"], tables["date_dim"], tables["item"], tables["store"]
    refs = {}
    # Q1.
    q = li[li.l_shipdate <= day("1998-09-02")].assign(
        disc_price=lambda t: t.l_extendedprice * (1.0 - t.l_discount))
    q = q.assign(charge=q.disc_price * (1.0 + q.l_tax))
    g = q.groupby(["l_returnflag", "l_linestatus"])
    r = g.agg(sum_qty=("l_quantity", "sum"), sum_base_price=("l_extendedprice", "sum"),
              sum_disc_price=("disc_price", "sum"), sum_charge=("charge", "sum"), avg_qty=("l_quantity", "mean"),
              avg_price=("l_extendedprice", "mean"), avg_disc=("l_discount", "mean"), count_order=("l_quantity", "size"))
    a = q.assign(**{k: q[k].abs() for k in ("l_extendedprice", "disc_price", "charge", "l_discount")}).groupby(
        ["l_returnflag", "l_linestatus"]).sum(numeric_only=True)
    n = r["count_order"].to_numpy()
    for col_, src in (("sum_base_price", "l_extendedprice"), ("sum_disc_price", "disc_price"), ("sum_charge", "charge")):
        r[f"{col_}__tol"] = sum_tolerance(n, a[src].to_numpy())
    r["avg_price__tol"] = r["sum_base_price__tol"] / n
    r["avg_disc__tol"] = sum_tolerance(n, a["l_discount"].to_numpy()) / n
    r["avg_qty__tol"] = sum_tolerance(n, a["l_quantity"].to_numpy()) / n
    tol = {k: f"{k}__tol" for k in ("sum_base_price", "sum_disc_price", "sum_charge", "avg_price", "avg_disc", "avg_qty")}
    refs["Q1"] = (r.reset_index(), ["l_returnflag", "l_linestatus"],
                  [("l_returnflag", True), ("l_linestatus", True)], tol, None, None)
    # Q3.
    oc = o[o.o_orderdate < day("1995-03-15")].merge(c[c.c_mktsegment == "BUILDING"][["c_custkey"]],
                                                    left_on="o_custkey", right_on="c_custkey")
    q = li[li.l_shipdate > day("1995-03-15")].merge(oc, left_on="l_orderkey", right_on="o_orderkey")
    q = q.assign(rev=q.l_extendedprice * (1.0 - q.l_discount))
    keys = ["l_orderkey", "o_orderdate", "o_shippriority"]
    r = q.groupby(keys).agg(revenue=("rev", "sum")).join(_join_tol(q, "rev", keys, "revenue__tol", buckets))
    r = r.reset_index()
    r["o_orderdate"] = (r.o_orderdate - pd.Timestamp("1970-01-01")).dt.days.astype(np.int64)
    refs["Q3"] = (r, ["l_orderkey"], [("revenue", False), ("o_orderdate", True)],
                  {"revenue": "revenue__tol"}, 10, None)
    # Q12.
    q = li[li.l_shipmode.isin(["MAIL", "SHIP"]) & (li.l_commitdate < li.l_receiptdate)
           & (li.l_shipdate < li.l_commitdate) & (li.l_receiptdate >= day("1994-01-01"))
           & (li.l_receiptdate < day("1995-01-01"))].merge(o[["o_orderkey", "o_orderpriority"]],
                                                            left_on="l_orderkey", right_on="o_orderkey")
    high = q.o_orderpriority.isin(["1-URGENT", "2-HIGH"])
    r = q.assign(h=high.astype(float), lo=(~high).astype(float)).groupby("l_shipmode").agg(
        high_line_count=("h", "sum"), low_line_count=("lo", "sum"))
    refs["Q12"] = (r.reset_index(), ["l_shipmode"], [("l_shipmode", True)], {}, None, None)
    # Q13: customers with their orders whose comment is not LIKE
    # '%special%requests%' (a left join: no such order counts 0).
    kept = o[~o.o_comment.str.contains("special.*requests", regex=True)]
    per = c[["c_custkey"]].merge(kept[["o_custkey", "o_orderkey"]], left_on="c_custkey", right_on="o_custkey",
                                 how="left").groupby("c_custkey").o_orderkey.count()
    r = per.value_counts().rename_axis("c_count").rename("custdist").reset_index()
    refs["Q13"] = (r, ["c_count"], [("custdist", False), ("c_count", False)], {}, None, None)
    # YEAR.
    q = li[["l_orderkey", "l_extendedprice", "l_discount"]].merge(
        o[["o_orderkey", "o_orderdate"]], left_on="l_orderkey", right_on="o_orderkey")
    q = q.assign(o_year=pd.to_datetime(q.o_orderdate).dt.year.astype(np.int64),
                 vol=q.l_extendedprice * (1.0 - q.l_discount))
    r = q.groupby("o_year").agg(volume=("vol", "sum")).join(_join_tol(q, "vol", ["o_year"], "volume__tol", buckets))
    refs["YEAR"] = (r.reset_index(), ["o_year"], [("o_year", True)], {"volume": "volume__tol"}, None, None)

    # TPC-DS.
    def ss_dd(cols, pred):
        d = dd[pred(dd)]
        return ss[["ss_sold_date_sk", *cols]].merge(d, left_on="ss_sold_date_sk", right_on="d_date_sk")

    q = ss_dd(["ss_store_sk", "ss_sales_price"], lambda d: d.d_year == 2000).merge(
        store[["s_store_sk", "s_store_id", "s_store_name"]], left_on="ss_store_sk", right_on="s_store_sk")
    days = ("Sunday", "Monday", "Tuesday", "Wednesday", "Thursday", "Friday", "Saturday")
    cols = {f"{d[:3].lower()}_sales": np.where(q.d_day_name == d, q.ss_sales_price, 0.0) for d in days}
    q = q.assign(**cols)
    keys = ["s_store_name", "s_store_id"]
    r = q.groupby(keys)[list(cols)].sum()
    t = _join_tol(q, "ss_sales_price", keys, "__t", buckets)["__t"]
    for k in cols:
        r[f"{k}__tol"] = t
    refs["q43"] = (r.reset_index(), keys, [(k, True) for k in keys], {k: f"{k}__tol" for k in cols}, 100, None)

    def rollup(frame, levels, value_cols):
        """The union of group-bys over each prefix of `levels`, with the
        grouping() flags, sums and their tolerances."""
        parts = []
        for i in range(len(levels), -1, -1):
            keep = levels[:i]
            if keep:
                g = frame.groupby(keep, dropna=False)[value_cols].sum()
                tl = {v: _join_tol(frame, v, keep, f"{v}__tol", buckets) for v in value_cols}
                g = g.join([tl[v] for v in value_cols]).reset_index()
            else:
                g = pd.DataFrame({v: [frame[v].sum()] for v in value_cols})
                for v in value_cols:
                    g[f"{v}__tol"] = join_sum_tolerance(len(frame), frame[v].abs().max(), buckets)
            for lv in levels[i:]:
                g[lv] = None
            g["__level"] = len(levels) - i
            parts.append(g)
        return pd.concat(parts, ignore_index=True)

    # q36.
    q = ss_dd(["ss_item_sk", "ss_store_sk", "ss_net_profit", "ss_ext_sales_price"], lambda d: d.d_year == 2001)
    q = q.merge(store[store.s_state.isin(["TX", "OH", "OR", "CA", "WA", "NM", "KY", "VA"])][["s_store_sk"]],
                left_on="ss_store_sk", right_on="s_store_sk").merge(
        item[["i_item_sk", "i_category", "i_class"]], left_on="ss_item_sk", right_on="i_item_sk")
    r = rollup(q, ["i_category", "i_class"], ["ss_net_profit", "ss_ext_sales_price"])
    r["gross_margin"] = r.ss_net_profit / r.ss_ext_sales_price
    r["gross_margin__tol"] = (r["ss_net_profit__tol"] + r.gross_margin.abs() * r["ss_ext_sales_price__tol"]) / \
        r.ss_ext_sales_price.abs() + 4 * UNIT_ROUNDOFF * r.gross_margin.abs()
    r["lochierarchy"] = r["__level"].astype(np.int64)
    r["parent_cat"] = np.where(r["__level"] == 0, r.i_category, "")
    r["rank_within_parent"] = r.groupby(["lochierarchy", "parent_cat"]).gross_margin.rank(method="min").astype(np.int64)
    r = r[["gross_margin", "i_category", "i_class", "lochierarchy", "rank_within_parent", "gross_margin__tol",
           "parent_cat"]]
    refs["q36"] = (r, ["i_category", "i_class"], [("lochierarchy", False), ("i_category", True),
                                                   ("rank_within_parent", True)],
                   {"gross_margin": "gross_margin__tol"}, 100,
                   {"rank_within_parent": ("gross_margin", ["lochierarchy", "parent_cat"])})
    # q67.
    q = ss_dd(["ss_item_sk", "ss_store_sk", "ss_quantity", "ss_sales_price"],
              lambda d: (d.d_month_seq >= 1200) & (d.d_month_seq <= 1211))
    q = q.merge(store[["s_store_sk", "s_store_id"]], left_on="ss_store_sk", right_on="s_store_sk").merge(
        item[["i_item_sk", "i_category", "i_class", "i_brand", "i_item_id"]], left_on="ss_item_sk",
        right_on="i_item_sk")
    q = q.assign(sumsales=q.ss_sales_price * q.ss_quantity)
    levels = ["i_category", "i_class", "i_brand", "i_item_id", "d_year", "d_qoy", "d_moy", "s_store_id"]
    r = rollup(q, levels, ["sumsales"])
    r["rk"] = r.groupby("i_category", dropna=False).sumsales.rank(method="min", ascending=False).astype(np.int64)
    r = r[r.rk <= 100][[*levels, "sumsales", "rk", "sumsales__tol"]]
    refs["q67"] = (r, levels, [("i_category", True), ("rk", True)], {"sumsales": "sumsales__tol"}, 100,
                   {"rk": ("sumsales", ["i_category"])})
    # q98 and WIN's items.
    q = ss_dd(["ss_item_sk", "ss_ext_sales_price"],
              lambda d: (d.d_date >= day("1999-02-22")) & (d.d_date <= day("1999-03-24")))
    q = q.merge(item[item.i_category.isin(["Sports", "Books", "Home"])][
        ["i_item_sk", "i_item_id", "i_item_desc", "i_category", "i_class", "i_current_price"]],
        left_on="ss_item_sk", right_on="i_item_sk")
    keys = ["i_item_id", "i_item_desc", "i_category", "i_class", "i_current_price"]
    # The fused Aggregate(Join) sums the item revenues over the store-sales
    # side of the 31 days, joined to date_dim.
    side = ss_dd(["ss_ext_sales_price"], lambda d: (d.d_date >= day("1999-02-22")) & (d.d_date <= day("1999-03-24")))
    items = q.groupby(keys).agg(itemrevenue=("ss_ext_sales_price", "sum")).join(
        _join_tol(q, "ss_ext_sales_price", keys, "itemrevenue__tol", buckets, side.ss_ext_sales_price)).reset_index()
    r = items.copy()
    grp = r.groupby("i_class")
    r["class_revenue"] = grp.itemrevenue.transform("sum")
    cls_tol = grp["itemrevenue__tol"].transform("sum") + grp.itemrevenue.transform("size") * UNIT_ROUNDOFF * \
        grp.itemrevenue.transform(lambda v: v.abs().sum())
    r["revenueratio"] = r.itemrevenue * 100.0 / r.class_revenue
    r["revenueratio__tol"] = 100.0 * (r["itemrevenue__tol"] + r.revenueratio.abs() / 100.0 * cls_tol) / \
        r.class_revenue.abs() + 4 * UNIT_ROUNDOFF * r.revenueratio.abs()
    r = r.drop(columns=["class_revenue"])
    refs["q98"] = (r, ["i_item_id"], [("i_category", True), ("i_class", True), ("i_item_id", True),
                                      ("i_item_desc", True), ("revenueratio", True)],
                   {"itemrevenue": "itemrevenue__tol", "revenueratio": "revenueratio__tol"}, 100, None)
    refs["WIN"] = items
    # CD1, CD2, CUBE.
    def store_year(y, cols):
        return ss_dd(["ss_store_sk", *cols], lambda d: d.d_year == y).merge(
            store[["s_store_sk", "s_store_id", "s_state"]], left_on="ss_store_sk", right_on="s_store_sk")

    q = store_year(2000, ["ss_customer_sk", "ss_net_profit", "ss_item_sk", "ss_sales_price"])
    g = q.groupby("s_store_id")
    r = g.agg(customers=("ss_customer_sk", "nunique"), profit=("ss_net_profit", "sum"),
              items=("ss_item_sk", "nunique"), avg_price=("ss_sales_price", "mean"))
    r = r.join(_join_tol(q, "ss_net_profit", ["s_store_id"], "profit__tol", buckets)).join(
        _join_tol(q, "ss_sales_price", ["s_store_id"], "avg_price__tol", buckets))
    r["avg_price__tol"] = r["avg_price__tol"] / g.size()
    r = r.reset_index()
    refs["CD1"] = (r[["s_store_id", "customers", "profit", "profit__tol"]], ["s_store_id"], [("s_store_id", True)],
                   {"profit": "profit__tol"}, None, None)
    refs["CD2"] = (r[["s_store_id", "customers", "items", "avg_price", "avg_price__tol"]], ["s_store_id"],
                   [("s_store_id", True)], {"avg_price": "avg_price__tol"}, None, None)
    q = store_year(2001, ["ss_net_profit"]).assign(one=1)
    parts = []
    for keep in (["s_state", "d_qoy"], ["s_state"], ["d_qoy"], []):
        if keep:
            g = q.groupby(keep).agg(profit=("ss_net_profit", "sum"), cnt=("one", "sum")).join(
                _join_tol(q, "ss_net_profit", keep, "profit__tol", buckets)).reset_index()
        else:
            g = pd.DataFrame({"profit": [q.ss_net_profit.sum()], "cnt": [len(q)], "profit__tol": [
                join_sum_tolerance(len(q), q.ss_net_profit.abs().max(), buckets)]})
        for k in ("s_state", "d_qoy"):
            if k not in keep:
                g[k] = None
        g["g_state"] = 0 if "s_state" in keep else 1
        parts.append(g)
    r = pd.concat(parts, ignore_index=True)
    refs["CUBE"] = (r, ["s_state", "d_qoy"], [("s_state", True), ("d_qoy", True)], {"profit": "profit__tol"}, None,
                    None)
    return refs


def check_window(got, items) -> None:
    """WIN against pandas: the rows in (i_category, rn) order; each item's
    revenue within tolerance of the reference; within each category the row numbers 1..m follow the
    revenue order (a swap only between revenues within tolerance), and the
    dense rank, running sum, lag, lead and range-frame running max are the
    ones pandas computes over the result's own revenues in that order."""
    import pandas as pd

    ref = items.set_index("i_item_id")
    if len(got) != len(ref):
        raise AssertionError(f"WIN: {len(got)} rows, the reference {len(ref)}")
    w = ref.loc[got.i_item_id]
    if not np.all(np.abs(got.itemrevenue.to_numpy() - w.itemrevenue.to_numpy()) <= w["itemrevenue__tol"].to_numpy()):
        raise AssertionError("WIN: itemrevenue beyond the float64 join bound")
    rows = got.to_dict("records")
    if [(r["i_category"], r["rn"]) for r in rows] != [
            (r["i_category"], r["rn"]) for r in _sort_rows(rows, [("i_category", True), ("rn", True)])]:
        raise AssertionError("WIN: the rows are not in (i_category, rn) order")
    all_abs = float(np.abs(got.itemrevenue.to_numpy()).sum())
    for cat, part in got.groupby("i_category", sort=False):
        part = part.sort_values("rn")
        m = len(part)
        if part.rn.tolist() != list(range(1, m + 1)):
            raise AssertionError(f"WIN {cat}: row numbers {part.rn.tolist()[:5]}... are not 1..{m}")
        rev = part.itemrevenue.to_numpy()
        tol = ref.loc[part.i_item_id, "itemrevenue__tol"].to_numpy()
        if np.any(np.diff(rev) > np.maximum(tol[1:], tol[:-1])):
            raise AssertionError(f"WIN {cat}: the row numbers do not follow the revenue order")
        want = {
            "drk": pd.Series(rev).rank(method="dense", ascending=False).astype(np.int64).to_numpy(),
            "run_revenue": np.cumsum(rev),
            "prev_revenue": pd.Series(rev).shift(1).to_numpy(),
            "next2_revenue": pd.Series(rev).shift(-2).to_numpy(),
        }
        # The range frame: a row's running max covers its peers (equal
        # revenue), so it is the cumulative max at its last peer.
        price = part.i_current_price.to_numpy()
        last_peer = np.searchsorted(-rev, -rev, side="right") - 1
        want["run_max_price"] = np.maximum.accumulate(price)[last_peer]
        for c in ("drk", "prev_revenue", "next2_revenue", "run_max_price"):
            a = part[c].to_numpy(dtype=np.float64)
            if not np.array_equal(a, want[c].astype(np.float64), equal_nan=True):
                raise AssertionError(f"WIN {cat}: {c} differs from pandas over the result's revenues")
        # The running sum is a difference of two prefix sums over every
        # partition sorted so far (ops/window.py), each within
        # (n - 1)·u·Σ|v| of exact in any order; pandas' cumsum within
        # (m - 1)·u·Σ|v| of the partition's.
        run_tol = 2 * len(got) * UNIT_ROUNDOFF * all_abs + m * UNIT_ROUNDOFF * np.cumsum(np.abs(rev))
        if np.any(np.abs(part.run_revenue.to_numpy() - want["run_revenue"]) > run_tol):
            raise AssertionError(f"WIN {cat}: the running sum differs from pandas' cumsum")


def check_limit(got, li) -> None:
    """LIM: 1,000 rows, each a (l_orderkey, l_extendedprice) of a source
    row with l_discount >= 0.05 (any 1,000 such rows are an answer)."""
    import collections

    if len(got) != LIMIT_ROWS:
        raise AssertionError(f"LIM: {len(got)} rows")
    src = li[li.l_discount >= 0.05]
    have = collections.Counter(zip(src.l_orderkey.tolist(), src.l_extendedprice.tolist()))
    need = collections.Counter(zip(got.l_orderkey.tolist(), got.l_extendedprice.tolist()))
    if any(have[k] < v for k, v in need.items()):
        raise AssertionError("LIM: a row is not one of the source's rows that satisfy the predicate")


def query_surface_path(device, ctx: dict, sf: float) -> dict:
    """The query surface at SF1 through the user entry points: the
    join-types phase's session, lineitem, orders and customer, and the
    TPC-DS store channel with its two indexes. Each query of
    query_surface_plans runs cold and warm through run_query and the
    phase's plan cache, index on and off, against pandas on the same
    parquet, on the JAX package's path (QUERY_SURFACE_EXPECT) with K1 and
    K2 launching where that path runs them; each prints one line.
    Returns the per-query records."""
    import pandas as pd
    import pyarrow.parquet as pq
    import torch

    import hyperspace_tpu_torch as htorch
    from hyperspace_tpu_torch import Hyperspace, IndexConfig
    from hyperspace_tpu_torch.datagen import gen_date_dim, gen_item, gen_store, gen_store_sales
    from hyperspace_tpu_torch.ops import aggregate
    from hyperspace_tpu_torch.ops.segment_reduce import segment_reduce
    from hyperspace_tpu_torch.ops.sortkeys import run_bounds
    from hyperspace_tpu_torch.ops.topk import topk

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    session, workdir = ctx["session"], ctx["workdir"]
    out: dict = {}
    t0 = time.perf_counter()
    roots = {name: workdir / name for name in ("date_dim", "item", "store", "store_sales")}
    gen_date_dim(roots["date_dim"])
    gen_item(roots["item"], sf)
    gen_store(roots["store"])
    gen_store_sales(roots["store_sales"], sf)
    out["tpcds_datagen_s"] = time.perf_counter() - t0
    scans = {name: session.parquet(root) for name, root in roots.items()}
    hs = Hyperspace(session)
    buckets = session.conf.num_buckets
    session.conf.set("hyperspace.index.num.buckets", TPCDS_BUCKETS)
    try:
        for name, scan, (indexed, included) in (("ss_by_date", "store_sales", SS_BY_DATE),
                                                ("dd_by_sk", "date_dim", DD_BY_SK)):
            t0 = time.perf_counter()
            hs.create_index(scans[scan], IndexConfig(name, indexed, included))
            sync()
            out[f"{name}_build_s"] = time.perf_counter() - t0
            out[f"{name}_build_phases_s"] = session.last_build_stats["phases_s"]
    finally:
        session.conf.set("hyperspace.index.num.buckets", buckets)
    tables = {"lineitem": ctx["lineitem"], "orders": ctx["orders"], "customer": ctx["customer"], **scans}
    ctx["surface_tables"] = tables  # what the serving path reuses
    plans = query_surface_plans(htorch, tables)

    t0 = time.perf_counter()

    def frame(root, columns=None):
        files = sorted(str(p) for p in Path(root).glob("*.parquet"))
        return pq.read_table(files, columns=columns).to_pandas(date_as_object=False)

    src = {
        "lineitem": ctx["source"].select([
            "l_orderkey", "l_quantity", "l_extendedprice", "l_discount", "l_tax", "l_returnflag", "l_linestatus",
            "l_shipdate", "l_commitdate", "l_receiptdate", "l_shipmode"]).to_pandas(date_as_object=False),
        "orders": frame(workdir / "orders", ["o_orderkey", "o_custkey", "o_orderdate", "o_orderpriority",
                                             "o_shippriority", "o_comment"]),
        "customer": frame(workdir / "customer", ["c_custkey", "c_mktsegment"]),
        **{name: frame(root) for name, root in roots.items()},
    }
    refs = surface_references(src, sf, max(buckets, TPCDS_BUCKETS))
    out["reference_s"] = time.perf_counter() - t0

    def check_result(label: str, result) -> None:
        got = pd.DataFrame(result.decode())
        name = label.split()[0]
        if name == "LIM":
            check_limit(got, src["lineitem"])
        elif name == "WIN":
            check_window(got, refs["WIN"])
        else:
            ref, ids, order, tol, limit, near = refs[name]
            check_ordered(label, got, ref, ids, order, tol, limit, near)

    tolerant = {name: tuple(ref[3]) for name, ref in refs.items() if isinstance(ref, tuple)}
    tolerant["WIN"] = ("itemrevenue", "run_revenue", "prev_revenue", "next2_revenue")
    for mode in ("index", "no_index"):
        session.enable_hyperspace() if mode == "index" else session.disable_hyperspace()
        m = 0 if mode == "index" else 1
        for name, plan in plans.items():
            want = QUERY_SURFACE_EXPECT[name]
            before = (segment_reduce.launches, run_bounds.launches, topk.launches)
            # Rows ordered or ranked by a float sum may swap between two
            # runs where the sums tie within tolerance: the warm run then
            # need only match the cold one's shape, and both are checked.
            (result,), (cold,), timing = cold_warm(
                f"{name} {mode}", session, [plan], ctx["plan_cache"], sync,
                tolerant=plan.schema.names if name in FLOAT_ORDERED else tolerant.get(name, ()))
            stats = timing.pop("warm_stats")
            launched = {k: now - was for k, now, was in zip(
                ("segment_reduce", "run_bounds", "topk"),
                (segment_reduce.launches, run_bounds.launches, topk.launches), before)}
            got_paths = surface_paths(stats)
            # The broadcast and top-N choices turn on row counts: the
            # table's are SF1's (and hold from TPC-H sf 0.25, TPC-DS 0.3).
            at_sf1 = sf >= 1.0
            want_paths = (want["agg_path"], sorted(want["join_paths"][m]) if at_sf1 else got_paths[1],
                          want["top_n"] if at_sf1 else got_paths[2], want["limit_early_out"])
            if got_paths != want_paths:
                raise AssertionError(f"{name} {mode}: paths {got_paths}, expected {want_paths}")
            if stats["files_pruned"] != want["files_pruned"][m]:
                raise AssertionError(f"{name} {mode}: {stats['files_pruned']} files pruned, "
                                     f"expected {want['files_pruned'][m]}")
            if device.type == "cuda":
                if (launched["segment_reduce"] > 0) != (name != "LIM"):
                    raise AssertionError(f"{name} {mode}: K1 launched {launched['segment_reduce']} times")
                if (launched["run_bounds"] > 0) != want["k2"][m]:
                    raise AssertionError(f"{name} {mode}: K2 launched {launched['run_bounds']} times")
                if launched["topk"]:
                    raise AssertionError(f"{name} {mode}: K3 launched {launched['topk']} times")
            # A zero-exchange join factorizes the keys of two indexes'
            # stable columns: its warm run must find them in HOST_DERIVED.
            if ZA in got_paths[1] and not timing["derived_hits"]:
                raise AssertionError(f"{name} {mode}: the warm run hit nothing in HOST_DERIVED")
            if name in FLOAT_ORDERED:
                check_result(f"{name} {mode} cold", cold)
            check_result(f"{name} {mode}", result)
            record = {"query": name, "mode": mode, "rows": result.num_rows, **timing,
                      **{k: stats[k] for k in ("agg_path", "join_paths", "top_n", "limit_early_out", "files_pruned",
                                               "files_read")},
                      "launches": launched}
            out[f"{name}_{mode}"] = record
            log(json.dumps({"query_surface_query": record}))
        out[f"caches_after_{mode}"] = cache_stats()
    session.enable_hyperspace()
    # K1's inputs at the shapes this phase first gives it, from one more
    # indexed run each: a grouping-set re-fold of many small groups (q67's
    # rollup level of 7 of its 8 columns, the second of its 9 re-folds,
    # after the finest-grain aggregate), count-distinct's inner aggregate
    # by (store, customer) (CD1's first call) and the pushdown's partial
    # aggregate (q43's first).
    k1_inputs = {}
    for label, query, pick, least in (("q67 re-fold", "q67", -8, 10), ("CD1 inner", "CD1", 0, 2),
                                      ("q43 partial", "q43", 0, 1)):
        calls = capture_k1(lambda: session.run(plans[query]), aggregate)
        if len(calls) < least:
            raise AssertionError(f"{query}: {len(calls)} K1 calls through the aggregate, expected {least} or more")
        k1_inputs[label] = calls[pick]
    ctx["k1_surface_inputs"] = k1_inputs
    # What the advisor phase holds its float-ordered plans to.
    ctx["surface_refs"] = {name: refs[name] for name in ("q43", "q67")}
    return out


# -- venue path (3v) ------------------------------------------------------------

VENUE_KEYS = ("hyperspace.join.venue", "hyperspace.agg.venue", "hyperspace.sort.venue", "hyperspace.filter.venue",
              "hyperspace.build.venue")
VENUE_STAT_KEYS = ("agg_path", "join_kernel", "exchange_kernel", "mask_kernel", "sort_op", "join_path")
# The names each query's host run must show (the JAX package's).
VENUE_HOST_NAMES = {
    "Q1": {"agg_path": "segment-reduce-host"},
    "revenue": {"agg_path": "segment-reduce-host"},
    # The 1% range is the sorted key's exact slice: no mask runs on either
    # venue. Unindexed, every row is masked.
    "range_index": {"mask_kernel": None},
    "range_no_index": {"mask_kernel": "host-mask"},
    "J1": {"join_kernel": "host-native-merge"},
    "J2": {"join_kernel": "host-native-merge-accumulate"},
    "REB": {"join_kernel": "host-native-merge-accumulate", "exchange_kernel": "host-counting-sort-exchange"},
    "Q3": {"sort_op": "HostSort", "mask_kernel": "host-mask"},
}
# Non-integral sums and means: host and device within 2·N·u (K1's float64
# atomics vary their last bits); everything else bit-equal.
VENUE_TOLERANT = {"Q1": ("sum_price", "avg_disc"), "revenue": ("rev",), "J2": ("sum_price", "avg_total"),
                  "REB": ("sum_price",), "Q3": ("revenue",)}


def _copy_mb_per_s(device, nbytes: int, pinned: bool, repeats: int = 5) -> float:
    """Median card→host rate of `nbytes` copies (MB/s, MB = 1e6 bytes),
    into pinned or pageable host memory."""
    import torch

    x = torch.arange(nbytes // 4, dtype=torch.int32, device=device)
    dst = torch.empty(nbytes // 4, dtype=torch.int32, pin_memory=pinned)
    walls = []
    for _ in range(repeats + 1):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        dst.copy_(x)
        torch.cuda.synchronize(device)
        walls.append(time.perf_counter() - t0)
    return nbytes / 1e6 / float(np.median(walls[1:]))


def _device_perm(result, cols: list):
    """Lexicographic order of `result`'s rows by `cols`, on its device."""
    import torch

    n = result.num_rows
    perm = torch.arange(n, device=result.device)
    for c in reversed(cols):
        perm = perm[torch.sort(result.column(c)[perm], stable=True).indices]
    return perm


def same_answer(name: str, a, b, tolerant: tuple, rel: float, sort_by: list | None = None) -> None:
    """Two venues' answers to one query: the same schema, rows, nulls and
    dictionaries; every column bit-equal but `tolerant` ones, which agree
    within `rel` of their magnitude. `sort_by` puts both in one row order
    first (a join's pairs come in each merge's order)."""
    import torch

    if a.schema.names != b.schema.names or a.num_rows != b.num_rows:
        raise AssertionError(f"{name}: {a.num_rows} rows of {a.schema.names} against {b.num_rows} of {b.schema.names}")
    pa_, pb = (_device_perm(a, sort_by), _device_perm(b, sort_by)) if sort_by else (None, None)
    for f in a.schema.fields:
        ca, cb = a.columns[f.name], b.columns[f.name]
        if pa_ is not None:
            ca, cb = ca[pa_], cb[pb]
        if f.name in tolerant:
            if not bool(torch.isclose(ca.double(), cb.double(), rtol=rel, atol=0.0, equal_nan=True).all()):
                raise AssertionError(f"{name}: {f.name} differs between the venues beyond 2·N·u")
        elif not torch.equal(ca, cb):
            raise AssertionError(f"{name}: {f.name} differs between the venues")
        va, vb = a.validity.get(f.name), b.validity.get(f.name)
        if pa_ is not None:
            va, vb = (None if va is None else va[pa_]), (None if vb is None else vb[pb])
        if (va is None) != (vb is None) or (va is not None and not torch.equal(va, vb)):
            raise AssertionError(f"{name}: the nulls of {f.name} differ between the venues")
        if not np.array_equal(a.dictionaries.get(f.name, []), b.dictionaries.get(f.name, [])):
            raise AssertionError(f"{name}: the dictionary of {f.name} differs between the venues")


def venue_plans(pkg, ctx: dict, sf: float) -> dict:
    """3v's queries: name -> (plan, hyperspace on, rebucketize mode, rows
    summed by its widest sum)."""
    from hyperspace_tpu_torch.datagen import TPCH_SF1_ORDERS_ROWS

    col, lit = pkg.col, pkg.lit
    li, orders, customer = ctx["lineitem"], ctx["orders"], ctx["customer"]
    domain = int(TPCH_SF1_ORDERS_ROWS * sf)
    lo, hi = int(domain * 0.47), int(domain * 0.48)
    between = li.filter((col("l_orderkey") >= lit(lo)) & (col("l_orderkey") <= lit(hi))).select(
        "l_orderkey", "l_partkey", "l_extendedprice")
    rows = ctx["source"].num_rows
    return {
        "Q1": (li.aggregate(Q1_GROUP, Q1_AGGS), True, "auto", rows),
        "revenue": (li.aggregate(["l_orderkey"], [("sum", "l_extendedprice", "rev")]), True, "auto", rows),
        "range_index": (between, True, "auto", rows),
        "range_no_index": (between, False, "auto", rows),
        "J1": (ctx["join_queries"]["J1"], True, "auto", rows),
        "J2": (ctx["join_queries"]["J2"], True, "auto", rows),
        "REB": (join_type_plans(pkg, li, orders, customer, sf)["REB"][0], True, "force", rows),
        "Q3": (q3_plan(pkg, li, orders, customer), True, "auto", rows),
    }


def venue_path(device, ctx: dict, sf: float) -> dict:
    """Phase 3v: the execution venues at SF1 on the join path's session
    and its lineitem and orders indexes (200 buckets). The card→host link
    is read the JAX package's way (one 4 MB copy after a synchronize: the
    reading its `auto` would compare with the 200 MB/s floor; the port's
    `auto` reads no link) and prints beside 4 MB pinned and 64 MB pageable
    copies; Q1,
    revenue, the 1% range (index on and off), J1 indexed, J2, REB (the
    forced exchange) and Q3 run cold and warm with every venue key `host`,
    `device` and `auto`; config 1's lineitem index is built again on the
    host venue. Fails unless the host answers equal the device's (exactly,
    non-integral sums within 2·N·u) and pyarrow's where the earlier phases
    hold them to it, the host build's bucket files are byte-identical to
    the main path's, host runs launch neither K1 nor K2, and `auto` runs
    launch what device runs do, with the same stats names."""
    import pandas as pd
    import torch

    import hyperspace_tpu_torch as htorch
    from hyperspace_tpu_torch import Hyperspace, IndexConfig
    from hyperspace_tpu_torch.datagen import TPCH_SF1_ORDERS_ROWS
    from hyperspace_tpu_torch.ops.segment_reduce import segment_reduce
    from hyperspace_tpu_torch.ops.sortkeys import run_bounds

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    session, cache = ctx["session"], ctx["plan_cache"]
    out: dict = {}
    probe: dict = {"jax_floor_mb_per_s": session.conf.join_venue_min_mbps}
    if device.type == "cuda":
        x = torch.arange(1 << 20, dtype=torch.int32, device=device)  # 4 MB
        x[:1].cpu()  # the process's first card→host copy sets up the runtime
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        x.cpu()
        probe["d2h_4mb_mb_per_s"] = 4.0 / (time.perf_counter() - t0)
        probe.update(pinned_4mb_mb_per_s=_copy_mb_per_s(device, 4 << 20, True),
                     pageable_64mb_mb_per_s=_copy_mb_per_s(device, 64 << 20, False))
        try:
            probe["card"] = nvml_card_line()
        except Exception as e:  # noqa: BLE001 — the script's last lines print the card again
            probe["card"] = f"{torch.cuda.get_device_name(device)} (power limit not read: {type(e).__name__})"
    log(json.dumps({"venue_link": probe}))
    out["probe"] = probe

    plans = venue_plans(htorch, ctx, sf)
    results: dict = {}
    try:
        for way in ("host", "device", "auto"):
            for key in VENUE_KEYS:
                session.conf.set(key, way)
            for name, (plan, indexed, rebucketize, _) in plans.items():
                session.enable_hyperspace() if indexed else session.disable_hyperspace()
                session.conf.set("hyperspace.join.rebucketize", rebucketize)
                k1, k2 = segment_reduce.launches, run_bounds.launches
                try:
                    (result,), _, timing = cold_warm(f"{name} {way}", session, [plan], cache, sync,
                                                  tolerant=VENUE_TOLERANT.get(name, ()))
                finally:
                    session.conf.set("hyperspace.join.rebucketize", "auto")
                stats = timing.pop("warm_stats")
                launched = {"segment_reduce": segment_reduce.launches - k1, "run_bounds": run_bounds.launches - k2}
                results[name, way] = (result, stats, launched)
                record = {"query": name, "venue": way, "rows": result.num_rows, "cold_s": timing["cold_s"],
                          "warm_s": timing["warm_s"], "warm_host_s": timing["warm_host_s"],
                          **{k: stats.get(k) for k in VENUE_STAT_KEYS}, "launches": launched}
                out[f"{name}_{way}"] = record
                log(json.dumps({"venue_query": record}))
    finally:
        for key in VENUE_KEYS:
            session.conf.set(key, "auto")
        session.enable_hyperspace()

    rows = ctx["source"].num_rows
    for name, (_, _, _, n_sum) in plans.items():
        host, dev, auto = (results[name, w] for w in ("host", "device", "auto"))
        if device.type == "cuda" and any(host[2].values()):
            raise AssertionError(f"{name}: the host venue launched {host[2]}")
        for key, want in VENUE_HOST_NAMES[name].items():
            if host[1].get(key) != want:
                raise AssertionError(f"{name}: the host run's {key} is {host[1].get(key)}, expected {want}")
        for key in VENUE_STAT_KEYS:
            if auto[1].get(key) != dev[1].get(key):
                raise AssertionError(f"{name}: auto's {key} {auto[1].get(key)} is not the device's {dev[1].get(key)}")
        if auto[2] != dev[2]:
            raise AssertionError(f"{name}: auto launched {auto[2]}, the device venue {dev[2]}")
        if device.type == "cuda" and name not in ("range_index", "range_no_index") and not any(dev[2].values()):
            raise AssertionError(f"{name}: the device venue launched no kernel")
        rel = 2 * n_sum * UNIT_ROUNDOFF
        sort_by = ["l_orderkey", "l_extendedprice", "o_totalprice"] if name == "J1" else (
            ["l_orderkey"] if name == "Q3" else None)
        same_answer(f"{name} host/device", host[0], dev[0], VENUE_TOLERANT.get(name, ()), rel, sort_by)
        same_answer(f"{name} auto/device", auto[0], dev[0], VENUE_TOLERANT.get(name, ()), rel, sort_by)
    # The host answers against pyarrow, as the earlier phases hold the
    # device's.
    source = ctx["source"]
    check_q1(pd.DataFrame(results["Q1", "host"][0].decode()), source)
    check_revenue(pd.DataFrame(results["revenue", "host"][0].decode()), source)
    refs = ctx["venue_refs"]
    import pyarrow.compute as pc

    domain = int(TPCH_SF1_ORDERS_ROWS * sf)
    lo, hi = int(domain * 0.47), int(domain * 0.48)
    cols = ["l_orderkey", "l_partkey", "l_extendedprice"]
    ref = source.filter(pc.and_(pc.greater_equal(source["l_orderkey"], lo), pc.less_equal(source["l_orderkey"], hi)))
    ref = ref.select(cols).sort_by([(c, "ascending") for c in cols])
    want = {c: ref[c].to_numpy() for c in cols}
    for name in ("range_index", "range_no_index"):
        got = results[name, "host"][0]
        order = _device_perm(got, ["l_orderkey", "l_partkey", "l_extendedprice"])
        for c in ("l_orderkey", "l_partkey", "l_extendedprice"):
            if not np.array_equal(got.column(c)[order].cpu().numpy(), want[c]):
                raise AssertionError(f"{name} host: column {c} differs from pyarrow")
    j1 = results["J1", "host"][0]
    order = _device_perm(j1, ["l_orderkey", "l_extendedprice", "o_totalprice"])
    for c, want in zip(("l_orderkey", "l_extendedprice", "o_totalprice"), refs["J1"]):
        if not np.array_equal(j1.column(c)[order].cpu().numpy(), want):
            raise AssertionError(f"J1 host: the pairs differ from pyarrow in {c}")
    buckets = session.conf.num_buckets
    _check_join_aggregate(
        "J2 host", pd.DataFrame(results["J2", "host"][0].decode()), refs["J2"], ["o_orderpriority"],
        {"sum_qty": "l_quantity_sum", "min_disc": "l_discount_min", "max_price": "l_extendedprice_max",
         "cnt": "l_orderkey_count"},
        {"sum_price": ("l_extendedprice_sum", "s", False), "avg_total": ("o_totalprice_sum", "p", True)},
        ctx["bucket_stats"], True, buckets)
    _check_join_aggregate(
        "REB host", pd.DataFrame(results["REB", "host"][0].decode()), refs["REB"], ["o_orderstatus"],
        {"cnt": "l_orderkey_count"}, {"sum_price": ("l_extendedprice_sum", "s", False)},
        ctx["bucket_stats"], True, buckets)
    del results

    # Config 1's lineitem index again, on the host build venue: every
    # bucket file byte-identical to the main path's.
    root = Path(session.conf.system_path)
    session.conf.set("hyperspace.build.venue", "host")
    try:
        t0 = time.perf_counter()
        Hyperspace(session).create_index(ctx["lineitem"], IndexConfig("lineitem_orderkey_host", INDEXED, INCLUDED))
        out["host_build_s"] = time.perf_counter() - t0
    finally:
        session.conf.set("hyperspace.build.venue", "auto")
    stats = session.last_build_stats
    if stats["sort_venue"] != "host" or stats["path"] != "in-memory":
        raise AssertionError(f"the host build ran {stats['path']} on {stats['sort_venue']}")
    out["host_build_phases_s"] = stats["phases_s"]
    ref_dir, got_dir = _only_version(root / "lineitem_orderkey"), _only_version(root / "lineitem_orderkey_host")
    names = sorted(p.name for p in ref_dir.glob("bucket-*.parquet"))
    if names != sorted(p.name for p in got_dir.glob("bucket-*.parquet")) or len(names) != buckets:
        raise AssertionError("the host build wrote other bucket files than the main path's")
    for f in names:
        if (ref_dir / f).read_bytes() != (got_dir / f).read_bytes():
            raise AssertionError(f"the host build's {f} differs from the main path's")
    out["host_build_identical_files"] = len(names)
    Hyperspace(session).delete_index("lineitem_orderkey_host")
    Hyperspace(session).vacuum_index("lineitem_orderkey_host")
    return out


def capture_k1(fn, module) -> list:
    """Runs `fn` once with every K1 call made through `module` (the
    aggregate or the fused Aggregate(Join)) recorded, in call order:
    (vals, gid, number of groups, reduce kinds), copied on the card. The
    calls still launch K1."""
    real = module.segment_reduce
    calls = []

    def recording(vals, gid, k, fns):
        calls.append((vals.clone(), gid.clone(), k, tuple(fns)))
        return real(vals, gid, k, fns)

    module.segment_reduce = recording
    try:
        fn()
    finally:
        module.segment_reduce = real
    return calls


def k2_phase(device, pk_np, sk_np) -> dict:
    """K2 against its plain version on the card at one shape (exactly
    equal: the bounds are integers), with CUDA-event times of kernel,
    plain version and the library yardstick (two batched
    torch.searchsorted calls), a device copy moving as many bytes (half
    read, half written: what the card's memory gives a plain stream of
    this size, beside the byte bound), the launch geometry (`bounds_plan`)
    and one call for device_ms_each."""
    import torch

    from hyperspace_tpu_torch.ops.sortkeys import _sm_count, bounds_plan, run_bounds, run_bounds_plain

    pk = torch.from_numpy(pk_np).to(device)
    sk = torch.from_numpy(sk_np).to(device)
    st, en = run_bounds(pk, sk)
    torch.cuda.synchronize()
    want_st, want_en = run_bounds_plain(pk, sk)
    max_abs_err = max(int((st - want_st).abs().max()), int((en - want_en).abs().max()))
    if max_abs_err != 0:
        raise AssertionError(f"K2 differs from its plain version by {max_abs_err} at {tuple(pk.shape)}, {tuple(sk.shape)}")
    b, lp = pk.shape
    ls = sk.shape[1]
    nbytes = 4 * b * lp + 4 * b * ls + 8 * b * lp
    ops = 2 * b * lp * max(int(ls).bit_length(), 1)  # two binary searches a row
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = ops / INT32_OPS * 1e3
    threads, tiles, grid, window, smem = bounds_plan(b, lp, ls, _sm_count(torch.cuda.current_device()))

    def library():
        torch.searchsorted(sk, pk, side="left", out_int32=True)
        torch.searchsorted(sk, pk, side="right", out_int32=True)

    copy_from = torch.empty(nbytes // 8, dtype=torch.int32, device=device)
    copy_to = torch.empty_like(copy_from)
    return {
        "b": b, "lp": lp, "ls": ls,
        "threads": threads, "tiles": b * tiles, "grid": grid, "window": window, "smem": smem,
        "ms": cuda_ms(lambda: run_bounds(pk, sk)),
        "call": lambda: run_bounds(pk, sk),
        "plain_ms": cuda_ms(lambda: run_bounds_plain(pk, sk)),
        "library_ms": cuda_ms(library),
        "copy_ms": cuda_ms(lambda: copy_to.copy_(copy_from)),
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "bytes": nbytes, "max_abs_err": float(max_abs_err),
    }


# -- lifecycle path -------------------------------------------------------------

LIVE_INDEX = "li_live"
# The two appended lineitem files: (their scale as a fraction of the run's,
# seed). The first is 10% of the rows, as benchmarks/bench_hybrid.py
# appends (800,000 on 8,000,000), under maxAppendedRatio 0.3; its order
# keys fall in the first tenth of orders' domain.
LIVE_APPENDS = ((0.1, 46), (0.05, 47))
# BASELINE config 4 (benchmarks/bench_refresh.py): the NYC-Taxi loop, in
# batches of one month of NYC TLC yellow-taxi trips (the TLC's 2023
# monthly files hold about 3M rows each).
TAXI_BATCH_ROWS = 3_000_000
TAXI_BATCHES = 6
TAXI_BUCKETS = 32
TAXI_ZONES = [4, 13, 42, 48, 68, 79, 107, 132, 138, 161, 230, 236]


def lifecycle_plans(pkg, li, orders, sf: float) -> tuple[dict, tuple]:
    """The lifecycle phase's queries over the lineitem source `li`, built
    with `pkg`'s builders (either package): the 12 point lookups of the
    aggregate path, its 1% range, an aggregate over that range
    (sum(l_extendedprice * (1 - l_discount)) by l_orderkey) and J2 with
    `orders`. Returns (name -> list of plans, the range's bounds and the
    lookups' keys)."""
    col, lit, spec = pkg.col, pkg.lit, pkg.AggSpec.of
    domain = int(1_500_000 * sf)  # orders' key domain
    lo, hi = int(domain * 0.47), int(domain * 0.48)
    between = (col("l_orderkey") >= lit(lo)) & (col("l_orderkey") <= lit(hi))
    keys = np.random.default_rng(7).integers(0, domain, 12).astype(np.int64)
    j = li.select("l_orderkey", "l_quantity", "l_extendedprice", "l_discount").join(
        orders.select("o_orderkey", "o_totalprice", "o_orderpriority"), ["l_orderkey"], ["o_orderkey"])
    return {
        "lookups": [li.filter(col("l_orderkey") == int(k)).select("l_orderkey", "l_partkey", "l_extendedprice")
                    for k in keys],
        "range": [li.filter(between).select("l_orderkey", "l_partkey", "l_extendedprice")],
        "range_agg": [li.filter(between).aggregate(["l_orderkey"], [
            spec("sum", col("l_extendedprice") * (lit(1) - col("l_discount")), "rev"),
            ("count", None, "n")])],
        "J2": [j.aggregate(["o_orderpriority"], J2_AGGS)],
    }, (lo, hi, keys)


def lifecycle_check(kind: str, name: str, results: list, grown, o_source, bounds, buckets: int) -> None:
    """The lifecycle queries' results against pyarrow on the grown lineitem
    (`grown`, every live file): rows exactly; the range aggregate's sums
    within sum_tolerance, J2's within the join bound taken over the whole
    table (a bucket's rows and Σ|v| are at most the table's)."""
    import pandas as pd
    import pyarrow as pa
    import pyarrow.compute as pc

    lo, hi, keys = bounds
    cols = ["l_orderkey", "l_partkey", "l_extendedprice"]
    if kind == "lookups":
        for k, result in zip(keys, results):
            _check_rows(f"{name} {k}", result, grown.filter(pc.equal(grown["l_orderkey"], int(k))).select(cols), cols)
        return
    (result,) = results
    in_range = grown.filter(pc.and_(pc.greater_equal(grown["l_orderkey"], lo), pc.less_equal(grown["l_orderkey"], hi)))
    if kind == "range":
        _check_rows(name, result, in_range.select(cols), cols)
        return
    if kind == "range_agg":
        rev = pc.multiply(in_range["l_extendedprice"], pc.subtract(1, in_range["l_discount"]))
        ref = pa.table({"l_orderkey": in_range["l_orderkey"], "rev": rev}).group_by("l_orderkey").aggregate(
            [("rev", "sum"), ("rev", "count")]).to_pandas().sort_values("l_orderkey").reset_index(drop=True)
        got = pd.DataFrame(result.decode()).sort_values("l_orderkey").reset_index(drop=True)
        if len(got) != len(ref) or len(got) == 0 or list(got["l_orderkey"]) != list(ref["l_orderkey"]):
            raise AssertionError(f"{name}: {len(got)} groups, pyarrow {len(ref)}")
        np.testing.assert_array_equal(got["n"].to_numpy(), ref["rev_count"].to_numpy(), err_msg=f"{name} n")
        tol = sum_tolerance(ref["rev_count"].to_numpy(), ref["rev_sum"].to_numpy())
        if not np.all(np.abs(got["rev"].to_numpy() - ref["rev_sum"].to_numpy()) <= tol):
            raise AssertionError(f"{name}: sums beyond the float64 bound")
        return
    ref = grown.select(["l_orderkey", "l_quantity", "l_extendedprice", "l_discount"]).join(
        o_source.select(["o_orderkey", "o_totalprice", "o_orderpriority"]),
        keys="l_orderkey", right_keys="o_orderkey", join_type="inner",
    ).group_by(["o_orderpriority"]).aggregate([
        ("l_extendedprice", "sum"), ("l_quantity", "sum"), ("l_discount", "min"),
        ("l_extendedprice", "max"), ("o_totalprice", "sum"), ("l_orderkey", "count"),
    ]).to_pandas()
    stats = {"l_extendedprice": _bucket_stats([grown.select(["l_extendedprice"])], "l_extendedprice"),
             "o_totalprice": _bucket_stats([o_source.select(["o_totalprice"])], "o_totalprice")}
    _check_join_aggregate(
        name, pd.DataFrame(result.decode()), ref, ["o_orderpriority"],
        {"sum_qty": "l_quantity_sum", "min_disc": "l_discount_min",
         "max_price": "l_extendedprice_max", "cnt": "l_orderkey_count"},
        {"sum_price": ("l_extendedprice_sum", "s", False), "avg_total": ("o_totalprice_sum", "p", True)},
        stats, True, buckets,
    )


def record_bucket_sorts(fn) -> list:
    """Runs `fn` once, recording for every join side whose key codes were
    sorted within buckets before K2 whether a sort ran (a side read from
    one sorted file a bucket needs none)."""
    from hyperspace_tpu_torch.execution import exec_common

    real = exec_common._bucket_sorted_codes_cached
    sorted_ = []

    def recording(codes, side):
        out = real(codes, side)
        sorted_.append(out[1] is not None)
        return out

    exec_common._bucket_sorted_codes_cached = recording
    try:
        fn()
    finally:
        exec_common._bucket_sorted_codes_cached = real
    return sorted_


def capture_k2(fn, module) -> list:
    """Runs `fn` once with every K2 call made through `module` recorded:
    (primary, secondary) codes copied to the host. The calls still launch
    K2."""
    real = module.run_bounds
    calls = []

    def recording(pk, sk):
        calls.append((pk.cpu().numpy(), sk.cpu().numpy()))
        return real(pk, sk)

    module.run_bounds = recording
    try:
        fn()
    finally:
        module.run_bounds = real
    return calls


def lifecycle_path(device, ctx: dict, sf: float, taxi_rows: int = TAXI_BATCH_ROWS) -> tuple[dict, dict, dict]:
    """The index lifecycle through the user entry points, on the session
    and orders of the join path. BASELINE config 3 (hybrid scan, as
    benchmarks/bench_hybrid.py runs it on lineitem): `li_live`, the
    lineitem index over a hard-linked copy of its files, then an appended
    file (10%); the queries of `lifecycle_plans` with hybrid scan on, cold
    and warm, index on and off, against pyarrow on the grown data; a
    second append, whose next warm run misses the plan cache; then
    incremental refresh, optimize and full refresh, each timed and
    followed by the queries. BASELINE config 4 (`taxi_loop`). Then
    delete / restore, a crashed refresh recovered, delete / vacuum.
    Returns (the records, K1's and K2's inputs from one hybrid J2 run)."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    import torch

    import hyperspace_tpu_torch as htorch
    from hyperspace_tpu_torch import Hyperspace, IndexConfig
    from hyperspace_tpu_torch.datagen import gen_tpch_lineitem
    from hyperspace_tpu_torch.metadata.log_manager import IndexLogManager
    from hyperspace_tpu_torch.ops import join_agg
    from hyperspace_tpu_torch.ops.segment_reduce import segment_reduce
    from hyperspace_tpu_torch.ops.sortkeys import run_bounds
    from hyperspace_tpu_torch.plan.nodes import Union

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    session, orders, workdir, cache = ctx["session"], ctx["orders"], ctx["workdir"], ctx["plan_cache"]
    buckets = session.conf.num_buckets
    hs = Hyperspace(session)
    session.enable_hyperspace()
    out: dict = {"actions_s": {}, "index_states": []}
    live = workdir / "lineitem_live"
    live.mkdir()
    for p in sorted((workdir / "lineitem").glob("*.parquet")):
        os.link(p, live / p.name)  # no bytes copied: the main path's indexes stay exact
    li = session.parquet(live)
    t0 = time.perf_counter()
    hs.create_index(li, IndexConfig(LIVE_INDEX, INDEXED, INCLUDED))
    sync()
    out["actions_s"]["create"] = time.perf_counter() - t0
    index_dir = Path(session.conf.system_path) / LIVE_INDEX
    parts = [ctx["source"]]

    def append(i: int) -> None:
        frac, seed = LIVE_APPENDS[i]
        stage = workdir / f"stage_{i}"
        gen_tpch_lineitem(stage, sf=frac * sf, seed=seed, files=1)
        parts.append(pq.read_table(stage / "part-0.parquet"))
        out.setdefault("appended_rows", []).append(parts[-1].num_rows)
        (stage / "part-0.parquet").rename(live / f"append-{i}.parquet")

    def state() -> None:
        frame = hs.indexes()
        out["index_states"].append(dict(zip(frame["name"], frame["state"])))

    def union_in(plan) -> bool:
        return isinstance(plan, Union) or any(union_in(c) for c in plan.children())

    plans, bounds = lifecycle_plans(htorch, li, orders, sf)
    # Plain scans where hyperspace is off; with it, the hybrid scan's
    # HybridScanFilter and the aligned fused join, then the index's own.
    expect_index = {"lookups": "IndexPointLookup", "range": "IndexRangeScan", "range_agg": "IndexRangeScan"}

    def run_queries(stage: str, modes=("index",), hybrid=False) -> None:
        grown = pa.concat_tables(parts, promote_options="default")
        for mode in modes:
            session.enable_hyperspace() if mode == "index" else session.disable_hyperspace()
            for name, qs in plans.items():
                k2, k1 = run_bounds.launches, segment_reduce.launches
                derived = ("fact", "gid") if name == "J2" and mode == "index" else ()
                tolerant = {"J2": ("sum_price", "avg_total"), "range_agg": ("rev",)}.get(name, ())
                results, _, timing = cold_warm(f"{stage} {name} {mode}", session, qs, cache, sync, derived, tolerant)
                stats = timing.pop("warm_stats")
                lifecycle_check(name, f"{stage} {name} {mode}", results, grown, ctx["o_source"], bounds, buckets)
                if mode == "index" and name == "J2":
                    want = ("zero-exchange-aligned", "fused-join-agg")
                    if (stats["join_path"], stats["agg_path"]) != want:
                        raise AssertionError(f"{stage} J2: {stats['join_path']}, {stats['agg_path']}")
                elif mode == "index":
                    want = "HybridScanFilter" if hybrid else expect_index[name]
                    if stats["scan"] != want:
                        raise AssertionError(f"{stage} {name}: scan {stats['scan']}, expected {want}")
                    if name == "lookups" and stats["files_pruned"] < buckets - 1:
                        raise AssertionError(f"{stage} lookups: {stats['files_pruned']} files pruned")
                launched = {"run_bounds": run_bounds.launches - k2, "segment_reduce": segment_reduce.launches - k1}
                if device.type == "cuda" and name in ("J2", "range_agg") and launched["segment_reduce"] == 0:
                    raise AssertionError(f"{stage} {name} {mode}: K1 never launched")
                if device.type == "cuda" and name == "J2" and launched["run_bounds"] == 0:
                    raise AssertionError(f"{stage} J2 {mode}: K2 never launched")
                record = {"stage": stage, "query": name, "mode": mode, "rows": sum(r.num_rows for r in results),
                          **timing, **{k: stats[k] for k in ("scan", "files_read", "files_pruned", "rows_pruned",
                                                             "join_path", "agg_path")},
                          "launches": launched}
                out[f"{stage}_{name}_{mode}"] = record
                log(json.dumps({"lifecycle_query": record}))
        session.enable_hyperspace()

    # Config 3: hybrid scan over the index and the appended 10%.
    session.conf.set("hyperspace.index.hybridscan.enabled", True)
    try:
        append(0)
        for name, qs in plans.items():
            if not union_in(session.optimized_plan(qs[0])):
                raise AssertionError(f"hybrid {name}: the plan holds no hybrid union")
        sorts = record_bucket_sorts(lambda: session.run(plans["J2"][0]))
        if sorts != [True, False]:
            raise AssertionError(f"hybrid J2: bucket sorts {sorts}, expected the lineitem side's only")
        run_queries("hybrid", ("index", "no_index"), hybrid=True)
        # K1's and K2's inputs from one hybrid J2 run: buckets of index
        # rows and delta rows, sorted per bucket.
        session.enable_hyperspace()
        k2_calls = capture_k2(lambda: session.run(plans["J2"][0]), join_agg)
        k1_calls = capture_k1(lambda: session.run(plans["J2"][0]), join_agg)
        if len(k2_calls) != 1 or len(k1_calls) != 2:
            raise AssertionError(f"hybrid J2: {len(k2_calls)} K2 and {len(k1_calls)} K1 calls")
        k1_inputs = {"hybrid J2 run extrema": k1_calls[0], "hybrid J2 fold": k1_calls[1]}
        k2_inputs = {"hybrid J2": k2_calls[0]}
        # A second append: the next warm run must miss the plan cache and
        # answer the grown data.
        append(1)
        misses = cache.stats()["misses"]
        outcome = session.run_query(plans["J2"][0], plan_cache=cache)
        if cache.stats()["misses"] != misses + 1:
            raise AssertionError("the run after the second append hit the plan cache")
        lifecycle_check("J2", "after the second append J2", [outcome.result],
                        pa.concat_tables(parts, promote_options="default"), ctx["o_source"], bounds, buckets)
        state()
    finally:
        session.conf.set("hyperspace.index.hybridscan.enabled", False)

    # The actions on li_live, each timed, each followed by the queries.
    for action, call, dirs in (
        ("refresh_incremental", lambda: hs.refresh_index(LIVE_INDEX, mode="incremental"), ["v__=0", "v__=1"]),
        ("optimize", lambda: hs.optimize_index(LIVE_INDEX), ["v__=2"]),
        ("refresh_full", lambda: hs.refresh_index(LIVE_INDEX), ["v__=3"]),
    ):
        t0 = time.perf_counter()
        call()
        sync()
        out["actions_s"][action] = time.perf_counter() - t0
        out[f"{action}_build_phases_s"] = session.last_build_stats["phases_s"]
        out[f"{action}_rows"] = session.last_build_stats["rows"]
        entry = next(e for e in session.manager.get_indexes() if e.name == LIVE_INDEX)
        if entry.content.directories != dirs:
            raise AssertionError(f"{action}: version dirs {entry.content.directories}, expected {dirs}")
        for name, qs in plans.items():
            if union_in(session.optimized_plan(qs[0])):
                raise AssertionError(f"{action} {name}: the plan still holds a hybrid union")
        if action == "optimize":
            files = sorted((index_dir / dirs[0]).glob("bucket-*.parquet"))
            if len(files) != buckets:
                raise AssertionError(f"optimize left {len(files)} files for {buckets} buckets")
        sorts = record_bucket_sorts(lambda: session.run(plans["J2"][0]))
        want_sorts = [True, False] if action == "refresh_incremental" else [False, False]
        if sorts != want_sorts:
            raise AssertionError(f"{action} J2: bucket sorts {sorts}, expected {want_sorts}")
        run_queries(action)
        state()
    out["taxi"] = taxi_loop(device, workdir, taxi_rows)

    # The other actions: delete / restore, a crashed refresh recovered,
    # delete / vacuum.
    lookup = plans["lookups"][0]

    def uses_index() -> bool:
        return any(getattr(s, "bucket_spec", None) is not None for s in session.optimized_plan(lookup).leaves())

    hs.delete_index(LIVE_INDEX)
    state()
    if uses_index():
        raise AssertionError("a deleted index still serves")
    hs.restore_index(LIVE_INDEX)
    state()
    if not uses_index():
        raise AssertionError("the restored index does not serve")
    # recover on the healthy index collects the versions the refreshes and
    # optimize superseded; then a refresh that died after begin(): its
    # REFRESHING entry and a partial version dir
    # (tests/test_fault_injection.py's fake).
    out["recover_superseded"] = hs.recover(LIVE_INDEX)
    if out["recover_superseded"] != {"rolled": False, "quarantined_entries": 0, "orphans_removed": 3}:
        raise AssertionError(f"recover of the superseded versions reported {out['recover_superseded']}")
    lm = IndexLogManager(index_dir)
    if not lm.write_log(lm.get_latest_id() + 1, lm.get_latest_log().with_state("REFRESHING")):
        raise AssertionError("could not write the crashed refresh's entry")
    orphan = index_dir / "v__=4"
    orphan.mkdir()
    (orphan / "bucket-00000.parquet").write_bytes(b"partial")
    state()
    out["recover"] = [hs.recover(LIVE_INDEX), hs.recover(LIVE_INDEX)]
    if out["recover"] != [{"rolled": True, "quarantined_entries": 0, "orphans_removed": 1},
                          {"rolled": False, "quarantined_entries": 0, "orphans_removed": 0}]:
        raise AssertionError(f"recover reported {out['recover']}")
    state()
    run_queries("recovered")
    hs.delete_index(LIVE_INDEX)
    hs.vacuum_index(LIVE_INDEX)
    state()
    if list(index_dir.glob("v__=*")):
        raise AssertionError("vacuum left version dirs")
    want_states = ["ACTIVE", "ACTIVE", "ACTIVE", "ACTIVE", "DELETED", "ACTIVE", "REFRESHING", "ACTIVE", "DOESNOTEXIST"]
    got_states = [s.get(LIVE_INDEX) for s in out["index_states"]]
    if got_states != want_states:
        raise AssertionError(f"li_live's states {got_states}, expected {want_states}")
    out["caches"] = cache_stats()
    return out, k1_inputs, k2_inputs


def taxi_loop(device, workdir: Path, batch_rows: int = TAXI_BATCH_ROWS) -> dict:
    """BASELINE config 4, benchmarks/bench_refresh.py's loop at one month
    of trips a batch: `trips_zone` (32 buckets) created on batch 0, then
    five times an append, an incremental refresh and two queries on the
    indexed column against pyarrow (`zone == 42`, and sum(fare) and count
    by zone over 12 zones); optimize after batch 3 and one full refresh at
    the end. Returns each action's wall and
    `taxi_incremental_ingest_throughput` as bench_refresh.py computes it
    (every batch's bytes over the incremental refreshes' seconds)."""
    import pandas as pd
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    import torch

    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig, PlanCache, col
    from hyperspace_tpu_torch.datagen import gen_trips_batch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    data = workdir / "trips"
    session = HyperspaceSession(system_path=str(workdir / "taxi_indexes"), num_buckets=TAXI_BUCKETS, device=device)
    hs = Hyperspace(session)
    cache = PlanCache()
    total_bytes = gen_trips_batch(data, batch_rows, 0)
    batches = [pq.read_table(data / "batch-0000.parquet")]
    df = session.parquet(data)
    out: dict = {"batch_rows": batch_rows, "actions_s": {}, "queries": []}
    t0 = time.perf_counter()
    hs.create_index(df, IndexConfig("trips_zone", ["zone"], ["fare", "distance"]))
    sync()
    out["actions_s"]["create"] = time.perf_counter() - t0
    session.enable_hyperspace()
    point = df.filter(col("zone") == 42).select("zone", "fare")
    by_zone = df.filter(col("zone").isin(TAXI_ZONES)).aggregate(["zone"], [("sum", "fare", "fare"), ("count", None, "n")])

    def queries(label: str) -> None:
        grown = pa.concat_tables(batches)
        (got_point, got_agg), _, timing = cold_warm(f"taxi {label}", session, [point, by_zone], cache, sync,
                                                    tolerant=("fare",))
        _check_rows(f"taxi {label} zone 42", got_point, grown.filter(pc.equal(grown["zone"], 42)).select(["zone", "fare"]),
                    ["zone", "fare"])
        ref = grown.filter(pc.is_in(grown["zone"], value_set=pa.array(TAXI_ZONES, pa.int64()))).group_by("zone").aggregate(
            [("fare", "sum"), ("fare", "count")]).to_pandas().sort_values("zone").reset_index(drop=True)
        got = pd.DataFrame(got_agg.decode()).sort_values("zone").reset_index(drop=True)
        if list(got["zone"]) != list(ref["zone"]) or list(got["n"]) != list(ref["fare_count"]):
            raise AssertionError(f"taxi {label}: groups or counts differ from pyarrow")
        tol = sum_tolerance(ref["fare_count"].to_numpy(), ref["fare_sum"].to_numpy())
        if not np.all(np.abs(got["fare"].to_numpy() - ref["fare_sum"].to_numpy()) <= tol):
            raise AssertionError(f"taxi {label}: fare sums beyond the float64 bound")
        stats = timing.pop("warm_stats")
        if stats["scan"] != "IndexPointLookup":
            raise AssertionError(f"taxi {label}: the zone IN list read {stats['scan']}, not its buckets")
        record = {"after": label, "rows": len(grown), "point_rows": got_point.num_rows, **timing,
                  **{k: stats[k] for k in ("scan", "files_read", "files_pruned")}}
        out["queries"].append(record)
        log(json.dumps({"taxi_query": record}))

    queries("create")
    t_inc = 0.0
    for b in range(1, TAXI_BATCHES):
        total_bytes += gen_trips_batch(data, batch_rows, b)
        batches.append(pq.read_table(data / f"batch-{b:04d}.parquet"))
        t0 = time.perf_counter()
        hs.refresh_index("trips_zone", mode="incremental")
        sync()
        out["actions_s"][f"refresh_incremental_{b}"] = time.perf_counter() - t0
        t_inc += out["actions_s"][f"refresh_incremental_{b}"]
        queries(f"batch {b}")
        if b == TAXI_BATCHES // 2:
            t0 = time.perf_counter()
            hs.optimize_index("trips_zone")
            sync()
            out["actions_s"]["optimize"] = time.perf_counter() - t0
            out["optimize_build_phases_s"] = session.last_build_stats["phases_s"]
            queries(f"optimize after batch {b}")
    t0 = time.perf_counter()
    hs.refresh_index("trips_zone")
    sync()
    out["actions_s"]["refresh_full"] = time.perf_counter() - t0
    out["refresh_full_build_phases_s"] = session.last_build_stats["phases_s"]
    queries("full refresh")
    out["total_rows"] = batch_rows * TAXI_BATCHES
    out["total_bytes"] = total_bytes
    out["taxi_incremental_ingest_throughput_gbps"] = total_bytes / 1e9 / t_inc
    out["vs_full_rebuilds"] = out["actions_s"]["refresh_full"] * (TAXI_BATCHES - 1) / t_inc
    return out


VECTOR_APPENDED = 0.1  # the vector lifecycle appends 10% more rows


# The serving phase (3e): the QueryServer over the session the earlier
# phases built. Its mix is benchmarks/bench_serve.py's point lookups (12
# distinct keys) and six of the earlier phases' plans.
SERVE_CLIENTS = (1, 4, 16)
# The file appended (and refreshed into li_live) under 16 looping clients:
# (its scale as a fraction of the run's, seed). Its order keys fall in
# the first 2% of orders' domain, where the base data has them too.
SERVE_APPEND = (0.02, 48)
SERVE_LOOP_CLIENTS = 16
SERVE_OBS_REPEATS = 5
# Per query of the mix, the executed physical plan's operators in
# pre-order, with the JAX package's op names and each join's path: what
# every handle's profile must show. An aligned side is read inside its
# join's frame, so it has no node of its own.
ZA_OP, SP_OP = "/zero-exchange-aligned", "/single-partition"
SERVE_EXPECT = {
    "lookup": ["Project", "IndexPointLookup"],
    "Q1": ["SegmentReduceAggregate", "TableScan"],
    "revenue": ["SegmentReduceAggregate", "TableScan"],
    "J2": ["FusedJoinAggregate" + ZA_OP],
    "J3": ["FusedJoinAggregate" + ZA_OP],
    "Q13": ["SegmentReduceAggregate", "SegmentReduceAggregate", "SortMergeJoin" + ZA_OP],
    # The pushdown: the partial aggregate of the store_sales ⋈ date_dim
    # side, joined with store on one partition, then the top 100.
    "q43": ["TopN", "PartialAggPushdown", "SortMergeJoin" + ZA_OP, "FusedJoinAggregate" + SP_OP, "_TableLeaf",
            "Project", "TableScan"],
}
# The mix's non-integral sums and means (alias -> the source column they
# sum). Their last bits vary with K1's float64 atomics; every source
# column is non-negative (checked), so two orders of a group's m <= N
# terms differ by at most 2(m-1)·u·|S| of the sum S itself.
SERVE_SUMS = {
    "Q1": {"sum_price": "l_extendedprice", "avg_disc": "l_discount"},
    "revenue": {"rev": "l_extendedprice"},
    "J2": {"sum_price": "l_extendedprice", "avg_total": "o_totalprice"},
    "J3": {"sum_total": "o_totalprice", "sum_price": "l_extendedprice"},
    "q43": {f"{d}_sales": "ss_sales_price" for d in ("sun", "mon", "tue", "wed", "thu", "fri", "sat")},
}


def serve_mix(pkg, ctx: dict, sf: float, keys) -> dict:
    """The serving phase's mix, name -> plan, from the earlier phases'
    plans: the lookups on `lineitem_orderkey`, the main path's Q1 and
    revenue, the join path's J2 and J3, the join-types path's Q13 and the
    query-surface path's q43."""
    col = pkg.col
    li = ctx["lineitem"]
    mix = {f"lookup {int(k)}": li.filter(col("l_orderkey") == int(k)).select("l_orderkey", "l_partkey",
                                                                             "l_extendedprice") for k in keys}
    mix["Q1"] = li.aggregate(Q1_GROUP, Q1_AGGS)
    mix["revenue"] = li.aggregate(["l_orderkey"], [("sum", "l_extendedprice", "rev")])
    mix["J2"], mix["J3"] = ctx["join_queries"]["J2"], ctx["join_queries"]["J3"]
    mix["Q13"] = join_type_plans(pkg, li, ctx["orders"], ctx["customer"], sf)["Q13"][0]
    mix["q43"] = query_surface_plans(pkg, ctx["surface_tables"])["q43"]
    return mix


def preorder_ops(node) -> list:
    """A physical (or profile) tree's operators in pre-order, each join's
    with its path."""
    out = []
    for n in node.walk():
        path = n.detail.get("path") or n.detail.get("join_path")
        out.append(n.op + (f"/{path}" if path else ""))
    return out


def check_served(name: str, got, want, rows: int) -> None:
    """A served result against its query's serial run (one device):
    bit-equal but in the sums and means of SERVE_SUMS, which are within
    2·rows·u of their serial value (non-negative terms, `rows` the
    widest input)."""
    import torch

    sums = SERVE_SUMS.get(name, {})
    same_result(name, want, got, tuple(sums))
    for alias in sums:
        a, b = got.column(alias), want.column(alias)
        va, vb = got.valid_mask(alias), want.valid_mask(alias)
        if (va is None) != (vb is None) or (va is not None and not torch.equal(va, vb)):
            raise AssertionError(f"{name}: the served {alias}'s nulls differ from the serial run's")
        ok = torch.abs(a - b) <= 2 * rows * UNIT_ROUNDOFF * torch.abs(b)
        if va is not None:
            ok |= ~va
        if not bool(ok.all()):
            raise AssertionError(f"{name}: the served {alias} is beyond 2·N·u of the serial run's")


def serve_pass(server, mix: dict, n_clients: int, serial: dict, rows: int) -> tuple[dict, list]:
    """One pass of the mix through `server` by `n_clients` threads, the
    submissions split as benchmarks/bench_serve.py::_run_phase splits
    them; every result checked against its serial run. Returns (qps and
    latency percentiles as bench_serve.py::_stats reports them, the
    handles)."""
    import threading

    names = list(mix)
    lat, handles, errors = [], [], []
    lock = threading.Lock()

    def client(cid: int):
        mine = [q for i, q in enumerate(names) if i % n_clients == cid]
        out = []
        try:
            for name in mine:
                t0 = time.perf_counter()
                h = server.submit(mix[name])
                result = h.result(timeout=600)
                out.append((time.perf_counter() - t0, name, h, result))
        except BaseException as e:  # re-raised on the main thread below
            errors.append(e)
        with lock:
            handles.extend(out)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads) or len(handles) != len(names):
        raise AssertionError(f"{n_clients} clients: {len(handles)} of {len(names)} queries answered")
    by_query: dict = {}
    for t, name, h, result in handles:
        check_served(name.split()[0], result, serial[name], rows)
        by_query.setdefault(name.split()[0], []).append(t * 1e3)
    lat = np.sort([h[0] for h in handles])
    return {
        "queries": len(lat),
        "throughput_qps": len(lat) / wall,
        "p50_ms": float(np.percentile(lat, 50)) * 1e3,
        "p95_ms": float(np.percentile(lat, 95)) * 1e3,
        "p99_ms": float(np.percentile(lat, 99)) * 1e3,
        "mean_ms": float(lat.mean()) * 1e3,
        # Submit to result as its client saw it, by query (the lookups' median).
        "by_query_ms": {q: float(np.median(v)) for q, v in by_query.items()},
    }, [(name, h) for _, name, h, _ in handles]


def serving_path(device, ctx: dict, sf: float) -> dict:
    """3e: the serving plane on the earlier phases' session and indexes.
    (1) The mix serially through `run_query`, then through
    `session.serve()` (4 workers, the result cache off) at 1, 4 and 16
    clients, each with a cold plan cache and then warm: every result the
    serial run's, K1's and K2's launches in each pass the serial pass's,
    every handle's profile the physical tree of SERVE_EXPECT with its
    operator walls telescoping to the root. (2) The result cache: a repeat
    hits, launching no kernel and reading no column; a tensor written in
    place misses; 16 clients loop 12 lookups on li_live (re-created) while
    the main thread appends a file and refreshes the index incrementally:
    every answer is pyarrow's before or after the refresh, and after it for
    every query submitted once the refresh returned. (3) Admission: 16
    instant submits at max_queue_depth 4, a queue timeout, drain and
    shutdown. (4) Warm Q1 and J2 with hyperspace.obs.enabled on and off
    (median of 5), and explain (diff, physical, analyze) of Q1 and J2."""
    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    import torch

    import hyperspace_tpu_torch as htorch
    from hyperspace_tpu_torch import Hyperspace, PlanCache
    from hyperspace_tpu_torch.datagen import TPCH_SF1_ORDERS_ROWS
    from hyperspace_tpu_torch.exceptions import AdmissionRejected, QueryTimeout
    from hyperspace_tpu_torch.execution import device_cache as dc
    from hyperspace_tpu_torch.ops.segment_reduce import segment_reduce
    from hyperspace_tpu_torch.ops.sortkeys import run_bounds

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def launches() -> tuple:
        return segment_reduce.launches, run_bounds.launches

    session, workdir = ctx["session"], ctx["workdir"]
    hs = Hyperspace(session)
    session.enable_hyperspace()
    out: dict = {}
    t_phase = time.perf_counter()
    ss_price = pq.read_table(sorted(str(p) for p in (workdir / "store_sales").glob("*.parquet")),
                             columns=["ss_sales_price"])["ss_sales_price"]
    for name, column in (("l_extendedprice", ctx["source"]["l_extendedprice"]),
                         ("l_discount", ctx["source"]["l_discount"]),
                         ("o_totalprice", ctx["o_source"]["o_totalprice"]), ("ss_sales_price", ss_price)):
        if (pc.min(column).as_py() or 0) < 0:
            raise AssertionError(f"{name} holds negative values: SERVE_SUMS's bound does not hold")
    rows = ctx["source"].num_rows
    keys = np.random.default_rng(7).choice(int(TPCH_SF1_ORDERS_ROWS * sf), 12, replace=False) + 1
    mix = serve_mix(htorch, ctx, sf, keys)

    # (1) Serial, then concurrent.
    serial, serial_s = {}, {}
    k1, k2 = launches()
    for name, plan in mix.items():
        t0 = time.perf_counter()
        outcome = session.run_query(plan, plan_cache=PlanCache())
        sync()
        serial_s[name] = time.perf_counter() - t0
        serial[name] = outcome.result
        ops = preorder_ops(outcome.physical_plan)
        if ops != SERVE_EXPECT[name.split()[0]]:
            raise AssertionError(f"serial {name}: physical plan {ops}, expected {SERVE_EXPECT[name.split()[0]]}")
    serial_launches = (segment_reduce.launches - k1, run_bounds.launches - k2)
    if device.type == "cuda" and not all(serial_launches):
        raise AssertionError(f"the serial mix launched K1 / K2 {serial_launches} times")
    out["serial"] = {"walls_s": serial_s, "launches": {"segment_reduce": serial_launches[0],
                                                       "run_bounds": serial_launches[1]}}
    out["concurrent"] = {}
    for n_clients in SERVE_CLIENTS:
        with session.serve(plan_cache=PlanCache(), result_cache=False) as server:
            for state in ("cold", "warm"):
                k1, k2 = launches()
                derived = dc.HOST_DERIVED.stats()
                stats, handles = serve_pass(server, mix, n_clients, serial, rows)
                after = dc.HOST_DERIVED.stats()
                stats["derived_misses"] = after["misses"] - derived["misses"]
                stats["derived_evictions"] = after["evictions"] - derived["evictions"]
                got = (segment_reduce.launches - k1, run_bounds.launches - k2)
                if got != serial_launches:
                    raise AssertionError(f"{n_clients} clients {state}: K1 / K2 launched {got} times, "
                                         f"serially {serial_launches}")
                for name, h in handles:
                    ops = preorder_ops(h.profile.root)
                    if ops != SERVE_EXPECT[name.split()[0]]:
                        raise AssertionError(f"{name}: the handle's profile holds {ops}")
                    if abs(h.profile.operator_total_s() - h.profile.root.wall_s) > 0.01 * h.profile.root.wall_s:
                        raise AssertionError(f"{name}: operator self times do not telescope to the root's wall")
                    if h.profile.venue["platform"] != ("gpu" if device.type == "cuda" else "cpu"):
                        raise AssertionError(f"{name}: profile venue {h.profile.venue}")
                hits = server.plan_cache.stats()["hits"]
                stats["plan_cache_hits"] = hits
                record = {"clients": n_clients, "plan_cache": state, **stats}
                out["concurrent"][f"{n_clients}_{state}"] = record
                log(json.dumps({"serve_pass": record}))
        if any(t.is_alive() for t in server._threads):
            raise AssertionError("a worker outlived shutdown()")

    # (2) The result cache.
    j2 = mix["J2"]
    with session.serve(result_cache=True) as server:
        first = server.submit(j2)
        check_served("J2", first.result(timeout=600), serial["J2"], rows)
        sync()
        k1, k2 = launches()
        reads = dc.DEVICE_CACHE.stats()["misses"]
        hit = server.submit(j2)
        again = hit.result(timeout=600)
        if not hit.cache_hit or again is not first.result() or launches() != (k1, k2):
            raise AssertionError(f"the repeat J2 missed the result cache or launched a kernel: {hit.stats}")
        if dc.DEVICE_CACHE.stats()["misses"] != reads or hit.profile is not None:
            raise AssertionError("the result-cache hit read a column")
        again.columns["sum_price"].add_(1.0)  # a client writes the shared result in place
        fresh = server.submit(j2)
        check_served("J2", fresh.result(timeout=600), serial["J2"], rows)
        if fresh.cache_hit or server.result_cache.stats()["written"] != 1:
            raise AssertionError("a result written in place was served from the result cache")
        out["result_cache"] = {**server.result_cache.stats(), "device_cache": cache_stats()["device_cache"]}
        log(json.dumps({"serve_result_cache": out["result_cache"]}))
        out["result_cache"]["refresh"] = serve_refresh_loop(device, session, server, workdir, sf)

    # (3) Admission.
    lookups = [p for n, p in mix.items() if n.startswith("lookup")]
    server = session.serve(workers=1, max_queue_depth=4)
    handles, refused, untyped = [], 0, []
    for i in range(16):
        try:
            handles.append(server.submit(lookups[i % len(lookups)]))
        except AdmissionRejected:
            refused += 1
        except Exception as e:  # any untyped refusal fails the phase below
            untyped.append(repr(e))
    for h in handles:
        h.result(timeout=600)
    expired = server.submit(lookups[0], timeout=1e-6)
    try:
        expired.result(timeout=600)
        raise AssertionError("a query past its queue timeout ran")
    except QueryTimeout:
        pass
    if not expired.timed_out or expired.profile is not None:
        raise AssertionError("the expired query was not discarded unexecuted")
    drained = server.drain(timeout=600)
    server.shutdown()
    if untyped or not refused or refused + len(handles) != 16 or not drained:
        raise AssertionError(f"admission: {refused} refused, {len(handles)} admitted, untyped {untyped}, "
                             f"drained {drained}")
    if any(t.is_alive() for t in server._threads):
        raise AssertionError("a worker outlived shutdown()")
    out["admission"] = {"refused": refused, "admitted": len(handles), "saturation": server.saturation(),
                        "metrics": server.metrics_snapshot()}

    # (4) Evidence: the tracer's cost on warm Q1 and J2, then explain.
    out["obs_walls_ms"] = {}
    for enabled in (True, False):
        session.conf.set("hyperspace.obs.enabled", enabled)
        for name in ("Q1", "J2"):
            walls = []
            for _ in range(SERVE_OBS_REPEATS):
                t0 = time.perf_counter()
                session.run_query(mix[name])
                sync()
                walls.append((time.perf_counter() - t0) * 1e3)
            walls.sort()
            out["obs_walls_ms"][f"{name} obs {'on' if enabled else 'off'}"] = {
                "median": walls[len(walls) // 2], "min": walls[0], "max": walls[-1]}
    session.conf.set("hyperspace.obs.enabled", True)
    log(json.dumps({"serve_obs_walls_ms": out["obs_walls_ms"]}))
    for name in ("Q1", "J2"):
        for kind, text in (("diff", hs.explain(mix[name])), ("physical", hs.explain(mix[name], physical=True)),
                           ("analyze", hs.explain(mix[name], mode="analyze"))):
            log(f"explain {kind} {name}:\n{text}")
    session.enable_hyperspace()
    out["serving_path_s"] = time.perf_counter() - t_phase
    return out


def serve_refresh_loop(device, session, server, workdir: Path, sf: float) -> dict:
    """16 clients loop 12 lookups on li_live (re-created over the live
    directory) through `server`, while this thread appends a file and
    refreshes the index incrementally. Every answer must be pyarrow's
    before the append or after it; a query submitted after the refresh
    returned must be the latter."""
    import threading

    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import Hyperspace, IndexConfig, col
    from hyperspace_tpu_torch.datagen import gen_tpch_lineitem

    hs = Hyperspace(session)
    live = workdir / "lineitem_live"
    t0 = time.perf_counter()
    hs.create_index(session.parquet(live), IndexConfig(LIVE_INDEX, INDEXED, INCLUDED))
    create_s = time.perf_counter() - t0
    frac, seed = SERVE_APPEND
    stage = workdir / "stage_serve"
    gen_tpch_lineitem(stage, sf=frac * sf, seed=seed, files=1)
    appended = pq.read_table(stage / "part-0.parquet")
    uniq = np.unique(appended["l_orderkey"].to_numpy())
    keys = uniq[np.linspace(0, len(uniq) - 1, 12).astype(np.int64)]
    cols = ["l_orderkey", "l_partkey", "l_extendedprice"]
    li = session.parquet(live)
    plans = {int(k): li.filter(col("l_orderkey") == int(k)).select(*cols) for k in keys}

    def answers(table) -> dict:
        sub = table.select(cols).filter(pc.is_in(table["l_orderkey"], value_set=pa.array(keys)))
        rows = sorted(zip(*(sub[c].to_pylist() for c in cols)))
        return {int(k): [r for r in rows if r[0] == k] for k in keys}

    before = answers(pq.read_table(sorted(str(p) for p in live.glob("*.parquet")), columns=cols))
    after = answers(pa.concat_tables([pq.read_table(sorted(str(p) for p in live.glob("*.parquet")), columns=cols),
                                      appended.select(cols)]))
    if all(before[k] == after[k] for k in before):
        raise AssertionError("the appended file changes none of the lookups")
    stop = threading.Event()
    seen, errors = [], []
    lock = threading.Lock()

    def client(cid: int):
        mine = []
        try:
            i = cid
            while not stop.is_set():
                k = int(keys[i % len(keys)])
                i += 1
                t_submit = time.perf_counter()
                result = server.submit(plans[k]).result(timeout=600)
                d = result.decode()
                mine.append((t_submit, k, sorted(zip(*(np.asarray(d[c]).tolist() for c in cols)))))
        except BaseException as e:  # re-raised on the main thread below
            errors.append(e)
        with lock:
            seen.extend(mine)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(SERVE_LOOP_CLIENTS)]
    for t in threads:
        t.start()
    time.sleep(0.5)
    (stage / "part-0.parquet").rename(live / "append-serve.parquet")
    t0 = time.perf_counter()
    hs.refresh_index(LIVE_INDEX, mode="incremental")
    committed = time.perf_counter()
    time.sleep(0.5)
    stop.set()
    for t in threads:
        t.join(timeout=600)
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise AssertionError("a looping client did not stop")
    late = 0
    for t_submit, k, rows in seen:
        if rows != after[k] and (rows != before[k] or t_submit >= committed):
            raise AssertionError(f"lookup {k} submitted {t_submit - committed:+.3f} s from the refresh's "
                                 f"commit gave {len(rows)} rows: neither before ({len(before[k])}) nor after "
                                 f"({len(after[k])})")
        late += t_submit >= committed
    if not late:
        raise AssertionError("no lookup was submitted after the refresh committed")
    record = {"create_s": create_s, "refresh_incremental_s": committed - t0, "queries": len(seen),
              "after_commit": late, "keys": len(keys), "rows_before": sum(map(len, before.values())),
              "rows_after": sum(map(len, after.values()))}
    log(json.dumps({"serve_refresh_loop": record}))
    return record


# Phase 3f: plan validation on every query, then fault tolerance — the
# corruption quarantine and fallback on li_live, and the crash sweep.
# VALIDATE_REPEATS times the validator alone; VALIDATE_WARM_REPEATS the
# warm queries with validation on and off, alternating: Q1 (about 5 ms)
# enough times to resolve the validator's 0.1 ms, J2 (about 100 ms) fewer.
VALIDATE_REPEATS = 5
VALIDATE_WARM_REPEATS = {"Q1": 200, "J2": 20}
# ROADMAP.md queue 3 item 1's malformed queries on SF1's lineitem, orders
# and customer: name -> (the plan over (pkg, lineitem, orders, customer),
# the JAX package's code, its node path). Each must raise
# PlanValidationError with that code, launching no kernel.
VALIDATE_EXPECT = {
    "int-with-string join key": (lambda p, li, o, c: li.join(o, ["l_orderkey"], ["o_orderpriority"]),
                                 "join-key-type-mismatch", "Join"),
    "missing column in a filter": (lambda p, li, o, c: li.filter(p.col("l_nokey") > 1), "unresolved-column",
                                   "Filter"),
    "missing column in an aggregate": (lambda p, li, o, c: li.aggregate(["l_nokey"], [("sum", "l_quantity", "q")]),
                                       "unresolved-column", "Aggregate"),
    "missing column in a sort": (lambda p, li, o, c: o.sort(["o_nokey"]), "unresolved-column", "Sort"),
    "missing join key": (lambda p, li, o, c: o.join(c, ["o_custkey"], ["c_nokey"]), "unresolved-column", "Join"),
    "limit(-1)": (lambda p, li, o, c: c.limit(-1), "bad-limit", "Limit"),
    "sum over a string": (lambda p, li, o, c: o.aggregate(["o_orderpriority"], [("sum", "o_comment", "s")]),
                          "dtype-incompatible-aggregate", "Aggregate"),
    "string compared with an int": (lambda p, li, o, c: c.filter(p.col("c_mktsegment") > 5),
                                    "dtype-incompatible-predicate", "Filter"),
    "int/string CASE": (lambda p, li, o, c: c.with_column("seg", p.when(p.col("c_nationkey") > 3, 1).otherwise("x")),
                        "dtype-incompatible-predicate", "Project"),
}
# The crash sweep: orders (the run's scale; 1,500,000 rows at SF1), its
# `o_orderkey` index with orders_orderkey's columns and 200 buckets on a
# system path of its own. The incremental refresh indexes one appended
# file (a twentieth of the scale, seed 49); optimize compacts the two
# versions it leaves.
SWEEP_INDEX = "o_sweep"
SWEEP_ACTIONS = ("create", "refresh", "optimize", "vacuum", "create_streaming", "create_pooled")
# The build at scale's points (ten of faults.KNOWN_POINTS): the
# streaming and pooled creates replay theirs as a crash, the streaming
# create also as a transient fault; the query's two (`prefetch.issue`,
# `device.stage`) are replayed around a cold lookup.
BUILD_POINTS = {
    "create_streaming": ("footer.read", "spill.read", "pipeline.put", "pipeline.get"),
    # The pooled create's own four; its workers' footer.read is the
    # streaming create's code, replayed there (each pooled replay pays
    # the workers' start-up, about 6.5 s on the card's host).
    "create_pooled": ("build.worker.spawn", "build.exchange.write", "build.exchange.read",
                      "build.manifest.merge"),
}
# The creates whose points are also replayed as a transient fault. The
# pooled create's transients are host code its workers run (they never
# touch the card), which tests/test_torch_build_scaleout.py holds on the
# CPU; each replay here paid the workers' start-up again (4 replays,
# 26-84 s by the host).
SWEEP_TRANSIENTS = ("create_streaming",)
QUERY_POINTS = ("prefetch.issue", "device.stage")
SWEEP_APPEND = (0.05, 49)
# Later calls of the busy points, replayed on create.
SWEEP_LATER = (("bucket.written", 100), ("log.write", 2), ("file.write_json", 2))


def validation_phase(device, ctx: dict, sf: float) -> dict:
    """3f (a): `check_plan` + `validate_rewrite` alone on the optimized
    plans of Q1, J2, q67 and Q13 (host ms, median of 5), warm Q1 and J2
    with `hyperspace.analysis.validate` on and off (VALIDATE_WARM_REPEATS
    repeats, each running both settings, their order alternating from one
    repeat to the next so that neither always runs first), then
    VALIDATE_EXPECT's malformed queries: each refused with the JAX
    package's code and path, no kernel launched."""
    import torch

    import hyperspace_tpu_torch as htorch
    from hyperspace_tpu_torch.analysis import check_plan, validate_rewrite
    from hyperspace_tpu_torch.exceptions import PlanValidationError
    from hyperspace_tpu_torch.ops.segment_reduce import segment_reduce
    from hyperspace_tpu_torch.ops.sortkeys import run_bounds
    from hyperspace_tpu_torch.ops.topk import topk
    from hyperspace_tpu_torch.plan.prune import prune_columns
    from hyperspace_tpu_torch.plan.pushdown import push_down_filters

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    session = ctx["session"]
    session.enable_hyperspace()
    li, orders, customer = ctx["lineitem"], ctx["orders"], ctx["customer"]
    plans = {
        "Q1": li.aggregate(Q1_GROUP, Q1_AGGS),
        "J2": ctx["join_queries"]["J2"],
        "q67": query_surface_plans(htorch, ctx["surface_tables"])["q67"],
        "Q13": join_type_plans(htorch, li, orders, customer, sf)["Q13"][0],
    }
    out: dict = {"validate_ms": {}, "warm_ms": {}, "refused": {}}
    for name, plan in plans.items():
        optimized = session.optimized_plan(plan)
        rewritten = prune_columns(push_down_filters(optimized))
        walls = []
        for _ in range(VALIDATE_REPEATS):
            t0 = time.perf_counter()
            check_plan(optimized)
            validate_rewrite(optimized, rewritten)
            walls.append((time.perf_counter() - t0) * 1e3)
        walls.sort()
        out["validate_ms"][name] = {"median": walls[len(walls) // 2], "min": walls[0], "max": walls[-1],
                                    "plan_nodes": sum(1 for _ in _plan_nodes(optimized))}
    warm = {(name, enabled): [] for name in ("Q1", "J2") for enabled in (True, False)}
    for enabled in (True, False):
        session.conf.set("hyperspace.analysis.validate", enabled)
        for name in ("Q1", "J2"):
            session.run_query(plans[name])
            sync()
    for repeat in range(max(VALIDATE_WARM_REPEATS.values())):
        for enabled in ((True, False) if repeat % 2 == 0 else (False, True)):
            session.conf.set("hyperspace.analysis.validate", enabled)
            for name in [n for n, count in VALIDATE_WARM_REPEATS.items() if repeat < count]:
                t0 = time.perf_counter()
                session.run_query(plans[name])
                sync()
                warm[name, enabled].append((time.perf_counter() - t0) * 1e3)
    session.conf.set("hyperspace.analysis.validate", True)

    def spread(walls) -> dict:
        q = [float(v) for v in np.percentile(walls, [0, 25, 50, 75, 100])]
        return {"median": q[2], "p25": q[1], "p75": q[3], "min": q[0], "max": q[4]}

    for (name, enabled), walls in warm.items():
        out["warm_ms"][f"{name} validate {'on' if enabled else 'off'}"] = spread(walls)
    for name in ("Q1", "J2"):
        # Each repeat's on minus its off: what validation adds, paired.
        out["warm_ms"][f"{name} on minus off"] = spread(np.subtract(warm[name, True], warm[name, False]))
    for name, (build, code, path) in VALIDATE_EXPECT.items():
        before = (segment_reduce.launches, run_bounds.launches, topk.launches)
        try:
            session.run(build(htorch, li, orders, customer))
        except PlanValidationError as e:
            got = (e.diagnostics[0].rule, e.diagnostics[0].path)
        else:
            raise AssertionError(f"validation: {name} was not refused")
        if got != (code, path):
            raise AssertionError(f"validation: {name} refused as {got}, the JAX package's is {(code, path)}")
        if (segment_reduce.launches, run_bounds.launches, topk.launches) != before:
            raise AssertionError(f"validation: the refused {name} launched a kernel")
        out["refused"][name] = code
    log(json.dumps({"faults_validation": out}))
    return out


def _plan_nodes(plan):
    yield plan
    for c in plan.children():
        yield from _plan_nodes(c)


def corruption_phase(device, ctx: dict, sf: float) -> dict:
    """3f (b): li_live as 3e left it (two versions), its newest version's
    bucket files truncated to 7 bytes with both caches dropped. The 12
    lookups and the Q1-shaped aggregate over li_live's source equal
    pyarrow: the first lookup re-plans once (li_live quarantined,
    `fallback.queries` +1, one `fallback.replan` and one
    `index.quarantined` event), the rest plan around it. In a fresh
    session J2 re-plans once and keeps orders_orderkey; a fresh session's
    server (result cache on) answers the lookup without caching the
    re-planned result; with the fallback off a lookup raises
    IndexCorruptionError. A full refresh lifts the quarantine: the
    lookups and J2 (K2) go back through the index. Then a transient
    `bucket.read` fault (twice) under a cold J2 is retried. Returns the
    record and K1's inputs from one more run of the fallback's Q1."""
    import pandas as pd
    import pyarrow.parquet as pq
    import torch

    import hyperspace_tpu_torch as htorch
    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, PlanCache, faults, stats
    from hyperspace_tpu_torch.exceptions import IndexCorruptionError
    from hyperspace_tpu_torch.execution import device_cache as dc
    from hyperspace_tpu_torch.obs import events
    from hyperspace_tpu_torch.ops import aggregate
    from hyperspace_tpu_torch.ops.sortkeys import run_bounds

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    workdir = ctx["workdir"]
    system_path = Path(ctx["session"].conf.system_path)
    buckets = ctx["session"].conf.num_buckets

    def fresh():
        s = HyperspaceSession(system_path=str(system_path), num_buckets=buckets, device=device)
        return s.enable_hyperspace()

    # A session of its own: the earlier phases' session may still list
    # li_live as a concurrent reader cached it during 3e's refresh (the
    # listing's TTL cache; a stale entry is skipped by its signature, so
    # queries stay right but would not read the index here).
    session = fresh()
    hs = Hyperspace(session)
    live = workdir / "lineitem_live"
    grown = pq.read_table(sorted(str(p) for p in live.glob("*.parquet")))
    li = session.parquet(live)
    plans, bounds = lifecycle_plans(htorch, li, ctx["orders"], sf)
    lookups, j2 = plans["lookups"], plans["J2"][0]
    q1 = li.aggregate(Q1_GROUP, Q1_AGGS)
    root = str(system_path / LIVE_INDEX)
    o_root = str(system_path / "orders_orderkey")
    out: dict = {}

    def check(kind, name, results):
        lifecycle_check(kind, name, results, grown, ctx["o_source"], bounds, buckets)

    def ops(outcome) -> list:
        return [n.op for n in outcome.physical_plan.walk()]

    cache = PlanCache()
    k2 = run_bounds.launches
    before = session.run_query(j2, plan_cache=cache)
    sync()
    check("J2", "3f healthy J2", [before.result])
    if before.stats["join_path"] != "zero-exchange-aligned" or (device.type == "cuda" and run_bounds.launches == k2):
        raise AssertionError(f"3f healthy J2: {before.stats['join_path']}, K2 launched {run_bounds.launches - k2}")
    versions = sorted((system_path / LIVE_INDEX).glob("v__=*"), key=lambda p: int(p.name.split("=")[1]))
    newest = versions[-1]
    dc.clear_all()
    truncated = 0
    for f in sorted(newest.glob("bucket-*.parquet")):
        with open(f, "r+b") as fh:
            fh.truncate(7)
        truncated += 1
    out["truncated"] = {"version": newest.name, "versions": len(versions), "files": truncated}

    fallbacks = stats.get("fallback.queries")
    seq0 = max((e["seq"] for e in events.recent()), default=0)
    t0 = time.perf_counter()
    first = session.run_query(lookups[0], plan_cache=cache)
    sync()
    out["first_fallback_s"] = time.perf_counter() - t0
    names = [e["name"] for e in events.recent() if e["seq"] > seq0]
    if (first.replans, first.stats.get("degraded_indexes"), stats.get("fallback.queries") - fallbacks,
            names.count("fallback.replan"), names.count("index.quarantined")) != (1, [root], 1, 1, 1):
        raise AssertionError(f"3f first lookup: replans {first.replans}, degraded "
                             f"{first.stats.get('degraded_indexes')}, events {names}")
    results, walls = [first.result], []
    for plan in lookups[1:]:
        t0 = time.perf_counter()
        o = session.run_query(plan, plan_cache=cache)
        sync()
        walls.append(time.perf_counter() - t0)
        if o.replans or o.stats.get("degraded_indexes") != [root] or "IndexPointLookup" in ops(o):
            raise AssertionError(f"3f lookup after the quarantine: replans {o.replans}, ops {ops(o)}")
        results.append(o.result)
    check("lookups", "3f fallback lookups", results)
    agg = session.run_query(q1, plan_cache=cache)
    sync()
    check_q1(pd.DataFrame(agg.result.decode()), grown)
    # K1's input as the fallback's Q1 gives it: li_live's raw source.
    calls = capture_k1(lambda: session.run_query(q1, plan_cache=cache), aggregate)
    if len(calls) != 1:
        raise AssertionError(f"3f fallback Q1: {len(calls)} K1 calls, expected one")
    k1_inputs = {"fallback Q1-shaped": calls[0]}
    out["quarantined"] = {"replans": first.replans, "degraded": first.stats["degraded_indexes"],
                          "next_lookups_s": walls, "q1_replans": agg.replans,
                          "fallback_queries": stats.get("fallback.queries") - fallbacks, "events": names}

    s2 = fresh()
    t0 = time.perf_counter()
    jo = s2.run_query(j2)
    sync()
    out["j2_fallback_s"] = time.perf_counter() - t0
    roots = {leaf.root for leaf in s2.optimized_plan(j2).leaves()}
    if jo.replans != 1 or list(s2.index_health) != [root] or o_root not in roots:
        raise AssertionError(f"3f J2: replans {jo.replans}, quarantined {list(s2.index_health)}, leaves {roots}")
    check("J2", "3f fallback J2", [jo.result])
    out["j2_fallback"] = {"replans": jo.replans, "join_path": jo.stats["join_path"], "kept": o_root}

    s3 = fresh()
    with s3.serve(result_cache=True, workers=1) as server:
        first_served = server.submit(lookups[0])
        check("lookups", "3f served lookup", [first_served.result(timeout=600)])
        if first_served.profile.fallback["replans"] != 1 or server.result_cache.stats()["entries"] != 0:
            raise AssertionError("3f: a re-planned result entered the result cache")
        again = server.submit(lookups[0])
        again.result(timeout=600)
        hit = server.submit(lookups[0])
        check("lookups", "3f served lookup, cached", [hit.result(timeout=600)])
        if again.cache_hit or again.profile.fallback["replans"] != 0 or not hit.cache_hit:
            raise AssertionError("3f: the served lookup's second run was not cached, or its third missed")
        out["served"] = server.result_cache.stats()

    s4 = fresh()
    s4.conf.set("hyperspace.fallback.enabled", False)
    try:
        s4.run(lookups[0])
        raise AssertionError("3f: with the fallback off a lookup over the truncated index answered")
    except IndexCorruptionError as e:
        out["fallback_off"] = {"error": type(e).__name__, "index_root": e.index_root}
        if e.index_root != root:
            raise AssertionError(f"3f: the corruption names {e.index_root}")

    t0 = time.perf_counter()
    hs.refresh_index(LIVE_INDEX)
    sync()
    out["lift_refresh_s"] = time.perf_counter() - t0
    if session.index_health:
        raise AssertionError(f"3f: the full refresh left {list(session.index_health)} quarantined")
    results = []
    for plan in lookups:
        o = session.run_query(plan, plan_cache=cache)
        if o.replans or "IndexPointLookup" not in ops(o):
            raise AssertionError(f"3f lookup after the lift: replans {o.replans}, ops {ops(o)}")
        results.append(o.result)
    check("lookups", "3f lookups after the lift", results)
    k2 = run_bounds.launches
    jl = session.run_query(j2, plan_cache=cache)
    sync()
    check("J2", "3f J2 after the lift", [jl.result])
    if jl.replans or jl.stats["join_path"] != "zero-exchange-aligned" or (
            device.type == "cuda" and run_bounds.launches == k2):
        raise AssertionError(f"3f J2 after the lift: replans {jl.replans}, {jl.stats['join_path']}")

    dc.clear_all()
    attempts = stats.get("retry.attempts")
    faults.inject("bucket.read", times=2)
    try:
        t0 = time.perf_counter()
        jt = session.run_query(j2)
        sync()
        out["transient_j2_s"] = time.perf_counter() - t0
    finally:
        faults.reset()
    check("J2", "3f J2 under a transient read fault", [jt.result])
    if stats.get("retry.attempts") - attempts != 2 or jt.replans:
        raise AssertionError(f"3f transient fault: {stats.get('retry.attempts') - attempts} retries, "
                             f"replans {jt.replans}")
    out["transient"] = {"retries": stats.get("retry.attempts") - attempts, "replans": jt.replans}
    log(json.dumps({"faults_corruption": out}))
    return out, k1_inputs


def crash_sweep(device, ctx: dict, sf: float) -> dict:
    """3f (c): the crash sweep of tests/test_fault_injection.py:591-640 at
    the run's scale: for each of create, incremental refresh, optimize and
    vacuum, discover the fault points the action fires, then replay it
    from its set-up state (restored from a copy, in place) with a
    CrashPoint at each point's first call, and at SWEEP_LATER's later
    calls of create. After each replay: the latest stable entry resolves;
    recover converges with no orphan version dir; a second recover does
    nothing; an `o_orderkey` lookup and an aggregate by `o_orderpriority`
    (K1) equal pyarrow, through the index where it survived and through
    the source otherwise. One line an action. Also a streaming
    create (a budget of a fifth of the input) and a pooled create (2
    workers), each replayed at its points of BUILD_POINTS, once as a
    crash (a CrashPoint, or a WorkerCrashed where the worker died)
    and, for the actions of SWEEP_TRANSIENTS, once as a transient fault
    (absorbed by the retry, or a typed failure rolled back), with no
    spill or exchange dir left after any;
    and the QUERY_POINTS around a cold lookup, each as a crash and as a
    transient fault (advisory: the answer stays pyarrow's). Returns the
    record and K1's inputs from the aggregate of create's and the
    incremental refresh's first check."""
    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    import torch

    import hyperspace_tpu_torch as htorch
    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig, faults
    from hyperspace_tpu_torch import states
    from hyperspace_tpu_torch.config import DATA_VERSION_PREFIX
    from hyperspace_tpu_torch.datagen import gen_tpch_orders
    from hyperspace_tpu_torch.execution import device_cache as dc
    from hyperspace_tpu_torch.execution import io as hio
    from hyperspace_tpu_torch.metadata.data_manager import IndexDataManager
    from hyperspace_tpu_torch.metadata.log_manager import IndexLogManager
    from hyperspace_tpu_torch.ops import aggregate

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    workdir = ctx["workdir"] / "sweep"
    buckets = ctx["session"].conf.num_buckets
    col = htorch.col
    t_phase = time.perf_counter()

    def source(action: str) -> Path:
        """The action's own source directory: hard links of the run's
        orders files."""
        d = workdir / f"orders_{action}"
        d.mkdir(parents=True)
        for p in sorted((ctx["workdir"] / "orders").glob("*.parquet")):
            os.link(p, d / p.name)
        return d

    def append(src: Path) -> None:
        """Links the appended file (made once) into `src`."""
        stage = workdir / "append"
        if not stage.exists():
            gen_tpch_orders(stage, sf=SWEEP_APPEND[0] * sf, seed=SWEEP_APPEND[1], files=1)
        os.link(stage / "part-0.parquet", src / "append.parquet")

    def session_on(system_path: Path):
        return HyperspaceSession(system_path=str(system_path), num_buckets=buckets, device=device)

    from hyperspace_tpu_torch.exceptions import WorkerCrashed

    orders_files = sorted(str(p) for p in (ctx["workdir"] / "orders").glob("*.parquet"))
    scale_conf = {
        "create_streaming": {"hyperspace.index.build.memoryBudgetBytes": max(
            1, hio.estimate_uncompressed_bytes(orders_files, O_INDEXED + O_INCLUDED) // 5)},
        "create_pooled": {"hyperspace.build.workers": 2},
    }

    def drive(action: str, system_path: Path, src: Path) -> None:
        s = session_on(system_path)
        for key, value in scale_conf.get(action, {}).items():
            s.conf.set(key, value)
        hs = Hyperspace(s)
        if action.startswith("create"):
            hs.create_index(s.parquet(src), IndexConfig(SWEEP_INDEX, O_INDEXED, O_INCLUDED))
        elif action == "refresh":
            hs.refresh_index(SWEEP_INDEX, mode="incremental")
        elif action == "optimize":
            hs.optimize_index(SWEEP_INDEX)
        else:
            hs.vacuum_index(SWEEP_INDEX)
        sync()

    def restore(pristine: Path, system_path: Path) -> None:
        # A replay plays a new process: its footer cache starts empty.
        hio.clear_footer_cache()
        shutil.rmtree(system_path, ignore_errors=True)
        # Fresh copies (new inodes and mtimes): a truncation by one replay
        # never reaches the set-up state, and no cache keys on old mtimes.
        shutil.copytree(pristine, system_path, copy_function=shutil.copyfile)

    k1_inputs = {}

    def check(action: str, point: str, system_path: Path, src: Path, ref) -> dict:
        name = f"sweep {action} {point}"
        index_path = system_path / SWEEP_INDEX
        lm, dm = IndexLogManager(index_path), IndexDataManager(index_path)
        lm.get_latest_stable_log()
        s = session_on(system_path)
        hs = Hyperspace(s)
        report = hs.recover(SWEEP_INDEX)
        latest = lm.get_latest_log()
        if latest is not None:
            stable = lm.get_latest_stable_log()
            if latest.state not in states.STABLE_STATES or stable is None or stable.id != latest.id:
                raise AssertionError(f"{name}: recover left {latest.state} at {latest.id}")
            referenced = (set(stable.content.directories)
                          if stable.state != states.DOESNOTEXIST and stable.content is not None else set())
            on_disk = {f"{DATA_VERSION_PREFIX}{v}" for v in dm.get_version_ids()}
            if not on_disk <= referenced:
                raise AssertionError(f"{name}: orphan version dirs {on_disk - referenced}")
        again = hs.recover(SWEEP_INDEX)
        if again["rolled"] or again["orphans_removed"] or again["quarantined_entries"]:
            raise AssertionError(f"{name}: a second recover did {again}")
        dc.clear_all()
        s.enable_hyperspace()
        o = s.parquet(src)
        key, table = ref
        lookup = s.run_query(o.filter(col("o_orderkey") == key).select("o_orderkey", "o_totalprice"))
        _check_rows(f"{name} lookup", lookup.result, table.filter(pc.equal(table["o_orderkey"], key)).select(
            ["o_orderkey", "o_totalprice"]), ["o_orderkey", "o_totalprice"])
        agg_plan = o.aggregate(["o_orderpriority"], [("count", None, "n"), ("max", "o_totalprice", "top"),
                                                     ("sum", "o_totalprice", "total")])
        label = f"sweep {action} aggregate"
        if action in ("create", "refresh") and label not in k1_inputs:
            # K1's input as the sweep's aggregate gives it, from its first
            # run after this action's first replay.
            done = []
            calls = capture_k1(lambda: done.append(s.run_query(agg_plan)), aggregate)
            if len(calls) != 1:
                raise AssertionError(f"{name}: {len(calls)} K1 calls in the aggregate, expected one")
            k1_inputs[label] = calls[0]
            agg = done[0]
        else:
            agg = s.run_query(agg_plan)
        sync()
        want = table.group_by("o_orderpriority").aggregate([
            ("o_orderpriority", "count"), ("o_totalprice", "max"), ("o_totalprice", "sum")]).to_pandas()
        got = {k: (n, t, tot) for k, n, t, tot in zip(*(agg.result.decode()[c] for c in ("o_orderpriority", "n",
                                                                                            "top", "total")))}
        if len(got) != len(want):
            raise AssertionError(f"{name}: {len(got)} priorities, pyarrow {len(want)}")
        for k, n, t, tot in zip(want["o_orderpriority"], want["o_orderpriority_count"], want["o_totalprice_max"],
                                want["o_totalprice_sum"]):
            gn, gt, gtot = got[k]
            if gn != n or gt != t or abs(gtot - tot) > sum_tolerance(np.array([n]), np.array([tot]))[0]:
                raise AssertionError(f"{name}: priority {k} gives ({gn}, {gt}, {gtot}), pyarrow ({n}, {t}, {tot})")
        return {"report": report, "via_index": "IndexPointLookup" in [n.op for n in lookup.physical_plan.walk()]}

    out: dict = {}
    for action in SWEEP_ACTIONS:
        t0 = time.perf_counter()
        grown = action in ("refresh", "optimize")
        src = source(action)
        system_path = workdir / action / "sys"
        pristine = workdir / action / "pristine"
        system_path.mkdir(parents=True)
        if not action.startswith("create"):
            drive("create", system_path, src)
        if grown:
            append(src)
            if action == "optimize":
                drive("refresh", system_path, src)
        if action == "vacuum":
            Hyperspace(session_on(system_path)).delete_index(SWEEP_INDEX)
        shutil.copytree(system_path, pristine, copy_function=shutil.copyfile)
        table = pq.read_table(sorted(str(p) for p in src.glob("*.parquet")),
                              columns=["o_orderkey", "o_totalprice", "o_orderpriority"])
        # A key of the appended file where there is one, else of the base.
        keys = pq.read_table(src / "append.parquet", columns=["o_orderkey"]) if grown else table
        ref = (int(keys["o_orderkey"][len(keys) // 2].as_py()), table)
        setup_s = time.perf_counter() - t0
        hio.clear_footer_cache()
        with faults.recording() as seen:
            drive(action, system_path, src)
        restore(pristine, system_path)
        if action in scale_conf:
            new = sorted(set(seen) & set(BUILD_POINTS[action]))
            if len(new) != len(BUILD_POINTS[action]):
                raise AssertionError(f"sweep {action}: fired {sorted(seen)}, not all of {BUILD_POINTS[action]}")
            replays = [(p, 1) for p in new]
            transients = list(new) if action in SWEEP_TRANSIENTS else []
        else:
            replays = [(p, 1) for p in sorted(seen)]
            transients = []
        if action == "create":
            replays += list(SWEEP_LATER)
        crashed, via_index, reports, transient_outcomes = [], 0, {}, {}
        for point, call in replays:
            faults.inject(point, crash=True, at_call=call)
            try:
                drive(action, system_path, src)
            except (faults.CrashPoint, WorkerCrashed):
                crashed.append(f"{point}@{call}")
            finally:
                faults.reset()
            r = check(action, f"{point}@{call}", system_path, src, ref)
            left = [str(p) for pat in ("*.spill", "*.exchange") for p in system_path.rglob(pat)]
            if left:
                raise AssertionError(f"sweep {action} {point}: scratch left behind: {left}")
            via_index += r["via_index"]
            reports[f"{point}@{call}"] = r["report"]
            restore(pristine, system_path)
        for point in transients:
            faults.inject(point, times=1)
            try:
                drive(action, system_path, src)
                transient_outcomes[point] = "absorbed"
            except Exception as e:  # a typed failure, rolled back by Action.run
                transient_outcomes[point] = type(e).__name__
            finally:
                faults.reset()
            check(action, f"{point} transient", system_path, src, ref)
            left = [str(p) for pat in ("*.spill", "*.exchange") for p in system_path.rglob(pat)]
            if left:
                raise AssertionError(f"sweep {action} {point} transient: scratch left behind: {left}")
            restore(pristine, system_path)
        if len(crashed) != len(replays):
            missed = {f"{p}@{c}" for p, c in replays} - set(crashed)
            raise AssertionError(f"sweep {action}: no crash fired at {sorted(missed)}")
        record = {"action": action, "scale": sf, "rows": table.num_rows, "points": sorted(seen),
                  "crashes": crashed, "transients": transient_outcomes, "answered_via_index": via_index,
                  "setup_s": setup_s, "sweep_s": time.perf_counter() - t0 - setup_s, "reports": reports}
        out[action] = record
        log(json.dumps({"faults_sweep": {k: v for k, v in record.items() if k != "reports"}}))
        shutil.rmtree(pristine, ignore_errors=True)
    out["query_points"] = query_point_replays(device, ctx, sf)
    out["sweep_wall_s"] = time.perf_counter() - t_phase
    return out, k1_inputs


def query_point_replays(device, ctx: dict, sf: float) -> dict:
    """The query's fault points around a cold lookup on the aggregate
    path's index: a crash at each is a CrashPoint out of the query (the
    next query answers), a transient fault is advisory (the same answer:
    the prefetch skips the file, staging copies the column)."""
    from hyperspace_tpu_torch import col, faults, stats
    from hyperspace_tpu_torch.execution import device_cache as dc
    from hyperspace_tpu_torch.execution import prefetch

    session, li = ctx["session"], ctx["lineitem"]
    session.enable_hyperspace()
    plan = li.filter(col("l_orderkey") == 7).select("l_orderkey", "l_partkey", "l_extendedprice")

    def cold():
        dc.clear_all()
        prefetch.reset()
        return session.run_query(plan).result

    want = cold()
    out = {}
    for point in QUERY_POINTS:
        f0 = stats.get("faults.injected")
        with faults.injected(point, crash=True):
            try:
                cold()
            except faults.CrashPoint:
                crashed = True
            else:
                crashed = False
        if not crashed and (point != "device.stage" or device.type == "cuda"):
            raise AssertionError(f"query point {point}: no crash fired")
        same_result(f"query point {point} after the crash", want, cold())
        with faults.injected(point):
            got = cold()
            prefetch.drain()
        same_result(f"query point {point} transient", want, got)
        out[point] = {"crashed": crashed, "faults_fired": stats.get("faults.injected") - f0}
    return out


def faults_path(device, ctx: dict, sf: float) -> dict:
    """3f: validation on every query (a), the corruption quarantine and
    fallback (b) and the crash sweep (c), on the earlier phases' session
    and indexes. Returns the record and K1's inputs at the shapes (b) and
    (c) give it."""
    out = {}
    t0 = time.perf_counter()
    out["validation"] = validation_phase(device, ctx, sf)
    out["validation_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["corruption"], k1_inputs = corruption_phase(device, ctx, sf)
    out["corruption_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["sweep"], k1_sweep = crash_sweep(device, ctx, sf)
    out["sweep_s"] = time.perf_counter() - t0
    return out, {**k1_inputs, **k1_sweep}


# -- 3g: the build at scale -------------------------------------------------------

# BASELINE config 1's index built five ways over TPC-H lineitem: in memory
# at the default 4 GiB budget, then out of core at a budget of a fifth of
# the input: streaming with the pipeline off and on, and pooled with 2 and
# 4 worker processes. At SF5 (about 30M rows, 256 MiB): at SF10 (60M rows,
# 512 MiB) the phase took 198-331 s on the card's host, past the five
# minutes it may take, and the whole run 620-930 s of its 1,200.
BUILD_SF = 5.0
BUILD_BUDGET_AT_SF10 = 512 << 20
BUILD_INDEX = "li_scale"
BUILD_BUCKETS = 200
BUILD_APPEND = (0.05, 50)  # the appended file: a twentieth of the rows, seed
STAGE_REPEATS = 10  # cold-lookup pairs, each setting first in turn


def _worker_startup() -> dict:
    """Runs in a spawned worker of the pooled build's pool: what importing
    the worker module (torch with it) costs, and whether it touched CUDA."""
    t0 = time.perf_counter()
    import torch

    from hyperspace_tpu_torch.execution import build_exchange  # noqa: F401

    return {"import_s": time.perf_counter() - t0, "cuda_initialized": torch.cuda.is_initialized()}


def _spread(walls) -> dict:
    q = [float(v) for v in np.percentile(walls, [0, 25, 50, 75, 100])]
    return {"median": q[2], "p25": q[1], "p75": q[3], "min": q[0], "max": q[4]}


def _same_index_files(ref: Path, got: Path, name: str) -> int:
    """Every file of version dir `got` byte-identical to `ref`'s; returns
    the bytes compared."""
    names = sorted(p.name for p in ref.iterdir())
    if names != sorted(p.name for p in got.iterdir()):
        raise AssertionError(f"{name}: other files than the reference's")
    total = 0
    for n in names:
        a, b = (ref / n).read_bytes(), (got / n).read_bytes()
        if a != b:
            raise AssertionError(f"{name}: {n} differs from the reference build's")
        total += len(a)
    return total


def _same_row_multiset(ref: Path, got: Path, buckets: int, key: str) -> None:
    """The in-memory build against the streaming one (the JAX package's
    promise, tests/test_streaming_build.py): equal manifest row counts,
    keys sorted in every bucket, the same rows in every bucket."""
    from concurrent.futures import ThreadPoolExecutor

    import pyarrow.parquet as pq

    from hyperspace_tpu_torch.execution import io as hio

    if hio.read_manifest(ref)["bucketRows"] != hio.read_manifest(got)["bucketRows"]:
        raise AssertionError("in-memory build: manifest row counts differ from the streaming build's")

    def one(b: int) -> None:
        # ParquetFile, not read_table: the dataset reader would add the
        # version dir's `v__` as a partition column.
        tables = [pq.ParquetFile(d / hio.bucket_file_name(b)).read() for d in (ref, got)]
        for t in tables:
            k = t[key].to_numpy()
            if len(k) > 1 and not np.all(k[1:] >= k[:-1]):
                raise AssertionError(f"in-memory build: bucket {b} not sorted by {key}")
        order = [(c, "ascending") for c in tables[0].column_names]
        if not tables[0].sort_by(order).equals(tables[1].select(tables[0].column_names).sort_by(order)):
            raise AssertionError(f"in-memory build: bucket {b} holds other rows than the streaming build's")

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as ex:
        list(ex.map(one, range(buckets)))


def build_scale_path(device, ctx: dict, sf: float, build_sf: float = BUILD_SF) -> tuple[dict, dict]:
    """3g: the build at scale. TPC-H lineitem at `build_sf` (seed 42,
    generated by as many processes as the host has cores); BASELINE config
    1's index built five ways, each in a system path of its own through
    `create_index`: (a) in memory at the default budget, (b) streaming at
    a fifth of the input with the pipeline off, (c) the same with it on,
    (d) pooled with 2 workers, (e) with 4. (b)-(e) byte-identical, (a)
    against (b) the same rows by bucket and keys sorted; no spill or
    exchange dir left; no worker initialized CUDA. Then on (b): the 12
    lookups, the 1% range and the revenue over it by `l_orderkey` (K1),
    cold and warm, index on and off, against pyarrow; an appended
    twentieth, an incremental refresh and an optimize at the budget (the
    streaming compactor), the queries again. Then, on the aggregate
    path's SF1 index, staging and the prefetch on and off over cold
    lookups, and a transient `device.stage` fault. Returns the record and
    K1's input from the revenue aggregate."""
    import pyarrow.parquet as pq
    import torch

    import hyperspace_tpu_torch as htorch
    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig, PlanCache, native
    from hyperspace_tpu_torch.datagen import gen_tpch_lineitem
    from hyperspace_tpu_torch.execution import device_cache as dc
    from hyperspace_tpu_torch.execution import io as hio
    from hyperspace_tpu_torch.ops import aggregate
    from hyperspace_tpu_torch.parallel.procpool import TaskPool

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    workdir = ctx["workdir"] / "scale"
    dc.clear_all()
    out: dict = {"build_sf": build_sf, "cpu_count": os.cpu_count(), "native": native.available()}
    t_phase = time.perf_counter()

    # 1. The data.
    data = workdir / "lineitem"
    t0 = time.perf_counter()
    out["memory_bytes"] = gen_tpch_lineitem(data, sf=build_sf, seed=42, workers=os.cpu_count() or 1)
    out["datagen_s"] = time.perf_counter() - t0
    files = sorted(str(p) for p in data.glob("*.parquet"))
    out["rows"] = sum(pq.read_metadata(f).num_rows for f in files)
    out["disk_bytes"] = sum(os.path.getsize(f) for f in files)
    out["files"] = len(files)
    est = hio.estimate_uncompressed_bytes(files, INDEXED + INCLUDED)
    budget = int(BUILD_BUDGET_AT_SF10 * build_sf / 10)
    out["index_columns_estimate_bytes"], out["budget_bytes"] = est, budget
    log(json.dumps({"build_scale_data": out}))

    # What a pooled build's worker pays before its task: 4 spawned at once,
    # as the 4-worker build spawns them.
    t0 = time.perf_counter()
    with TaskPool("hs-startup") as pool:
        for w in range(4):
            pool.submit(w, _worker_startup)
        started = pool.join()
    if any(r["cuda_initialized"] for r in started.values()):
        raise AssertionError("a spawned worker initialized CUDA")
    out["worker_startup"] = {"workers": 4, "wall_s": time.perf_counter() - t0,
                             "import_s": sorted(r["import_s"] for r in started.values())}

    # 2-3. The five builds.
    def build(name: str, **conf):
        system_path = workdir / name
        s = HyperspaceSession(system_path=str(system_path), num_buckets=BUILD_BUCKETS, device=device)
        for key, value in conf.items():
            s.conf.set(key, value)
        t0 = time.perf_counter()
        Hyperspace(s).create_index(s.parquet(data), IndexConfig(BUILD_INDEX, INDEXED, INCLUDED))
        sync()
        wall = time.perf_counter() - t0
        st = s.last_build_stats
        left = [str(p) for pat in ("*.spill", "*.exchange") for p in system_path.rglob(pat)]
        if left:
            raise AssertionError(f"build {name}: scratch left behind: {left}")
        if st["rows"] != out["rows"]:
            raise AssertionError(f"build {name}: {st['rows']} rows of {out['rows']}")
        rec = {"wall_s": wall, **{k: v for k, v in st.items() if k != "pipeline"}}
        if "pipeline" in st:
            rec["pipeline"] = st["pipeline"]
        log(json.dumps({"build_scale_build": name, **rec}))
        return s, system_path / BUILD_INDEX / "v__=0", rec

    budget_conf = {"hyperspace.index.build.memoryBudgetBytes": budget}
    builds: dict = {}
    s_b, d_b, builds["b_streaming"] = build("b_streaming", **budget_conf,
                                            **{"hyperspace.build.pipeline.enabled": False})
    for name, conf, path in (
        ("c_pipelined", {**budget_conf, "hyperspace.build.pipeline.enabled": True}, "streaming"),
        ("d_pooled_2", {**budget_conf, "hyperspace.build.workers": 2}, "pooled"),
        ("e_pooled_4", {**budget_conf, "hyperspace.build.workers": 4}, "pooled"),
        ("a_in_memory", {}, "in-memory"),
    ):
        _, d, builds[name] = build(name, **conf)
        if builds[name]["path"] != path:
            raise AssertionError(f"build {name} took the {builds[name]['path']} path, not {path}")
        if path == "pooled" and builds[name]["worker_cuda_initialized"]:
            raise AssertionError(f"build {name}: a worker initialized CUDA")
        if name == "a_in_memory":
            _same_row_multiset(d_b, d, BUILD_BUCKETS, INDEXED[0])
        else:
            builds[name]["identical_bytes"] = _same_index_files(d_b, d, name)
        shutil.rmtree(workdir / name)
    if builds["b_streaming"]["path"] != "streaming":
        raise AssertionError("build b took the in-memory path under the budget")
    out["builds"] = builds
    for w in (2, 4):
        name = f"{'d' if w == 2 else 'e'}_pooled_{w}"
        out[f"pooled_{w}_speedup_over_serial_streaming"] = builds["b_streaming"]["wall_s"] / builds[name]["wall_s"]

    # 4. The queries on the streamed index.
    grown = pq.read_table(files, columns=["l_orderkey", "l_partkey", "l_extendedprice", "l_discount"])
    df = s_b.parquet(data)
    plans, bounds = lifecycle_plans(htorch, df, ctx["orders"], build_sf)
    del plans["J2"]  # no join in 3g
    cache = PlanCache()
    k1_inputs: dict = {}

    def queries(stage: str, warm: bool = True) -> dict:
        rec = {}
        for mode in ("index", "no_index"):
            s_b.enable_hyperspace() if mode == "index" else s_b.disable_hyperspace()
            for name, qs in plans.items():
                label = f"3g {stage} {name} {mode}"
                dc.clear_all()
                if warm:
                    results, _, timing = cold_warm(label, s_b, qs, cache, sync, tolerant=("rev",))
                else:
                    t0 = time.perf_counter()
                    outcomes = [s_b.run_query(q, plan_cache=cache) for q in qs]
                    sync()
                    results = [o.result for o in outcomes]
                    timing = {"cold_s": time.perf_counter() - t0,
                              "warm_stats": {k: outcomes[-1].stats[k] for k in ("scan", "files_read",
                                                                                "files_pruned", "rows_pruned")}}
                lifecycle_check(name, label, results, grown, None, bounds, BUILD_BUCKETS)
                st = timing["warm_stats"]
                if mode == "index" and name == "lookups" and (st["scan"] != "IndexPointLookup"
                                                               or st["files_pruned"] != BUILD_BUCKETS - 1):
                    raise AssertionError(f"{label}: the lookup did not read 1 of {BUILD_BUCKETS} files: {st}")
                rec[f"{name}_{mode}"] = timing
        s_b.enable_hyperspace()
        return rec

    out["queries"] = queries("streamed")
    calls = capture_k1(lambda: s_b.run(plans["range_agg"][0]), aggregate)
    if len(calls) != 1:
        raise AssertionError(f"3g revenue: {len(calls)} K1 calls, expected one")
    k1_inputs[f"3g revenue over the 1% range (SF{build_sf:g} streamed index)"] = calls[0]

    # 5. Refresh and compact past memory.
    stage = workdir / "append"
    gen_tpch_lineitem(stage, sf=BUILD_APPEND[0] * build_sf, seed=BUILD_APPEND[1], files=1)
    (stage / "part-0.parquet").rename(data / "append.parquet")
    files = sorted(str(p) for p in data.glob("*.parquet"))
    grown = pq.read_table(files, columns=["l_orderkey", "l_partkey", "l_extendedprice", "l_discount"])
    hs_b = Hyperspace(s_b)
    for action, call in (("refresh_incremental", lambda: hs_b.refresh_index(BUILD_INDEX, mode="incremental")),
                         ("optimize", lambda: hs_b.optimize_index(BUILD_INDEX))):
        t0 = time.perf_counter()
        call()
        sync()
        st = s_b.last_build_stats
        out[action] = {"wall_s": time.perf_counter() - t0, "path": st["path"], "rows": st["rows"],
                       "phases_s": st["phases_s"], "bytes_estimate": st.get("bytes_estimate")}
        log(json.dumps({"build_scale_action": action, **out[action]}))
    if out["optimize"]["path"] != "streaming" or out["optimize"]["rows"] != grown.num_rows:
        raise AssertionError(f"optimize past memory: {out['optimize']}, {grown.num_rows} rows")
    entry = next(e for e in s_b.manager.get_indexes() if e.name == BUILD_INDEX)
    (live,) = entry.content.directories
    left = sorted((workdir / "b_streaming" / BUILD_INDEX / live).glob("bucket-*.parquet"))
    if len(left) != BUILD_BUCKETS:
        raise AssertionError(f"optimize left {len(left)} files for {BUILD_BUCKETS} buckets")
    out["queries_after_optimize"] = queries("optimized", warm=False)
    del grown
    shutil.rmtree(workdir, ignore_errors=True)

    # 6. Staging and the prefetch on the aggregate path's SF1 index.
    out["staging"] = staging_and_prefetch(device, ctx, sf, sync)
    out["build_scale_path_s"] = time.perf_counter() - t_phase
    return out, k1_inputs


def staging_and_prefetch(device, ctx: dict, sf: float, sync) -> dict:
    """3g (6): the aggregate path's 12 cold indexed lookups (both caches
    emptied first) with zero-copy staging on and off, then with the
    query-tail prefetch on and off, STAGE_REPEATS pairs each, the setting
    that runs first alternating; the staging counters of one cold pass;
    and a cold pass under a transient `device.stage` fault (every column
    takes the copied path, the answers stay the same)."""
    from hyperspace_tpu_torch import col, faults, stats
    from hyperspace_tpu_torch.datagen import TPCH_SF1_ORDERS_ROWS
    from hyperspace_tpu_torch.execution import device_cache as dc
    from hyperspace_tpu_torch.execution import prefetch

    session, li = ctx["session"], ctx["lineitem"]
    session.enable_hyperspace()
    keys = np.random.default_rng(7).integers(0, int(TPCH_SF1_ORDERS_ROWS * sf), 12).astype(np.int64)
    plans = [li.filter(col("l_orderkey") == int(k)).select("l_orderkey", "l_partkey", "l_extendedprice")
             for k in keys]

    def cold() -> tuple[float, list]:
        dc.clear_all()
        prefetch.reset()
        t0 = time.perf_counter()
        results = [session.run_query(p).result for p in plans]
        sync()
        return (time.perf_counter() - t0) * 1e3, results

    def counters():
        return stats.get("device.stage.bytes_zero_copy"), stats.get("device.stage.bytes_copied")

    out: dict = {}
    z0, c0 = counters()
    _, want = cold()
    z1, c1 = counters()
    out["one_cold_pass"] = {"bytes_zero_copy": z1 - z0, "bytes_copied": c1 - c0}
    for key, setting in (("hyperspace.device.staging.enabled", "staging"),
                         ("hyperspace.scan.prefetch.enabled", "prefetch")):
        walls = {True: [], False: []}
        for repeat in range(STAGE_REPEATS):
            for on in ((True, False) if repeat % 2 == 0 else (False, True)):
                session.conf.set(key, on)
                ms, got = cold()
                walls[on].append(ms)
                for a, b in zip(want, got):
                    same_result(f"cold lookups, {setting} {on}", a, b)
        session.conf.set(key, True)
        out[f"cold_lookups_ms_{setting}_on"] = _spread(walls[True])
        out[f"cold_lookups_ms_{setting}_off"] = _spread(walls[False])
        out[f"cold_lookups_ms_{setting}_on_minus_off"] = _spread(np.subtract(walls[True], walls[False]))
    z0, c0 = counters()
    with faults.injected("device.stage"):
        _, got = cold()
    z1, c1 = counters()
    if device.type == "cuda" and (z1 != z0 or c1 == c0):
        raise AssertionError(f"device.stage fault: {z1 - z0} bytes zero-copy, {c1 - c0} copied")
    for a, b in zip(want, got):
        same_result("cold lookups under a device.stage fault", a, b)
    out["under_stage_fault"] = {"bytes_zero_copy": z1 - z0, "bytes_copied": c1 - c0}
    log(json.dumps({"build_scale_staging": out}))
    return out


# Phase 3h: the fleet on the card. N server processes over the one store,
# each a spawned member with its own CUDA context, device cache and
# derived cache, serving 3e's mix (benchmarks/bench_serve.py's fleet mode,
# its four regimes, and the controller).
FLEET_PASSES = 16  # passes of the mix in each throughput window (288 queries)
FLEET_WINDOWS = 2  # throughput windows at each fleet size
FLEET_CLIENTS = 16  # client threads in all, split evenly over the members
FLEET_SIZES = (2, 4)
FLEET_WORKERS = 4  # each server's worker threads, as in 3e
# The index-entry listing's TTL in the members' sessions: another
# process's refresh reaches a member's listing within it (ROADMAP queue 3's
# stale listing: with the default 300 s a member plans around an index for
# five minutes after another process refreshed it).
FLEET_EXPIRY_S = 2.0
FLEET_APPEND = (0.02, 51)  # (c)'s appended file: a fiftieth, seed 51
FLEET_LOOP_CLIENTS = 8  # (c)'s looping clients in each member
# (d): an instant burst of 64 submits across 4 tenants, each tenant's
# bucket 8 tokens at 5 a second, a queue of 16 shedding ordinary submits
# at 8.
FLEET_BURST = (64, 4, 5.0, 8, 16, 0.5)
# The admitted burst's p99 must stay under it: the prediction, with
# margin over the H100's readings of 72-141 ms a member.
FLEET_BURST_P99_MS = 1_000.0
FLEET_LEASE_TTL_S = 2.0  # (d)'s takeover: the killed holder's lease TTL
# (e): a 99% availability objective, so that 20 failed lookups page in
# both windows (burn 100, page at 14.4) and 240 clean ones end the page
# (20 / 260 = 7.7% bad, burn 7.7); the controller ticks every 0.2 s.
FLEET_FAIL_BURST = 20
FLEET_CLEAN = 240
FLEET_CONTROLLER_CONF = {
    "hyperspace.controller.enabled": True,
    "hyperspace.controller.intervalSeconds": 0.2,
    "hyperspace.controller.cooldownSeconds": 1.0,
    "hyperspace.obs.slo.availabilityTarget": 0.99,
    "hyperspace.obs.journal.enabled": True,
    "hyperspace.obs.journal.segmentBytes": 4096,
    "hyperspace.obs.http.enabled": True,
}
FLEET_WAIT_S = 60.0  # the longest a phase waits for a member's answer (start-up: 180)


def _arrow_served(name: str, got, want, rows: int) -> None:
    """A result served by another process (a ColumnTable) against its
    serial run's Arrow table: equal values but in the sums and means of
    SERVE_SUMS, within 2·rows·u of the serial value (check_served's rule;
    string columns compare as strings, since each process encodes its own
    dictionaries)."""
    import pyarrow.compute as pc

    got = got.to_arrow()
    if got.schema.names != want.schema.names or got.num_rows != want.num_rows:
        raise AssertionError(f"{name}: {got.num_rows} rows of {got.schema.names}, serially {want.num_rows} of "
                             f"{want.schema.names}")
    sums = SERVE_SUMS.get(name.split()[0], {})
    for c in want.schema.names:
        a, b = got.column(c), want.column(c)
        if c not in sums:
            if not a.equals(b):
                raise AssertionError(f"{name}: the served {c} differs from the serial run's")
            continue
        if not pc.is_valid(a).equals(pc.is_valid(b)):
            raise AssertionError(f"{name}: the served {c}'s nulls differ from the serial run's")
        x = pc.fill_null(a, 0.0).to_numpy()
        y = pc.fill_null(b, 0.0).to_numpy()
        if not np.all(np.abs(x - y) <= 2 * rows * UNIT_ROUNDOFF * np.abs(y)):
            raise AssertionError(f"{name}: the served {c} is beyond 2·N·u of the serial run's")


def _drain(server, plans: dict, work_q, n_clients: int, started) -> list:
    """`n_clients` threads pull plan names from `work_q` until a None,
    submit each to `server` and keep (name, ms submit to result,
    completion time, result); `started()` runs once every thread is
    pulling. Raises a client's first error."""
    import threading

    done, errors, lock = [], [], threading.Lock()

    def client():
        mine = []
        try:
            while (name := work_q.get(timeout=FLEET_WAIT_S)) is not None:
                t0 = time.perf_counter()
                result = server.submit(plans[name]).result(timeout=600)
                mine.append((name, (time.perf_counter() - t0) * 1e3, time.time(), result))
        except BaseException as e:  # re-raised below
            errors.append(e)
        with lock:
            done.extend(mine)

    threads = [threading.Thread(target=client) for _ in range(n_clients)]
    for t in threads:
        t.start()
    started()
    for t in threads:
        t.join(timeout=900)
    if errors:
        raise errors[0]
    return done


def _member_counts() -> dict:
    from hyperspace_tpu_torch.ops.segment_reduce import segment_reduce
    from hyperspace_tpu_torch.ops.sortkeys import run_bounds
    from hyperspace_tpu_torch.ops.topk import topk

    return {"segment_reduce": segment_reduce.launches, "run_bounds": run_bounds.launches, "topk": topk.launches}


def _member_delta(before: dict) -> dict:
    now = _member_counts()
    return {k: now[k] - before[k] for k in now}


def fleet_member(wctx, spec: dict, cmd_qs, result_q, work_q, loop_stop) -> None:
    """One fleet member (a spawned process): opens its CUDA context (or
    raises: a member never serves from the CPU unless `spec` asks for it),
    loads the kernels built in phase 1, opens a session over the store and
    a server over the fleet's shared plan cache, runs the mix once (its
    start-up), then answers the coordinator's commands until told to stop.
    Every answer goes to `result_q` as (worker id, pid, command, record)."""
    import queue as queue_mod
    import traceback

    wid, pid = wctx.worker_id, os.getpid()
    try:
        state = _member_start(wctx, spec, time.time())
    except BaseException as e:  # posted, then the process exits non-zero
        result_q.put((wid, pid, "error", f"start-up: {type(e).__name__}: {e}\n{traceback.format_exc()}"))
        raise SystemExit(1)
    state.update(result_q=result_q, work_q=work_q, loop_stop=loop_stop, wid=wid, pid=pid)
    result_q.put((wid, pid, "ready", state["startup"]))
    while not wctx.stop_event.is_set():
        try:
            cmd = cmd_qs[wid].get(timeout=0.2)
        except queue_mod.Empty:
            continue
        if cmd[0] == "stop":
            break
        try:
            out = _MEMBER_OPS[cmd[0]](state, *cmd[1:])
            out["launches_total"] = _member_counts()
            result_q.put((wid, pid, cmd[0], out))
        except BaseException as e:  # posted; the coordinator fails the phase
            result_q.put((wid, pid, "error", f"{cmd[0]}: {type(e).__name__}: {e}\n{traceback.format_exc()}"))
    for key in ("controller",):
        if state.get(key) is not None:
            state[key].stop()
    for key in ("server", "rc_server", "burst_server", "ctl_server"):
        if state.get(key) is not None:
            state[key].shutdown()


def _member_start(wctx, spec: dict, t_enter: float) -> dict:
    import pyarrow as pa
    import torch

    from hyperspace_tpu_torch import HyperspaceSession
    from hyperspace_tpu_torch.execution import device_cache as dc
    from hyperspace_tpu_torch.ops import kernels
    from hyperspace_tpu_torch.plan.nodes import plan_from_json
    from hyperspace_tpu_torch.serve import fleet

    startup = {"spawn_to_entry_s": t_enter - spec["spawned_at"][wctx.worker_id]}
    t0 = time.perf_counter()
    if spec["device"] == "cuda":
        torch.cuda.init()
        torch.zeros(1, device="cuda")  # the context; raises where the card refuses one
        startup["cuda_init_s"] = time.perf_counter() - t0
        startup["libraries_prebuilt"] = all(kernels.library_path(n).exists() for n in kernels.SOURCES)
        t0 = time.perf_counter()
        kernels.build()
        startup["kernel_build_s"] = time.perf_counter() - t0
    session = HyperspaceSession(system_path=spec["system_path"], device=None if spec["device"] == "cuda" else "cpu")
    for key, value in spec["conf"].items():
        session.conf.set(key, value)
    session.conf.set("hyperspace.index.cache.expiryDurationInSeconds", FLEET_EXPIRY_S)
    if spec["http"]:
        session.conf.set("hyperspace.obs.http.enabled", True)
    session.enable_hyperspace()
    plans = {name: plan_from_json(doc) for name, doc in spec["mix"].items()}
    serial = {}
    for name in plans:
        with pa.memory_map(str(Path(spec["serial_dir"]) / f"{list(plans).index(name)}.arrow"), "r") as src:
            serial[name] = pa.ipc.open_file(src).read_all()
    shared_plans, shared_results = fleet.shared_caches(session)
    server = session.serve(workers=FLEET_WORKERS, plan_cache=shared_plans, result_cache=False)
    if spec["http"]:
        fleet.register_worker(wctx.fleet_dir, wctx.worker_id, server.health_endpoint.port)
    state = {"session": session, "plans": plans, "serial": serial, "rows": spec["rows"], "server": server,
             "shared_plans": shared_plans, "shared_results": shared_results, "spec": spec, "fleet_dir": wctx.fleet_dir,
             "device": session.device}
    # Start-up's last step: the mix once, serially, each result checked
    # (the member's cold reads and derivations).
    c0, t0 = _member_counts(), time.perf_counter()
    for name, plan in plans.items():
        _arrow_served(name, session.run_query(plan, plan_cache=shared_plans).result, serial[name], spec["rows"])
    if spec["device"] == "cuda":
        torch.cuda.synchronize()
    startup["warm_pass_s"] = time.perf_counter() - t0
    startup["warm_pass_launches"] = _member_delta(c0)
    startup["ready_at"] = time.time()
    startup["spawn_to_ready_s"] = startup["ready_at"] - spec["spawned_at"][wctx.worker_id]
    startup["cuda_initialized"] = torch.cuda.is_initialized()
    startup["device_name"] = torch.cuda.get_device_name(0) if spec["device"] == "cuda" else "cpu"
    startup["derived"] = {k: dc.HOST_DERIVED.stats()[k] for k in ("hits", "misses")}
    state["startup"] = startup
    return state


def _op_pass(state, n_clients: int) -> dict:
    """One throughput window's share: `_drain` over the fleet's work
    queue, every result then checked."""
    from hyperspace_tpu_torch.execution import device_cache as dc

    d0, c0 = dc.HOST_DERIVED.stats(), _member_counts()
    done = _drain(state["server"], state["plans"], state["work_q"], n_clients,
                  lambda: state["result_q"].put((state["wid"], state["pid"], "armed", {})))
    launches = _member_delta(c0)
    d1 = dc.HOST_DERIVED.stats()
    for name, _, _, result in done:
        _arrow_served(name, result, state["serial"][name], state["rows"])
    return {"served": [(name, ms, t) for name, ms, t, _ in done], "launches": launches,
            "derived_hits": d1["hits"] - d0["hits"], "derived_misses": d1["misses"] - d0["misses"]}


def _op_result_cache(state, name: str) -> dict:
    """`name` through a server with the fleet's shared result cache: the
    result, whether it was a hit, the kernels launched and the columns
    read (device-cache misses) for it."""
    from hyperspace_tpu_torch.execution import device_cache as dc

    if state.get("rc_server") is None:
        state["rc_server"] = state["session"].serve(workers=1, plan_cache=state["shared_plans"],
                                                    result_cache=state["shared_results"])
    c0, m0 = _member_counts(), dc.DEVICE_CACHE.stats()["misses"]
    h = state["rc_server"].submit(state["plans"][name])
    result = h.result(timeout=600)
    launched = _member_delta(c0)
    _arrow_served(name, result, state["serial"][name], state["rows"])
    return {"cache_hit": bool(h.cache_hit), "launches": launched,
            "columns_read": dc.DEVICE_CACHE.stats()["misses"] - m0, "device": str(result.device)}


def _op_loop(state, plans_json: dict, cols: list) -> dict:
    """FLEET_LOOP_CLIENTS threads loop the li_live lookups until the
    fleet's loop_stop is set, keeping (submit time, key, rows)."""
    import threading

    from hyperspace_tpu_torch.plan.nodes import plan_from_json

    plans = {int(k): plan_from_json(doc) for k, doc in plans_json.items()}
    keys = sorted(plans)
    seen, errors, lock = [], [], threading.Lock()

    def client(cid: int):
        mine, i = [], cid
        try:
            while not state["loop_stop"].is_set():
                k = keys[i % len(keys)]
                i += 1
                t_submit = time.time()
                d = state["server"].submit(plans[k]).result(timeout=600).decode()
                mine.append((t_submit, k, sorted(zip(*(np.asarray(d[c]).tolist() for c in cols)))))
        except BaseException as e:  # reported below
            errors.append(repr(e))
        with lock:
            seen.extend(mine)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(FLEET_LOOP_CLIENTS)]
    for t in threads:
        t.start()
    state["result_q"].put((state["wid"], state["pid"], "armed", {}))
    for t in threads:
        t.join(timeout=600)
    if errors:
        raise AssertionError(f"member {state['wid']}: {errors[0]}")
    return {"seen": seen}


def _op_burst(state) -> dict:
    """(d): an instant burst through a server with tenant quotas and a
    shed ratio: every refusal typed, the admitted answers right, their
    submit-to-result latencies kept."""
    from hyperspace_tpu_torch.exceptions import AdmissionRejected, QuotaExceeded
    from hyperspace_tpu_torch.serve.fleet.quota import TenantQuotas

    n, tenants, rate, burst, depth, ratio = FLEET_BURST
    if state.get("burst_server") is None:
        state["burst_server"] = state["session"].serve(
            workers=FLEET_WORKERS, max_queue_depth=depth, shed_depth_ratio=ratio,
            plan_cache=state["shared_plans"], result_cache=False, quotas=TenantQuotas(rate=rate, burst=burst))
    server = state["burst_server"]
    lookups = [name for name in state["plans"] if name.startswith("lookup")]
    admitted, refused, untyped = [], {"quota": 0, "shed_or_full": 0}, []
    for i in range(n):
        name = lookups[i % len(lookups)]
        t0 = time.perf_counter()
        try:
            admitted.append((name, t0, server.submit(state["plans"][name], tenant=f"t{i % tenants}")))
        except QuotaExceeded:
            refused["quota"] += 1
        except AdmissionRejected:
            refused["shed_or_full"] += 1
        except Exception as e:  # fails the phase on the coordinator
            untyped.append(repr(e))
    done_at: dict = {}
    deadline = time.perf_counter() + 600
    while len(done_at) < len(admitted) and time.perf_counter() < deadline:
        for i, (_, _, h) in enumerate(admitted):
            if i not in done_at and h.done():
                done_at[i] = time.perf_counter()
        time.sleep(0.001)
    for name, _, h in admitted:
        _arrow_served(name, h.result(timeout=600), state["serial"][name], state["rows"])
    lat = np.sort([(done_at[i] - t0) * 1e3 for i, (_, t0, _) in enumerate(admitted)])
    return {"submitted": n, "admitted": len(admitted), "refused": refused, "untyped": untyped,
            "p50_ms": float(np.percentile(lat, 50)) if len(lat) else None,
            "p99_ms": float(np.percentile(lat, 99)) if len(lat) else None,
            "saturation": server.saturation()}


def _op_hold_lease(state, key: str) -> dict:
    """(d): take the single-flight lease for `key` under the fleet's
    directory and hold it, building forever (the coordinator kills this
    member)."""
    from hyperspace_tpu_torch.serve.fleet.singleflight import SingleFlight

    def build():
        state["result_q"].put((state["wid"], state["pid"], "held", {}))
        time.sleep(600)

    SingleFlight(Path(state["fleet_dir"]) / "sf", lease_ttl_s=FLEET_LEASE_TTL_S, wait_s=1.0).run(key, build)
    return {}


def _op_takeover(state, key: str) -> dict:
    from hyperspace_tpu_torch import stats
    from hyperspace_tpu_torch.obs import events
    from hyperspace_tpu_torch.serve.fleet.singleflight import SingleFlight

    t0 = time.perf_counter()
    value = SingleFlight(Path(state["fleet_dir"]) / "sf", lease_ttl_s=FLEET_LEASE_TTL_S, wait_s=30.0).run(
        key, build=lambda: "taken over")
    return {"value": value, "wait_s": time.perf_counter() - t0, "takeovers": stats.get("fleet.singleflight.takeovers"),
            "events": [e["fields"] for e in events.recent() if e["name"] == "fleet.singleflight.takeover"]}


def _op_controller(state) -> dict:
    """(e): the controller, the journal and the HTTP plane on, over a
    server of its own with tenant quotas (the throttle's actuator)."""
    from hyperspace_tpu_torch import Hyperspace
    from hyperspace_tpu_torch.serve.fleet.quota import TenantQuotas

    session = state["session"]
    for key, value in FLEET_CONTROLLER_CONF.items():
        session.conf.set(key, value)
    session.conf.set("hyperspace.obs.journal.dir", state["spec"]["journal_dir"])
    state["ctl_server"] = session.serve(workers=FLEET_WORKERS, max_queue_depth=32, plan_cache=state["shared_plans"],
                                        result_cache=False, quotas=TenantQuotas())
    state["controller"] = Hyperspace(session).controller(server=state["ctl_server"],
                                                         member_id=f"member-{state['wid']}").start()
    return {"port": state["ctl_server"].health_endpoint.port, "snapshot": state["controller"].snapshot()}


def _wait_for(cond, timeout: float) -> float | None:
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if cond():
            return time.perf_counter() - t0
        time.sleep(0.02)
    return None


def _clients(server, plans: list, n_threads: int) -> list:
    """Submit `plans` from `n_threads` threads, each in turn; returns the
    (plan index, result or exception) of every one."""
    import threading

    out, lock = [], threading.Lock()

    def client(cid: int):
        mine = []
        for i in range(cid, len(plans), n_threads):
            try:
                mine.append((i, server.submit(plans[i]).result(timeout=600)))
            except Exception as e:  # counted by the caller
                mine.append((i, e))
        with lock:
            out.extend(mine)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return out


def _op_fail_burst(state) -> dict:
    """(e) 1: a `bucket.read` error rule with retry and the fallback off
    and both caches emptied, under FLEET_FAIL_BURST lookups: they fail,
    the availability SLO pages, the controller engages shed and throttle;
    the rule cleared, FLEET_CLEAN lookups succeed and it releases both."""
    from hyperspace_tpu_torch import faults
    from hyperspace_tpu_torch.execution import device_cache as dc
    from hyperspace_tpu_torch.utils import retry

    session, server, ctrl = state["session"], state["ctl_server"], state["controller"]
    lookups = [name for name in state["plans"] if name.startswith("lookup")]
    max_depth = server.max_queue_depth
    out = {"shed_depth_before": server.get_shed_depth(), "throttle_before": server.quotas.throttle()}
    # The retry key sets the process's policy (the key itself reads None
    # until set), so the attempts are saved from the policy.
    attempts, fallback = retry.io_policy().max_attempts, session.conf.get("hyperspace.fallback.enabled")
    session.conf.set("hyperspace.retry.maxAttempts", 1)
    session.conf.set("hyperspace.fallback.enabled", False)
    dc.clear_all()
    faults.inject("bucket.read")
    try:
        got = _clients(server, [state["plans"][lookups[i % len(lookups)]] for i in range(FLEET_FAIL_BURST)], 4)
    finally:
        faults.reset()
        session.conf.set("hyperspace.retry.maxAttempts", attempts)
        session.conf.set("hyperspace.fallback.enabled", fallback)
    out["failed"] = sum(isinstance(r, Exception) for _, r in got)
    out["engage_s"] = _wait_for(lambda: ctrl.snapshot()["engaged"], 10.0)
    out["shed_depth_engaged"], out["throttle_engaged"] = server.get_shed_depth(), server.quotas.throttle()
    out["verdicts_engaged"] = ctrl.snapshot()["verdicts"]
    names = [lookups[i % len(lookups)] for i in range(FLEET_CLEAN)]
    got = _clients(server, [state["plans"][n] for n in names], 4)
    bad = [r for _, r in got if isinstance(r, Exception)]
    if bad:
        raise AssertionError(f"a clean lookup failed: {bad[0]!r}")
    for i, result in got:
        _arrow_served(names[i], result, state["serial"][names[i]], state["rows"])
    out["release_s"] = _wait_for(lambda: not ctrl.snapshot()["engaged"], 10.0)
    out["shed_depth_released"], out["throttle_released"] = server.get_shed_depth(), server.quotas.throttle()
    out["max_queue_depth"] = max_depth
    out["snapshot"] = ctrl.snapshot()
    return out


def _op_conf(state, key: str, value) -> dict:
    state["session"].conf.set(key, value)
    return {}


def _op_query(state, names: list) -> dict:
    """Run `names` through `run_query` and the shared plan cache: each
    result checked, with its join path, replans and the kernels launched."""
    from hyperspace_tpu_torch import stats

    out = {}
    for name in names:
        c0 = _member_counts()
        outcome = state["session"].run_query(state["plans"][name], plan_cache=state["shared_plans"])
        _arrow_served(name, outcome.result, state["serial"][name], state["rows"])
        out[name] = {"replans": outcome.replans, "join_path": outcome.stats.get("join_path"),
                     "launches": _member_delta(c0)}
    # The quarantine as the last query left it.
    out["quarantined"] = sorted(Path(r).name for r in outcome.stats.get("degraded_indexes", []))
    out["fallback_queries"] = stats.get("fallback.queries")
    return out


def _op_heal(state) -> dict:
    """(e) 2: arm the controller and wait (60 s at most) for the
    quarantine to lift; the heal's audit records and counters."""
    from hyperspace_tpu_torch import stats
    from hyperspace_tpu_torch.obs import events

    session = state["session"]
    session.conf.set("hyperspace.controller.enabled", True)

    def audit() -> list:
        return [e["fields"] for e in events.recent() if e["name"] == "controller.actuation"
                and str(e["fields"].get("action", "")).startswith("heal.")]

    # The audit record lands once the whole actuation returned (the
    # quarantine lifts earlier, at its first step, recover); the next
    # queries show the quarantine gone.
    waited = _wait_for(lambda: bool(audit()), 60.0)
    return {"heal_s": waited, "heals": stats.get("controller.heals"), "actuations": stats.get("controller.actuations"),
            "budget_remaining": state["controller"].snapshot()["budget_remaining"], "audit": audit()}


def _op_report(state) -> dict:
    import torch

    from hyperspace_tpu_torch import stats
    from hyperspace_tpu_torch.execution import device_cache as dc

    out = {"derived": {k: dc.HOST_DERIVED.stats()[k] for k in ("hits", "misses", "evictions", "bytes")},
           "device_cache": {k: dc.DEVICE_CACHE.stats()[k] for k in ("hits", "misses", "evictions", "bytes")},
           "shared_cache": {k: stats.get(f"fleet.shared_cache.{k}") for k in ("hits", "misses", "errors")},
           "cuda_initialized": torch.cuda.is_initialized()}
    if state["spec"]["device"] == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        out["memory_reserved"] = torch.cuda.memory_reserved()
    if state.get("controller") is not None:
        out["controller"] = state["controller"].snapshot()
    return out


_MEMBER_OPS = {"pass": _op_pass, "result_cache": _op_result_cache, "loop": _op_loop, "burst": _op_burst,
               "hold_lease": _op_hold_lease, "takeover": _op_takeover, "controller": _op_controller,
               "fail_burst": _op_fail_burst, "conf": _op_conf, "query": _op_query, "heal": _op_heal,
               "report": _op_report}


class _Fleet:
    """The coordinator's handle on one fleet: its supervisor, the
    members' command queues, the shared result and work queues, and the
    answers it has read."""

    def __init__(self, name: str, n: int, spec: dict, workdir: Path):
        from hyperspace_tpu_torch.parallel.procpool import spawn_context
        from hyperspace_tpu_torch.serve.fleet import FleetSupervisor

        mp = spawn_context()
        self.name, self.n = name, n
        self.cmd_qs = [mp.Queue() for _ in range(n)]
        self.result_q, self.work_q, self.loop_stop = mp.Queue(), mp.Queue(), mp.Event()
        self.spec = dict(spec, spawned_at=[0.0] * n)
        self.fleet_dir = workdir / f"fleet_{name}"
        self.sup = FleetSupervisor(fleet_member, fleet_dir=str(self.fleet_dir), n=n,
                                   args=(self.spec, self.cmd_qs, self.result_q, self.work_q, self.loop_stop),
                                   max_restarts=2, restart_backoff=0.5)
        self.ready: dict = {}
        self.respawned: list = []
        self.last_launches: dict = {}
        self._pending: list = []

    def start(self) -> None:
        self.spec["spawned_at"][:] = [time.time()] * self.n
        self.sup.start()

    def _read(self, timeout: float):
        import queue as queue_mod

        try:
            wid, pid, op, rec = self.result_q.get(timeout=timeout)
        except queue_mod.Empty:
            raise AssertionError(f"fleet {self.name}: no member answered within {timeout:.0f} s "
                                 f"(alive {self.sup.alive_count()} of {self.n})") from None
        if op == "error":
            raise AssertionError(f"fleet {self.name} member {wid} (pid {pid}): {rec}")
        if op == "ready":
            if wid in self.ready:
                self.respawned.append({"worker": wid, "pid": pid, **rec})
            else:
                self.ready[wid] = {"pid": pid, **rec}
        if isinstance(rec, dict) and "launches_total" in rec:
            self.last_launches[pid] = rec["launches_total"]
        return wid, pid, op, rec

    def await_ready(self, timeout: float) -> None:
        deadline = time.perf_counter() + timeout
        while len(self.ready) < self.n:
            self._read(max(1.0, deadline - time.perf_counter()))

    def send(self, wids, *cmd) -> None:
        for wid in wids:
            self.cmd_qs[wid].put(cmd)

    def collect(self, wids, op: str, timeout: float = FLEET_WAIT_S) -> dict:
        """Each of `wids`' answer to `op` (worker id -> record)."""
        out = {}
        deadline = time.perf_counter() + timeout
        keep = []
        for item in self._pending:
            if item[2] == op and item[0] in wids and item[0] not in out:
                out[item[0]] = item[3]
            else:
                keep.append(item)
        self._pending = keep
        while set(out) != set(wids):
            item = self._read(max(1.0, deadline - time.perf_counter()))
            if item[2] == op and item[0] in wids and item[0] not in out:
                out[item[0]] = item[3]
            elif item[2] != "ready":
                self._pending.append(item)
        return out

    def ask(self, wids, *cmd, timeout: float = FLEET_WAIT_S) -> dict:
        self.send(wids, *cmd)
        return self.collect(wids, cmd[0], timeout)

    def stop(self, timeout: float = 30.0) -> None:
        """Tell every member to stop, read what they still post (a member
        exits only once its queue is flushed), then stop the supervisor."""
        import queue as queue_mod

        self.send(range(self.n), "stop")
        deadline = time.perf_counter() + timeout
        while self.sup.alive_count() and time.perf_counter() < deadline:
            try:
                self.result_q.get(timeout=0.1)
            except queue_mod.Empty:
                pass
        self.sup.stop(timeout=1.0)


def _window(served: list, t_fill: float) -> dict:
    """qps and latency percentiles of one throughput window: every served
    (name, ms, completion time) against the time the queue was filled."""
    lat = np.sort([ms for _, ms, _ in served])
    wall = max(t for _, _, t in served) - t_fill
    by_query: dict = {}
    for name, ms, _ in served:
        by_query.setdefault(name.split()[0], []).append(ms)
    return {"queries": len(served), "wall_s": wall, "throughput_qps": len(served) / wall,
            "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
            "p99_ms": float(np.percentile(lat, 99)), "by_query_ms": {q: float(np.median(v)) for q, v in by_query.items()}}


def _filler(work_q, names: list, n_clients: int):
    """A callable that puts FLEET_PASSES passes of `names` and one None
    a client on `work_q`, keeping the time it began as `.t_fill`."""

    def fill():
        fill.t_fill = time.time()
        for _ in range(FLEET_PASSES):
            for name in names:
                work_q.put(name)
        for _ in range(n_clients):
            work_q.put(None)

    return fill


def smi_card_state() -> dict | None:
    """The card's used and total memory and its compute mode as
    `nvidia-smi --query-gpu=memory.used,memory.total,compute_mode` gives
    them, or None if it gave no answer within 60 s."""
    try:
        proc = subprocess.Popen(["nvidia-smi", "--query-gpu=memory.used,memory.total,compute_mode",
                                 "--format=csv,noheader"], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    except FileNotFoundError:
        return None
    line = _smi_line(proc, 60)
    if line is None:
        return None
    used, total, mode = (field.strip() for field in line.split(","))
    return {"memory_used": used, "memory_total": total, "compute_mode": mode}


def fleet_path(device, ctx: dict, sf: float) -> dict:
    """3h: the fleet on the card, on the earlier phases' store (the SF1
    lineitem and orders indexes, the customer and TPC-DS indexes, li_live)
    and 3e's mix. Members are spawned processes, each with its own CUDA
    context, device cache and derived cache, over the shared plan cache
    (`shared_caches`); their sessions list indexes with a TTL of
    FLEET_EXPIRY_S (ROADMAP queue 3's stale listing: another process's
    refresh reaches a member within it). Contexts of several processes on
    one card are time-sliced, not concurrent: a fleet can only win by
    taking host work off one interpreter lock.

    (a) Throughput: 16 client threads pull FLEET_PASSES passes of the mix
    from one shared work queue, served by one process (`session.serve()`,
    4 workers), then by a fleet of 2 and of 4 members (4 workers each),
    FLEET_WINDOWS windows at each size: qps, p50, p99; every served result equal to its serial run's
    (`_arrow_served`); the members' summed K1 / K2 launches the serial
    pass's times the passes served; each member's start-up timed apart
    (spawn to entry, CUDA context, kernel load, the mix's cold pass).
    (b) A fleet of 2 with the shared result cache: J2 computed by one
    member is served by the other with no kernel launch and no column
    read. (c) li_live re-created; both members loop its lookups while
    this process appends a file and refreshes incrementally: every answer
    pyarrow's before or after, after for every lookup submitted once the
    refresh returned. (d) On the fleet of 4: an instant burst against
    tenant quotas and a shed ratio draws typed refusals only, p99
    bounded; `fleet_health` reports every member's saturation; one member
    SIGKILLed is respawned and counted; a member SIGKILLed holding a
    single-flight lease is taken over by another. (e) The fleet of 2 with
    the controller, the journal and the HTTP plane on: a `bucket.read`
    error burst pages the availability SLO, each controller engages shed
    and throttle, and releases both once clean traffic ends the page;
    orders_orderkey's newest bucket files truncated, both members
    quarantine it, exactly one member's controller heals it (recover and
    a full refresh) and the other observes the marker, spending no
    budget; J2 then runs aligned again with K2; an incident bundle holds
    journal segments of both members."""
    import queue as queue_mod

    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    import torch

    import hyperspace_tpu_torch as htorch
    from hyperspace_tpu_torch import Hyperspace, IndexConfig, PlanCache, col, faults, stats
    from hyperspace_tpu_torch.datagen import TPCH_SF1_ORDERS_ROWS, gen_tpch_lineitem
    from hyperspace_tpu_torch.ops.segment_reduce import segment_reduce
    from hyperspace_tpu_torch.ops.sortkeys import run_bounds

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t_phase = time.perf_counter()
    session, workdir = ctx["session"], ctx["workdir"]
    session.enable_hyperspace()
    faults.reset()
    out: dict = {}
    if device.type == "cuda":
        torch.cuda.empty_cache()
        card = smi_card_state()
        out["compute_mode"] = card and card["compute_mode"]
        if out["compute_mode"] in ("Exclusive_Process", "Exclusive_Thread", "Prohibited"):
            raise AssertionError(f"the card's compute mode is {out['compute_mode']}: fleet members cannot open "
                                 "CUDA contexts beside this process's")
    rows = ctx["source"].num_rows
    keys = np.random.default_rng(7).choice(int(TPCH_SF1_ORDERS_ROWS * sf), 12, replace=False) + 1
    mix = serve_mix(htorch, ctx, sf, keys)
    names = list(mix)

    # Serial, through run_query and the plan cache the one-process server
    # then uses; each result also written as Arrow IPC for the members.
    serial_dir = workdir / "fleet_serial"
    serial_dir.mkdir(exist_ok=True)
    pc_one, serial = PlanCache(), {}
    k1, k2 = segment_reduce.launches, run_bounds.launches
    for i, (name, plan) in enumerate(mix.items()):
        serial[name] = session.run_query(plan, plan_cache=pc_one).result
        table = serial[name].to_arrow()
        with pa.OSFile(str(serial_dir / f"{i}.arrow"), "wb") as sink, pa.ipc.new_file(sink, table.schema) as w:
            w.write_table(table)
    sync()
    serial_launches = {"segment_reduce": segment_reduce.launches - k1, "run_bounds": run_bounds.launches - k2}
    if device.type == "cuda" and not all(serial_launches.values()):
        raise AssertionError(f"3h's serial mix launched {serial_launches}")
    out["serial_launches"] = serial_launches
    total = FLEET_PASSES * len(names)

    # (a) One process: 16 clients over one queue, FLEET_WINDOWS windows.
    throughput: dict = {}
    with session.serve(workers=FLEET_WORKERS, plan_cache=pc_one, result_cache=False) as server:
        for w in range(FLEET_WINDOWS):
            work_q: queue_mod.Queue = queue_mod.Queue()
            fill = _filler(work_q, names, FLEET_CLIENTS)
            k1, k2 = segment_reduce.launches, run_bounds.launches
            served = _drain(server, mix, work_q, FLEET_CLIENTS, fill)
            launched = {"segment_reduce": segment_reduce.launches - k1, "run_bounds": run_bounds.launches - k2}
            for name, _, _, result in served:
                check_served(name.split()[0], result, serial[name], rows)
            if launched != {k: v * FLEET_PASSES for k, v in serial_launches.items()}:
                raise AssertionError(f"one process: {launched} launches for {FLEET_PASSES} passes of {serial_launches}")
            window = {**_window([s[:3] for s in served], fill.t_fill), "launches": launched}
            throughput.setdefault("1 process", []).append(window)
            log(json.dumps({"fleet_pass": {"fleet": "1 process", "window": w, **window}}))

    spec = {"system_path": str(session.conf.system_path), "device": device.type, "rows": rows,
            "mix": {name: plan.to_json() for name, plan in mix.items()}, "serial_dir": str(serial_dir),
            "journal_dir": str(workdir / "fleet_obs"),
            "conf": {k: v for k, v in session.conf.overrides.items()
                     if k.startswith(("hyperspace.index.hybridscan.", "hyperspace.join.", "hyperspace.recover."))}}
    fleets = {2: _Fleet("2", 2, dict(spec, http=False), workdir), 4: _Fleet("4", 4, dict(spec, http=True), workdir)}
    try:
        t0 = time.perf_counter()
        for f in fleets.values():
            f.start()
        for f in fleets.values():
            f.await_ready(300)
        out["fleets_ready_s"] = time.perf_counter() - t0
        startup = {f"{n} members": f.ready for n, f in fleets.items()}
        for n, f in fleets.items():
            for wid, rec in f.ready.items():
                if device.type == "cuda" and not (rec["cuda_initialized"] and rec["libraries_prebuilt"]):
                    raise AssertionError(f"fleet {n} member {wid}: context {rec['cuda_initialized']}, "
                                         f"kernels prebuilt {rec['libraries_prebuilt']}")
                if device.type == "cuda" and {k: rec["warm_pass_launches"][k] for k in serial_launches} != serial_launches:
                    raise AssertionError(f"fleet {n} member {wid}: the start-up pass launched "
                                         f"{rec['warm_pass_launches']}, serially {serial_launches}")
        log(json.dumps({"fleet_startup": startup}))

        for n in FLEET_SIZES:
            f = fleets[n]
            if n == 4 and device.type == "cuda":
                out["nvidia_smi_while_4_up"] = smi_card_state()
            for w in range(FLEET_WINDOWS):
                f.send(range(n), "pass", FLEET_CLIENTS // n)
                f.collect(range(n), "armed")
                fill = _filler(f.work_q, names, FLEET_CLIENTS)
                fill()
                got = f.collect(range(n), "pass", timeout=600)
                served = [s for rec in got.values() for s in rec["served"]]
                if len(served) != total:
                    raise AssertionError(f"fleet of {n}: {len(served)} of {total} queries answered")
                summed = {k: sum(rec["launches"][k] for rec in got.values())
                          for k in ("segment_reduce", "run_bounds", "topk")}
                want = {**{k: v * FLEET_PASSES for k, v in serial_launches.items()}, "topk": 0}
                if device.type == "cuda" and summed != want:
                    raise AssertionError(f"fleet of {n}: the members launched {summed}, {FLEET_PASSES} serial passes "
                                         f"{want}")
                reports = f.ask(range(n), "report")
                window = {
                    **_window(served, fill.t_fill), "launches": summed,
                    "by_member": {wid: {"served": len(rec["served"]), "launches": rec["launches"],
                                        "derived_hits": rec["derived_hits"], "derived_misses": rec["derived_misses"],
                                        **{k: reports[wid].get(k) for k in ("max_memory_allocated", "memory_reserved",
                                                                            "cuda_initialized")}}
                                  for wid, rec in got.items()}}
                throughput.setdefault(f"{n} members", []).append(window)
                log(json.dumps({"fleet_pass": {"fleet": f"{n} members", "window": w, **window}}))
        out["throughput"] = throughput

        # (d) Overload, restart and takeover on the fleet of 4.
        f = fleets[4]
        bursts = f.ask(range(4), "burst")
        health = f.sup.fleet_health()
        for wid, rec in bursts.items():
            if rec["untyped"] or not rec["admitted"] or not sum(rec["refused"].values()):
                raise AssertionError(f"burst on member {wid}: {rec}")
            if rec["p99_ms"] > FLEET_BURST_P99_MS:
                raise AssertionError(f"burst on member {wid}: p99 {rec['p99_ms']:.0f} ms")
        members = health["members"]
        if sorted(members) != [0, 1, 2, 3] or any(not (m["healthz"] or {}).get("scheduler") for m in members.values()):
            raise AssertionError(f"fleet_health: {json.dumps(health, default=str)[:2000]}")
        r0 = stats.get("fleet.supervisor.restarts")
        victim = f.sup.pids()[3]
        os.kill(victim, 9)
        respawn_s = _wait_for(lambda: f.sup.restarts().get(3) == 1 and f.sup.pids()[3] != victim
                              and f.sup._host.get(3).is_alive(), 30.0)
        if respawn_s is None or stats.get("fleet.supervisor.restarts") != r0 + 1:
            raise AssertionError(f"member 3 was not respawned: restarts {f.sup.restarts()}")
        f.send([1], "hold_lease", "3h.takeover")
        f.collect([1], "held")
        holder = f.sup.pids()[1]
        os.kill(holder, 9)
        taken = f.ask([2], "takeover", "3h.takeover")[2]
        if taken["value"] != "taken over" or taken["takeovers"] != 1:
            raise AssertionError(f"takeover: {taken}")
        out["overload"] = {
            "bursts": bursts,
            "fleet_health": {"status": health["status"], "saturation": health["saturation"],
                             "members": {w: {"status": m["status"], "port": m["port"],
                                             "scheduler": (m["healthz"] or {}).get("scheduler")}
                                         for w, m in members.items()}},
            "respawn_s": respawn_s, "restarts": f.sup.restarts(),
            "fleet.supervisor.restarts": stats.get("fleet.supervisor.restarts") - r0,
            "takeover": {k: taken[k] for k in ("value", "wait_s", "takeovers", "events")}}
        log(json.dumps({"fleet_overload": out["overload"]}, default=str))
        f.stop(timeout=2.0)
        out["fleet_4_launches"] = dict(f.last_launches)

        # (b) The shared result cache on the fleet of 2.
        f = fleets[2]
        first = f.ask([0], "result_cache", "J2")[0]
        second = f.ask([1], "result_cache", "J2")[1]
        if first["cache_hit"] or not second["cache_hit"] or any(second["launches"].values()) \
                or second["columns_read"]:
            raise AssertionError(f"shared result cache: first {first}, second {second}")
        out["shared_result_cache"] = {"first": first, "second": second}
        log(json.dumps({"fleet_shared_result_cache": out["shared_result_cache"]}))

        # (c) Refresh churn: li_live re-created, looped by both members
        # across an append and an incremental refresh.
        hs = Hyperspace(session)
        live = workdir / "lineitem_live"
        t0 = time.perf_counter()
        listed = hs.indexes()
        if LIVE_INDEX in set(listed[listed["state"] == "ACTIVE"]["name"]):
            hs.delete_index(LIVE_INDEX)
            hs.vacuum_index(LIVE_INDEX)
        hs.create_index(session.parquet(live), IndexConfig(LIVE_INDEX, INDEXED, INCLUDED))
        create_s = time.perf_counter() - t0
        frac, seed = FLEET_APPEND
        stage = workdir / "stage_fleet"
        gen_tpch_lineitem(stage, sf=frac * sf, seed=seed, files=1)
        appended = pq.read_table(stage / "part-0.parquet")
        uniq = np.unique(appended["l_orderkey"].to_numpy())
        lkeys = uniq[np.linspace(0, len(uniq) - 1, 12).astype(np.int64)]
        cols = ["l_orderkey", "l_partkey", "l_extendedprice"]
        li = session.parquet(live)
        plans = {int(k): li.filter(col("l_orderkey") == int(k)).select(*cols).to_json() for k in lkeys}

        def answers(table) -> dict:
            sub = table.select(cols).filter(pc.is_in(table["l_orderkey"], value_set=pa.array(lkeys)))
            found = sorted(zip(*(sub[c].to_pylist() for c in cols)))
            return {int(k): [r for r in found if r[0] == k] for k in lkeys}

        base = pq.read_table(sorted(str(p) for p in live.glob("*.parquet")), columns=cols)
        before, after = answers(base), answers(pa.concat_tables([base, appended.select(cols)]))
        time.sleep(FLEET_EXPIRY_S)  # the members' listings now hold the new li_live
        f.loop_stop.clear()
        f.send([0, 1], "loop", plans, cols)
        f.collect([0, 1], "armed")
        time.sleep(0.5)
        (stage / "part-0.parquet").rename(live / "append-fleet.parquet")
        t0 = time.perf_counter()
        hs.refresh_index(LIVE_INDEX, mode="incremental")
        committed_wall, refresh_s = time.time(), time.perf_counter() - t0
        time.sleep(1.0)
        f.loop_stop.set()
        loops = f.collect([0, 1], "loop", timeout=120)
        seen = [s for rec in loops.values() for s in rec["seen"]]
        late = 0
        for t_submit, k, got_rows in seen:
            got_rows = [tuple(r) for r in got_rows]
            if got_rows != after[k] and (got_rows != before[k] or t_submit >= committed_wall):
                raise AssertionError(f"li_live lookup {k} submitted {t_submit - committed_wall:+.3f} s from the "
                                     f"refresh's commit gave {len(got_rows)} rows: neither before "
                                     f"({len(before[k])}) nor after ({len(after[k])})")
            late += t_submit >= committed_wall
        if not late:
            raise AssertionError("no li_live lookup was submitted after the refresh committed")
        out["refresh_churn"] = {"create_s": create_s, "refresh_incremental_s": refresh_s, "queries": len(seen),
                                "after_commit": late, "by_member": {w: len(r["seen"]) for w, r in loops.items()},
                                "stale_after_commit": 0}
        log(json.dumps({"fleet_refresh_churn": out["refresh_churn"]}))

        # (e) The controller on the fleet of 2.
        setup = f.ask([0, 1], "controller")
        fails = f.ask([0, 1], "fail_burst", timeout=120)
        for wid, rec in fails.items():
            if rec["failed"] != FLEET_FAIL_BURST or rec["engage_s"] is None or rec["release_s"] is None \
                    or rec["shed_depth_engaged"] != rec["max_queue_depth"] // 2 or rec["throttle_engaged"] != 0.5 \
                    or rec["shed_depth_released"] != rec["shed_depth_before"] \
                    or rec["throttle_released"] != rec["throttle_before"]:
                raise AssertionError(f"controller on member {wid}: {rec}")
        f.ask([0, 1], "conf", "hyperspace.controller.enabled", False)
        o_index = Path(session.conf.system_path) / "orders_orderkey"
        versions = sorted(o_index.glob("v__=*"), key=lambda p: int(p.name.split("=")[1]))
        truncated = 0
        for path in sorted(versions[-1].glob("bucket-*.parquet")):
            with open(path, "r+b") as fh:
                fh.truncate(7)
            truncated += 1
        broken = f.ask([0, 1], "query", ["J2"], timeout=120)
        for wid, rec in broken.items():
            if rec["quarantined"] != ["orders_orderkey"] or rec["J2"]["replans"] != 1:
                raise AssertionError(f"member {wid} over the truncated orders_orderkey: {rec}")
        healed = f.ask([0, 1], "heal", timeout=120)
        leaders = [w for w, r in healed.items() if r["heals"] == 1]
        observers = [w for w, r in healed.items() if r["heals"] == 0]
        if len(leaders) != 1 or len(observers) != 1 or any(r["heal_s"] is None for r in healed.values()):
            raise AssertionError(f"the heal: {healed}")
        lead, obs = healed[leaders[0]], healed[observers[0]]
        if [a["outcome"] for a in obs["audit"]] != ["observed"] or obs["budget_remaining"] != lead["budget_remaining"] + 1:
            raise AssertionError(f"the observer: {obs}; the leader: {lead}")
        new_versions = sorted(o_index.glob("v__=*"), key=lambda p: int(p.name.split("=")[1]))
        if int(new_versions[-1].name.split("=")[1]) != int(versions[-1].name.split("=")[1]) + 1:
            raise AssertionError(f"orders_orderkey versions after the heal: {[p.name for p in new_versions]}")
        again = f.ask([0, 1], "query", ["J2"] + [n for n in names if n.startswith("lookup")][:3], timeout=120)
        for wid, rec in again.items():
            j2 = rec["J2"]
            if rec["quarantined"] or j2["replans"] or j2["join_path"] != "zero-exchange-aligned" \
                    or (device.type == "cuda" and not j2["launches"]["run_bounds"]):
                raise AssertionError(f"member {wid} after the heal: {rec}")
        incidents = Path(session.conf.system_path) / "_fleet" / "incidents"
        bundles = {}
        for b in sorted(incidents.iterdir()) if incidents.is_dir() else []:
            pids = sorted(p.name for p in (b / "journal").iterdir()) if (b / "journal").is_dir() else []
            bundles[b.name] = {"manifest": (b / "manifest.json").exists(), "journal_pids": pids}
        member_pids = {str(f.ready[w]["pid"]) for w in (0, 1)}
        if not any(member_pids <= set(b["journal_pids"]) for b in bundles.values()):
            raise AssertionError(f"no incident bundle holds both members' journal segments: {bundles}")
        reports = f.ask([0, 1], "report")
        out["controller"] = {"setup": setup, "fail_burst": fails, "truncated": truncated, "quarantined": broken,
                             "healed": healed, "leader": leaders[0], "after_heal": again, "bundles": bundles,
                             "fleet_health": f.sup.fleet_summary(), "reports": reports}
        log(json.dumps({"fleet_controller": out["controller"]}, default=str))
        f.stop()
        out["fleet_2_launches"] = dict(f.last_launches)
    finally:
        for f in fleets.values():
            f.sup.stop(timeout=5.0)
    session.manager.clear_cache()
    members_total = {k: sum(c[k] for fl in ("fleet_2_launches", "fleet_4_launches")
                            for c in out.get(fl, {}).values()) for k in ("segment_reduce", "run_bounds", "topk")}
    out["member_launches"] = members_total
    if device.type == "cuda" and (not members_total["segment_reduce"] or not members_total["run_bounds"]
                                  or members_total["topk"]):
        raise AssertionError(f"the members launched {members_total}")
    out["fleet_path_s"] = time.perf_counter() - t_phase
    return out


# -- the advisor (3i) ---------------------------------------------------------

ADVISOR_WARMUPS = 2  # untimed runs a plan a phase, with the routing ledger off
ADVISOR_RUNS = 3  # recorded runs a plan a phase
ADVISOR_MIN_SAMPLES = 2  # hyperspace.advisor.routing.minSamples in 3i
ADVISOR_SUPPRESS = 1e9  # demoteRatio while the indexed phase measures
ADVISOR_HOT_KEYS = 12  # (c)'s l_partkey lookups, keys drawn with seed 12
ADVISOR_HOT = "adv_lineitem_l_partkey"  # the index the sweep creates for them
ADVISOR_COLD = "cold_audit_idx"  # the index no query touches
ADVISOR_REFRESHED = "customer_custkey"  # (b)'s committed mutation: Q13's side
# The plans whose results are aggregates: their float columns are sums and
# means of non-negative terms, within 2·N·u across paths.
ADVISOR_AGGREGATES = ("Q1", "revenue", "J2", "J3", "Q13", "DPPk")


def advisor_plans(pkg, ctx: dict, sf: float) -> dict:
    """3i's plans, name -> plan, from the earlier phases': the main path's
    12 lookups, its 1% range, Q1 and revenue, the join path's J1-J3, the
    join-types path's Q13 and DPPk and the query surface's q43 and q67."""
    from hyperspace_tpu_torch.datagen import TPCH_SF1_ORDERS_ROWS

    col, lit = pkg.col, pkg.lit
    li = ctx["lineitem"]
    domain = int(TPCH_SF1_ORDERS_ROWS * sf)
    keys = np.random.default_rng(7).integers(0, domain, 12).astype(np.int64)
    plans = {f"lookup {int(k)}": li.filter(col("l_orderkey") == int(k)).select(
        "l_orderkey", "l_partkey", "l_extendedprice") for k in keys}
    lo, hi = int(domain * 0.47), int(domain * 0.48)
    plans["range"] = li.filter((col("l_orderkey") >= lit(lo)) & (col("l_orderkey") <= lit(hi))).select(
        "l_orderkey", "l_partkey", "l_extendedprice")
    plans["Q1"] = li.aggregate(Q1_GROUP, Q1_AGGS)
    plans["revenue"] = li.aggregate(["l_orderkey"], [("sum", "l_extendedprice", "rev")])
    plans.update(ctx["join_queries"])
    jt = join_type_plans(pkg, li, ctx["orders"], ctx["customer"], sf)
    plans["Q13"], plans["DPPk"] = jt["Q13"][0], jt["DPPk"][0]
    surface = query_surface_plans(pkg, ctx["surface_tables"])
    plans["q43"], plans["q67"] = surface["q43"], surface["q67"]
    return plans


def sorted_rows(result, tolerant: tuple):
    """A result as a pyarrow table with strings decoded, its rows sorted
    by every column but the `tolerant` ones (for `same_rows`)."""
    import pyarrow as pa

    t = result.to_arrow()
    t = pa.table({c: t[c].cast(t[c].type.value_type) if pa.types.is_dictionary(t[c].type) else t[c]
                  for c in t.column_names})
    return t.sort_by([(c, "ascending") for c in t.column_names if c not in tolerant])


def same_rows(name: str, a, b, tolerant: tuple, rows: int) -> None:
    """Two results of one query over two paths (the index's, the
    source's), as `sorted_rows` gives them: the same rows as multisets,
    strings compared as strings; the `tolerant` columns (sums and means
    of non-negative terms) within 2·rows·u of each other, the rest
    exact."""
    import pyarrow.compute as pc

    if a.column_names != b.column_names or a.num_rows != b.num_rows:
        raise AssertionError(f"{name}: {a.num_rows} rows of {a.column_names}, the other path "
                             f"{b.num_rows} of {b.column_names}")
    for c in a.column_names:
        if c not in tolerant:
            if not a[c].equals(b[c]):
                raise AssertionError(f"{name}: column {c} differs between the paths")
            continue
        x = a[c].to_numpy(zero_copy_only=False).astype(np.float64)
        y = b[c].to_numpy(zero_copy_only=False).astype(np.float64)
        nulls = np.asarray(pc.is_null(a[c])), np.asarray(pc.is_null(b[c]))
        if not np.array_equal(*nulls):
            raise AssertionError(f"{name}: the nulls of {c} differ between the paths")
        ok = np.abs(x - y) <= 2 * rows * UNIT_ROUNDOFF * np.abs(y)
        if not bool((ok | nulls[0]).all()):
            raise AssertionError(f"{name}: {c} differs between the paths beyond 2·N·u")


def advisor_path(device, ctx: dict, sf: float) -> dict:
    """3i: the advisor on the earlier phases' session, store and plans
    (`advisor_plans`), at SF1 with nothing cut. The session's workload log
    starts empty: the advisor's evidence is this phase's.

    (a) Three phases over every plan, as benchmarks/bench_advisor.py runs
    them, with routing on (minSamples ADVISOR_MIN_SAMPLES): raw (index
    off), indexed (demoteRatio ADVISOR_SUPPRESS), routed (the default
    ratio); each plan ADVISOR_WARMUPS untimed runs with the ledger off,
    then ADVISOR_RUNS recorded ones. Every routed run's decision must be
    the one the ledger's own EMAs give just before it
    (`indexed > demoteRatio x raw`, both sides sampled minSamples times);
    a raw-routed run has no index scan, the raw run's physical operators
    (so its join paths) and its K1 / K2 launches; an indexed-routed run
    the indexed run's. The last routed, raw and indexed results agree
    (`same_rows`; q43 and q67 each against the query surface's pandas
    reference), and explain's routing line agrees with the ledger. The
    medians per query, routed / raw and the number demoted print; no time
    is gated. (b) A full refresh of `customer_custkey` (Q13's side) moves
    the collection stamp: one invalidation, every decision indexed again.
    (c) A cold index over a table of its own (2,000 rows) and 12 cold
    `l_partkey` lookups on lineitem: `recommend()` gives a create for
    them and a drop for the cold index; a sweep with autoCreate and
    autoVacuum on builds the first on the card through the Action log and
    vacuums the second (and any other index the phase did not touch); the
    next lookup reads one of the new index's bucket files and equals
    pyarrow. (d) The operations controller on an injected clock, the
    lifecycle gates off, demotionClusterSize at most the demotions (a)
    emitted: one step drains them from the event ring and makes exactly
    one audited `advisor.sweep` (trigger `routing.demotion_cluster`),
    which mutates nothing."""
    import pandas as pd
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    import torch

    import hyperspace_tpu_torch as htorch
    from hyperspace_tpu_torch import Hyperspace, IndexConfig, col, faults
    from hyperspace_tpu_torch.advisor.workload import used_index_names
    from hyperspace_tpu_torch.execution import device_cache as dc
    from hyperspace_tpu_torch.metadata.log_manager import IndexLogManager
    from hyperspace_tpu_torch.obs import events as obs_events
    from hyperspace_tpu_torch.obs import metrics as obs_metrics
    from hyperspace_tpu_torch.obs import slo as obs_slo
    from hyperspace_tpu_torch.ops.segment_reduce import segment_reduce
    from hyperspace_tpu_torch.ops.sortkeys import run_bounds
    from hyperspace_tpu_torch.serve.plan_cache import collection_log_versions
    from hyperspace_tpu_torch.signature import plan_signature

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t_phase = time.perf_counter()
    session, workdir, cache = ctx["session"], ctx["workdir"], ctx["plan_cache"]
    hs = Hyperspace(session)
    conf = session.conf
    faults.reset()
    session.enable_hyperspace()
    session.workload.clear()
    rows = ctx["source"].num_rows
    plans = advisor_plans(htorch, ctx, sf)
    sigs = {name: plan_signature(plan) for name, plan in plans.items()}
    if len(set(sigs.values())) != len(sigs):
        raise AssertionError(f"3i: two plans share a signature: {sigs}")
    conf.set("hyperspace.advisor.routing.enabled", True)
    conf.set("hyperspace.advisor.routing.minSamples", ADVISOR_MIN_SAMPLES)
    ledger = session.routing_ledger()
    ratio = float(conf.advisor_routing_demote_ratio)
    min_n = ADVISOR_MIN_SAMPLES
    refs = ctx["surface_refs"]
    out: dict = {"plans": list(plans), "min_samples": min_n, "runs": ADVISOR_RUNS}
    events_seq0 = max([e["seq"] for e in obs_events.recent()] or [0])

    def run(plan):
        k1, k2 = segment_reduce.launches, run_bounds.launches
        t0 = time.perf_counter()
        o = session.run_query(plan, plan_cache=cache)
        sync()
        wall = time.perf_counter() - t0
        return o, wall, {"segment_reduce": segment_reduce.launches - k1, "run_bounds": run_bounds.launches - k2}

    def expected(sig) -> str:
        e = ledger.snapshot()["entries"].get(sig, {})
        idx, raw = e.get("indexed"), e.get("raw")
        if idx and raw and idx[1] >= min_n and raw[1] >= min_n and idx[0] > ratio * raw[0]:
            return "raw"
        return "indexed"

    def index_scans(o) -> list:
        return [s.root for s in o.optimized_plan.leaves() if s.bucket_spec is not None]

    phases: dict = {}
    for phase in ("raw", "indexed", "routed"):
        t0 = time.perf_counter()
        session.disable_hyperspace() if phase == "raw" else session.enable_hyperspace()
        conf.set("hyperspace.advisor.routing.demoteRatio", ADVISOR_SUPPRESS if phase == "indexed" else ratio)
        rec: dict = {}
        for name, plan in plans.items():
            conf.set("hyperspace.advisor.routing.enabled", False)
            for _ in range(ADVISOR_WARMUPS):
                run(plan)
            conf.set("hyperspace.advisor.routing.enabled", True)
            walls, decisions = [], []
            for _ in range(ADVISOR_RUNS):
                want = expected(sigs[name]) if phase == "routed" else None
                o, wall, launched = run(plan)
                walls.append(wall)
                routing = o.stats["advisor_routing"]
                decision = routing["decision"]
                if phase == "routed":
                    if routing != {"decision": want, "demoted": want == "raw"}:
                        raise AssertionError(f"3i {name}: routed {routing}, the ledger's EMAs give {want}")
                    ref = phases["raw" if decision == "raw" else "indexed"][name]
                    ops = preorder_ops(o.physical_plan)
                    if decision == "raw" and index_scans(o):
                        raise AssertionError(f"3i {name}: demoted, yet the plan reads {index_scans(o)}")
                    if ops != ref["ops"] or launched != ref["launches"]:
                        raise AssertionError(f"3i {name} routed {decision}: {ops}, {launched}; the {decision} "
                                             f"run {ref['ops']}, {ref['launches']}")
                elif decision != ("raw" if phase == "raw" else "indexed"):
                    raise AssertionError(f"3i {name} {phase}: routed {routing}")
                decisions.append(decision)
            rec[name] = {"result": o.result, "ops": preorder_ops(o.physical_plan), "launches": launched,
                         "join_paths": o.stats.get("join_paths"), "index_scans": len(index_scans(o)),
                         "median_ms": float(np.median(walls)) * 1e3, "decisions": decisions}
        phases[phase] = rec
        out[f"{phase}_s"] = time.perf_counter() - t0
    session.enable_hyperspace()

    # The answers: routed against raw and indexed (q43 and q67 each
    # against the query surface's reference: their ORDER BY on float sums
    # may swap rows tied within the bound between paths).
    t0 = time.perf_counter()
    for name in plans:
        got = {p: phases[p][name]["result"] for p in phases}
        if name in refs:
            ref, ids, order, tol, limit, near = refs[name]
            for p, result in got.items():
                check_ordered(f"3i {name} {p}", pd.DataFrame(result.decode()), ref, ids, order, tol, limit, near)
            continue
        tolerant = tuple(f.name for f in got["raw"].schema.fields
                         if name in ADVISOR_AGGREGATES and f.dtype in ("float32", "float64"))
        got = {p: sorted_rows(r, tolerant) for p, r in got.items()}
        same_rows(f"3i {name} routed / raw", got["routed"], got["raw"], tolerant, rows)
        same_rows(f"3i {name} routed / indexed", got["routed"], got["indexed"], tolerant, rows)
    out["answers_checked_s"] = time.perf_counter() - t0

    # The ledger's verdicts and explain's line.
    snap = ledger.snapshot()["entries"]
    demoted = set(ledger.demoted_signatures())
    table = {}
    for name, plan in plans.items():
        e = snap.get(sigs[name], {})
        verdict = "raw" if sigs[name] in demoted else "indexed"
        if verdict != expected(sigs[name]):
            raise AssertionError(f"3i {name}: the ledger demotes {verdict}, its EMAs {e}")
        line = [ln for ln in hs.explain(plan).splitlines() if ln.startswith("Adaptive routing:")]
        if len(line) != 1 or line[0].split()[2] != verdict:
            raise AssertionError(f"3i {name}: explain says {line}, the ledger {verdict}")
        raw_ms, routed_ms = phases["raw"][name]["median_ms"], phases["routed"][name]["median_ms"]
        table[name] = {"raw_ms": raw_ms, "indexed_ms": phases["indexed"][name]["median_ms"],
                       "routed_ms": routed_ms, "routed_over_raw": routed_ms / raw_ms, "verdict": verdict,
                       "routed_decisions": phases["routed"][name]["decisions"],
                       "ema_indexed_ms": e["indexed"][0] * 1e3, "ema_raw_ms": e["raw"][0] * 1e3,
                       "paths": {p: phases[p][name]["join_paths"] for p in ("raw", "indexed")},
                       "launches": {p: phases[p][name]["launches"] for p in phases}}
        log(json.dumps({"advisor_query": {"query": name, **table[name]}}))
    out["queries"] = table
    out["demoted"] = sorted(n for n in plans if table[n]["verdict"] == "raw")
    demotion_events = [e for e in obs_events.recent() if e["seq"] > events_seq0
                       and e["name"] == "advisor.routing.demoted"]
    out["demotion_events"] = len(demotion_events)
    want_events = sum(d == "raw" for n in plans for d in phases["routed"][n]["decisions"])
    if len(demotion_events) != want_events:
        raise AssertionError(f"3i: {len(demotion_events)} demotion events, {want_events} raw-routed runs")

    # (b) Re-promotion: a committed mutation moves the collection stamp.
    inval = obs_metrics.counter("advisor.routing.invalidations")
    before = inval.value
    t0 = time.perf_counter()
    hs.refresh_index(ADVISOR_REFRESHED, "full")
    sync()
    out["repromotion_refresh_s"] = time.perf_counter() - t0
    back = {name: ledger.decide(sig) for name, sig in sigs.items()}
    if inval.value - before != 1 or set(back.values()) != {"indexed"} or ledger.snapshot()["entries"]:
        raise AssertionError(f"3i (b): invalidations +{inval.value - before}, decisions {back}")
    out["repromotion"] = {"invalidations": inval.value - before, "decisions": sorted(set(back.values()))}

    # (c) Recommendations over the phase's workload, then the sweep.
    t0 = time.perf_counter()
    cold_root = workdir / "cold_audit"
    cold_root.mkdir(exist_ok=True)
    rng = np.random.default_rng(5)
    pq.write_table(pa.table({"audit_id": np.arange(2000, dtype=np.int64), "blob": rng.standard_normal(2000)}),
                   cold_root / "part0.parquet")
    hs.create_index(session.parquet(cold_root), IndexConfig(ADVISOR_COLD, ["audit_id"], ["blob"]))
    li = ctx["lineitem"]
    hot_keys = np.random.default_rng(12).integers(1, int(200_000 * sf) + 1, ADVISOR_HOT_KEYS)
    hot = [li.filter(col("l_partkey") == int(k)).select("l_partkey", "l_suppkey", "l_extendedprice")
           for k in hot_keys]
    # Cold lookups: an index is for the reads a cache does not hold.
    dc.clear_all()
    for plan in hot:
        o = session.run_query(plan, plan_cache=cache)
        if used_index_names(o.optimized_plan):
            raise AssertionError(f"3i (c): a hot lookup used {used_index_names(o.optimized_plan)} before the sweep")
    sync()
    recs = hs.recommend()
    out["recommendations"] = [r.to_json() for r in recs]
    log(json.dumps({"advisor_recommendations": out["recommendations"]}))
    src_root = str(li.root)
    creates = [r for r in recs if r.kind == "create" and r.source_root == src_root
               and [c.lower() for c in r.index_config.indexed_columns] == ["l_partkey"]]
    drops = [r for r in recs if r.kind == "drop" and r.index_name == ADVISOR_COLD]
    if len(creates) != 1 or creates[0].index_config.index_name != ADVISOR_HOT or len(drops) != 1:
        raise AssertionError(f"3i (c): recommendations {out['recommendations']}")
    system_path = Path(conf.system_path)
    hot_log = IndexLogManager(system_path / ADVISOR_HOT)
    hot_id0 = hot_log.get_latest_id()
    conf.set("hyperspace.advisor.lifecycle.autoCreate", True)
    conf.set("hyperspace.advisor.lifecycle.autoVacuum", True)
    t1 = time.perf_counter()
    report = hs.lifecycle().sweep()
    sync()
    out["sweep_s"] = time.perf_counter() - t1
    out["sweep"] = {k: [(a["kind"], a["index_name"] or a["index_config"]["name"]) for a in v]
                    for k, v in report.items()}
    applied = out["sweep"]["applied"]
    if report["failed"] or ("create", ADVISOR_HOT) not in applied or ("drop", ADVISOR_COLD) not in applied:
        raise AssertionError(f"3i (c): the sweep {out['sweep']}")
    conf.set("hyperspace.advisor.lifecycle.autoCreate", False)
    conf.set("hyperspace.advisor.lifecycle.autoVacuum", False)
    first = 0 if hot_id0 is None else hot_id0 + 1
    states = [hot_log.get_log(i).state for i in range(first, hot_log.get_latest_id() + 1)]
    files = sorted((system_path / ADVISOR_HOT).glob("v__=*/*.parquet"))
    if states != ["CREATING", "ACTIVE"] or len(files) != conf.num_buckets:
        raise AssertionError(f"3i (c): {ADVISOR_HOT}'s log {states}, {len(files)} bucket files")
    cold_state = IndexLogManager(system_path / ADVISOR_COLD).get_latest_log().state
    if cold_state != "DOESNOTEXIST" or list((system_path / ADVISOR_COLD).glob("v__=*")):
        raise AssertionError(f"3i (c): {ADVISOR_COLD} is {cold_state} after the sweep")
    out["hot_build"] = {"path": session.last_build_stats.get("path"), "rows": session.last_build_stats.get("rows"),
                        "phases_s": session.last_build_stats.get("phases_s")}
    key = int(hot_keys[0])
    o = session.run_query(hot[0], plan_cache=cache)
    sync()
    st = o.stats
    if used_index_names(o.optimized_plan) != (ADVISOR_HOT,) or st["scan"] != "IndexPointLookup" \
            or st["files_read"] != 1 or st["files_pruned"] != conf.num_buckets - 1:
        raise AssertionError(f"3i (c): the hot lookup after the sweep: {used_index_names(o.optimized_plan)}, "
                             f"{ {k: st.get(k) for k in ('scan', 'files_read', 'files_pruned')} }")
    src = ctx["source"]
    cols = ["l_partkey", "l_suppkey", "l_extendedprice"]
    want = src.filter(pc.equal(src["l_partkey"], key)).select(cols)
    got = o.result.to_arrow().select(cols)
    order = [(c, "ascending") for c in cols]
    got, want = got.sort_by(order), want.sort_by(order)
    if want.num_rows == 0 or got.num_rows != want.num_rows or not all(
            np.array_equal(got[c].to_numpy(), want[c].to_numpy()) for c in cols):
        raise AssertionError(f"3i (c): the hot lookup of {key} differs from pyarrow ({got.num_rows} rows, "
                             f"{want.num_rows})")
    out["hot_lookup"] = {"key": key, "rows": got.num_rows, "files_read": st["files_read"],
                         "files_pruned": st["files_pruned"]}
    out["recommend_sweep_s"] = time.perf_counter() - t0

    # (d) The controller: the demotions of (a) on the ring, one step.
    t0 = time.perf_counter()
    if not demotion_events:
        raise AssertionError("3i (d): (a) demoted nothing, so no demotion reached the ring")
    conf.set("hyperspace.controller.enabled", True)
    conf.set("hyperspace.controller.demotionClusterSize", min(3, len(demotion_events)))
    versions = collection_log_versions(session)
    seq = max(e["seq"] for e in obs_events.recent())
    # The earlier phases' servers are not this step's SLO evidence.
    obs_slo.reset()
    ctrl = hs.controller(clock=lambda: 0.0)
    try:
        ctrl.step(now=0.0)
    finally:
        conf.set("hyperspace.controller.enabled", False)
    audit = [e["fields"] for e in obs_events.recent() if e["seq"] > seq and e["name"] == "controller.actuation"]
    sweeps = [a for a in audit if a["action"] == "advisor.sweep"]
    if len(sweeps) != 1 or sweeps[0]["trigger"] != "routing.demotion_cluster" or sweeps[0]["outcome"] != "executed" \
            or collection_log_versions(session) != versions:
        raise AssertionError(f"3i (d): the controller's audit {audit}")
    out["controller"] = {"audit": audit, "demotions_drained": sweeps[0]["demotions"],
                         "cluster_size": conf.controller_demotion_cluster_size, "step_s": time.perf_counter() - t0}
    conf.set("hyperspace.advisor.routing.enabled", False)
    out["advisor_path_s"] = time.perf_counter() - t_phase
    return out


# -- 3j: continuous ingestion -------------------------------------------------

INGEST_BATCH_ROWS = 500_000  # benchmarks/bench_ingest.py's full workload: rows a trip batch
INGEST_BATCHES = 8  # appended on top of the seed batch 0
INGEST_CDC_ROWS = 10_000  # rows a CDC wave, one wave a batch
INGEST_LAG_S = 60.0  # hyperspace.ingest.maxLagSeconds
INGEST_P99_S = 5.0  # bench_ingest's completed-query p99 bound
INGEST_FLOOR_GBPS = 0.11  # bench_ingest's throughput floor: printed with its verdict, not gated
INGEST_GAUGE_ZONE = 42
# The zone aggregate's 12 zones (42, the gauge's, among them).
INGEST_ZONES = (7, 19, 42, 57, 88, 101, 133, 150, 177, 201, 230, 264)
INGEST_WORKER_BATCHES = 2  # (b)'s batches, published with the process worker on


class _TimedIngest:
    """Pass-through Hyperspace facade that clocks successful refreshes and
    compactions (bench_ingest's accounting: dataset bytes over the seconds
    inside successful refreshes; empty polls and failures excluded) and
    records what each build reports: its path, rows and the device its
    bucket sort ran on."""

    def __init__(self, hs):
        self._hs = hs
        self._lock = threading.Lock()
        self.commit_s = 0.0
        self.builds: list[dict] = []

    def _record(self, action: str, t0: float) -> None:
        st = self._hs.session.last_build_stats
        with self._lock:
            self.builds.append({"action": action, "s": time.perf_counter() - t0, "path": st.get("path"),
                                "rows": st.get("rows"), "sort_device": st.get("sort_device")})

    def refresh_index(self, name, mode="full"):
        t0 = time.perf_counter()
        out = self._hs.refresh_index(name, mode)  # raises on an empty poll
        with self._lock:
            self.commit_s += time.perf_counter() - t0
        self._record("refresh", t0)
        return out

    def optimize_index(self, name, *args, **kwargs):
        t0 = time.perf_counter()
        out = self._hs.optimize_index(name, *args, **kwargs)
        self._record("optimize", t0)
        return out

    def __getattr__(self, attr):
        return getattr(self._hs, attr)


def _ingest_answers(result) -> tuple:
    """The zone aggregate's answer as (zones, counts, sums), by zone."""
    d = result.decode()
    order = np.argsort(d["zone"])
    return (tuple(int(z) for z in d["zone"][order]), tuple(int(c) for c in d["n"][order]),
            np.asarray(d["fare_sum"], dtype=np.float64)[order])


def _ingest_reference(data: Path) -> tuple:
    """pyarrow over every published file and CDC batch file under `data`:
    the gauge's row count and the zone aggregate's zones, counts, sums and
    sums of |fare| (each file read alone: the CDC batches order their
    columns by name)."""
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    parts = [pq.read_table(p, columns=["zone", "fare"]) for p in sorted(data.glob("*.parquet"))]
    t = pa.concat_tables([p.cast(pa.schema([("zone", pa.int64()), ("fare", pa.float64())])) for p in parts])
    gauge = int(pc.sum(pc.equal(t["zone"], INGEST_GAUGE_ZONE)).as_py())
    sel = t.filter(pc.is_in(t["zone"], value_set=pa.array(INGEST_ZONES, pa.int64())))
    g = sel.group_by("zone").aggregate([("fare", "sum"), ("fare", "count")]).sort_by("zone")
    zones = tuple(int(z) for z in g["zone"].to_pylist())
    counts = tuple(int(c) for c in g["fare_count"].to_pylist())
    sums = np.asarray(g["fare_sum"].to_pylist(), dtype=np.float64)
    return gauge, zones, counts, sums, np.abs(sums)  # every fare is >= 0


def _ingest_log_actions(index_dir: Path, max_deltas: int) -> list[tuple]:
    """Each committed action of the index's log with the version dirs it
    left, checked against what the action must leave: a refresh its
    predecessor's dirs plus one new one, an optimize one new dir in place
    of more than `max_deltas`."""
    log_dir = index_dir / "_hyperspace_log"
    entries = [json.loads((log_dir / p).read_text())
               for p in sorted((p.name for p in log_dir.iterdir() if p.name.isdigit()), key=int)]
    actions, prev = [], None
    for before, entry in zip([None] + entries[:-1], entries):
        if entry["state"] != "ACTIVE":
            continue
        dirs = entry["content"]["directories"]
        kind = before["state"] if before is not None else "CREATING"
        if kind == "REFRESHING":
            ok = dirs[:-1] == prev and dirs[-1] not in prev
        elif kind == "OPTIMIZING":
            ok = len(dirs) == 1 and dirs[0] not in prev and len(prev) > max_deltas
        else:
            ok = kind == "CREATING" and prev is None and len(dirs) == 1
        if not ok:
            raise AssertionError(f"3j: log entry {entry['id']} ({kind}) left {dirs} after {prev}")
        actions.append((kind, tuple(dirs)))
        prev = dirs
    missing = [d for d in prev if not (index_dir / d).is_dir()]
    if missing:
        raise AssertionError(f"3j: the latest entry's version dirs {missing} are not on disk")
    return actions


def _journal_records(root: Path, pid: int) -> list[dict]:
    """One process's journal records: its sealed segments and its active
    tail, read as written (a killed process's flushed lines included)."""
    from hyperspace_tpu_torch.obs import journal

    d = root / str(pid)
    paths = journal.segment_paths(d) + sorted(d.glob(f"{journal.TMP_PREFIX}*"))
    return [r for p in paths for r in journal.read_segment(p)]


def ingest_path(device, workdir: Path, batch_rows: int = INGEST_BATCH_ROWS, batches: int = INGEST_BATCHES,
                cdc_rows: int = INGEST_CDC_ROWS) -> tuple[dict, dict]:
    """3j: continuous ingestion at benchmarks/bench_ingest.py's full
    workload, through the port with nothing cut.

    (a) A seed batch of `batch_rows` trips (`gen_trips_batch`, seed 50)
    indexed as `trips_zone` on `zone` with `fare` and `distance` (16
    buckets); the daemon (`IngestDaemon`, thread mode, on the session's
    device; pollSeconds 0.02, maxLagSeconds 60, cdcBatchRows `cdc_rows`,
    the advisor's autoOptimize on so that compaction runs past maxDeltas
    4) watches it and `changes.jsonl`. bench_ingest's producer publishes
    `batches` more batches by `os.replace` from a staging dir, each with a
    CDC wave of `cdc_rows` JSON rows (rng 1234, trip ids from 10,000,000),
    and waits for the commits to keep up. A querier alternates the gauge
    (`zone == 42`, zone and fare) with the zone aggregate (`zone` in
    INGEST_ZONES, sum of fare and a count, by zone: K1), and re-reads both
    every round through a snapshot pinned before the first commit; the
    shared HTTP plane's /healthz is read once while it runs. Hard checks:
    every pinned read repeats the admission answer (the gauge's rows and
    the counts exactly, the sums within 2·N·u); no live answer goes
    backwards; no query started more than maxLagSeconds after a unit
    arrived misses it; no untyped error; completed-query p99 under 5 s;
    after the drain the gauge equals the expected total and the aggregate
    equals pyarrow over every file (counts exactly, sums within 2·N·u);
    at least `batches` commits, a compaction, every action's version
    dirs; each build's sort on the session's device; K1 in every
    aggregate, none in a gauge lookup. The throughput (dataset bytes over
    the seconds inside successful refreshes) prints beside bench_ingest's
    0.11 GB/s floor, ungated.

    (b) On (a)'s index, `hyperspace.ingest.processWorker` on: a batch and
    its wave published, the spawned worker (its session on the parent's
    device) commits it and is SIGKILLed; a second batch published;
    `recover` converges (no transient tail, no orphan version dir, a
    second recover does nothing); a restarted worker drains the rest
    exactly once (the gauge's expected total, the aggregate against
    pyarrow). The workers' commits journal their sort device; the parent
    launches no kernel in the workers' window.

    Returns the phase's record and the K1 input of one zone aggregate over
    the drained index (for the kernel phase)."""
    import os
    import signal
    import urllib.request

    import pyarrow.parquet as pq
    import torch

    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig, col, faults, stats
    from hyperspace_tpu_torch.datagen import gen_trips_batch
    from hyperspace_tpu_torch.exceptions import HyperspaceError
    from hyperspace_tpu_torch.ingest import IngestDaemon
    from hyperspace_tpu_torch.obs import http as obs_http
    from hyperspace_tpu_torch.obs import journal
    from hyperspace_tpu_torch.obs import slo as obs_slo
    from hyperspace_tpu_torch.ops import aggregate
    from hyperspace_tpu_torch.ops.segment_reduce import segment_reduce
    from hyperspace_tpu_torch.ops.topk import topk

    cuda = device.type == "cuda"
    t_phase = time.perf_counter()
    walls: dict = {}
    out: dict = {"batch_rows": batch_rows, "batches": batches, "cdc_rows_per_wave": cdc_rows}
    faults.reset()
    # The earlier phases' servers are not this phase's SLO evidence: a page
    # left over from them would defer every compaction.
    obs_slo.reset()
    root = workdir / "ingest"
    data, staging = root / "trips", root / "staging"
    t0 = time.perf_counter()
    total_bytes = gen_trips_batch(data, batch_rows, 0)
    session = HyperspaceSession(system_path=str(root / "indexes"), num_buckets=16, device=device)
    conf = session.conf
    conf.set("hyperspace.ingest.enabled", "true")
    conf.set("hyperspace.ingest.pollSeconds", "0.02")
    conf.set("hyperspace.ingest.maxLagSeconds", str(INGEST_LAG_S))
    conf.set("hyperspace.ingest.cdcBatchRows", str(cdc_rows))
    conf.set("hyperspace.advisor.lifecycle.autoOptimize", "true")
    max_deltas = int(conf.advisor_lifecycle_max_deltas)
    hs = Hyperspace(session)
    df = session.parquet(data)
    hs.create_index(df, IndexConfig("trips_zone", ["zone"], ["fare", "distance"]))
    if not str(session.last_build_stats.get("sort_device", "")).startswith(device.type):
        raise AssertionError(f"3j: the create sorted on {session.last_build_stats.get('sort_device')}")
    session.enable_hyperspace()
    gauge = df.filter(col("zone") == INGEST_GAUGE_ZONE).select("zone", "fare")
    agg = df.filter(col("zone").isin(list(INGEST_ZONES))).aggregate(
        ["zone"], [("sum", "fare", "fare_sum"), ("count", None, "n")])
    timed = _TimedIngest(hs)
    walls["seed_and_create_s"] = time.perf_counter() - t0

    def count_rows(snapshot=None) -> tuple[int, int]:
        k1 = segment_reduce.launches
        n = len(session.run(gauge, snapshot=snapshot).decode()["zone"])
        return n, segment_reduce.launches - k1

    def zone_agg(snapshot=None) -> tuple[tuple, int]:
        k1 = segment_reduce.launches
        ans = _ingest_answers(session.run(agg, snapshot=snapshot))
        return ans, segment_reduce.launches - k1

    changelog = root / "changes.jsonl"
    changelog.touch()
    daemon = IngestDaemon(timed).watch("trips_zone", changelog=changelog)
    stats0 = {k: stats.get(k) for k in ("ingest.commits", "ingest.compactions", "ingest.commit_failures",
                                        "ingest.compact_failures", "ingest.rows", "ingest.bytes",
                                        "ingest.snapshots", "ingest.pinned_reads", "ingest.deferred")}

    # Pinned before any commit: this reader stays on the seed world for the
    # whole run, however many micro-batches land underneath.
    pinned = session.pin_snapshot()
    (pinned_rows, _), (pinned_agg, _) = count_rows(pinned), zone_agg(pinned)
    seed_rows, _ = count_rows()
    _, seed_zones, seed_counts, seed_sums, seed_abs = _ingest_reference(data)
    if (pinned_rows, pinned_agg[:2]) != (seed_rows, (seed_zones, seed_counts)) or not np.all(
            np.abs(pinned_agg[2] - seed_sums) <= sum_tolerance(np.asarray(seed_counts), seed_abs)):
        raise AssertionError(f"3j: the admission answer {pinned_rows}, {pinned_agg[:2]} is not pyarrow's "
                             f"{seed_counts}")
    pinned_tol = sum_tolerance(np.asarray(seed_counts), seed_abs)
    floors: list[dict] = []
    floors_lock = threading.Lock()
    expected = {"gauge": seed_rows, "agg": sum(seed_counts)}
    errors_untyped: list[str] = []
    typed_refusals: list[str] = []
    stop = threading.Event()
    zone_set = np.asarray(INGEST_ZONES)

    cdc = {"rng": np.random.default_rng(1234), "next_id": 10_000_000}

    def publish_batch(b: int) -> tuple[int, np.ndarray]:
        """Batch b built in staging and published by `os.replace`; its
        bytes and zones."""
        nb = gen_trips_batch(staging, batch_rows, b)
        fname = f"batch-{b:04d}.parquet"
        zones = np.asarray(pq.read_table(staging / fname, columns=["zone"]).column("zone"))
        os.replace(staging / fname, data / fname)
        return nb, zones

    def publish_wave() -> np.ndarray:
        """One CDC wave of `cdc_rows` JSON rows appended to the changelog;
        its zones."""
        rng = cdc["rng"]
        wave = rng.integers(0, 265, cdc_rows)
        with open(changelog, "a", encoding="utf-8") as f:
            for z in wave:
                f.write(json.dumps({"trip_id": cdc["next_id"], "zone": int(z),
                                    "fare": round(float(rng.random() * 80), 3),
                                    "distance": round(float(rng.random() * 30), 3)}) + "\n")
                cdc["next_id"] += 1
        return wave

    def arrived(zones: np.ndarray) -> None:
        with floors_lock:
            expected["gauge"] += int((zones == INGEST_GAUGE_ZONE).sum())
            expected["agg"] += int(np.isin(zones, zone_set).sum())
            floors.append({"arrived": time.perf_counter(), "gauge": expected["gauge"], "agg": expected["agg"],
                           "seen_at": None})

    def producer():
        """bench_ingest's producer: a batch, then its wave, each a unit of
        arrival; then wait for the commits to keep up."""
        nonlocal total_bytes
        for b in range(1, batches + 1):
            nb, zones = publish_batch(b)
            total_bytes += nb
            arrived(zones)
            arrived(publish_wave())
            deadline = time.perf_counter() + 120
            while time.perf_counter() < deadline and not stop.is_set():
                if daemon.snapshot()["commits"] >= b:
                    break
                time.sleep(0.02)

    latencies: list[float] = []
    serves = {"gauge": 0, "agg": 0, "backwards": 0, "stale_past_lag": 0}
    pinned_state = {"reads": 0, "violations": []}
    k1_by_query = {"gauge": 0, "agg": 0, "pinned_gauge": 0, "pinned_agg": 0}
    high = {"gauge": seed_rows, "agg": sum(seed_counts)}

    def querier():
        turn = 0
        while not stop.is_set():
            kind = "gauge" if turn % 2 == 0 else "agg"
            turn += 1
            t_start = time.perf_counter()
            try:
                if kind == "gauge":
                    n, k1 = count_rows()
                else:
                    ans, k1 = zone_agg()
                    n = sum(ans[1])
            except HyperspaceError as e:
                typed_refusals.append(f"{type(e).__name__}: {e}"[:200])
                continue
            except Exception as e:  # noqa: BLE001 — the gate
                errors_untyped.append(f"{type(e).__name__}: {e}"[:400])
                continue
            t_done = time.perf_counter()
            latencies.append(t_done - t_start)
            serves[kind] += 1
            k1_by_query[kind] += k1
            if n < high[kind]:
                serves["backwards"] += 1
            high[kind] = max(high[kind], n)
            with floors_lock:
                # Every unit that arrived more than maxLagSeconds before
                # this query started must be in its answer; the first
                # serve of the gauge covering a unit stamps its lag.
                floor = max([u[kind] for u in floors if t_start - u["arrived"] > INGEST_LAG_S] or [0])
                for u in floors:
                    if kind == "gauge" and u["seen_at"] is None and n >= u["gauge"]:
                        u["seen_at"] = t_done
            if n < floor:
                serves["stale_past_lag"] += 1
            try:
                pinned_state["reads"] += 1
                pn, k1g = count_rows(pinned)
                pa_, k1a = zone_agg(pinned)
                k1_by_query["pinned_gauge"] += k1g
                k1_by_query["pinned_agg"] += k1a
                if pn != pinned_rows or pa_[:2] != pinned_agg[:2] or not np.all(
                        np.abs(pa_[2] - pinned_agg[2]) <= pinned_tol):
                    pinned_state["violations"].append((pn, pa_[1]))
            except Exception as e:  # noqa: BLE001 — the gate
                errors_untyped.append(f"pinned {type(e).__name__}: {e}"[:400])

    plane = obs_http.acquire()
    try:
        daemon.start()
        t_ingest0 = time.perf_counter()
        qt = threading.Thread(target=querier, name="ingest-querier", daemon=True)
        pt = threading.Thread(target=producer, name="ingest-producer", daemon=True)
        qt.start()
        pt.start()
        # /healthz once while the daemon runs: its ingest section.
        while pt.is_alive() and daemon.snapshot()["commits"] < 1:
            time.sleep(0.05)
        with urllib.request.urlopen(plane.url("/healthz"), timeout=30) as r:
            health = json.loads(r.read())
        pt.join(timeout=900)
        if pt.is_alive():
            raise AssertionError("3j: the producer did not finish in 900 s")
        drained = daemon.drain(timeout=300)
        t_ingest = time.perf_counter() - t_ingest0
        commits = daemon.snapshot()["commits"]
        stop.set()
        qt.join(timeout=60)
        daemon.stop()
    finally:
        stop.set()
        daemon.stop()
        obs_http.release()
    walls["ingest_window_s"] = t_ingest
    sections = [s for s in health.get("ingest", []) if s.get("watched") == ["trips_zone"]]
    if not sections or not sections[0]["running"] or sections[0]["mode"] != "thread":
        raise AssertionError(f"3j: /healthz's ingest section {health.get('ingest')}")
    out["healthz_ingest"] = sections[0]

    t0 = time.perf_counter()
    final_rows, k1_final_gauge = count_rows()
    final_agg, k1_final_agg = zone_agg()
    pinned_final, _ = count_rows(pinned)
    pinned_final_agg, _ = zone_agg(pinned)
    pinned.release()
    ref_rows, ref_zones, ref_counts, ref_sums, ref_abs = _ingest_reference(data)
    walls["final_and_reference_s"] = time.perf_counter() - t0
    t_end = t_ingest0 + t_ingest
    lags = [max((u["seen_at"] if u["seen_at"] is not None else t_end) - u["arrived"], 0.0) for u in floors]
    lat = sorted(latencies)
    p99 = float(np.percentile(lat, 99)) if lat else float("nan")
    gbps = (total_bytes / 1e9) / timed.commit_s if timed.commit_s > 0 else 0.0
    counters = {k: stats.get(k) - v for k, v in stats0.items()}
    actions = _ingest_log_actions(root / "indexes" / "trips_zone", max_deltas)
    compactions = sum(1 for kind, _ in actions if kind == "OPTIMIZING")
    out.update({
        "dataset_bytes": total_bytes, "rows_expected_gauge": expected["gauge"],
        "commits": commits, "compactions": compactions, "counters": counters,
        "serves": dict(serves), "typed_refusals": len(typed_refusals), "errors_untyped": errors_untyped[:10],
        "pinned": {"admission_rows": pinned_rows, "admission_counts": list(pinned_agg[1]),
                   "reads": pinned_state["reads"], "violations": len(pinned_state["violations"])},
        "freshness_lag_s": {"mean": float(np.mean(lags)) if lags else None,
                            "max": float(np.max(lags)) if lags else None, "bound": INGEST_LAG_S},
        "completed_p99_s": p99, "completed_p50_s": float(np.percentile(lat, 50)) if lat else None,
        "p99_bound_s": INGEST_P99_S,
        "throughput": {"gbps": gbps, "refresh_commit_s": timed.commit_s, "floor_gbps": INGEST_FLOOR_GBPS,
                       "meets_floor": gbps >= INGEST_FLOOR_GBPS, "gated": False},
        "builds": timed.builds, "log_actions": [k for k, _ in actions],
        "k1_launches": dict(k1_by_query),
    })
    failures = []
    if pinned_state["violations"] or pinned_final != pinned_rows or pinned_final_agg[:2] != pinned_agg[:2] \
            or not np.all(np.abs(pinned_final_agg[2] - pinned_agg[2]) <= pinned_tol):
        failures.append(f"pinned reads differ from the admission answer: {pinned_state['violations'][:3]}")
    if pinned_state["reads"] < 10 or commits < 2:
        failures.append(f"{pinned_state['reads']} pinned reads across {commits} commits")
    if serves["backwards"] or serves["stale_past_lag"]:
        failures.append(f"serves {serves}")
    if errors_untyped:
        failures.append(f"untyped errors {errors_untyped[:3]}")
    if not p99 < INGEST_P99_S:
        failures.append(f"completed p99 {p99} s")
    if not drained or final_rows != expected["gauge"] or final_rows != ref_rows:
        failures.append(f"drained {drained}: gauge {final_rows}, expected {expected['gauge']}, pyarrow {ref_rows}")
    if final_agg[:2] != (ref_zones, ref_counts) or not np.all(
            np.abs(final_agg[2] - ref_sums) <= sum_tolerance(np.asarray(ref_counts), ref_abs)):
        failures.append(f"the live aggregate {final_agg[:2]} against pyarrow {ref_counts}")
    if counters["ingest.commits"] < batches or commits < batches:
        failures.append(f"{counters['ingest.commits']} commits")
    if compactions < 1 or counters["ingest.compactions"] != compactions:
        failures.append(f"{compactions} compactions in the log, {counters['ingest.compactions']} counted")
    if counters["ingest.commit_failures"] or counters["ingest.compact_failures"]:
        failures.append(f"failures {counters}")
    wrong = [b for b in timed.builds if not str(b["sort_device"]).startswith(device.type)]
    if wrong or len(timed.builds) != counters["ingest.commits"] + counters["ingest.compactions"]:
        failures.append(f"builds {timed.builds}")
    if cuda and (k1_by_query["gauge"] or k1_by_query["pinned_gauge"] or k1_final_gauge
                 or not k1_final_agg or min(serves["agg"], k1_by_query["agg"]) < 1
                 or k1_by_query["agg"] < serves["agg"] or k1_by_query["pinned_agg"] < pinned_state["reads"]):
        failures.append(f"K1 launches by query {k1_by_query}, final gauge {k1_final_gauge} / agg {k1_final_agg}")
    if cuda and topk.launches:
        failures.append(f"K3 launched {topk.launches} times")
    if failures:
        raise AssertionError("3j (a): " + "; ".join(failures))
    log(json.dumps({"ingest_throughput": out["throughput"],
                    "verdict": "meets the floor" if out["throughput"]["meets_floor"] else "below the floor",
                    "gate": "printed, not enforced"}))

    # K1's input at the ingest aggregate's own shape, over the drained index.
    calls = capture_k1(lambda: session.run(agg), aggregate)
    if cuda and not calls:
        raise AssertionError("3j: the zone aggregate made no K1 call through the aggregate")
    k1_inputs = {"ingest zone aggregate": calls[0]} if calls else {}

    # (b) The process worker on (a)'s index.
    t_b = time.perf_counter()
    index_dir = root / "indexes" / "trips_zone"
    jroot = root / "_obs_ingest"
    saved_journal = journal.export_state()
    journal.configure(enabled=True, root=str(jroot))
    conf.set("hyperspace.ingest.processWorker", "true")

    def publish(b: int) -> None:
        _, zones = publish_batch(b)
        arrived(zones)
        arrived(publish_wave())

    def lm_id() -> int:
        return json.loads((index_dir / "_hyperspace_log" / "latestStable").read_text())["id"]

    k1_before = segment_reduce.launches
    workers: list[dict] = []
    try:
        publish(batches + 1)
        base_id = lm_id()
        w1 = IngestDaemon(hs).watch("trips_zone", changelog=changelog)
        t0, spawned_at = time.perf_counter(), time.time()
        w1.start()
        pid1 = w1.worker_pid()
        deadline = time.perf_counter() + 300
        while time.perf_counter() < deadline and lm_id() <= base_id and w1._host.alive_count():
            time.sleep(0.05)
        if lm_id() <= base_id:
            raise AssertionError(f"3j (b): the process worker never committed (alive: {w1._host.alive_count()})")
        first_commit_s = time.perf_counter() - t0
        os.kill(pid1, signal.SIGKILL)
        deadline = time.perf_counter() + 60
        while time.perf_counter() < deadline and w1._host.alive_count() > 0:
            time.sleep(0.05)
        alive = w1._host.alive_count()
        w1.stop(timeout=10)
        if alive:
            raise AssertionError("3j (b): the SIGKILLed worker is still alive")
        workers.append({"pid": pid1, "spawned_at": spawned_at, "spawn_to_first_commit_s": first_commit_s,
                        "killed": True})
        publish(batches + 2)
        t0 = time.perf_counter()
        first = hs.recover("trips_zone")
        again = hs.recover("trips_zone")
        stable = json.loads((index_dir / "_hyperspace_log" / "latestStable").read_text())
        on_disk = sorted(p.name for p in index_dir.glob("v__=*"))
        if stable["state"] != "ACTIVE" or again["rolled"] or again["orphans_removed"] \
                or on_disk != sorted(stable["content"]["directories"]):
            raise AssertionError(f"3j (b): recover left {stable['state']}, {on_disk} against "
                                 f"{stable['content']['directories']}; the second recover {again}")
        walls["b_recover_s"] = time.perf_counter() - t0
        out["b_recover"] = {"first": first, "second": again, "version_dirs": on_disk}
        base_id = lm_id()
        w2 = IngestDaemon(hs).watch("trips_zone", changelog=changelog)
        t0, spawned_at = time.perf_counter(), time.time()
        w2.start()
        pid2 = w2.worker_pid()
        deadline = time.perf_counter() + 300
        rows = -1
        while time.perf_counter() < deadline and w2._host.alive_count():
            if lm_id() > base_id:
                rows, _ = count_rows()
                if rows >= expected["gauge"]:
                    break
            time.sleep(0.1)
        drain_s = time.perf_counter() - t0
        drained = w2.drain(timeout=120)
        w2.stop(timeout=30)
        latest = max(int(p.name) for p in (index_dir / "_hyperspace_log").iterdir() if p.name.isdigit())
        if latest != lm_id():
            raise AssertionError(f"3j (b): the stopped worker left log entry {latest} past the stable {lm_id()}")
        workers.append({"pid": pid2, "spawned_at": spawned_at, "spawn_to_drained_s": drain_s, "killed": False})
    finally:
        conf.set("hyperspace.ingest.processWorker", "false")
        journal.seal()
        journal.configure(enabled=bool(saved_journal["enabled"]), root=saved_journal["root"] or "")
    k1_window = segment_reduce.launches - k1_before
    walls["b_s"] = time.perf_counter() - t_b
    t0 = time.perf_counter()
    final_rows, _ = count_rows()
    final_agg, k1_b_agg = zone_agg()
    ref_rows, ref_zones, ref_counts, ref_sums, ref_abs = _ingest_reference(data)
    walls["b_check_s"] = time.perf_counter() - t0
    for w in workers:
        records = _journal_records(jroot, w["pid"])
        w["commits"] = [{k: r["event"]["fields"].get(k) for k in ("log_id", "sort_device")} for r in records
                        if r.get("kind") == "event" and r["event"].get("name") == "ingest.committed"]
        # Start-up: the spawn to the worker's journal install (its imports
        # done), on the host's wall clock.
        installed = [r["ts"] for r in records if r.get("kind") == "process"]
        w["startup_s"] = installed[0] - w.pop("spawned_at") if installed else None
    out["b_workers"] = workers
    out["b_worker_startup_s"] = [w["startup_s"] for w in workers]
    failures = []
    if not drained or final_rows != expected["gauge"] or final_rows != ref_rows:
        failures.append(f"drained {drained}: gauge {final_rows}, expected {expected['gauge']}, pyarrow {ref_rows}")
    if final_agg[:2] != (ref_zones, ref_counts) or not np.all(
            np.abs(final_agg[2] - ref_sums) <= sum_tolerance(np.asarray(ref_counts), ref_abs)):
        failures.append(f"the live aggregate {final_agg[:2]} against pyarrow {ref_counts}")
    if k1_window:
        failures.append(f"K1 launched {k1_window} times in the workers' window")
    if cuda and not k1_b_agg:
        failures.append("K1 did not launch in the aggregate after the workers")
    for w in workers:
        if not w["commits"] or w["startup_s"] is None or any(not str(c["sort_device"]).startswith(device.type) for c in w["commits"]):
            failures.append(f"worker {w['pid']}'s journaled commits {w['commits']}")
    if failures:
        raise AssertionError("3j (b): " + "; ".join(failures))
    walls["phase_s"] = time.perf_counter() - t_phase
    out["walls_s"] = walls
    return out, k1_inputs


def vector_lifecycle(device, vctx: dict) -> dict:
    """The vector index's lifecycle at the end of the vector path, on its
    index: 10% more rows drawn from the same clusters (gen_embeddings'
    append), an incremental refresh (the appended rows assigned to the
    existing centroids on the card), `ann_search` at nprobe 8 and full
    probe (k = 10) against brute force and a float64 exact top-10 over
    every row; then optimize (retrained centroids, one version) and the
    same searches."""
    import torch

    from hyperspace_tpu_torch.datagen import gen_embeddings

    session, hs, df, workdir = vctx["session"], vctx["hs"], vctx["df"], vctx["workdir"]
    n, dim, partitions, queries = vctx["n"], vctx["dim"], vctx["partitions"], vctx["queries"]
    index_dir = workdir / "vindexes" / "annidx"
    out: dict = {"actions_s": {}, "checks": {}}
    extra = gen_embeddings(workdir / "emb", n, dim, clusters=partitions, seed=7, appended=int(n * VECTOR_APPENDED))
    emb_all = np.concatenate([vctx["emb"], extra])
    out["rows"] = len(emb_all)
    t0 = time.perf_counter()
    exact_ids, exact_d2 = exact_l2_topk(emb_all, queries, 10)
    out["exact_host_float64_s"] = time.perf_counter() - t0

    def searches(stage: str) -> None:
        def ids_of(res):
            return res.rows.host_column("id").reshape(len(queries), 10)

        session.disable_hyperspace()
        brute = hs.ann_search(df, queries, k=10)
        session.enable_hyperspace()
        got = {}
        for nprobe in (8, partitions):
            hs.ann_search(df, queries, k=10, nprobe=nprobe)  # cold
            t0 = time.perf_counter()
            got[nprobe] = hs.ann_search(df, queries, k=10, nprobe=nprobe)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            out[f"{stage}_ann_nprobe{nprobe}_s"] = time.perf_counter() - t0
        out["checks"][f"{stage}_brute"] = check_against_exact(
            f"{stage} brute force", brute.scores, ids_of(brute), exact_ids, exact_d2, emb_all, queries, 10)
        out["checks"][f"{stage}_full_probe"] = check_against_exact(
            f"{stage} full probe", got[partitions].scores, ids_of(got[partitions]), exact_ids, exact_d2, emb_all,
            queries, 10)
        if not np.allclose(got[partitions].scores, brute.scores, rtol=1e-4,
                           atol=2 * l2_rounding(emb_all, queries, exact_ids).max()):
            raise AssertionError(f"{stage}: full probe scores differ from brute force")
        got8 = ids_of(got[8])
        recall = float(np.mean([len(set(got8[i]) & set(exact_ids[i, :10])) / 10 for i in range(len(queries))]))
        out["checks"][f"{stage}_recall_at_10_nprobe8"] = recall
        if recall < 0.8:
            raise AssertionError(f"{stage}: recall@10 at nprobe 8 is {recall} < 0.8")

    before = np.load(index_dir / "v__=0" / "_centroids.npy")
    t0 = time.perf_counter()
    hs.refresh_index("annidx", mode="incremental")
    out["actions_s"]["refresh_incremental"] = time.perf_counter() - t0
    out["refresh_incremental_phases_s"] = session.last_build_stats["phases_s"]
    entry = session.manager.get_indexes()[0]
    if entry.content.directories != ["v__=0", "v__=1"]:
        raise AssertionError(f"incremental refresh: version dirs {entry.content.directories}")
    if not np.array_equal(np.load(index_dir / "v__=1" / "_centroids.npy"), before):
        raise AssertionError("incremental refresh moved the centroids")
    searches("incremental")
    t0 = time.perf_counter()
    hs.optimize_index("annidx")
    out["actions_s"]["optimize"] = time.perf_counter() - t0
    out["optimize_phases_s"] = session.last_build_stats["phases_s"]
    entry = session.manager.get_indexes()[0]
    if entry.content.directories != ["v__=2"]:
        raise AssertionError(f"optimize: version dirs {entry.content.directories}")
    searches("optimized")
    return out
# -- vector path --------------------------------------------------------------


def exact_l2_topk(emb: np.ndarray, queries: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """The exact top-k+1 by l2 of each query on the host in float64:
    (row ids [q, k+1], squared distances [q, k+1]), nearest first."""
    e = emb.astype(np.float64)
    q = queries.astype(np.float64)
    d2 = (q * q).sum(1)[:, None] - 2.0 * (q @ e.T) + (e * e).sum(1)[None, :]
    part = np.argpartition(d2, k, axis=1)[:, : k + 1]
    ordered = np.take_along_axis(part, np.argsort(np.take_along_axis(d2, part, 1), axis=1, kind="stable"), 1)
    return ordered, np.take_along_axis(d2, ordered, 1)


def l2_rounding(emb: np.ndarray, queries: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Bound on the float32 error of an l2 score -(|q|² - 2q·x + |x|²) over
    d dimensions: each of the three terms is within d·u of its scale and
    the two additions add 2u, so within (d + 2)·u·(|q| + |x|)², u = 2^-24."""
    qn = np.linalg.norm(queries.astype(np.float64), axis=1)[:, None]
    xn = np.linalg.norm(emb[ids].astype(np.float64), axis=2)
    return (emb.shape[1] + 2) * 2.0**-24 * (qn + xn) ** 2


def check_against_exact(name: str, scores, ids, exact_ids, exact_d2, emb, queries, k: int) -> dict:
    """A float32 search result (scores [q, k], row ids [q, k]) against the
    float64 exact answer: every score within rtol 1e-4 plus the float32
    rounding bound of its slot, and the id sets equal wherever the exact
    gap between the k-th and (k+1)-th distance exceeds twice that bound.
    Returns how many queries the set check covered."""
    want = -exact_d2[:, :k]
    tol = l2_rounding(emb, queries, exact_ids[:, : k + 1])
    if scores.shape != want.shape or not np.isfinite(scores).all():
        raise AssertionError(f"{name}: scores of shape {scores.shape}, finite {np.isfinite(scores).all()}")
    err = np.abs(scores - want)
    if not np.all(err <= 1e-4 * np.abs(want) + tol[:, :k]):
        raise AssertionError(f"{name}: scores beyond rtol 1e-4 plus the float32 bound ({err.max()})")
    separated = (exact_d2[:, k] - exact_d2[:, k - 1]) > 2 * tol[:, k - 1 : k + 1].max(axis=1)
    for i in np.nonzero(separated)[0]:
        if set(ids[i].tolist()) != set(exact_ids[i, :k].tolist()):
            raise AssertionError(f"{name}: query {i} found other rows than the exact top {k}")
    return {"queries_set_checked": int(separated.sum()), "max_abs_score_err": float(err.max())}


def check_scores_of_rows(name: str, scores, ids, exact_top, emb, queries) -> dict:
    """An approximate search result (scores [q, k], row ids [q, k]): the
    ids of a row distinct, its scores descending, and each score its
    row's float64 l2 score within rtol 1e-4 plus the float32 rounding
    bound (l2_rounding). Returns the recall against `exact_top`."""
    if scores.shape != ids.shape or not np.isfinite(scores).all():
        raise AssertionError(f"{name}: scores of shape {scores.shape}, finite {np.isfinite(scores).all()}")
    if any(len(set(r.tolist())) != len(r) for r in ids):
        raise AssertionError(f"{name}: a query returned a row twice")
    if np.any(np.diff(scores, axis=1) > 0):
        raise AssertionError(f"{name}: scores are not in descending order")
    q = queries.astype(np.float64)
    d2 = np.stack([((emb[ids[i]].astype(np.float64) - q[i]) ** 2).sum(1) for i in range(len(q))])
    err = np.abs(scores + d2)
    if not np.all(err <= 1e-4 * d2 + l2_rounding(emb, queries, ids)):
        raise AssertionError(f"{name}: scores beyond rtol 1e-4 plus the float32 bound ({err.max()})")
    recall = np.mean([len(set(ids[i].tolist()) & set(exact_top[i].tolist())) / ids.shape[1] for i in range(len(q))])
    return {"recall": float(recall), "max_abs_score_err": float(err.max())}


def capture_topk(fn) -> list:
    """Runs `fn` once with every K3 call of the vector search recorded, in
    call order: (scores, k), copied on the device. The calls still launch
    K3."""
    from hyperspace_tpu_torch.vector import search

    real = search.topk
    calls = []

    def recording(scores, k):
        calls.append((scores.clone(), k))
        return real(scores, k)

    search.topk = recording
    try:
        fn()
    finally:
        search.topk = real
    return calls


def vector_path(device, workdir: Path, n: int, dim: int = 128, partitions: int = 64) -> tuple[dict, dict, dict]:
    """The port's vector index through its user entry points, at the shape
    of SIFT1M (1M x 128 float32, l2, k = 10) with the settings of
    benchmarks/bench_ann.py. Returns (the phase wall times and checks,
    the K3 inputs at the path's four shapes, what the vector lifecycle
    reuses)."""
    import pyarrow.parquet as pq
    import torch

    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, VectorIndexConfig
    from hyperspace_tpu_torch.datagen import gen_embeddings
    from hyperspace_tpu_torch.execution.io import read_manifest
    from hyperspace_tpu_torch.ops.topk import launches_per_call, topk, topk_plain

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for float32 matrix products")
    phases: dict = {}
    checks: dict = {}
    t0 = time.perf_counter()
    emb = gen_embeddings(workdir / "emb", n, dim, clusters=partitions, seed=7)
    phases["datagen_s"] = time.perf_counter() - t0
    session = HyperspaceSession(system_path=str(workdir / "vindexes"), device=device)
    hs = Hyperspace(session)
    df = session.parquet(workdir / "emb")
    t0 = time.perf_counter()
    hs.create_vector_index(df, VectorIndexConfig("annidx", "emb", ["id"], num_partitions=partitions))
    sync()
    phases["build_s"] = time.perf_counter() - t0
    phases["build_phases_s"] = session.last_build_stats["phases_s"]

    # The index on disk: partition row counts sum to n and match the manifest.
    vdir = workdir / "vindexes" / "annidx" / "v__=0"
    file_rows = [pq.read_metadata(vdir / f"bucket-{p:05d}.parquet").num_rows for p in range(partitions)]
    manifest = read_manifest(vdir)
    if sum(file_rows) != n or manifest["bucketRows"] != file_rows:
        raise AssertionError(f"partition rows {sum(file_rows)} of {n}; manifest agrees: {manifest['bucketRows'] == file_rows}")
    checks["partition_rows"] = {"min": min(file_rows), "max": max(file_rows)}

    queries = emb[np.random.default_rng(9).choice(n, 32, replace=False)] + 0.01
    # Past K3's shared-memory sort; at most half the rows an nprobe-8 query
    # probes (n / 8), which only a rehearsal's small n makes the limit.
    big_k = min(BIG_K, n // 16)
    t0 = time.perf_counter()
    exact_ids, exact_d2 = exact_l2_topk(emb, queries, big_k)
    phases["exact_host_float64_s"] = time.perf_counter() - t0

    def timed(label, fn):
        t0 = time.perf_counter()
        out = fn()
        sync()
        phases[label] = time.perf_counter() - t0
        return out

    def ids_of(res, k):
        return res.rows.host_column("id").reshape(len(queries), k)

    before = topk.launches
    session.disable_hyperspace()
    brute = {}
    for k in (10, 100):
        timed(f"brute_k{k}_cold_s", lambda: hs.ann_search(df, queries, k=k))
        res = timed(f"brute_k{k}_s", lambda: hs.ann_search(df, queries, k=k))
        brute[k] = res
        checks[f"brute_k{k}"] = check_against_exact(
            f"brute force k={k}", res.scores, ids_of(res, k), exact_ids, exact_d2, emb, queries, k
        )
    session.enable_hyperspace()
    ann = {}
    for nprobe in (8, partitions):
        timed(f"ann_nprobe{nprobe}_cold_s", lambda: hs.ann_search(df, queries, k=10, nprobe=nprobe))
        ann[nprobe] = timed(f"ann_nprobe{nprobe}_s", lambda: hs.ann_search(df, queries, k=10, nprobe=nprobe))
    # Full probe is brute force: the same id sets (where the exact gap at
    # the 10th row clears the float32 bound) and scores.
    checks["full_probe"] = check_against_exact(
        "full probe", ann[partitions].scores, ids_of(ann[partitions], 10), exact_ids, exact_d2, emb, queries, 10
    )
    if not np.allclose(ann[partitions].scores, brute[10].scores, rtol=1e-4, atol=2 * l2_rounding(emb, queries, exact_ids[:, :10]).max()):
        raise AssertionError("full probe scores differ from brute force")
    exact10 = exact_ids[:, :10]
    got8 = ids_of(ann[8], 10)
    recall = float(np.mean([len(set(got8[i]) & set(exact10[i])) / 10 for i in range(len(queries))]))
    checks["recall_at_10_nprobe8"] = recall
    if recall < 0.8:
        raise AssertionError(f"recall@10 at nprobe 8 is {recall} < 0.8")
    # The index lookup alone (index listing, source fingerprint): the
    # host's share of each warm indexed query that brute force skips.
    from hyperspace_tpu_torch.vector.search import find_vector_index

    timed("ann_find_index_s", lambda: find_vector_index(session, df))
    # The kernels of topk.cu are all named topk_*.
    profiled = device_time(lambda: hs.ann_search(df, queries, k=10, nprobe=8), ("topk_",))
    # Each call's share of K3's device time: routing runs first, in
    # launches_per_call(partitions) kernels, and the candidates' follow.
    each = profiled["kernel_ms_each"]["topk_"]
    split = launches_per_call(partitions, 8)
    profiled["topk_ms"] = (
        None if each is None else {"routing": sum(each[:split]), "candidates": sum(each[split:])}
    )
    phases["ann_nprobe8_profiled"] = profiled
    # Past K3's shared-memory sort (k > 2,048): brute force against the
    # exact top k, and an nprobe-8 search whose every score must be its
    # row's exact distance (it may miss rows of unprobed partitions).
    session.disable_hyperspace()
    res = timed(f"brute_k{big_k}_s", lambda: hs.ann_search(df, queries, k=big_k))
    checks[f"brute_k{big_k}"] = check_against_exact(
        f"brute force k={big_k}", res.scores, ids_of(res, big_k), exact_ids, exact_d2, emb, queries, big_k
    )
    session.enable_hyperspace()
    res = timed(f"ann_nprobe8_k{big_k}_s", lambda: hs.ann_search(df, queries, k=big_k, nprobe=8))
    checks[f"ann_nprobe8_k{big_k}"] = check_scores_of_rows(
        f"nprobe 8, k={big_k}", res.scores, ids_of(res, big_k), exact_ids[:, :big_k], emb, queries
    )
    # 2 brute force x (cold, warm) + 2 nprobe x (cold, warm) x 2 (route,
    # candidates) + the profiled query's 2, twice + brute force and nprobe
    # 8 at big_k (1 and 2).
    launched = topk.launches - before
    if device.type == "cuda" and launched != 4 + 8 + 4 + 3:
        raise AssertionError(f"K3 launched {launched} times on the vector path, expected 19")

    # K3's inputs at the path's shapes: the routing and candidate scores
    # of one nprobe-8 query, and the brute-force score matrix (for k = 10
    # and k = 100).
    routing, candidates = capture_topk(lambda: hs.ann_search(df, queries, k=10, nprobe=8))
    probed = torch.unique(topk_plain(*routing)[1])
    checks["nprobe8_partitions_in_union"] = len(probed)
    checks["nprobe8_candidates"] = candidates[0].shape[1]
    _, (big_candidates, _) = capture_topk(lambda: hs.ann_search(df, queries, k=big_k, nprobe=8))
    session.disable_hyperspace()
    (brute_scores, _), = capture_topk(lambda: hs.ann_search(df, queries, k=10))
    k3_inputs = {
        "routing": routing, "candidates": candidates,
        "brute force": (brute_scores, 10), "brute force k=100": (brute_scores, 100),
        f"candidates k={big_k}": (big_candidates, big_k), f"brute force k={big_k}": (brute_scores, big_k),
    }
    vctx = {"session": session, "hs": hs, "df": df, "workdir": workdir, "emb": emb, "queries": queries,
            "n": n, "dim": dim, "partitions": partitions}
    return {"rows": n, "dim": dim, "partitions": partitions, "queries": len(queries),
            "phases": phases, "checks": checks}, k3_inputs, vctx


def tie_heavy(scores):
    """The brute-force scores rounded to 16 distinct values (integers -8
    to 7), with an all-NaN row, scattered NaN and -inf, and signed zeros."""
    import torch

    lo, hi = scores.min(), scores.max()
    x = torch.floor((scores - lo) / (hi - lo) * 16).clamp(0, 15) - 8
    g = torch.Generator(device=scores.device).manual_seed(5)
    pick = lambda: torch.randint(0, x.shape[1], (x.shape[0], 64), generator=g, device=x.device)  # noqa: E731
    x.scatter_(1, pick(), float("nan"))
    x.scatter_(1, pick(), float("-inf"))
    x.scatter_(1, pick(), -0.0)
    x[0] = float("nan")
    return x.contiguous()


def k3_phase(device, scores, k: int) -> dict:
    """K3 against its plain version on the card at one path shape:
    bit-equal values and equal indices. Times kernel, plain version and
    torch.topk (the library yardstick: its tie order is unspecified, so it
    is timed only) with CUDA events."""
    import torch

    from hyperspace_tpu_torch.ops.topk import _sm_count, launches_per_call, select_plan, topk, topk_plain

    vals, idx = topk(scores, k)
    torch.cuda.synchronize()
    want_vals, want_idx = topk_plain(scores, k)
    if not (torch.equal(idx, want_idx) and torch.equal(vals.view(torch.int32), want_vals.view(torch.int32))):
        raise AssertionError(f"K3 differs from its plain version at {tuple(scores.shape)}, k={k}")
    # The largest difference over the values finite in both (the rest are
    # bit-equal -inf, checked above) and over the indices.
    finite = torch.isfinite(vals) & torch.isfinite(want_vals)
    max_abs_err = max(
        float((vals[finite] - want_vals[finite]).abs().max()) if bool(finite.any()) else 0.0,
        float((idx.long() - want_idx.long()).abs().max()) if idx.numel() else 0.0,
    )
    q, n = scores.shape
    nbytes = q * n * 4 + q * k * 8  # scores read once, values and indices written once
    ops = q * n  # at least one compare a score
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = ops / INT32_OPS * 1e3
    blocks, chunk = select_plan(q, n, _sm_count(torch.cuda.current_device()))
    return {
        "q": q, "n": n, "k": k,
        # The design's split of a row (0 blocks: one block sorts the row)
        # and its kernels a call.
        "blocks_per_row": blocks, "chunk": chunk, "kernels_per_call": launches_per_call(n, k),
        "ms": cuda_ms(lambda: topk(scores, k)),
        "call": lambda: topk(scores, k),
        "plain_ms": cuda_ms(lambda: topk_plain(scores, k)),
        "library_ms": cuda_ms(lambda: torch.topk(scores, k, dim=1)),
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "bytes": nbytes, "max_abs_err": max_abs_err,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=1.0, help="TPC-H scale factor (1.0 = 1.5M orders, about 6.0M rows)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--build-sf", type=float, default=BUILD_SF, help="phase 3g's lineitem scale factor")
    args = ap.parse_args(argv)
    card_query = start_card_query()
    try:
        return run(args, card_query)
    finally:
        stop_process(card_query)


def run(args: argparse.Namespace, card_query: subprocess.Popen | None) -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; none is available")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    device = torch.device("cuda")
    with phase("kernel_build"):
        from hyperspace_tpu_torch.ops import kernels
        from hyperspace_tpu_torch.ops.segment_reduce import segment_reduce
        from hyperspace_tpu_torch.ops.sortkeys import run_bounds
        from hyperspace_tpu_torch.ops.topk import topk

        t0 = time.perf_counter()
        kernels.build()
        log(json.dumps({"kernel_build_s": time.perf_counter() - t0, "kernels": list(kernels.SOURCES)}))

    def zero_counts():
        segment_reduce.launches = 0
        run_bounds.launches = 0
        topk.launches = 0

    def read_counts(path: str, kernels_of_path: tuple) -> dict:
        counts = {"segment_reduce": segment_reduce.launches, "run_bounds": run_bounds.launches,
                  "topk": topk.launches}
        for name, count in counts.items():
            if (count == 0) == (name in kernels_of_path):
                raise AssertionError(f"kernel {name} launched {count} times on the {path} path")
        return counts

    from hyperspace_tpu_torch import stats

    t_script = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="hs_chip_smoke_"))
    try:
        with phase("main_path"):
            zero_counts()
            t0 = time.perf_counter()
            staged0 = {k: stats.get(k) for k in ("device.stage.bytes_zero_copy", "device.stage.bytes_copied")}
            result, ctx = main_path(device, args.sf, args.seed, work)
            result["phases"]["main_path_s"] = time.perf_counter() - t0
            # Zero-copy staging over the aggregate path's reads (most of them
            # cold: each query's first run).
            result["phases"]["staging_bytes"] = {k: stats.get(k) - v for k, v in staged0.items()}
            launches = {"aggregates": read_counts("aggregate", ("segment_reduce",))}
            log(json.dumps({"main_path": result, "launches": launches["aggregates"]}))
            log(json.dumps({"caches_after_path": "aggregate", **cache_stats()}))
        with phase("join_path"):
            zero_counts()
            t0 = time.perf_counter()
            join, k1_join_inputs, k2_inputs = join_path(device, ctx, args.sf)
            join["phases"]["join_path_s"] = time.perf_counter() - t0
            launches["join"] = read_counts("join", ("run_bounds", "segment_reduce"))
            log(json.dumps({"join_path": join, "launches": launches["join"]}))
            log(json.dumps({"caches_after_path": "join", **cache_stats()}))
        with phase("mesh_path"):
            zero_counts()
            t0 = time.perf_counter()
            mesh = mesh_path(device, ctx, args.sf, {"lineitem": result["phases"]["build_s"],
                                                    "orders": join["phases"]["orders_build_s"]})
            mesh["mesh_path_s"] = time.perf_counter() - t0
            launches["mesh"] = read_counts("mesh", ("run_bounds", "segment_reduce"))
            log(json.dumps({"mesh_path": mesh, "launches": launches["mesh"]}, default=str))
            log(json.dumps({"caches_after_path": "mesh", **cache_stats()}))
        with phase("join_types_path"):
            zero_counts()
            t0 = time.perf_counter()
            join_types = join_types_path(device, ctx, args.sf)
            join_types["join_types_path_s"] = time.perf_counter() - t0
            launches["join_types"] = read_counts("join types", ("run_bounds", "segment_reduce"))
            log(json.dumps({"join_types_path": join_types, "launches": launches["join_types"]}))
            log(json.dumps({"caches_after_path": "join types", **cache_stats()}))
        with phase("query_surface_path"):
            zero_counts()
            t0 = time.perf_counter()
            surface = query_surface_path(device, ctx, args.sf)
            surface["query_surface_path_s"] = time.perf_counter() - t0
            launches["query_surface"] = read_counts("query surface", ("run_bounds", "segment_reduce"))
            log(json.dumps({"query_surface_path": surface, "launches": launches["query_surface"]}))
            log(json.dumps({"caches_after_path": "query surface", **cache_stats()}))
        with phase("venue_path"):
            zero_counts()
            t0 = time.perf_counter()
            venues = venue_path(device, ctx, args.sf)
            venues["venue_path_s"] = time.perf_counter() - t0
            launches["venue"] = read_counts("venue", ("run_bounds", "segment_reduce"))
            log(json.dumps({"venue_path": {k: v for k, v in venues.items() if not isinstance(v, dict) or k in (
                "probe", "host_build_phases_s")}, "launches": launches["venue"],
                "script_s_so_far": time.perf_counter() - t_script}, default=str))
            log(json.dumps({"caches_after_path": "venue", **cache_stats()}))
        with phase("lifecycle_path"):
            zero_counts()
            t0 = time.perf_counter()
            lifecycle, k1_life_inputs, k2_life_inputs = lifecycle_path(device, ctx, args.sf)
            lifecycle["lifecycle_path_s"] = time.perf_counter() - t0
            launches["lifecycle"] = read_counts("lifecycle", ("run_bounds", "segment_reduce"))
            log(json.dumps({"lifecycle_path": lifecycle, "launches": launches["lifecycle"]}))
            log(json.dumps({"caches_after_path": "lifecycle", **cache_stats()}))
        with phase("serving_path"):
            zero_counts()
            t0 = time.perf_counter()
            serving = serving_path(device, ctx, args.sf)
            serving["serving_path_wall_s"] = time.perf_counter() - t0
            launches["serve"] = read_counts("serve", ("run_bounds", "segment_reduce"))
            log(json.dumps({"serving_path": serving, "launches": launches["serve"]}, default=str))
            log(json.dumps({"caches_after_path": "serve", **cache_stats()}))
        with phase("faults_path"):
            zero_counts()
            t0 = time.perf_counter()
            faults_rec, k1_faults_inputs = faults_path(device, ctx, args.sf)
            faults_rec["faults_path_wall_s"] = time.perf_counter() - t0
            launches["faults"] = read_counts("faults", ("run_bounds", "segment_reduce"))
            log(json.dumps({"faults_path": {k: v for k, v in faults_rec.items() if k != "sweep"},
                            "launches": launches["faults"]}, default=str))
            log(json.dumps({"caches_after_path": "faults", **cache_stats()}))
        with phase("build_scale_path"):
            zero_counts()
            t0 = time.perf_counter()
            scale, k1_scale_inputs = build_scale_path(device, ctx, args.sf, args.build_sf)
            scale["build_scale_path_wall_s"] = time.perf_counter() - t0
            launches["build_scale"] = read_counts("build at scale", ("segment_reduce",))
            log(json.dumps({"build_scale_path": scale, "launches": launches["build_scale"]}, default=str))
            log(json.dumps({"caches_after_path": "build at scale", **cache_stats()}))
            # Phase 3d's incremental refresh and taxi loop, with the host hash
            # path they ran on (PERF.md §5 holds the numpy hash's).
            log(json.dumps({"native_hash_refresh_and_taxi": {
                "hash_path": scale["builds"]["b_streaming"]["hash_path"],
                "li_live_refresh_incremental_s": lifecycle["actions_s"]["refresh_incremental"],
                "li_live_refresh_incremental_phases_s": lifecycle["refresh_incremental_build_phases_s"],
                "taxi_incremental_ingest_throughput_gbps": lifecycle["taxi"]["taxi_incremental_ingest_throughput_gbps"],
            }}))
        with phase("fleet_path"):
            zero_counts()
            t0 = time.perf_counter()
            fleet = fleet_path(device, ctx, args.sf)
            fleet["fleet_path_wall_s"] = time.perf_counter() - t0
            launches["fleet"] = read_counts("fleet", ("run_bounds", "segment_reduce"))
            # The members' launches, each read in its own process.
            launches["fleet_members"] = fleet["member_launches"]
            log(json.dumps({"fleet_path": {k: fleet.get(k) for k in (
                                "fleet_path_s", "fleet_path_wall_s", "fleets_ready_s", "serial_launches",
                                "member_launches", "compute_mode", "nvidia_smi_while_4_up")},
                            "launches": launches["fleet"], "member_launches": launches["fleet_members"]}))
            log(json.dumps({"caches_after_path": "fleet", **cache_stats()}))
        with phase("advisor_path"):
            zero_counts()
            t0 = time.perf_counter()
            advisor = advisor_path(device, ctx, args.sf)
            advisor["advisor_path_wall_s"] = time.perf_counter() - t0
            launches["advisor"] = read_counts("advisor", ("run_bounds", "segment_reduce"))
            log(json.dumps({"advisor_path": {k: v for k, v in advisor.items() if k != "queries"},
                            "launches": launches["advisor"], "script_s_so_far": time.perf_counter() - t_script},
                           default=str))
            log(json.dumps({"caches_after_path": "advisor", **cache_stats()}))
        with phase("ingest_path"):
            zero_counts()
            t0 = time.perf_counter()
            ingest, k1_ingest_inputs = ingest_path(device, work)
            ingest["ingest_path_wall_s"] = time.perf_counter() - t0
            launches["ingest"] = read_counts("ingest", ("segment_reduce",))
            log(json.dumps({"ingest_path": ingest, "launches": launches["ingest"],
                            "script_s_so_far": time.perf_counter() - t_script}, default=str))
            log(json.dumps({"caches_after_path": "ingest", **cache_stats()}))
        k1_join_inputs.update(k1_ingest_inputs)
        k1_join_inputs.update(k1_life_inputs)
        k1_join_inputs.update(k1_faults_inputs)
        k1_join_inputs.update(k1_scale_inputs)
        k2_inputs.update(k2_life_inputs)
        k1_agg_inputs = {**ctx["k1_inputs"], **ctx["k1_surface_inputs"]}
        del ctx
        with phase("vector_path"):
            zero_counts()
            t0 = time.perf_counter()
            vector, k3_inputs, vctx = vector_path(device, work, n=1_000_000)
            vector["phases"]["vector_path_s"] = time.perf_counter() - t0
            launches["vector"] = read_counts("vector", ("topk",))
            log(json.dumps({"vector_path": vector, "launches": launches["vector"]}))
            log(json.dumps({"caches_after_path": "vector", **cache_stats()}))
        with phase("vector_lifecycle"):
            zero_counts()
            t0 = time.perf_counter()
            vector_life = vector_lifecycle(device, vctx)
            vector_life["vector_lifecycle_s"] = time.perf_counter() - t0
            launches["vector_lifecycle"] = read_counts("vector lifecycle", ("topk",))
            log(json.dumps({"vector_lifecycle": vector_life, "launches": launches["vector_lifecycle"]}))
            log(json.dumps({"caches_after_path": "vector lifecycle", **cache_stats()}))
            del vctx
    finally:
        shutil.rmtree(work, ignore_errors=True)

    with phase("kernel_phase"):
        # Kernel phase at the aggregate path's two shapes: its row count and
        # group counts. Q1 by (l_returnflag, l_linestatus): 6 groups, 12
        # channels — the thread regime. Revenue by l_orderkey: 1.5M groups at
        # SF1, 2 channels — the global regime. First on seeded channels with
        # uniformly random group ids, then on the inputs the queries gave K1,
        # whose ids come as the source's rows do (revenue's in runs of one to
        # seven: lineitem is written in l_orderkey order).
        n = result["rows"]
        phases = result["phases"]
        q1_kinds = ("qty", "ind", "price", "ind", "disc", "ind", "price", "ind", "disc", "ind", "ind", "ind")
        shapes = {
            "q1": k1_synthetic(device, n, phases["agg_q1_groups"], Q1_FNS, q1_kinds, args.seed),
            "revenue": k1_synthetic(
                device, n, phases["agg_revenue_groups"], ("sum", "sum"), ("price", "ind"), args.seed + 1
            ),
        }
        # And at the join path's four, on the inputs the indexed J2 and J3 gave
        # it: the secondary run extrema (min/max over about 1.5M runs, global
        # atomics) and the group fold over the padded [B·Lp] rows; at the
        # query-surface path's three: q67's re-fold, CD1's inner aggregate and
        # q43's partial aggregate; and at 3f's three: the fallback's Q1 over
        # li_live's raw source and the crash sweep's aggregate by priority
        # after create and after the incremental refresh.
        for name, (vals, gid, k, fns) in {**k1_agg_inputs, **k1_join_inputs}.items():
            shapes[name] = k1_phase(device, vals, gid, k, fns, _k1_exact_from_data(vals.cpu().numpy(), fns))
        del k1_agg_inputs, k1_join_inputs
        # K2 at the join path's shapes, on its real key codes: the aligned J2
        # (orders buckets searched in lineitem buckets), the aligned J3 (the
        # reverse) and the un-indexed J2 (one partition: 1.5M codes searched in
        # 6.0M); then the aligned J2 with each primary row shuffled (seed 3),
        # which no caller gives it: a tile's keys then span its bucket's row,
        # and the kernel searches device memory.
        pk_j2 = k2_inputs["J2 aligned"][0]
        k2_inputs["J2 aligned, shuffled"] = (np.random.default_rng(3).permuted(pk_j2, axis=1), k2_inputs["J2 aligned"][1])
        k2 = {name: k2_phase(device, pk, sk) for name, (pk, sk) in k2_inputs.items()}
        del k2_inputs
        # K3 at the vector path's four shapes, on its real score matrices: the
        # routing scores [32, 64] (k = 8), the probed candidates' [32, about
        # 690k] (k = 10) and brute force's [32, 1M] at k = 10 and 100; then
        # the tie-heavy matrix at the brute-force shape.
        ties = tie_heavy(k3_inputs["brute force"][0])
        k3_inputs["tie-heavy"] = (ties, 10)
        k3_inputs["tie-heavy k=100"] = (ties, 100)
        profiled = vector["phases"]["ann_nprobe8_profiled"]["topk_ms"] or {}
        k3 = {name: k3_phase(device, scores, k) for name, (scores, k) in k3_inputs.items()}
        # Each call's kernels alone on the card, beside the event time, which
        # also holds the wrapper's host work: every kernel's calls in one
        # profiler window.
        device_ms = device_ms_each({
            **{("segment_reduce", n): (r.pop("call"), r["kernels_per_call"], "segment_reduce_") for n, r in shapes.items()},
            **{("run_bounds", n): (r.pop("call"), 1, "run_bounds_") for n, r in k2.items()},
            **{("topk", n): (r.pop("call"), r["kernels_per_call"], "topk_") for n, r in k3.items()},
        })
        for name, r in shapes.items():
            r["device_ms"] = device_ms["segment_reduce", name]
            log(json.dumps({"kernel": "segment_reduce", "shape": name, **r}))

        entries = []
        for name, r in shapes.items():
            query = name.split()[0]
            entries.append({
                "name": f"segment_reduce[{name}: n={r['n']}, K={r['k']}, C={r['channels']}]",
                "route": "cuda",
                "source": "hyperspace_tpu_torch/csrc/segment_reduce.cu",
                "replaces": "hyperspace_tpu/ops/aggregate.py:81",
                # K1 runs on thirteen paths: its launches on each, summed (the
                # fleet's in this process and in its members).
                "launches": sum(launches[p]["segment_reduce"] for p in ("aggregates", "join", "mesh", "join_types",
                                                                         "query_surface", "venue", "lifecycle", "serve",
                                                                         "faults", "build_scale", "fleet",
                                                                         "fleet_members", "advisor", "ingest")),
                "launches_by_path": {p: c["segment_reduce"] for p, c in launches.items()},
                "max_abs_err": r["max_abs_err"],
                "ms": r["ms"],
                "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
                # Where the kinds differ, no one call computes the function:
                # torch's scatter_reduce_ once per kind, timed together.
                "library_calls": r["library_calls"],
                "library_calls_ms": r["library_calls_ms"],
                "regime": r["regime"],
                "kernels_per_call": r["kernels_per_call"],
                "device_ms": r["device_ms"],
                # The kernel's device time inside the main path's query
                # (torch.profiler); for J2 and J3 both K1 launches of the query
                # together; the query-surface queries are not profiled.
                "main_path_ms": (
                    phases[f"agg_{query}_profiled"]["kernel_ms"]["segment_reduce_"] if query in ("q1", "revenue")
                    else join["phases"][f"{query}_profiled"]["kernel_ms"]["segment_reduce_"] if query in ("J2", "J3")
                    else None
                ),
                # k1_phase raised had the kernel disagreed with its plain version.
                "plain_check": "passed",
            })

        profiled_k2 = {
            "J2 aligned": join["phases"]["J2_profiled"], "J3 aligned": join["phases"]["J3_profiled"],
            "J2 no index": join["phases"]["J2_no_index_profiled"],
        }
        for name, r in k2.items():
            r["device_ms"] = device_ms["run_bounds", name]
            log(json.dumps({"kernel": "run_bounds", "shape": name, **r}))
            entries.append({
                "name": f"run_bounds[{name}: B={r['b']}, Lp={r['lp']}, Ls={r['ls']}]",
                "route": "cuda",
                "source": "hyperspace_tpu_torch/csrc/run_bounds.cu",
                "replaces": "hyperspace_tpu/ops/sortkeys.py:212",
                # K2 runs on the join paths, the mesh, the query surface, the venues, the
                # lifecycle, the serving path, the faults path, the fleet (in
                # this process and in its members) and the advisor: its
                # launches on each, summed.
                "launches": sum(launches[p]["run_bounds"] for p in ("join", "mesh", "join_types", "query_surface",
                                                                     "venue", "lifecycle", "serve", "faults", "fleet",
                                                                     "fleet_members", "advisor")),
                "launches_by_path": {p: c["run_bounds"] for p, c in launches.items()},
                "max_abs_err": r["max_abs_err"],
                "ms": r["ms"],
                "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
                "copy_ms": r["copy_ms"],
                "tiles": r["tiles"],
                "window": r["window"],
                "device_ms": r["device_ms"],
                # K2's device time inside the query of that name (torch.profiler);
                # the shuffled primary is no query's.
                "main_path_ms": profiled_k2[name]["kernel_ms"]["run_bounds_"] if name in profiled_k2 else None,
                "plain_check": "passed",
            })

        for name, r in k3.items():
            r["device_ms"] = device_ms["topk", name]
            log(json.dumps({"kernel": "topk", "shape": name, **r}))
            entries.append({
                "name": f"topk[{name}: q={r['q']}, n={r['n']}, k={r['k']}]",
                "route": "cuda",
                "source": "hyperspace_tpu_torch/csrc/topk.cu",
                "replaces": "hyperspace_tpu/ops/topk.py:46",
                # K3 runs on the vector path and its lifecycle: summed.
                "launches": launches["vector"]["topk"] + launches["vector_lifecycle"]["topk"],
                "launches_by_path": {p: c["topk"] for p, c in launches.items()},
                "max_abs_err": r["max_abs_err"],
                "ms": r["ms"],
                "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
                "blocks_per_row": r["blocks_per_row"],
                "kernels_per_call": r["kernels_per_call"],
                "device_ms": r["device_ms"],
                # K3's device time for this call inside one warm nprobe-8 query
                # (torch.profiler); brute force is not profiled.
                "main_path_ms": profiled.get(name),
                "plain_check": "passed",
            })
        log(json.dumps({"kernels": entries}))
    with phase("card_line"):
        log(card_line(card_query))
    log(json.dumps({"script_s": time.perf_counter() - t_script}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

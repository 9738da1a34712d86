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
3b. join-types path, on the join path's session, lineitem and orders:
   generates TPC-H customer (150,000 rows, seed 45), builds
   `customer_custkey` (with `c_nationkey, c_acctbal`) and
   `orders_custkey` (with `o_orderkey, o_totalprice`), 200 buckets, and
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
   kernel launch counts are zeroed just before each path and read just
   after it: every kernel a path runs must have launched in it, and no
   other;
5. kernel phase: holds each kernel against its plain PyTorch version on
   the card at the shapes the paths gave it (K1: the aggregates' row
   count, group counts and channels on seeded channels with uniformly
   random group ids, the very inputs the two aggregates gave it, and
   those of its four launches in the indexed J2 and J3 — the secondary
   run extrema and the group fold; K2: the join's real key codes at the
   aligned J2 and J3 shapes and the un-indexed J2 shape, and the aligned
   J2 codes with each primary row shuffled, so that the kernel's windows
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
   if it gave none), and, last, `{"ok": true, "device": {...}}`.

It needs a CUDA card and the repository around it; without either it
fails before printing any result.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
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


def cold_warm(name: str, session, plans: list, cache, sync, derived=(), tolerant=()) -> tuple[list, dict]:
    """Runs `plans` once cold and once warm through `run_query` and the
    PlanCache `cache`. The warm pass must hit the plan cache on every
    plan (where hyperspace is enabled), hit HOST_DERIVED on every kind in
    `derived` and miss none of them, read no file, and give the cold
    pass's results. Returns (the warm results, the cold and warm walls
    with the warm pass's host time by step: plan, read, derive, and the
    rest up to the synchronized wall)."""
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
    return [o.result for o in warm], {
        "cold_s": cold_s, "warm_s": warm_s, "warm_host_s": split,
        "plan_cache": "hit" if session.is_hyperspace_enabled() else "not used (hyperspace off)",
        "device_cache_hits": r1["hits"] - r0["hits"], "device_cache_misses": r1["misses"] - r0["misses"],
        "derived_hits": sum(v["hits"] for v in d1.values()) - sum(v["hits"] for v in d0.values()),
        "derived_misses": sum(v["misses"] for v in d1.values()) - sum(v["misses"] for v in d0.values()),
        "warm_stats": {k: warm[-1].stats[k] for k in ("scan", "files_read", "files_pruned", "rows_pruned",
                                                     "range_exact", "agg_path", "join_path", "join_paths",
                                                     "join_kernel", "exchange_kernel")},
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
        got, phases[f"lookups_{mode}"] = cold_warm(f"lookups {mode}", session, lookup_plans, plan_cache, sync)
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
        (result,), phases[f"agg_{name}"] = cold_warm(name, session, [plan], plan_cache, sync, ("gid",), tolerant)
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
            (result,), timing = cold_warm(f"range {name} {mode}", session, [plan], plan_cache, sync)
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

    li_buckets = _index_buckets(Path(session.conf.system_path), "lineitem_orderkey", ["l_orderkey", "l_extendedprice"])
    o_buckets = _index_buckets(Path(session.conf.system_path), "orders_orderkey", ["o_orderkey", "o_totalprice"])
    stats = {"l_extendedprice": _bucket_stats(li_buckets, "l_extendedprice"),
             "o_totalprice": _bucket_stats(o_buckets, "o_totalprice")}
    # What the join-types path reuses.
    ctx.update(orders=orders, o_source=o_source, bucket_stats=stats)

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
            (result,), timing = cold_warm(f"{name} {mode}", session, [plan], ctx["plan_cache"], sync, derived,
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


# -- join-types path -----------------------------------------------------------

C_INDEXED, C_INCLUDED = ["c_custkey"], ["c_nationkey", "c_acctbal"]
OC_INDEXED, OC_INCLUDED = ["o_custkey"], ["o_orderkey", "o_totalprice"]
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
                (result,), timing = cold_warm(f"{name} {mode}", session, [plan], ctx["plan_cache"], sync,
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
    for name, floor in (("DPPk", ("files_pruned", session.conf.num_buckets - SET_KEYS)), ("DPPq", ("rows_pruned", 1))):
        got = out[f"{name}_index"][floor[0]]
        if got < floor[1]:
            raise AssertionError(f"{name}: {floor[0]} {got}, expected at least {floor[1]}")
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


def vector_path(device, workdir: Path, n: int, dim: int = 128, partitions: int = 64) -> tuple[dict, dict]:
    """The port's vector index through its user entry points, at the shape
    of SIFT1M (1M x 128 float32, l2, k = 10) with the settings of
    benchmarks/bench_ann.py. Returns (the phase wall times and checks,
    the K3 inputs at the path's four shapes)."""
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
    del emb
    return {"rows": n, "dim": dim, "partitions": partitions, "queries": len(queries),
            "phases": phases, "checks": checks}, k3_inputs


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
    from hyperspace_tpu_torch.ops import kernels
    from hyperspace_tpu_torch.ops.segment_reduce import segment_reduce
    from hyperspace_tpu_torch.ops.sortkeys import run_bounds
    from hyperspace_tpu_torch.ops.topk import topk

    device = torch.device("cuda")
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

    work = Path(tempfile.mkdtemp(prefix="hs_chip_smoke_"))
    try:
        zero_counts()
        t0 = time.perf_counter()
        result, ctx = main_path(device, args.sf, args.seed, work)
        result["phases"]["main_path_s"] = time.perf_counter() - t0
        launches = {"aggregates": read_counts("aggregate", ("segment_reduce",))}
        log(json.dumps({"main_path": result, "launches": launches["aggregates"]}))
        log(json.dumps({"caches_after_path": "aggregate", **cache_stats()}))
        zero_counts()
        t0 = time.perf_counter()
        join, k1_join_inputs, k2_inputs = join_path(device, ctx, args.sf)
        join["phases"]["join_path_s"] = time.perf_counter() - t0
        launches["join"] = read_counts("join", ("run_bounds", "segment_reduce"))
        log(json.dumps({"join_path": join, "launches": launches["join"]}))
        log(json.dumps({"caches_after_path": "join", **cache_stats()}))
        zero_counts()
        t0 = time.perf_counter()
        join_types = join_types_path(device, ctx, args.sf)
        join_types["join_types_path_s"] = time.perf_counter() - t0
        launches["join_types"] = read_counts("join types", ("run_bounds", "segment_reduce"))
        log(json.dumps({"join_types_path": join_types, "launches": launches["join_types"]}))
        log(json.dumps({"caches_after_path": "join types", **cache_stats()}))
        k1_agg_inputs = ctx["k1_inputs"]
        del ctx
        zero_counts()
        t0 = time.perf_counter()
        vector, k3_inputs = vector_path(device, work, n=1_000_000)
        vector["phases"]["vector_path_s"] = time.perf_counter() - t0
        launches["vector"] = read_counts("vector", ("topk",))
        log(json.dumps({"vector_path": vector, "launches": launches["vector"]}))
        log(json.dumps({"caches_after_path": "vector", **cache_stats()}))
    finally:
        shutil.rmtree(work, ignore_errors=True)

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
    # atomics) and the group fold over the padded [B·Lp] rows.
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
            # K1 runs on three paths: its launches on each, summed.
            "launches": sum(launches[p]["segment_reduce"] for p in ("aggregates", "join", "join_types")),
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
            # together.
            "main_path_ms": (
                phases[f"agg_{query}_profiled"] if query in ("q1", "revenue") else join["phases"][f"{query}_profiled"]
            )["kernel_ms"]["segment_reduce_"],
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
            # K2 runs on both join paths: its launches on each, summed.
            "launches": launches["join"]["run_bounds"] + launches["join_types"]["run_bounds"],
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
            "launches": launches["vector"]["topk"],
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
    log(card_line(card_query))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

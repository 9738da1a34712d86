"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--sf 1.0] [--seed 42]

What it does, in order (any failure raises and exits non-zero):

1. prints the card's name and power limit (nvidia-smi), then builds every
   CUDA kernel of the port from `hyperspace_tpu_torch/csrc/` (one nvcc per
   source, started together) into `build/kernels/`;
2. main path, through the user entry points: generates TPC-H lineitem
   (16 columns; 6,001,991 rows at SF1 with seed 42, where TPC-H's own
   table holds 6,001,215), builds the `l_orderkey` covering index with
   200 buckets, runs 12 point lookups with the index enabled and
   disabled, and runs the Q1-shaped group-by and the per-order revenue
   aggregate, each checked against an independent pyarrow computation on
   the same parquet. Each aggregate runs cold, warm (timed), and once more
   under `torch.profiler` for the kernels' device time inside the query.
   Kernel launch counts are zeroed just before this phase and read just
   after; every kernel must have launched;
3. kernel phase: holds each kernel against its plain PyTorch version on
   the card at the shapes the main path gave it (its row count, group
   counts and channels), and times kernel, plain version and the library
   yardstick with CUDA events (median of 12 runs after warm-up);
4. prints one JSON line describing every kernel, the card's name and
   power limit again, and, last, `{"ok": true, "device": {...}}`.

It needs a CUDA card and the repository around it; without either it
fails before printing any result.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# H100 SXM (NVIDIA data sheet): 3.35 TB/s HBM3, 34 TFLOP/s float64 outside
# the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12
REPEATS = 12
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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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


def k1_phase(device, n: int, k: int, fns: tuple, kinds: tuple, seed: int) -> dict:
    """K1 against its plain version on the card at one main-path shape:
    exact channels (integral sums, extrema with NaN and ±inf, counts)
    bit-equal, non-integral sums within `sum_tolerance` (float64 atomics
    add in another order than index_add_). For few groups it also reports
    each non-integral sum's error against the exact (math.fsum) sum."""
    import math

    import torch

    from hyperspace_tpu_torch.ops.segment_reduce import segment_reduce, segment_reduce_plain

    gid_np, vals_np = _k1_inputs(np.random.default_rng(seed), n, k, fns, kinds)
    gid = torch.from_numpy(gid_np).to(device)
    vals = torch.from_numpy(vals_np).to(device)
    got = segment_reduce(vals, gid, k, fns).cpu().numpy()
    want = segment_reduce_plain(vals, gid, k, fns).cpu().numpy()
    exact = _k1_exact(kinds, fns)
    rows = np.bincount(gid_np, minlength=k)
    rel_err = {}
    for c, is_exact in enumerate(exact):
        if is_exact:
            np.testing.assert_array_equal(got[c], want[c], err_msg=f"exact channel {c} ({fns[c]})")
            continue
        abs_sum = np.bincount(gid_np, weights=np.abs(vals_np[c]), minlength=k)
        if k <= 64:
            truth = np.array([math.fsum(vals_np[c][gid_np == g]) for g in range(k)])
            rel_err[c] = {
                "kernel": float(np.max(np.abs(got[c] - truth) / abs_sum)),
                "plain": float(np.max(np.abs(want[c] - truth) / abs_sum)),
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
    return {
        "n": n, "k": k, "channels": c_num,
        "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_calls_ms if len(blocks) == 1 else None,
        "library_calls": len(blocks), "library_calls_ms": library_calls_ms,
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "bytes": nbytes, "max_abs_err": max_abs_err, "rel_err_vs_exact": rel_err,
        "deterministic_channels": sum(exact),
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


def device_time(fn, kernel_prefix: str) -> dict:
    """Runs `fn` once under torch.profiler and sums the device time of the
    kernels whose names hold `kernel_prefix` (counting them), and of all
    device work. The times are None when the profiler recorded no device
    activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    ours = busy = 0.0
    seen = matched = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        seen += 1
        busy += us
        if kernel_prefix in e.name:
            ours += us
            matched += 1
    if seen == 0:
        return {"kernel_ms": None, "device_busy_ms": None, "profiled_wall_ms": wall_ms, "kernels": 0}
    return {
        "kernel_ms": ours / 1e3, "device_busy_ms": busy / 1e3, "profiled_wall_ms": wall_ms,
        "kernels": matched,
    }


def main_path(device, sf: float, seed: int, workdir: Path, num_buckets: int = 200) -> dict:
    """The port's main path through its user entry points; returns the
    phase wall times and row counts."""
    import pandas as pd
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    import torch

    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig, col
    from hyperspace_tpu_torch.datagen import TPCH_SF1_ORDERS_ROWS, gen_tpch_lineitem

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

    def lookups():
        got = []
        for k in keys:
            q = df.filter(col("l_orderkey") == int(k)).select("l_orderkey", "l_partkey", "l_extendedprice")
            got.append(session.to_pandas(q))
        return got

    counts = {}
    for mode in ("index", "no_index"):
        session.enable_hyperspace() if mode == "index" else session.disable_hyperspace()
        t0 = time.perf_counter()
        lookups()  # cold: reads the files onto the device
        phases[f"lookups_{mode}_cold_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = lookups()
        phases[f"lookups_{mode}_s"] = time.perf_counter() - t0
        counts[mode] = [len(g) for g in got]
        stats = session.last_query_stats
        # The rule rewrite alone (signature, index listing, manifest): the
        # host's share of each warm lookup.
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

    session.enable_hyperspace()
    for name, plan, check in (
        ("q1", df.aggregate(Q1_GROUP, Q1_AGGS), check_q1),
        ("revenue", df.aggregate(["l_orderkey"], [("sum", "l_extendedprice", "rev")]), check_revenue),
    ):
        session.run(plan)  # cold: reads the columns onto the device
        sync()
        t0 = time.perf_counter()
        result = session.run(plan)
        sync()
        phases[f"agg_{name}_s"] = time.perf_counter() - t0
        check(pd.DataFrame(result.decode()), source)
        phases[f"agg_{name}_groups"] = result.num_rows
        # K1's device time inside the query (the kernels of segment_reduce.cu
        # are all named segment_reduce_*).
        phases[f"agg_{name}_profiled"] = device_time(lambda: session.run(plan), "segment_reduce_")
    return {"rows": rows, "lookup_rows": sum(counts["index"]), "phases": phases}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=1.0, help="TPC-H scale factor (1.0 = 1.5M orders, about 6.0M rows)")
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; none is available")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from hyperspace_tpu_torch.ops import kernels
    from hyperspace_tpu_torch.ops.segment_reduce import segment_reduce

    card = card_line()
    log(card)
    device = torch.device("cuda")
    t0 = time.perf_counter()
    kernels.build()
    log(json.dumps({"kernel_build_s": time.perf_counter() - t0, "kernels": list(kernels.SOURCES)}))

    segment_reduce.launches = 0
    work = Path(tempfile.mkdtemp(prefix="hs_chip_smoke_"))
    try:
        t0 = time.perf_counter()
        result = main_path(device, args.sf, args.seed, work)
        result["phases"]["main_path_s"] = time.perf_counter() - t0
        launches = {"segment_reduce": segment_reduce.launches}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(json.dumps({"main_path": result, "launches": launches}))
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} never launched on the main path")

    # Kernel phase at the main path's two aggregate shapes: its row count
    # and group counts. Q1 by (l_returnflag, l_linestatus): 6 groups, 12
    # channels — the shared-memory regime. Revenue by l_orderkey: 1.5M
    # groups at SF1, 2 channels — the global-atomic regime.
    n = result["rows"]
    phases = result["phases"]
    q1_kinds = ("qty", "ind", "price", "ind", "disc", "ind", "price", "ind", "disc", "ind", "ind", "ind")
    shapes = {
        "q1": k1_phase(device, n, phases["agg_q1_groups"], Q1_FNS, q1_kinds, args.seed),
        "revenue": k1_phase(
            device, n, phases["agg_revenue_groups"], ("sum", "sum"), ("price", "ind"), args.seed + 1
        ),
    }
    for name, r in shapes.items():
        log(json.dumps({"kernel": "segment_reduce", "shape": name, **r}))

    entries = []
    for name, r in shapes.items():
        entries.append({
            "name": f"segment_reduce[{name}: n={r['n']}, K={r['k']}, C={r['channels']}]",
            "route": "cuda",
            "source": "hyperspace_tpu_torch/csrc/segment_reduce.cu",
            "replaces": "hyperspace_tpu/ops/aggregate.py:81",
            "launches": launches["segment_reduce"],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            # The same kernel's device time inside the main path's query
            # (torch.profiler; None where it saw no device activity).
            "main_path_ms": phases[f"agg_{name}_profiled"]["kernel_ms"],
            # k1_phase raised had the kernel disagreed with its plain version.
            "plain_check": "passed",
        })
    log(json.dumps({"kernels": entries}))
    log(card_line())
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

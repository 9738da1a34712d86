"""Fleet member targets for the port's spawning tests (test_torch_fleet.py,
test_torch_imports.py). Each runs in a spawned process on the CPU, so it
sits in a module of its own that the child can import."""

from __future__ import annotations

import os
import queue
import sys
import time
from pathlib import Path


def forbidden_modules() -> list:
    """The JAX modules and the JAX package's modules this process loaded."""
    return sorted(k for k in sys.modules
                  if k == "jax" or k.startswith(("jax.", "jaxlib")) or k == "hyperspace_tpu"
                  or k.startswith("hyperspace_tpu."))


def crasher(ctx, marker_dir):
    """Record the attempt (and whether the coordinator's shipped fault rule
    fires here), seal the journal the coordinator shipped, then die with a
    non-zero exit."""
    from hyperspace_tpu_torch import faults
    from hyperspace_tpu_torch.obs import journal

    try:
        faults.fault_point("fleet.lease.acquire", "probe")
        fired = "no-fault"
    except faults.FaultError:
        fired = "fault-fired"
    Path(marker_dir, f"pid-{os.getpid()}").write_text(fired)
    journal.seal()
    raise SystemExit(3)


def lease_holder(sf_dir, name, ready_q):
    """Take the single-flight lease for `name` and hang until killed."""
    from hyperspace_tpu_torch.serve.fleet.lease import FileLease
    from hyperspace_tpu_torch.serve.fleet.singleflight import key_name

    claim = FileLease(Path(sf_dir) / f"{key_name(name)}.lease", ttl_s=300).try_acquire()
    ready_q.put("held" if claim is not None else "failed")
    time.sleep(300)


def cache_member(ctx, data_root, system_path, cmd_q, out_q):
    """A fleet member on the CPU: serves one point query over the shared
    store through the fleet's shared caches, its health plane on an
    ephemeral port registered in the fleet directory; answers each
    "query" command with the ids, its shared-cache hits, its port, the
    forbidden modules it loaded and whether it opened a CUDA context."""
    import numpy as np
    import torch

    from hyperspace_tpu_torch import HyperspaceSession, col, stats
    from hyperspace_tpu_torch.serve import fleet

    session = HyperspaceSession(system_path=system_path, device="cpu")
    session.conf.set("hyperspace.obs.http.enabled", "true")
    session.conf.set("hyperspace.index.cache.expiryDurationInSeconds", 0)
    session.enable_hyperspace()
    q = session.parquet(data_root).filter(col("key") == 7).select("id", "key", "value")
    plans, results = fleet.shared_caches(session)
    with session.serve(workers=1, plan_cache=plans, result_cache=results) as server:
        endpoint = server.health_endpoint
        fleet.register_worker(ctx.fleet_dir, ctx.worker_id, endpoint.port)
        while not ctx.stop_event.is_set():
            try:
                cmd = cmd_q.get(timeout=0.2)
            except queue.Empty:
                continue
            if cmd == "stop":
                break
            out = server.submit(q).result(timeout=300)
            out_q.put({
                "ids": sorted(np.asarray(out.decode()["id"]).tolist()),
                "shared_hits": stats.get("fleet.shared_cache.hits"),
                "port": endpoint.port,
                "forbidden": forbidden_modules(),
                "cuda_initialized": torch.cuda.is_initialized(),
                "device": str(results.device),
            })


def import_member(ctx, out_q):
    """Import every module of the port a fleet member runs, open a CPU
    session's server with the fleet's caches, and report the forbidden
    modules loaded."""
    import importlib
    import pkgutil

    import hyperspace_tpu_torch
    from hyperspace_tpu_torch import HyperspaceSession
    from hyperspace_tpu_torch.serve import fleet

    for m in pkgutil.walk_packages(hyperspace_tpu_torch.__path__, "hyperspace_tpu_torch."):
        importlib.import_module(m.name)
    session = HyperspaceSession(system_path=str(Path(ctx.fleet_dir) / "indexes"), device="cpu")
    plans, _ = fleet.shared_caches(session)
    with session.serve(workers=1, plan_cache=plans, result_cache=False):
        pass
    out_q.put({"pid": os.getpid(), "forbidden": forbidden_modules()})


def card_member(ctx, data_root, system_path, out_q):
    """A fleet member on the card: serves a Q1-shaped aggregate over the
    shared store through the fleet's plan cache and reports its CUDA
    context, device, K1 launches and the rows it served."""
    import numpy as np
    import torch

    from hyperspace_tpu_torch import HyperspaceSession
    from hyperspace_tpu_torch.ops.segment_reduce import segment_reduce
    from hyperspace_tpu_torch.serve import fleet

    session = HyperspaceSession(system_path=system_path)  # the card, or it raises
    session.enable_hyperspace()
    q = session.parquet(data_root).aggregate(["l_returnflag", "l_linestatus"], [
        ("sum", "l_quantity", "q"), ("min", "l_extendedprice", "lo"), ("max", "l_discount", "hi"),
        ("count", None, "c")])
    plans, _ = fleet.shared_caches(session)
    with session.serve(workers=2, plan_cache=plans, result_cache=False) as server:
        k1 = segment_reduce.launches
        out = server.submit(q).result(timeout=300)
        decoded = {k: np.asarray(v).tolist() for k, v in out.decode().items()}
        out_q.put({"pid": os.getpid(), "cuda_initialized": torch.cuda.is_initialized(),
                   "device": str(out.device), "name": torch.cuda.get_device_name(0),
                   "k1_launches": segment_reduce.launches - k1, "rows": decoded,
                   "forbidden": forbidden_modules()})

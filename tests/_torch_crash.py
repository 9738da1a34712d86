"""Crash-consistency helpers shared by the port's build-at-scale fault tests
(test_torch_streaming_build.py, test_torch_build_scaleout.py,
test_torch_io_chunks.py): tests/test_fault_injection.py's source, query
probe and post-crash invariants, for the port alone."""

from pathlib import Path

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq

import hyperspace_tpu_torch as htorch
from hyperspace_tpu_torch import states
from hyperspace_tpu_torch.config import DATA_VERSION_PREFIX
from hyperspace_tpu_torch.metadata.data_manager import IndexDataManager
from hyperspace_tpu_torch.metadata.log_manager import IndexLogManager


def write_source(root: Path, n: int = 60) -> str:
    rng = np.random.default_rng(7)
    table = pa.table({
        "id": pa.array(np.arange(n, dtype=np.int64)),
        "key": pa.array((np.arange(n, dtype=np.int64) * 13) % 10),
        "value": pa.array(rng.standard_normal(n)),
    })
    root.mkdir(parents=True, exist_ok=True)
    pq.write_table(table.slice(0, n // 2), root / "part-0.parquet")
    pq.write_table(table.slice(n // 2), root / "part-1.parquet")
    return str(root)


def session(system_path, **conf):
    s = htorch.HyperspaceSession(system_path=str(system_path), num_buckets=2, device="cpu")
    for key, value in conf.items():
        s.conf.set(key, value)
    return s


def create(s, source: str) -> None:
    htorch.Hyperspace(s).create_index(s.parquet(source), htorch.IndexConfig("idx1", ["key"], ["value"]))


def _canon(df: pd.DataFrame) -> pd.DataFrame:
    cols = ["key", "value"]
    return df[cols].sort_values(cols).reset_index(drop=True)


def query_matches(s, source: str) -> pd.DataFrame:
    """A filter on the indexed column, row-identical to pandas over the raw
    source."""
    import pyarrow.dataset as pads

    got = _canon(s.to_pandas(s.parquet(source).filter(htorch.col("key") == 7).select("key", "value")))
    raw = pads.dataset(source, format="parquet").to_table().to_pandas()
    pd.testing.assert_frame_equal(got, _canon(raw[raw["key"] == 7]), check_dtype=False)
    return got


def assert_no_build_scratch(system_path: Path) -> None:
    leftovers = [p for pat in ("*.exchange", "*.spill") for p in Path(system_path).rglob(pat)]
    assert not leftovers, f"build scratch survived: {leftovers}"


def assert_crash_consistent(system_path: Path, source: str, ctx: str) -> None:
    """After a crash: recover converges (the latest entry stable, no orphan
    version dir, a second recover does nothing) and the query answers."""
    index_path = Path(system_path) / "idx1"
    lm, dm = IndexLogManager(index_path), IndexDataManager(index_path)
    s2 = session(system_path)
    hs2 = htorch.Hyperspace(s2)
    hs2.recover("idx1")
    latest = lm.get_latest_log()
    if latest is not None:
        assert latest.state in states.STABLE_STATES, ctx
        stable = lm.get_latest_stable_log()
        assert stable is not None and stable.id == latest.id, ctx
        referenced = (
            set(stable.content.directories)
            if stable.state != states.DOESNOTEXIST and stable.content is not None else set()
        )
        on_disk = {f"{DATA_VERSION_PREFIX}{v}" for v in dm.get_version_ids()}
        assert on_disk <= referenced, f"{ctx}: orphan version dirs {on_disk - referenced}"
    again = hs2.recover("idx1")
    assert not again["rolled"] and again["orphans_removed"] == 0, ctx
    assert_no_build_scratch(system_path)
    s2.enable_hyperspace()
    query_matches(s2, source)

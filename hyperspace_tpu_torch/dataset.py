"""Dataset registration: the analog of a Spark relation over data-lake files.

A Dataset is a parquet directory with a derived Schema; `scan()` yields the
plan leaf. The port reads parquet sources only; the JAX package's ORC, CSV
and JSON sources are not ported yet. File enumeration returns (path, size, mtime) triples — the
identity the signature provider fingerprints (reference collects
`PartitioningAwareFileIndex.allFiles` at actions/CreateActionBase.scala:89-97).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.metadata.log_entry import FileInfo
from hyperspace_tpu_torch.plan.nodes import Scan
from hyperspace_tpu_torch.schema import Schema


_FORMAT_SUFFIX = {"parquet": ".parquet", "orc": ".orc", "csv": ".csv", "json": ".json"}


def format_suffix(fmt: str) -> str:
    try:
        return _FORMAT_SUFFIX[fmt]
    except KeyError:
        raise HyperspaceError(f"unsupported source format {fmt!r} (parquet|orc|csv|json)")


def list_data_files(root: str | Path, suffix: str = ".parquet") -> list[FileInfo]:
    """Recursively list data files under `root`, sorted by path."""
    root = Path(root)
    if root.is_file():
        st = root.stat()
        return [FileInfo(str(root), st.st_size, st.st_mtime_ns)]
    out = []
    for p in sorted(root.rglob(f"*{suffix}")):
        if p.name.startswith((".", "_")):
            continue
        st = p.stat()
        out.append(FileInfo(str(p), st.st_size, st.st_mtime_ns))
    return out


@dataclasses.dataclass
class Dataset:
    root: str
    format: str
    schema: Schema

    @staticmethod
    def parquet(root: str | Path) -> "Dataset":
        """Register a parquet dataset, deriving the schema from the first
        footer (all files must share it)."""
        import pyarrow.parquet as pq

        files = list_data_files(root)
        if not files:
            raise HyperspaceError(f"no parquet files found under {root}")
        arrow_schema = pq.read_schema(files[0].path)
        return Dataset(str(root), "parquet", Schema.from_arrow(arrow_schema))

    def files(self) -> list[FileInfo]:
        return list_data_files(self.root, suffix=format_suffix(self.format))

    def scan(self) -> Scan:
        return Scan(self.root, self.format, self.schema)

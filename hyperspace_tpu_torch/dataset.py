"""Dataset registration: the analog of a Spark relation over data-lake files.

A Dataset is a directory of parquet, ORC, CSV or line-delimited JSON files
with a derived Schema; `scan()` yields the plan leaf. File enumeration
returns (path, size, mtime) triples — the
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

    @staticmethod
    def of_format(root: str | Path, fmt: str) -> "Dataset":
        """Register a dataset of any supported format (parquet/orc/csv/
        json — the same four the reference gates sources to,
        index/serde/LogicalPlanSerDeUtils.scala:225-245), deriving the
        schema from the first file."""
        if fmt == "parquet":
            return Dataset.parquet(root)
        files = list_data_files(root, suffix=format_suffix(fmt))
        if not files:
            raise HyperspaceError(f"no {fmt} files found under {root}")
        first = files[0].path
        if fmt == "orc":
            from pyarrow import orc

            arrow_schema = orc.ORCFile(first).schema
        elif fmt == "csv":
            from pyarrow import csv as pcsv

            # Full-file read: block-sample inference can mis-type columns
            # whose early values look numeric. Reads at registration are
            # pinned to this schema afterwards (io._arrow_types_for).
            arrow_schema = pcsv.read_csv(first).schema
        else:  # json
            from pyarrow import json as pjson

            arrow_schema = pjson.read_json(first).schema
        return Dataset(str(root), fmt, Schema.from_arrow(arrow_schema))

    @staticmethod
    def orc(root: str | Path) -> "Dataset":
        return Dataset.of_format(root, "orc")

    @staticmethod
    def csv(root: str | Path) -> "Dataset":
        return Dataset.of_format(root, "csv")

    @staticmethod
    def json(root: str | Path) -> "Dataset":
        return Dataset.of_format(root, "json")

    def files(self) -> list[FileInfo]:
        return list_data_files(self.root, suffix=format_suffix(self.format))

    def scan(self) -> Scan:
        return Scan(self.root, self.format, self.schema)

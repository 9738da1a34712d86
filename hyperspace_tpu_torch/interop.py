"""Hand the same data to both packages: numpy columns in, a device table out.

`table_from_numpy(columns, schema, device)` builds a ColumnTable from a
dict of numpy arrays and a Schema — the entry tests use to give the JAX
package and the port the same inputs made from one numpy seed. String
columns arrive as object arrays of Python strings (None = NULL) and are
dictionary-encoded exactly as a parquet read would encode them; other
columns may be numpy masked arrays, whose mask marks NULLs.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa
import torch

from hyperspace_tpu_torch.device import resolve_device
from hyperspace_tpu_torch.execution.table import ColumnTable
from hyperspace_tpu_torch.schema import Schema

_ARROW = {
    "int32": pa.int32(),
    "int64": pa.int64(),
    "float32": pa.float32(),
    "float64": pa.float64(),
    "bool": pa.bool_(),
    "string": pa.string(),
    "date": pa.date32(),
    "timestamp": pa.timestamp("us"),
}


def table_from_numpy(
    columns: dict[str, np.ndarray], schema: Schema, device: "str | torch.device | None" = None
) -> ColumnTable:
    """`device=None` means the CUDA card, as for every entry point of the
    port; pass `device="cpu"` to build the table on the host."""
    arrays = {}
    for f in schema.fields:
        arr = columns[f.name]
        mask = np.ma.getmaskarray(arr) if isinstance(arr, np.ma.MaskedArray) else None
        data = np.ma.getdata(arr) if mask is not None else arr
        arrays[f.name] = pa.array(data, type=_ARROW[f.dtype], mask=mask)
    return ColumnTable.from_arrow(pa.table(arrays), schema, device=resolve_device(device))

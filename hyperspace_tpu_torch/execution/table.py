"""ColumnTable: the columnar container of the device plane.

Struct-of-tensors on one device (the CUDA card, or the CPU when the caller
asks for it), with the JAX package's physical types:

- numerics/bools/dates map directly;
- a vector (embedding) column is one [n, dim] float32 tensor; it holds
  no nulls;
- strings are dictionary-encoded with a SORTED dictionary kept on the
  host as a numpy object array, so int32 codes on the device preserve the
  string sort order — equality AND range predicates evaluate correctly on
  codes once literals are translated;
- nulls are carried as per-column validity masks (True = valid). Null
  slots hold a deterministic zero in the physical column; every consumer
  that cares (predicates, key codes, hashing, output encode) reads the
  mask.

A port of the JAX package's `execution/table.py` (same decode from Arrow,
same dictionaries, same Arrow encode), holding `torch.Tensor` columns
instead of numpy arrays. Numpy buffers coming from Arrow can be read-only
views; they enter a CPU tensor only as a copy, so no write through a
tensor can reach a buffer Arrow still owns. A scalar column bound for the
card crosses `execution/staging.py`: where it is fixed-width, null-free
and one chunk, it goes from Arrow's buffer straight into the
host-to-device copy, and the tensor on the card owns its memory.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable

import numpy as np
import torch

from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.schema import Schema


def to_tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy → tensor on `device`, copying any buffer the tensor must not
    share: a read-only (Arrow-owned) view is always copied."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor → numpy (zero-copy for CPU tensors, a download otherwise)."""
    return t.detach().cpu().numpy()


def _validity_mask(arr) -> np.ndarray:
    """Bool per row (True = valid) from a pyarrow (Chunked)Array."""
    import pyarrow.compute as pc

    return np.asarray(pc.is_valid(arr))


@dataclasses.dataclass
class ColumnTable:
    schema: Schema
    columns: dict[str, torch.Tensor]  # physical columns (codes for strings)
    dictionaries: dict[str, np.ndarray]  # string name -> sorted object array
    # column name -> bool tensor, True = valid. Absent key = no nulls.
    validity: dict[str, torch.Tensor]
    device: torch.device

    def __post_init__(self):
        lens = {len(v) for v in self.columns.values()}
        if len(lens) > 1:
            raise HyperspaceError(f"ragged columns: {lens}")

    @property
    def num_rows(self) -> int:
        if not self.columns:
            return 0
        return len(next(iter(self.columns.values())))

    def column(self, name: str) -> torch.Tensor:
        f = self.schema.field(name)
        return self.columns[f.name]

    def host_column(self, name: str) -> np.ndarray:
        return to_numpy(self.column(name))

    def valid_mask(self, name: str) -> torch.Tensor | None:
        """Validity of a column (True = valid), or None when null-free."""
        f = self.schema.field(name)
        return self.validity.get(f.name)

    def host_valid_mask(self, name: str) -> np.ndarray | None:
        v = self.valid_mask(name)
        return None if v is None else to_numpy(v)

    # -- construction ----------------------------------------------------
    @staticmethod
    def from_arrow(table, schema: Schema | None = None, *, device: torch.device | str) -> "ColumnTable":
        """Build from a pyarrow Table, dictionary-encoding string columns
        and extracting validity masks for nullable data (the JAX package's
        decode, step for step), then placing every column on `device`."""
        import pyarrow as pa
        import pyarrow.compute as pc

        from hyperspace_tpu_torch.execution import staging

        device = torch.device(device)
        if schema is None:
            schema = Schema.from_arrow(table.schema)
        staged: dict[str, torch.Tensor] = {}
        columns: dict[str, np.ndarray] = {}
        dictionaries: dict[str, np.ndarray] = {}
        validity: dict[str, np.ndarray] = {}
        for f in schema.fields:
            arr = table.column(f.name)
            valid = None
            if arr.null_count:
                if f.is_vector:
                    raise HyperspaceError(
                        f"vector column {f.name!r} contains {arr.null_count} null "
                        "rows; null embeddings are not supported"
                    )
                valid = _validity_mask(arr)
                validity[f.name] = valid
            if f.is_string:
                # Arrow's dictionary encode, then a SMALL sort of the
                # dictionary + an O(n) int remap (sorted-codes invariant).
                enc = arr if pa.types.is_dictionary(arr.type) else pc.dictionary_encode(arr)
                if isinstance(enc, pa.ChunkedArray):
                    enc = enc.combine_chunks() if enc.num_chunks != 1 else enc.chunk(0)
                dict_arr = enc.dictionary
                dict_null = None
                if dict_arr.null_count:
                    # Entry-level nulls in the dictionary: rows referencing
                    # such an entry are logically NULL.
                    dict_null = ~np.asarray(pc.is_valid(dict_arr))
                    dict_arr = pc.fill_null(dict_arr, "")
                dvals = dict_arr.to_numpy(zero_copy_only=False)
                svals = np.asarray(dvals, dtype=str)
                idx = enc.indices
                if idx.null_count:
                    idx = pc.fill_null(idx, 0)
                codes0 = np.asarray(idx).astype(np.int64, copy=False)
                if dict_null is not None and dict_null.any():
                    row_null = dict_null[codes0]
                    if row_null.any():
                        valid = ~row_null if valid is None else (valid & ~row_null)
                        validity[f.name] = valid
                if valid is not None and not (svals == "").any():
                    # Null slots take the deterministic "" value.
                    svals = np.append(svals, "")
                # np.unique over the SMALL dictionary: sorts AND dedups.
                sorted_dict, inv = np.unique(svals, return_inverse=True)
                codes = inv.astype(np.int32, copy=False)[codes0]
                if valid is not None:
                    empty_code = np.int32(np.searchsorted(sorted_dict, ""))
                    codes = np.where(valid, codes, empty_code).astype(np.int32, copy=False)
                columns[f.name] = codes
                dictionaries[f.name] = sorted_dict
            elif f.is_vector:
                # [n, dim] float32 from the FixedSizeList's child buffer
                # (.values, not .flatten(), which drops null list slots).
                combined = arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) else arr
                child = combined.values
                if child.null_count:
                    raise HyperspaceError(f"vector column {f.name!r} contains null elements")
                flat = child.to_numpy(zero_copy_only=False)
                columns[f.name] = np.ascontiguousarray(flat).astype(np.float32, copy=False).reshape(-1, f.dim)
            else:
                if valid is None:
                    on_device = staging.stage_column(arr, f, device)
                    if on_device is not None:
                        staged[f.name] = on_device
                        continue
                if f.dtype == "date":
                    arr = arr.cast(pa.int32())
                elif f.dtype == "timestamp":
                    arr = arr.cast(pa.int64())
                if valid is not None:
                    # Zero the null slots with a TYPED scalar.
                    arr = pc.fill_null(arr, pa.scalar(False if f.dtype == "bool" else 0, arr.type))
                np_arr = arr.to_numpy(zero_copy_only=False)
                columns[f.name] = np.ascontiguousarray(np_arr).astype(f.device_dtype, copy=False)
                staging.count_copied(columns[f.name].nbytes)
        out = ColumnTable.from_numpy(schema, columns, dictionaries, validity, device=device)
        if staged:
            # Back in the schema's column order.
            out.columns = {f.name: staged.get(f.name, out.columns.get(f.name)) for f in schema.fields}
        return out

    @staticmethod
    def from_numpy(
        schema: Schema, columns: dict[str, np.ndarray], dictionaries=None, validity=None,
        *, device: torch.device | str,
    ) -> "ColumnTable":
        device = torch.device(device)
        return ColumnTable(
            schema,
            {k: to_tensor(v, device) for k, v in columns.items()},
            dict(dictionaries or {}),
            {k: to_tensor(np.asarray(v, dtype=bool), device) for k, v in (validity or {}).items()},
            device,
        )

    @staticmethod
    def empty(schema: Schema, *, device: torch.device | str) -> "ColumnTable":
        """Zero-row table for a schema (empty sorted dictionaries for
        string fields)."""
        cols: dict[str, np.ndarray] = {}
        dicts: dict[str, np.ndarray] = {}
        for f in schema.fields:
            cols[f.name] = np.zeros((0, f.dim) if f.is_vector else 0, dtype=f.device_dtype)
            if f.is_string:
                dicts[f.name] = np.zeros(0, dtype=object)
        return ColumnTable.from_numpy(schema, cols, dicts, device=device)

    def to(self, device: torch.device | str) -> "ColumnTable":
        device = torch.device(device)
        return ColumnTable(
            self.schema,
            {k: v.to(device) for k, v in self.columns.items()},
            dict(self.dictionaries),
            {k: v.to(device) for k, v in self.validity.items()},
            device,
        )

    # -- transforms ------------------------------------------------------
    def select(self, names: Iterable[str]) -> "ColumnTable":
        sub = self.schema.select(list(names))
        cols = {f.name: self.columns[f.name] for f in sub.fields}
        dicts = {f.name: self.dictionaries[f.name] for f in sub.fields if f.name in self.dictionaries}
        val = {f.name: self.validity[f.name] for f in sub.fields if f.name in self.validity}
        return ColumnTable(sub, cols, dicts, val, self.device)

    def take(self, indices: torch.Tensor) -> "ColumnTable":
        """Row gather by an index tensor on this table's device."""
        cols = {k: v[indices] for k, v in self.columns.items()}
        val = {k: v[indices] for k, v in self.validity.items()}
        return ColumnTable(self.schema, cols, dict(self.dictionaries), val, self.device)

    def filter_mask(self, mask: torch.Tensor) -> "ColumnTable":
        cols = {k: v[mask] for k, v in self.columns.items()}
        val = {k: v[mask] for k, v in self.validity.items()}
        return ColumnTable(self.schema, cols, dict(self.dictionaries), val, self.device)

    def translate_literal(self, column: str, value: Any, op: str) -> Any:
        """Map a literal to the physical domain of `column`.

        For string columns, translate a string literal to the dictionary
        code domain such that comparisons on codes are equivalent:
        - present in dict: its code works for all comparison ops;
        - absent: use the insertion point; eq ⇒ impossible (-1), ne ⇒
          always true (-1), lt/ge boundaries still correct because the
          dictionary is sorted.
        """
        f = self.schema.field(column)
        if not f.is_string:
            return value
        d = self.dictionaries.get(f.name)
        if d is None:
            raise HyperspaceError(f"no dictionary for string column {column!r}")
        pos = int(np.searchsorted(d, value))
        present = pos < len(d) and d[pos] == value
        if present:
            return pos
        if op in ("eq", "ne"):
            return -1
        if op in ("lt", "ge"):
            return pos  # codes < pos are strictly smaller strings
        if op in ("le", "gt"):
            return pos - 1 if pos > 0 else -1
        return pos

    def decode(self) -> dict[str, np.ndarray]:
        """Materialize logical values on the host (strings decoded, null
        slots as None in object arrays) for result checks."""
        out = {}
        for f in self.schema.fields:
            arr = to_numpy(self.columns[f.name])
            vals = self.dictionaries[f.name][arr] if f.is_string else arr
            valid = self.validity.get(f.name)
            if valid is not None:
                valid = to_numpy(valid)
                if not valid.all():
                    vals = vals.astype(object)
                    vals[~valid] = None
            out[f.name] = vals
        return out

    def to_arrow(self):
        import pyarrow as pa

        arrays = {}
        for f in self.schema.fields:
            valid = self.validity.get(f.name)
            mask = ~to_numpy(valid) if valid is not None else None  # pa: True = null
            v = to_numpy(self.columns[f.name])
            if f.is_string:
                # The (codes, dictionary) pair AS a DictionaryArray: the
                # column never inflates to a per-row string array.
                d = self.dictionaries[f.name]
                idx = pa.array(np.ascontiguousarray(v, dtype=np.int32), mask=mask)
                arrays[f.name] = pa.DictionaryArray.from_arrays(
                    idx, pa.array(d.astype(object), type=pa.string())
                )
            elif f.is_vector:
                arrays[f.name] = pa.FixedSizeListArray.from_arrays(
                    pa.array(np.ascontiguousarray(v).reshape(-1), type=pa.float32()), f.dim
                )
            elif f.dtype == "date":
                arrays[f.name] = pa.array(v, type=pa.date32(), mask=mask)
            elif f.dtype == "timestamp":
                arrays[f.name] = pa.array(v, type=pa.timestamp("us"), mask=mask)
            else:
                arrays[f.name] = pa.array(v, mask=mask)
        return pa.table(arrays)

    @staticmethod
    def concat(tables: list["ColumnTable"]) -> "ColumnTable":
        """Concatenate tables with the same schema on one device. String
        columns merge on the (small, host) dictionaries and remap codes
        with one lookup per part, never decoding row values."""
        if not tables:
            raise HyperspaceError("cannot concat zero tables")
        if len(tables) == 1:
            return tables[0]
        schema, device = tables[0].schema, tables[0].device
        cols: dict[str, torch.Tensor] = {}
        dicts: dict[str, np.ndarray] = {}
        validity: dict[str, torch.Tensor] = {}
        for f in schema.fields:
            parts = [t.columns[f.name] for t in tables]
            if f.is_string:
                part_dicts = [t.dictionaries[f.name] for t in tables]
                if all(len(d) == len(part_dicts[0]) and np.array_equal(d, part_dicts[0]) for d in part_dicts[1:]):
                    dicts[f.name] = part_dicts[0]
                else:
                    merged = np.unique(np.concatenate(part_dicts).astype(str))
                    remapped = []
                    for codes, d in zip(parts, part_dicts):
                        # Old code -> position of its string in the merged
                        # sorted dictionary (exact: every entry is present).
                        old_to_new = to_tensor(np.searchsorted(merged, d.astype(str)).astype(np.int32), device)
                        remapped.append(old_to_new[codes.long()] if len(d) else codes)
                    dicts[f.name] = merged.astype(object)
                    parts = remapped
            cols[f.name] = torch.cat(parts)
            if any(f.name in t.validity for t in tables):
                validity[f.name] = torch.cat([
                    t.validity.get(f.name, torch.ones(t.num_rows, dtype=torch.bool, device=device)) for t in tables
                ])
        return ColumnTable(schema, cols, dicts, validity, device)

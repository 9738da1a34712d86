"""Columnar schema model.

The reference stores a Spark `schemaString` (JSON StructType) inside the
index log entry (index/IndexLogEntry.scala:39-47). Here the schema is a
first-class dataclass that serializes to/from plain JSON, and additionally
knows how each logical type maps onto a device-resident physical type:

- fixed-width numerics map 1:1 onto tensor dtypes;
- strings are dictionary-encoded on the host feed (int32 codes on device,
  dictionary kept host-side) because variable-length data has no efficient
  device representation.

A copy of the JAX package's `schema.py`: the schema JSON in a log entry
must read the same in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

_SUPPORTED = {
    "int32": np.int32,
    "int64": np.int64,
    "float32": np.float32,
    "float64": np.float64,
    "bool": np.bool_,
    "string": np.int32,  # dictionary codes on device
    "date": np.int32,  # days since epoch
    "timestamp": np.int64,  # microseconds since epoch
    "vector": np.float32,  # fixed-dim embedding, [n, dim] float32 on device
}


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    dtype: str  # logical type name, one of _SUPPORTED
    nullable: bool = False
    # Embedding dimensionality; required iff dtype == "vector".
    dim: int | None = None

    def __post_init__(self):
        if self.dtype not in _SUPPORTED:
            raise ValueError(f"unsupported dtype {self.dtype!r} for field {self.name!r}")
        if (self.dtype == "vector") != (self.dim is not None):
            raise ValueError(f"field {self.name!r}: dim is required iff dtype is 'vector'")

    @property
    def device_dtype(self) -> np.dtype:
        """Physical dtype of the device-resident column."""
        return np.dtype(_SUPPORTED[self.dtype])

    @property
    def is_string(self) -> bool:
        return self.dtype == "string"

    @property
    def is_vector(self) -> bool:
        return self.dtype == "vector"

    def to_json(self) -> dict[str, Any]:
        d = {"name": self.name, "dtype": self.dtype, "nullable": self.nullable}
        if self.dim is not None:
            d["dim"] = self.dim
        return d

    @staticmethod
    def from_json(d: dict[str, Any]) -> "Field":
        return Field(d["name"], d["dtype"], d.get("nullable", False), d.get("dim"))


@dataclasses.dataclass(frozen=True)
class Schema:
    fields: tuple[Field, ...]

    def __post_init__(self):
        names = [f.name.lower() for f in self.fields]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names in schema: {names}")

    @staticmethod
    def of(*fields: Field) -> "Schema":
        return Schema(tuple(fields))

    @property
    def names(self) -> list[str]:
        return [f.name for f in self.fields]

    def field(self, name: str) -> Field:
        """Case-insensitive field lookup (reference resolves columns
        case-insensitively, index/IndexConfig.scala:40-53)."""
        low = name.lower()
        for f in self.fields:
            if f.name.lower() == low:
                return f
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        try:
            self.field(name)
            return True
        except KeyError:
            return False

    def select(self, names: list[str]) -> "Schema":
        return Schema(tuple(self.field(n) for n in names))

    def to_json(self) -> list[dict[str, Any]]:
        return [f.to_json() for f in self.fields]

    @staticmethod
    def from_json(items: list[dict[str, Any]]) -> "Schema":
        return Schema(tuple(Field.from_json(d) for d in items))

    @staticmethod
    def from_arrow(arrow_schema) -> "Schema":
        """Derive a Schema from a pyarrow schema."""
        import pyarrow as pa

        fields = []
        for f in arrow_schema:
            t = f.type
            if pa.types.is_int32(t):
                dt = "int32"
            elif pa.types.is_int64(t):
                dt = "int64"
            elif pa.types.is_float32(t):
                dt = "float32"
            elif pa.types.is_float64(t):
                dt = "float64"
            elif pa.types.is_boolean(t):
                dt = "bool"
            elif pa.types.is_string(t) or pa.types.is_large_string(t) or pa.types.is_dictionary(t):
                dt = "string"
            elif pa.types.is_date32(t):
                dt = "date"
            elif pa.types.is_timestamp(t):
                dt = "timestamp"
            elif pa.types.is_fixed_size_list(t) and pa.types.is_floating(t.value_type):
                fields.append(Field(f.name, "vector", f.nullable, dim=t.list_size))
                continue
            else:
                raise ValueError(f"unsupported arrow type {t} for column {f.name!r}")
            fields.append(Field(f.name, dt, f.nullable))
        return Schema(tuple(fields))

"""Order-preserving 32-bit lane decomposition of key columns, and the
stable device sort by those lanes.

Each logical key column decomposes into 1-3 int32/uint32 lanes whose
lexicographic order equals the logical order of the column:

- int8/16/32, date32, bool  → one int32 lane;
- int64, timestamp          → (hi int32, lo uint32) word pair;
- uint64                    → (hi uint32, lo uint32);
- float32                   → one uint32 lane via the IEEE-754 total-order
  bit flip (negatives reversed, sign bit toggled);
- float64                   → the same flip on 64 bits, split hi/lo;
- strings                   → the table's sorted-dictionary codes;
- nullable columns          → a leading validity lane (0 null, 1 valid),
  so nulls sort first.

The decomposition is a copy of the JAX package's `ops/sortkeys.py`
(numpy, on the host). The sort is the port of its `device_lanes_perm` /
`device_sort_perms`: one stable `torch.sort` per lane on the device, least
significant lane first (LSD), which reproduces the JAX package's
`lexsort_lanes` exactly.
Torch can neither sort nor shift `uint32`, so every lane travels as int64:
unsigned lanes zero-extend and signed lanes sign-extend, which keeps each
lane's own (signed or unsigned) order.
"""

from __future__ import annotations

import numpy as np
import torch

from hyperspace_tpu_torch.exceptions import HyperspaceError


def _flip32(v: np.ndarray) -> np.ndarray:
    """IEEE-754 int32 bit pattern → uint32 whose unsigned order equals the
    float order (negatives reversed, sign toggled)."""
    mask = (v >> 31) | np.int32(-(2**31))  # v>=0: 0x80000000, v<0: 0xFFFFFFFF
    return (v ^ mask).view(np.uint32)


def _flip64(v: np.ndarray) -> np.ndarray:
    mask = (v >> 63) | np.int64(-(2**63))
    return (v ^ mask).view(np.uint64)


def _split64(u: np.ndarray) -> list[np.ndarray]:
    """uint64 → (hi uint32, lo uint32) lanes (unsigned lexicographic)."""
    return [(u >> np.uint64(32)).astype(np.uint32), (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)]


def value_lanes(arr: np.ndarray) -> list[np.ndarray]:
    """Decompose one physical array into order-preserving 32-bit lanes."""
    dt = np.dtype(arr.dtype)
    if dt == np.bool_:
        return [arr.astype(np.int32)]
    if dt.kind == "i" and dt.itemsize <= 4:
        return [arr.astype(np.int32, copy=False)]
    if dt.kind == "u" and dt.itemsize < 4:
        return [arr.astype(np.int32)]
    if dt == np.uint32:
        return [arr]
    if dt == np.int64:
        return [(arr >> 32).astype(np.int32), (arr & 0xFFFFFFFF).astype(np.uint32)]
    if dt == np.uint64:
        return _split64(arr)
    if dt == np.float32:
        return [_flip32(arr.view(np.int32))]
    if dt == np.float64:
        return _split64(_flip64(arr.view(np.int64)))
    raise HyperspaceError(f"unsupported key dtype {dt}")


def column_lanes(table, name: str, force_validity: bool = False) -> list[np.ndarray]:
    """Lanes for a named column of a ColumnTable (validity lane first when
    the column has nulls; null slots zeroed so output is deterministic).
    `force_validity` emits the validity lane even for null-free columns so
    lane layouts match across tables (batched sorts)."""
    f = table.schema.field(name)
    arr = table.host_column(f.name)
    lanes: list[np.ndarray] = []
    valid = table.host_valid_mask(name)
    if valid is not None:
        lanes.append(valid.astype(np.int32))
        zero = np.zeros((), dtype=arr.dtype)
        arr = np.where(valid, arr, zero)
    elif force_validity:
        lanes.append(np.ones(len(arr), dtype=np.int32))
    if f.is_string:
        lanes.append(np.ascontiguousarray(arr, dtype=np.int32))
        return lanes
    lanes.extend(value_lanes(arr))
    return lanes


def key_lanes(table, key_columns: list[str], force_validity: bool = False) -> list[np.ndarray]:
    """All lanes for a key-column list, in sort-significance order."""
    out: list[np.ndarray] = []
    for c in key_columns:
        out.extend(column_lanes(table, c, force_validity=force_validity))
    return out


def lanes_as_unsigned(lanes: list[np.ndarray]) -> np.ndarray:
    """[L, n] uint32 matrix whose unsigned lexicographic order equals the
    lanes' mixed signed/unsigned order (signed lanes get the sign bit
    flipped) — the layout the JAX package's native host sort consumes."""
    out = np.empty((len(lanes), len(lanes[0]) if lanes else 0), dtype=np.uint32)
    for i, l in enumerate(lanes):
        if l.dtype == np.uint32:
            out[i] = l
        else:
            out[i] = l.astype(np.int32).view(np.uint32) ^ np.uint32(0x80000000)
    return out


def lane_tensor(lane: np.ndarray, device: torch.device) -> torch.Tensor:
    """One lane as an int64 tensor on `device`, order-preserving: uint32
    zero-extends, int32 sign-extends."""
    return torch.from_numpy(lane.astype(np.int64)).to(device)


def device_lanes_perm(lanes: list[torch.Tensor]) -> torch.Tensor:
    """Stable permutation sorting rows by int64 lanes (most significant
    first): one stable sort per lane, least significant first."""
    n = len(lanes[0]) if lanes else 0
    perm = torch.arange(n, device=lanes[0].device if lanes else "cpu")
    for lane in reversed(lanes):
        _, p = torch.sort(lane[perm], stable=True)
        perm = perm[p]
    return perm


def device_sort_perm(table, key_columns: list[str], device: torch.device) -> torch.Tensor:
    """Stable key-sort permutation of one table on `device`."""
    if table.num_rows <= 1:
        return torch.arange(table.num_rows, device=device)
    return device_lanes_perm([lane_tensor(l, device) for l in key_lanes(table, key_columns)])

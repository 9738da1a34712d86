"""The device mesh and its collectives.

The port of the JAX package's `parallel/mesh.py`: "N buckets sharded over
a device mesh" is the analog of "N shuffle partitions over a Spark
cluster". The inner axis ("x") spans the devices of one host; a
multi-slice mesh adds an outer "dcn" axis. Ownership of rows, buckets or
units is contiguous in flattened mesh order either way, so the sharded
operators are agnostic of the mesh's shape.

The JAX mesh is single-controller: one process drives every device of a
`jax.sharding.Mesh` through `shard_map` and XLA's collectives. So is this
one. A `Mesh` is an ordered tuple of `torch.device`s, and one device may
appear more than once: each appearance is a virtual shard, as the JAX
package's tests run eight virtual CPU devices. The collectives are plain
functions over a list of per-shard tensors (shard i's on `devices[i]`),
explicit copies between the shards' devices combined in shard order, so a
result never depends on timing. The same sharded code runs on one card
with four virtual shards and on N real cards.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from hyperspace_tpu_torch.exceptions import HyperspaceError

AXIS = "x"
DCN_AXIS = "dcn"


def normalize_device(device) -> torch.device:
    """A mesh device with its index: "cuda" means the current card. A CUDA
    device needs a card to exist."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise HyperspaceError(f"the mesh names {dev}, but no CUDA device is available")
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        if index >= torch.cuda.device_count():
            raise HyperspaceError(f"the mesh names cuda:{index}; {torch.cuda.device_count()} cards are visible")
        return torch.device("cuda", index)
    if dev.type != "cpu":
        raise HyperspaceError(f"unsupported mesh device {dev}")
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """`devices` in flattened mesh order (a device may repeat: virtual
    shards), `axis_names` ("x",) or ("dcn", "x"), `dims` the size of each
    axis."""

    devices: tuple
    axis_names: tuple
    dims: tuple

    def __post_init__(self):
        devices = tuple(normalize_device(d) for d in self.devices)
        if not devices:
            raise HyperspaceError("a mesh needs at least one device")
        if len({d.type for d in devices}) > 1:
            raise HyperspaceError(f"a mesh mixes device types: {sorted({d.type for d in devices})}")
        if len(self.axis_names) != len(self.dims) or math.prod(self.dims) != len(devices):
            raise HyperspaceError(f"mesh axes {self.axis_names} of sizes {self.dims} do not hold {len(devices)} devices")
        object.__setattr__(self, "devices", devices)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        object.__setattr__(self, "dims", tuple(int(x) for x in self.dims))

    @property
    def shape(self) -> dict:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.dims))


def mesh_axes(mesh: Mesh) -> tuple:
    """The mesh's data axes, innermost last ((x,) or (dcn, x))."""
    return tuple(mesh.axis_names)


def mesh_size(mesh: Mesh) -> int:
    return len(mesh.devices)


def _visible_cards() -> list:
    if not torch.cuda.is_available():
        raise HyperspaceError("no CUDA device is available; pass the mesh's devices (e.g. [torch.device('cpu')])")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(devices=None, n: int | None = None) -> Mesh:
    """A 1-D ("x") mesh over `devices` (default: every visible CUDA card),
    cut to the first `n`."""
    devices = _visible_cards() if devices is None else list(devices)
    if n is not None:
        devices = devices[:n]
    return Mesh(tuple(devices), (AXIS,), (len(devices),))


def make_multislice_mesh(num_slices: int, devices=None) -> Mesh:
    """2-D (dcn, x) mesh: the outer axis spans slices, the inner axis the
    devices within a slice."""
    devices = _visible_cards() if devices is None else list(devices)
    if num_slices < 1 or len(devices) % num_slices != 0:
        raise ValueError(f"{len(devices)} devices do not split into {num_slices} equal slices")
    return Mesh(tuple(devices), (DCN_AXIS, AXIS), (num_slices, len(devices) // num_slices))


def default_mesh() -> Mesh:
    return make_mesh()


def mesh_for_parallelism(mesh: Mesh | None, n_units: int) -> Mesh:
    """The largest prefix of `mesh` (flattened order) whose size divides
    `n_units`, so that contiguous ownership of units (buckets) is exact.
    Used by the build and the distributed query plane."""
    mesh = mesh if mesh is not None else make_mesh()
    d = mesh_size(mesh)
    if n_units % d == 0:
        return mesh
    while n_units % d != 0:
        d -= 1
    return make_mesh(list(mesh.devices), n=d)


def row_ranges(n: int, per: int, d: int) -> list[tuple[int, int]]:
    """Shard i's contiguous rows [lo, hi) of `n` real rows, `per` a shard;
    rows past `n` are pads and belong to no shard."""
    return [(min(i * per, n), min((i + 1) * per, n)) for i in range(d)]


def to_shard(t: torch.Tensor, mesh: Mesh, i: int) -> torch.Tensor:
    """`t` on shard i's device (itself where it already lies there)."""
    return t.to(mesh.devices[i], non_blocking=True)


# -- collectives: lists of per-shard tensors, combined in shard order --------


def all_to_all(parts: list, mesh: Mesh) -> list:
    """`parts[src][dst]` is what shard src sends shard dst (on src's
    device). Returns, for each dst, everything sent to it concatenated on
    its device in source order."""
    d = mesh_size(mesh)
    return [torch.cat([to_shard(parts[src][dst], mesh, dst) for src in range(d)]) for dst in range(d)]


def concat_shards(parts: list, device: torch.device) -> torch.Tensor:
    """Per-shard tensors concatenated on `device` in shard order."""
    return torch.cat([p.to(device, non_blocking=True) for p in parts])


def _fold(parts: list, device, op) -> torch.Tensor:
    out = parts[0].to(device, non_blocking=True)
    for p in parts[1:]:
        out = op(out, p.to(device, non_blocking=True))
    return out


def psum(parts: list, device: torch.device) -> torch.Tensor:
    """The elementwise sum of the shards' tensors on `device`, added in
    shard order."""
    return _fold(parts, device, torch.add)


def pmin(parts: list, device: torch.device) -> torch.Tensor:
    """The elementwise minimum (NaN propagates) on `device`."""
    return _fold(parts, device, torch.minimum)


def pmax(parts: list, device: torch.device) -> torch.Tensor:
    """The elementwise maximum (NaN propagates) on `device`."""
    return _fold(parts, device, torch.maximum)

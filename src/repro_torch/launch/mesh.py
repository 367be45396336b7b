"""Production meshes, sharding specs, and grid-axis sharding.

**The LM half** mirrors the reference's `make_production_mesh`,
`make_mesh`, `data_axes` and `dp_degree`.  A mesh is a plain
description, `Mesh(shape, mesh_dim_names)`: the port reads only the
axis names and sizes (the dry run's shardings, per-device shapes and
collective bytes), so the (16, 16) and (2, 16, 16) production meshes
need no process group and no device.  A sharding is a mesh and a
partition spec: one entry per tensor dimension, each None, a mesh-axis
name or a tuple of names (`MeshSharding`); `placements` turns it into
DTensor placements and `local_shape` gives the per-device shape under
them, an uneven dimension rounded up as XLA pads it.

**The grid half** carries the batched timing model
(core/timing_torch.py).  A grid "mesh" is a list of `torch.device`s: the
lane axis of a grid is split into one equal part per device, each part
evaluated on its device, and the parts concatenated.  Divisibility is
handled explicitly: a grid whose leading axis does not divide the device
count is padded by repeating its last row (and the caller told by how
much), or rejected with the exact remainder, never silently truncated or
reshaped.

Importing this module touches no device and no process group.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

# A partition spec: per tensor dimension None, a mesh axis, or a tuple.
Spec = Tuple[Any, ...]


# ------------------------------------------------------------------ LM mesh
@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh by its axis sizes and names (DeviceMesh's
    `shape` and `mesh_dim_names`)."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) with "pod"."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh(shape, axes) -> Mesh:
    """Arbitrary mesh for elastic rungs / tests."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} and axes "
                         f"{tuple(axes)} differ in length")
    return Mesh(tuple(int(n) for n in shape), tuple(axes))


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a `Mesh` (or a DeviceMesh)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def data_axes(mesh) -> tuple:
    """Mesh axes that carry data parallelism (pod + data when present)."""
    names = mesh.mesh_dim_names
    return tuple(a for a in ("pod", "data") if a in names)


def dp_degree(mesh) -> int:
    sizes = axis_sizes(mesh)
    out = 1
    for a in data_axes(mesh):
        out *= sizes[a]
    return out


def _spec_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(mesh, spec: Spec) -> list:
    """DTensor placements of `spec` on `mesh`: per mesh dimension
    `Shard(d)` where tensor dimension d is split over it, else
    `Replicate()`; a dimension over two axes is `Shard(d)` on both."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        for a in _spec_axes(entry):
            out[names.index(a)] = Shard(d)
    return out


def local_shape(mesh, places: Sequence[Any], shape: Sequence[int]
                ) -> Tuple[int, ...]:
    """Per-device shape of a `shape` leaf under DTensor placements: each
    dimension divided by the sizes of the mesh dimensions that shard it,
    an uneven one rounded up (XLA pads the last shard)."""
    out = list(shape)
    for size, p in zip(tuple(mesh.shape), places):
        if p.is_shard():
            out[p.dim] = -(-out[p.dim] // size)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class MeshSharding:
    """A mesh and a partition spec: the port's NamedSharding."""
    mesh: Any
    spec: Spec

    def placements(self) -> list:
        return placements(self.mesh, self.spec)

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        return local_shape(self.mesh, self.placements(), shape)


# ---------------------------------------------------------------- grid axis
def grid_mesh(num_devices: Optional[int] = None, *,
              device: "torch.device | str | None" = None
              ) -> List[torch.device]:
    """The devices a grid is sharded over.

    By default every visible CUDA card (raises without one); pass
    `num_devices` to restrict (it may not exceed the visible count).
    ``device="cpu"`` gives ``num_devices`` (default 1) host devices, the
    CPU stand-in for a multi-card mesh.
    """
    dev = resolve_device(device)
    if dev.type == "cpu":
        n = 1 if num_devices is None else int(num_devices)
    else:
        visible = torch.cuda.device_count()
        n = visible if num_devices is None else int(num_devices)
        if n > visible:
            raise ValueError(
                f"num_devices {n} exceeds the {visible} visible CUDA "
                f"devices")
    if n < 1:
        raise ValueError(f"num_devices must be >= 1, got {n}")
    if dev.type == "cpu":
        return [torch.device("cpu")] * n
    return [torch.device("cuda", k) for k in range(n)]


def grid_padding(n: int, parts: int, *, pad: bool = True) -> int:
    """Rows to append so `n` divides into `parts` equal shards.

    Returns 0 when already divisible.  With ``pad=False`` a remainder is
    an error carrying the exact numbers — the explicit contract that
    replaces silent truncation/implicit reshapes.
    """
    if parts < 1:
        raise ValueError(f"parts must be >= 1, got {parts}")
    if n < 1:
        raise ValueError(f"grid size must be >= 1, got {n}")
    rem = n % parts
    if rem == 0:
        return 0
    if not pad:
        raise ValueError(
            f"grid size {n} does not divide over {parts} devices "
            f"(remainder {rem}); pass pad=True to pad with "
            f"{parts - rem} repeated rows, or resize the grid")
    return parts - rem


def shard_grid(array, mesh: List[torch.device], *, pad: bool = True
               ) -> Tuple[List[torch.Tensor], int]:
    """Split `array`'s leading dimension into one part per mesh device.

    Returns ``(parts, extra)``: ``parts[k]`` is a tensor on ``mesh[k]``,
    and `extra` the number of padding rows appended (repeats of the last
    row) to make the leading dimension divide the device count; callers
    slice ``[:n]`` off any result computed from the parts.  With
    ``pad=False`` a non-divisible leading dimension raises instead —
    never a silent truncation.
    """
    arr = np.asarray(array)
    if arr.ndim == 0:
        raise ValueError("shard_grid needs at least one array dimension")
    extra = grid_padding(arr.shape[0], len(mesh), pad=pad)
    if extra:
        arr = np.concatenate([arr, np.repeat(arr[-1:], extra, axis=0)])
    rows = arr.shape[0] // len(mesh)
    parts = [torch.from_numpy(np.ascontiguousarray(
        arr[k * rows:(k + 1) * rows])).to(dev)
        for k, dev in enumerate(mesh)]
    return parts, extra

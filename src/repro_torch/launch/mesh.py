"""Grid-axis sharding for the batched timing model (core/timing_torch.py).

A "mesh" here is a list of `torch.device`s: the lane axis of a grid is
split into one equal part per device, each part evaluated on its device,
and the parts concatenated.  Divisibility is handled explicitly: a grid
whose leading axis does not divide the device count is padded by
repeating its last row (and the caller told by how much), or rejected
with the exact remainder, never silently truncated or reshaped.

Importing this module touches no device.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


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

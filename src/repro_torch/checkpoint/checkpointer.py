"""Async, atomic checkpointing of tensor trees, in the reference's format.

Format: one directory per step, `step_<8 digits>`, containing
  manifest.json    — {"step": step, "leaves": {path: {"file", "shape",
                     "dtype"}}}, one entry per leaf
  leaf_<5 digits>.npy — one file per leaf, numbered in flatten order

A leaf's path is the reference's key path: dict keys (sorted) and list
indices joined by "/", a NamedTuple field as ".field" (an AdamWState's
leaves are `.step`, `.master/<keys>/...`, `.m/...`, `.v/...`).  bfloat16
leaves are stored as their uint16 bits with logical dtype "bfloat16".  A
checkpoint written by the reference's Checkpointer restores here, and
the reverse.

Properties:
  * async: `save()` copies every leaf to host memory before it returns
    (the train loop may then update its tensors in place) and writes the
    files on a background thread;
  * atomic: writes go to `<dir>.tmp` and rename on completion, so a crash
    mid-write never corrupts the latest checkpoint;
  * retention: keep the last K checkpoints;
  * restore onto a device: `restore()` rebuilds the template's tree on
    `device` (the card unless the caller names the CPU).  Restoring onto
    a sharded layout waits for the mesh slice of the port.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import tree_unflatten

Pytree = Any


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_paths(tree: Pytree, path: str = "") -> List[Tuple[str, Any]]:
    """(key path, leaf) pairs in the reference's flatten order (that of
    `common.tree_leaves`)."""
    def join(part: str) -> str:
        return f"{path}/{part}" if path else part

    if _is_namedtuple(tree):
        return [kv for name, v in zip(tree._fields, tree)
                for kv in _flatten_with_paths(v, join(f".{name}"))]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_with_paths(tree[k], join(str(k)))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten_with_paths(v, join(str(i)))]
    return [(path, tree)]


def _host_copy(leaf) -> Tuple[np.ndarray, str]:
    """A host NumPy copy of `leaf` that nothing else references, and its
    logical dtype (bfloat16 is carried as its uint16 bits)."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.array(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach()
    logical = "bfloat16" if t.dtype == torch.bfloat16 else None
    if logical:
        t = t.view(torch.int16)          # Tensor.numpy() refuses bf16
    # For a CPU tensor .cpu() is the same storage: copy it, or an
    # in-place update right after save() would reach the file.
    arr = t.cpu().numpy().copy() if t.device.type == "cpu" else \
        t.cpu().numpy()
    if logical:
        return arr.view(np.uint16), logical
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, logical: str) -> torch.Tensor:
    # np.array (not ascontiguousarray: it promotes 0-d to 1-d)
    arr = np.array(arr)
    if logical == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Pytree, blocking: bool = False) -> None:
        self.wait()   # one in-flight save at a time
        host_leaves = [(key, *_host_copy(leaf))
                       for key, leaf in _flatten_with_paths(tree)]

        def _write():
            try:
                final = os.path.join(self.directory, f"step_{step:08d}")
                tmp = final + ".tmp"
                os.makedirs(tmp, exist_ok=True)
                manifest = {"step": step, "leaves": {}}
                for i, (key, arr, logical) in enumerate(host_leaves):
                    fname = f"leaf_{i:05d}.npy"
                    np.save(os.path.join(tmp, fname), arr)
                    manifest["leaves"][key] = {
                        "file": fname, "shape": list(arr.shape),
                        "dtype": logical}
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._gc()
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Pytree, step: Optional[int] = None,
                device=None) -> Pytree:
        """Rebuild `template`-structured tree from disk on `device` (the
        card unless the caller names the CPU).  The template's leaves
        are tensors (meta tensors will do) giving each leaf's shape and
        dtype."""
        dev = resolve_device(device)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)

        leaves = []
        for key, tmpl in _flatten_with_paths(template):
            info = manifest["leaves"].get(key)
            if info is None:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = np.load(os.path.join(d, info["file"]), mmap_mode="r")
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(
                    f"{key}: checkpoint shape {arr.shape} != "
                    f"{tuple(tmpl.shape)}")
            leaves.append(_to_tensor(arr, info["dtype"]).to(
                device=dev, dtype=tmpl.dtype))
        return tree_unflatten(template, leaves)

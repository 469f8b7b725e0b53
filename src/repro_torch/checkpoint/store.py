"""Checkpoint store, in the layout `repro.checkpoint.store` writes.

Layout:  <dir>/step_<N>/
             manifest.json      leaf paths, shapes, dtypes, step, extra
             <leaf-path>.npy    one file per leaf (full logical array)

A tree is nested dicts, NamedTuples (by field name), lists and tuples
(by position) whose leaves are tensors or numpy arrays; a leaf's path
joins its keys with "/", as jax names a pytree's leaves, and its file
name replaces "/" by "__".  bfloat16 leaves are stored as their uint16
bit patterns (numpy has no bfloat16) and the manifest records the
logical dtype.  So either package loads what the other saved.
Saves write a temporary directory and rename it into place: a crash
mid-save never leaves a half-written step visible.  Arrays are stored
whole, and `load_checkpoint(..., shardings=)` places each one whole on
a device or cut over a mesh axis.  `CheckpointManager`
writes steps in the background and keeps the newest few.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.runtime.sharding import place


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    if hasattr(tree, "_fields"):                  # a NamedTuple: by name
        tree = tree._asdict()
    if isinstance(tree, dict):
        out: Dict[str, Any] = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(array to write, logical dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    if str(arr.dtype) == "bfloat16":            # ml_dtypes' bfloat16
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def save_checkpoint(directory: str, step: int, tree, *,
                    extra: Optional[dict] = None) -> str:
    """Write <dir>/step_<step>; returns the final path."""
    final = os.path.join(directory, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}, "extra": extra or {},
                "time": time.time()}
    for key, leaf in _flatten(tree).items():
        arr, dtype_str = _to_numpy(leaf)
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape), "dtype": dtype_str}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                     # atomic publish
    return final


def latest_step(directory: str) -> Optional[int]:
    """The largest N of the step_<N> checkpoints under `directory`, or
    None when there is none."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                steps.append(int(d.split("_")[1]))
            except ValueError:
                pass
    return max(steps) if steps else None


def _decode_leaf(arr: np.ndarray, dtype_str: str) -> torch.Tensor:
    """A stored leaf as a CPU tensor of its logical dtype (undoing the
    bfloat16 -> uint16 bit-pattern encoding)."""
    if dtype_str == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _step_path(directory: str, step: Optional[int]) -> str:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    return os.path.join(directory, f"step_{step}")


def load_arrays(directory: str, *, step: Optional[int] = None
                ) -> Tuple[Dict[str, torch.Tensor], dict]:
    """({leaf path: CPU tensor}, manifest) of checkpoint `step` (None =
    the latest), without a template tree."""
    path = _step_path(directory, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    arrays = {key: _decode_leaf(np.load(os.path.join(path, info["file"])),
                                info["dtype"])
              for key, info in manifest["leaves"].items()}
    return arrays, manifest


def load_checkpoint(directory: str, like_tree, *,
                    step: Optional[int] = None, shardings=None):
    """(tree, manifest): checkpoint `step` (None = the latest) restored
    into the structure of `like_tree`, each leaf a CPU tensor, or placed
    as `shardings` says: a tree of the same structure (leaves may be left
    out) whose leaves are a device (the array whole on it) or a
    `runtime.sharding.Sharded` (the array cut over a mesh axis: a tuple
    of blocks, block s on slot s; `runtime.sharding.place`).  A
    checkpoint holds whole arrays, so it restores onto any mesh: the
    elastic re-mesh."""
    arrays, manifest = load_arrays(directory, step=step)
    if shardings is not None:
        for key, where in _flatten(shardings).items():
            arrays[key] = place(arrays[key], where)

    def build(node, prefix: str):
        if isinstance(node, dict):
            return {k: build(node[k], f"{prefix}{k}/") for k in node}
        if hasattr(node, "_fields"):                   # a NamedTuple
            return type(node)(**{f: build(getattr(node, f), f"{prefix}{f}/")
                                 for f in node._fields})
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, f"{prefix}{i}/")
                              for i, v in enumerate(node))
        return arrays[prefix[:-1]]
    return build(like_tree, ""), manifest


def _to_host(tree):
    """A copy of `tree` whose tensor leaves are host copies, taken now."""
    if hasattr(tree, "_fields"):                  # a NamedTuple
        return type(tree)(*(_to_host(v) for v in tree))
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return np.array(tree, copy=True)


class CheckpointManager:
    """Async, rotating checkpoint writer.

    `save(step, tree)` copies the tree's tensors to host memory at the
    call (the values at this step), and writes them with
    `save_checkpoint`, in a background thread when `async_save` (one
    write pending at most: a second save waits for the first), keeping
    the newest `keep` steps.  A write's error is raised by the next
    save() or wait()."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        if async_save:
            self._worker = threading.Thread(target=self._loop, daemon=True)
            self._worker.start()

    def save(self, step: int, tree, extra: Optional[dict] = None) -> None:
        if self._error:
            raise self._error
        host_tree = _to_host(tree)
        if self.async_save:
            self._q.put((step, host_tree, extra))   # blocks if one pending
        else:
            self._write(step, host_tree, extra)

    def wait(self) -> None:
        """Block until every queued save is written; raise a write's
        error."""
        if self.async_save:
            self._q.join()
        if self._error:
            raise self._error

    def _loop(self) -> None:
        while True:
            step, tree, extra = self._q.get()
            try:
                self._write(step, tree, extra)
            except BaseException as e:    # surfaced on next save()/wait()
                self._error = e
            finally:
                self._q.task_done()

    def _write(self, step, tree, extra) -> None:
        save_checkpoint(self.directory, step, tree, extra=extra)
        self._gc()

    def _gc(self) -> None:
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

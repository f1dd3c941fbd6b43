"""Atomic, async checkpointing of state trees.

Port of ``repro/train/checkpoint.py`` (``save_checkpoint``,
``latest_step``, ``restore_checkpoint``, ``AsyncCheckpointer``) for state
trees: NamedTuples of tensors or arrays (a ``BingoState``), with ``None``
leaves skipped.  A checkpoint is the reference's on-disk
layout, so each package reads the other's: ``step_<n>/`` holds one
``.npy`` per leaf, named by the leaf's path as JAX's
``tree_flatten_with_path`` prints it (``.nbr.npy``, ...,
``.itable__.prob.npy``, ``.itable__.alias.npy``; ``ginv`` absent when it
is ``None``), and a ``manifest.json`` with ``leaves`` and ``extra``.
Commit is atomic: write to ``step_<n>.tmp-<pid>`` then ``os.rename``.

``AsyncCheckpointer.save`` copies every tensor to the host on the
calling thread before it returns — the port updates its tables in place,
so a writer thread holding device tensors would write a later
generation — and writes on a background thread.  Over a process group
only group rank 0 writes, and ``wait`` ends in a barrier, so after it
every rank may read what was written.  The reference's
``shardings`` argument (re-placing leaves on another mesh) has no torch
counterpart yet; ``restore_checkpoint`` takes a ``device`` instead.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "AsyncCheckpointer"]

_MANIFEST = "manifest.json"


def _map_tree(tree, fn, path=()):
    """``tree`` with every leaf replaced by ``fn(key, leaf)``; ``key`` is
    the reference's leaf name (``".nbr"``, ``".itable/.prob"``)."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map_tree(x, fn, path + ("." + f,))
                            for f, x in zip(tree._fields, tree)])
    return fn("/".join(path), tree)


def _leaves(tree) -> dict:
    out = {}
    _map_tree(tree, lambda key, leaf: out.__setitem__(key, leaf))
    return out


def _to_numpy(x) -> np.ndarray:
    """A host copy of a leaf (never a view of a tensor's memory)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x, copy=True)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    extra: Optional[dict] = None) -> str:
    """Atomic save of a tree under ``ckpt_dir/step_<n>/``."""
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + f".tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for key, leaf in _leaves(tree).items():
        arr = leaf if isinstance(leaf, np.ndarray) else _to_numpy(leaf)
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                     # atomic commit
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and ".tmp" not in d]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, like: Any,
                       device=None) -> Any:
    """Restore into the structure of ``like``: every leaf a tensor of its
    ``like`` leaf's dtype, on ``device`` (default: that leaf's device;
    ``like`` may live on the ``meta`` device, which holds no memory)."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)

    def load(key, leaf):
        meta = manifest["leaves"][key]
        arr = np.load(os.path.join(d, meta["file"]), mmap_mode="r")
        arr = np.asarray(arr, dtype=meta["dtype"])
        dev = leaf.device if device is None else torch.device(device)
        return torch.from_numpy(np.array(arr, copy=True)).to(
            device=dev, dtype=leaf.dtype)
    return _map_tree(like, load)


class AsyncCheckpointer:
    """Background-thread checkpointing; at most one save in flight.

    With ``group`` every rank of the group calls ``save`` and ``wait`` in
    the same order; only group rank 0 writes (the others' ``tree`` is not
    read and may be None), and ``wait``, which ``save`` calls first, ends
    in a barrier over the group: a write starts after the previous one
    committed on every rank's view and is committed when ``wait``
    returns."""

    def __init__(self, ckpt_dir: str, keep: int = 3, group=None):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.group = group
        self.writer = True
        if group is not None:
            import torch.distributed as dist
            self.writer = dist.get_rank(group) == 0
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        """Copy ``tree`` to the host on this thread, then write it on a
        background thread; returns once the copy is taken."""
        self.wait()
        if not self.writer:
            return
        host_tree = _map_tree(tree, lambda _key, leaf: _to_numpy(leaf))

        def work():
            save_checkpoint(self.ckpt_dir, step, host_tree, extra)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.group is not None:
            import torch.distributed as dist
            dist.barrier(group=self.group)

    def _gc(self):
        steps = sorted(s for s in (
            int(d.split("_")[1]) for d in os.listdir(self.ckpt_dir)
            if d.startswith("step_") and ".tmp" not in d))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s}"),
                          ignore_errors=True)

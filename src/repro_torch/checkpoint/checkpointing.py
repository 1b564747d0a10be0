"""Checkpointing in JAX's layout, ported from
src/repro/checkpoint/checkpointing.py: <dir>/step_XXXXXXXX/ holds one
.npy per leaf and manifest.json (step, extra, each leaf's key, file,
shape and dtype), written under step_XXXXXXXX.tmp and published by an
atomic rename; an async saver overlaps the writes with the next steps.

Trees are the port's (tree.py: dicts and lists of tensors, numbers), keyed
by their paths as JAX keys its pytrees, so a checkpoint of f32 leaves that
JAX's ``save`` wrote restores here, and the other way round.  numpy has
no bfloat16 without ``ml_dtypes``: a bf16 leaf is stored as its raw bits,
uint16, with dtype "bfloat16" in the manifest, and restored bit for bit.

``restore(..., shardings=)`` is the elastic restore: a checkpoint saved
whole restores onto any mesh, each rank reading only its shard of each
leaf (``sharding.Placement`` per leaf, launch/sharding.tree_shardings).
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import sharding
from repro_torch import tree as tree_lib

BF16 = "bfloat16"


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the array to store and the dtype to record."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        arr = arr.astype(np.int32)       # JAX keeps its step as int32
    return arr, str(arr.dtype)


def _snapshot(tree: Any) -> Any:
    """Host copies of every leaf, taken now (the async save's consistent
    snapshot)."""
    return tree_lib.tree_map(
        lambda x: x.detach().to("cpu", copy=True)
        if isinstance(x, torch.Tensor) else x, tree)


def save(ckpt_dir, step: int, tree: Any,
         extra: Optional[Dict] = None) -> Path:
    """Blocking save of ``tree`` under <dir>/step_<n>/."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    tmp = d.with_suffix(".tmp")
    tmp.mkdir(parents=True, exist_ok=True)
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for key, leaf in tree_lib.flatten_with_paths(tree):
        arr, dtype = _to_numpy(leaf)
        fname = key.replace("/", "__") + ".npy"
        np.save(tmp / fname, arr)
        manifest["leaves"].append(
            {"key": key, "file": fname, "shape": list(arr.shape),
             "dtype": dtype})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if d.exists():                       # overwrite (e.g. re-save after a
        shutil.rmtree(d)                 # restart re-reaches this step)
    tmp.replace(d)                       # atomic publish
    return d


class AsyncCheckpointer:
    """Overlaps checkpoint writes with the next train steps."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[Path] = None

    def save(self, ckpt_dir, step, tree, extra=None):
        self.wait()
        snapshot = _snapshot(tree)       # on this thread: consistent

        def _write():
            self.last_path = save(ckpt_dir, step, snapshot, extra)

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(ckpt_dir) -> Optional[int]:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in d.glob("step_*")
                   if p.is_dir() and not p.name.endswith(".tmp"))
    return steps[-1] if steps else None


def _from_numpy(arr: np.ndarray, dtype: str, like):
    """A stored array as a leaf like ``like``: a tensor of like's dtype on
    like's device, or an int."""
    if dtype == BF16:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return int(t)


def restore(ckpt_dir, step: int, like: Any,
            shardings: Any = None) -> Tuple[Any, Dict]:
    """A new tree of ``like``'s structure, each leaf read from the
    checkpoint by its path key, in the leaf's dtype on its device; and the
    checkpoint's ``extra``.

    ``shardings``, a tree of ``sharding.Placement`` of ``like``'s
    structure (JAX's elastic restore onto a possibly different mesh):
    each leaf is this rank's shard of the stored full leaf
    (``sharding.local_shard``), read through a memory map so the rank
    copies only its slice out of the file; ``like``'s leaves give the
    dtype and device, their shapes may be the full or the shard's."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    by_key = {m["key"]: m for m in manifest["leaves"]}

    def load(key, ref, placement=None):
        m = by_key[key]
        if placement is None:
            return _from_numpy(np.load(d / m["file"]), m["dtype"], ref)
        arr = np.load(d / m["file"], mmap_mode="r")
        return _from_numpy(sharding.local_shard(arr, placement),
                           m["dtype"], ref)

    paths = tree_lib.path_tree(like)
    if shardings is None:
        out = tree_lib.tree_map(load, paths, like)
    else:
        out = tree_lib.tree_map(load, paths, like, shardings)
    return out, manifest["extra"]

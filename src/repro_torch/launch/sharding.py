"""Logical-axis -> mesh-axis rules for a mesh, ported from
src/repro/launch/sharding.py.

The binding is computed per (arch, mesh):

  * batch           -> (pod, data)         [data parallel everywhere]
  * vocab/heads/mlp -> model               [tensor parallel]
  * experts         -> model when it divides (expert parallel); otherwise
                       the expert FFN's hidden dim takes the model axis
  * KV cache        -> kv_heads on model when H_kv divides |model| (a
                       head-parallel cache), else kv_seq on model (a
                       context-parallel cache: the GQA small-H_kv case)

``sharding.spec_for`` drops any mapping that does not divide the concrete
dim and uses each mesh axis once per tensor, so one rule set serves every
(arch x shape x mesh).  The port's steps run them (launch/steps.py,
models/tp.py), and they drive ``checkpointing.restore``.  ``place`` cuts
a tree to a rank's shards and ``local_like`` allocates a tree at a
rank's shard shapes, so a rank holds only its shards.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch

from repro_torch import sharding as shlib
from repro_torch import tree as tree_lib
from repro_torch.models.config import ModelConfig


def make_rules(cfg: ModelConfig, mesh) -> Dict[str, object]:
    model_ax = "model" if "model" in mesh.axis_names else None
    batch_ax = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    msize = mesh.shape[model_ax] if model_ax else 1

    head_parallel_cache = cfg.n_kv_heads % msize == 0 if msize > 1 else True
    return {
        "batch": batch_ax if len(batch_ax) != 1 else batch_ax[0],
        "seq": None,
        "embed": None,
        "vocab": model_ax,
        "heads": model_ax,
        "mlp": model_ax,
        "experts": model_ax,
        "layers": None,
        "head_dim": None,
        "kv_heads": model_ax if head_parallel_cache else None,
        "kv_seq": None if head_parallel_cache else model_ax,
    }


def tree_shardings(spec_tree, shape_tree, mesh):
    """(logical-spec tree, tree of tensors of the full shapes) -> a tree of
    ``sharding.Placement`` of ``shape_tree``'s structure.  The spec tree
    follows the tensor tree's dicts and lists down to each tensor, whose
    spec is a tuple of logical names; spec_for reads the active context's
    rules."""
    return tree_lib.tree_map(
        lambda shp, spec: shlib.Placement(
            mesh, shlib.spec_for(spec, tuple(shp.shape))),
        shape_tree, spec_tree)


def replicated(mesh) -> shlib.Placement:
    return shlib.Placement(mesh, shlib.PartitionSpec())


def spec_axes(spec) -> tuple:
    """The mesh axis names a PartitionSpec uses."""
    out = []
    for ax in spec:
        if ax is not None:
            out += list(ax) if isinstance(ax, (tuple, list)) else [ax]
    return tuple(out)


def local_shape(shape, placement: shlib.Placement,
                coords: Optional[Mapping[str, int]] = None) -> tuple:
    """The shape of the rank's shard of a tensor of ``shape``."""
    return tuple(len(range(*s.indices(n))) for s, n in zip(
        shlib.shard_slices(tuple(shape), placement, coords), shape))


def place(tree, placements, coords=None, device=None):
    """``tree``'s tensors cut to the shards of the rank at ``coords``
    (default this rank) under ``placements`` (a tree of
    ``sharding.Placement``): each sharded leaf a tensor of its own holding
    only the shard (on ``device``, default the leaf's), a replicated leaf
    as it is (a padded LM head keeps its rows); numbers pass."""
    def cut(x, pl):
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            return x
        sl = shlib.shard_slices(tuple(x.shape), pl, coords)
        dev = x.device if device is None else torch.device(device)
        if all(s == slice(None) for s in sl):
            return x if dev == x.device else x.to(dev)
        part = x[sl]
        return torch.empty(part.shape, dtype=x.dtype,
                           device=dev).copy_(part)
    return tree_lib.tree_map(cut, tree, placements)


def local_like(meta_tree, placements, fill: Callable[[str], float],
               coords=None, device="cpu"):
    """A tree of ``meta_tree``'s structure (tensors of the full shapes,
    e.g. on meta) whose leaves are new tensors of the rank's shard shapes,
    each filled with ``fill(path)``: a cache or a state allocated only as
    the shard."""
    paths = tree_lib.path_tree(meta_tree)

    def make(t, pl, path):
        if not isinstance(t, torch.Tensor) or t.dim() == 0:
            return t
        return torch.full(local_shape(t.shape, pl, coords), fill(path),
                          dtype=t.dtype, device=device)
    return tree_lib.tree_map(make, meta_tree, placements, paths)

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
(arch x shape x mesh).  The port's steps run the rules' data axis today;
a ``model`` axis above 1 waits for a tensor-parallel body (ROADMAP.md,
Queue 1), but its placements already drive ``checkpointing.restore``.
"""
from __future__ import annotations

from typing import Dict

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

"""The elastic restore of the port (checkpoint/checkpointing.restore(...,
shardings=)) against the full leaves and JAX's restore, on the CPU.

A checkpoint of qwen2-0.5b's smoke parameters in bf16 and AdamW's f32
state, written whole by the port's ``save``, restored under the
placements of launch/sharding.tree_shardings on meshes (1, 2), (2, 1),
(2, 2) and (4, 2), once per rank (a runtime ``launch/mesh.Mesh`` of that
rank, no process group): each rank's leaf is the slice of the full leaf
that ``sharding.shard_slices`` names, read through a memory map; the
ranks' shards put back together equal the saved leaves bit for bit, and
JAX's ``restore`` of the same checkpoint (a bf16 leaf's uint16 bits, as
the port stores them)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointing as jckpt
from repro_torch import sharding as tsh
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import checkpointing as tckpt
from repro_torch.configs import base as tbase
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as tls
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw

torch.set_num_threads(1)
MESHES = [(1, 2), (2, 1), (2, 2), (4, 2)]


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    cfg = dataclasses.replace(tbase.get_config("qwen2-0.5b", smoke=True),
                              dtype="bfloat16")
    model = build_model(cfg, "cpu")
    params = model.init(seed=4)
    state = adamw.init_state(params)
    for m in tree_lib.leaves(state["m"]):
        m.normal_(generator=torch.Generator().manual_seed(m.numel()))
    state["step"] = 7
    tree = {"params": params, "opt_state": state}
    d = tmp_path_factory.mktemp("elastic")
    tckpt.save(d, 7, tree, extra={"note": "whole"})
    return model, tree, d


def _rank_mesh(data, model, rank):
    return mesh_lib.Mesh(data, model, rank, "none", torch.device("cpu"),
                         {"data": None, "model": None})


def _placements(model, tree, mesh):
    with tsh.use_context(mesh, tls.make_rules(model.cfg, mesh)):
        pl = tls.tree_shardings(model.param_specs(), tree["params"], mesh)
    return {"params": pl, "opt_state": {"m": pl, "v": pl,
                                        "step": tls.replicated(mesh)}}


@pytest.mark.parametrize("shape", MESHES)
def test_shards_rebuild_the_saved_leaves(saved, shape, monkeypatch):
    model, tree, d = saved
    loads = []
    real_load = np.load

    def load(path, *a, **kw):
        loads.append(kw.get("mmap_mode"))
        return real_load(path, *a, **kw)

    monkeypatch.setattr(tckpt.np, "load", load)
    keys = [k for k, _ in tree_lib.flatten_with_paths(tree)]
    full = dict(tree_lib.flatten_with_paths(tree))
    rebuilt = {k: (torch.full_like(v, float("nan"))
                   if isinstance(v, torch.Tensor) else None)
               for k, v in full.items()}
    n_sharded = 0
    for rank in range(shape[0] * shape[1]):
        mesh = _rank_mesh(*shape, rank)
        pls = dict(tree_lib.flatten_with_paths(_placements(model, tree,
                                                            mesh)))
        got, extra = tckpt.restore(d, 7, tree, shardings=_placements(
            model, tree, mesh))
        assert extra == {"note": "whole"}
        for key, leaf in tree_lib.flatten_with_paths(got):
            ref = full[key]
            if not isinstance(ref, torch.Tensor):
                assert leaf == ref == 7
                continue
            sl = tsh.shard_slices(tuple(ref.shape), pls[key])
            assert leaf.dtype == ref.dtype and leaf.shape == ref[sl].shape
            assert torch.equal(leaf.view(torch.int16) if leaf.dtype ==
                               torch.bfloat16 else leaf, ref[sl].view(
                                   torch.int16) if ref.dtype ==
                               torch.bfloat16 else ref[sl]), key
            n_sharded += leaf.numel() < ref.numel()
            rebuilt[key][sl] = leaf
    assert loads and all(m == "r" for m in loads)
    assert n_sharded > 0 or shape[1] == 1      # (d, 1): batch only
    for key in keys:
        if isinstance(full[key], torch.Tensor):
            a, b = rebuilt[key], full[key]
            if a.dtype == torch.bfloat16:
                a, b = a.view(torch.int16), b.view(torch.int16)
            assert torch.equal(a, b), key
    # JAX's restore of the same checkpoint, leaf for leaf
    like = tree_lib.tree_map(lambda x: np.zeros(()) if not isinstance(
        x, torch.Tensor) else np.zeros(x.shape), tree)
    want, _ = jckpt.restore(d, 7, like)
    for key, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        name = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in key)
        ref = full[name]
        w = np.asarray(w)
        if not isinstance(ref, torch.Tensor):
            assert int(w) == ref
        elif ref.dtype == torch.bfloat16:
            assert w.dtype == np.uint16
            np.testing.assert_array_equal(
                w, rebuilt[name].view(torch.int16).numpy().view(np.uint16))
        else:
            np.testing.assert_array_equal(w, rebuilt[name].numpy())


def test_restore_without_shardings_is_unchanged(saved):
    model, tree, d = saved
    got, _ = tckpt.restore(d, 7, tree)
    for (k, a), (_, b) in zip(tree_lib.flatten_with_paths(got),
                              tree_lib.flatten_with_paths(tree)):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(
                a.float(), b.float()), k
        else:
            assert a == b


def test_restore_into_shard_shaped_leaves(saved):
    """``like`` may hold the shards' shapes (a rank that never held the
    full leaves): only its dtypes and devices are read."""
    model, tree, d = saved
    mesh = _rank_mesh(1, 2, 1)
    pls = _placements(model, tree, mesh)
    like = tree_lib.tree_map(
        lambda x, p: tsh.local_shard(x, p).clone()
        if isinstance(x, torch.Tensor) else x, tree, pls)
    got, _ = tckpt.restore(d, 7, like, shardings=pls)
    for (k, a), (_, b) in zip(tree_lib.flatten_with_paths(got),
                              tree_lib.flatten_with_paths(like)):
        if isinstance(b, torch.Tensor):
            assert a.shape == b.shape and torch.equal(
                a.float(), b.float()), k

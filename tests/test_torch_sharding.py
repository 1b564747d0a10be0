"""The port's logical sharding rules (sharding.py, launch/sharding.py,
launch/mesh.make_production_mesh, the models' param_specs/cache_specs)
and the step builders' input specs and placements (launch/steps.py),
against the JAX package, on the CPU.

JAX's side runs on ``jax.sharding.AbstractMesh`` (no devices needed),
the port's on ``launch/mesh.MeshShape``.  For every config of
src/repro/configs/ at its full size and the meshes (1, 1), (2, 1),
(1, 2), (4, 2), (16, 16) and (2, 16, 16): ``make_rules`` equal, every
spec tree equal leaf for leaf once the port's per-layer lists are read
in JAX's stacked layout (bridge.py's key mapping), and every input's
resolved ``PartitionSpec`` equal.  ``input_specs`` has JAX's
``eval_shape`` shapes and dtypes on the meta device, allocating nothing.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import sharding as jsh
from repro.configs import base as jbase
from repro.launch import sharding as jls
from repro.launch import steps as jsteps
from repro.models.registry import build_model as jbuild
from repro_torch import bridge
from repro_torch import sharding as tsh
from repro_torch.configs import base as tbase
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as tls
from repro_torch.launch import steps as tsteps
from repro_torch.models.registry import build_model as tbuild

torch.set_num_threads(1)

MESHES = [(1, 1), (2, 1), (1, 2), (4, 2), (16, 16), (2, 16, 16)]
ARCHS = jbase.list_archs()


def jax_mesh(shape):
    names = ("pod", "data", "model") if len(shape) == 3 else ("data",
                                                                "model")
    return AbstractMesh(shape, names)


def port_mesh(shape):
    names = ("pod", "data", "model") if len(shape) == 3 else ("data",
                                                                "model")
    return mesh_lib.MeshShape(names, shape)


def test_production_meshes_and_data_axes():
    one = mesh_lib.make_production_mesh()
    two = mesh_lib.make_production_mesh(multi_pod=True)
    assert one.shape == {"data": 16, "model": 16}
    assert two.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh_lib.data_axes(one) == ("data",)
    assert mesh_lib.data_axes(two) == ("pod", "data")
    runtime = mesh_lib.shape_mesh(2, 1)       # the runtime Mesh reads too
    assert mesh_lib.data_axes(runtime) == ("data",)
    assert tls.make_rules(tbase.get_config("qwen2-0.5b"), runtime)[
        "batch"] == "data"


# ---------------------------------------------------------------------------
# spec_for's three rules, the context, shard, Placement and local_shard
# ---------------------------------------------------------------------------

SPEC_CASES = [
    (("batch", "seq"), (8, 16)),
    (("batch", "seq"), (3, 16)),             # data does not divide 3
    (("embed", "heads"), (64, 48)),
    (("heads", "vocab"), (32, 64)),          # model used once: first wins
    (("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
     (4, 8, 32, 2, 16)),
    ((None, "mlp"), (4, 6)),
    (("vocab", "embed", None), (7, 4, 2)),
    (("batch",), (32,)),
]


@pytest.mark.parametrize("shape", MESHES)
def test_spec_for_matches_jax(shape):
    cfg_j = jbase.get_config("llada-8b")
    cfg_t = tbase.get_config("llada-8b")
    jm, tm = jax_mesh(shape), port_mesh(shape)
    rules_j, rules_t = jls.make_rules(cfg_j, jm), tls.make_rules(cfg_t, tm)
    # a rule that names a tuple of axes and one that reuses an axis
    rules_j = dict(rules_j, seq=rules_j["batch"])
    rules_t = dict(rules_t, seq=rules_t["batch"])
    for names, dims in SPEC_CASES:
        with jsh.use_context(jm, rules_j):
            want = tuple(jsh.spec_for(names, dims))
            want_free = tuple(jsh.spec_for(names))
        with tsh.use_context(tm, rules_t):
            assert tuple(tsh.spec_for(names, dims)) == want, (names, dims)
            assert tuple(tsh.spec_for(names)) == want_free
            pl = tsh.named_sharding(names, dims)
            assert pl.mesh is tm and tuple(pl.spec) == want
    assert tsh.current_mesh() is None
    assert tsh.named_sharding(("batch",), (8,)) is None
    with tsh.use_context(None, {"batch": "data"}):   # no mesh: no dropping
        assert tuple(tsh.spec_for(("batch", None), (3, 2))) == ("data",)


def test_shard_is_the_identity():
    x = torch.arange(6).reshape(2, 3)
    with tsh.use_context(port_mesh((2, 1)), {"batch": "data"}):
        assert tsh.shard(x, "batch", None) is x


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (4, 2), (2, 2, 2)])
def test_local_shards_tile_the_full_tensor(shape):
    """Every rank's shard, placed where its coordinates say, rebuilds the
    full tensor; a tuple of axes orders its shards first axis major."""
    mesh = port_mesh(shape)
    names = mesh.axis_names
    batch = names[:-1] if len(names) == 3 else names[0]
    x = torch.arange(8 * 4 * 6).reshape(8, 4, 6)
    for spec in [tsh.P(batch, None, "model"), tsh.P(None, "model"),
                 tsh.P(), tsh.P("model", batch)]:
        pl = tsh.Placement(mesh, spec)
        rebuilt = torch.full_like(x, -1)
        for coords in np.ndindex(*shape):
            c = dict(zip(names, coords))
            sl = tsh.shard_slices(tuple(x.shape), pl, c)
            shard = tsh.local_shard(x, pl, c)
            assert torch.equal(shard, x[sl])
            rebuilt[sl] = shard
        assert torch.equal(rebuilt, x)
    if len(shape) == 3:      # ('pod', 'data'): pod is the major index
        pl = tsh.Placement(mesh, tsh.P(("pod", "data")))
        assert tsh.shard_slices((8,), pl, {"pod": 1, "data": 0}) == (
            slice(4, 6),)
    with pytest.raises(ValueError, match="coordinates"):
        tsh.local_shard(x, tsh.Placement(mesh, tsh.P("model")))
    big = max(names, key=mesh.shape.get)        # an axis of 2 or more
    with pytest.raises(ValueError, match="does not split"):
        tsh.local_shard(torch.zeros(3), tsh.Placement(mesh, tsh.P(big)),
                        dict(zip(names, (0,) * len(names))))


# ---------------------------------------------------------------------------
# rules, spec trees and every input's placement, per config and mesh
# ---------------------------------------------------------------------------

def to_jax_layout(tree, cfg, stack, norm):
    """A tree in the port's parameter layout -> JAX's (the inverse of
    bridge.params_from_numpy's mapping): per-layer lists stacked by
    ``stack(items)``, RMSNorms as ``{"w": norm(leaf)}``, a transformer
    layer's attention and MLP leaves nested under ``attn`` / ``mlp``."""
    def item(sub):
        return {k: ({"w": norm(v)} if k in bridge.NORM_KEYS
                    and not isinstance(v, dict)
                    else item(v) if isinstance(v, dict) else v)
                for k, v in sub.items()}

    def unflat(lp):
        out = item(lp)
        out["attn"] = {k: out.pop(k) for k in bridge.ATTN_KEYS if k in out}
        mlp = {k: out.pop(k) for k in bridge.MLP_KEYS if k in out}
        if mlp:
            out["mlp"] = mlp
        return out

    def stacked(items):
        if isinstance(items[0], dict):
            return {k: stacked([it[k] for it in items]) for k in items[0]}
        return stack(items)

    def fnorm(v):
        return {"w": norm(v)} if not isinstance(v, dict) else v

    out = {"embed": tree["embed"], "final_norm": fnorm(tree["final_norm"]),
           "lm_head": tree["lm_head"]}
    if cfg.family == "ssm":
        out["layers"] = stacked([item(lp) for lp in tree["layers"]])
        return out
    if cfg.family == "hybrid":
        out["triples"] = stacked([item(t) for t in tree["triples"]])
        out["tail"] = stacked([item(t) for t in tree["tail"]])
        return out
    out["layers"] = stacked([unflat(lp) for lp in tree["layers"]])
    if cfg.family == "audio":
        enc = tree["encoder"]
        out["encoder"] = {
            "layers": stacked([unflat(lp) for lp in enc["layers"]]),
            "pos_embed": enc["pos_embed"],
            "final_norm": enc["final_norm"]}
    return out


def _same_items(items):
    assert all(it == items[0] for it in items[1:]), items
    return items[0]


def spec_stack(items):
    return ("layers",) + _same_items(items)


def placement_stack(items):
    """A per-layer Placement's spec as JAX's stacked leaf's: the layers
    dim first (``layers`` maps to no mesh axis), trailing Nones trimmed."""
    spec = (None,) + tuple(_same_items([tuple(p.spec) for p in items]))
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def shape_stack(items):
    one = _same_items([(tuple(t.shape), t.dtype) for t in items])
    return (len(items),) + one[0], one[1]


def _is_spec(x):
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None), tuple)) for e in x)


@functools.lru_cache(maxsize=None)
def models(arch):
    return jbuild(jbase.get_config(arch)), tbuild(tbase.get_config(arch),
                                                  "meta")


@functools.lru_cache(maxsize=None)
def specs(arch, shape_name, split):
    jm, tm = models(arch)
    shape = jbase.SHAPES[shape_name]
    jp = jsteps.ServePolicy(split_cache=split)
    tp = tsteps.ServePolicy(split_cache=split)
    return (jsteps.input_specs(jm, shape, jp),
            tsteps.input_specs(tm, tbase.SHAPES[shape_name], tp))


def _spec_tuple(s):
    return tuple(s.spec)


def _compare_placements(cfg, jtree, ttree, what):
    """JAX's NamedSharding tree against the port's Placement tree (the
    port's params in its own layout), leaf for leaf."""
    for key in jtree:
        j, t = jtree[key], ttree[key]
        if key in ("params",):
            t = to_jax_layout(t, cfg, placement_stack, lambda p: p)
            j = jax.tree.map(_spec_tuple, j)
            t = jax.tree.map(lambda p: tuple(p.spec)
                             if isinstance(p, tsh.Placement) else p, t,
                             is_leaf=_is_spec)
        elif key == "opt_state":
            t = {"m": to_jax_layout(t["m"], cfg, placement_stack,
                                    lambda p: p),
                 "v": to_jax_layout(t["v"], cfg, placement_stack,
                                    lambda p: p),
                 "step": tuple(t["step"].spec)}
            j = jax.tree.map(_spec_tuple, j)
            t = jax.tree.map(lambda p: tuple(p.spec)
                             if isinstance(p, tsh.Placement) else p, t,
                             is_leaf=_is_spec)
        else:
            j = jax.tree.map(_spec_tuple, j)
            t = jax.tree.map(lambda p: tuple(p.spec), t,
                             is_leaf=lambda x: isinstance(x, tsh.Placement))
        jl = jax.tree_util.tree_leaves_with_path(j, is_leaf=_is_spec)
        tl = jax.tree_util.tree_leaves_with_path(t, is_leaf=_is_spec)
        assert [p for p, _ in jl] == [p for p, _ in tl], (what, key)
        for (path, a), (_, b) in zip(jl, tl):
            assert a == b, (what, key, jax.tree_util.keystr(path), a, b)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_spec_trees_and_placements_match_jax(arch, shape):
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    jm, tm = models(arch)
    jmesh, tmesh = jax_mesh(shape), port_mesh(shape)
    rules = jls.make_rules(jcfg, jmesh)
    assert tls.make_rules(tcfg, tmesh) == rules
    # the spec trees, leaf for leaf
    assert to_jax_layout(tm.param_specs(), tcfg, spec_stack,
                         lambda s: s) == jm.param_specs()
    for act in (None, 16):
        assert tm.cache_specs(act) == jm.cache_specs(act)
    for shape_name in jbase.applicable_shapes(jcfg):
        for split in (False, True):
            jspec, tspec = specs(arch, shape_name, split)
            jshape, tshape = (jbase.SHAPES[shape_name],
                              tbase.SHAPES[shape_name])
            with jsh.use_context(jmesh, rules):
                want = jsteps.input_shardings(
                    jm, jshape, jmesh, jspec,
                    jsteps.ServePolicy(split_cache=split))
            with tsh.use_context(tmesh, tls.make_rules(tcfg, tmesh)):
                got = tsteps.input_shardings(
                    tm, tshape, tmesh, tspec,
                    tsteps.ServePolicy(split_cache=split))
            assert sorted(got) == sorted(want)
            _compare_placements(tcfg, want, got,
                                f"{arch} {shape} {shape_name} {split}")


def test_tree_shardings_and_replicated():
    cfg = tbase.get_config("qwen2-0.5b")
    mesh = port_mesh((2, 2))
    model = tbuild(cfg, "meta")
    params = model.init()
    with tsh.use_context(mesh, tls.make_rules(cfg, mesh)):
        tree = tls.tree_shardings(model.param_specs(), params, mesh)
    assert tree["lm_head"].spec == (None, "model")
    assert tree["layers"][3]["wk"].spec == (None, "model")
    assert tree["layers"][0]["ln1"].spec == ()
    assert tls.replicated(mesh).spec == () and tls.replicated(mesh).mesh \
        is mesh


# ---------------------------------------------------------------------------
# input_specs: JAX's eval_shape shapes and dtypes, on meta
# ---------------------------------------------------------------------------

def _dt(x):
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_eval_shape(arch):
    cfg = tbase.get_config(arch)
    for shape_name in jbase.applicable_shapes(jbase.get_config(arch)):
        for split in (False, True):
            jspec, tspec = specs(arch, shape_name, split)
            assert sorted(jspec) == sorted(tspec)
            for key in jspec:
                j, t = jspec[key], tspec[key]
                if key == "params":
                    t = to_jax_layout(t, cfg, shape_stack, lambda x: x)
                elif key == "opt_state":
                    t = {"m": to_jax_layout(t["m"], cfg, shape_stack,
                                            lambda x: x),
                         "v": to_jax_layout(t["v"], cfg, shape_stack,
                                            lambda x: x),
                         "step": t["step"]}

                def sd(x):
                    if isinstance(x, tuple) and len(x) == 2 and \
                            isinstance(x[1], torch.dtype):
                        return x[0], str(x[1]).replace("torch.", "")
                    return tuple(x.shape), _dt(x)

                jl = jax.tree_util.tree_leaves_with_path(
                    jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                                 j), is_leaf=lambda x: isinstance(x, tuple)
                    and len(x) == 2 and isinstance(x[1], str))
                tl = jax.tree_util.tree_leaves_with_path(
                    jax.tree.map(sd, t, is_leaf=lambda x: isinstance(
                        x, tuple) and len(x) == 2 and isinstance(
                        x[1], torch.dtype)),
                    is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2
                    and isinstance(x[1], str))
                assert [p for p, _ in jl] == [p for p, _ in tl], key
                for (path, a), (_, b) in zip(jl, tl):
                    assert a == b, (arch, shape_name, key,
                                    jax.tree_util.keystr(path), a, b)
            leaves = [x for x in jax.tree.leaves(tspec)
                      if isinstance(x, torch.Tensor)]
            assert leaves and all(x.device.type == "meta" for x in leaves)

"""The tensor-parallel body (models/tp.py) of the port's step builders
(launch/steps.py) over (data, model) meshes with |model| > 1, against the
port's single-device step on the full inputs (which
tests/test_torch_steps.py holds against JAX's build_step), on the CPU.

Each mesh runs as spawned gloo ranks (tests/_torch_mesh_ranks.py, job
"tp"): (1, 2), (1, 4) and (2, 2), on the smoke configs in f32 with every
norm and bias moved off its constant init.  The cases cover a
head-parallel cache (llada-8b), a context-parallel cache whose ``wk``
shards cut a head (qwen2-0.5b and internvl2-26b at |model| = 4, two KV
heads), experts over ``model`` (llada-moe-7b-a1b) and the experts' hidden
dim over ``model`` (qwen2-moe-a2.7b with six experts at |model| = 4, with
its biased shared experts), experts whole on every rank beside sharded
shared experts (six experts of hidden 66 at |model| = 4), a replicated head (V = 257, which no
|model| > 1 divides), a vocab-sharded embedding, loss and decode head
(llada-8b with V = 256: shards of 128 and 64, route A), whisper's biased
GELU MLP (``b_out`` added once after the sum), its encoder and its
cross-attention, and the vlm's image splice.

* train: the loss within 1e-5 relative; each gathered gradient leaf within
  1e-5 of its largest value (mamba's leaves in JAX's layout, where the
  layers of one name form one stacked leaf: the gradients of its per-head
  f32 scalars, A_log, D and dt_bias, sum every position, channel and state
  with heavy cancellation, so a layer's may be 10x smaller than the
  stack's, and the f32 ulps of a row-parallel sum move it by up to 6e-5 of
  its own largest value; in float64 the mesh's gradients equal one rank's
  to 3e-14); the parameters after one AdamW step within
  2 x lr + 1e-6 (tests/test_torch_steps.py's bound: AdamW's first step
  moves each element by about lr x sign(g)); the loss and the MoE aux
  equal on every ``model`` rank;
* prefill: the gathered logits within 1e-5 of the largest logit; the
  gathered cache's K/V within one mxint4 grid step, at most one element in
  10^3 beyond 1e-5 (an MX rounding edge), the calibration and the split
  cache's unquantized active block within 1e-4 relative + 1e-5;
* decode, unified and split cache: the gathered canvas equal (no near-tie
  is recorded at these sizes), and every ``model`` rank's canvas equal;
* shard sizes: each rank's parameter, optimizer and cache bytes equal the
  shard that JAX's placements (launch/sharding.make_rules on
  ``jax.sharding.AbstractMesh``) give one device;
* ``QuantPolicy(enabled=True)``: the forward's logits within 1e-5 of the
  largest (llada-8b, whose ``wo`` shards of 16 rows at |model| 4 split
  MX blocks and are gathered first).  qwen2-moe-a2.7b with six experts
  (expert hidden shards of 16 rows at |model| 4, gathered too): its MoE
  combine sums in another order (2e-7 apart after the first layer), and
  one ulp moves an activation across an MX rounding edge now and then, so
  at least 95% of its logits lie within 1e-5 of the largest and all
  within 2% (0.7% of them beyond 1e-5, at most 0.66%, on every mesh; a
  block split across shards puts 99% beyond, up to 1.35 of 2.4).
"""
import dataclasses
import functools

import _torch_mesh_ranks as ranks
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import sharding as jsh
from repro.configs import base as jbase
from repro.launch import sharding as jls
from repro.launch import steps as jsteps
from repro.models.registry import build_model as jbuild

torch.set_num_threads(1)

MESHES = [(1, 2), (1, 4), (2, 2)]
CASES = ranks.TP_CASES
GRID_STEP = 0.3      # one mxint4 step of a minmax-smoothed value (<= 2/7)
CALIB = ("k_center", "k_scale", "v_center", "v_scale")


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def mesh_run(request, tmp_path_factory):
    data, model = request.param
    got = ranks.spawn("tp", data * model, tmp_path_factory.mktemp("tp"),
                      timeout=300.0, data=data, model=model, cases=CASES)
    return request.param, got


@functools.lru_cache(maxsize=None)
def one_rank(case):
    return ranks.tp_run(case)


@functools.lru_cache(maxsize=None)
def leaf_names(case):
    """Each gradient's leaf in the bound's layout: the port's own leaves,
    or for mamba JAX's, where ``layers/<i>/<name>`` of every layer is one
    stacked leaf ``layers/<name>``."""
    from repro_torch import tree as tree_lib
    from repro_torch.models.registry import build_model
    cfg = ranks.tp_config(case)
    paths = [p for p, _ in tree_lib.flatten_with_paths(
        build_model(cfg, "meta").init())]
    if cfg.family != "ssm":
        return paths
    return ["/".join(q for q in p.split("/") if not q.isdigit())
            for p in paths]


@pytest.mark.parametrize("case", CASES)
def test_train_matches_one_rank(mesh_run, case):
    _, got = mesh_run
    want, got = one_rank(case), got[case]
    (l0, a0, g0), (l1, a1, g1) = want["train"], got["train"]
    assert abs(l1 - l0) <= 1e-5 * abs(l0), (l1, l0)
    assert abs(a1 - a0) <= 1e-5 * max(abs(a0), 1e-30), (a1, a0)
    assert len(g1) == len(g0) == len(leaf_names(case))
    top = {}
    for name, w in zip(leaf_names(case), g0):
        top[name] = max(top.get(name, 0.0), float(np.abs(w).max()))
    for name, g, w in zip(leaf_names(case), g1, g0):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * max(
            top[name], 1e-30), err_msg=name)
    n0, p0 = want["train step"]
    n1, p1 = got["train step"]
    assert abs(n1 - n0) <= 1e-5 * n0, (n1, n0)       # the clipping norm
    assert np.abs(p1 - p0).max() <= 2 * ranks.TP_LR + 1e-6
    assert got["train equal"]


@pytest.mark.parametrize("case", CASES)
def test_prefill_matches_one_rank(mesh_run, case):
    _, got = mesh_run
    for split in (False, True):
        (lw, _, cw), (lg, _, cg) = (one_rank(case)["serve", split],
                                    got[case]["serve", split])
        assert lg.shape == lw.shape
        np.testing.assert_allclose(lg, lw, rtol=0,
                                   atol=1e-5 * float(np.abs(lw).max()))
        assert sorted(cg) == sorted(cw)
        for name, w in cw.items():
            diff = np.abs(cg[name] - w)
            if name in CALIB or name.endswith("_act"):
                # f32 calibration; the split cache's smoothed, unquantized
                # active block as the decode step leaves it
                np.testing.assert_allclose(cg[name], w, rtol=1e-4,
                                           atol=1e-5, err_msg=name)
            else:
                assert (diff > 1e-5).mean() <= 1e-3 and \
                    diff.max() <= GRID_STEP, (name, split, diff.max())


@pytest.mark.parametrize("split", [False, True], ids=["unified", "split"])
@pytest.mark.parametrize("case", CASES)
def test_decode_matches_one_rank(mesh_run, case, split):
    _, got = mesh_run
    want = one_rank(case)["serve", split][1]
    canvas = got[case]["serve", split][1]
    np.testing.assert_array_equal(canvas, want)
    assert got[case]["decode equal", split]


def jax_shard_bytes(cfg, mesh_shape, kind, split=False):
    """Bytes of one device's shard of the step inputs under JAX's
    placements: {"params", "opt" (m and v), "cache"}."""
    names = ("data", "model")
    jm = AbstractMesh(mesh_shape, names)
    model = jbuild(cfg)
    shape = jbase.ShapeConfig(kind, ranks.STEP_S, ranks.STEP_B, kind,
                              block_length=ranks.STEP_L)
    pol = jsteps.ServePolicy(split_cache=split)
    with jsh.use_context(jm, jls.make_rules(cfg, jm)):
        specs = jsteps.input_specs(model, shape, pol)
        shardings = jsteps.input_shardings(model, shape, jm, specs, pol)

    def nbytes(tree, shard_tree):
        import jax
        tot = 0
        for sds, sh in zip(jax.tree.leaves(tree), jax.tree.leaves(
                shard_tree, is_leaf=lambda x: isinstance(
                    x, jax.sharding.NamedSharding))):
            n = int(np.prod(sds.shape)) if sds.shape else 1
            parts = int(np.prod([dict(zip(names, mesh_shape))[a]
                                 for ax in sh.spec if ax is not None
                                 for a in ((ax,) if isinstance(ax, str)
                                           else ax)]))
            tot += n * sds.dtype.itemsize // parts
        return tot

    if kind == "train":
        opt = specs["opt_state"]
        return {"params": nbytes(specs["params"], shardings["params"]),
                "opt": nbytes((opt["m"], opt["v"]),
                              (shardings["opt_state"]["m"],
                               shardings["opt_state"]["v"]))}
    return {"cache": nbytes(specs["cache"], shardings["cache"])}


def jax_config(case):
    """JAX's smoke config with the case's changes (tp_config's)."""
    arch, *opts = case.split()
    cfg = jbase.get_config(arch, smoke=True)
    tcfg = ranks.tp_config(case)
    if any(o[0] == "v" for o in opts):
        cfg = dataclasses.replace(cfg, vocab=tcfg.vocab,
                                  mask_token_id=tcfg.mask_token_id)
    if "h32" in opts:
        cfg = dataclasses.replace(cfg, ssm_head_dim=32)
    if "e6" in opts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=6))
    if "f66" in opts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, d_ff_expert=66))
    return cfg


@pytest.mark.parametrize("case", CASES)
def test_shard_bytes_match_jax(mesh_run, case):
    mesh_shape, got = mesh_run
    cfg = jax_config(case)
    train = jax_shard_bytes(cfg, mesh_shape, "train")
    params, opt = got[case]["bytes"]
    assert params == train["params"]
    assert opt == train["opt"]
    for split in (False, True):
        want = jax_shard_bytes(cfg, mesh_shape, "decode", split)["cache"]
        assert got[case]["cache bytes", split] == want, split


@pytest.mark.parametrize("case", ranks.TP_QUANT_CASES)
def test_quant_forward_matches_one_rank(mesh_run, case):
    _, got = mesh_run
    want = ranks.tp_quant_forward(case)
    top = float(np.abs(want).max())
    diff = np.abs(got["quant"][case] - want)
    if ranks.tp_config(case).moe is None:
        assert diff.max() <= 1e-5 * top, diff.max()
    else:
        assert (diff > 1e-5 * top).mean() <= 0.05 and \
            diff.max() <= 0.02 * top, ((diff > 1e-5 * top).mean(),
                                       diff.max())

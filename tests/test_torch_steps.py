"""The port's step builders (launch/steps.py) against JAX's
(src/repro/launch/steps.py), on the CPU, and over a data mesh against
the single-device step.

Without a mesh, on smoke configs and the same parameters (bridge):

* train (dense, MoE with its aux, audio through the encoder, vlm through
  ``valid``; and ``loss_chunk``), with JAX's draw injected: the metrics
  and every gradient at tests/test_torch_train.py's tolerances (rtol
  1e-4, atol 1e-6, the gradients' atol x max(1, the leaf's largest
  value)), the parameters after AdamW at tests/test_torch_optim_data.py's
  (rtol 1e-4, atol 1e-3 x lr), but for an element whose JAX gradient is
  within the gradients' tolerance of 0: AdamW's first step moves it by
  about lr x sign(g), so it may differ by up to 2 x the step's lr;
* prefill: the active block's logits (rtol 1e-4, atol 5e-3) and every
  cache leaf (the calibration rtol 1e-4, atol 1e-5; an MX-quantized K/V
  element may sit one grid step apart at a rounding edge, at most one in
  10^3, tests/test_torch_baos.py);
* decode from JAX's prefilled cache, with and without ``split_cache``:
  the canvas equal and every cache leaf as above.

Over a data mesh, two gloo ranks (tests/_torch_mesh_ranks.py): prefill
and decode bit for bit equal to the single-device step; train within
1e-5 relative in the loss, every gradient within 1e-5 of its leaf's
largest value, the parameters within 2 x lr + 1e-6 (AdamW's first step
moves each element by about lr x sign(g), so a gradient element that
rounds to the other side of 0 moves its parameter by up to 2 x lr), and
every rank holding the same parameters; the MoE steps at the same
bounds (the aux the global batch's).  The ssm body over |model| > 1 and
sampled decoding over |data| > 1 or a vocab-sharded head build
(tests/test_torch_tp_steps.py holds |model| > 1, and
tests/test_torch_sampled_mesh.py the sampled decode).  A (1, 1) mesh in
this process equals no mesh bit for bit.
"""
import dataclasses
import functools

import _torch_mesh_ranks as ranks
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import diffusion as jdiff
from repro.launch import steps as jsteps
from repro.models.registry import build_model as jbuild
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch import tree as tree_lib
from repro_torch.configs import base as tbase
from repro_torch.core import baos as tbaos
from repro_torch.core import diffusion as tdiff
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as tsteps
from repro_torch.models.registry import build_model as tbuild
from repro_torch.optim import adamw as tadamw

torch.set_num_threads(1)

B, S, L, BS = 2, 32, 8, 16
RTOL, ATOL = 1e-4, 1e-6
SEED = 3


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


@functools.lru_cache(maxsize=None)
def _models(arch):
    cfg_j = jbase.get_config(arch, smoke=True)
    cfg_t = tbase.get_config(arch, smoke=True)
    model_j, model_t = jbuild(cfg_j), tbuild(cfg_t, "cpu")
    params_j = model_j.init(jax.random.PRNGKey(0))
    return model_j, model_t, params_j


def _params_t(arch):
    """The port's copy of JAX's parameters (its own memory: the train step
    updates it in place)."""
    model_j, model_t, params_j = _models(arch)
    return bridge.params_from_numpy(jax.tree.map(np.array, params_j),
                                    model_t.cfg, "cpu")


def _shapes(kind):
    return (jbase.ShapeConfig(kind, S, B, kind, block_length=L),
            tbase.ShapeConfig(kind, S, B, kind, block_length=L))


def _bf16(a):
    """numpy f32 values that bf16 holds exactly, as (jax, torch) bf16."""
    t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


def _extras(cfg, kind):
    """(JAX's, the port's) extra inputs for ``kind``, from numpy."""
    rs = np.random.RandomState(21)
    j, t = {}, {}
    if cfg.family == "audio":
        if kind in ("train", "prefill"):
            j["audio_embeds"], t["audio_embeds"] = _bf16(
                rs.randn(B, cfg.n_audio_ctx, cfg.d_model))
        else:
            kv = (cfg.n_layers, B, cfg.n_audio_ctx, cfg.n_kv_heads,
                  cfg.d_head)
            arrs = [rs.randn(*kv).astype(np.float32) for _ in range(2)]
            j["cross_kv"] = tuple(jnp.asarray(a) for a in arrs)
            t["cross_kv"] = tuple(torch.from_numpy(a) for a in arrs)
    if cfg.family == "vlm" and kind in ("train", "prefill"):
        j["image_embeds"], t["image_embeds"] = _bf16(
            rs.randn(B, cfg.n_image_tokens, cfg.d_model))
    return j, t


def _tokens(cfg, seed=1):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab - 2, size=(B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

TRAIN_CASES = {"llada-8b": 0, "llada-moe-7b-a1b": 0, "whisper-medium": 0,
               "internvl2-26b": 0, "llada-8b chunked": 8}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_step_matches_jax(case):
    arch = case.split()[0]
    model_j, model_t, params_j = _models(arch)
    cfg = model_t.cfg
    params_t = _params_t(arch)
    jpol = jsteps.ServePolicy(loss_chunk=TRAIN_CASES[case])
    tpol = tsteps.ServePolicy(loss_chunk=TRAIN_CASES[case])
    opt_j = jadamw.OptConfig(lr=3e-3, schedule="cosine", warmup_steps=2,
                             stable_steps=2, decay_steps=1)
    opt_t = tadamw.OptConfig(**dataclasses.asdict(opt_j))
    tokens = _tokens(cfg)
    ex_j, ex_t = _extras(cfg, "train")
    jshape, tshape = _shapes("train")
    fj, names_j = jsteps.build_step(model_j, jshape, jpol, opt_j)
    ft, names_t = tsteps.build_step(model_t, tshape, tpol, opt_t)
    assert names_t == names_j
    state_j = jadamw.init_state(params_j)
    new_j, _, met_j = jax.jit(fj)(params_j, state_j, jnp.asarray(tokens),
                                  jnp.uint32(SEED), ex_j)
    rng = jax.random.fold_in(jax.random.PRNGKey(0), SEED)
    draw = jdiff.forward_mask(rng, jnp.asarray(tokens), cfg.mask_id)
    draw_t = tuple(torch.from_numpy(np.asarray(d)) for d in draw)

    # the gradients, against jax.grad of the step's own loss
    def loss_fn(p):
        ex = dict(ex_j, params_ref=p)
        kw = jsteps._fwd_extras(model_j, model_j.cfg, ex, "train")
        valid = None
        if cfg.family == "vlm":
            valid = jnp.broadcast_to(jnp.arange(S) >= cfg.n_image_tokens,
                                     (B, S))
        return jdiff.masked_diffusion_loss(
            model_j, p, jnp.asarray(tokens), rng,
            aux_weight=0.01 if cfg.moe is not None else 0.0, valid=valid,
            loss_chunk=TRAIN_CASES[case] or None, **kw)[0]
    grads_j = jax.grad(loss_fn)(params_j)
    met_g, grads_t = tsteps.build_grad_fn(model_t, policy=tpol)(
        params_t, torch.from_numpy(tokens), SEED, ex_t, draw=draw_t)
    got = bridge.params_to_numpy(tree_lib.unflatten(params_t, grads_t), cfg)
    want = jax.tree.map(np.asarray, grads_j)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(want)):
        _close(g, w, atol=ATOL * max(1.0, float(np.abs(w).max())),
               what=f"{case} grad {jax.tree_util.keystr(path)}")

    # the whole step: metrics and the parameters after AdamW
    new_t, state_t, met_t = ft(params_t, tadamw.init_state(params_t),
                               torch.from_numpy(tokens), SEED, ex_t,
                               draw=draw_t)
    assert new_t is params_t and state_t["step"] == 1
    assert sorted(met_t) == sorted(met_j)
    for name in met_j:
        _close(float(met_t[name]), float(met_j[name]), what=name)
    if cfg.moe is not None:
        assert float(met_t["aux"]) > 0
    lr = float(met_j["lr"])
    for (path, g), w, gw in zip(jax.tree_util.tree_flatten_with_path(
            bridge.params_to_numpy(new_t, cfg))[0], jax.tree.leaves(new_j),
            jax.tree.leaves(want)):
        w = np.asarray(w, np.float32)
        # where JAX's gradient lies within the gradients' tolerance of 0,
        # AdamW's first step (about lr x sign(g)) may go either way
        tiny = np.abs(gw) <= ATOL * max(1.0, float(np.abs(gw).max()))
        what = f"{case} param {jax.tree_util.keystr(path)}"
        _close(g[~tiny], w[~tiny], atol=1e-3 * opt_j.lr, what=what)
        assert (np.abs(g - w)[tiny] <= 2 * lr + 1e-3 * opt_j.lr).all(), what


def test_train_step_draws_its_own_mask():
    """Without ``draw`` the step draws from step_generator(0, seed): the
    same seed, the same loss; another seed, another."""
    _, model_t, _ = _models("llada-8b")
    tokens = torch.from_numpy(_tokens(model_t.cfg))
    fn = tsteps.build_grad_fn(model_t)
    a = fn(_params_t("llada-8b"), tokens, 4, {})[0]["loss"]
    b = fn(_params_t("llada-8b"), tokens, 4, {})[0]["loss"]
    c = fn(_params_t("llada-8b"), tokens, 5, {})[0]["loss"]
    gen = tdiff.step_generator(0, 4, "cpu")
    draw = tdiff.forward_mask(gen, tokens, model_t.cfg.mask_id)
    d = fn(_params_t("llada-8b"), tokens, 9, {}, draw=draw)[0]["loss"]
    assert float(a) == float(b) == float(d) and float(a) != float(c)


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

GRID_STEP = 0.3      # one mxint4 step of a minmax-smoothed value (<= 2/7)


def _cache_close(got, want, what, baos=True):
    for name, w in want.items():
        g = got[name].float().numpy()
        w = np.asarray(w, np.float32)
        if not baos and name in tbaos.BAOSCalib._fields:
            # BAOS off: JAX still stores the calibration, the port keeps
            # the identity (ROADMAP.md, Queue 3, "Unused calibration")
            assert (g == (1.0 if "scale" in name else 0.0)).all(), name
        elif name in ("k", "v"):
            diff = np.abs(g - w)
            assert (diff > 1e-5).mean() <= 1e-3 and diff.max() <= \
                GRID_STEP, (what, name, diff.max())
        else:
            _close(g, w, atol=1e-5, what=f"{what} {name}")


def _canvas(cfg):
    x = _tokens(cfg, 7)
    x[:, BS:] = cfg.mask_id
    return x


SERVE_CASES = ["llada-8b", "llada-8b split", "llada-8b baos-off",
               "whisper-medium", "internvl2-26b"]


@pytest.mark.parametrize("case", SERVE_CASES)
def test_prefill_and_decode_match_jax(case):
    arch = case.split()[0]
    model_j, model_t, params_j = _models(arch)
    cfg = model_t.cfg
    params_t = _params_t(arch)
    kw = dict(split_cache="split" in case)
    if "baos-off" in case:
        kw["baos"] = jsteps.ServePolicy().baos.__class__(enabled=False)
    jpol = jsteps.ServePolicy(**kw)
    if "baos-off" in case:
        kw["baos"] = tbaos.BAOSConfig(enabled=False)
    tpol = tsteps.ServePolicy(**kw)
    act = L if jpol.split_cache else None
    x = _canvas(cfg)
    k = np.array([3, 2], np.int32)

    jpre, tpre = _shapes("prefill")
    fj, _ = jsteps.build_step(model_j, jpre, jpol)
    ft, names = tsteps.build_step(model_t, tpre, tpol)
    assert names == ("params", "x", "cache", "block_start", "extras")
    ex_j, ex_t = _extras(cfg, "prefill")
    logits_j, cache_j = jax.jit(fj)(params_j, jnp.asarray(x),
                                    model_j.init_cache(B, S, act),
                                    jnp.int32(BS), ex_j)
    logits_t, cache_t = ft(params_t, torch.from_numpy(x),
                           model_t.init_cache(B, S, act), BS, ex_t)
    assert sorted(cache_t) == sorted(cache_j)
    _close(logits_t.float().numpy(), np.asarray(logits_j, np.float32),
           atol=5e-3, what="prefill logits")
    _cache_close(cache_t, cache_j, f"{case} prefill", tpol.baos.enabled)

    jdec, tdec = _shapes("decode")
    fj, _ = jsteps.build_step(model_j, jdec, jpol)
    ft, names = tsteps.build_step(model_t, tdec, tpol)
    assert names == ("params", "x", "cache", "block_start", "k", "seed",
                     "extras")
    ex_j, ex_t = _extras(cfg, "decode")
    x_j, c_j = jax.jit(fj)(params_j, jnp.asarray(x), cache_j,
                           jnp.int32(BS), jnp.asarray(k), jnp.uint32(SEED),
                           ex_j)
    start = bridge.cache_from_numpy(jax.tree.map(np.asarray, cache_j), cfg,
                                    "cpu")
    x_t, c_t = ft(params_t, torch.from_numpy(x), start,
                  torch.tensor([BS]), torch.from_numpy(k), SEED, ex_t)
    np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j))
    committed = (x_t.numpy() != x).sum(1)
    np.testing.assert_array_equal(committed, k)
    assert x_t.dtype == torch.int32
    _cache_close(c_t, c_j, f"{case} decode")     # from JAX's cache


def test_policy_and_dcfg_match_jax():
    jp, tp = jsteps.ServePolicy(), tsteps.ServePolicy()
    for f in dataclasses.fields(jp):
        a, b = getattr(jp, f.name), getattr(tp, f.name)
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name
    cfg = tbase.get_config("llada-8b", smoke=True)
    d = tsteps.make_dcfg(cfg, _shapes("decode")[1], tp)
    assert (d.gen_length, d.block_length, d.steps_per_block,
            d.cache_mode) == (L, L, 8, "dual")
    assert d.baos == tp.baos and d.sampling == tp.sampling


# ---------------------------------------------------------------------------
# over a mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_steps(tmp_path_factory):
    return ranks.spawn("steps", 2, tmp_path_factory.mktemp("steps"),
                       timeout=240.0)


def test_mesh_2_1_equals_one_rank(mesh_steps):
    loss_s, grads_s, params_s, lr = mesh_steps["train", "single"]
    loss_m, grads_m, params_m = mesh_steps["train", "mesh"]
    assert abs(loss_m - loss_s) <= 1e-5 * abs(loss_s)
    for g, w in zip(grads_m, grads_s):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * max(
            float(np.abs(w).max()), 1e-30))
    assert np.abs(params_m - params_s).max() <= 2 * lr + 1e-6
    assert mesh_steps["train", "ranks equal"]
    for split in (False, True):
        single, mesh = (mesh_steps["serve", split][n]
                        for n in ("single", "mesh"))
        np.testing.assert_array_equal(mesh[0], single[0])    # logits
        np.testing.assert_array_equal(mesh[1], single[1])    # canvas
        assert sorted(mesh[2]) == sorted(single[2])
        for name in single[2]:
            np.testing.assert_array_equal(mesh[2][name], single[2][name])
        assert (mesh[1] != single[1]).sum() == 0
        assert ("k_act" in mesh[2]) == split


def test_mesh_refusals(mesh_steps):
    for kind in ("ssm train", "ssm decode"):
        # the ssm body runs over |model| > 1 (test_torch_tp_steps.py)
        assert mesh_steps["refused", kind] is None
    for kind in ("hot decode", "hot sharded-head decode"):
        # the decode step samples on any mesh (test_torch_sampled_mesh.py)
        assert mesh_steps["refused", kind] is None
    with pytest.raises(TypeError, match="not a launch/mesh.Mesh"):
        tsteps.build_step(_models("llada-8b")[1], _shapes("prefill")[1],
                          mesh=mesh_lib.make_production_mesh())


def test_mesh_2_1_moe_equals_one_rank(mesh_steps):
    """The MoE train step over |data| = 2 (its load-balance aux the
    global batch's) and its prefill + decode, against one rank at the
    bounds of test_mesh_2_1_equals_one_rank."""
    want, got = ranks.tp_run("llada-moe-7b-a1b"), mesh_steps["moe"]
    (l0, a0, g0), (l1, a1, g1) = want["train"], got["train"]
    assert abs(l1 - l0) <= 1e-5 * abs(l0)
    assert abs(a1 - a0) <= 1e-5 * abs(a0)
    for g, w in zip(g1, g0):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * max(
            float(np.abs(w).max()), 1e-30))
    assert np.abs(got["train step"][1] - want["train step"][1]).max() <= \
        2 * ranks.TP_LR + 1e-6
    for split in (False, True):
        np.testing.assert_array_equal(got["serve", split][1],
                                      want["serve", split][1])


def test_mesh_1_1_equals_no_mesh():
    """A (1, 1) gloo mesh in this process: the train, prefill and decode
    steps bit for bit equal to no mesh."""
    _, model_t, _ = _models("llada-8b")
    cfg = model_t.cfg
    mesh = mesh_lib.make_debug_mesh(1, 1, "cpu")
    tokens = torch.from_numpy(_tokens(cfg))
    out = {}
    for m in (None, mesh):
        params = _params_t("llada-8b")
        step, _ = tsteps.build_step(model_t, _shapes("train")[1], mesh=m)
        params, _, met = step(params, tadamw.init_state(params), tokens,
                              SEED, {})
        pre, _ = tsteps.build_step(model_t, _shapes("prefill")[1], mesh=m)
        dec, _ = tsteps.build_step(model_t, _shapes("decode")[1], mesh=m)
        x = torch.from_numpy(_canvas(cfg))
        with torch.no_grad():
            logits, cache = pre(params, x, model_t.init_cache(B, S), BS, {})
            x1, cache = dec(params, x, cache, BS, torch.tensor([3, 2]),
                            SEED, {})
        out[m is None] = (float(met["loss"]), tree_lib.leaves(params),
                          logits, x1, cache)
    a, b = out[True], out[False]
    assert a[0] == b[0]
    assert all(torch.equal(p, q) for p, q in zip(a[1], b[1]))
    assert torch.equal(a[2], b[2]) and torch.equal(a[3], b[3])
    assert all(torch.equal(a[4][n], b[4][n]) for n in a[4])

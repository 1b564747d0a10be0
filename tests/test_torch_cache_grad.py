"""The cached forward under autograd against ``jax.grad`` of the JAX
package, on the CPU: attention with BAOS, route B's second K/V source and a
device query offset (kernels/flash_bidir.py ``FlashBidir``), the BAOS
write-back (kernels/baos_mx_quant.py ``BaosMxQuant``) in every core/mx
KV format, the calibration's ties, and ``transformer.forward`` with a
cache (the warm step with BAOS in every format, the split refine, a
refine from a device block start, the hybrid past its window), every
parameter leaf.

Tolerances, stated per test:

* f32 attention: rtol 1e-4, atol 1e-5 x each leaf's largest |gradient|
  (summation order).
* bf16 activations or bf16 scores: within 3% of each leaf's largest
  |gradient|.  The port fuses q * f_k and out * f_v + c_v in f32 and
  rounds once; JAX rounds each to the activation dtype (ROADMAP.md, Queue
  3, "BAOS fusion rounding": up to 1.3% of the output's largest value),
  and the bf16 scores round P and dS (2% of dq's and dk's largest).
* baos_mx_quant: dx rtol 1e-6 in f32 (the same division), one bf16 ulp
  (rtol 2^-8) in bf16; dc and df rtol 1e-5 with atol 1e-6 x their largest
  (summation order; df's f^-2 rounds apart).
* the calibration: rtol 1e-6, atol 1e-7 x the largest.
* the model: rtol 1e-4, atol 1e-5 x max(1, each leaf's largest) in f32
  (the smoke configs), as tests/test_torch_train.py holds the cache-free
  gradient, with 1e-4 of the largest for the MX-quantized caches (an MX
  block scale at a log2 edge can sit one step apart, test_torch_baos.py)
  and 1e-2 for the bf16 cache, whose cotangents both packages round to
  bf16: f32 cotangents summed in other orders round one bf16 ulp apart
  where they straddle a rounding boundary.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import baos as jbaos
from repro.core import diffusion as jdiff
from repro.models import layers as jlayers
from repro.models.registry import build_model as jbuild
from repro_torch import bridge
from repro_torch import tree as tree_lib
from repro_torch.configs import base as tbase
from repro_torch.core import baos as tbaos
from repro_torch.core import diffusion as tdiff
from repro_torch.core import mx as tmx
from repro_torch.kernels import baos_mx_quant as tbq
from repro_torch.kernels import flash_bidir as tfb
from repro_torch.models.registry import build_model as tbuild

torch.set_num_threads(1)

KV_FORMATS = ("mxint4", "mxint8", "mxfp8_e4m3", "mxfp6_e3m2", "mxfp4_e2m1",
              "bf16", "none")
# the formats whose fake-quant has no derivative (round, grid lookup)
ZERO_FORMATS = ("mxint4", "mxint8", "mxfp6_e3m2", "mxfp4_e2m1")
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _leaf_close(got, want, what, rtol=1e-4, atol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(float(np.abs(want).max()),
                                               1e-30), err_msg=what)


def _bf16_close(got, want, what, frac=3e-2):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    err = float(np.abs(got - want).max())
    assert err <= frac * float(np.abs(want).max()), (what, err)


# ---------------------------------------------------------------------------
# attention with BAOS, route B and a device query offset
# ---------------------------------------------------------------------------

# (B, Sq, Skv, Hq, Hkv, D, window, offset, second-source length, causal)
ATTN = {
    "baos": (2, 6, 12, 4, 2, 16, None, 0, 0, False),
    "split_baos": (2, 4, 12, 4, 2, 16, None, 5, 4, False),
    "offset_baos": (2, 4, 20, 4, 2, 16, 5, 9, 0, False),
    "offset_split_causal": (2, 4, 16, 4, 2, 16, 6, 8, 4, True),
}


def _attn_case(name, seed=0):
    B, Sq, Skv, Hq, Hkv, D, win, off, S2, causal = ATTN[name]
    rng = np.random.RandomState(seed)
    x = {"q": rng.randn(B, Sq, Hq, D), "k": rng.randn(B, Skv, Hkv, D),
         "v": rng.randn(B, Skv, Hkv, D),
         "fk": rng.uniform(0.5, 2, (B, Hkv, D)),
         "fv": rng.uniform(0.5, 2, (B, Hkv, D)), "cv": rng.randn(B, Hkv, D),
         "do": rng.randn(B, Sq, Hq, D)}
    valid = rng.rand(B, Skv) > 0.25
    valid[:, :2] = True
    if S2:
        x["k2"], x["v2"] = (rng.randn(B, S2, Hkv, D) for _ in range(2))
        # the cache's stale copy of the block is masked, as the split
        # refine masks it
        valid[:, off:off + S2] = False
    return {n: a.astype(np.float32) for n, a in x.items()}, valid


def _jax_cached_attention(name, valid, dtype, scores):
    B, Sq, Skv, Hq, Hkv, D, win, off, S2, causal = ATTN[name]
    qpos = np.tile(off + np.arange(Sq), (B, 1))
    kpos = np.tile(np.arange(Skv), (B, 1))

    def f(q, k, v, fk, fv, cv, k2=None, v2=None):
        cal = jbaos.BAOSCalib(jnp.zeros_like(fk[:, None]), fk[:, None],
                              cv[:, None], fv[:, None])
        extra = None if k2 is None else (
            k2, v2, np.tile(off + np.arange(S2), (B, 1)),
            jnp.ones((B, S2), bool))
        return jlayers.attention(
            q, k, v, q_pos=qpos, kv_pos=kpos, kv_valid=jnp.asarray(valid),
            mode="causal" if causal else "bidir", window=win,
            baos_calib=cal, extra_kv=extra, score_dtype=JDT[scores])
    return f


@pytest.mark.parametrize("scores", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(ATTN))
def test_attention_cached_grad_matches_jax(name, dtype, scores):
    """flash_bidir with BAOS (f_k, f_v, c_v f32), route B's second source
    and a (B,) int64 query offset, under autograd: every gradient against
    ``jax.grad`` of JAX's ``layers.attention(baos_calib=, extra_kv=,
    q_pos=offset + r)``; the tensor offset's gradients equal the host
    int's bit for bit."""
    x, valid = _attn_case(name, seed=len(name))
    B, Sq, Skv, Hq, Hkv, D, win, off, S2, causal = ATTN[name]
    names = ["q", "k", "v", "fk", "fv", "cv"] + (["k2", "v2"] if S2 else [])
    jx = {n: jnp.asarray(x[n]).astype(JDT[dtype]) if n in
          ("q", "k", "v", "k2", "v2") else jnp.asarray(x[n]) for n in names}
    f = _jax_cached_attention(name, valid, dtype, scores)
    do = jnp.asarray(x["do"]).astype(JDT[dtype])
    want = jax.grad(lambda *a: jnp.sum(
        (f(*a) * do).astype(jnp.float32)), tuple(range(len(names))))(
        *(jx[n] for n in names))

    def port(q_offset):
        ts = {n: torch.from_numpy(x[n]).to(TDT[dtype] if n in
              ("q", "k", "v", "k2", "v2") else torch.float32)
              .requires_grad_() for n in names}
        extra = (ts["k2"], ts["v2"], None) if S2 else None
        out = tfb.flash_bidir(ts["q"], ts["k"], ts["v"],
                              torch.from_numpy(valid), ts["fk"], ts["fv"],
                              ts["cv"], window=win, q_offset=q_offset,
                              extra_kv=extra, causal=causal,
                              score_dtype=scores)
        assert out.grad_fn is not None
        out.backward(torch.from_numpy(x["do"]).to(TDT[dtype]))
        return [ts[n].grad.float().numpy() for n in names]
    got = port(torch.full((B,), off, dtype=torch.int64))
    for a, b in zip(got, port(off)):
        np.testing.assert_array_equal(a, b)
    for n, g, w in zip(names, got, want):
        w = np.asarray(w.astype(jnp.float32))
        if dtype == "float32" and scores == "float32":
            _leaf_close(g, w, f"d{n} {name}")
        else:
            _bf16_close(g, w, f"d{n} {name} {dtype} scores {scores}")


def test_flash_bidir_bwd_skips_what_needs_no_grad():
    """``flash_bidir_bwd(needs=)``: the split refine's read-only cache gets
    no dk/dv, and the other gradients equal the full call's."""
    x, valid = _attn_case("split_baos", seed=3)
    ts = {n: torch.from_numpy(a) for n, a in x.items()}
    kw = dict(fk=ts["fk"], fv=ts["fv"], cv=ts["cv"],
              extra_kv=(ts["k2"], ts["v2"], None))
    args = (ts["q"], ts["k"], ts["v"], ts["do"], torch.from_numpy(valid),
            None, 5)
    full = tfb.flash_bidir_bwd(*args, **kw)
    part = tfb.flash_bidir_bwd(*args, **kw, needs=(True, False, False, True,
                                                   False, True, True, True))
    assert part[1] is None and part[2] is None and part[4] is None
    for a, b in zip(full, part):
        if b is not None:
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    # the cache-less call: the same 8 entries, None past dq, dk, dv
    bare = tfb.flash_bidir_bwd(*args)
    assert len(bare) == 8 and bare[3:] == (None,) * 5


def test_bwd_count_names():
    """The backward's launch-count entries, in the forward's order with
    BAOS before the device offset."""
    assert tfb.bwd_count_name(True, False, True, True) == \
        "flash_bidir_bwd_split"
    assert tfb.bwd_count_name(False, False, True, True) == \
        "flash_bidir_bwd_baos"
    assert tfb.bwd_count_name(False, False, True, False) == \
        "flash_bidir_bwd_offset"
    assert tfb.bwd_count_name(False, True, True, True) == \
        "flash_bidir_bwd_causal"
    assert tfb.bwd_count_name(True, True, True, True, True) == \
        "flash_bidir_bwd_bf16s"
    assert tfb.bwd_count_name(False, False, False, False) == "flash_bidir_bwd"


def test_bwd_plan_two_terms():
    """BAOS's two bf16 terms of q and dO: the dq CTA's rows and the dk/dv
    ring double, and every plan still fits the shared memory a block
    takes (the dk/dv ring at tile 256 two stages deep)."""
    for dt in (32, 64, 128, 256):
        w1 = tfb.bwd_dq_max_warps(dt, True)
        w2 = tfb.bwd_dq_max_warps(dt, True, 2)
        assert 1 <= w2 <= w1
        assert tfb.bwd_dq_smem(dt, True, w2, 2) <= tfb.SMEM_LIMIT_BYTES
        for bs in (False, True):
            assert tfb.bwd_dkv_smem(dt, bs, 2) <= tfb.SMEM_LIMIT_BYTES
    assert tfb.bwd_dkv_stages(256, 2) == 2 and tfb.bwd_dkv_stages(128, 2) == 3
    p = tfb.bwd_plan(4, 96, 96, 32, 32, 128, torch.bfloat16, masked=True,
                     terms=2)
    assert p.dq_smem == tfb.bwd_dq_smem(128, True, p.dq_warps, 2)
    assert p.dkv_smem == tfb.bwd_dkv_smem(128, False, 2)


# ---------------------------------------------------------------------------
# baos_mx_quant's backward
# ---------------------------------------------------------------------------

def _kv(B, S, H, D, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, S, H, D) * 2).astype(np.float32)
    c = (rng.randn(B, 1, H, D) * 0.3).astype(np.float32)
    f = rng.uniform(0.5, 3, (B, 1, H, D)).astype(np.float32)
    g = rng.randn(B, S, H, D).astype(np.float32)
    return x, c, f, g


def _jax_smooth_quantize_vjp(x, c, f, g, fmt, dtype):
    cfg = jbaos.BAOSConfig(kv_format=fmt)
    xj = jnp.asarray(x).astype(JDT[dtype])
    _, vjp = jax.vjp(lambda a, b, s: jbaos.smooth_quantize(a, b, s, cfg), xj,
                     jnp.asarray(c), jnp.asarray(f))
    return [np.asarray(t.astype(jnp.float32)) for t in vjp(
        jnp.asarray(g).astype(JDT[dtype]))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", KV_FORMATS)
def test_baos_mx_quant_grad_matches_jax(fmt, dtype):
    """(dx, dc, df) of baos_mx_quant against ``jax.vjp`` of
    core/baos.smooth_quantize: 0 for the integer formats, fp6 and fp4;
    mxfp8's cotangent rounded to e4m3 at its block scale; bf16's to bf16;
    none's as it is; then through (x - c) / f, summed over the positions
    into (B, 1, H, D)."""
    x, c, f, g = _kv(2, 12, 3, 64, seed=KV_FORMATS.index(fmt))
    want = _jax_smooth_quantize_vjp(x, c, f, g, fmt, dtype)
    xt = torch.from_numpy(x).to(TDT[dtype]).requires_grad_()
    ct, ft = (torch.from_numpy(a).requires_grad_() for a in (c, f))
    y = tbq.baos_mx_quant(xt, ct, ft, fmt)
    assert y.grad_fn is not None and y.dtype == xt.dtype
    y.backward(torch.from_numpy(g).to(TDT[dtype]))
    got = [t.grad.float().numpy() for t in (xt, ct, ft)]
    if fmt in ZERO_FORMATS:
        for gg, w in zip(got, want):
            assert not gg.any() and not w.any()
        return
    np.testing.assert_allclose(got[0], want[0],
                               rtol=1e-6 if dtype == "float32" else 2 ** -8)
    for n, gg, w in zip(("dc", "df"), got[1:], want[1:]):
        _leaf_close(gg, w, f"{n} {fmt} {dtype}", rtol=1e-5, atol=1e-6)


def test_mxfp8_cotangent_rounding():
    """mxfp8's cotangent is rounded to e4m3 at the block's scale (so it is
    not the identity's), NaN past 464 as JAX's cast, and halved where a
    value sits at +-448 of its scale (jnp.clip's tie): each as JAX's."""
    x, c, f, g = _kv(1, 4, 1, 32, seed=11)
    c[:], f[:] = 0.0, 1.0
    x[0, 1, 0, 5] = 1.75      # the block's amax: 448 x 2^-8, at the clip
    x[0, 1, 0, :5] = x[0, 1, 0, 6:] = 0.3
    dx = {}
    for fmt in ("mxfp8_e4m3", "none"):
        want = _jax_smooth_quantize_vjp(x, c, f, g, fmt, "float32")
        dx[fmt] = tbq.baos_mx_quant_bwd(*(torch.from_numpy(a) for a in
                                          (x, c, f, g)), fmt)[0].numpy()
        np.testing.assert_array_equal(dx[fmt], want[0])
    assert not np.array_equal(dx["mxfp8_e4m3"], dx["none"])
    assert dx["mxfp8_e4m3"][0, 1, 0, 5] == 0.5 * float(
        tmx.e4m3_cast(torch.tensor(g[0, 1, 0, 5] * 2.0 ** -8))) * 2 ** 8
    big = torch.tensor([470.0, 464.0, -465.0, 100.0])
    want = np.asarray(jnp.asarray(big.numpy()).astype(
        jnp.float8_e4m3fn).astype(jnp.float32))
    np.testing.assert_array_equal(tmx.e4m3_cast(big).numpy(), want)


# ---------------------------------------------------------------------------
# the calibration's ties
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("variant", ["minmax", "mean"])
def test_calibration_ties_split_as_jax(variant, masked):
    """core/baos.calibrate under autograd on K/V full of ties (small
    integers: each channel's max and min are taken by several positions,
    and minmax's two radii are equal): torch's amax/amin and maximum split
    the gradient between tied positions as JAX's max/min/maximum do."""
    rng = np.random.RandomState(2)
    k = rng.randint(-3, 4, (2, 16, 2, 8)).astype(np.float32)
    v = rng.randint(-2, 3, (2, 16, 2, 8)).astype(np.float32)
    w = [rng.randn(2, 1, 2, 8).astype(np.float32) for _ in range(4)]
    mask = None
    if masked:
        mask = np.zeros((2, 16), bool)
        mask[0, 4:12] = mask[1, 0:9] = True
    cfg_j = jbaos.BAOSConfig(variant=variant)
    cfg_t = tbaos.BAOSConfig(variant=variant)

    def fj(k, v):
        cal = jbaos.calibrate(k, v, cfg_j,
                              None if mask is None else jnp.asarray(mask))
        return sum(jnp.sum(a * b) for a, b in zip(cal, w))
    want = jax.grad(fj, (0, 1))(jnp.asarray(k), jnp.asarray(v))
    kt, vt = (torch.from_numpy(a).requires_grad_() for a in (k, v))
    cal = tbaos.calibrate(kt, vt, cfg_t,
                          None if mask is None else torch.from_numpy(mask))
    sum((a * torch.from_numpy(b)).sum() for a, b in zip(cal, w)).backward()
    for n, t, wj in zip("kv", (kt, vt), want):
        wj = np.asarray(wj)
        if variant == "minmax":        # the split is visible: halves
            assert np.any(np.abs(wj) > 0) and np.any(
                (np.abs(wj) > 0) & (np.abs(wj) < np.abs(wj).max()))
        _leaf_close(t.grad.numpy(), wj, f"d{n} {variant}", rtol=1e-6,
                    atol=1e-7)


# ---------------------------------------------------------------------------
# the model's cached forward
# ---------------------------------------------------------------------------

B, S, L = 2, 32, 8
BS = S - L


@functools.lru_cache(maxsize=None)
def _models(arch):
    cfg_j = jbase.get_config(arch, smoke=True)
    cfg_t = tbase.get_config(arch, smoke=True)
    model_j, model_t = jbuild(cfg_j), tbuild(cfg_t, "cpu")
    params_j = model_j.init(jax.random.PRNGKey(0))
    return model_j, model_t, params_j


def _params_t(arch):
    model_j, model_t, params_j = _models(arch)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                      model_t.cfg, "cpu")
    for p in tree_lib.leaves(params):
        p.requires_grad_(True)
    return params


def _dcfgs(baos, fmt="mxint4", mode="dual"):
    kw = dict(gen_length=L, block_length=L, steps_per_block=2,
              cache_mode=mode)
    return (jdiff.DiffusionConfig(baos=jbaos.BAOSConfig(
                enabled=baos, kv_format=fmt), **kw),
            tdiff.DiffusionConfig(baos=tbaos.BAOSConfig(
                enabled=baos, kv_format=fmt), **kw))


def _check_grads(arch, grads_t, grads_j, what, atol=1e-5):
    cfg = _models(arch)[1].cfg
    got = bridge.params_to_numpy(tree_lib.unflatten(
        _params_t(arch), grads_t), cfg)
    want = jax.tree.map(np.asarray, grads_j)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(want)):
        np.testing.assert_allclose(
            g, w, rtol=1e-4, atol=atol * max(1.0, float(np.abs(w).max())),
            err_msg=f"{what} {jax.tree_util.keystr(path)}")
    assert any(np.abs(w).max() > 0 for w in jax.tree.leaves(want))


def _port_grads(arch, step):
    params = _params_t(arch)
    logits, _ = step(params)
    W = torch.from_numpy(np.random.RandomState(9).randn(
        *logits.shape).astype(np.float32))
    leaves = tree_lib.leaves(params)
    grads = torch.autograd.grad((logits * W).sum(), leaves,
                                allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)], W.numpy()


def _tokens(cfg, seed=1):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab - 2, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("fmt", KV_FORMATS + ("off",))
def test_warm_step_grads_match_jax(fmt):
    """The warm step (calibrate, write the cache through BAOS, attend over
    it) under autograd, llada-8b's smoke config: every parameter's
    gradient of sum(logits * W) against ``jax.grad`` of JAX's warm_step.
    Under an integer, fp6 or fp4 cache the gradient reaches K and V only
    through the calibration (f_k in q * f_k; f_v, c_v in the output), as
    in JAX; the cache the step returns holds the values it wrote."""
    arch = "llada-8b"
    model_j, model_t, params_j = _models(arch)
    x = _tokens(model_t.cfg)
    dj, dt = _dcfgs(fmt != "off", fmt if fmt != "off" else "mxint4")
    grads_t, W = _port_grads(arch, lambda p: tdiff.warm_step(
        model_t, p, torch.from_numpy(x), model_t.init_cache(B, S), BS, dt))
    grads_j = jax.grad(lambda p: jnp.sum(jdiff.warm_step(
        model_j, p, jnp.asarray(x), model_j.init_cache(B, S), BS, dj)[0]
        * W))(params_j)
    # bf16 rounds each cotangent of the cache to bf16 (in both packages):
    # where the two packages' f32 cotangents, summed in other orders, lie
    # either side of a rounding boundary they round one bf16 ulp apart
    atol = {"off": 1e-5, "none": 1e-5, "bf16": 1e-2}.get(fmt, 1e-4)
    _check_grads(arch, grads_t, grads_j, f"warm {fmt}", atol=atol)
    with torch.no_grad():
        cache = model_t.init_cache(B, S)
        tdiff.warm_step(model_t, _params_t(arch), torch.from_numpy(x), cache,
                        BS, dt)
    graded = model_t.init_cache(B, S)
    tdiff.warm_step(model_t, _params_t(arch), torch.from_numpy(x), graded,
                    BS, dt)
    for name in cache:
        assert not graded[name].requires_grad
        np.testing.assert_array_equal(graded[name].numpy(),
                                      cache[name].numpy(), err_msg=name)


def _refine_grads(arch, baos, split, device_start, fmt="mxint4"):
    model_j, model_t, params_j = _models(arch)
    x = _tokens(model_t.cfg)
    dj, dt = _dcfgs(baos, fmt)
    act = L if split else None
    _, cj = jdiff.warm_step(model_j, params_j, jnp.asarray(x),
                            model_j.init_cache(B, S, act_len=act),
                            jnp.int32(BS), dj)
    cj = jax.tree.map(np.asarray, cj)
    start = torch.tensor([BS]) if device_start else BS
    grads_t, W = _port_grads(arch, lambda p: tdiff.refine_step(
        model_t, p, torch.from_numpy(x),
        bridge.cache_from_numpy(cj, model_t.cfg, "cpu"), start, dt))
    grads_j = jax.grad(lambda p: jnp.sum(jdiff.refine_step(
        model_j, p, jnp.asarray(x), jax.tree.map(jnp.asarray, cj),
        jnp.int32(BS), dj)[0] * W))(params_j)
    return grads_t, grads_j


@pytest.mark.parametrize("baos", [False, True], ids=["plain", "baos"])
def test_split_refine_grads_match_jax(baos):
    """The split refine (route B: the read-only cache less its stale copy
    of the block, and the smoothed, unquantized active buffer in one
    softmax) under autograd, from JAX's warm cache carried over
    (bridge.cache_from_numpy): every parameter's gradient against
    ``jax.grad`` of JAX's refine_step."""
    grads_t, grads_j = _refine_grads("llada-8b", baos, True, False)
    _check_grads("llada-8b", grads_t, grads_j, f"split refine baos={baos}")


@pytest.mark.parametrize("split", [False, True], ids=["unified", "split"])
def test_refine_device_start_grads_match_jax(split):
    """A refine whose block start is a device tensor (the graphed steps
    and launch/steps.py: the segment scattered through index_copy, the
    query offset read from memory), BAOS mxint4, against ``jax.grad`` of
    JAX's refine_step at a traced start."""
    grads_t, grads_j = _refine_grads("llada-8b", True, split, True)
    _check_grads("llada-8b", grads_t, grads_j, f"device start split={split}")


def test_hybrid_past_window_grads_match_jax():
    """recurrentgemma-2b's smoke config past its 32-position window (a
    40-position canvas, the block at 32) from a device block start, BAOS
    mxint4: the refine's gradients of every leaf, the local attention's
    window placed by the offset in memory, against ``jax.grad``."""
    arch = "recurrentgemma-2b"
    model_j, model_t, params_j = _models(arch)
    s_tot, start = 40, 32
    x = np.random.RandomState(4).randint(
        0, model_t.cfg.vocab - 2, size=(B, s_tot)).astype(np.int32)
    dj, dt = _dcfgs(True)
    _, cj = jdiff.warm_step(model_j, params_j, jnp.asarray(x),
                            model_j.init_cache(B, s_tot), jnp.int32(start),
                            dj)
    cj = jax.tree.map(np.asarray, cj)
    grads_t, W = _port_grads(arch, lambda p: tdiff.refine_step(
        model_t, p, torch.from_numpy(x),
        bridge.cache_from_numpy(cj, model_t.cfg, "cpu"),
        torch.tensor([start]), dt))
    grads_j = jax.grad(lambda p: jnp.sum(jdiff.refine_step(
        model_j, p, jnp.asarray(x), jax.tree.map(jnp.asarray, cj),
        jnp.int32(start), dj)[0] * W))(params_j)
    _check_grads(arch, grads_t, grads_j, "hybrid past the window")

"""The training path of the PyTorch port against the JAX package, on the
CPU: attention's gradient (kernels/flash_bidir.py: ``FlashBidir``'s
backward and ``flash_bidir_bwd_plain``) against ``jax.grad`` of JAX's
models/layers.attention and kernels/ref.flash_bidir_ref;
core/diffusion.masked_diffusion_loss's value, metrics and every
parameter's gradient against ``jax.value_and_grad`` of JAX's loss on the
same injected draw, for the dense (llada-8b; qwen2-0.5b with QKV bias and
GQA), moe (aux loss at weight 0.01), ssm and hybrid smoke configs; and
the guard of the kernels without a backward.  The train steps are in
test_torch_optim_data.py, the train CLI in
test_torch_checkpoint_runtime.py.

Tolerances (f32 throughout): attention gradients rtol 1e-4, atol 1e-5;
the loss and its metrics rtol 1e-4, atol 1e-6; each parameter gradient
rtol 1e-4, atol 1e-6 x
max(1, the largest |gradient| of its leaf).  The two packages sum in
other orders, so they agree to f32 rounding, not bit for bit; an element
that is a sum of large terms cancelling near zero (the hybrid model's
embedding rows, whose leaf reaches |4|) carries the absolute rounding of
those terms, which the leaf's largest magnitude bounds.

One deliberate difference: a query row with no valid key.  Its output
averages V whatever q and k are (in both packages, as the test shows),
so its dq and its share of dk are 0 in the port.  JAX adds the -1e30 mask
as a bias, so ``jax.grad`` sends the row's ds through that addition and
returns a nonzero dq and dk there, which is no derivative of the
function; its dv, the gradients of the other rows and everything else
are held to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import baos as jbaos
from repro.core import diffusion as jdiff
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro.models.registry import build_model as jbuild
from repro_torch import bridge
from repro_torch import tree as tree_lib
from repro_torch.configs import base as tbase
from repro_torch.core import diffusion as tdiff
from repro_torch.kernels import _build
from repro_torch.kernels import flash_bidir as fb
from repro_torch.models.registry import build_model as tbuild

torch.set_num_threads(1)

ATTN_RTOL, ATTN_ATOL = 1e-4, 1e-5
RTOL, ATOL = 1e-4, 1e-6


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# attention's gradient
# ---------------------------------------------------------------------------

# (B, Sq, Skv, Hq, Hkv, D, window, q_offset, kv_valid lengths or None)
ATTN_CASES = {
    "mha": (2, 12, 12, 4, 4, 16, None, 0, None),
    "gqa2": (2, 12, 12, 4, 2, 16, None, 0, None),
    "gqa7": (2, 10, 10, 14, 2, 16, None, 0, None),
    "kv_valid_empty_row": (3, 9, 9, 4, 2, 16, None, 0, (9, 0, 4)),
    "window_q_offset": (2, 6, 20, 4, 2, 16, 5, 9, (20, 13)),
    "d64": (2, 8, 8, 4, 2, 64, None, 0, None),
    "d256": (1, 6, 6, 2, 1, 256, None, 0, None),
}


def _attn_inputs(case, seed=0):
    B, Sq, Skv, Hq, Hkv, D, win, off, lens = case
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Sq, Hq, D).astype(np.float32)
    k = rng.randn(B, Skv, Hkv, D).astype(np.float32)
    v = rng.randn(B, Skv, Hkv, D).astype(np.float32)
    do = rng.randn(B, Sq, Hq, D).astype(np.float32)
    valid = np.ones((B, Skv), bool)
    if lens is not None:
        valid = np.arange(Skv)[None, :] < np.asarray(lens)[:, None]
    return q, k, v, do, valid


def _jax_attn(case, valid):
    B, Sq, Skv, _, _, _, win, off, _ = case
    q_pos = np.tile(off + np.arange(Sq), (B, 1))
    kv_pos = np.tile(np.arange(Skv), (B, 1))

    def f(q, k, v):
        return jlayers.attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                 kv_valid=valid, window=win)
    return f


@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_attention_grad_matches_jax(name):
    case = ATTN_CASES[name]
    win, off, lens = case[6:]
    q, k, v, do, valid = _attn_inputs(case)
    f = _jax_attn(case, valid)
    want_out = np.asarray(f(q, k, v))
    want = [np.asarray(g) for g in jax.jit(jax.grad(
        lambda *a: jnp.sum(f(*a) * do), (0, 1, 2)))(q, k, v)]

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tvalid = None if lens is None else torch.from_numpy(valid)
    out = fb.flash_bidir(tq, tk, tv, tvalid, window=win, q_offset=off)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(do))
    got = [t.grad.numpy() for t in (tq, tk, tv)]
    with torch.no_grad():
        plain = [t.numpy() for t in fb.flash_bidir_bwd_plain(
            *(torch.from_numpy(x) for x in (q, k, v, do)), tvalid, win,
            off)[:3]]
    _close(out.detach().numpy(), want_out, ATTN_RTOL, ATTN_ATOL, "out")
    # rows with a valid key: every gradient equals JAX's
    live = valid.any(axis=1)
    for n, g, p, w in zip("qkv", got, plain, want):
        assert np.isfinite(g).all() and np.isfinite(p).all()
        np.testing.assert_array_equal(g, p)       # the Function runs plain
        _close(g[live], w[live], ATTN_RTOL, ATTN_ATOL, f"d{n} {name}")
    if live.all():
        return
    # a batch row with no valid key: its output ignores q and k (in both
    # packages), so dq = dk = 0 there; dv averages dO, as in JAX
    dead = ~live
    assert not got[0][dead].any() and not got[1][dead].any()
    _close(got[2][dead], want[2][dead], ATTN_RTOL, ATTN_ATOL, "dv dead")
    moved = np.asarray(f(q * 3.0, k * 2.0 + 1.0, v))
    np.testing.assert_array_equal(moved[dead], want_out[dead])


@pytest.mark.parametrize("G", [1, 2, 7])
def test_attention_grad_matches_reference_window(G):
    """Against ``jax.grad`` of kernels/ref.flash_bidir_ref (window, no
    kv_valid), MHA, GQA 2 and GQA 7."""
    B, S, Hkv, D, win = 2, 12, 2, 16, 4
    rng = np.random.RandomState(G)
    q = rng.randn(B, S, Hkv * G, D).astype(np.float32)
    k, v = (rng.randn(B, S, Hkv, D).astype(np.float32) for _ in range(2))
    do = rng.randn(B, S, Hkv * G, D).astype(np.float32)
    want = jax.jit(jax.grad(lambda *a: jnp.sum(jref.flash_bidir_ref(
        *a, window=win) * do), (0, 1, 2)))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    fb.flash_bidir(tq, tk, tv, window=win).backward(torch.from_numpy(do))
    for t, w in zip((tq, tk, tv), want):
        _close(t.grad.numpy(), np.asarray(w), ATTN_RTOL, ATTN_ATOL)


def test_attention_grad_refuses_baos():
    """BAOS under autograd (it was refused before the cached forward had a
    backward): the gradients of q, k, v and of the calibration f_k, f_v,
    c_v equal ``jax.grad`` of JAX's ``layers.attention(baos_calib=)``
    (f32: ATTN_RTOL, and ATTN_ATOL x each leaf's largest); under no_grad
    the serving path carries no backward, as before."""
    case = ATTN_CASES["window_q_offset"]
    q, k, v, do, valid = _attn_inputs(case, seed=4)
    B, Sq, Skv, Hq, Hkv, D, win, off, _ = case
    rng = np.random.RandomState(5)
    fk, fv = (rng.uniform(0.5, 2, (B, Hkv, D)).astype(np.float32)
              for _ in range(2))
    cv = rng.randn(B, Hkv, D).astype(np.float32)

    def f(q, k, v, fk, fv, cv):
        cal = jbaos.BAOSCalib(jnp.zeros_like(fk[:, None]), fk[:, None],
                              cv[:, None], fv[:, None])
        return jnp.sum(jlayers.attention(
            q, k, v, q_pos=np.tile(off + np.arange(Sq), (B, 1)),
            kv_pos=np.tile(np.arange(Skv), (B, 1)), kv_valid=valid,
            window=win, baos_calib=cal) * do)
    want = jax.grad(f, tuple(range(6)))(q, k, v, fk, fv, cv)
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, fk, fv,
                                                         cv)]
    out = fb.flash_bidir(*ts[:3], torch.from_numpy(valid), *ts[3:],
                         window=win, q_offset=off)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(do))
    for n, t, w in zip(("q", "k", "v", "fk", "fv", "cv"), ts, want):
        w = np.asarray(w)
        _close(t.grad.numpy(), w, ATTN_RTOL,
               ATTN_ATOL * max(1.0, float(np.abs(w).max())), f"d{n}")
    with torch.no_grad():     # serving: no autograd, BAOS as before
        assert fb.flash_bidir(*ts[:3], None, *ts[3:]).grad_fn is None


def test_refuse_grad_helper():
    """The guard the four kernel wrappers without a backward call on
    their kernel route: it raises while grad mode is on and an input
    requires grad, and only then."""
    a = torch.zeros(3, requires_grad=True)
    b = torch.zeros(3)
    with pytest.raises(RuntimeError, match="no backward"):
        _build.refuse_grad("topk_mask", b, None, a)
    _build.refuse_grad("topk_mask", b, None)
    with torch.no_grad():
        _build.refuse_grad("topk_mask", a, b)
    # on the CPU the wrappers keep running their differentiable plain
    # versions
    from repro_torch.kernels import baos_mx_quant as bmq
    x = torch.randn(1, 4, 2, 32, requires_grad=True)
    y = bmq.baos_mx_quant(x, torch.zeros(1, 1, 2, 32), torch.ones(1, 1, 2, 32),
                          "bf16")
    assert y.grad_fn is not None


# ---------------------------------------------------------------------------
# the loss and every parameter's gradient
# ---------------------------------------------------------------------------

LOSS_ARCHS = {"llada-8b": 0.0, "qwen2-0.5b": 0.0, "llada-moe-7b-a1b": 0.01,
              "mamba2-130m": 0.0, "recurrentgemma-2b": 0.0}
B, S = 2, 48


def _models(arch, seed=0):
    cfg_j = jbase.get_config(arch, smoke=True)
    cfg_t = tbase.get_config(arch, smoke=True)
    model_j, model_t = jbuild(cfg_j), tbuild(cfg_t, "cpu")
    params_j = model_j.init(jax.random.PRNGKey(seed))
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        cfg_t, "cpu")
    return model_j, model_t, params_j, params_t


def _tokens(cfg, seed=1):
    rng = np.random.RandomState(seed)
    return rng.randint(0, cfg.vocab - 2, size=(B, S)).astype(np.int32)


def _port_loss_grads(model_t, params_t, tokens, draw, **kw):
    leaves = tree_lib.leaves(params_t)
    for p in leaves:
        p.requires_grad_(True)
    noisy, mask, t = draw
    loss, metrics = tdiff.masked_diffusion_loss(
        model_t, params_t, torch.from_numpy(tokens).long(),
        draw=(torch.from_numpy(np.asarray(noisy)).long(),
              torch.from_numpy(np.asarray(mask)),
              torch.from_numpy(np.asarray(t))), **kw)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), metrics, tree_lib.unflatten(params_t, grads)


@pytest.mark.parametrize("arch", sorted(LOSS_ARCHS))
def test_loss_and_grads_match_jax(arch):
    model_j, model_t, params_j, params_t = _models(arch)
    cfg = model_t.cfg
    aux_weight = LOSS_ARCHS[arch]
    tokens = _tokens(cfg)
    rng = jax.random.PRNGKey(7)
    draw = jdiff.forward_mask(rng, jnp.asarray(tokens), cfg.mask_id)
    (loss_j, met_j), grads_j = jax.jit(jax.value_and_grad(
        lambda p: jdiff.masked_diffusion_loss(model_j, p, jnp.asarray(tokens),
                                              rng, aux_weight=aux_weight),
        has_aux=True))(params_j)
    loss_t, met_t, grads_t = _port_loss_grads(model_t, params_t, tokens,
                                              draw, aux_weight=aux_weight)
    _close(float(loss_t), float(loss_j), what="loss")
    for name in ("loss", "ce_masked", "mask_frac", "aux"):
        _close(float(met_t[name]), float(met_j[name]), what=name)
    if aux_weight:
        assert float(met_t["aux"]) > 0
    got = bridge.params_to_numpy(grads_t, cfg)
    want = jax.tree.map(np.asarray, grads_j)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(want)):
        _close(g, w, atol=ATOL * max(1.0, float(np.abs(w).max())),
               what=f"{arch} grad {jax.tree_util.keystr(path)}")
    assert any(np.abs(w).max() > 0 for w in jax.tree.leaves(want))


def test_loss_valid_and_chunks_match_jax():
    """``valid`` weights the CE; ``loss_chunk`` equals the unchunked loss
    (value and gradients), as in JAX."""
    model_j, model_t, params_j, params_t = _models("llada-8b")
    cfg = model_t.cfg
    tokens = _tokens(cfg, 3)
    valid = np.arange(S)[None, :] < np.array([[S], [S // 2]])
    rng = jax.random.PRNGKey(3)
    draw = jdiff.forward_mask(rng, jnp.asarray(tokens), cfg.mask_id)
    loss_j, _ = jdiff.masked_diffusion_loss(
        model_j, params_j, jnp.asarray(tokens), rng, valid=jnp.asarray(valid))
    loss_v, _, g_v = _port_loss_grads(model_t, params_t, tokens, draw,
                                      valid=torch.from_numpy(valid))
    _close(float(loss_v), float(loss_j), what="valid")
    loss_u, _, g_u = _port_loss_grads(model_t, params_t, tokens, draw)
    loss_c, _, g_c = _port_loss_grads(model_t, params_t, tokens, draw,
                                      loss_chunk=16)
    _close(float(loss_c), float(loss_u), what="chunked")
    assert float(loss_v) < float(loss_u)
    for a, b in zip(tree_lib.leaves(g_c), tree_lib.leaves(g_u)):
        _close(a.numpy(), b.numpy())


def test_forward_mask_draw():
    """The port's own draw: t in [eps, 1), noisy = mask id where masked,
    the same bits from the same (seed, step), others from another step."""
    tokens = torch.randint(0, 200, (64, 32),
                           generator=torch.Generator().manual_seed(0))
    a = tdiff.forward_mask(tdiff.step_generator(5, 3, "cpu"), tokens, 256)
    b = tdiff.forward_mask(tdiff.step_generator(5, 3, "cpu"), tokens, 256)
    c = tdiff.forward_mask(tdiff.step_generator(5, 4, "cpu"), tokens, 256)
    noisy, mask, t = a
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(mask, c[1])
    assert float(t.min()) >= 1e-3 and float(t.max()) < 1.0
    assert torch.equal(noisy, torch.where(mask, 256, tokens))
    # the mask rate follows t
    assert abs(float(mask.float().mean()) - float(t.mean())) < 0.05

"""JAX's bf16 attention scores (``score_dtype="bfloat16"``) in the port,
on the CPU: kernels/flash_bidir.py's plain versions (forward and
backward) against JAX's models/layers.attention(score_dtype=bf16) and its
``jax.grad``, then the transformer families with the config field set
against JAX's models on the same weights (bridge), the train step with
remat none and dots, the tensor-parallel body on two gloo ranks against
one rank, the hybrid ignoring the field, and f32 scores unchanged.

The function (JAX's ``attention_partials`` per chunk of ``attn_chunk``
keys): qg = bf16(q D^-1/2), S = bf16(qg . bf16(k)), P = bf16(exp(bf16(S -
bf16(m)))) with m the chunk's max, l = sum P and o = P . bf16(v) in f32,
chunks merged in f32.

Which JAX to hold it to.  Run op by op (eagerly, and with ``unroll=True``
so that the chunk loop is Python's), JAX rounds at every step written
above.  Compiled (``jax.jit``, or ``lax.scan`` over the chunks or the
layers), XLA folds the bf16 rounding of P out of the sum l (its HLO sums
the f32 exp; only P . V sees bf16(P)): JAX's own compiled and eager
results then differ by up to 1.3e-3 of the largest output on these
inputs, and greedy generate commits other tokens at a few near-ties.  So
every test compares with JAX run op by op: ``unroll=True`` and
``unroll_layers=True`` for the forward, ``jax.disable_jit()`` around
generate and the train step's gradient.

Tolerances, each with its reason:

* kernel level, forward: within 1e-5 absolute at f32 activations and one
  bf16 ulp (+1e-6) at bf16 activations: the same roundings in the same
  places.  S is rounded from f32 sums the two packages form in other
  orders; one on a bf16 rounding edge would move its row, and these seeds
  have none.
* kernel level, backward: dv within 1e-5 (+ 1 bf16 ulp at bf16
  activations) of JAX's: dq and dk within 2% of their largest value.
  ``jax.grad`` sends the softmax max's cotangent, -sum_j dS_ij, to the
  row's argmax key through a bf16 sum of terms that cancel to about 0;
  XLA sums them in bf16 and PyTorch in f32, so the argmax key's dS moves
  by a few bf16 ulp of dS and with it that key's dk and every dq of the
  row (up to 1.2% of the largest here; with the max's cotangent stopped in
  both packages the gradients agree within 1e-6).  A row with no valid
  key: dq = dk = 0 there (tests/test_torch_train.py's recorded
  difference), dv held to JAX's.
* models: the hidden states within 1% of their largest value, and at
  most half as far from JAX's as the port with f32 scores is (which shows
  the route is taken): an S rounded on an edge (above) moves a P by up to
  2^-8 of S and carries through the layers.
* train step: the loss within 1e-4 relative; each gradient leaf within
  2% of its largest value (the max's cotangent above, through every
  layer), and closer to JAX's than the port's f32-score gradients are.
* generate: tokens equal (no near-tie at these seeds).
* the tensor-parallel body against one rank: tests/test_torch_tp_steps.py's
  gates (the train loss within 1e-5 relative, the prefill logits within
  1e-5 of the largest, the decode canvas equal), but each gradient within
  2^-9 of its leaf's largest value, where f32 scores hold 1e-5: dP, dS,
  dq and dk are bf16 roundings, so an f32 ulp of difference in what
  enters them (a row-parallel sum in another order) moves one by a bf16
  ulp (up to 5.8e-4 of a leaf's largest value here).
"""
import dataclasses

import _torch_mesh_ranks as ranks
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import baos as jbaos
from repro.core import diffusion as jdiff
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro.models.registry import build_model as jbuild
from repro_torch import bridge
from repro_torch import tree as tree_lib
from repro_torch.configs import base as tbase
from repro_torch.core import baos as tbaos
from repro_torch.core import diffusion as tdiff
from repro_torch.kernels import _build
from repro_torch.kernels import flash_bidir as fb
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttr
from repro_torch.models.registry import build_model as tbuild

torch.set_num_threads(1)

BF16 = "bfloat16"


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp of each value (2^(e - 7) for |x| in [2^e, 2^(e+1)))."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return 2.0 ** (e - 7)


# ---------------------------------------------------------------------------
# kernel level: the plain versions against JAX's layers.attention
# ---------------------------------------------------------------------------

# (B, Sq, Skv, Hq, Hkv, D, window, q_offset, kv_valid lengths or None,
#  causal, kv_chunk, activations)
CASES = {
    "gqa": (2, 8, 32, 4, 2, 16, None, 0, None, False, 1024, "f32"),
    "mha_chunks": (2, 8, 64, 4, 4, 16, None, 0, None, False, 16, "f32"),
    "kv_valid_empty_row": (3, 9, 24, 4, 2, 16, None, 0, (24, 0, 5), False,
                           8, "f32"),
    "window_offset": (2, 8, 40, 4, 2, 16, 5, 7, (40, 13), False, 8, "f32"),
    "causal": (2, 8, 40, 4, 2, 16, None, 3, None, True, 8, "f32"),
    "causal_window": (2, 8, 40, 6, 2, 16, 6, 20, (40, 30), True, 1024,
                      "f32"),
    "chunk_not_dividing": (2, 6, 36, 4, 2, 16, None, 0, None, False, 16,
                           "f32"),
    "d100": (2, 6, 24, 4, 2, 100, None, 0, (24, 11), False, 8, "f32"),
    "d260": (1, 5, 16, 2, 1, 260, 4, 6, None, False, 8, "f32"),
    "bf16": (2, 8, 64, 4, 2, 16, None, 0, (64, 50), False, 16, "bf16"),
    "bf16_d100": (2, 6, 24, 4, 2, 100, 7, 9, None, False, 8, "bf16"),
}


def _inputs(case, seed=0, scale=2.0):
    B, Sq, Skv, Hq, Hkv, D = case[:6]
    rs = np.random.RandomState(seed)
    q, do = (rs.randn(B, Sq, Hq, D).astype(np.float32) * s
             for s in (scale, 1.0))
    k = rs.randn(B, Skv, Hkv, D).astype(np.float32) * scale
    v = rs.randn(B, Skv, Hkv, D).astype(np.float32)
    lens = case[8]
    valid = np.ones((B, Skv), bool) if lens is None else \
        np.arange(Skv)[None, :] < np.asarray(lens)[:, None]
    return q, k, v, do, valid


def _jax_fn(case, valid):
    B, Sq, Skv = case[:3]
    win, off, _, causal, chunk = case[6:11]
    q_pos = np.tile(off + np.arange(Sq), (B, 1))
    kv_pos = np.tile(np.arange(Skv), (B, 1))

    def f(q, k, v):
        return jlayers.attention(
            q, k, v, q_pos=q_pos, kv_pos=kv_pos, kv_valid=valid,
            mode="causal" if causal else "bidir", window=win,
            kv_chunk=chunk, unroll=True, score_dtype=jnp.bfloat16)
    return f


def _dtypes(case):
    return (jnp.bfloat16, torch.bfloat16) if case[11] == "bf16" else \
        (jnp.float32, torch.float32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_forward_matches_jax(name):
    case = CASES[name]
    q, k, v, _, valid = _inputs(case)
    jd, td = _dtypes(case)
    win, off, lens, causal, chunk = case[6:11]
    want = np.asarray(_jax_fn(case, valid)(
        *(jnp.asarray(x).astype(jd) for x in (q, k, v))).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).to(td) for x in (q, k, v))
    tvalid = None if lens is None else torch.from_numpy(valid)
    got = fb.flash_bidir(tq, tk, tv, tvalid, window=win, q_offset=off,
                         causal=causal, score_dtype=BF16, kv_chunk=chunk)
    assert got.dtype == td
    got = got.float().numpy()
    if case[11] == "bf16":
        assert (np.abs(got - want) <= _bf16_ulp(want) + 1e-6).all()
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # and the function is not the f32-score one
    f32 = fb.flash_bidir(tq, tk, tv, tvalid, window=win, q_offset=off,
                         causal=causal).float().numpy()
    assert np.abs(f32 - want).max() > 4 * np.abs(got - want).max()


@pytest.mark.parametrize("baos", [False, True])
def test_plain_route_b_matches_jax_extra_kv(baos):
    """Route B (a second K/V source at q_offset + j, the split cache's
    active block) and the BAOS fusion (f32 activations, so JAX's rounding
    of q * f_k and out * f_v + c_v to the activation dtype is none):
    layers.attention against JAX's attention(extra_kv=...); the second
    source is a chunk of its own in both."""
    B, Sq, Skv, S2, Hq, Hkv, D, off = 2, 8, 48, 8, 4, 2, 16, 16
    rs = np.random.RandomState(3)
    q = rs.randn(B, Sq, Hq, D).astype(np.float32) * 2
    k, v = (rs.randn(B, Skv, Hkv, D).astype(np.float32) * 2
            for _ in range(2))
    k2, v2 = (rs.randn(B, S2, Hkv, D).astype(np.float32) * 2
              for _ in range(2))
    valid = np.arange(Skv)[None] < np.array([[Skv], [30]])
    valid &= ~((np.arange(Skv) >= off) & (np.arange(Skv) < off + S2))[None]
    cal_j = cal_t = None
    if baos:
        raw = [rs.uniform(0.5, 2, (B, 1, Hkv, D)).astype(np.float32),
               rs.randn(B, 1, Hkv, D).astype(np.float32)]
        cal_j = jbaos.BAOSCalib(jnp.zeros_like(raw[1]), jnp.asarray(raw[0]),
                                jnp.asarray(raw[1]), jnp.asarray(raw[0]))
        cal_t = tbaos.BAOSCalib(*(torch.from_numpy(np.asarray(a))
                                  for a in cal_j))
    pos = np.tile(np.arange(Skv), (B, 1))
    want = np.asarray(jlayers.attention(
        q, k, v, q_pos=pos[:, off:off + Sq], kv_pos=pos, kv_valid=valid,
        baos_calib=cal_j, kv_chunk=16, unroll=True,
        score_dtype=jnp.bfloat16,
        extra_kv=(k2, v2, pos[:, off:off + S2], np.ones((B, S2), bool))))
    got = tlayers.attention(
        *(torch.from_numpy(x) for x in (q, k, v, valid)), baos_calib=cal_t,
        q_offset=off, extra_kv=(torch.from_numpy(k2), torch.from_numpy(v2),
                                None), score_dtype=BF16, kv_chunk=16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_jax_grad(name):
    case = CASES[name]
    q, k, v, do, valid = _inputs(case)
    jd, td = _dtypes(case)
    win, off, lens, causal, chunk = case[6:11]
    f = _jax_fn(case, valid)
    want = [np.asarray(g.astype(jnp.float32)) for g in jax.grad(
        lambda *a: jnp.sum(f(*a).astype(jnp.float32) * do), (0, 1, 2))(
            *(jnp.asarray(x).astype(jd) for x in (q, k, v)))]
    tq, tk, tv = (torch.from_numpy(x).to(td).requires_grad_()
                  for x in (q, k, v))
    tvalid = None if lens is None else torch.from_numpy(valid)
    out = fb.flash_bidir(tq, tk, tv, tvalid, window=win, q_offset=off,
                         causal=causal, score_dtype=BF16, kv_chunk=chunk)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(do).to(td))
    got = [t.grad.float().numpy() for t in (tq, tk, tv)]
    plain = [t.float().numpy() for t in fb.flash_bidir_bwd_plain(
        *(torch.from_numpy(x).to(td) for x in (q, k, v, do)), tvalid, win,
        off, causal, BF16, chunk)[:3]]
    live = valid.any(axis=1)
    for n, g, p, w in zip("qkv", got, plain, want):
        assert np.isfinite(g).all()
        np.testing.assert_array_equal(g, p)     # the Function runs plain
        top = float(np.abs(w[live]).max())
        if n == "v":
            tol = 1e-5 + (_bf16_ulp(w[live]) if case[11] == "bf16" else 0)
            assert (np.abs(g[live] - w[live]) <= tol).all(), name
        else:
            assert np.abs(g[live] - w[live]).max() <= 0.02 * top, (n, name)
    if not live.all():
        dead = ~live
        assert not got[0][dead].any() and not got[1][dead].any()
        np.testing.assert_allclose(got[2][dead], want[2][dead], rtol=0,
                                   atol=1e-5)


def _kernel_bwd_emulation(q, k, v, do, mcorr, tile=32):
    """dk of csrc/flash_bidir_bwd.cu's bf16-score route, emulated in f32
    with its roundings: qg = bf16(q D^-1/2); kernel 1's online (m, l,
    delta) over key tiles (P rounded relative to the running max); P
    relative to the final max; dP = bf16(bf16(dp / l) - bf16(delta / l)),
    dS = bf16(P dP); with ``mcorr`` the softmax max's cotangent (the row's
    f32 sum of dS, bf16_mcorr) added at the row's keys at the max; dk =
    bf16(sum_i dS qg), summed over each KV head's group."""
    def br(x):
        return x.to(torch.bfloat16).float()
    B, S, Hq, D = q.shape
    G = Hq // k.shape[2]
    qg = br(q.float() * fb.score_scale(D, q.dtype, True))
    kf, vf = (t.float().repeat_interleave(G, 2) for t in (k, v))
    s = br(torch.einsum("bqhd,bkhd->bhqk", qg, kf))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vf)
    m = torch.full(s.shape[:-1] + (1,), -1e30)
    l, pdp = torch.zeros_like(m), torch.zeros_like(m)
    for t0 in range(0, S, tile):
        st = s[..., t0:t0 + tile]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = br(torch.exp(br(st - br(m_new))))
        l = l * corr + p.sum(-1, keepdim=True)
        pdp = pdp * corr + (p * dp[..., t0:t0 + tile]).sum(-1, keepdim=True)
        m = m_new
    il = 1.0 / l
    p = br(torch.exp(br(s - br(m))))
    ds = br(p * br(br(dp * il) - br(pdp * il * il)))
    if mcorr:
        tie = s == m
        mc = br(br(-ds.sum(-1, keepdim=True)) / tie.sum(-1, keepdim=True))
        ds = torch.where(tie, br(ds + mc), ds)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qg)
    return br(dk.reshape(B, S, -1, G, D).sum(3))


def test_kernel_backward_arithmetic_keeps_the_max_cotangent():
    """Why the backward kernels add the softmax max's cotangent: a shift of
    every key by one vector moves no score of a row relative to another,
    so the sum of dk over the keys is 0 in exact arithmetic (2.8e-7 of
    |dk| in f32 here).  dS's bf16 roundings break it, and jax.grad's
    cotangent through the max takes most of that back, up to the bf16
    rounding of the argmax key's dS: the plain version (autograd) keeps
    2.07e-3 of |dk| on these inputs, the kernels' arithmetic with the
    cotangent 2.08e-3, without it 4.5e-3 (on the card, without it,
    qwen2-0.5b's key biases in layers 5-7 reached cosines of 0.975-0.987
    to f32 where plain kept 0.992-0.996).  Its dk stays within the gate of
    chip_smoke.py phase 15h: beyond one bf16 ulp of the f32 function at
    most 2x the plain version's distance."""
    gen = torch.Generator().manual_seed(0)
    B, S, Hq, Hkv, D = 4, 128, 14, 2, 64
    q, do = (torch.randn(B, S, Hq, D, generator=gen) * sc for sc in (1.5, 1))
    k = torch.randn(B, S, Hkv, D, generator=gen) * 1.5
    v = torch.randn(B, S, Hkv, D, generator=gen)
    q, k, v, do = (t.bfloat16() for t in (q, k, v, do))
    ref = fb.flash_bidir_bwd_plain(*(t.float() for t in (q, k, v, do)))[1]
    plain = fb.flash_bidir_bwd_plain(q, k, v, do, score_dtype=BF16)[1].float()

    def drift(dk):
        return float(dk.sum(1).norm() / dk.norm())
    assert drift(ref) < 1e-6
    without = _kernel_bwd_emulation(q, k, v, do, mcorr=False)
    kernel = _kernel_bwd_emulation(q, k, v, do, mcorr=True)
    assert drift(without) > 1.5 * drift(plain) > 1e-3
    assert drift(kernel) < 1.1 * drift(plain)
    ulp = torch.from_numpy(_bf16_ulp(ref.numpy()))
    e_k = float(((kernel - ref).abs() - ulp).max())
    assert e_k <= 2 * float((plain - ref).abs().max())


def test_counts_names_and_refusals():
    """A bf16-score launch counts as flash_bidir_bf16s (forward) or
    flash_bidir_bwd_bf16s (backward) whatever its route, both entries of
    their libraries; a score dtype outside (float32, bfloat16) raises,
    naming both, in every entry point and in the config check."""
    for split in (False, True):
        for causal in (False, True):
            for dev_off in (False, True):
                assert fb.count_name(split, causal, dev_off, True) == \
                    fb.BF16S_NAME
    assert _build.ROUTES[fb.BF16S_NAME] == fb.NAME
    assert _build.ROUTES[fb.BWD_BF16S_NAME] == fb.BWD_NAME
    assert {fb.BF16S_NAME, fb.BWD_BF16S_NAME} <= set(_build.COUNTED)
    q = torch.zeros(1, 2, 2, 8)
    for call in (lambda: fb.flash_bidir(q, q, q, score_dtype="float16"),
                 lambda: fb.flash_bidir_bwd(q, q, q, q,
                                            score_dtype="float16"),
                 lambda: tlayers.attention(q, q, q, score_dtype="float16"),
                 lambda: ttr.check_supported(dataclasses.replace(
                     tbase.get_config("llada-8b", smoke=True),
                     score_dtype="float16"))):
        with pytest.raises(ValueError, match="'float32', 'bfloat16'"):
            call()


def test_f32_scores_unchanged():
    """score_dtype "float32" is the function it was, bit for bit, at any
    kv_chunk (f32 scores read no chunk), forward and backward."""
    case = CASES["window_offset"]
    q, k, v, do, valid = (torch.from_numpy(x) for x in _inputs(case))
    kw = dict(window=5, q_offset=7)
    a = fb.flash_bidir_plain(q, k, v, valid, **kw)
    b = fb.flash_bidir_plain(q, k, v, valid, **kw, score_dtype="float32",
                             kv_chunk=8)
    assert torch.equal(a, b)
    ga = fb.flash_bidir_bwd_plain(q, k, v, do, valid, 5, 7)
    gb = fb.flash_bidir_bwd_plain(q, k, v, do, valid, 5, 7, False,
                                  "float32", 8)
    assert ga[3:] == gb[3:] == (None,) * 5
    assert all(torch.equal(x, y) for x, y in zip(ga[:3], gb[:3]))


# ---------------------------------------------------------------------------
# the transformer families
# ---------------------------------------------------------------------------

def _pair(arch, **over):
    """(JAX config, port config, JAX params, port params): the smoke config
    with bf16 scores (JAX's run op by op: ``unroll_layers``)."""
    cfg_j = dataclasses.replace(jbase.get_config(arch, smoke=True),
                                score_dtype=BF16, unroll_layers=True, **over)
    cfg_t = dataclasses.replace(tbase.get_config(arch, smoke=True),
                                score_dtype=BF16, **over)
    model_j = jbuild(cfg_j)
    params_j = model_j.init(jax.random.PRNGKey(0))
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        cfg_t, "cpu")
    return model_j, tbuild(cfg_t, "cpu"), params_j, params_t


def _toks(cfg, B, S, seed=1):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab - 2, size=(B, S)).astype(np.int32)


def _held(got, got_f32, want, what):
    """The model gate (module docstring): within 1% of the largest value
    and at most half as far as the f32-score port."""
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    err32 = float(np.abs(got_f32 - want).max())
    assert err <= 0.01 * top and err <= 0.5 * err32, (what, err, err32, top)


def _f32(model_t):
    return tbuild(dataclasses.replace(model_t.cfg, score_dtype="float32"),
                  "cpu")


@pytest.fixture(scope="module")
def llada():
    return _pair("llada-8b")


@pytest.mark.parametrize("S", [40, 128])
def test_forward_without_cache(llada, S):
    """No cache (also the train step's forward): 40 positions (one chunk
    of the smoke config's 64) and 128 (two chunks)."""
    model_j, model_t, params_j, params_t = llada
    toks = _toks(model_t.cfg, 2, S)
    want, _, _ = jtr.forward(params_j, model_j.cfg, jnp.asarray(toks),
                             head_mode="hidden")
    got, _ = ttr.forward(params_t, model_t.cfg, torch.from_numpy(toks),
                         head_mode="hidden")
    g32, _ = ttr.forward(params_t, _f32(model_t).cfg, torch.from_numpy(toks),
                         head_mode="hidden")
    _held(got.numpy(), g32.numpy(), np.asarray(want), f"no cache S {S}")


@pytest.mark.parametrize("kv_format", [None, "mxint8"])
@pytest.mark.parametrize("split", [False, True])
def test_warm_and_refine(llada, kv_format, split):
    """The warm step (the whole canvas, calibrating) and a refine of the
    block at 64 over the warm cache (prefix mode's segment without split;
    the split cache's route B with it), BAOS off and mxint8."""
    model_j, model_t, params_j, params_t = llada
    B, S, L, s0 = 2, 96, 16, 64
    toks = _toks(model_t.cfg, B, S, 2)
    on = kv_format is not None
    dj = jdiff.DiffusionConfig(gen_length=32, block_length=L,
                               steps_per_block=2, cache_mode="dual",
                               baos=jbaos.BAOSConfig(
                                   enabled=on, kv_format=kv_format or
                                   "mxint4"))
    dt = tdiff.DiffusionConfig(gen_length=32, block_length=L,
                               steps_per_block=2, cache_mode="dual",
                               baos=tbaos.BAOSConfig(
                                   enabled=on, kv_format=kv_format or
                                   "mxint4"))
    act = L if split else None
    outs = []
    for model, params in ((model_t, params_t), (_f32(model_t), params_t)):
        ct = model.init_cache(B, S, act_len=act)
        w, _ = tdiff.warm_step(model, params, torch.from_numpy(toks), ct,
                               s0, dt, head_mode="hidden")
        r, _ = tdiff.refine_step(model, params, torch.from_numpy(toks), ct,
                                 s0, dt, head_mode="hidden")
        outs.append((w.numpy(), r.numpy()))
    cj = model_j.init_cache(B, S, act_len=act)
    wj, cj = jdiff.warm_step(model_j, params_j, jnp.asarray(toks), cj,
                             jnp.int32(s0), dj, head_mode="hidden")
    rj, _ = jdiff.refine_step(model_j, params_j, jnp.asarray(toks), cj,
                              jnp.int32(s0), dj, head_mode="hidden")
    _held(outs[0][0], outs[1][0], np.asarray(wj), "warm")
    _held(outs[0][1], outs[1][1], np.asarray(rj), "refine")


@pytest.mark.parametrize("cache_mode", ["none", "dual", "prefix"])
def test_generate_matches_jax(llada, cache_mode):
    """generate (greedy, BAOS mxint4 in the cached modes) against JAX's
    run op by op: tokens equal, no mask id left."""
    model_j, model_t, params_j, params_t = llada
    prompt = _toks(model_t.cfg, 2, 12, 5)
    on = cache_mode != "none"
    kw = dict(gen_length=16, block_length=8, steps_per_block=4)
    dj = jdiff.DiffusionConfig(cache_mode=cache_mode, baos=jbaos.BAOSConfig(
        enabled=on, kv_format="mxint4"), **kw)
    dt = tdiff.DiffusionConfig(cache_mode=cache_mode, baos=tbaos.BAOSConfig(
        enabled=on, kv_format="mxint4"), **kw)
    with jax.disable_jit():
        want = np.asarray(jdiff.generate(model_j, params_j,
                                         jnp.asarray(prompt), dj,
                                         rng=jax.random.PRNGKey(11)))
    got = tdiff.generate(model_t, params_t, torch.from_numpy(prompt), dt,
                         seed=11).numpy()
    np.testing.assert_array_equal(got, want)
    assert not (got == model_t.cfg.mask_id).any()


def test_moe_forward():
    """An MoE config (llada-moe-7b-a1b): the forward without a cache and
    with a warm cache."""
    model_j, model_t, params_j, params_t = _pair("llada-moe-7b-a1b")
    toks = _toks(model_t.cfg, 2, 64, 3)
    want, _, _ = jtr.forward(params_j, model_j.cfg, jnp.asarray(toks),
                             head_mode="hidden")
    got, _ = ttr.forward(params_t, model_t.cfg, torch.from_numpy(toks),
                         head_mode="hidden")
    g32, _ = ttr.forward(params_t, _f32(model_t).cfg, torch.from_numpy(toks),
                         head_mode="hidden")
    _held(got.numpy(), g32.numpy(), np.asarray(want), "moe")


def test_whisper_encoder_and_decoder():
    """whisper-medium: its encoder's config inherits the field (bf16
    self-attention scores there), the decoder's self-attention takes it,
    its cross-attention keeps f32 scores, as in JAX."""
    model_j, model_t, params_j, params_t = _pair("whisper-medium")
    cfg = model_t.cfg
    rs = np.random.RandomState(4)
    audio = rs.randn(2, cfg.n_audio_ctx, cfg.d_model).astype(np.float32)
    enc_j = model_j.encode(params_j, jnp.asarray(audio))
    enc_t = model_t.encode(params_t, torch.from_numpy(audio))
    enc_32 = _f32(model_t).encode(params_t, torch.from_numpy(audio))
    _held(enc_t.numpy(), enc_32.numpy(), np.asarray(enc_j), "encoder")
    toks = _toks(cfg, 2, 24, 6)
    kv_j = model_j.cross_kv(params_j, enc_j)
    kv_t = model_t.cross_kv(params_t, enc_t)
    want, _, _ = model_j.forward(params_j, jnp.asarray(toks), cross_kv=kv_j,
                                 head_mode="hidden")
    got, _ = model_t.forward(params_t, torch.from_numpy(toks),
                             cross_kv=kv_t, head_mode="hidden")
    g32, _ = _f32(model_t).forward(params_t, torch.from_numpy(toks),
                                   cross_kv=kv_t, head_mode="hidden")
    _held(got.numpy(), g32.numpy(), np.asarray(want), "decoder")


def _loss_grads(model_t, params_j, tokens, draw):
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        model_t.cfg, "cpu")
    leaves = tree_lib.leaves(params_t)
    for p in leaves:
        p.requires_grad_(True)
    noisy, mask, t = (torch.from_numpy(np.asarray(a)) for a in draw)
    loss, _ = tdiff.masked_diffusion_loss(
        model_t, params_t, torch.from_numpy(tokens).long(),
        draw=(noisy.long(), mask, t))
    grads = torch.autograd.grad(loss, leaves)
    got = bridge.params_to_numpy(tree_lib.unflatten(params_t, grads),
                                 model_t.cfg)
    return float(loss), jax.tree.leaves(got)


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_train_step_matches_jax(remat):
    """JAX's remat_bf16 variant on the smoke qwen2-0.5b (GQA and a QKV
    bias): the loss and every gradient against jax.value_and_grad of JAX's
    masked_diffusion_loss (op by op) with the same remat, on one draw;
    remat dots equals the port's step without remat bit for bit."""
    model_j, model_t, params_j, _ = _pair("qwen2-0.5b", remat=remat)
    cfg = model_t.cfg
    tokens = _toks(cfg, 2, 48)
    rng = jax.random.PRNGKey(7)
    draw = jdiff.forward_mask(rng, jnp.asarray(tokens), cfg.mask_id)
    with jax.disable_jit():
        loss_j, grads_j = jax.value_and_grad(
            lambda p: jdiff.masked_diffusion_loss(
                model_j, p, jnp.asarray(tokens), rng)[0])(params_j)
    loss_t, got = _loss_grads(model_t, params_j, tokens, draw)
    _, got32 = _loss_grads(_f32(model_t), params_j, tokens, draw)
    assert abs(loss_t - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    closer = 0
    for g, g32, w in zip(got, got32, jax.tree.leaves(grads_j)):
        w = np.asarray(w)
        top = max(float(np.abs(w).max()), 1e-30)
        assert np.abs(g - w).max() <= 0.02 * top
        closer += np.abs(g - w).max() < np.abs(g32 - w).max()
    assert closer >= 0.9 * len(got), (closer, len(got))
    if remat != "none":
        plain = tbuild(dataclasses.replace(cfg, remat="none"), "cpu")
        loss_n, got_n = _loss_grads(plain, params_j, tokens, draw)
        assert loss_n == loss_t
        assert all(np.array_equal(a, b) for a, b in zip(got, got_n))


def test_hybrid_ignores_score_dtype():
    """recurrentgemma-2b's attention layers keep f32 scores, as JAX's
    rglru does: with the field set, its forward (no cache and warm) is
    the default's bit for bit."""
    cfg = tbase.get_config("recurrentgemma-2b", smoke=True)
    m32 = tbuild(cfg, "cpu")
    m16 = tbuild(dataclasses.replace(cfg, score_dtype=BF16), "cpu")
    params = m32.init(seed=0)
    toks = torch.from_numpy(_toks(cfg, 2, 40))
    a, _ = m32.forward(params, toks)
    b, _ = m16.forward(params, toks)
    assert torch.equal(a, b)
    warm = dict(seg_start=0, calibrate=True,
                kv_valid=torch.ones(2, 40, dtype=torch.bool))
    a, _ = m32.forward(params, toks, cache=m32.init_cache(2, 40), **warm)
    b, _ = m16.forward(params, toks, cache=m16.init_cache(2, 40), **warm)
    assert torch.equal(a, b)


TP_CASES = ("llada-8b bf16s", "qwen2-0.5b bf16s")


@pytest.fixture(scope="module")
def tp_mesh_run(tmp_path_factory):
    return ranks.spawn("tp", 2, tmp_path_factory.mktemp("tp_bf16s"),
                       timeout=300.0, data=1, model=2, cases=TP_CASES,
                       quant=False)


@pytest.mark.parametrize("case", TP_CASES)
def test_tp_body_matches_one_rank(tp_mesh_run, case):
    """The tensor-parallel body with bf16 scores at (data 1, model 2)
    against one rank (the gates of the module docstring): the train loss
    and gradients, the prefill logits, the decode canvas with the unified
    and the split cache."""
    want, got = ranks.tp_run(case), tp_mesh_run[case]
    (l0, _, g0), (l1, _, g1) = want["train"], got["train"]
    assert abs(l1 - l0) <= 1e-5 * abs(l0), (l1, l0)
    assert len(g1) == len(g0)
    for g, w in zip(g1, g0):
        np.testing.assert_allclose(g, w, rtol=0, atol=2.0 ** -9 * max(
            float(np.abs(w).max()), 1e-30))
    for split in (False, True):
        (lw, xw, _), (lg, xg, _) = want["serve", split], got["serve", split]
        np.testing.assert_allclose(lg, lw, rtol=0,
                                   atol=1e-5 * float(np.abs(lw).max()))
        np.testing.assert_array_equal(xg, xw)
        assert got["decode equal", split]

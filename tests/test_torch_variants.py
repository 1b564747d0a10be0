"""What the JAX package runs and the port once refused, held against JAX on
the CPU (the kernels' plain versions run here; the card's routes are
pure functions of the shapes):

* the recurrent families with ``norm="ln"`` (mamba2-130m, recurrentgemma-2b
  smoke, f32, every norm weight and bias moved off its init by a numpy
  draw): ``forward`` without a cache, a warm step and a refine, greedy
  ``generate``; the hybrid with ``ffn="swiglu"`` and ``attn_mode="causal"``,
  which JAX ignores, equal to JAX's and to the port's default config bit
  for bit; the recurrent tensor-parallel bodies with ln on two spawned
  gloo ranks against one rank;
* attention at head dims 4, 12, 36, 260 and 512 (not a multiple of 8, or
  past 256): ``flash_bidir_plain`` against JAX's models/layers.attention
  (kv_valid, window, causal) and JAX's Pallas flash_bidir in interpret
  mode (BAOS, window); ``flash_bidir_bwd_plain`` against ``jax.grad`` of
  layers.attention;
* the fused head at d 100: its plain version and route A's against JAX's
  Pallas kernel (interpret) and jnp partials, with and without a
  ``QuantPolicy`` (MX blocks along d with a zero tail), and
  ``padded_hidden``;
* ``baos_mx_quant``'s plain version at D 100 against JAX's
  core/baos.smooth_quantize;
* the train step with ``remat`` full and dots against JAX's loss and
  gradients with the same ``remat`` and against the port's step without
  it, and under the tensor-parallel body on two gloo ranks, each backward
  on a thread of its own, against one rank; an unknown ``remat`` and
  ``score_dtype="bfloat16"`` raise.

Tolerances (f32): logits, states and attention outputs rtol 1e-4, atol
1e-4 (the recurrent files' bound: the two packages sum in other orders;
attention rtol 1e-5 atol 2e-6 as tests/test_torch_kernel_limits.py);
attention gradients rtol 1e-4 atol 1e-5 and the loss's rtol 1e-4 atol
1e-6 x the leaf's largest |gradient| (tests/test_torch_train.py's);
greedy tokens equal (no near-tie shows on these seeds); the fused head's
conf rtol 1e-5 and tokens equal; baos_mx_quant bit for bit; remat against
no remat bit for bit (the same ops recomputed in the same order).
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
from repro.core import sampling as js
from repro.kernels import flash_bidir as jfb
from repro.kernels import ops
from repro.models import layers as jlayers
from repro.models.registry import build_model as jbuild
from repro_torch import bridge
from repro_torch import tree as tree_lib
from repro_torch.configs import base as tbase
from repro_torch.core import baos as tbaos
from repro_torch.core import diffusion as tdiff
from repro_torch.kernels import baos_mx_quant as tbq
from repro_torch.kernels import flash_bidir as tfb
from repro_torch.kernels import fused_head_sampling as tfh
from repro_torch.models import layers as tlayers
from repro_torch.models.registry import build_model as tbuild

torch.set_num_threads(1)

RTOL = ATOL = 1e-4


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# the recurrent families' variants
# ---------------------------------------------------------------------------

RECURRENT = ("mamba2-130m", "recurrentgemma-2b")
HYBRID_IGNORED = dict(ffn="swiglu", attn_mode="causal")


def _moved_norms(tree, seed=3):
    """JAX's params with every norm's w and b moved off 1 and 0 by a numpy
    draw (an ln bias then shows wherever it is dropped or doubled)."""
    rs = np.random.RandomState(seed)

    def move(path, a):
        keys = [getattr(p, "key", "") for p in path]
        if keys and keys[-1] in ("w", "b"):
            a = a + rs.randn(*a.shape).astype(np.float32) * 0.2
        return a
    return jax.tree_util.tree_map_with_path(move, tree)


@pytest.fixture(scope="module", params=RECURRENT)
def ln_models(request):
    arch = request.param
    cfg_j = dataclasses.replace(jbase.get_config(arch, smoke=True),
                                norm="ln")
    cfg_t = dataclasses.replace(tbase.get_config(arch, smoke=True),
                                norm="ln")
    model_j, model_t = jbuild(cfg_j), tbuild(cfg_t, "cpu")
    params_j = _moved_norms(jax.tree.map(
        np.asarray, model_j.init(jax.random.PRNGKey(0))))
    params_t = bridge.params_from_numpy(params_j, cfg_t, "cpu")
    params_j = jax.tree.map(jnp.asarray, params_j)
    return model_j, model_t, params_j, params_t


def _tokens(cfg, B, S, seed):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab - 2, size=(B, S)).astype(np.int32)


def test_ln_layout_matches_jax(ln_models):
    """ln's bias reaches every norm of the layout: the bridged tree, the
    port's own init and its logical specs carry ``{"w", "b"}`` where JAX's
    does, the gated norm of mamba stays an RMSNorm weight."""
    model_j, model_t, params_j, params_t = ln_models
    fn = params_t["final_norm"]
    assert sorted(fn) == ["b", "w"] and bool(fn["b"].any())
    own, specs = model_t.init(seed=1), model_t.param_specs()
    sub = (own["layers"][0] if "layers" in own else own["tail"][0])
    spec = (specs["layers"][0] if "layers" in specs else specs["tail"][0])
    for name in ("norm", "ln1", "ln2"):
        if name in sub:
            assert sorted(sub[name]) == ["b", "w"]
            assert spec[name] == {"w": ("embed",), "b": ("embed",)}
    if "gate_norm" in sub:
        assert isinstance(sub["gate_norm"], torch.Tensor)
    back = bridge.params_to_numpy(params_t, model_t.cfg)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, params_j))


def test_ln_forward_without_cache_matches_jax(ln_models):
    model_j, model_t, params_j, params_t = ln_models
    toks = _tokens(model_t.cfg, 2, 48, seed=1)
    want, _, _ = model_j.forward(params_j, tokens=jnp.asarray(toks))
    got, _ = model_t.forward(params_t, torch.from_numpy(toks))
    _close(got, want)


def test_ln_warm_then_refine_matches_jax(ln_models):
    """A warm step (block at 16, length 16) and a refine from its cache,
    BAOS off: the logits and every cache leaf as JAX's."""
    model_j, model_t, params_j, params_t = ln_models
    B, S, bs, L = 2, 48, 16, 16
    toks = _tokens(model_t.cfg, B, S, seed=2)
    bj = jbaos.BAOSConfig(enabled=False)
    bt = tbaos.BAOSConfig(enabled=False)
    lj, cj, _ = model_j.forward(params_j, tokens=jnp.asarray(toks),
                                cache=model_j.init_cache(B, S),
                                calibrate=True, baos_cfg=bj,
                                logits_slice=(jnp.int32(bs), L))
    ct = model_t.init_cache(B, S)
    lt, _ = model_t.forward(params_t, torch.from_numpy(toks), cache=ct,
                            calibrate=True, baos_cfg=bt,
                            logits_slice=(bs, L))
    _close(lt, lj)
    for name in cj:
        if name not in ("k_center", "k_scale", "v_center", "v_scale"):
            _close(ct[name], cj[name], what=name)
    seg = toks[:, bs:bs + L]
    rj, _, _ = model_j.forward(params_j, tokens=jnp.asarray(seg), cache=cj,
                               seg_start=jnp.int32(bs), baos_cfg=bj,
                               logits_slice=(0, L))
    rt, _ = model_t.forward(params_t, torch.from_numpy(seg), cache=ct,
                            seg_start=bs, baos_cfg=bt, logits_slice=(0, L))
    _close(rt, rj)


@pytest.mark.parametrize("cache_mode", ["none", "dual"])
def test_ln_generate_matches_jax(ln_models, cache_mode):
    """Greedy tokens of generate(): B 2, prompt 32, gen 32, block 16, 4
    steps; dual with BAOS mxint8."""
    model_j, model_t, params_j, params_t = ln_models
    on = cache_mode != "none"
    kw = dict(gen_length=32, block_length=16, steps_per_block=4,
              cache_mode=cache_mode)
    dj = jdiff.DiffusionConfig(
        baos=jbaos.BAOSConfig(enabled=on, kv_format="mxint8"), **kw)
    dt = tdiff.DiffusionConfig(
        baos=tbaos.BAOSConfig(enabled=on, kv_format="mxint8"), **kw)
    toks = _tokens(model_t.cfg, 2, 32, seed=5)
    want = jdiff.generate(model_j, params_j, jnp.asarray(toks), dj,
                          rng=jax.random.PRNGKey(11))
    got = tdiff.generate(model_t, params_t, torch.from_numpy(toks), dt,
                         seed=11)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("norm", ["rms", "ln"])
def test_hybrid_ignores_ffn_and_attn_mode(norm):
    """JAX's hybrid runs GeGLU and bidirectional attention whatever
    ``ffn`` and ``attn_mode`` say; so does the port's: with swiglu and
    causal its logits equal JAX's (rtol 1e-4) and its own default
    config's bit for bit, without a cache and on a warm step."""
    arch = "recurrentgemma-2b"
    base_j = dataclasses.replace(jbase.get_config(arch, smoke=True),
                                 norm=norm)
    base_t = dataclasses.replace(tbase.get_config(arch, smoke=True),
                                 norm=norm)
    model_j = jbuild(dataclasses.replace(base_j, **HYBRID_IGNORED))
    model_t = tbuild(dataclasses.replace(base_t, **HYBRID_IGNORED), "cpu")
    model_d = tbuild(base_t, "cpu")
    params_j = jax.tree.map(np.asarray, model_j.init(jax.random.PRNGKey(4)))
    params_t = bridge.params_from_numpy(params_j, model_t.cfg, "cpu")
    params_j = jax.tree.map(jnp.asarray, params_j)
    toks = _tokens(base_t, 2, 40, seed=6)
    want, _, _ = model_j.forward(params_j, tokens=jnp.asarray(toks))
    got, _ = model_t.forward(params_t, torch.from_numpy(toks))
    _close(got, want)
    assert torch.equal(got, model_d.forward(params_t,
                                            torch.from_numpy(toks))[0])
    warm = dict(calibrate=True, logits_slice=(8, 8),
                baos_cfg=tbaos.BAOSConfig(enabled=True, kv_format="mxint4"))
    a, _ = model_t.forward(params_t, torch.from_numpy(toks),
                           cache=model_t.init_cache(2, 40), **warm)
    b, _ = model_d.forward(params_t, torch.from_numpy(toks),
                           cache=model_d.init_cache(2, 40), **warm)
    assert torch.equal(a, b)


LN_TP_CASES = ("mamba2-130m ln", "recurrentgemma-2b ln")


@pytest.fixture(scope="module")
def ln_mesh_run(tmp_path_factory):
    return ranks.spawn("tp", 2, tmp_path_factory.mktemp("tp_ln"),
                       timeout=300.0, data=1, model=2, cases=LN_TP_CASES,
                       quant=False)


@pytest.mark.parametrize("case", LN_TP_CASES)
def test_recurrent_ln_tp_matches_one_rank(ln_mesh_run, case):
    """The recurrent tensor-parallel bodies with ln at (data 1, model 2)
    against one rank (tests/test_torch_tp_steps.py's gates): the train
    loss within 1e-5 relative and each gradient leaf within 1e-5 of its
    largest value (mamba's leaves by name, its layers' stacked); the
    prefill logits within 1e-5 of the largest; the decode canvas equal.
    The residual-stream norms act on whole rows on every rank, so ln
    needs no sum over ``model``: the gates hold with none."""
    want, got = ranks.tp_run(case), ln_mesh_run[case]
    (l0, _, g0), (l1, _, g1) = want["train"], got["train"]
    assert abs(l1 - l0) <= 1e-5 * abs(l0), (l1, l0)
    assert len(g1) == len(g0)
    for g, w in zip(g1, g0):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * max(
            float(np.abs(w).max()), 1e-30))
    for split in (False, True):
        (lw, xw, _), (lg, xg, _) = want["serve", split], got["serve", split]
        np.testing.assert_allclose(lg, lw, rtol=0,
                                   atol=1e-5 * float(np.abs(lw).max()))
        np.testing.assert_array_equal(xg, xw)
        assert got["decode equal", split]


# ---------------------------------------------------------------------------
# attention at any head dim
# ---------------------------------------------------------------------------

# (D, Hq, Hkv, window, causal, kv_valid lengths): a query row without a
# valid key in reach lies only in a batch row with none (the backward's
# deliberate difference is then the whole batch row's)
ANY_DIMS = [(4, 4, 2, None, False, (24, 8)), (12, 6, 3, 7, False, (24, 0)),
            (36, 4, 1, None, True, (24, 17)),
            (260, 4, 2, 5, False, None),
            (512, 2, 1, None, True, None)]


def _attn_inputs(D, Hq, Hkv, lens, B=2, S=24, seed=0):
    rs = np.random.RandomState(seed + D)
    q = rs.randn(B, S, Hq, D).astype(np.float32)
    k = rs.randn(B, S, Hkv, D).astype(np.float32)
    v = rs.randn(B, S, Hkv, D).astype(np.float32)
    do = rs.randn(B, S, Hq, D).astype(np.float32)
    valid = np.ones((B, S), bool) if lens is None else \
        np.arange(S)[None, :] < np.asarray(lens)[:, None]
    return q, k, v, do, valid


def _jax_attention(window, causal, valid, B=2, S=24):
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))

    def f(q, k, v):
        return jlayers.attention(q, k, v, q_pos=pos, kv_pos=pos,
                                 kv_valid=jnp.asarray(valid),
                                 mode="causal" if causal else "bidir",
                                 window=window, kv_chunk=8)
    return f


@pytest.mark.parametrize("D,Hq,Hkv,window,causal,lens", ANY_DIMS)
def test_any_head_dim_matches_jax_attention(D, Hq, Hkv, window, causal,
                                            lens):
    q, k, v, _, valid = _attn_inputs(D, Hq, Hkv, lens)
    want = _jax_attention(window, causal, valid)(q, k, v)
    got = tfb.flash_bidir_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if lens is None else torch.from_numpy(valid), window=window,
        causal=causal)
    _close(got, want, 1e-5, 2e-6)


@pytest.mark.parametrize("D,window", [(4, None), (12, 5), (36, None),
                                      (260, 9), (512, None)])
def test_any_head_dim_baos_matches_pallas(D, window):
    """BAOS fusion (q * f_k, out * f_v + c_v) at any D against JAX's
    Pallas flash_bidir in interpret mode (Skv a multiple of its block)."""
    B, S, Hq, Hkv = 2, 32, 4, 2
    rs = np.random.RandomState(D)
    q, k, v = (rs.randn(B, S, h, D).astype(np.float32)
               for h in (Hq, Hkv, Hkv))
    fk, fv = (rs.rand(B, Hkv, D).astype(np.float32) + 0.5 for _ in range(2))
    cv = rs.randn(B, Hkv, D).astype(np.float32)
    want = jfb.flash_bidir(*(jnp.asarray(a) for a in (q, k, v, fk, fv, cv)),
                           bq=16, bk=16, window=window, interpret=True)
    got = tfb.flash_bidir_plain(*(torch.from_numpy(a) for a in
                                  (q, k, v)), None,
                                *(torch.from_numpy(a) for a in (fk, fv, cv)),
                                window=window)
    _close(got, want, 1e-5, 1e-5)


@pytest.mark.parametrize("D,Hq,Hkv,window,causal,lens", ANY_DIMS)
def test_any_head_dim_grad_matches_jax(D, Hq, Hkv, window, causal, lens):
    """flash_bidir's backward (its plain version on the CPU) against
    jax.grad of layers.attention; a row with no valid key has dq = dk = 0
    (tests/test_torch_train.py's deliberate difference), its dv JAX's."""
    q, k, v, do, valid = _attn_inputs(D, Hq, Hkv, lens)
    f = _jax_attention(window, causal, valid)
    want = [np.asarray(g) for g in jax.jit(jax.grad(
        lambda *a: jnp.sum(f(*a) * do), (0, 1, 2)))(q, k, v)]
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tvalid = None if lens is None else torch.from_numpy(valid)
    tfb.flash_bidir(tq, tk, tv, tvalid, window=window,
                    causal=causal).backward(torch.from_numpy(do))
    plain = tfb.flash_bidir_bwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v, do)), tvalid, window, 0,
        causal)
    live = valid.any(axis=1)
    for n, t, p, w in zip("qkv", (tq, tk, tv), plain, want):
        g = t.grad.numpy()
        np.testing.assert_array_equal(g, p.numpy())
        _close(g[live], w[live], 1e-4, 1e-5, f"d{n} D {D}")
    dead = ~live
    if dead.any():
        assert not tq.grad.numpy()[dead].any()
        _close(tv.grad.numpy()[dead], want[2][dead], 1e-4, 1e-5, "dv dead")


@pytest.mark.parametrize("D,want", [(4, ("CUDA cores", 32)),
                                    (12, ("CUDA cores", 32)),
                                    (36, ("CUDA cores", 64)),
                                    (100, ("CUDA cores", 128)),
                                    (260, (tfb.WIDE_ROUTE, 256)),
                                    (512, (tfb.WIDE_ROUTE, 256))])
def test_any_head_dim_route_and_plan(D, want):
    """The card's routes at these D (bf16 and f32 alike), and the
    backward's plan: the CUDA-core route's grids, or the wide route's
    statistics, dq and dk/dv CTAs over ceil(D / 256) column slices, each
    CTA's shared memory within sm_90's limit; D < 1 raises."""
    B, S, Hq, Hkv = 4, 96, 8, 2
    for dt in (torch.bfloat16, torch.float32):
        assert tfb.route(D, dt) == want
        plan = tfb.bwd_plan(B, S, S, Hq, Hkv, D, dt)
        assert plan.route == want[0] and plan.n_split == 1
        assert plan.stats_floats == 3 * B * Hq * S
        assert max(plan.dq_smem, plan.dkv_smem) <= tfb.SMEM_LIMIT_BYTES
        if want[0] == tfb.WIDE_ROUTE:
            n = tfb.n_slices(D)
            assert n == -(-D // 256)
            assert plan.dq_ctas == 6 * Hq * B * (1 + n)
            assert plan.dkv_ctas == 3 * Hkv * B * n
    assert tfb.route(64, torch.bfloat16) == ("tensor cores", 64)
    with pytest.raises(ValueError):
        tfb.route(0, torch.float32)


# ---------------------------------------------------------------------------
# the fused head and baos_mx_quant at unaligned widths
# ---------------------------------------------------------------------------

def _head(d=100, V=300, R=10, seed=0):
    rs = np.random.RandomState(seed)
    h = rs.randn(R, d).astype(np.float32)
    w = (rs.randn(d, V) * 4 / np.sqrt(d)).astype(np.float32)
    return h, w


@pytest.mark.parametrize("fmt", ["none", "mxfp8_e4m3"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_fused_head_d100_matches_pallas(fmt, temperature):
    """d 100 (the bf16 route reads the hidden rows through padded_hidden
    on the card): the plain version against JAX's Pallas kernel in
    interpret mode, tokens equal, conf rtol 1e-5."""
    h, w = _head()
    seed = int(js.gumbel_seed(jax.random.PRNGKey(3)))
    conf, tok = tfh.fused_head_sampling(
        torch.from_numpy(h), torch.from_numpy(w), fmt=fmt, suppress_id=299,
        temperature=temperature, seed=seed)
    kc, kt = ops.fused_head_sampling(
        jnp.asarray(h), jnp.asarray(w), fmt=fmt, suppress_id=299,
        temperature=temperature, seed=jnp.uint32(seed), chunk_v=128,
        interpret=True)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(kt))
    _close(conf, kc, 1e-5, 0)


def test_fused_head_d100_quant_blocks_along_d():
    """A QuantPolicy on the fused head at d 100: the hidden rows' and the
    head's MX blocks along d end in a partial block (core/mx's zero tail),
    whether the head is fake-quantized as it is or through head_storage's
    padded rows (its pad columns are along V, not d); against JAX's
    Pallas kernel with the same policy."""
    from repro.models.layers import QuantPolicy as JQuant
    h, w = _head(V=257, seed=1)
    jq, tq = JQuant(enabled=True), tlayers.QuantPolicy(enabled=True)
    kc, kt = ops.fused_head_sampling(jnp.asarray(h), jnp.asarray(w),
                                     fmt="mxfp8_e4m3", quant=jq,
                                     chunk_v=128, interpret=True)
    wp = tfh.pad_head(torch.from_numpy(w))
    assert wp.stride(0) == 264
    wq = tq.weights(tfh.head_storage(wp))[:, :257]
    conf, tok = tfh.fused_head_sampling(tq.acts(torch.from_numpy(h)), wq,
                                        fmt="mxfp8_e4m3")
    np.testing.assert_array_equal(tok.numpy(), np.asarray(kt))
    _close(conf, kc, 1e-5, 0)
    assert torch.equal(wq, tq.weights(torch.from_numpy(w)))


def test_route_a_d100_matches_jax_partials():
    """Route A's plain version at d 100 on shard 1 of 2 against JAX's
    fused_head_local_partials (m, global index, s)."""
    h, w = _head(V=320, seed=2)
    ws = w[:, 160:]
    got = tfh.head_shard_partials(torch.from_numpy(h),
                                  torch.from_numpy(np.ascontiguousarray(ws)),
                                  fmt="mxfp8_e4m3", col_offset=160,
                                  chunk_v=64)
    want = js.fused_head_local_partials(jnp.asarray(h), jnp.asarray(ws),
                                        "mxfp8_e4m3", col_offset=160,
                                        chunk_v=64)
    _close(got[0], want[0], 1e-5, 1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    _close(got[2], want[2], 1e-5, 1e-6)


def test_padded_hidden():
    h = torch.randn(3, 100)
    p = tfh.padded_hidden(h)
    assert p.shape == (3, 104) and torch.equal(p[:, :100], h)
    assert not p[:, 100:].any()
    a = torch.randn(3, 64)
    assert tfh.padded_hidden(a) is a


@pytest.mark.parametrize("fmt", ["mxint4", "mxint8", "mxfp8_e4m3",
                                 "mxfp4_e2m1"])
@pytest.mark.parametrize("D", [100, 12])
def test_baos_mx_quant_ragged_d_matches_jax(fmt, D):
    """D not a multiple of 32: the last MX block of each head is partial,
    its amax over its real columns (core/mx pads it with zeros); the plain
    version equals JAX's smooth_quantize bit for bit, and only D columns
    come out."""
    rs = np.random.RandomState(D)
    x = (rs.randn(2, 9, 3, D) * 3 + rs.randn(1, 1, 3, D)).astype(np.float32)
    kj, vj = jnp.asarray(x), jnp.asarray(x)
    cal = jbaos.calibrate(kj, vj, jbaos.BAOSConfig(kv_format=fmt))
    want = jbaos.smooth_quantize(kj, cal.k_center, cal.k_scale,
                                 jbaos.BAOSConfig(kv_format=fmt))
    got = tbq.baos_mx_quant(torch.from_numpy(x),
                            torch.from_numpy(np.asarray(cal.k_center)),
                            torch.from_numpy(np.asarray(cal.k_scale)), fmt)
    assert got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# remat and score_dtype
# ---------------------------------------------------------------------------

def _loss_models(arch, remat):
    cfg_j = dataclasses.replace(jbase.get_config(arch, smoke=True),
                                remat=remat)
    cfg_t = dataclasses.replace(tbase.get_config(arch, smoke=True),
                                remat=remat)
    model_j, model_t = jbuild(cfg_j), tbuild(cfg_t, "cpu")
    params_j = model_j.init(jax.random.PRNGKey(0))
    return model_j, model_t, params_j


def _port_loss_grads(model_t, params_j, tokens, draw):
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
    return loss.detach(), grads, params_t


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["llada-8b", "qwen2-0.5b"])
def test_remat_train_step_matches_jax(arch, remat):
    """The loss and every gradient with ``remat`` (each layer under
    torch.utils.checkpoint) against jax.value_and_grad of JAX's
    masked_diffusion_loss with the same remat (jax.checkpoint), and bit
    for bit against the port's own step without remat."""
    model_j, model_t, params_j = _loss_models(arch, remat)
    cfg = model_t.cfg
    tokens = np.random.RandomState(1).randint(
        0, cfg.vocab - 2, size=(2, 48)).astype(np.int32)
    rng = jax.random.PRNGKey(7)
    draw = jdiff.forward_mask(rng, jnp.asarray(tokens), cfg.mask_id)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jdiff.masked_diffusion_loss(
            model_j, p, jnp.asarray(tokens), rng)[0]))(params_j)
    loss_t, grads_t, params_t = _port_loss_grads(model_t, params_j, tokens,
                                                 draw)
    _close(float(loss_t), float(loss_j), 1e-4, 1e-6, "loss")
    got = bridge.params_to_numpy(tree_lib.unflatten(params_t, grads_t), cfg)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(grads_j)):
        w = np.asarray(w)
        _close(g, w, 1e-4, 1e-6 * max(1.0, float(np.abs(w).max())))
    plain = tbuild(dataclasses.replace(cfg, remat="none"), "cpu")
    loss_n, grads_n, _ = _port_loss_grads(plain, params_j, tokens, draw)
    assert torch.equal(loss_t, loss_n)
    assert all(torch.equal(a, b) for a, b in zip(grads_t, grads_n))


def test_remat_dots_saves_products_recomputes_the_rest():
    """remat "dots" saves a matrix product's output and recomputes every
    other op; the backward reruns each layer, attention's plain version
    included (its products taken from the forward, as JAX's
    checkpoint_dots takes its einsums)."""
    from torch.utils.checkpoint import CheckpointPolicy
    from repro_torch.models import transformer
    for op in transformer.DOTS:
        assert transformer._dots_policy(None, op) == \
            CheckpointPolicy.MUST_SAVE
    assert transformer._dots_policy(None, torch.ops.aten.add.Tensor) == \
        CheckpointPolicy.PREFER_RECOMPUTE
    calls = []
    real = tfb.flash_bidir_plain

    def counted(*a, **kw):
        calls.append(torch.is_grad_enabled())
        return real(*a, **kw)
    cfg = dataclasses.replace(tbase.get_config("llada-8b", smoke=True),
                              remat="dots")
    model = tbuild(cfg, "cpu")
    params = model.init(seed=0)
    for p in tree_lib.leaves(params):
        p.requires_grad_(True)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, 200, size=(2, 16)))
    tfb.flash_bidir_plain = counted
    try:
        logits, _ = model.forward(params, toks)
        assert len(calls) == cfg.n_layers
        logits.float().sum().backward()
    finally:
        tfb.flash_bidir_plain = real
    assert len(calls) == 2 * cfg.n_layers


@pytest.fixture(scope="module")
def remat_mesh_run(tmp_path_factory):
    return ranks.spawn("tp_remat", 2, tmp_path_factory.mktemp("tp_remat"),
                       timeout=300.0, cases=ranks.TP_REMAT_CASES)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("case", ranks.TP_REMAT_CASES)
def test_remat_tp_matches_one_rank(remat_mesh_run, case, remat):
    """The train step with ``remat`` under the tensor-parallel body on two
    gloo ranks (model 2), each backward on a thread of its own as a CUDA
    backward runs on autograd's device thread, so the recompute sees the
    forward's tensor-parallel context only because the layer re-enters
    it.  Against one rank without remat: the loss within 1e-5 relative
    and each gradient within 1e-5 of its largest value
    (tests/test_torch_tp_steps.py's gates); against the same mesh without
    remat bit for bit (the same ops and collectives in the same order)."""
    l0, g0 = ranks.tp_remat_grads(case, "none")
    l1, g1 = remat_mesh_run[case, remat]
    assert abs(l1 - l0) <= 1e-5 * abs(l0), (l1, l0)
    assert len(g1) == len(g0)
    for g, w in zip(g1, g0):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * max(
            float(np.abs(w).max()), 1e-30))
    ln, gn = remat_mesh_run[case, "none"]
    assert l1 == ln
    assert all(np.array_equal(a, b) for a, b in zip(g1, gn))


def test_remat_and_score_dtype_checked():
    cfg = tbase.get_config("llada-8b", smoke=True)
    with pytest.raises(ValueError, match="remat"):
        tbuild(dataclasses.replace(cfg, remat="some"), "cpu")
    # bf16 scores run (tests/test_torch_score_dtype.py); a name outside
    # float32 and bfloat16 raises, naming both
    with pytest.raises(ValueError, match="'float32', 'bfloat16'"):
        tbuild(dataclasses.replace(cfg, score_dtype="float16"), "cpu")
    # the hybrid family ignores score_dtype, as JAX's does
    rg = dataclasses.replace(tbase.get_config("recurrentgemma-2b",
                                              smoke=True),
                             score_dtype="bfloat16")
    assert tbuild(rg, "cpu").cfg.score_dtype == "bfloat16"

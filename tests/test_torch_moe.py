"""The MoE family of the PyTorch port vs the JAX package on the SMOKE
configs (f32) of llada-moe-7b-a1b, qwen2-moe-a2.7b (shared experts, QKV
bias) and moonshot-v1-16b-a3b (one shared expert), same weights (JAX init
-> numpy -> bridge): the configs, the bridge, ``route``, ``moe_ffn`` (one
group and per-row groups, capacity drops, QuantPolicy), ``forward``,
greedy ``generate`` in cache modes none, dual and prefix, the serving
engine (modes none, warm and warm + BAOS at K 1 and 4, slot and paged
pools) and the serving command on an MoE arch.

Tolerance rtol 1e-5, atol 1e-5.  ``torch.topk`` and ``lax.top_k`` may
route otherwise where two router probabilities tie; routing is held off
the positions where the reference's k-th and (k+1)-th probabilities lie
within 1e-6 (these seeds have none, so the checks are exact)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import baos as jbaos
from repro.core import diffusion as jdiff
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.models.registry import build_model as jbuild
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.core import baos as tbaos
from repro_torch.core import diffusion as tdiff
from repro_torch.kernels import fused_head_sampling as fhs
from repro_torch.launch import serve
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from repro_torch.models.registry import build_model as tbuild
from repro_torch.serving import EngineConfig, Request, ServingEngine

torch.set_num_threads(1)

RTOL = ATOL = 1e-5
TIE = 1e-6
MOE = ["llada-moe-7b-a1b", "qwen2-moe-a2.7b", "moonshot-v1-16b-a3b"]


@pytest.fixture(scope="module", params=MOE)
def models(request):
    cfg_j = jbase.get_config(request.param, smoke=True)
    cfg_t = tbase.get_config(request.param, smoke=True)
    model_j, model_t = jbuild(cfg_j), tbuild(cfg_t, "cpu")
    params_j = model_j.init(jax.random.PRNGKey(0))
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        cfg_t, "cpu")
    return model_j, model_t, params_j, params_t


def _layer0(params_j, params_t):
    """Layer 0's moe subtree in each package."""
    return (jax.tree.map(lambda a: a[0], params_j["layers"]["moe"]),
            params_t["layers"][0]["moe"])


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _tokens(cfg, B, S, seed):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab - 2, size=(B, S)).astype(np.int32)


def _near_ties(x_flat, router, cfg):
    """Positions (T,) whose reference k-th and (k+1)-th router
    probabilities lie within TIE."""
    logits = np.asarray(jnp.einsum("td,de->te", jnp.asarray(x_flat),
                                   jnp.asarray(router, jnp.float32)))
    p = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    p = -np.sort(-p, axis=-1)
    K = cfg.top_k
    if K >= cfg.num_experts:
        return np.zeros(p.shape[0], bool)
    return p[:, K - 1] - p[:, K] < TIE


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", MOE)
def test_config_fields_match_jax(arch, smoke):
    """Every field, the MoEConfig field for field, both parameter counts;
    build_model builds the full config."""
    cfg_t = tbase.get_config(arch, smoke=smoke)
    cfg_j = jbase.get_config(arch, smoke=smoke)
    for f in dataclasses.fields(cfg_j):
        a, b = getattr(cfg_t, f.name), getattr(cfg_j, f.name)
        if f.name == "moe":
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        else:
            assert a == b, f.name
    assert cfg_t.param_count() == cfg_j.param_count()
    assert cfg_t.active_param_count() == cfg_j.active_param_count()
    assert tmoe.moe_flops_per_token(cfg_t.d_model, cfg_t.moe) == \
        jmoe.moe_flops_per_token(cfg_j.d_model, cfg_j.moe)
    assert tbuild(cfg_t, "cpu").cfg is cfg_t


def test_bridge_round_trip(models):
    """Every leaf of JAX's parameter tree arrives in the port's layout
    unchanged (the experts stacked (E, d, F) / (E, F, d), the shared
    experts with gate_proj, the LM head stored with padded rows); the
    port's own seeded init gives the same tree of shapes."""
    model_j, model_t, params_j, params_t = models
    cfg = model_t.cfg
    tree = jax.tree.map(np.asarray, params_j)
    np.testing.assert_array_equal(params_t["embed"].numpy(), tree["embed"])
    np.testing.assert_array_equal(
        fhs.head_storage(params_t["lm_head"])[:, :cfg.vocab].numpy(),
        tree["lm_head"])
    moe_j = tree["layers"]["moe"]
    for i, lp in enumerate(params_t["layers"]):
        assert "w_gate" not in lp
        flat_t = {"/".join(k): v for k, v in _flatten(lp["moe"])}
        flat_j = {"/".join(k): v[i] for k, v in _flatten(moe_j)}
        assert flat_t.keys() == flat_j.keys()
        for name, leaf in flat_j.items():
            np.testing.assert_array_equal(flat_t[name].numpy(), leaf,
                                          err_msg=name)
    own = tbuild(cfg, "cpu").init(seed=1)
    for a, b in zip(own["layers"], params_t["layers"]):
        assert {k: tuple(v.shape) for k, v in _flatten(a)} == \
            {k: tuple(v.shape) for k, v in _flatten(b)}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_route_matches(models):
    """Top-k weights (renormalised), experts and the Switch aux on 64
    tokens."""
    model_j, model_t, params_j, params_t = models
    cfg = model_t.cfg.moe
    pj, pt = _layer0(params_j, params_t)
    x = _x((64, model_t.cfg.d_model), 3)
    wj, ej, aj = jmoe.route(jnp.asarray(x), pj["router"], cfg)
    wt, et, at = tmoe.route(torch.from_numpy(x), pt["router"], cfg)
    off = ~_near_ties(x, pj["router"], cfg)
    assert off.mean() > 0.9
    np.testing.assert_array_equal(np.sort(et.numpy(), -1)[off],
                                  np.sort(np.asarray(ej), -1)[off])
    np.testing.assert_allclose(wt.numpy()[off], np.asarray(wj)[off],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(at), float(aj), rtol=RTOL)


@pytest.mark.parametrize("B,S", [(1, 24), (3, 40)])
def test_moe_ffn_matches(models, B, S):
    """One group of B·S tokens (B = 1) and one group per row (B = 3), with
    the smokes' shared experts (qwen2-moe 2, moonshot 1)."""
    model_j, model_t, params_j, params_t = models
    cfg = model_t.cfg.moe
    pj, pt = _layer0(params_j, params_t)
    x = _x((B, S, model_t.cfg.d_model), 4)
    assert not _near_ties(x.reshape(-1, x.shape[-1]), pj["router"],
                          cfg).any()
    oj, aj = jmoe.moe_ffn(jnp.asarray(x), pj, cfg)
    ot, at = tmoe.moe_ffn(torch.from_numpy(x), pt, cfg)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(at), float(aj), rtol=RTOL)


def _reference_drops(topk_e, C, E):
    """The (group, token, k) pairs a sort-based dispatch drops: pairs in
    (token, k) order, each expert keeping its first C."""
    drops = set()
    for g, te in enumerate(topk_e):
        seen = np.zeros(E, int)
        for t, experts in enumerate(te):
            for k, e in enumerate(experts):
                if seen[e] >= C:
                    drops.add((g, t, k))
                seen[e] += 1
    return drops


@pytest.mark.parametrize("B,S", [(1, 24), (2, 24)])
def test_moe_ffn_capacity_drops(models, B, S):
    """A router built so every token picks experts 0 and 1 (in that
    order): each keeps C of the group's tokens and drops the rest.  The
    dropped pairs equal a plain reference's, computed on JAX's routing;
    tokens that lost both experts get no routed contribution: their rows
    are exactly JAX's zeros, or with shared experts exactly the shared
    experts' output alone."""
    model_j, model_t, params_j, params_t = models
    cfg = model_t.cfg.moe
    E, K, d = cfg.num_experts, cfg.top_k, model_t.cfg.d_model
    pj, pt = _layer0(params_j, params_t)
    router = np.zeros((d, E), np.float32)
    router[:, 0], router[:, 1] = 2.0, 1.0
    pj = dict(pj, router=jnp.asarray(router))
    pt = dict(pt, router=torch.from_numpy(router))
    x = np.abs(_x((B, S, d), 5)) + 0.1
    G, T = (B, S) if B > 1 else (1, B * S)
    C = tmoe.capacity(T, cfg)
    assert C < T
    _, ej, _ = jmoe.route(jnp.asarray(x.reshape(-1, d)), pj["router"], cfg)
    ej = np.asarray(ej).reshape(G, T, K)
    want = _reference_drops(ej, C, E)
    _, et, _ = tmoe.route(torch.from_numpy(x.reshape(G, T, d)), pt["router"],
                          cfg)
    order, slot = tmoe.dispatch_slots(et, cfg, C)
    pair = torch.empty_like(slot).scatter_(1, order, slot).reshape(G, T, K)
    got = {tuple(int(i) for i in p) for p in torch.nonzero(pair == E * C)}
    assert got == want and len(want) == G * 2 * (T - C)
    oj, _ = jmoe.moe_ffn(jnp.asarray(x), pj, cfg)
    ot, _ = tmoe.moe_ffn(torch.from_numpy(x), pt, cfg)
    oj, ot = np.asarray(oj).reshape(G, T, d), ot.numpy().reshape(G, T, d)
    lost = np.array([[all((g, t, k) in want for k in range(K))
                      for t in range(T)] for g in range(G)])
    assert lost.sum() == G * (T - C)
    if cfg.num_shared_experts == 0:
        np.testing.assert_array_equal(ot[lost], oj[lost])
        assert not ot[lost].any()
    else:
        sp = pt["shared"]
        xt = torch.from_numpy(x).reshape(G, T, d)
        hs = tlayers.swiglu(tlayers.qdot(xt, sp["w_gate"]),
                            tlayers.qdot(xt, sp["w_up"]))
        shared = tlayers.qdot(hs, sp["w_down"]) * torch.sigmoid(
            xt @ sp["gate_proj"])
        np.testing.assert_array_equal(ot[lost], shared.numpy()[lost])
    np.testing.assert_allclose(ot, oj, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B", [1, 3])
def test_moe_ffn_under_quant_policy(models, B):
    """QuantPolicy (MXINT4 weights, MXINT8 activations): the stacked
    experts quantized along each matrix's contraction axis (JAX vmaps
    quant.weights over E), expert_in along d, the shared experts through
    qdot."""
    model_j, model_t, params_j, params_t = models
    cfg = model_t.cfg.moe
    pj, pt = _layer0(params_j, params_t)
    x = _x((B, 16, model_t.cfg.d_model), 6)
    oj, _ = jmoe.moe_ffn(jnp.asarray(x), pj, cfg,
                         jlayers.QuantPolicy(enabled=True))
    ot, _ = tmoe.moe_ffn(torch.from_numpy(x), pt, cfg,
                         tlayers.QuantPolicy(enabled=True))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=RTOL,
                               atol=ATOL)
    w = pt["w_down"]
    assert torch.equal(tmoe.expert_weights(w, tlayers.QuantPolicy(True)),
                       torch.stack([tlayers.QuantPolicy(True).weights(m)
                                    for m in w]))


@pytest.mark.parametrize("head_mode", ["hidden", "logits"])
@pytest.mark.parametrize("with_cache", [False, True])
def test_forward_matches(models, head_mode, with_cache):
    """forward over 40 positions of 3 rows; with the full warm cache and
    BAOS (mxint4), rows of length 40, 25 and 1 (the engine's idle-row
    mask)."""
    model_j, model_t, params_j, params_t = models
    cfg_j, cfg_t = model_j.cfg, model_t.cfg
    B, S = 3, 40
    toks = _tokens(cfg_t, B, S, seed=1)
    valid = np.arange(S)[None, :] < np.array([[40], [25], [1]])
    kw_j, kw_t = {}, {}
    if with_cache:
        kw_j = dict(cache=jtr.init_cache(cfg_j, B, S),
                    kv_valid=jnp.asarray(valid), calibrate=True,
                    baos_cfg=jbaos.BAOSConfig(kv_format="mxint4"))
        kw_t = dict(cache=ttr.init_cache(cfg_t, B, S, "cpu"),
                    kv_valid=torch.from_numpy(valid), calibrate=True,
                    baos_cfg=tbaos.BAOSConfig(kv_format="mxint4"))
    want, _, aux = jtr.forward(params_j, cfg_j, jnp.asarray(toks),
                               head_mode=head_mode, **kw_j)
    got, _ = ttr.forward(params_t, cfg_t, torch.from_numpy(toks),
                         head_mode=head_mode, **kw_t)
    assert float(aux) > 0
    atol = 5e-3 if with_cache else ATOL       # BAOS rounding edges
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=atol)


@pytest.mark.parametrize("cache_mode,kv_format", [
    ("none", None), ("dual", "mxint4"), ("prefix", "mxint4"),
    ("dual", "mxfp4_e2m1")])
def test_generate_greedy_tokens_match(models, cache_mode, kv_format):
    """Greedy tokens of generate() equal JAX's, B 2, prompt 12, gen 16,
    block 8, 4 steps; the cached modes with BAOS."""
    model_j, model_t, params_j, params_t = models
    on = kv_format is not None
    kw = dict(gen_length=16, block_length=8, steps_per_block=4,
              cache_mode=cache_mode)
    dj = jdiff.DiffusionConfig(baos=jbaos.BAOSConfig(
        enabled=on, kv_format=kv_format or "mxint4"), **kw)
    dt = tdiff.DiffusionConfig(baos=tbaos.BAOSConfig(
        enabled=on, kv_format=kv_format or "mxint4"), **kw)
    prompt = _tokens(model_t.cfg, 2, 12, seed=5)
    want = jdiff.generate(model_j, params_j, jnp.asarray(prompt), dj,
                          rng=jax.random.PRNGKey(11))
    got = tdiff.generate(model_t, params_t, torch.from_numpy(prompt), dt,
                         seed=11)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not bool((got == model_t.cfg.mask_id).any())


@pytest.fixture(scope="module")
def llada_moe():
    cfg_j = jbase.get_config("llada-moe-7b-a1b", smoke=True)
    cfg_t = tbase.get_config("llada-moe-7b-a1b", smoke=True)
    model_j, model_t = jbuild(cfg_j), tbuild(cfg_t, "cpu")
    params_j = model_j.init(jax.random.PRNGKey(0))
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        cfg_t, "cpu")
    return model_j, model_t, params_j, params_t


def _engine_trace(vocab):
    """Two requests share a two-page prompt (page 8); gens 8 and 16."""
    rs = np.random.RandomState(0)
    shared = rs.randint(0, vocab - 2, size=(16,)).astype(np.int32)
    prompts = [shared, shared.copy(),
               rs.randint(0, vocab - 2, size=(12,)).astype(np.int32),
               rs.randint(0, vocab - 2, size=(8,)).astype(np.int32)]
    return [(p, 8 * (1 + i % 2)) for i, p in enumerate(prompts)]


def _serve(engine, make_request, trace):
    events = []
    for prompt, gen in trace:
        engine.submit(make_request(prompt=prompt.copy(), gen_length=gen),
                      on_commit=events.append)
    engine.warmup()
    while engine.pending:
        if not engine.tick():
            break
    done = sorted(engine.completed, key=lambda c: c.uid)
    keys = [(e.uid, e.tick, e.block_idx, e.step_in_block, e.masks_left,
             e.done, tuple(int(p) for p in e.positions),
             tuple(int(t) for t in e.tokens)) for e in events]
    return ({c.uid: c.tokens.tolist() for c in done},
            {c.uid: c.ticks for c in done}, keys, engine.ticks_total)


@pytest.mark.parametrize("pool", ["slot", "paged"])
@pytest.mark.parametrize("megatick_k", [1, 4])
@pytest.mark.parametrize("mode,baos", [
    ("none", None), ("warm", None), ("warm", dict(kv_format="mxint4"))],
    ids=["none", "warm", "warm+baos"])
def test_moe_engine_matches_jax_engine(llada_moe, mode, baos, megatick_k,
                                       pool):
    """llada-moe-7b-a1b: final tokens, per-request ticks, every CommitEvent
    and the tick count equal the JAX engine's, and the paged run the slot
    run's.  The engine's forward runs over idle-slot and padding
    positions, which share each row's expert capacity in both packages."""
    model_j, model_t, params_j, params_t = llada_moe
    kw = dict(gen_length=16, block_length=8, steps_per_block=4)
    bj = jbaos.BAOSConfig(**baos) if baos else jbaos.BAOSConfig(enabled=False)
    bt = tbaos.BAOSConfig(**baos) if baos else tbaos.BAOSConfig(enabled=False)
    dj = jdiff.DiffusionConfig(cache_mode="none", baos=bj, **kw)
    dt = tdiff.DiffusionConfig(baos=bt, **kw)
    base = dict(num_slots=2, max_seq_len=32, page_size=8, mode=mode,
                megatick_k=megatick_k)
    trace = _engine_trace(model_t.cfg.vocab)
    got = _serve(ServingEngine(model_t, params_t, dt,
                               EngineConfig(pool=pool, seed=0, **base)),
                 Request, trace)
    want = _serve(JEngine(model_j, params_j, dj,
                          JEngineConfig(pool=pool, rng=jax.random.PRNGKey(0),
                                        **base)), JRequest, trace)
    assert got == want
    if pool == "paged":
        slot = _serve(ServingEngine(model_t, params_t, dt,
                                    EngineConfig(pool="slot", seed=0,
                                                 **base)), Request, trace)
        assert got == slot
    for toks in got[0].values():
        assert model_t.cfg.mask_id not in toks


def test_serve_command_on_an_moe_arch(capsys):
    """``python -m repro_torch.launch.serve --arch llada-moe-7b-a1b`` on the
    smoke config, on the CPU: the engine path with breakdown, and the
    legacy path."""
    small = ["--device", "cpu", "--arch", "llada-moe-7b-a1b", "--batch", "2",
             "--prompt-len", "16", "--gen-len", "16", "--block-len", "8",
             "--steps", "4", "--requests", "2"]
    serve.main(small + ["--breakdown"])
    out = capsys.readouterr().out
    assert "engine: slots=2" in out and "steady-state TPS" in out
    assert "sampling:" in out and "forward:" in out
    serve.main(small + ["--legacy"])
    out = capsys.readouterr().out
    assert "steady-state TPS" in out and "cache=dual" in out


def test_moe_is_a_ported_family():
    """build_model builds every MoE config, and a dense config relabelled
    vlm (the vlm family's backbone is the dense stack) as JAX's VLMModel;
    a transformer config whose moe field disagrees with its family is
    refused."""
    for arch in MOE:
        assert tbuild(tbase.get_config(arch), "cpu").cfg.family == "moe"
    vlm = dataclasses.replace(tbase.get_config("llada-8b", smoke=True),
                              family="vlm")
    assert type(tbuild(vlm, "cpu")).__name__ == "VLMModel"
    with pytest.raises(ValueError):
        ttr.check_supported(dataclasses.replace(
            tbase.get_config("llada-moe-7b-a1b", smoke=True), moe=None))

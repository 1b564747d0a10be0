"""The dense configurations of the PyTorch port vs the JAX package: every
field of the full and smoke configs of all five dense archs, the bridge
carrying each new arch's parameters (codeqwen1.5-7b's QKV bias,
llama3.2-3b's GQA 24/8 and rope theta 5e5, minicpm-2b's embed, residual
and logit scales and odd vocabulary), and smoke generate() and engine
greedy tokens for codeqwen1.5-7b, llama3.2-3b and minicpm-2b.  minicpm-2b
holds greedy tokens only: JAX's own jitted and eager heads differ by up to
1% in conf at its logit_scale != 1."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import diffusion as jdiff
from repro.models import transformer as jtr
from repro.models.registry import build_model as jbuild
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.core import diffusion as tdiff
from repro_torch.models import transformer as ttr
from repro_torch.models.registry import build_model as tbuild
from repro_torch.serving import EngineConfig, Request, ServingEngine

torch.set_num_threads(1)

DENSE = ["llada-8b", "qwen2-0.5b", "codeqwen1.5-7b", "llama3.2-3b",
         "minicpm-2b"]
NEW = ["codeqwen1.5-7b", "llama3.2-3b", "minicpm-2b"]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_config_fields_match_jax(arch, smoke):
    cfg_t = tbase.get_config(arch, smoke=smoke)
    cfg_j = jbase.get_config(arch, smoke=smoke)
    fields_t = {f.name: getattr(cfg_t, f.name)
                for f in dataclasses.fields(cfg_t)}
    fields_j = {f.name: getattr(cfg_j, f.name)
                for f in dataclasses.fields(cfg_j)}
    assert fields_t == fields_j
    assert cfg_t.mask_id == cfg_j.mask_id
    assert cfg_t.param_count() == cfg_j.param_count()


@pytest.fixture(scope="module", params=NEW)
def models(request):
    cfg_j = jbase.get_config(request.param, smoke=True)
    cfg_t = tbase.get_config(request.param, smoke=True)
    model_j, model_t = jbuild(cfg_j), tbuild(cfg_t, "cpu")
    params_j = model_j.init(jax.random.PRNGKey(0))
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        cfg_t, "cpu")
    return model_j, model_t, params_j, params_t


def test_bridge_carries_the_params(models):
    """Every JAX parameter reaches the port (QKV biases included), and the
    logits of a forward over them equal JAX's."""
    model_j, model_t, params_j, params_t = models
    cfg = model_t.cfg
    stack = params_j["layers"]["attn"]
    for i, lp in enumerate(params_t["layers"]):
        assert ("bq" in lp) == cfg.qkv_bias
        for name in ("wq", "wk", "wv", "wo") + (
                ("bq", "bk", "bv") if cfg.qkv_bias else ()):
            np.testing.assert_array_equal(lp[name].numpy(),
                                          np.asarray(stack[name][i]))
    np.testing.assert_array_equal(params_t["lm_head"].numpy(),
                                  np.asarray(params_j["lm_head"]))
    toks = np.random.RandomState(3).randint(0, cfg.vocab, size=(2, 24)
                                            ).astype(np.int32)
    want, _, _ = jtr.forward(params_j, model_j.cfg, jnp.asarray(toks))
    got, _ = ttr.forward(params_t, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("cache_mode", ["none", "dual", "prefix"])
def test_generate_greedy_tokens_match(models, cache_mode):
    model_j, model_t, params_j, params_t = models
    kw = dict(gen_length=16, block_length=8, steps_per_block=4,
              cache_mode=cache_mode)
    prompt = np.random.RandomState(5).randint(
        0, model_t.cfg.vocab - 2, size=(2, 12)).astype(np.int32)
    want = jdiff.generate(model_j, params_j, jnp.asarray(prompt),
                          jdiff.DiffusionConfig(**kw),
                          rng=jax.random.PRNGKey(11))
    got = tdiff.generate(model_t, params_t, torch.from_numpy(prompt),
                         tdiff.DiffusionConfig(**kw), seed=11)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not bool((got == model_t.cfg.mask_id).any())
    tdiff.clear_step_graphs()


@pytest.mark.parametrize("mode", ["warm", "none"])
def test_engine_greedy_tokens_match(models, mode):
    model_j, model_t, params_j, params_t = models
    kw = dict(gen_length=16, block_length=8, steps_per_block=4)
    rs = np.random.RandomState(0)
    trace = [(rs.randint(0, model_t.cfg.vocab - 2, size=(8 + 4 * i,)
                         ).astype(np.int32), 8 * (1 + i % 2))
             for i in range(4)]
    eng_j = JEngine(model_j, params_j,
                    jdiff.DiffusionConfig(cache_mode="none", **kw),
                    JEngineConfig(num_slots=2, max_seq_len=48, mode=mode,
                                  rng=jax.random.PRNGKey(0)))
    eng_t = ServingEngine(model_t, params_t, tdiff.DiffusionConfig(**kw),
                          EngineConfig(num_slots=2, max_seq_len=48,
                                       mode=mode))
    done_j = eng_j.run([JRequest(prompt=p, gen_length=g) for p, g in trace])
    done_t = eng_t.run([Request(prompt=p, gen_length=g) for p, g in trace])
    assert {c.uid: c.tokens.tolist() for c in done_t} == \
        {c.uid: c.tokens.tolist() for c in done_j}

"""Dense transformer forward of the PyTorch port vs the JAX package on the
same weights (JAX init -> numpy -> bridge), both SMOKE configs (llada-8b;
qwen2-0.5b brings GQA and a QKV bias)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import baos as jbaos
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro.models.registry import build_model as jbuild
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.core import baos as tbaos
from repro_torch.models import layers as tlayers
from repro_torch.models import registry as tregistry
from repro_torch.models import transformer as ttr
from repro_torch.models.registry import build_model as tbuild

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
ARCHS = ["llada-8b", "qwen2-0.5b"]


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    cfg_j = jbase.get_config(request.param, smoke=True)
    cfg_t = tbase.get_config(request.param, smoke=True)
    params_j = jbuild(cfg_j).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params_j)
    return cfg_j, cfg_t, params_j, bridge.params_from_numpy(tree, cfg_t,
                                                            "cpu")


def _tokens(cfg, B, S, seed):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab, size=(B, S)).astype(np.int32)


def test_config_copies_match(models):
    cfg_j, cfg_t = models[:2]
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_head",
              "d_ff", "vocab", "qkv_bias", "rope_theta", "norm_eps",
              "mask_id", "dtype", "logit_scale"):
        assert getattr(cfg_t, f) == getattr(cfg_j, f), f
    full_j = jbase.get_config(cfg_j.name)
    full_t = tbase.get_config(cfg_t.name)
    assert full_t.param_count() == full_j.param_count()


@pytest.mark.parametrize("with_cache", [False, True])
def test_hidden_states_match(models, with_cache):
    """forward(head_mode='hidden') over 40 positions; with the full warm
    cache, rows of length 40, 25 and 1 (the engine's idle-row mask).
    Without a cache both packages attend over every position."""
    cfg_j, cfg_t, params_j, params_t = models
    B, S = 3, 40
    toks = _tokens(cfg_j, B, S, seed=1)
    valid = np.arange(S)[None, :] < np.array([[40], [25], [1]])
    kw_j, kw_t = {}, {}
    if with_cache:
        kw_j = dict(cache=jtr.init_cache(cfg_j, B, S),
                    kv_valid=jnp.asarray(valid))
        kw_t = dict(cache=ttr.init_cache(cfg_t, B, S, "cpu"),
                    kv_valid=torch.from_numpy(valid))
    want, cache_j, _ = jtr.forward(params_j, cfg_j, jnp.asarray(toks),
                                   head_mode="hidden", **kw_j)
    got, cache_t = ttr.forward(params_t, cfg_t, torch.from_numpy(toks),
                               head_mode="hidden", **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    if with_cache:
        for name in ("k", "v"):
            np.testing.assert_allclose(cache_t[name].numpy(),
                                       np.asarray(cache_j[name]),
                                       rtol=RTOL, atol=ATOL)


def test_logits_slice_and_logits(models):
    cfg_j, cfg_t, params_j, params_t = models
    toks = _tokens(cfg_j, 2, 24, seed=2)
    want, _, _ = jtr.forward(params_j, cfg_j, jnp.asarray(toks),
                             logits_slice=(8, 8))
    got, _ = ttr.forward(params_t, cfg_t, torch.from_numpy(toks),
                         logits_slice=(8, 8))
    assert tuple(got.shape) == (2, 8, cfg_t.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("kv_format", [None, "mxint4", "mxint8",
                                       "mxfp8_e4m3"])
def test_segment_into_warm_cache_matches(models, kv_format):
    """The cached modes' forward: a warm pass over 40 positions that
    calibrates and writes the whole cache, then a 16-token segment at
    seg_start 16 (a prefix-mode refine) reading the stored calibration.
    Hidden states, the K/V written (smoothed and quantized with BAOS on)
    and the calibration must match JAX's.

    Tolerances with BAOS on: K/V computed 1e-7 apart (GEMM summation order)
    can round to neighbouring grid points when they sit on a rounding edge.
    That happens to about one element in 10^4 here, moves it by one grid
    step (here at most 1/64, in smoothed units), and moves the hidden
    states of the following layers by up to 2e-3 absolute."""
    cfg_j, cfg_t, params_j, params_t = models
    B, S, seg = 2, 40, 16
    toks = _tokens(cfg_j, B, S, seed=3)
    on = kv_format is not None
    bj = jbaos.BAOSConfig(enabled=on, kv_format=kv_format or "mxint4")
    bt = tbaos.BAOSConfig(enabled=on, kv_format=kv_format or "mxint4")
    cache_j = jtr.init_cache(cfg_j, B, S)
    cache_t = ttr.init_cache(cfg_t, B, S, "cpu")
    atol = 5e-3 if on else ATOL
    for kw in (dict(tokens=toks, seg_start=0, calibrate=True),
               dict(tokens=toks[:, seg:2 * seg], seg_start=seg,
                    calibrate=False)):
        want, cache_j, _ = jtr.forward(
            params_j, cfg_j, jnp.asarray(kw["tokens"]), cache=cache_j,
            seg_start=kw["seg_start"], baos_cfg=bj,
            calibrate=kw["calibrate"], head_mode="hidden")
        got, cache_t = ttr.forward(
            params_t, cfg_t, torch.from_numpy(kw["tokens"]), cache=cache_t,
            seg_start=kw["seg_start"], baos_cfg=bt,
            calibrate=kw["calibrate"], head_mode="hidden")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=atol)
    for name in ("k", "v"):
        diff = np.abs(cache_t[name].numpy() - np.asarray(cache_j[name]))
        if not on:
            np.testing.assert_allclose(cache_t[name].numpy(),
                                       np.asarray(cache_j[name]), rtol=RTOL,
                                       atol=ATOL)
        else:
            assert (diff > 0).mean() <= 1e-3 and diff.max() <= 1 / 64, name
    if on:            # (the port skips the calibration nothing reads)
        for name in tbaos.BAOSCalib._fields:
            np.testing.assert_allclose(cache_t[name].numpy(),
                                       np.asarray(cache_j[name]), rtol=RTOL,
                                       atol=ATOL)


def test_seeded_init_shapes_and_scales():
    """The port's own init: JAX's shapes and distributions (the draws are
    torch's)."""
    cfg = tbase.get_config("qwen2-0.5b", smoke=True)
    p = tbuild(cfg, "cpu").init(seed=3)
    tree = jax.tree.map(np.asarray, jbuild(jbase.get_config(
        "qwen2-0.5b", smoke=True)).init(jax.random.PRNGKey(0)))
    ref = bridge.params_from_numpy(tree, cfg, "cpu")
    assert p.keys() == ref.keys()
    for a, b in zip(p["layers"], ref["layers"]):
        assert a.keys() == b.keys()
        for name in a:
            assert a[name].shape == b[name].shape, name
    std = (2.0 / (cfg.d_model + cfg.vocab)) ** 0.5
    assert abs(float(p["lm_head"].std()) / std - 1) < 0.05
    assert abs(float(p["embed"].std()) / 0.02 - 1) < 0.05
    again = tbuild(cfg, "cpu").init(seed=3)
    assert torch.equal(again["lm_head"], p["lm_head"])


def test_unported_features_raise():
    """No feature of this module is left unported.  Every model family
    is ported: build_model builds all six (audio and vlm since their
    slice; their parity is tests/test_torch_whisper.py and
    tests/test_torch_vlm.py).  The split k_act/v_act cache is ported: a
    warm forward through it refreshes the active buffer from the block's
    rows (its parity in full is tests/test_torch_split_cache.py).  The
    QuantPolicy is ported: forward(quant=...) gives JAX's logits (its
    parity in full is tests/test_torch_quant.py)."""
    cfg = tbase.get_config("llada-8b", smoke=True)
    for arch in ("whisper-medium", "internvl2-26b"):
        model = tbuild(tbase.get_config(arch), "cpu")
        assert type(model).__name__ == type(
            jbuild(jbase.get_config(arch))).__name__
    assert set(tregistry.FAMILIES) == {"dense", "moe", "ssm", "hybrid",
                                       "audio", "vlm"}
    cfg_j = jbase.get_config("llada-8b", smoke=True)
    params_j = jbuild(cfg_j).init(jax.random.PRNGKey(0))
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        cfg, "cpu")
    split = ttr.init_cache(cfg, 1, 16, "cpu", act_len=8)
    ttr.forward(params_t, cfg, torch.arange(16, dtype=torch.int32)[None],
                cache=split, calibrate=True, logits_slice=(8, 8))
    assert torch.equal(split["k_act"], split["k"][:, :, 8:16])
    assert torch.equal(split["v_act"], split["v"][:, :, 8:16])
    toks = _tokens(cfg_j, 2, 16, seed=4)
    want, _, _ = jtr.forward(params_j, cfg_j, jnp.asarray(toks),
                             quant=jlayers.QuantPolicy(enabled=True))
    got, _ = ttr.forward(params_t, cfg, torch.from_numpy(toks),
                         quant=tlayers.QuantPolicy(enabled=True))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)

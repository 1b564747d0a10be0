"""The port's serving mesh (ROADMAP item 12, serving half) against the JAX
package and against its own single-device path, on the CPU.

Ranks are processes spawned by tests/_torch_mesh_ranks.py over gloo (a
``file://`` store in tmp_path, each joined with a deadline); a (1, 1) mesh
runs in the test's own process.  Held here:

* the vocab-sharded combine: ``combine_partials``, ``sharded_stable_max``
  and ``sharded_fused_head_stable_max`` on 1, 2 and 4 shards of V 257
  (not divisible: the MX-block pad and ``col_limit``) and of stored
  logits, formats none / mxfp8 / mxint4, with and without a suppressed
  id, against JAX's run under ``jax.vmap(axis_name="model")`` over the
  shards: tokens equal, conf within rtol 2e-6 (the combine sums the
  shards' f32 partials in another order than JAX's psum);
* ``generate(mesh=)`` (K 1 and the megatick at K 4) and the engine in
  modes none and warm (K 1 and 4) over meshes (1, 1), (2, 1), (1, 2) and
  (2, 2): tokens bit for bit equal to the single-device fused path, and
  the mesh megatick's ticks and CommitEvents equal to K 1's;
* the refusals, JAX's in type and meaning; ``serve --mesh``; the per-chip
  trace of ``capture_tick_trace(mesh=)`` against JAX's sharded sampling
  trace.
"""
import argparse

import _torch_mesh_ranks as ranks
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import diffusion as jdiff
from repro.core import sampling as jsamp
from repro.launch.mesh import make_debug_mesh as jmesh
from repro.models.registry import build_model as jbuild
from repro.sim import trace as jtr
from repro_torch.configs import base as tbase
from repro_torch.core import diffusion as tdiff
from repro_torch.core import sampling as tsamp
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve
from repro_torch.models.registry import build_model as tbuild
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.sim import trace as ttr

torch.set_num_threads(1)
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2)]
CONF_RTOL = 2e-6


@pytest.fixture(scope="module")
def combine_results(tmp_path_factory):
    return ranks.spawn("combine", 4, tmp_path_factory.mktemp("combine"))


def _jax_shards(fn, shards):
    return jax.vmap(fn, axis_name="model")(jnp.asarray(shards))


@pytest.mark.parametrize("fmt", ranks.FMTS)
@pytest.mark.parametrize("n", ranks.SHARDS)
def test_sharded_fused_head_matches_jax(combine_results, n, fmt):
    h, w, _, _ = ranks.combine_inputs()
    wp = np.asarray(jsamp.pad_head_for_mesh(jnp.asarray(w), n))
    assert wp.shape[1] % (n * 32) == 0
    shards = wp.reshape(ranks.D, n, -1).transpose(1, 0, 2)
    for sup in ranks.SUPPRESS:
        conf, idx = _jax_shards(
            lambda ws: jsamp.sharded_fused_head_stable_max(
                jnp.asarray(h), ws, "model", fmt, suppress_id=sup,
                col_limit=ranks.V_HEAD), shards)
        tconf, tidx = combine_results["head", n, fmt, sup]
        for r in range(n):                 # the same on every shard
            np.testing.assert_array_equal(np.asarray(idx[r]), tidx)
            np.testing.assert_allclose(np.asarray(conf[r]), tconf,
                                       rtol=CONF_RTOL)
        if sup is not None:
            assert not (tidx == sup).any()
    # and the single-device fused head's tokens
    want_c, want_i = jsamp.fused_head_stable_max(
        jnp.asarray(h), jnp.asarray(w), fmt, suppress_id=ranks.V_HEAD - 1)
    got_c, got_i = combine_results["head", n, fmt, ranks.V_HEAD - 1]
    np.testing.assert_array_equal(np.asarray(want_i), got_i)
    np.testing.assert_allclose(np.asarray(want_c), got_c, rtol=CONF_RTOL)


@pytest.mark.parametrize("fmt", ranks.FMTS)
@pytest.mark.parametrize("n", ranks.SHARDS)
def test_sharded_stable_max_matches_jax(combine_results, n, fmt):
    _, _, logits, _ = ranks.combine_inputs()
    shards = logits.reshape(ranks.R, n, -1).transpose(1, 0, 2)
    conf, idx = _jax_shards(
        lambda z: jsamp.sharded_stable_max(z, "model", fmt), shards)
    tconf, tidx = combine_results["logits", n, fmt]
    np.testing.assert_array_equal(np.asarray(idx[0]), tidx)
    np.testing.assert_allclose(np.asarray(conf[0]), tconf, rtol=CONF_RTOL)


@pytest.mark.parametrize("n", ranks.SHARDS)
def test_combine_partials_matches_jax(combine_results, n):
    """Explicit partials, ties of m across shards included: the lowest
    index among the shards holding the max wins, as JAX's pmin."""
    _, _, _, (pm, pi, ps) = ranks.combine_inputs()
    conf, idx = jax.vmap(
        lambda m, i, s: jsamp.combine_partials(m, i, s, "model"),
        axis_name="model")(jnp.asarray(pm[:n]), jnp.asarray(pi[:n]),
                           jnp.asarray(ps[:n]))
    tconf, tidx = combine_results["partials", n]
    np.testing.assert_array_equal(np.asarray(idx[0]), tidx)
    np.testing.assert_allclose(np.asarray(conf[0]), tconf, rtol=CONF_RTOL)


# ---------------------------------------------------------------------------
# generate and the engine over a mesh, bit for bit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def single_device():
    return ranks.serve_results(None)


@pytest.fixture(scope="module")
def mesh_results(tmp_path_factory):
    out, tmp = {}, tmp_path_factory.mktemp("serve")
    for data, model in MESHES:
        if data * model == 1:
            out[data, model] = ranks.serve_results(
                mesh_lib.make_debug_mesh(1, 1, "cpu"))
        else:
            out[data, model] = ranks.spawn("serve", data * model, tmp,
                                           data=data, model=model)
    return out


@pytest.mark.parametrize("data,model", MESHES)
def test_generate_mesh_bit_identical(single_device, mesh_results, data,
                                     model):
    got = mesh_results[data, model]
    shape, backend, coords = got["mesh"]
    assert shape == {"data": data, "model": model} and backend == "gloo"
    assert coords == (0, 0)
    for k in (1, 4):
        np.testing.assert_array_equal(got["generate", k],
                                      single_device["generate", 1])
    assert not (got["generate", 1][:, ranks.PROMPT[1]:] ==
                tbase.get_config("llada-8b", smoke=True).mask_id).any()


@pytest.mark.parametrize("mode", ["none", "warm"])
@pytest.mark.parametrize("data,model", MESHES)
def test_engine_mesh_bit_identical(single_device, mesh_results, data, model,
                                   mode):
    got = mesh_results[data, model]
    ref = single_device["engine", mode, 1]
    assert got["engine", mode, 1][0] == ref[0]          # tokens per uid
    assert got["engine", mode, 1][1:] == ref[1:]       # ticks, events
    assert set(ref[0]) == {1, 2, 3, 4}


@pytest.mark.parametrize("mode", ["none", "warm"])
@pytest.mark.parametrize("data,model", MESHES)
def test_mesh_megatick_equals_k1(mesh_results, data, model, mode):
    got = mesh_results[data, model]
    assert got["engine", mode, 4] == got["engine", mode, 1]


# ---------------------------------------------------------------------------
# Refusals, JAX's in type and meaning
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    cfg_j = jbase.get_config("llada-8b", smoke=True)
    cfg_t = tbase.get_config("llada-8b", smoke=True)
    model_t = tbuild(cfg_t, "cpu")
    return jbuild(cfg_j), model_t, model_t.init(0)


def _raises(fn):
    try:
        fn()
    except Exception as e:          # noqa: BLE001 - the error is the result
        return e
    raise AssertionError("no exception")


@pytest.mark.parametrize("case", ["legacy-head", "temperature", "random",
                                  "generate-dual", "generate-fwd-kw",
                                  "axes"])
def test_refusals_match_jax(models, case):
    model_j, model_t, params_t = models
    jm, tm = jmesh(1, 1), mesh_lib.make_debug_mesh(1, 1, "cpu")
    mid = model_t.cfg.mask_id
    if case in ("legacy-head", "temperature", "random"):
        kw = {"legacy-head": dict(head_path="legacy"),
              "temperature": dict(sampling=tsamp.SamplingConfig(
                  temperature=0.7)),
              "random": dict(sampling=tsamp.SamplingConfig(
                  strategy="random"))}[case]
        jkw = dict(kw)
        if "sampling" in kw:
            s = kw["sampling"]
            jkw["sampling"] = jsamp.SamplingConfig(
                temperature=s.temperature, strategy=s.strategy)
        ej = _raises(lambda: jdiff.get_spmd_tick_fn(
            model_j, jdiff.DiffusionConfig(**jkw), mid, jm))
        et = _raises(lambda: tdiff.get_spmd_tick_fn(
            model_t, tdiff.DiffusionConfig(**kw), mid, tm))
    elif case == "axes":
        ej = _raises(lambda: jdiff.get_spmd_tick_fn(
            model_j, jdiff.DiffusionConfig(), mid,
            jax.make_mesh((1,), ("batch",))))
        et = _raises(lambda: tdiff.get_spmd_tick_fn(
            model_t, tdiff.DiffusionConfig(), mid,
            argparse.Namespace(axis_names=("batch",))))
    else:
        cache = "dual" if case == "generate-dual" else "none"
        kw = dict(cross_kv=None) if case == "generate-fwd-kw" else {}
        ej = _raises(lambda: jdiff.step(
            model_j, {}, jdiff.init_state(model_j, jnp.zeros((1, 8),
                                                                jnp.int32),
                                          jdiff.DiffusionConfig(
                                              gen_length=8, block_length=8,
                                              steps_per_block=2,
                                              cache_mode=cache)),
            mesh=jm, **({"extra": 1} if kw else {})))
        et = _raises(lambda: tdiff.generate(
            model_t, params_t, torch.zeros((1, 8), dtype=torch.int32),
            tdiff.DiffusionConfig(gen_length=8, block_length=8,
                                  steps_per_block=2, cache_mode=cache),
            mesh=tm, **kw))
    assert type(et) is type(ej), (et, ej)
    key = {"legacy-head": "head_path='fused'", "temperature": "greedy",
           "random": "greedy", "generate-dual": "cache_mode='none'",
           "generate-fwd-kw": "forward kwargs",
           "axes": "('data', 'model')"}[case]
    assert key in str(ej) and key in str(et), (et, ej)


@pytest.mark.parametrize("option", ["breakdown", "fwd-kw", "slots"])
def test_engine_refusals(models, option):
    """JAX's engine refusals under a mesh (ValueError each); the slot check
    on a (2, 1) mesh shape (it refuses before any collective)."""
    _, model_t, params_t = models
    mesh = (mesh_lib.shape_mesh(2, 1) if option == "slots"
            else mesh_lib.make_debug_mesh(1, 1, "cpu"))
    cfg = dict(breakdown=dict(breakdown=True),
               **{"fwd-kw": dict(fwd_kw={"cross_kv": None}),
                  "slots": dict(num_slots=3)})[option]
    with pytest.raises(ValueError, match="breakdown|forward kwargs|"
                                         "divisible"):
        ServingEngine(model_t, params_t, tdiff.DiffusionConfig(),
                      EngineConfig(mesh=mesh, max_seq_len=32, **cfg))


def test_tick_refuses_indivisible_batch_and_unplaced_params(models):
    _, model_t, params_t = models
    view = mesh_lib.shape_mesh(2, 1)
    tick = tdiff.get_spmd_tick_fn(model_t, tdiff.DiffusionConfig(),
                                  model_t.cfg.mask_id, view, False)
    meta = torch.empty((3, 16), dtype=torch.int32, device="meta")
    placed = tdiff.place_spmd_params(params_t, view)
    with pytest.raises(ValueError, match="not divisible by the data axis"):
        tick(placed, meta, None, meta[:, 0], meta[:, 0], 0)
    one = mesh_lib.make_debug_mesh(1, 1, "cpu")
    tick1 = tdiff.get_spmd_tick_fn(model_t, tdiff.DiffusionConfig(),
                                   model_t.cfg.mask_id, one, False)
    two = mesh_lib.shape_mesh(1, 2)
    with pytest.raises(ValueError, match="place_spmd_params"):
        tick1(tdiff.place_spmd_params(params_t, two), meta, None,
              meta[:, 0], meta[:, 0], 0)
    assert tdiff.place_spmd_params(placed, view) is placed


def test_mesh_needs_its_processes_and_refuses_gloo_graphs(models):
    """A mesh of more ranks than the job has processes raises (pointing at
    torch.distributed.run); a graphed step over a mesh whose collectives a
    CUDA graph cannot capture raises, never running eagerly in silence."""
    model_t = models[1]
    with pytest.raises(ValueError, match="torch.distributed.run"):
        mesh_lib.make_debug_mesh(2, 1, "cpu")
    gloo_card = mesh_lib.Mesh(1, 1, 0, "gloo", torch.device("cuda"),
                              {"data": None, "model": None})
    assert not gloo_card.capturable
    with pytest.raises(ValueError, match="jit_steps=False"):
        tdiff.check_spmd(model_t, tdiff.DiffusionConfig(), gloo_card, True)
    tdiff.check_spmd(model_t, tdiff.DiffusionConfig(), gloo_card, False)
    assert mesh_lib.choose_backend(torch.device("cpu"), 4) == "gloo"


# ---------------------------------------------------------------------------
# serve --mesh and the per-chip trace
# ---------------------------------------------------------------------------

SMALL = ["--device", "cpu", "--arch", "qwen2-0.5b", "--batch", "2",
         "--prompt-len", "8", "--gen-len", "16", "--block-len", "8",
         "--steps", "4", "--requests", "2"]


def test_serve_mesh_1_1(capsys):
    serve.main(SMALL + ["--mesh", "1,1", "--mode", "none"])
    out = capsys.readouterr().out
    assert "mesh: Mesh(data=1, model=1" in out and "gloo" in out
    assert "mesh={'data': 1, 'model': 1}" in out
    serve.main(SMALL + ["--mesh", "1,1", "--legacy", "--cache", "none"])
    assert "steady-state TPS" in capsys.readouterr().out


def test_serve_mesh_refusals():
    with pytest.raises(SystemExit, match="torch.distributed.run"):
        serve.main(SMALL + ["--mesh", "2,1"])
    with pytest.raises(SystemExit, match="DATA,MODEL"):
        serve.main(SMALL + ["--mesh", "2"])
    with pytest.raises(SystemExit, match="--cache none"):
        serve.main(SMALL + ["--mesh", "1,1", "--legacy"])
    # --http serves over a mesh of this job's ranks
    # (test_torch_frontend_mesh.py); a mesh shape has none
    args = serve.build_parser().parse_args(SMALL + ["--http", "0"])
    with pytest.raises(ValueError, match="no process groups"):
        serve.run_http(args, None, None, None, None,
                       mesh=mesh_lib.shape_mesh(1, 2))


@pytest.mark.parametrize("data,model", [(1, 1), (2, 1), (1, 4), (2, 2)])
@pytest.mark.parametrize("cache", ["none", "warm"])
def test_spmd_tick_trace_per_chip(models, data, model, cache):
    """The mesh capture records one chip's tick: the forward marker over
    B/n_data rows, then exactly JAX's per-chip sharded sampling trace
    (capture_sampling_trace('sharded'): the shard's streamed partials, the
    combine, the commit)."""
    model_t = models[1]
    cfg = model_t.cfg
    B, S, L = 4, 32, 8
    dt = tdiff.DiffusionConfig(gen_length=16, block_length=L,
                               steps_per_block=4,
                               cache_mode="dual" if cache == "warm"
                               else "none")
    t = ttr.capture_tick_trace(model_t, dt, B=B, s_tot=S,
                               mesh=mesh_lib.shape_mesh(data, model))
    assert t.meta["mesh"] == {"data": data, "model": model}
    first = t.ops[0].to_dict()
    assert first["op"] == "XU_FORWARD"
    assert tuple(first["shape"]) == (B // data, S, cfg.d_model)
    want = jtr.capture_sampling_trace(
        B=B, L=L, V=cfg.vocab, d=cfg.d_model, head_path="sharded",
        model_shards=model, data_shards=data, mask_id=cfg.mask_id)
    assert [o.to_dict() for o in t.ops[1:]] == \
        [o.to_dict() for o in want.ops]
    assert any(o.op == "COLL_PMAX" for o in t.ops)

"""ServingEngine of the PyTorch port vs the JAX engine: modes 'none' and
'warm' (also with BAOS, and on the unfused and legacy head paths) on a
mixed-length trace (2 slots, 4 requests, all arriving at 0 so admission
does not depend on the wall clock).  Final tokens and every
CommitEvent (tick, block/step, positions, tokens, masks_left, done,
final row) must be equal; ``now`` is wall-clock and is not compared."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import baos as jbaos
from repro.core import diffusion as jdiff
from repro.models.registry import build_model as jbuild
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.core import baos as tbaos
from repro_torch.core import diffusion as tdiff
from repro_torch.models.registry import build_model as tbuild
from repro_torch.serving import (EngineConfig, Request, ServingEngine,
                                 SlowFastPolicy)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    cfg_j = jbase.get_config("llada-8b", smoke=True)
    cfg_t = tbase.get_config("llada-8b", smoke=True)
    model_j, model_t = jbuild(cfg_j), tbuild(cfg_t, "cpu")
    params_j = model_j.init(jax.random.PRNGKey(0))
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        cfg_t, "cpu")
    return model_j, model_t, params_j, params_t


def _trace(vocab):
    rs = np.random.RandomState(0)
    return [(rs.randint(0, vocab - 2, size=(8 + 4 * i,)).astype(np.int32),
             8 * (1 + i % 2)) for i in range(4)]


def _run(engine, make_request, trace):
    events = []
    for prompt, gen in trace:
        engine.submit(make_request(prompt=prompt, gen_length=gen),
                      on_commit=events.append)
    done = engine.run()
    rows = [(e.uid, e.tick, e.block_idx, e.step_in_block,
             e.positions.tolist(), np.asarray(e.tokens).tolist(),
             e.masks_left, e.done,
             None if e.final_tokens is None else e.final_tokens.tolist())
            for e in events]
    return {c.uid: c.tokens.tolist() for c in done}, rows


def _compare_engines(models, mode, baos=None, **dcfg_kw):
    """Run the same trace through both engines; tokens, CommitEvents and
    tick counts must be equal.  ``baos`` is a BAOSConfig field dict."""
    model_j, model_t, params_j, params_t = models
    kw = dict(gen_length=16, block_length=8, steps_per_block=4, **dcfg_kw)
    bj = jbaos.BAOSConfig(**baos) if baos else jbaos.BAOSConfig(enabled=False)
    bt = tbaos.BAOSConfig(**baos) if baos else tbaos.BAOSConfig(enabled=False)
    trace = _trace(model_t.cfg.vocab)
    eng_j = JEngine(model_j, params_j,
                    jdiff.DiffusionConfig(cache_mode="none", baos=bj, **kw),
                    JEngineConfig(num_slots=2, max_seq_len=48, mode=mode,
                                  rng=jax.random.PRNGKey(0)))
    eng_t = ServingEngine(model_t, params_t,
                          tdiff.DiffusionConfig(baos=bt, **kw),
                          EngineConfig(num_slots=2, max_seq_len=48,
                                       mode=mode))
    tok_j, ev_j = _run(eng_j, JRequest, trace)
    tok_t, ev_t = _run(eng_t, Request, trace)
    assert tok_t == tok_j
    assert ev_t == ev_j
    assert eng_t.ticks_total == eng_j.ticks_total
    for toks in tok_t.values():
        assert model_t.cfg.mask_id not in toks


@pytest.mark.parametrize("mode", ["none", "warm"])
def test_engine_matches_jax_engine(models, mode):
    _compare_engines(models, mode)


@pytest.mark.parametrize("baos", [
    dict(kv_format="mxint4"),
    dict(kv_format="mxfp8_e4m3", calib_scope="active_block"),
    dict(kv_format="mxint8", variant="mean")],
    ids=["mxint4", "mxfp8-active_block", "mxint8-mean"])
def test_warm_engine_with_baos_matches_jax_engine(models, baos):
    """Every warm tick recalibrates over the pool (idle and padding rows
    included, as JAX does; or each row's active block) and writes the
    smoothed MX cache through the BAOS kernel's plain version."""
    _compare_engines(models, "warm", baos=baos)


@pytest.mark.parametrize("mode,head_path", [("warm", "unfused"),
                                            ("none", "legacy")])
def test_engine_head_paths_match_jax_engine(models, mode, head_path):
    _compare_engines(models, mode, head_path=head_path)


def test_one_slot_engine_equals_generate(models):
    _, model_t, _, params_t = models
    dcfg = tdiff.DiffusionConfig(gen_length=16, block_length=8,
                                 steps_per_block=4)
    prompt = np.arange(3, 19, dtype=np.int32)
    ref = tdiff.generate(model_t, params_t, torch.from_numpy(prompt)[None],
                         dcfg)
    eng = ServingEngine(model_t, params_t, dcfg,
                        EngineConfig(num_slots=1, max_seq_len=32,
                                     mode="none"))
    done = eng.run([Request(prompt=prompt, gen_length=16)])
    np.testing.assert_array_equal(done[0].tokens, ref[0].numpy())


def test_engine_policies_cancel_and_validation(models):
    _, model_t, _, params_t = models
    dcfg = tdiff.DiffusionConfig(gen_length=16, block_length=8,
                                 steps_per_block=4)
    eng = ServingEngine(model_t, params_t, dcfg,
                        EngineConfig(num_slots=1, max_seq_len=32, mode="warm",
                                     policy=SlowFastPolicy(threshold=0.0)))
    prompt = np.arange(8, dtype=np.int32)
    uid = eng.submit(Request(prompt=prompt, gen_length=16))
    late = eng.submit(Request(prompt=prompt, gen_length=8, arrival_time=1e9))
    assert eng.cancel(late) and not eng.cancel(late)
    with pytest.raises(ValueError):
        eng.submit(Request(prompt=prompt, gen_length=12))     # not k*block
    with pytest.raises(ValueError):
        eng.submit(Request(prompt=prompt, gen_length=32))     # too long
    with pytest.raises(ValueError):
        eng.submit(Request(prompt=prompt, gen_length=8, uid=uid))
    done = eng.warmup().run()
    assert [c.uid for c in done] == [uid]
    # threshold 0 finishes each block one tick after its first commit
    assert done[0].ticks == 4
    # a per-request policy overrides the engine's: fifo keeps the schedule
    own = eng.submit(Request(prompt=prompt, gen_length=16, policy="fifo"))
    done = eng.run()
    assert done[-1].uid == own and done[-1].ticks == 8
    assert eng.metrics.summary()["requests_completed"] == 2


# the mesh is ported (tests/test_torch_spmd.py), the paged pool under it
# too (tests/test_torch_paged_mesh.py).  These refuse as JAX refuses:
# breakdown timing under a mesh (option2) with its ValueError, and
# something that is no mesh (option0, the megatick; option1, the paged
# pool; option3) with JAX's ValueError for missing mesh axes
@pytest.mark.parametrize("option", [dict(megatick_k=4, mesh=object()),
                                    dict(pool="paged", mesh=object()),
                                    dict(breakdown=True, mesh=object()),
                                    dict(mesh=object())])
def test_unported_engine_options_raise(models, option):
    _, model_t, _, params_t = models
    error, match = (ValueError, "breakdown" if option.get("breakdown")
                    else "mesh axes")
    with pytest.raises(error, match=match):
        ServingEngine(model_t, params_t, tdiff.DiffusionConfig(),
                      EngineConfig(**option))

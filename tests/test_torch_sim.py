"""Trace capture and the cycle-level simulator of the PyTorch port
(repro_torch.sim.isa / trace / cycle) against the JAX package's.

Every case of tests/test_cycle_sim.py has a counterpart here, held against
JAX: the port's traces come from its own tick and sampling functions run
on meta tensors, JAX's from jax.eval_shape, and the two op lists (op,
shape, format, stage, note) and their ``meta`` must be equal, at small and
at llada-8b widths.  The simulator is pure Python over the op list, so its
results are held equal, float for float, not within a tolerance.  A trace
written by either package is read by the other's ``Trace.load``.  The
tick's tracer records nothing on the numbers: a tick with one gives the
tokens of a tick without."""
import argparse
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import diffusion as jdiff
from repro.core import sampling as jsamp
from repro.models.registry import build_model as jbuild
from repro.sim import analytical as jana
from repro.sim import cycle as jcyc
from repro.sim import isa as jisa
from repro.sim import trace as jtr
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.core import diffusion as tdiff
from repro_torch.core import sampling as tsamp
from repro_torch.models.registry import build_model as tbuild
from repro_torch.sim import analytical as tana
from repro_torch.sim import cycle as tcyc
from repro_torch.sim import isa as tisa
from repro_torch.sim import trace as ttr

torch.set_num_threads(1)

# moderate scale: real chunking (several vocab chunks), instant capture
CAP = dict(B=8, L=32, V=32768, d=1024)
WIDTHS = {"small": dict(B=3, L=8, V=1000, d=64),
          "llada-8b": dict(B=4, L=16, V=126464, d=4096)}
# hardware points of NPUConfig.from_hw: the paper's §6.2 point and three
# moves of it
HW_POINTS = [dict(), dict(hbm_stacks=2), dict(vlen=512, grid=2),
             dict(freq=1.5e9, pipeline_fill=12)]


def _ops(trace):
    return [o.to_dict() for o in trace.ops]


def _same_trace(a, b):
    assert _ops(a) == _ops(b)
    assert a.meta == b.meta


def _same_sim(a, b):
    """Two SimResults, field for field and float for float."""
    for name in ("cycles", "hbm_bytes", "net_bytes", "macs", "vec_ops",
                 "sram_peak_bytes", "sram_reuses", "sram_overflow_bytes",
                 "n_ops", "time_s", "energy_j", "sram_ok"):
        assert getattr(a, name) == getattr(b, name), name
    assert {k: dataclasses.asdict(v) for k, v in a.stages.items()} == \
        {k: dataclasses.asdict(v) for k, v in b.stages.items()}


@pytest.fixture(scope="module")
def fused_trace():
    return ttr.capture_sampling_trace(head_path="fused", **CAP)


@pytest.fixture(scope="module")
def fused_trace_jax():
    return jtr.capture_sampling_trace(head_path="fused", **CAP)


# ---------------------------------------------------------------------------
# The ISA, the NPU configuration and the analytical stages
# ---------------------------------------------------------------------------


def test_isa_tables_equal_jax():
    assert {n: dataclasses.asdict(i) for n, i in tisa.ISA.items()} == \
        {n: dataclasses.asdict(i) for n, i in jisa.ISA.items()}
    assert tisa.BYTES == jisa.BYTES and tisa.TILE_R == jisa.TILE_R
    for fmt in tisa.BYTES:
        assert tisa.fmt_bytes(fmt) == jisa.fmt_bytes(fmt)
        assert tisa.is_mx(fmt) == jisa.is_mx(fmt)
    with pytest.raises(KeyError):          # as JAX's: no mxfp6_e3m2 width
        tisa.fmt_bytes("mxfp6_e3m2")


@pytest.mark.parametrize("point", range(len(HW_POINTS)))
def test_npu_config_from_hw_equals_jax(point):
    t = tisa.NPUConfig.from_hw(tana.HWConfig(**HW_POINTS[point]))
    j = jisa.NPUConfig.from_hw(jana.HWConfig(**HW_POINTS[point]))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for prop in ("hbm_bytes_per_cycle", "net_bytes_per_cycle",
                 "sram_bytes_per_cycle"):
        assert getattr(t, prop) == getattr(j, prop)
    assert tisa.NPUConfig.from_hw(tana.HWConfig(), vlen=256).vlen == 256


@pytest.mark.parametrize("fmt", ["mxfp8_e4m3", "mxint4", "bf16"])
@pytest.mark.parametrize("logit_rows", [None, 4 * 96])
def test_unfused_stage_and_sram_footprint_equal_jax(fmt, logit_rows):
    for point in HW_POINTS:
        th, jh = tana.HWConfig(**point), jana.HWConfig(**point)
        t = tana.unfused_head_sampling_stage(4, 16, 126464, 4096, th,
                                             fmt=fmt, logit_rows=logit_rows)
        j = jana.unfused_head_sampling_stage(4, 16, 126464, 4096, jh,
                                             fmt=fmt, logit_rows=logit_rows)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for v_chunk in (4096, 200000):
        assert tana.sampling_sram_footprint(4, 16, 126464, v_chunk, 2048) \
            == jana.sampling_sram_footprint(4, 16, 126464, v_chunk, 2048)


# ---------------------------------------------------------------------------
# Trace round-trip, determinism, the tracer's rules (test_cycle_sim.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_trace_roundtrip_json(fused_trace, fused_trace_jax, writer,
                              tmp_path):
    """A trace written by one package is read by the other's Trace.load
    (and by its own), with the same ops, meta and simulated cycles."""
    p = tmp_path / "t.trace.json"
    (fused_trace if writer == "torch" else fused_trace_jax).save(str(p))
    back_t, back_j = ttr.Trace.load(str(p)), jtr.Trace.load(str(p))
    assert back_t.ops == fused_trace.ops and back_t.meta == fused_trace.meta
    assert _ops(back_j) == _ops(fused_trace) and \
        back_j.meta == fused_trace.meta
    assert tcyc.simulate(back_t).cycles == tcyc.simulate(fused_trace).cycles \
        == jcyc.simulate(back_j).cycles


def test_capture_is_deterministic_and_equals_jax(fused_trace,
                                                 fused_trace_jax):
    again = ttr.capture_sampling_trace(head_path="fused", **CAP)
    assert again.ops == fused_trace.ops
    _same_trace(fused_trace, fused_trace_jax)


def test_trace_ops_are_known_isa(fused_trace):
    assert len(fused_trace) > 0
    for op in fused_trace:
        assert op.op in tisa.ISA
    names = fused_trace.op_names()
    for needed in ("HBM_RD", "GEMM_TILE", "V_RED_MAX_IDX", "V_EXP_V",
                   "V_RED_SUM", "V_TOPK_MASK_PER_ELT", "V_SELECT_INT"):
        assert needed in names
    assert fused_trace.stages() == ["stream", "tail", "commit"]
    assert fused_trace.hbm_bytes() == \
        jtr.capture_sampling_trace(head_path="fused", **CAP).hbm_bytes()


def test_tracer_inactive_outside_capture():
    assert not ttr.is_active()
    ttr.emit("V_EXP_V", (4,))      # silently dropped, no tracer
    with ttr.activate(ttr.Tracer()) as tr:
        ttr.emit("V_EXP_V", (4,))
        with ttr.suppress():
            ttr.emit("V_EXP_V", (4,))
    assert len(tr.ops) == 1
    assert not ttr.is_active()


def test_unknown_op_rejected():
    with ttr.activate(ttr.Tracer()):
        with pytest.raises(ValueError, match="unknown trace op"):
            ttr.emit("V_BOGUS", (4,))


# ---------------------------------------------------------------------------
# Simulator: monotonicity and resource models, equal to JAX's
# ---------------------------------------------------------------------------


def test_cycles_monotone_in_hbm_bw():
    tr = ttr.capture_sampling_trace(head_path="legacy", seq_len=256, **CAP)
    jt = jtr.capture_sampling_trace(head_path="legacy", seq_len=256, **CAP)
    _same_trace(tr, jt)
    npu, jnpu = tisa.NPUConfig(), jisa.NPUConfig()
    prev = None
    for scale in (0.25, 0.5, 1.0, 2.0, 4.0):
        c = tcyc.simulate(
            tr, dataclasses.replace(npu, hbm_bw=npu.hbm_bw * scale)).cycles
        assert c == jcyc.simulate(
            jt, dataclasses.replace(jnpu, hbm_bw=jnpu.hbm_bw * scale)).cycles
        if prev is not None:
            assert c <= prev
        prev = c
    slow = tcyc.simulate(
        tr, dataclasses.replace(npu, hbm_bw=npu.hbm_bw * 0.25)).cycles
    assert slow > tcyc.simulate(tr, npu).cycles


def test_cycles_monotone_in_lanes(fused_trace, fused_trace_jax):
    npu, jnpu = tisa.NPUConfig(), jisa.NPUConfig()
    prev = None
    for vlen in (256, 512, 1024, 2048, 4096):
        c = tcyc.simulate(fused_trace,
                          dataclasses.replace(npu, vlen=vlen)).cycles
        assert c == jcyc.simulate(
            fused_trace_jax, dataclasses.replace(jnpu, vlen=vlen)).cycles
        if prev is not None:
            assert c <= prev
        prev = c
    assert tcyc.simulate(
        fused_trace, dataclasses.replace(npu, vlen=256)).cycles > \
        tcyc.simulate(fused_trace, npu).cycles


def test_mx_decode_width_binds(fused_trace, fused_trace_jax):
    narrow = tcyc.simulate(fused_trace, tisa.NPUConfig(mx_decode_width=64))
    assert narrow.cycles > tcyc.simulate(fused_trace).cycles
    _same_sim(narrow, jcyc.simulate(fused_trace_jax,
                                    jisa.NPUConfig(mx_decode_width=64)))


def test_sram_reuse_and_capacity(fused_trace, fused_trace_jax):
    r = tcyc.simulate(fused_trace)
    assert r.sram_ok and r.sram_peak_bytes > 0
    n_chunks = sum(1 for o in fused_trace if o.op == "GEMM_TILE")
    assert n_chunks > 1
    assert r.sram_reuses == 2 * (n_chunks - 1)
    tiny = tcyc.simulate(fused_trace, tisa.NPUConfig(sram_bytes=64 * 1024))
    assert not tiny.sram_ok and tiny.sram_overflow_bytes > 0
    _same_sim(r, jcyc.simulate(fused_trace_jax))
    _same_sim(tiny, jcyc.simulate(fused_trace_jax,
                                  jisa.NPUConfig(sram_bytes=64 * 1024)))


def test_hbm_bytes_match_analytical(fused_trace):
    hw = tana.HWConfig()
    ana = tana.fused_head_sampling_stage(CAP["B"], CAP["L"], CAP["V"],
                                         CAP["d"], hw)
    sim = tcyc.simulate(fused_trace, tisa.NPUConfig.from_hw(hw))
    assert sim.hbm_bytes == pytest.approx(ana.hbm_bytes, rel=0.05)


@pytest.mark.parametrize("point", range(len(HW_POINTS)))
@pytest.mark.parametrize("head_path,kw", [
    ("fused", {}), ("unfused", {}), ("legacy", {"seq_len": 256}),
    ("sharded", {"model_shards": 4}), ("engine", {})])
def test_simulate_equals_jax_at_hw_points(head_path, kw, point):
    """simulate on the port's trace and on JAX's, at NPUConfig.from_hw of
    each hardware point: every field equal."""
    tr = ttr.capture_sampling_trace(head_path=head_path, **CAP, **kw)
    jt = jtr.capture_sampling_trace(head_path=head_path, **CAP, **kw)
    _same_trace(tr, jt)
    _same_sim(tcyc.simulate(tr, tisa.NPUConfig.from_hw(
                  tana.HWConfig(**HW_POINTS[point]))),
              jcyc.simulate(jt, jisa.NPUConfig.from_hw(
                  jana.HWConfig(**HW_POINTS[point]))))


# ---------------------------------------------------------------------------
# Analytical-vs-cycle agreement (the documented crossval band)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head_path,kw", [
    ("fused", {}),
    ("unfused", {}),
    ("legacy", {"seq_len": 256}),
    ("sharded", {"model_shards": 4}),
    ("engine", {}),
])
def test_agreement_band(head_path, kw):
    """Inside JAX's band, and crossval_sampling's dict equal to JAX's at
    every hardware point."""
    r = tcyc.crossval_sampling(head_path=head_path, **CAP, **kw)
    lo, hi = tcyc.CROSSVAL_BAND[head_path]
    assert lo <= r["ratio_vs_analytical"] <= hi, r
    assert r["within_band"]
    assert tcyc.CROSSVAL_BAND == jcyc.CROSSVAL_BAND
    for point in HW_POINTS:
        assert tcyc.crossval_sampling(
            head_path=head_path, hw=tana.HWConfig(**point), **CAP, **kw) == \
            jcyc.crossval_sampling(head_path=head_path,
                                   hw=jana.HWConfig(**point), **CAP, **kw)


def test_sharded_trace_has_combine():
    tr = ttr.capture_sampling_trace(head_path="sharded", model_shards=4,
                                    **CAP)
    names = tr.op_names()
    for coll in ("COLL_PMAX", "COLL_PSUM", "COLL_PMIN"):
        assert coll in names
    full = ttr.capture_sampling_trace(head_path="fused", **CAP)

    def head(t):
        return sum(o.bytes for o in t
                   if o.op == "HBM_RD" and o.note == "head_w")
    assert head(full) / head(tr) == pytest.approx(4.0, rel=0.05)


# ---------------------------------------------------------------------------
# capture_sampling_trace against JAX: every head path, format and width
# ---------------------------------------------------------------------------


PATHS = [("fused", {}), ("unfused", {}), ("legacy", {"seq_len": 64}),
         ("engine", {}),
         ("sharded", {"model_shards": 2}), ("sharded", {"model_shards": 4}),
         ("sharded", {"model_shards": 2, "data_shards": 2}),
         ("sharded", {"model_shards": 4, "data_shards": 2})]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("fmt", ["none", "bf16", "mxfp8_e4m3", "mxint8",
                                 "mxint4"])
@pytest.mark.parametrize("path", range(len(PATHS)),
                         ids=["-".join([p] + [f"{k}{v}" for k, v in kw.items()])
                              for p, kw in PATHS])
def test_capture_sampling_trace_equals_jax(path, fmt, temperature):
    """Equal op lists and meta at small widths and at llada-8b's (d 4096,
    V 126464, the mask id), and equal simulated results."""
    head_path, kw = PATHS[path]
    for width in WIDTHS.values():
        extra = dict(mask_id=width["V"] - 1, temperature=temperature,
                     fmt=fmt, **kw)
        t = ttr.capture_sampling_trace(head_path=head_path, **width, **extra)
        j = jtr.capture_sampling_trace(head_path=head_path, **width, **extra)
        _same_trace(t, j)
        _same_sim(tcyc.simulate(t), jcyc.simulate(j))


@pytest.mark.parametrize("fmt", ["mxfp6_e3m2", "fp8", "int4"])
def test_formats_without_a_width_mirror_jax(fmt):
    """JAX's BYTES has no mxfp6_e3m2 and no alias: both packages record a
    trace in such a format, and simulating one whose memory ops carry it
    raises KeyError in both (the fused stream's ops carry the head's
    format only, so it simulates)."""
    for head_path in ("fused", "engine"):
        t = ttr.capture_sampling_trace(head_path=head_path, fmt=fmt,
                                       **WIDTHS["small"])
        j = jtr.capture_sampling_trace(head_path=head_path, fmt=fmt,
                                       **WIDTHS["small"])
        _same_trace(t, j)
        if head_path == "fused":
            _same_sim(tcyc.simulate(t), jcyc.simulate(j))
        else:
            with pytest.raises(KeyError):
                tcyc.simulate(t)
            with pytest.raises(KeyError):
                jcyc.simulate(j)


def test_capture_rejects_unknown_head_path_and_legacy_without_seq_len():
    for pkg in (ttr, jtr):
        with pytest.raises(ValueError, match="unknown head_path"):
            pkg.capture_sampling_trace(head_path="bogus", **CAP)
        with pytest.raises(ValueError, match="seq_len"):
            pkg.capture_sampling_trace(head_path="legacy", **CAP)


# ---------------------------------------------------------------------------
# Traces come from the real tick
# ---------------------------------------------------------------------------


def _smoke_setup(arch="llada-8b", smoke=True):
    cfg_j = jbase.get_config(arch, smoke=smoke)
    cfg_t = tbase.get_config(arch, smoke=smoke)
    return cfg_t, jbuild(cfg_j), tbuild(cfg_t, "cpu")


def _dcfgs(**kw):
    base = dict(gen_length=16, block_length=8, steps_per_block=4,
                cache_mode="none")
    base.update(kw)
    return jdiff.DiffusionConfig(**base), tdiff.DiffusionConfig(**base)


def _sampling_ops(trace):
    return [o for o in trace.ops if o.stage != "forward"]


def test_tick_trace_matches_standalone_fused():
    cfg, model_j, model_t = _smoke_setup()
    dj, dt = _dcfgs()
    tick = ttr.capture_tick_trace(model_t, dt, B=4, s_tot=32)
    assert any(o.op == "XU_FORWARD" for o in tick)
    ref = ttr.capture_sampling_trace(
        B=4, L=8, V=cfg.vocab, d=cfg.d_model, fmt=dt.sampling.fmt,
        head_path="fused", chunk_v=dt.head_chunk, mask_id=cfg.mask_id)
    assert _sampling_ops(tick) == list(ref.ops)
    _same_trace(tick, jtr.capture_tick_trace(model_j, dj, B=4, s_tot=32))


def test_tick_trace_legacy_head_charged_in_forward():
    cfg, model_j, model_t = _smoke_setup()
    dj, dt = _dcfgs(head_path="legacy")
    B, s_tot = 4, 32
    tick = ttr.capture_tick_trace(model_t, dt, B=B, s_tot=s_tot)
    gemms = [o for o in tick if o.op == "GEMM_TILE"]
    assert gemms and gemms[0].shape == (B * s_tot, cfg.d_model, cfg.vocab)
    assert any(o.op == "HBM_WR" and o.note == "logits" for o in tick)
    _same_trace(tick, jtr.capture_tick_trace(model_j, dj, B=B, s_tot=s_tot))


def test_warm_cache_tick_trace_captures():
    _, model_j, model_t = _smoke_setup()
    dj, dt = _dcfgs(cache_mode="dual")
    tick = ttr.capture_tick_trace(model_t, dt, B=2, s_tot=32)
    assert any(o.op == "XU_FORWARD" for o in tick)
    assert any(o.op == "GEMM_TILE" for o in tick)
    _same_trace(tick, jtr.capture_tick_trace(model_j, dj, B=2, s_tot=32))


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("cache_mode", ["none", "dual"])
@pytest.mark.parametrize("head_path", ["fused", "unfused", "legacy"])
def test_tick_trace_equals_jax_dense(head_path, cache_mode, temperature):
    """The smoke llada-8b tick: equal op lists and meta for every head
    path, cache none and warm, greedy and T 0.8 (JAX's tick always holds a
    key, the port's tick a seed), and a format without a kernel before
    this slice (mxint4)."""
    _, model_j, model_t = _smoke_setup()
    for fmt in ("mxfp8_e4m3", "mxint4"):
        dj, dt = _dcfgs(head_path=head_path, cache_mode=cache_mode)
        dj = dataclasses.replace(dj, sampling=jsamp.SamplingConfig(
            fmt=fmt, temperature=temperature))
        dt = dataclasses.replace(dt, sampling=tsamp.SamplingConfig(
            fmt=fmt, temperature=temperature))
        _same_trace(ttr.capture_tick_trace(model_t, dt, B=4, s_tot=32),
                    jtr.capture_tick_trace(model_j, dj, B=4, s_tot=32))


@pytest.mark.parametrize("cache_mode", ["none", "dual"])
def test_tick_trace_equals_jax_legacy_family(cache_mode):
    """mamba2-130m (no head_mode: the legacy head on every path), smoke
    config, segments a multiple of 16."""
    _, model_j, model_t = _smoke_setup("mamba2-130m")
    for head_path in ("fused", "legacy"):
        dj, dt = _dcfgs(head_path=head_path, cache_mode=cache_mode,
                        block_length=16, gen_length=16)
        tick = ttr.capture_tick_trace(model_t, dt, B=2, s_tot=32)
        assert [o.op for o in tick][:2] == ["XU_FORWARD", "HBM_RD"]
        _same_trace(tick, jtr.capture_tick_trace(model_j, dj, B=2, s_tot=32))


@pytest.mark.parametrize("head_path", ["fused", "unfused", "legacy"])
def test_tick_trace_equals_jax_at_full_width(head_path):
    """llada-8b at full width (32 layers, d 4096, V 126464): shape only on
    both sides (meta tensors; jax.eval_shape), the engine's shape."""
    _, model_j, model_t = _smoke_setup(smoke=False)
    dj, dt = _dcfgs(head_path=head_path, block_length=16)
    t = ttr.capture_tick_trace(model_t, dt, B=4, s_tot=96)
    _same_trace(t, jtr.capture_tick_trace(model_j, dj, B=4, s_tot=96))
    assert t.meta["V"] == 126464 and t.meta["d"] == 4096


def test_spmd_tick_trace_waits_for_the_mesh():
    """The SPMD capture (a mesh) no longer waits: the port records one
    chip's tick (tests/test_torch_spmd.py holds it to JAX's per-chip
    sampling trace).  Something that is no mesh raises JAX's ValueError
    for missing mesh axes."""
    from repro_torch.launch import mesh as mesh_lib
    _, _, model_t = _smoke_setup()
    _, dt = _dcfgs()
    t = ttr.capture_tick_trace(model_t, dt, B=4, s_tot=32,
                               mesh=mesh_lib.shape_mesh(2, 2))
    assert t.meta["mesh"] == {"data": 2, "model": 2}
    assert [o.op for o in t.ops].count("COLL_PSUM") == 1
    with pytest.raises(ValueError, match="mesh axes"):
        ttr.capture_tick_trace(model_t, dt, B=4, s_tot=32,
                               mesh=argparse.Namespace(
                                   shape={"data": 1, "model": 1}))


@pytest.fixture(scope="module")
def smoke_params():
    cfg, model_j, model_t = _smoke_setup()
    params_j = model_j.init(jax.random.PRNGKey(0))
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        cfg, "cpu")
    return cfg, model_t, params_t


@pytest.mark.parametrize("strategy", ["stablemax", "random"])
@pytest.mark.parametrize("head_path", ["fused", "unfused", "legacy"])
def test_tick_with_a_tracer_gives_the_same_tokens(smoke_params, head_path,
                                                  strategy):
    """The serving path passes no tracer; a tick with one records the ops
    of the meta capture and changes no number of the tick."""
    cfg, model_t, params_t = smoke_params
    _, dt = _dcfgs(head_path=head_path)
    dt = dataclasses.replace(dt, sampling=tsamp.SamplingConfig(
        strategy=strategy))
    B, s_tot = 2, 24
    rs = np.random.RandomState(1)
    x = torch.from_numpy(np.concatenate(
        [rs.randint(0, cfg.vocab - 2, size=(B, 8)),
         np.full((B, 16), cfg.mask_id)], axis=1).astype(np.int32))
    args = (params_t, x, torch.ones((B, s_tot), dtype=torch.bool),
            torch.full((B,), 8, dtype=torch.int32),
            torch.full((B,), 2, dtype=torch.int32), 11, None, dt,
            cfg.mask_id)
    ref = tdiff.batched_tick(model_t, *args)
    tracer = ttr.Tracer()
    out = tdiff.batched_tick(model_t, *args, tracer=tracer)
    for a, b in zip(ref, out):
        if a is not None:
            assert torch.equal(a, b)
    assert _ops(tracer.finish()) == _ops(
        ttr.capture_tick_trace(model_t, dt, B=B, s_tot=s_tot))
    assert not ttr.is_active()


# ---------------------------------------------------------------------------
# Hybrid end-to-end
# ---------------------------------------------------------------------------


def test_end_to_end_cycle_fused_beats_legacy():
    cfg_t = tbase.get_config("llada-8b")
    cfg_j = jbase.get_config("llada-8b")
    kw = dict(B=4, prompt=64, gen_len=128, block_len=32, steps=8,
              cache_mode="dual")
    fused = tcyc.end_to_end_cycle(cfg_t, head_path="fused", **kw)
    legacy = tcyc.end_to_end_cycle(cfg_t, head_path="legacy", **kw)
    assert fused.tps > legacy.tps
    assert fused.sampling_frac < legacy.sampling_frac
    assert fused.tokens == 4 * 128
    for head_path, got in (("fused", fused), ("legacy", legacy)):
        want = jcyc.end_to_end_cycle(cfg_j, head_path=head_path, **kw)
        for name in ("total_s", "model_s", "sampling_s", "energy_j",
                     "tokens", "tps", "tok_per_j", "sampling_frac"):
            assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("point", range(len(HW_POINTS)))
@pytest.mark.parametrize("head_path", ["fused", "unfused", "legacy",
                                       "sharded"])
def test_end_to_end_cycle_equals_jax_at_hw_points(head_path, point):
    """end_to_end_cycle at each hardware point and head path, Table 6's
    shape (B 16, prompt 128, gen 256, block 64, 16 steps), llada-8b: every
    number equal to JAX's; a trace passed in (one capture for every
    point, as a DSE sweep does) gives the same."""
    cfg_t = tbase.get_config("llada-8b")
    cfg_j = jbase.get_config("llada-8b")
    kw = dict(B=16, prompt=128, gen_len=256, block_len=64, steps=16,
              cache_mode="dual", head_path=head_path,
              model_shards=2 if head_path == "sharded" else 1)
    got = tcyc.end_to_end_cycle(cfg_t, tana.HWConfig(**HW_POINTS[point]),
                                **kw)
    want = jcyc.end_to_end_cycle(cfg_j, jana.HWConfig(**HW_POINTS[point]),
                                 **kw)
    for name in ("total_s", "model_s", "sampling_s", "energy_j", "tokens"):
        assert getattr(got, name) == getattr(want, name), name
    _same_sim(got.sampling_sim, want.sampling_sim)
    again = tcyc.end_to_end_cycle(
        cfg_t, tana.HWConfig(**HW_POINTS[point]),
        trace=ttr.capture_sampling_trace(
            B=16, L=64, V=cfg_t.vocab, d=cfg_t.d_model, head_path=head_path,
            model_shards=kw["model_shards"],
            seq_len=384 if head_path == "legacy" else None), **kw)
    assert again.total_s == got.total_s

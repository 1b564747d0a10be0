"""BAOS of the PyTorch port vs the JAX package: calibration, the smoothed
MX quantization of the KV write-back (core/baos.smooth_quantize and the
plain version of kernels/baos_mx_quant.py, against repro.core.baos, the
Pallas kernel in interpret mode and its jnp oracle), and the query/output
fusion helpers.

The quantized values are held bit for bit.  The inputs are seeded and
chosen as tests/test_torch_mx.py chooses them: no subnormal or near-f32-max
block, and no block whose amax / grid_max lies within 2 ulp of a power of
two, where XLA's and torch's log2 may round the exponent differently."""
import itertools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import baos as jbaos
from repro.core import mx as jmx
from repro.kernels import ops, ref
from repro_torch.core import baos as tbaos
from repro_torch.core import mx as tmx
from repro_torch.kernels import baos_mx_quant as tbq

torch.set_num_threads(1)

KV_FORMATS = ["mxint4", "mxint8", "mxfp8_e4m3"]


def _far_from_scale_edges(xs: np.ndarray, fmt: str) -> bool:
    """True when no 32-block's amax / grid_max is within 2 ulp of a power
    of two (blocks along the last axis)."""
    amax = np.abs(xs.reshape(*xs.shape[:-1], -1, 32)).max(-1)
    r = (amax[amax > 0] / np.float32(jmx.FORMATS[fmt].grid_max)).astype(
        np.float32)
    p = (2.0 ** np.round(np.log2(r))).astype(np.float32)
    return bool((np.abs(r - p) > 2 * np.spacing(p)).all())


def _kv_inputs(B, S, H, D, fmt, dtype, seed):
    """x (B, S, H, D) with per-channel offsets and spreads (the outlier
    channels BAOS is for), and its minmax calibration; the first seed from
    ``seed`` whose smoothed blocks are clear of the scale edges."""
    for s in itertools.count(seed):
        rs = np.random.RandomState(s)
        x = (rs.randn(B, S, H, D) * rs.uniform(0.2, 8.0, (1, 1, H, D))
             + rs.randn(1, 1, H, D) * 3).astype(np.float32)
        xt = torch.from_numpy(x).to(getattr(torch, dtype))
        x = xt.float().numpy()
        c, f = jbaos._calibrate_one(jnp.asarray(x), jbaos.BAOSConfig())
        c, f = np.asarray(c), np.asarray(f)
        if _far_from_scale_edges((x - c) / f, fmt):
            return xt, c, f


@pytest.mark.parametrize("variant", ["minmax", "mean"])
@pytest.mark.parametrize("masked", [False, True])
def test_calibrate_matches(variant, masked):
    """Centers and scales, over the whole sequence or a block mask (the
    active-block scope).  minmax centers are exact; mean sums in another
    order, so its centers agree to 1e-6 absolute.  The scales go through
    f ** 0.5, which XLA and torch round apart by up to an ulp."""
    rs = np.random.RandomState(3)
    k = (rs.randn(2, 24, 3, 32) * 4 + 1).astype(np.float32)
    v = rs.randn(2, 24, 3, 32).astype(np.float32)
    mask = None
    if masked:
        mask = np.zeros((2, 24), bool)
        mask[0, 8:16] = mask[1, 4:20] = True
    cfg_j = jbaos.BAOSConfig(variant=variant, alpha=0.5)
    cfg_t = tbaos.BAOSConfig(variant=variant, alpha=0.5)
    want = jbaos.calibrate(jnp.asarray(k), jnp.asarray(v), cfg_j,
                           None if mask is None else jnp.asarray(mask))
    got = tbaos.calibrate(torch.from_numpy(k), torch.from_numpy(v), cfg_t,
                          None if mask is None else torch.from_numpy(mask))
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        assert tuple(g.shape) == (2, 1, 3, 32) and g.dtype == torch.float32
        if variant == "minmax" and name.endswith("center"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)


def test_config_copy_matches():
    """Same fields, same defaults."""
    def fields(cfg):
        return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}
    assert fields(tbaos.BAOSConfig()) == fields(jbaos.BAOSConfig())


@pytest.mark.parametrize("fmt", KV_FORMATS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smooth_quantize_bit_exact(fmt, dtype):
    """core/baos.smooth_quantize (the kernel's plain version on the CPU)
    vs repro.core.baos.smooth_quantize, the JAX model path."""
    xt, c, f = _kv_inputs(2, 20, 3, 64, fmt, dtype, seed=KV_FORMATS.index(fmt))
    xj = jnp.asarray(xt.float().numpy()).astype(getattr(jnp, dtype))
    want = jbaos.smooth_quantize(xj, jnp.asarray(c), jnp.asarray(f),
                                 jbaos.BAOSConfig(kv_format=fmt))
    got = tbaos.smooth_quantize(xt, torch.from_numpy(c), torch.from_numpy(f),
                                tbaos.BAOSConfig(kv_format=fmt))
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("fmt", KV_FORMATS)
def test_baos_plain_matches_pallas_and_oracle(fmt):
    """The plain version of baos_mx_quant vs the Pallas kernel (interpret
    mode, its (G, S, D) grid through ops.baos_quantize, S = 40 padded to
    its tile) and the jnp oracle kernels/ref.baos_mx_quant_ref."""
    B, S, H, D = 2, 40, 3, 64
    xt, c, f = _kv_inputs(B, S, H, D, fmt, "float32", seed=20)
    x = xt.numpy()
    got = tbq.baos_mx_quant(xt, torch.from_numpy(c), torch.from_numpy(f),
                            fmt).numpy()
    kern = np.asarray(ops.baos_quantize(jnp.asarray(x), jnp.asarray(c),
                                        jnp.asarray(f), fmt_name=fmt,
                                        interpret=True))
    g = lambda a: a.transpose(0, 2, 1, 3).reshape(B * H, -1, D)  # noqa: E731
    oracle = np.asarray(ref.baos_mx_quant_ref(
        jnp.asarray(g(x)), jnp.asarray(g(c)), jnp.asarray(g(f)), fmt))
    np.testing.assert_array_equal(got, kern)
    np.testing.assert_array_equal(g(got), oracle)


def test_baos_writes_into_a_cache_slice():
    """``out=`` a strided slice of a (B, s_tot, H, D) cache: the segment is
    written in place and nothing else changes."""
    xt, c, f = _kv_inputs(2, 8, 3, 32, "mxint4", "bfloat16", seed=30)
    cache = torch.full((2, 20, 3, 32), 7.0, dtype=torch.bfloat16)
    out = tbq.baos_mx_quant(xt, torch.from_numpy(c), torch.from_numpy(f),
                            "mxint4", out=cache[:, 5:13])
    want = tbq.baos_mx_quant_plain(xt, torch.from_numpy(c),
                                   torch.from_numpy(f), "mxint4")
    assert out.data_ptr() == cache[:, 5:13].data_ptr()
    assert torch.equal(cache[:, 5:13], want)
    assert bool((cache[:, :5] == 7).all()) and bool((cache[:, 13:] == 7).all())
    with pytest.raises(ValueError):
        tbq.baos_mx_quant(xt, torch.from_numpy(c)[:, :, :2],
                          torch.from_numpy(f), "mxint4")


def _g(a: np.ndarray) -> np.ndarray:
    """(B, S, H, D) -> the Pallas kernel's and oracle's (G = B * H, S, D)."""
    B, S, H, D = a.shape
    return a.transpose(0, 2, 1, 3).reshape(B * H, S, D)


@pytest.mark.parametrize("fmt", KV_FORMATS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_baos_plain_zero_blocks_and_d32_match_oracle(fmt, dtype):
    """D = 32 (one MX block per head) with whole blocks equal to their
    centers, so their smoothed values are all zero (scale 1), and a ragged
    S: the plain version vs the JAX oracle kernels/ref.baos_mx_quant_ref,
    bit for bit."""
    B, S, H, D = 2, 13, 3, 32
    for seed in itertools.count(40):
        rs = np.random.RandomState(seed)
        c = torch.from_numpy(rs.randn(B, 1, H, D).astype(np.float32) * 3)
        c = c.to(getattr(torch, dtype)).float()     # x can equal c exactly
        f = torch.from_numpy(rs.uniform(0.5, 2.0, (B, 1, H, D)).astype(
            np.float32))
        x = (c + torch.from_numpy(rs.randn(B, S, H, D).astype(np.float32))
             * f * 4).to(getattr(torch, dtype))
        x[:, :, 1] = c[:, :, 1].to(x.dtype)          # head 1: zero blocks
        x[0, 5] = c[0, 0].to(x.dtype)                # a zero row
        xs = ((x.float() - c) / f).numpy()
        if _far_from_scale_edges(xs, fmt):
            break
    got = tbq.baos_mx_quant(x, c, f, fmt)
    assert bool((got[:, :, 1] == 0).all()) and bool((got[0, 5] == 0).all())
    oracle = np.asarray(ref.baos_mx_quant_ref(
        jnp.asarray(_g(x.float().numpy())).astype(getattr(jnp, dtype)),
        jnp.asarray(_g(c.numpy())), jnp.asarray(_g(f.numpy())), fmt
    ).astype(jnp.float32))
    np.testing.assert_array_equal(_g(got.float().numpy()), oracle)


def _np_baos_mx_quant(x: np.ndarray, c: np.ndarray, f: np.ndarray,
                      fmt: str) -> np.ndarray:
    """core/mx's rule transcribed to numpy f32 (no flush to zero, exact
    np.ldexp powers of two): (x - c)/f, then the MX fake-quant of each
    32-block along the last axis, in f32."""
    fm = jmx.FORMATS[fmt]
    xs = ((x - c) / f).astype(np.float32)
    xb = xs.reshape(*xs.shape[:-1], -1, 32)
    amax = np.abs(xb).max(-1, keepdims=True)
    safe = np.where(amax > 0, amax, np.float32(1))
    e = np.clip(np.ceil(np.log2(safe / np.float32(fm.grid_max))), -127, 127)
    scale = np.where(amax > 0, np.ldexp(np.float32(1), e.astype(np.int32)),
                     np.float32(1)).astype(np.float32)
    y = (xb / scale).astype(np.float32)
    if fm.is_int:
        t = y * np.float32(2 ** fm.frac_bits)
        lo, hi = -(2 ** (fm.element_bits - 1)), 2 ** (fm.element_bits - 1) - 1
        q = np.clip(np.sign(t) * np.floor(np.abs(t) + np.float32(0.5)), lo, hi)
        q = (q * np.float32(2.0 ** -fm.frac_bits)).astype(np.float32)
    else:
        q = np.clip(y, -448, 448).astype(ml_dtypes.float8_e4m3fn).astype(
            np.float32)
    with np.errstate(over="ignore"):
        return (q * scale).astype(np.float32).reshape(xs.shape), e


def _exact_exp2(e):
    """2^e exactly for integer-valued e in [-126, 127], from the exponent
    bits (XLA's CPU exp2 is off by several ulp for most |e| >= 13)."""
    return jax.lax.bitcast_convert_type(
        jnp.left_shift(e.astype(jnp.int32) + 127, 23), jnp.float32)


@pytest.mark.parametrize("fmt", KV_FORMATS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_baos_plain_at_exponent_extremes(fmt, dtype, monkeypatch):
    """Blocks at both ends of the E8M0 range, with identity calibration:
    amax 3.385e38 (for the integer formats ceil(log2(amax / grid_max)) is
    128 and clips to 127; mxfp8 reaches 120) and amax <= 1.1e-39, subnormal
    values whose exponent clips to -127, beside zero and ordinary blocks.
    The plain version, bit for bit, vs a numpy transcription of the rule
    everywhere, and vs the JAX oracle kernels/ref.baos_mx_quant_ref off the
    bottom blocks, run op by op with XLA's CPU exp2 replaced by the exact
    power of two (XLA's exp2 is inexact there, and XLA flushes the
    subnormal bottom blocks to zero)."""
    B, S, H, D = 1, 5, 2, 128
    for seed in itertools.count(50):
        rs = np.random.RandomState(seed)
        x = rs.randn(B, S, H, D // 32, 32).astype(np.float32)
        top = np.where(rs.rand(*x.shape) < 0.5, -1, 1) * 3.385e38 * \
            rs.uniform(0.5, 1.0, x.shape)
        top[..., 0] = 3.385e38
        x[:, :, :, 0] = 0.0
        x[:, :, :, 1] = top[:, :, :, 1]
        x[:, :, :, 2] = np.clip(x[:, :, :, 2], -1, 1) * np.float32(1.1e-39)
        xt = torch.from_numpy(x.reshape(B, S, H, D)).to(getattr(torch, dtype))
        x = xt.float().numpy()
        if _far_from_scale_edges(x, fmt):
            break
    c = np.zeros((B, 1, H, D), np.float32)
    f = np.ones((B, 1, H, D), np.float32)
    got = tbq.baos_mx_quant(xt, torch.from_numpy(c), torch.from_numpy(f),
                            fmt).float().numpy()
    want, e = _np_baos_mx_quant(x, c, f, fmt)
    want = torch.from_numpy(want).to(xt.dtype).float().numpy()
    np.testing.assert_array_equal(got, want)
    e = e[..., 0].reshape(B, S, H, D // 32)
    assert (e[..., 2] == -127).all()
    assert (e[..., 1] == (120 if fmt == "mxfp8_e4m3" else 127)).all()
    monkeypatch.setattr(jnp, "exp2", _exact_exp2)
    with jax.disable_jit():
        oracle = np.asarray(ref.baos_mx_quant_ref(
            jnp.asarray(_g(x)).astype(getattr(jnp, dtype)),
            jnp.asarray(_g(c)), jnp.asarray(_g(f)), fmt
        ).astype(jnp.float32))
    keep = np.arange(D) // 32 % 4 != 2
    np.testing.assert_array_equal(_g(got)[..., keep], oracle[..., keep])


def test_query_output_fusion_and_dequantize_match():
    """scale_query, correct_output (GQA 6 query heads over 2 KV heads) and
    dequantize_kv vs JAX."""
    rs = np.random.RandomState(5)
    cal = [rs.rand(2, 1, 2, 16).astype(np.float32) + 0.5 for _ in range(4)]
    q = rs.randn(2, 5, 6, 16).astype(np.float32)
    ks = rs.randn(2, 5, 2, 16).astype(np.float32)
    vs = rs.randn(2, 5, 2, 16).astype(np.float32)
    cj = jbaos.BAOSCalib(*(jnp.asarray(a) for a in cal))
    ct = tbaos.BAOSCalib(*(torch.from_numpy(a) for a in cal))
    pairs = [(tbaos.scale_query(torch.from_numpy(q), ct, 6),
              jbaos.scale_query(jnp.asarray(q), cj, 6)),
             (tbaos.correct_output(torch.from_numpy(q), ct, 6),
              jbaos.correct_output(jnp.asarray(q), cj, 6))]
    pairs += list(zip(tbaos.dequantize_kv(torch.from_numpy(ks),
                                          torch.from_numpy(vs), ct),
                      jbaos.dequantize_kv(jnp.asarray(ks), jnp.asarray(vs),
                                          cj)))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    ident = tbaos.identity_calib(2, 2, 16)
    assert bool((ident.k_center == 0).all()) and bool((ident.v_scale == 1).all())


# every name core/mx knows, aliases included, and one it does not
KV_NAMES = sorted(tmx.FORMATS) + ["mxfp3"]


@pytest.mark.parametrize("fmt", KV_NAMES)
def test_unported_kv_formats_raise(fmt):
    """Every KV format core/mx knows is accepted and has a kernel format
    code (mxfp6/mxfp4 since the kernel learned their grids); a name it
    does not know is refused, as JAX's lookup refuses it."""
    cfg = tbaos.BAOSConfig(kv_format=fmt)
    if fmt not in tmx.FORMATS:
        with pytest.raises(ValueError, match="unknown"):
            tbaos.check_supported(cfg)
        with pytest.raises(KeyError):
            jmx.mx_fake_quant(jnp.zeros((32,)), fmt)
    else:
        tbaos.check_supported(cfg)
        assert tmx.FORMATS[fmt].name in tbaos.KV_FORMATS
        assert tmx.FORMATS[fmt].name in tbq.FMT_CODES
    tbaos.check_supported(tbaos.BAOSConfig(enabled=False, kv_format=fmt))


# the KV formats beyond the Pallas kernel's three: the fp6/fp4 grids and
# the bf16 / none pseudo-formats, which JAX's model path writes through
# core/mx (the Pallas kernel casts non-integer formats through e4m3)
GRID_FORMATS = ["mxfp6_e3m2", "mxfp4_e2m1", "bf16", "none"]


@pytest.mark.parametrize("fmt", GRID_FORMATS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smooth_quantize_grid_formats_bit_exact(fmt, dtype):
    """core/baos.smooth_quantize (the kernel's plain version on the CPU) vs
    JAX's smooth_quantize, the function the JAX model path writes its cache
    with, bit for bit; zero and D-32 blocks included."""
    scale_fmt = fmt if fmt.startswith("mx") else "mxint4"
    xt, c, f = _kv_inputs(2, 20, 3, 64, scale_fmt, dtype,
                          seed=GRID_FORMATS.index(fmt))
    xt[:, :, 1, :32] = 0
    bj = jbaos.BAOSConfig(kv_format=fmt)
    bt = tbaos.BAOSConfig(kv_format=fmt)
    got = tbaos.smooth_quantize(xt, torch.from_numpy(c), torch.from_numpy(f),
                                bt)
    want = jbaos.smooth_quantize(jnp.asarray(xt.float().numpy()).astype(
        getattr(jnp, dtype)), jnp.asarray(c), jnp.asarray(f), bj)
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.fixture(scope="module")
def dense_models():
    from repro.configs import base as jcfg
    from repro.models.registry import build_model as jbuild
    from repro_torch import bridge
    from repro_torch.configs import base as tcfg
    from repro_torch.models.registry import build_model as tbuild
    cfg_j = jcfg.get_config("llada-8b", smoke=True)
    cfg_t = tcfg.get_config("llada-8b", smoke=True)
    model_j, model_t = jbuild(cfg_j), tbuild(cfg_t, "cpu")
    params_j = model_j.init(jax.random.PRNGKey(0))
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        cfg_t, "cpu")
    return model_j, model_t, params_j, params_t


@pytest.mark.parametrize("fmt", ["mxfp6_e3m2", "mxfp4_e2m1"])
def test_warm_step_with_grid_kv_format_matches(dense_models, fmt):
    """A warm step (the whole sequence: calibrate, write the smoothed fp6 /
    fp4 cache, attend over it) vs JAX's warm_step: the calibration, the
    cache and the active block's hidden states.  K/V computed 1e-7 apart
    (GEMM summation order) may round to neighbouring grid points on a
    rounding edge: at most one element in 10^3 may differ, by at most one
    grid step (0.5 on fp4's grid at a block amax of 1, the largest a
    minmax-smoothed value reaches)."""
    from repro.core import diffusion as jdiff
    from repro_torch.core import diffusion as tdiff
    model_j, model_t, params_j, params_t = dense_models
    cfg = model_t.cfg
    B, S, L, bs = 2, 40, 8, 16
    x = np.random.RandomState(7).randint(0, cfg.vocab - 2, size=(B, S))
    x = x.astype(np.int32)
    x[:, bs:] = cfg.mask_id
    kw = dict(gen_length=24, block_length=L, steps_per_block=4,
              cache_mode="dual")
    dj = jdiff.DiffusionConfig(baos=jbaos.BAOSConfig(kv_format=fmt), **kw)
    dt = tdiff.DiffusionConfig(baos=tbaos.BAOSConfig(kv_format=fmt), **kw)
    want, cache_j = jdiff.warm_step(model_j, params_j, jnp.asarray(x),
                                    model_j.init_cache(B, S), bs, dj,
                                    head_mode="hidden")
    got, cache_t = tdiff.warm_step(model_t, params_t, torch.from_numpy(x),
                                   model_t.init_cache(B, S), bs, dt,
                                   head_mode="hidden")
    for name in tbaos.BAOSCalib._fields:
        np.testing.assert_allclose(cache_t[name].numpy(),
                                   np.asarray(cache_j[name]), rtol=1e-4,
                                   atol=1e-5)
    for name in ("k", "v"):
        diff = np.abs(cache_t[name].numpy() - np.asarray(cache_j[name]))
        assert (diff > 0).mean() <= 1e-3 and diff.max() <= 0.5, name
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=5e-3)

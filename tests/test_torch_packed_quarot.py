"""Table 5's KV storage functions of the port against the JAX package's,
on the CPU: core/quarot.py (the Hadamard matrix exactly; rotate, unrotate
and quarot_quantize_kv), core/packed.py (pack's codes and exponents,
unpack, packed_bytes, compression_ratio) and
core/baos.outlier_channel_overlap, on data without ties; the port's own
guarantee unpack(pack(x)) == mx_fake_quant(x) bit for bit; and attention
over an unpacked cache equal to attention over the fake-quant cache.

Tolerances (f32): the rotations rtol 1e-5, atol 1e-6 (two summation
orders).  pack on the same values gives JAX's codes and exponents
exactly.  After a rotation the two packages' inputs to the quantizer
differ by rounding, so, as for the MX formats of the KV cache, an element
on a rounding edge may land on the neighbouring grid point: at most one
element in 1,000 may differ, by at most one grid step of its block.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baos as jbaos
from repro.core import mx as jmx
from repro.core import packed as jpacked
from repro.core import quarot as jquarot
from repro_torch.core import baos as tbaos
from repro_torch.core import mx as tmx
from repro_torch.core import packed as tpacked
from repro_torch.core import quarot as tquarot
from repro_torch.kernels import flash_bidir as fb

torch.set_num_threads(1)

FORMATS = ["mxint4", "mxint8"]


def _kv(shape, seed=0):
    """(B, S, H, D) f32 with per-channel spreads and a few outlier
    channels (what Table 5 smooths)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape) * rs.uniform(0.2, 4.0, (1, 1) + shape[2:])
    x[..., 3] *= 20.0
    return x.astype(np.float32)


@pytest.mark.parametrize("dim", [16, 64, 128, 256])
@pytest.mark.parametrize("seed", [0, 5])
def test_hadamard_matrix_equals_jax(dim, seed):
    got = tquarot.hadamard_matrix(dim, seed)
    np.testing.assert_array_equal(got, jquarot.hadamard_matrix(dim, seed))
    np.testing.assert_allclose(got @ got.T, np.eye(dim), atol=1e-12)
    with pytest.raises(ValueError, match="power of 2"):
        tquarot.hadamard_matrix(48)


def test_rotate_unrotate_match_jax():
    x = _kv((2, 24, 4, 64))
    got = tquarot.rotate(torch.from_numpy(x), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jquarot.rotate(
        jnp.asarray(x), 3)), rtol=1e-5, atol=1e-6)
    back = tquarot.unrotate(got, 3)
    np.testing.assert_allclose(back.numpy(), np.asarray(jquarot.unrotate(
        jquarot.rotate(jnp.asarray(x), 3), 3)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-5, atol=1e-5)
    # Q_r K_rᵀ = Q Kᵀ
    q, k = torch.from_numpy(_kv((2, 24, 4, 64), 1)), torch.from_numpy(x)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    s_r = torch.einsum("bqhd,bkhd->bhqk", tquarot.rotate(q, 3),
                       tquarot.rotate(k, 3))
    np.testing.assert_allclose(s_r.numpy(), s.numpy(), rtol=1e-4, atol=1e-3)


def _grid_step(x_rotated_jax: np.ndarray, fmt: str) -> np.ndarray:
    """Each element's grid step in JAX's quantization of its block."""
    p = jpacked.pack(jnp.asarray(x_rotated_jax), fmt)
    scale = np.exp2(np.asarray(p.exponents, np.float32) - 127.0)
    step = scale * 2.0 ** -jmx.FORMATS[fmt].frac_bits
    return np.repeat(step, 32, axis=-1)[..., :x_rotated_jax.shape[-1]]


@pytest.mark.parametrize("fmt", FORMATS)
def test_quarot_quantize_kv_matches_jax(fmt):
    k, v = _kv((2, 32, 4, 64), 2), _kv((2, 32, 4, 64), 3)
    got = tquarot.quarot_quantize_kv(torch.from_numpy(k),
                                     torch.from_numpy(v), fmt, seed=1)
    want = jquarot.quarot_quantize_kv(jnp.asarray(k), jnp.asarray(v), fmt,
                                      seed=1)
    for g, w, x in zip(got, want, (k, v)):
        w = np.asarray(w)
        diff = np.abs(g.numpy() - w)
        step = _grid_step(np.asarray(jquarot.rotate(jnp.asarray(x), 1)), fmt)
        assert (diff > 0).mean() <= 1e-3
        assert (diff <= step * (1 + 1e-6)).all()


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("shape", [(2, 8, 4, 64), (3, 5, 40), (7, 33)])
def test_pack_matches_jax(fmt, shape):
    """Codes and exponents equal JAX's on the same values, a ragged last
    axis (40, 33) included; unpack equals JAX's unpack."""
    x = np.random.RandomState(len(shape)).randn(*shape).astype(np.float32)
    x *= np.float32(3.0)
    got = tpacked.pack(torch.from_numpy(x), fmt)
    want = jpacked.pack(jnp.asarray(x), fmt)
    assert got.codes.dtype == got.exponents.dtype == torch.uint8
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.exponents.numpy(),
                                  np.asarray(want.exponents))
    assert (got.fmt_name, got.orig_last) == (want.fmt_name, want.orig_last)
    assert got.nbytes == want.nbytes
    if shape[-1] % 32 == 0:       # nbytes counts a ragged block's padding
        assert got.nbytes == tpacked.packed_bytes(shape, fmt)
    np.testing.assert_array_equal(tpacked.unpack(got).numpy(),
                                  np.asarray(jpacked.unpack(want)))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("shape", [(4, 96, 32, 128), (3, 7, 40), (5, 1)])
def test_packed_bytes_and_ratio_match_jax(fmt, shape):
    assert tpacked.packed_bytes(shape, fmt) == jpacked.packed_bytes(shape,
                                                                    fmt)
    assert tpacked.compression_ratio(shape, fmt) == \
        jpacked.compression_ratio(shape, fmt)


def test_pack_refuses_float_formats():
    with pytest.raises(ValueError, match="MXINT"):
        tpacked.pack(torch.zeros(4, 32), "mxfp8_e4m3")


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unpack_pack_is_fake_quant_bit_for_bit(fmt, dtype):
    """The port's guarantee: unpack(pack(x)) == mx_fake_quant(x), zero
    blocks, extreme exponents and a ragged last axis included."""
    x = torch.from_numpy(_kv((2, 9, 3, 72), 4)).to(dtype)
    x[0, 0, 0, :32] = 0.0
    x[1, 1, 1, 32:64] *= 2.0 ** 60
    x[1, 2, 2, :32] *= 2.0 ** -60
    got = tpacked.unpack(tpacked.pack(x, fmt), dtype=dtype)
    want = tmx.mx_fake_quant(x, fmt)
    assert got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("fmt", FORMATS)
def test_attention_over_unpacked_cache(fmt):
    """Attention over the unpacked cache equals attention over the
    fake-quant cache bit for bit (the packed cache replaces the emulated
    one without changing a value)."""
    q = torch.from_numpy(_kv((2, 16, 8, 64), 5))
    k, v = (torch.from_numpy(_kv((2, 48, 2, 64), s)) for s in (6, 7))
    valid = torch.arange(48)[None, :] < torch.tensor([[48], [30]])
    packed = [tpacked.unpack(tpacked.pack(t, fmt)) for t in (k, v)]
    fake = [tmx.mx_fake_quant(t, fmt) for t in (k, v)]
    assert torch.equal(fb.flash_bidir(q, *packed, valid),
                       fb.flash_bidir(q, *fake, valid))


@pytest.mark.parametrize("top_frac", [0.01, 0.05, 0.25])
def test_outlier_channel_overlap_matches_jax(top_frac):
    warm = _kv((2, 24, 4, 64), 8)
    refine = warm + np.random.RandomState(9).randn(*warm.shape).astype(
        np.float32) * 0.5
    got = tbaos.outlier_channel_overlap(torch.from_numpy(warm),
                                        torch.from_numpy(refine), top_frac)
    want = jbaos.outlier_channel_overlap(jnp.asarray(warm),
                                         jnp.asarray(refine), top_frac)
    assert got.dtype == torch.float32
    assert float(got) == float(want)
    assert 0.0 < float(got) <= 1.0
    assert float(tbaos.outlier_channel_overlap(
        torch.from_numpy(warm), torch.from_numpy(warm), top_frac)) == 1.0
    assert jax.numpy.isfinite(want)

"""MX fake-quant of the PyTorch port vs the JAX package, bit for bit, and
the rest of core/mx (mx_quantize, mx_dequantize, quant_error,
storage_bytes, the kernels' format codes) in each format.  Codes, scales
and byte counts are exact; quant_error, a ratio of two norms summed in
other orders, within rtol 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mx as jmx
from repro_torch.core import mx as tmx

torch.set_num_threads(1)


def _blocks(seed: int) -> np.ndarray:
    """(4, 100) f32: random rows (100 is not a multiple of the 32-wide
    block), one all-zero block, and one overflow block whose max is one ulp
    above 448 * 2^4.  There log2(amax / 448) rounds to exactly 4 on both
    backends, so the scaled max lands above 448 and the mxfp8 clip
    saturates it.  (Subnormal and near-f32-max blocks are left out: XLA's
    CPU backend flushes subnormals to zero and its exp2 is not exact at
    2^117, where torch's is; sampling logits never go there.)"""
    rs = np.random.RandomState(seed)
    x = (rs.randn(4, 100) * 6).astype(np.float32)
    x[1, 32:64] = 0.0
    x[2, :32] = np.clip(rs.randn(32) * 2000, -7000, 7000)
    x[2, 5] = np.nextafter(np.float32(448 * 16), np.float32(np.inf))
    return x


def _as_bf16(x: np.ndarray):
    t = torch.from_numpy(x).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


FMTS = ["none", "bf16", "mxfp8_e4m3", "mxint8", "mxint4", "mxfp6_e3m2",
        "mxfp4_e2m1"]


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mx_fake_quant_bit_exact(fmt, dtype):
    x = _blocks(FMTS.index(fmt) + (dtype == "bfloat16") * 10)
    if dtype == "float32":
        xt, xj = torch.from_numpy(x), jnp.asarray(x)
    else:
        xt, xj = _as_bf16(x)
    got = tmx.mx_fake_quant(xt, fmt)
    want = np.asarray(jmx.mx_fake_quant(xj, fmt).astype(jnp.float32))
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_mx_fake_quant_along_axis_0():
    x = _blocks(7).T.copy()
    got = tmx.mx_fake_quant(torch.from_numpy(x), "mxfp8_e4m3", axis=0)
    want = np.asarray(jmx.mx_fake_quant(jnp.asarray(x), "mxfp8_e4m3",
                                        axis=0))
    np.testing.assert_array_equal(got.numpy(), want)


def test_mxfp8_saturates_where_the_cast_would_overflow():
    """The explicit clip to +-448 before the e4m3 cast: an element above
    the grid maximum after scaling saturates instead of becoming NaN."""
    x = torch.tensor([[500.0, -600.0, 448.0, 1.0]])
    q = tmx._quant_element(x, tmx.MXFP8)
    np.testing.assert_array_equal(q.numpy(), [[448.0, -448.0, 448.0, 1.0]])
    want = np.asarray(jmx._quant_element(jnp.asarray(x.numpy()), jmx.MXFP8))
    np.testing.assert_array_equal(q.numpy(), want)


def _inverse_scale_inputs(kind: str) -> np.ndarray:
    """f32 values for the exact-inverse test: random magnitudes over the
    whole normal range, the largest normals, the smallest normals, and
    values whose quotients by 2^e land in the subnormal range."""
    rs = np.random.RandomState(11)
    sign = np.where(rs.rand(4096) < 0.5, -1.0, 1.0)
    mant = 1.0 + rs.randint(0, 2 ** 23, 4096) / 2.0 ** 23
    if kind == "random":
        exp = rs.randint(-126, 128, 4096)
    elif kind == "largest_normal":
        mant[:2] = 2.0 - 2.0 ** -23                  # FLT_MAX itself
        exp = np.full(4096, 127)
    elif kind == "smallest_normal":
        mant[:2] = 1.0                               # FLT_MIN itself
        exp = np.full(4096, -126)
    else:                                            # subnormal results
        exp = rs.randint(-126, -90, 4096)
    return (sign * np.ldexp(mant, exp)).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "largest_normal",
                                  "smallest_normal", "subnormal_results"])
def test_inverse_power_of_two_scale_is_exact(kind):
    """The kernels' premise: x * 2^-e equals the plain version's quotient
    x / 2^e bit for bit in torch f32, for every integer e in [-127, 127]
    (2^-127 and the quotients below 2^-126 are subnormal, the largest
    normals overflow alike), and torch.exp2(e), the plain version's scale,
    is exactly 2^e."""
    x = torch.from_numpy(_inverse_scale_inputs(kind))
    es = np.arange(-127, 128)
    scales = np.ldexp(np.float32(1), es).astype(np.float32)
    np.testing.assert_array_equal(
        torch.exp2(torch.from_numpy(es.astype(np.float32))).numpy(), scales)
    n_subnormal = 0
    for e, scale in zip(es, scales):
        inv = torch.tensor(np.ldexp(np.float32(1), -e).astype(np.float32))
        quot = x / torch.full_like(x, scale)
        prod = x * inv
        assert torch.equal(prod.view(torch.int32), quot.view(torch.int32)), e
        n_subnormal += int(((quot != 0) & (quot.abs() < 2.0 ** -126)).sum())
    assert kind != "subnormal_results" or n_subnormal > 10000


MX_FMTS = ["mxfp8_e4m3", "mxint8", "mxint4", "mxfp6_e3m2", "mxfp4_e2m1"]


@pytest.mark.parametrize("fmt", MX_FMTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mx_quantize_and_dequantize_bit_exact(fmt, dtype):
    """Element codes (..., nblocks, 32) and E8M0 scales (..., nblocks, 1)
    equal JAX's; dequantized (cut to n) they are the fake-quant."""
    x = _blocks(MX_FMTS.index(fmt) + 20)
    xt, xj = ((torch.from_numpy(x), jnp.asarray(x)) if dtype == "float32"
              else _as_bf16(x))
    codes, scale = tmx.mx_quantize(xt, fmt)
    jcodes, jscale = jmx.mx_quantize(xj, fmt)
    assert tuple(codes.shape) == jcodes.shape == (4, 4, 32)
    assert tuple(scale.shape) == jscale.shape == (4, 4, 1)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    back = tmx.mx_dequantize(codes, scale, n=100)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jmx.mx_dequantize(jcodes, jscale, n=100)))
    np.testing.assert_array_equal(
        back.numpy(), tmx.mx_fake_quant(xt, fmt).float().numpy())
    assert tmx.mx_dequantize(codes, scale, dtype=torch.bfloat16).dtype == \
        torch.bfloat16


@pytest.mark.parametrize("fmt", ["none", "bf16"])
def test_mx_quantize_refuses_pseudo_formats_as_jax(fmt):
    """none and bf16 have no element grid: mx_quantize raises ValueError
    in both packages."""
    x = _blocks(3)
    with pytest.raises(ValueError, match="unknown element format"):
        tmx.mx_quantize(torch.from_numpy(x), fmt)
    with pytest.raises(ValueError, match="unknown element format"):
        jmx.mx_quantize(jnp.asarray(x), fmt)


@pytest.mark.parametrize("fmt", sorted(tmx.FORMATS))
def test_quant_error_and_storage_bytes_match_jax(fmt):
    """Every name and alias of FORMATS: the relative L2 error of the
    fake-quant (rtol 1e-6), storage bytes of several shapes (ragged last
    blocks included, exact), the bits per element, and the kernels' code
    of the format."""
    x = _blocks(sorted(tmx.FORMATS).index(fmt) + 40)
    got = float(tmx.quant_error(torch.from_numpy(x), fmt))
    want = float(jmx.quant_error(jnp.asarray(x), fmt))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for shape in ((100,), (4, 100), (3, 5, 32), (7, 1)):
        assert tmx.storage_bytes(shape, fmt) == jmx.storage_bytes(shape, fmt)
    assert tmx.FORMATS[fmt].bits_per_element == \
        jmx.FORMATS[fmt].bits_per_element
    assert tmx.fmt_code(fmt) == tmx.FMT_CODES[tmx.FORMATS[fmt].name]


def test_format_codes_cover_every_format():
    """Each canonical format has its own code (csrc/common.cuh Fmt, 0-6);
    an unknown name raises ValueError."""
    assert sorted(tmx.FMT_CODES.values()) == list(range(7))
    assert {f.name for f in tmx.FORMATS.values()} == set(tmx.FMT_CODES)
    with pytest.raises(ValueError, match="unknown MX format"):
        tmx.fmt_code("mxint3")

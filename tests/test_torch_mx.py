"""MX fake-quant of the PyTorch port vs the JAX package, bit for bit."""
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

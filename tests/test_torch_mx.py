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

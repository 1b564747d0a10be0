"""Bidirectional attention of the PyTorch port (plain version, the CPU
side of kernels/flash_bidir.py) vs the JAX model's layers.attention, the
flash_bidir oracle and the Pallas kernel in interpret mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.models import layers as jlayers
from repro_torch.kernels import flash_bidir as tfb
from repro_torch.models import layers as tlayers

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _qkv(B, Sq, Skv, Hq, Hkv, D, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, Sq, Hq, D).astype(np.float32),
            rs.randn(B, Skv, Hkv, D).astype(np.float32),
            rs.randn(B, Skv, Hkv, D).astype(np.float32))


@pytest.mark.parametrize("Skv", [64, 40])     # kv_chunk 32 divides / not
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 2), (6, 1)])
def test_attention_matches_model_attention(Skv, Hq, Hkv):
    """Mixed-length rows and one row with no valid key (which averages
    every key, as the reference does)."""
    B, D = 3, 16
    q, k, v = _qkv(B, Skv, Skv, Hq, Hkv, D, seed=Skv + Hq * 7 + Hkv)
    valid = np.arange(Skv)[None, :] < np.array([[Skv], [Skv // 3], [0]])
    pos = jnp.broadcast_to(jnp.arange(Skv)[None], (B, Skv))
    want = jlayers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             q_pos=pos, kv_pos=pos,
                             kv_valid=jnp.asarray(valid), kv_chunk=32)
    got = tlayers.attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("Hq,Hkv", [(4, 2), (2, 2)])
def test_flash_plain_matches_oracle_and_pallas(window, Hq, Hkv):
    """BAOS fusion (fk, fv, cv) and the local window: the oracle and the
    Pallas kernel (Skv a multiple of its KV block, which it requires)."""
    B, S, D = 2, 32, 16
    q, k, v = _qkv(B, S, S, Hq, Hkv, D, seed=3 + Hq + (window or 0))
    rs = np.random.RandomState(9)
    fk = (rs.rand(B, Hkv, D) + 0.5).astype(np.float32)
    fv = (rs.rand(B, Hkv, D) + 0.5).astype(np.float32)
    cv = rs.randn(B, Hkv, D).astype(np.float32)
    args_j = [jnp.asarray(a) for a in (q, k, v, fk, fv, cv)]
    want = ref.flash_bidir_ref(*args_j, window=window)
    kern = ops.flash_attention(*args_j, window=window, bq=16, bk=16,
                               interpret=True)
    got = tfb.flash_bidir(*(torch.from_numpy(a) for a in (q, k, v)), None,
                          *(torch.from_numpy(a) for a in (fk, fv, cv)),
                          window=window)
    for w in (want, kern):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_flash_rejects_mismatched_shapes():
    q, k, v = _qkv(1, 4, 6, 3, 2, 8, seed=0)
    with pytest.raises(ValueError):
        tfb.flash_bidir(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v))
    with pytest.raises(ValueError):
        tfb.flash_bidir(torch.zeros(1, 4, 2, 8), torch.zeros(1, 6, 2, 8),
                        torch.zeros(1, 6, 2, 8), torch.ones(1, 5, dtype=bool))

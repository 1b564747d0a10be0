"""The three kernel limits the port lifted, held against the JAX package on
the CPU (where the wrappers run their plain versions, and the card's
routes are pure functions of the shapes):

  * topk_mask at any block length: the plain version at L 65, 128 and 256
    against JAX's Pallas kernel in interpret mode, and ``route(L)``;
  * the fused head at a vocabulary that is not a multiple of 8: the
    ``padded_vocab`` plan, the zero-padded head ``pad_head`` stores once,
    and the plain version at V 257 on that padded head against JAX's
    Pallas kernel in interpret mode;
  * flash_bidir at head dims 16, 96 and 256 (recurrentgemma-2b's attention
    layout: 10 query heads on 1 KV head, window 2048) against the JAX
    model's layers.attention, ``route(D, dtype)``, and the head dims it
    once refused (4, 12, 260, 512), which it now runs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sampling as js
from repro.kernels import ops
from repro.models import layers as jlayers
from repro_torch.configs import base as tbase
from repro_torch.kernels import flash_bidir as tfb
from repro_torch.kernels import fused_head_sampling as tfh
from repro_torch.kernels import topk_mask as ttk
from repro_torch.models import layers as tlayers
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import build_model as tbuild

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# topk_mask at any L
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k_dtype", ["int32", "int64"])
@pytest.mark.parametrize("R,L", [(3, 65), (5, 128), (6, 256)])
def test_topk_long_rows_match_pallas(R, L, k_dtype):
    """Rows past the warp route's 64: exact ties, a row with nothing
    masked, k past L; 0 positions differ from the Pallas kernel."""
    rs = np.random.RandomState(R * 1000 + L)
    conf = (np.round(rs.randn(R, L) * 2) / 2 + 0.0).astype(np.float32)
    mask = rs.rand(R, L) < 0.6
    mask[0] = True
    mask[1] = False
    k = rs.randint(0, L + 2, size=R).astype(k_dtype)
    k[0] = L // 2
    got = ttk.topk_mask(torch.from_numpy(conf), torch.from_numpy(mask),
                        torch.from_numpy(k))
    kern = np.asarray(ops.transfer_mask(
        jnp.asarray(conf), jnp.asarray(mask),
        jnp.asarray(k.astype(np.int32)), interpret=True))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), kern)
    np.testing.assert_array_equal(got.numpy().sum(1),
                                  np.minimum(k, mask.sum(1)))


def test_topk_route_covers_every_length():
    routes = [ttk.route(L) for L in range(1, 1001)]
    assert routes[:64] == ["warp"] * 64
    assert routes[64:] == ["cta"] * (1000 - 64)
    with pytest.raises(ValueError):
        ttk.route(0)


# ---------------------------------------------------------------------------
# the fused head at a ragged vocabulary
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("V,want", [(257, 264), (1003, 1008),
                                    (122753, 122760), (126464, 126464)])
def test_padded_vocab(V, want):
    assert tfh.padded_vocab(V) == want
    assert want % tfh.ROW_ALIGN == 0 and 0 <= want - V < tfh.ROW_ALIGN


def test_pad_head_stores_zero_padded_rows_once():
    w = torch.randn(24, 257)
    p = tfh.pad_head(w)
    assert p.shape == w.shape and torch.equal(p, w)
    assert p.stride() == (264, 1)
    full = tfh.head_storage(p)
    assert full.shape == (24, 264) and not bool(full[:, 257:].any())
    aligned = torch.randn(24, 256)
    assert tfh.pad_head(aligned) is aligned
    assert tfh.head_storage(aligned).data_ptr() == aligned.data_ptr()


@pytest.mark.parametrize("fmt", ["none", "bf16", "mxfp8_e4m3"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_fused_head_ragged_vocab_matches_pallas(fmt, temperature):
    """V 257 (minicpm-2b's smoke vocabulary; the full one is 122753): the
    plain version on the padded head, whose last MX block is ragged and
    whose pad holds zeros, against the Pallas kernel (which pads V to its
    chunk and masks the pad).  Tokens equal except at a near-tie, the rule
    of the fused head's tests (here none occurs); conf within 1e-5."""
    R, d, V, sup = 11, 32, 257, 256
    rs = np.random.RandomState(V + int(temperature * 10))
    h = rs.randn(R, d).astype(np.float32)
    w = (rs.randn(d, V) * 4 / np.sqrt(d)).astype(np.float32)
    seed = int(js.gumbel_seed(jax.random.PRNGKey(3)))
    wt = tfh.pad_head(torch.from_numpy(w))
    assert wt.stride(0) == 264
    conf, tok = tfh.fused_head_sampling(
        torch.from_numpy(h), wt, fmt=fmt, suppress_id=sup,
        temperature=temperature, seed=seed)
    kc, kt = ops.fused_head_sampling(
        jnp.asarray(h), jnp.asarray(w), fmt=fmt, suppress_id=sup,
        temperature=temperature, seed=jnp.uint32(seed), chunk_v=128,
        interpret=True)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(kt))
    np.testing.assert_allclose(conf.numpy(), np.asarray(kc), rtol=1e-5)
    c2, t2 = tfh.fused_head_sampling(
        torch.from_numpy(h), torch.from_numpy(w), fmt=fmt, suppress_id=sup,
        temperature=temperature, seed=seed)
    assert torch.equal(t2, tok) and torch.equal(c2, conf)


# ---------------------------------------------------------------------------
# flash_bidir at any head dim
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D,Hq,Hkv,window", [(16, 4, 2, None),
                                             (96, 6, 3, None),
                                             (256, 10, 1, 2048),
                                             (256, 10, 1, 7)])
def test_flash_head_dims_match_model_attention(D, Hq, Hkv, window):
    """D 256 at recurrentgemma-2b's layout (10 query heads, 1 KV head,
    window 2048; also a window of 7 that cuts), D 16 and 96 (run on the
    card in the 32- and 128-wide tiles); mixed-length rows and a row with
    no valid key; f32, rtol 1e-5 (atol 2e-6 for outputs near 0, where
    the two sum a 256-term dot product in another order)."""
    B, S = 3, 40
    rs = np.random.RandomState(D + Hq + (window or 0))
    q = rs.randn(B, S, Hq, D).astype(np.float32)
    k = rs.randn(B, S, Hkv, D).astype(np.float32)
    v = rs.randn(B, S, Hkv, D).astype(np.float32)
    valid = np.arange(S)[None, :] < np.array([[S], [S // 3], [0]])
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    want = jlayers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             q_pos=pos, kv_pos=pos, window=window,
                             kv_valid=jnp.asarray(valid), kv_chunk=16)
    got = tlayers.attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(valid),
                            window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-6)


@pytest.mark.parametrize("D,tile", [(8, 32), (16, 32), (32, 32), (40, 64),
                                    (96, 128), (128, 128), (136, 256),
                                    (256, 256)])
def test_flash_route(D, tile):
    assert tfb.route(D, torch.bfloat16) == ("tensor cores", tile)
    assert tfb.route(D, torch.float32) == ("CUDA cores", tile)


@pytest.mark.parametrize("D", [260, 12, 4, 512])
def test_unsupported_head_dims_raise_up_front(D):
    """The head dims the port once refused up front (past 256, or not a
    multiple of 8) now run: ``route`` names the kernel route that takes
    them (the CUDA-core route for a bf16 D that is not a multiple of 8,
    the wide route's column slices past 256), layers.attention equals the
    JAX model's on the CPU (f32, rtol 1e-5, atol 2e-6: the two sum a
    D-term dot product in another order), and build_model takes the
    config."""
    want = (tfb.WIDE_ROUTE, tfb.WIDE_SLICE) if D > 256 else \
        ("CUDA cores", 32)
    assert tfb.route(D, torch.bfloat16) == want
    B, S, Hq, Hkv = 2, 24, 4, 2
    rs = np.random.RandomState(D)
    q = rs.randn(B, S, Hq, D).astype(np.float32)
    k = rs.randn(B, S, Hkv, D).astype(np.float32)
    v = rs.randn(B, S, Hkv, D).astype(np.float32)
    valid = np.arange(S)[None, :] < np.array([[S], [S // 3]])
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    want_o = jlayers.attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), q_pos=pos, kv_pos=pos,
                               kv_valid=jnp.asarray(valid), kv_chunk=8)
    got = tlayers.attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_o), rtol=1e-5,
                               atol=2e-6)
    cfg = tbase.get_config("llada-8b", smoke=True)
    cfg = ModelConfig(**{**cfg.__dict__, "d_head": D})
    assert tbuild(cfg, "cpu").cfg.d_head == D

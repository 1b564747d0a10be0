"""Bidirectional attention of the PyTorch port (plain version, the CPU
side of kernels/flash_bidir.py) vs the JAX model's layers.attention, the
flash_bidir oracle and the Pallas kernel in interpret mode; with BAOS
calibration and a query segment at an offset into a longer cache."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baos as jbaos
from repro.kernels import ops, ref
from repro.models import layers as jlayers
from repro_torch.core import baos as tbaos
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


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("Hq,Hkv", [(4, 2), (2, 2)])
def test_baos_segment_attention_matches_model_attention(window, Hq, Hkv):
    """A refine step's attention: 8 query rows at positions 12..19 over a
    40-long smoothed cache with its BAOS calibration (f_k into the query,
    f_v, c_v onto the output) and ragged kv_valid.  In f32 the port's
    in-kernel f32 fusion and the JAX model's activation-dtype rounding are
    the same arithmetic."""
    B, Sq, Skv, D, off = 2, 8, 40, 16, 12
    q, k, v = _qkv(B, Sq, Skv, Hq, Hkv, D, seed=7 + Hq + (window or 0))
    valid = np.arange(Skv)[None, :] < np.array([[Skv], [30]])
    cal_j = jbaos.calibrate(jnp.asarray(k), jnp.asarray(v),
                            jbaos.BAOSConfig())
    ks, vs = (np.asarray(a) for a in jbaos.smooth_quantize_kv(
        jnp.asarray(k), jnp.asarray(v), cal_j, jbaos.BAOSConfig()))
    want = jlayers.attention(
        jnp.asarray(q), jnp.asarray(ks), jnp.asarray(vs),
        q_pos=jnp.broadcast_to(off + jnp.arange(Sq)[None], (B, Sq)),
        kv_pos=jnp.broadcast_to(jnp.arange(Skv)[None], (B, Skv)),
        kv_valid=jnp.asarray(valid), window=window, baos_calib=cal_j,
        kv_chunk=Skv)
    cal_t = tbaos.BAOSCalib(*(torch.from_numpy(np.asarray(a)) for a in cal_j))
    got = tlayers.attention(torch.from_numpy(q), torch.from_numpy(ks),
                            torch.from_numpy(vs), torch.from_numpy(valid),
                            window=window, baos_calib=cal_t, q_offset=off)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_baos_fusion_rounding_at_bf16():
    """The JAX model rounds q * f_k and out * f_v + c_v to the activation
    dtype; the port's kernel (and its plain version) apply them in f32 and
    round once.  At bf16 the two differ by a few bf16 ulp of the output
    (up to 1.3% of its largest value on these inputs, with per-channel
    offsets as in real K/V), and the port is the closer of the two to the
    same attention computed in f32 from the same bf16 inputs."""
    rs = np.random.RandomState(0)
    B, Sq, Skv, Hq, Hkv, D = 2, 16, 48, 8, 4, 64

    def kv():
        return (rs.randn(B, Skv, Hkv, D) * rs.uniform(0.2, 8, (1, 1, Hkv, D))
                + rs.randn(1, 1, Hkv, D) * 3).astype(np.float32)

    qb, kb, vb = (torch.from_numpy(a).bfloat16() for a in (
        rs.randn(B, Sq, Hq, D).astype(np.float32), kv(), kv()))
    cal = tbaos.calibrate(kb, vb, tbaos.BAOSConfig())
    ks, vs = tbaos.smooth_quantize_kv(kb, vb, cal, tbaos.BAOSConfig())
    cal_j = jbaos.BAOSCalib(*(jnp.asarray(c.numpy()) for c in cal))
    pos = jnp.broadcast_to(jnp.arange(Skv)[None], (B, Skv))

    def jax_attention(dtype):
        a = [jnp.asarray(t.float().numpy()).astype(dtype) for t in (qb, ks, vs)]
        out = jlayers.attention(*a, q_pos=pos[:, 8:8 + Sq], kv_pos=pos,
                                kv_valid=jnp.ones((B, Skv), bool),
                                baos_calib=cal_j, kv_chunk=Skv)
        return np.asarray(out.astype(jnp.float32))

    got = tlayers.attention(qb, ks, vs, baos_calib=cal, q_offset=8)
    got = got.float().numpy()
    want, exact = jax_attention(jnp.bfloat16), jax_attention(jnp.float32)
    top = np.abs(exact).max()
    assert np.abs(got - want).max() <= 0.02 * top
    assert np.abs(got - exact).max() <= np.abs(want - exact).max()


def _split_bf16(x: torch.Tensor, terms: int) -> list:
    """f32 x as ``terms`` bf16 values (held in f32) t_i =
    bf16(x - t_0 - ... - t_(i-1)): the operands the tensor-core route
    feeds for q * f_k and P."""
    out, r = [], x
    for _ in range(terms):
        t = r.to(torch.bfloat16).to(torch.float32)
        out.append(t)
        r = r - t
    return out


def _flash_split_emulation(q, k, v, kv_valid, fk, fv, cv, window, q_offset,
                           terms, tile=32):
    """The arithmetic of csrc/flash_bidir.cu's bf16 route in torch: K, V
    and (without f_k) q exact bf16, q * f_k split into ``terms`` bf16
    terms, scores as f32 sums of bf16 products (the smallest terms first)
    times D^-1/2, an online softmax over 32-key tiles with P split the same
    way, and out / max(l, 1e-30) * f_v + c_v in f32.  Returns f32."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qs = [q.float()]
    if fk is not None:
        qs = _split_bf16(q.float() * fk.repeat_interleave(G, dim=1)[:, None],
                         terms)
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    ok = torch.ones((B, 1, Sq, Skv), dtype=torch.bool)
    if kv_valid is not None:
        ok = ok & kv_valid[:, None, None, :]
    if window is not None:
        qp = q_offset + torch.arange(Sq)[:, None]
        ok = ok & ((qp - torch.arange(Skv)[None, :]).abs() < window)
    m = torch.full((B, Hq, Sq), -1e30)
    l = torch.zeros((B, Hq, Sq))
    o = torch.zeros((B, Hq, Sq, D))
    for t0 in range(0, Skv, tile):
        kt, vt = kf[:, t0:t0 + tile], vf[:, t0:t0 + tile]
        s = sum(torch.einsum("bqhd,bkhd->bhqk", qt, kt)
                for qt in reversed(qs)) * D ** -0.5
        s = torch.where(ok[..., t0:t0 + tile], s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + sum(
            torch.einsum("bhqk,bkhd->bhqd", pt, vt)
            for pt in reversed(_split_bf16(p, terms)))
        m = m_new
    out = (o / torch.clamp(l, min=1e-30)[..., None]).transpose(1, 2)
    if fv is not None:
        out = out * fv.repeat_interleave(G, dim=1)[:, None]
    if cv is not None:
        out = out + cv.repeat_interleave(G, dim=1)[:, None]
    return out


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each value of bf16 x (8 significant bits; 0 at 0)."""
    _, e = torch.frexp(x.float())
    ulp = torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)
    return torch.where(x == 0, 0.0, ulp)


@pytest.mark.parametrize(
    "Hq,Hkv,Sq,q_offset,window,baos,valid",
    [(7, 1, 48, 0, None, False, False), (7, 1, 48, 0, 5, True, False),
     (14, 2, 48, 0, None, True, True), (14, 2, 16, 12, 5, False, True),
     (7, 1, 16, 12, 5, True, True), (4, 4, 48, 0, None, False, True)])
def test_split_bf16_products_keep_the_f32_function(Hq, Hkv, Sq, q_offset,
                                                   window, baos, valid):
    """The split-bf16 design of flash_bidir's tensor-core route (one exact
    bf16 term for q without BAOS, three for q * f_k and for P), emulated
    in torch on bf16 inputs (Skv = 48: one full and one ragged 32-key
    tile; GQA G = 7; one batch row with no valid key): within 1e-5 of
    max|out| of the f32 plain version and of the Pallas kernel in
    interpret mode (which has no kv_valid and no query offset), and,
    rounded to bf16, within one bf16 ulp of the plain bf16 output."""
    B, Skv, D = 2, 48, 32
    rs = np.random.RandomState(Hq + Sq + (window or 0) + 2 * baos + valid)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(
        B, Sq, Skv, Hq, Hkv, D, seed=Hq * Sq + q_offset))
    kv_valid = None
    if valid:
        kv_valid = torch.from_numpy(np.arange(Skv)[None, :]
                                    < np.array([[37], [0]]))
    cal = [None] * 3
    if baos:
        cal = [torch.from_numpy(a.astype(np.float32)) for a in (
            rs.rand(B, Hkv, D) + 0.5, rs.rand(B, Hkv, D) + 0.5,
            rs.randn(B, Hkv, D))]
    emu = _flash_split_emulation(q, k, v, kv_valid, *cal, window, q_offset,
                                 tfb.SPLIT_TERMS)
    want = tfb.flash_bidir_plain(q.float(), k.float(), v.float(), kv_valid,
                                 *cal, window=window, q_offset=q_offset)
    top = float(want.abs().max())
    assert float((emu - want).abs().max()) <= 1e-5 * top
    if not valid and q_offset == 0:
        kern = np.asarray(ops.flash_attention(
            *(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
            *(None if c is None else jnp.asarray(c.numpy()) for c in cal),
            window=window, bq=16, bk=16, interpret=True))
        assert np.abs(emu.numpy() - kern).max() <= 1e-5 * top
    want16 = tfb.flash_bidir_plain(q, k, v, kv_valid, *cal, window=window,
                                   q_offset=q_offset).float()
    err = (emu.bfloat16().float() - want16).abs()
    assert bool((err <= _bf16_ulp(want16)).all())


def test_flash_rejects_mismatched_shapes():
    q, k, v = _qkv(1, 4, 6, 3, 2, 8, seed=0)
    with pytest.raises(ValueError):
        tfb.flash_bidir(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v))
    with pytest.raises(ValueError):
        tfb.flash_bidir(torch.zeros(1, 4, 2, 8), torch.zeros(1, 6, 2, 8),
                        torch.zeros(1, 6, 2, 8), torch.ones(1, 5, dtype=bool))

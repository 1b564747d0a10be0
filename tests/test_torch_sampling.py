"""Sampling stage of the PyTorch port vs the JAX package: the
counter-Gumbel stream, the fused LM head + Stable-Max (plain version vs
the JAX oracle and the Pallas kernel in interpret mode), Stable-Max over
stored logits (the plain version of kernels/stablemax_sampling.py vs
stable_max and the Pallas kernel), the top-k transfer mask (with the
bool mask and int32/int64 k the kernel takes), the tensor form of the
tick seed, and the full fused and unfused sampling steps; in every format
of core/mx.FORMATS (names and aliases) and under both transfer
strategies.  The random strategy draws otherwise than JAX (the port's
counter stream, JAX's jax.random.uniform), so its tests inject one numpy
draw into both.  Tolerances: tokens and transfer masks exact; conf
rtol 1e-5 (f32; the exp-sums run in other orders), 3e-3 on bf16
inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mx as jmx
from repro.core import sampling as js
from repro.kernels import ops, ref
from repro_torch.core import mx as tmx
from repro_torch.core import sampling as ts
from repro_torch.kernels import fused_head_sampling as tfh
from repro_torch.kernels import stablemax_sampling as tsm
from repro_torch.kernels import topk_mask as ttk

torch.set_num_threads(1)


def _rows_cols(n: int, seed: int):
    rs = np.random.RandomState(seed)
    rows = rs.randint(0, 2 ** 31 - 1, size=n).astype(np.int64)
    cols = rs.randint(0, 2 ** 31 - 1, size=n).astype(np.int64)
    return rows, cols


def test_mix32_bit_exact():
    x = np.random.RandomState(0).randint(0, 2 ** 32, size=4096,
                                         dtype=np.uint64)
    x[:3] = [0, 2 ** 32 - 1, 0x80000000]
    want = np.asarray(js._mix32(jnp.asarray(x.astype(np.uint32))))
    got = ts._mix32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 0xDEADBEEF])
def test_counter_uniform_bit_exact(seed):
    """The hash and the uniform it yields match the JAX stream bit for
    bit (uint32 wraparound in int64)."""
    rows, cols = _rows_cols(20000, seed % 97)
    h = js._mix32(jnp.asarray(rows.astype(np.uint32)) * jnp.uint32(0x9E3779B9)
                  ^ jnp.uint32(seed))
    h = js._mix32(h ^ jnp.asarray(cols.astype(np.uint32))
                  * jnp.uint32(0x85EBCA6B))
    want = np.asarray(((h >> jnp.uint32(8)).astype(jnp.float32) + 0.5)
                      * (1.0 / (1 << 24)))
    got = ts.counter_uniform(seed, torch.from_numpy(rows),
                             torch.from_numpy(cols)).numpy()
    np.testing.assert_array_equal(got, want)


def test_counter_gumbel_matches():
    """g = -log(-log(u)) from the bit-exact u.  XLA's CPU log is a
    polynomial that differs from torch's (nearly correctly rounded) log in
    the last bit for about 14% of f32 inputs, so g agrees to a few ulp,
    not bit for bit."""
    rows, cols = _rows_cols(20000, 3)
    seed = 0x5A11
    want = np.asarray(js.counter_gumbel(
        jnp.uint32(seed), jnp.asarray(rows.astype(np.int32)),
        jnp.asarray(cols.astype(np.int32))))
    got = ts.counter_gumbel(seed, torch.from_numpy(rows),
                            torch.from_numpy(cols)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


def _head_inputs(R: int, d: int, V: int, dtype: str, seed: int,
                 boost_col=None):
    """hidden (R, d) and w_head (d, V) for both packages; ``boost_col``
    makes that column every row's largest logit."""
    rs = np.random.RandomState(seed)
    h = rs.randn(R, d).astype(np.float32)
    w = (rs.randn(d, V) * 4 / np.sqrt(d)).astype(np.float32)
    if boost_col is not None:
        h = np.abs(h)
        w[:, boost_col] = 1.0
    ht, wt = torch.from_numpy(h), torch.from_numpy(w)
    if dtype == "bfloat16":
        ht, wt = ht.to(torch.bfloat16), wt.to(torch.bfloat16)
        hj = jnp.asarray(ht.float().numpy()).astype(jnp.bfloat16)
        wj = jnp.asarray(wt.float().numpy()).astype(jnp.bfloat16)
    else:
        hj, wj = jnp.asarray(h), jnp.asarray(w)
    return ht, wt, hj, wj


@pytest.mark.parametrize("fmt", ["none", "bf16", "mxfp8_e4m3"])
@pytest.mark.parametrize("suppress", [None, 7])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_head_plain_matches_jax(fmt, suppress, temperature, dtype):
    """R = 13 (not a multiple of the Pallas 8-row tile), V = 1000 (not a
    multiple of 32).  Both JAX paths get the seed the port gets."""
    R, d, V = 13, 32, 1000
    ht, wt, hj, wj = _head_inputs(R, d, V, dtype, seed=R + V,
                                  boost_col=suppress)
    key = jax.random.PRNGKey(5)
    seed = int(js.gumbel_seed(key))
    conf, tok = tfh.fused_head_sampling(
        ht, wt, fmt=fmt, suppress_id=suppress, temperature=temperature,
        seed=seed)
    oc, ot = js.fused_head_stable_max(
        hj, wj, fmt, rng=key if temperature > 0 else None,
        temperature=temperature, suppress_id=suppress, chunk_v=256)
    kc, kt = ops.fused_head_sampling(
        hj, wj, fmt=fmt, suppress_id=suppress, temperature=temperature,
        seed=jnp.uint32(seed), chunk_v=256, interpret=True)
    rtol = 3e-3 if dtype == "bfloat16" else 1e-5
    for c_ref, t_ref in ((oc, ot), (kc, kt)):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(t_ref))
        np.testing.assert_allclose(conf.numpy(), np.asarray(c_ref),
                                   rtol=rtol)
    if suppress is not None:
        assert not bool((tok == suppress).any())


def test_fused_head_logit_scale_rounds_through_the_activation_dtype():
    """logit_scale joins in bf16, as JAX's weakly typed scale does
    (bf16(0.3) = 0.30078125).  Held against JAX's eager
    stable_max(head_logits(...)): its jitted streamed oracle at a bf16
    logit_scale != 1 differs from that composition by up to 1% in conf
    (XLA keeps the scaled tile wider), while the port matches the eager
    composition exactly.  The models here all have logit_scale 1."""
    ht, wt, hj, wj = _head_inputs(8, 32, 300, "bfloat16", seed=1)
    conf, tok = tfh.fused_head_sampling(ht, wt, fmt="mxfp8_e4m3",
                                        logit_scale=0.3)
    oc, ot = js.stable_max(js.head_logits(hj, wj, logit_scale=0.3),
                           "mxfp8_e4m3")
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ot))
    np.testing.assert_allclose(conf.numpy(), np.asarray(oc), rtol=1e-5)


@pytest.mark.parametrize("n_sm", [1, 3, 132])
@pytest.mark.parametrize("fmt", ["none", "bf16", "mxfp8_e4m3"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_column_partition_matches_jax(n_sm, fmt, temperature, dtype):
    """The tensor-core route's partition: V = 1000 split by column_plan
    into whole-MX-block ranges (one, three with a ragged last range, or 32
    of one block each), each folded into one partial per row
    (head_partials_plain) and the partials merged in a shuffled order by
    the twin of common.cuh combine_row.  Two columns on either side of a
    range boundary hold equal maximum logits (the first must win), and the
    suppressed id sits in the block just past the boundary with a larger
    logit still.  Held against JAX's oracle and the Pallas kernel in
    interpret mode, with the fused head test's tolerances."""
    R, d, V = 13, 32, 1000
    cols, n_parts = plan = tfh.column_plan(V, n_sm)
    assert cols % 32 == 0 and (n_parts - 1) * cols < V <= n_parts * cols
    edge = cols if n_parts > 1 else 512
    rs = np.random.RandomState(n_sm + 7)
    h = np.abs(rs.randn(R, d)).astype(np.float32)
    w = (rs.randn(d, V) * 4 / np.sqrt(d)).astype(np.float32)
    w[:, edge - 1] = w[:, edge] = 1.0            # an exact tie across ranges
    suppress = edge + 3
    w[:, suppress] = 1.5
    ht, wt = torch.from_numpy(h), torch.from_numpy(w)
    if dtype == "bfloat16":
        ht, wt = ht.to(torch.bfloat16), wt.to(torch.bfloat16)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    hj = jnp.asarray(ht.float().numpy()).astype(jdt)
    wj = jnp.asarray(wt.float().numpy()).astype(jdt)
    key = jax.random.PRNGKey(5)
    seed = int(js.gumbel_seed(key))
    parts = tfh.head_partials_plain(ht, wt, plan, fmt,
                                    temperature=temperature, seed=seed,
                                    suppress_id=suppress)
    assert all(tuple(t.shape) == (R, n_parts) for t in parts)
    order = torch.from_numpy(rs.permutation(n_parts))
    conf, tok = tfh.combine_rows_plain(*(t[:, order] for t in parts),
                                       gumbel=temperature > 0)
    oc, ot = js.fused_head_stable_max(
        hj, wj, fmt, rng=key if temperature > 0 else None,
        temperature=temperature, suppress_id=suppress, chunk_v=256)
    kc, kt = ops.fused_head_sampling(
        hj, wj, fmt=fmt, suppress_id=suppress, temperature=temperature,
        seed=jnp.uint32(seed), chunk_v=256, interpret=True)
    rtol = 3e-3 if dtype == "bfloat16" else 1e-5
    for c_ref, t_ref in ((oc, ot), (kc, kt)):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(t_ref))
        np.testing.assert_allclose(conf.numpy(), np.asarray(c_ref),
                                   rtol=rtol)
    if temperature == 0.0:
        assert bool((tok == edge - 1).all())
    assert not bool((tok == suppress).any())


def _logits(R: int, V: int, dtype: str, seed: int, boost_col=None):
    """Stored logits (R, V) for both packages, made as the head makes them
    (``_head_inputs``), so MX blocks and near-ties look like the real
    ones."""
    ht, wt, hj, wj = _head_inputs(R, 32, V, dtype, seed, boost_col)
    return ts.head_logits(ht, wt), js.head_logits(hj, wj)


@pytest.mark.parametrize("suppress", [None, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stablemax_plain_matches_pallas(suppress, dtype):
    """No fake-quant (the Pallas kernel has none): the plain version vs the
    Pallas kernel in interpret mode (R = 13 and V = 1000, both padded to
    its tiles) and the jnp oracle kernels/ref.stablemax_sampling_ref.
    Tokens equal; conf to 1e-5 (the exp-sums run in other orders)."""
    zt, zj = _logits(13, 1000, dtype, seed=2, boost_col=suppress)
    conf, tok = tsm.stablemax_sampling(zt, suppress_id=suppress)
    kc, kt = ops.fused_sampling(zj, suppress_id=suppress, interpret=True)
    oc, ot = ref.stablemax_sampling_ref(zj, suppress_id=suppress)
    for c_ref, t_ref in ((kc, kt), (oc, ot)):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(t_ref))
        np.testing.assert_allclose(conf.numpy(), np.asarray(c_ref),
                                   rtol=1e-5)
    if suppress is not None:
        assert not bool((tok == suppress).any())


@pytest.mark.parametrize("V,n_sm", [(1003, 132), (4096, 3)])
@pytest.mark.parametrize("fmt", ["none", "bf16", "mxfp8_e4m3"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stablemax_vocab_plan_matches_jax(V, n_sm, fmt, temperature, dtype):
    """The stored-logit kernel's partition: V split by vocab_plan (V 1003
    on 132 SMs: 32 ranges of one MX block, the last ragged; V 4096 on 3:
    two ranges of one 2048-column CTA step), each range folded into one
    partial per row (stablemax_partials_plain) and the partials merged in
    a shuffled order by the twin of common.cuh combine_row.  The two
    columns on either side of the first range boundary hold equal maximum
    logits (the first must win), the suppressed id sits just past it with
    a larger logit still, and one row's maximum lies in the ragged last
    block.  Held against stable_max_plain, JAX's core/sampling.stable_max
    (greedy) or its fused-head oracle on an identity hidden state, which
    streams the same logits through the counter-Gumbel draw (T = 0.8), and
    the Pallas kernel in interpret mode where it applies (fmt none,
    greedy); tolerances as in the tests above."""
    R = 6
    cols, n_parts = plan = tsm.vocab_plan(V, R, n_sm)
    assert cols % 32 == 0 and n_parts > 1
    assert (n_parts - 1) * cols < V <= n_parts * cols
    edge, suppress = cols, cols + 3
    rs = np.random.RandomState(V + n_sm)
    z = (rs.randn(R, V) * 3).astype(np.float32)
    z[:, edge - 1] = z[:, edge] = 20.0        # an exact tie across ranges
    z[:, suppress] = 30.0
    z[1, V - 1] = 25.0                        # in the ragged last block
    zt = torch.from_numpy(z).to(getattr(torch, dtype))
    zj = jnp.asarray(zt.float().numpy()).astype(getattr(jnp, dtype))
    key = jax.random.PRNGKey(7)
    seed = int(js.gumbel_seed(key))
    kw = dict(temperature=temperature, seed=seed, suppress_id=suppress)
    parts = tsm.stablemax_partials_plain(zt, plan, fmt, **kw)
    assert all(tuple(t.shape) == (R, n_parts) for t in parts)
    order = torch.from_numpy(rs.permutation(n_parts))
    conf, tok = tfh.combine_rows_plain(*(t[:, order] for t in parts),
                                       gumbel=temperature > 0)
    pc, pt = tsm.stable_max_plain(zt, fmt, **kw)
    refs = [(pc, pt)]
    if temperature > 0:
        refs.append(js.fused_head_stable_max(
            jnp.eye(R, dtype=zj.dtype), zj, fmt, rng=key,
            temperature=temperature, suppress_id=suppress, chunk_v=256))
    else:
        refs.append(js.stable_max(zj, fmt, suppress_id=suppress))
        if fmt == "none":
            refs.append(ops.fused_sampling(zj, suppress_id=suppress,
                                           interpret=True))
    for c_ref, t_ref in refs:
        np.testing.assert_array_equal(tok.numpy(), np.asarray(t_ref))
        np.testing.assert_allclose(conf.numpy(), np.asarray(c_ref),
                                   rtol=1e-5)
    if temperature == 0.0:
        assert tok.tolist() == [edge - 1, V - 1] + [edge - 1] * (R - 2)
    assert not bool((tok == suppress).any())


@pytest.mark.parametrize("fmt", ["bf16", "mxfp8_e4m3"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stable_max_matches_jax(fmt, dtype):
    """Greedy stable_max with the sampling fake-quant, (2, 5, V) logits
    (leading dims flattened), the suppressed id still in its MX block."""
    zt, zj = _logits(10, 1000, dtype, seed=3, boost_col=7)
    zt, zj = zt.reshape(2, 5, -1), zj.reshape(2, 5, -1)
    conf, tok = ts.stable_max(zt, fmt, suppress_id=7)
    oc, ot = js.stable_max(zj, fmt, suppress_id=7)
    assert tuple(tok.shape) == (2, 5) and tok.dtype == torch.int32
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ot))
    np.testing.assert_allclose(conf.numpy(), np.asarray(oc), rtol=1e-5)


@pytest.mark.parametrize("fmt", ["none", "mxfp8_e4m3"])
def test_stable_max_gumbel_matches_the_fused_stream(fmt):
    """temperature > 0: the port draws counter_gumbel with its seed (JAX's
    stable_max draws jax.random.gumbel), so stable_max on the stored
    logits must equal JAX's fused-head oracle fed the same seed."""
    R, d, V = 13, 32, 1000
    ht, wt, hj, wj = _head_inputs(R, d, V, "float32", seed=4)
    key = jax.random.PRNGKey(9)
    seed = int(js.gumbel_seed(key))
    conf, tok = ts.stable_max(ts.head_logits(ht, wt), fmt, seed, 0.8,
                              suppress_id=3)
    oc, ot = js.fused_head_stable_max(hj, wj, fmt, rng=key, temperature=0.8,
                                      suppress_id=3, chunk_v=256)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ot))
    np.testing.assert_allclose(conf.numpy(), np.asarray(oc), rtol=1e-5)
    greedy = ts.stable_max(ts.head_logits(ht, wt), fmt, None, 0.8)[1]
    assert not torch.equal(greedy, tok)     # no seed: greedy, as in JAX


@pytest.mark.parametrize("fmt", ["none", "mxfp8_e4m3"])
def test_sampling_step_full_matches_jax(fmt):
    """Stored block logits (B, L, V) -> (tokens, transfer, conf) of one
    greedy step, committed tokens kept, mask id suppressed."""
    B, L, V, mask_id = 3, 8, 300, 299
    zt, zj = _logits(B * L, V, "float32", seed=12)
    rs = np.random.RandomState(13)
    x = rs.randint(0, V - 1, size=(B, L)).astype(np.int32)
    x[rs.rand(B, L) < 0.6] = mask_id
    k = np.array([2, 0, 5], np.int32)
    nx, tr, cf = ts.sampling_step_full(
        zt.reshape(B, L, V), torch.from_numpy(x), mask_id,
        torch.from_numpy(k), ts.SamplingConfig(fmt=fmt))
    jx, jtr, jcf = js.sampling_step_full(
        zj.reshape(B, L, V), jnp.asarray(x), mask_id, jnp.asarray(k),
        js.SamplingConfig(fmt=fmt))
    np.testing.assert_array_equal(nx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jtr))
    np.testing.assert_allclose(cf.numpy(), np.asarray(jcf), rtol=1e-5)


@pytest.mark.parametrize("B,L", [(2, 16), (5, 32), (8, 64), (3, 7)])
@pytest.mark.parametrize("ties", [False, True])
def test_topk_plain_matches_jax(B, L, ties):
    rs = np.random.RandomState(B * L + ties)
    conf = rs.randn(B, L).astype(np.float32)
    if ties:                              # coarse values: many exact ties
        # (+ 0.0 turns -0.0 into 0.0: lax.top_k sorts -0.0 below 0.0,
        # where the rank formula and the Pallas kernel call them equal)
        conf = np.round(conf * 2) / 2 + 0.0
    mask = rs.rand(B, L) < 0.6
    mask[0] = True
    k = rs.randint(0, L + 1, size=B).astype(np.int32)
    k[0] = L // 2
    got = ttk.topk_mask(torch.from_numpy(conf), torch.from_numpy(mask),
                        torch.from_numpy(k)).numpy()
    want = np.asarray(js.topk_transfer_mask(
        jnp.asarray(conf), jnp.asarray(mask), jnp.asarray(k),
        use_kernel=False))
    kern = np.asarray(ops.transfer_mask(jnp.asarray(conf), jnp.asarray(mask),
                                        jnp.asarray(k), interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, kern)


def test_topk_all_tied():
    conf = np.full((2, 16), 0.5, np.float32)
    mask = np.ones((2, 16), bool)
    k = np.array([4, 16], np.int32)
    got = ttk.topk_mask(torch.from_numpy(conf), torch.from_numpy(mask),
                        torch.from_numpy(k)).numpy()
    want = np.asarray(ops.transfer_mask(jnp.asarray(conf), jnp.asarray(mask),
                                        jnp.asarray(k), interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], np.arange(16) < 4)


@pytest.mark.parametrize("k_dtype", ["int32", "int64"])
@pytest.mark.parametrize("R,L", [(3, 1), (5, 16), (7, 33), (6, 64)])
def test_topk_bool_mask_and_integer_k_match_jax(R, L, k_dtype):
    """The types the kernel takes on the card: a bool mask in, a bool mask
    out, k as int32 or int64; R not a multiple of 4, exact ties, a row with
    nothing masked and k past L."""
    rs = np.random.RandomState(R * 100 + L)
    conf = (np.round(rs.randn(R, L) * 2) / 2 + 0.0).astype(np.float32)
    mask = rs.rand(R, L) < 0.6
    mask[0] = True
    mask[1] = False
    k = rs.randint(0, L + 2, size=R).astype(k_dtype)
    got = ttk.topk_mask(torch.from_numpy(conf), torch.from_numpy(mask),
                        torch.from_numpy(k))
    assert got.dtype == torch.bool and got.shape == (R, L)
    args = (jnp.asarray(conf), jnp.asarray(mask),
            jnp.asarray(k.astype(np.int32)))
    want = np.asarray(ref.topk_mask_ref(*args)).astype(bool)
    kern = np.asarray(ops.transfer_mask(*args, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), kern)
    np.testing.assert_array_equal(
        got.numpy().sum(1), np.minimum(k, mask.sum(1)))


@pytest.mark.parametrize("seed", [0, 7, 0xDEADBEEF, 2 ** 32 - 1])
def test_tensor_seeds_are_bit_equal_to_int_seeds(seed):
    """tick_seed from a tensor tick (and seed), as a captured graph
    computes it on the device, equals the int form; counter_uniform and
    counter_gumbel with a tensor seed equal the int seed's draws."""
    from repro_torch.core import diffusion as tdiff
    rows, cols = _rows_cols(4096, seed & 0xFFFF)
    rows_t, cols_t = torch.from_numpy(rows), torch.from_numpy(cols)
    for tick in (0, 1, 2, 1000, 2 ** 31 - 1, 2 ** 31, 2 ** 32 + 5):
        want = tdiff.tick_seed(seed, tick)
        got = tdiff.tick_seed(seed, torch.tensor([tick]))
        both = tdiff.tick_seed(torch.tensor([seed]), torch.tensor(tick))
        assert got.dtype == torch.int64 and got.shape == (1,)
        assert int(got) == int(both) == want
        assert torch.equal(ts.counter_uniform(got, rows_t, cols_t),
                           ts.counter_uniform(want, rows_t, cols_t))
        assert torch.equal(ts.counter_gumbel(got, rows_t, cols_t),
                           ts.counter_gumbel(want, rows_t, cols_t))
    assert torch.equal(ts.seed_tensor(seed, "cpu"),
                       torch.tensor([seed], dtype=torch.int64))
    with pytest.raises(ValueError):
        ts.seed_tensor(torch.tensor([1], dtype=torch.int32), "cpu")


@pytest.mark.parametrize("fmt", ["bf16", "mxfp8_e4m3"])
def test_fused_sampling_step_matches_jax(fmt):
    """hidden (B, L, d) -> (tokens, transfer, conf) of one greedy step,
    committed tokens kept, mask id suppressed."""
    B, L, d, V, mask_id = 3, 8, 32, 300, 299
    rs = np.random.RandomState(11)
    h = rs.randn(B, L, d).astype(np.float32)
    w = (rs.randn(d, V) / np.sqrt(d) * 4).astype(np.float32)
    x = rs.randint(0, V - 1, size=(B, L)).astype(np.int32)
    x[rs.rand(B, L) < 0.6] = mask_id
    k = np.array([2, 0, 5], np.int32)
    cfg_j = js.SamplingConfig(fmt=fmt)
    cfg_t = ts.SamplingConfig(fmt=fmt)
    nx, tr, cf = ts.fused_sampling_step_full(
        torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(x),
        mask_id, torch.from_numpy(k), cfg_t)
    jx, jtr, jcf = js.fused_sampling_step_full(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(x), mask_id,
        jnp.asarray(k), cfg_j, use_kernel=False)
    np.testing.assert_array_equal(nx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jtr))
    np.testing.assert_allclose(cf.numpy(), np.asarray(jcf), rtol=1e-5)


def test_unported_sampling_options_raise():
    """Both packages run each transfer strategy and every format of
    core/mx.FORMATS (names and aliases) through the fused and the unfused
    step.  A name the port does not know raises ValueError there; JAX
    raises KeyError for an unknown format and treats an unknown strategy
    as 'stablemax' (ROADMAP.md, Queue 3)."""
    B, L, d, V, mid = 1, 4, 32, 64, 63
    rs = np.random.RandomState(2)
    h = rs.randn(B, L, d).astype(np.float32)
    w = rs.randn(d, V).astype(np.float32)
    z = rs.randn(B, L, V).astype(np.float32)
    x = np.full((B, L), mid, np.int32)
    k = np.array([2], np.int32)
    key = jax.random.PRNGKey(3)
    for fmt in tmx.FORMATS:
        for strategy in ts.STRATEGIES:
            cfg_t = ts.SamplingConfig(fmt=fmt, strategy=strategy)
            cfg_j = js.SamplingConfig(fmt=fmt, strategy=strategy)
            for out_t, out_j in (
                    (ts.fused_sampling_step_full(
                        torch.from_numpy(h), torch.from_numpy(w),
                        torch.from_numpy(x), mid, torch.from_numpy(k),
                        cfg_t, 5),
                     js.fused_sampling_step_full(
                        jnp.asarray(h), jnp.asarray(w), jnp.asarray(x), mid,
                        jnp.asarray(k), cfg_j, key, use_kernel=False)),
                    (ts.sampling_step_full(
                        torch.from_numpy(z), torch.from_numpy(x), mid,
                        torch.from_numpy(k), cfg_t, 5),
                     js.sampling_step_full(
                        jnp.asarray(z), jnp.asarray(x), mid, jnp.asarray(k),
                        cfg_j, key))):
                assert int(out_t[1].sum()) == int(out_j[1].sum()) == 2
                assert not bool((out_t[0] == mid).all())
    xt, kt = torch.from_numpy(x), torch.from_numpy(k)
    for cfg in (ts.SamplingConfig(fmt="mxint3"),
                ts.SamplingConfig(strategy="confidence")):
        with pytest.raises(ValueError):
            ts.fused_sampling_step_full(torch.from_numpy(h),
                                        torch.from_numpy(w), xt, mid, kt,
                                        cfg, 5)
        with pytest.raises(ValueError):
            ts.sampling_step_full(torch.from_numpy(z), xt, mid, kt, cfg, 5)
    with pytest.raises(KeyError):
        js.sampling_step_full(jnp.asarray(z), jnp.asarray(x), mid,
                              jnp.asarray(k), js.SamplingConfig(fmt="mxint3"))
    j_odd = js.sampling_step_full(jnp.asarray(z), jnp.asarray(x), mid,
                                  jnp.asarray(k),
                                  js.SamplingConfig(strategy="confidence"))
    j_ref = js.sampling_step_full(jnp.asarray(z), jnp.asarray(x), mid,
                                  jnp.asarray(k), js.SamplingConfig())
    np.testing.assert_array_equal(np.asarray(j_odd[1]), np.asarray(j_ref[1]))


ALL_NAMES = sorted(tmx.FORMATS)
CANONICAL = ["none", "bf16", "mxfp8_e4m3", "mxint8", "mxint4", "mxfp6_e3m2",
             "mxfp4_e2m1"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ALL_NAMES)
def test_stable_max_every_format_matches_jax(fmt, dtype):
    """Greedy stable_max in every name and alias of core/mx.FORMATS, the
    suppressed id still in its MX block, (2, 5, V) logits; the plain
    version of the kernel underneath (CPU tensors)."""
    zt, zj = _logits(10, 1000, dtype, seed=ALL_NAMES.index(fmt),
                     boost_col=7)
    zt, zj = zt.reshape(2, 5, -1), zj.reshape(2, 5, -1)
    conf, tok = ts.stable_max(zt, fmt, suppress_id=7)
    oc, ot = js.stable_max(zj, fmt, suppress_id=7)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ot))
    np.testing.assert_allclose(conf.numpy(), np.asarray(oc), rtol=1e-5)


@pytest.mark.parametrize("fmt", CANONICAL)
def test_two_pass_and_full_softmax_match_jax(fmt):
    """stable_max_two_pass against JAX's and against the one-pass
    stable_max (no suppression: the same function); the naive
    full_softmax_reference against JAX's and, at fmt none, against
    Stable-Max's conf."""
    zt, zj = _logits(12, 500, "float32", seed=21)
    c2, t2 = ts.stable_max_two_pass(zt, fmt)
    jc, jt = js.stable_max_two_pass(zj, fmt)
    np.testing.assert_array_equal(t2.numpy(), np.asarray(jt))
    np.testing.assert_allclose(c2.numpy(), np.asarray(jc), rtol=1e-5)
    c1, t1 = ts.stable_max(zt, fmt)
    np.testing.assert_array_equal(t1.numpy(), t2.numpy())
    np.testing.assert_allclose(c1.numpy(), c2.numpy(), rtol=1e-5)
    fc, ft = ts.full_softmax_reference(zt)
    jfc, jft = js.full_softmax_reference(zj)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(jft))
    np.testing.assert_allclose(fc.numpy(), np.asarray(jfc), rtol=1e-5)
    if fmt == "none":
        np.testing.assert_allclose(c1.numpy(), fc.numpy(), rtol=1e-5)


@pytest.mark.parametrize("fmt", CANONICAL)
def test_sampling_steps_every_format_match_jax(fmt):
    """sampling_step_full (stored logits) and sampling_step in every
    format, greedy, committed tokens kept, mask id suppressed."""
    B, L, V, mask_id = 3, 8, 300, 299
    zt, zj = _logits(B * L, V, "float32", seed=31)
    rs = np.random.RandomState(32)
    x = rs.randint(0, V - 1, size=(B, L)).astype(np.int32)
    x[rs.rand(B, L) < 0.6] = mask_id
    k = np.array([2, 0, 5], np.int32)
    args_t = (zt.reshape(B, L, V), torch.from_numpy(x), mask_id,
              torch.from_numpy(k), ts.SamplingConfig(fmt=fmt))
    args_j = (zj.reshape(B, L, V), jnp.asarray(x), mask_id, jnp.asarray(k),
              js.SamplingConfig(fmt=fmt))
    nx, tr, cf = ts.sampling_step_full(*args_t)
    jx, jtr, jcf = js.sampling_step_full(*args_j)
    np.testing.assert_array_equal(nx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jtr))
    np.testing.assert_allclose(cf.numpy(), np.asarray(jcf), rtol=1e-5)
    sx, st = ts.sampling_step(*args_t)
    jsx, jst = js.sampling_step(*args_j)
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))


def _step_inputs(B=3, L=8, d=32, V=300, seed=11):
    rs = np.random.RandomState(seed)
    h = rs.randn(B, L, d).astype(np.float32)
    w = (rs.randn(d, V) / np.sqrt(d) * 4).astype(np.float32)
    x = rs.randint(0, V - 1, size=(B, L)).astype(np.int32)
    x[rs.rand(B, L) < 0.6] = V - 1
    return h, w, x, np.array([2, 0, 5], np.int32)[:B]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("fmt", CANONICAL)
def test_fused_step_every_format_matches_jax(fmt, temperature):
    """The plain fused step (CPU tensors) against JAX's lax.scan oracle in
    every format, greedy and T 0.8: both draw counter_gumbel with the
    seed JAX folds from its key, so sampled tokens are equal too."""
    h, w, x, k = _step_inputs()
    mask_id = w.shape[1] - 1
    key = jax.random.PRNGKey(8)
    nx, tr, cf = ts.fused_sampling_step_full(
        torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(x),
        mask_id, torch.from_numpy(k),
        ts.SamplingConfig(fmt=fmt, temperature=temperature),
        int(js.gumbel_seed(key)))
    jx, jtr, jcf = js.fused_sampling_step_full(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(x), mask_id,
        jnp.asarray(k), js.SamplingConfig(fmt=fmt, temperature=temperature),
        key, use_kernel=False)
    np.testing.assert_array_equal(nx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jtr))
    np.testing.assert_allclose(cf.numpy(), np.asarray(jcf), rtol=1e-5)


@pytest.mark.parametrize("chunk_v", [32, 96, 256, 4096])
def test_fused_step_chunk_v_matches_jax(chunk_v):
    """chunk_v sets the plain stream's vocab chunk and the trace's chunk
    count, as in JAX: tokens equal at every chunk width, conf within the
    exp-sum's order, and the trace holds one GEMM tile per chunk of
    _chunk_grid."""
    from repro_torch.sim import trace as ttr
    h, w, x, k = _step_inputs(V=1000)
    V, mask_id = w.shape[1], w.shape[1] - 1
    cfg_t, cfg_j = ts.SamplingConfig(), js.SamplingConfig()
    args = (torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(x),
            mask_id, torch.from_numpy(k), cfg_t)
    with ttr.activate(ttr.Tracer()) as tracer:
        nx, tr, cf = ts.fused_sampling_step_full(*args, chunk_v=chunk_v)
    jx, jtr, jcf = js.fused_sampling_step_full(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(x), mask_id,
        jnp.asarray(k), cfg_j, use_kernel=False, chunk_v=chunk_v)
    np.testing.assert_array_equal(nx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jtr))
    np.testing.assert_allclose(cf.numpy(), np.asarray(jcf), rtol=1e-5)
    chunk, Vp = ts._chunk_grid(V, chunk_v)
    assert (chunk, Vp) == js._chunk_grid(V, chunk_v)
    assert sum(o.op == "GEMM_TILE" for o in tracer.ops) == Vp // chunk


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("head", ["fused", "unfused"])
def test_random_strategy_with_an_injected_draw_matches_jax(
        monkeypatch, head, temperature):
    """strategy='random' with one numpy uniform draw injected into JAX's
    jax.random.uniform and into the port's random_select: the transfer,
    the tokens and the (Stable-Max) conf equal JAX's.  Without a seed
    (rng) both raise ValueError."""
    h, w, x, k = _step_inputs()
    B, L = x.shape
    V, mask_id = w.shape[1], w.shape[1] - 1
    u = np.random.RandomState(17).rand(B, L).astype(np.float32)
    calls = []

    def jax_uniform(rng, shape, *a, **kw):
        calls.append("jax")
        assert tuple(shape) == (B, L)
        return jnp.asarray(u)

    def port_draw(seed, shape, device, row_offset=0):
        calls.append("port")
        assert tuple(shape) == (B, L) and seed is not None
        assert row_offset == 0
        return torch.from_numpy(u)
    monkeypatch.setattr(jax.random, "uniform", jax_uniform)
    monkeypatch.setattr(ts, "random_select", port_draw)
    key = jax.random.PRNGKey(4)
    cfg_t = ts.SamplingConfig(strategy="random", temperature=temperature)
    cfg_j = js.SamplingConfig(strategy="random", temperature=temperature)
    seed = int(js.gumbel_seed(key))
    if head == "fused":
        got = ts.fused_sampling_step_full(
            torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(x),
            mask_id, torch.from_numpy(k), cfg_t, seed)
        want = js.fused_sampling_step_full(
            jnp.asarray(h), jnp.asarray(w), jnp.asarray(x), mask_id,
            jnp.asarray(k), cfg_j, key, use_kernel=False)
    else:
        zt = ts.head_logits(torch.from_numpy(h), torch.from_numpy(w))
        zj = js.head_logits(jnp.asarray(h), jnp.asarray(w))
        got = ts.sampling_step_full(zt, torch.from_numpy(x), mask_id,
                                    torch.from_numpy(k), cfg_t, seed)
        # JAX's unfused path draws jax.random.gumbel at T > 0: hold the
        # port's counter-Gumbel tokens against JAX's fused oracle there
        want = (js.sampling_step_full(zj, jnp.asarray(x), mask_id,
                                      jnp.asarray(k), cfg_j, key)
                if temperature == 0.0 else js.fused_sampling_step_full(
                    jnp.asarray(h), jnp.asarray(w), jnp.asarray(x), mask_id,
                    jnp.asarray(k), cfg_j, key, use_kernel=False))
    assert calls == ["port", "jax"]
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-5)
    # the draw, not conf, chose: the k largest draws among masked positions
    m_idx = x == mask_id
    for r in range(B):
        n = min(k[r], m_idx[r].sum())
        order = np.argsort(-np.where(m_idx[r], u[r], -1.0), kind="stable")
        assert set(np.nonzero(got[1][r].numpy())[0]) == set(order[:n])
    with pytest.raises(ValueError, match="seed"):
        ts.fused_sampling_step_full(
            torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(x),
            mask_id, torch.from_numpy(k), cfg_t)
    with pytest.raises(ValueError, match="rng"):
        js.fused_sampling_step_full(
            jnp.asarray(h), jnp.asarray(w), jnp.asarray(x), mask_id,
            jnp.asarray(k), cfg_j, use_kernel=False)


@pytest.mark.parametrize("seed", [0, 7, 0xDEADBEEF])
def test_random_draw_is_a_counter_stream_of_the_tick_seed(seed):
    """The random strategy's draw: counter_uniform on selection_seed(seed)
    at (row, position), in (0, 1]; the same bits from a tensor seed (the
    form a graph reads from device memory) as from the int; a stream
    apart from the Gumbel noise of the same seed (another seed word)."""
    from repro_torch.core import diffusion as tdiff
    tick = tdiff.tick_seed(seed, 3)
    u = ts.random_select(tick, (4, 16), "cpu")
    assert u.shape == (4, 16) and u.dtype == torch.float32
    assert bool(((u > 0) & (u <= 1)).all())
    u_dev = ts.random_select(tdiff.tick_seed(seed, torch.tensor([3])),
                             (4, 16), "cpu")
    assert torch.equal(u, u_dev)
    sel = ts.selection_seed(tick)
    assert sel != tick and int(ts.selection_seed(torch.tensor([tick]))) == sel
    rows, cols = torch.arange(4)[:, None], torch.arange(16)[None, :]
    assert torch.equal(u, ts.counter_uniform(sel, rows, cols))
    assert not torch.equal(u, ts.counter_uniform(tick, rows, cols))
    assert not torch.equal(u, ts.random_select(tdiff.tick_seed(seed, 4),
                                               (4, 16), "cpu"))


@pytest.mark.parametrize("fmt", ["none", "mxfp8_e4m3", "mxint4"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_head_partials_match_jax(n_shards, fmt):
    """pad_head_for_mesh and the per-shard streamed partials
    (fused_head_local_partials with col_offset, col_limit, suppression)
    against JAX's, shard by shard; merged by the combine rule they give
    the unsharded fused head's token and conf."""
    R, d, V, mid = 6, 32, 1000, 7
    ht, wt, hj, wj = _head_inputs(R, d, V, "float32", seed=n_shards,
                                  boost_col=mid)
    wpt = ts.pad_head_for_mesh(wt, n_shards)
    wpj = js.pad_head_for_mesh(wj, n_shards)
    assert tuple(wpt.shape) == wpj.shape
    assert wpt.shape[1] % (n_shards * 32) == 0
    np.testing.assert_array_equal(wpt.numpy(), np.asarray(wpj))
    vloc = wpt.shape[1] // n_shards
    parts = []
    for sh in range(n_shards):
        kw = dict(col_offset=sh * vloc, suppress_id=mid, chunk_v=256,
                  col_limit=V)
        m, gi, s = ts.fused_head_local_partials(
            ht, wpt[:, sh * vloc:(sh + 1) * vloc], fmt, **kw)
        jm, jgi, js_ = js.fused_head_local_partials(
            hj, wpj[:, sh * vloc:(sh + 1) * vloc], fmt, **kw)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(jgi))
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-5)
        np.testing.assert_allclose(s.numpy(), np.asarray(js_), rtol=1e-5)
        parts.append((m, gi, s))
    m = torch.stack([p[0] for p in parts], 1)
    gi = torch.stack([p[1] for p in parts], 1)
    s = torch.stack([p[2] for p in parts], 1)
    gm = m.amax(1)
    conf = 1.0 / (s * torch.exp(m - gm[:, None])).sum(1)
    tok = torch.where(m >= gm[:, None], gi, 1 << 30).amin(1)
    fc, ft = tfh.fused_head_stable_max(ht, wt, fmt, suppress_id=mid)
    np.testing.assert_array_equal(tok.numpy(), ft.numpy())
    np.testing.assert_allclose(conf.numpy(), fc.numpy(), rtol=1e-5)


@pytest.mark.parametrize("suppress", ["first", "last", "none"])
@pytest.mark.parametrize("fmt", ["none", "mxfp8_e4m3", "mxint4"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_route_c_partials_merge_to_jax_stable_max(n_shards, fmt, suppress):
    """Route C's plain version (stablemax_shard_partials on the CPU: the
    local_partials of one shard of stored logits, indices global, the
    suppressed id masked on the shard that holds it), shard by shard and
    merged by the combine rule, gives JAX's stable_max on the whole row:
    the token exact, conf within 1e-5; an exact tie across two shards
    goes to the lower index."""
    R, V = 7, 32 * 4 * n_shards
    z = np.random.RandomState(n_shards).randn(R, V).astype(np.float32) * 3
    vloc = V // n_shards
    z[:, vloc - 1] = z[:, vloc] = 20.0            # a tie across shards
    mid = {"first": vloc - 1, "last": V - 1, "none": None}[suppress]
    parts = [tsm.stablemax_shard_partials(
        torch.from_numpy(z[:, sh * vloc:(sh + 1) * vloc]).contiguous(),
        fmt=fmt, col_offset=sh * vloc, suppress_id=mid)
        for sh in range(n_shards)]
    m, gi, s = (torch.stack([p[i] for p in parts], 1) for i in range(3))
    assert gi.dtype == torch.int32
    gm = m.amax(1)
    conf = 1.0 / (s * torch.exp(m - gm[:, None])).sum(1)
    tok = torch.where(m >= gm[:, None], gi, 1 << 30).amin(1)
    jc, jt = js.stable_max(jnp.asarray(z), fmt, suppress_id=mid)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jt))
    np.testing.assert_allclose(conf.numpy(), np.asarray(jc), rtol=1e-5)
    assert (tok.numpy() == (vloc if suppress == "first" else vloc - 1)
            ).all()

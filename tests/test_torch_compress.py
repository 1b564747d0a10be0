"""The port's int8 error-feedback gradient compression
(optim/compress.py) against the JAX package's, on the CPU.

``_quant_int8``/``_dequant_int8`` bit for bit against JAX's (blocks of
256, scale amax / 127 floored at 1e-12, round half to even);
``compressed_psum`` over 1, 2 and 4 gloo ranks (spawned by
tests/_torch_mesh_ranks.py) against JAX's run under
``jax.vmap(axis_name="pod")``, with a leaf of 300 elements (not a
multiple of 256): every rank's new error bit for bit, the reduced mean
within 1e-6 of each leaf's largest value (the all-reduce sums the
dequantized f32 values in its own order) and within each block's int8
half-step (plus 4 f32 ulp) of the plain mean; JAX's two compression tests
as torch cases.
"""
import _torch_mesh_ranks as ranks
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compress as jcomp
from repro_torch.optim import compress as tcomp

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def psum_results(tmp_path_factory):
    return ranks.spawn("compress", 4, tmp_path_factory.mktemp("compress"))


def test_quant_dequant_bit_for_bit():
    rs = np.random.RandomState(0)
    cases = [rs.randn(1000).astype(np.float32) * 3,
             rs.randn(3, 256).astype(np.float32),
             np.zeros((300,), np.float32),             # the 1e-12 floor
             (np.arange(512, dtype=np.float32) - 256) / 2,   # ties: x.5
             rs.randn(7, 5).astype(np.float32) * 1e-30]
    for x in cases:
        qj, sj = jcomp._quant_int8(jnp.asarray(x))
        qt, st = tcomp._quant_int8(torch.from_numpy(x))
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        assert qt.dtype == torch.int8 and qt.shape[-1] == tcomp.BLOCK
        np.testing.assert_array_equal(
            tcomp._dequant_int8(qt, st, x.shape).numpy(),
            np.asarray(jcomp._dequant_int8(qj, sj, x.shape)))


@pytest.mark.parametrize("n", ranks.COMPRESS_N)
def test_compressed_psum_matches_jax(psum_results, n):
    grads, errs = ranks.compress_inputs(n)
    stack = lambda trees: {k: jnp.asarray(np.stack(  # noqa: E731
        [t[k] for t in trees])) for k in trees[0]}
    red_j, err_j = jax.vmap(
        lambda g, e: jcomp.compressed_psum(g, "pod", e),
        axis_name="pod")(stack(grads), stack(errs))
    every = psum_results[n]
    assert len(every) == n
    for r, (red_t, err_t) in enumerate(every):
        for name in ranks.COMPRESS_SHAPES:
            want = np.asarray(red_j[name][r])
            np.testing.assert_allclose(
                red_t[name], want, rtol=0,
                atol=1e-6 * float(np.abs(want).max()), err_msg=name)
            np.testing.assert_array_equal(err_t[name],
                                          np.asarray(err_j[name][r]))
            assert red_t[name].shape == ranks.COMPRESS_SHAPES[name]
    # the mean of the ranks' dequantized values: within each block's int8
    # half-step (scale / 2, summed over the ranks, over n) of the plain mean
    for name, shape in ranks.COMPRESS_SHAPES.items():
        plain = np.mean([g[name] + e[name] for g, e in zip(grads, errs)], 0)
        half = np.mean([_half_steps(g[name] + e[name]) for g, e in
                        zip(grads, errs)], 0)
        # the half-step, and 4 f32 ulp of the value for the sums' rounding
        assert (np.abs(every[0][0][name] - plain) <= half + np.abs(plain)
                * 2.0 ** -21).all(), name


def _half_steps(x):
    """Each element's int8 half-step: its block's scale / 2."""
    _, s = tcomp._quant_int8(torch.from_numpy(x))
    flat = np.repeat(s.numpy()[:, 0], tcomp.BLOCK)[:x.size]
    return flat.reshape(x.shape) / 2


def test_init_error_is_zero_f32():
    params = {"w": torch.ones(3, 4, dtype=torch.bfloat16),
              "layers": [{"b": torch.ones(5)}]}
    err = tcomp.init_error(params)
    assert err["w"].dtype == torch.float32 and err["w"].shape == (3, 4)
    assert not err["w"].any() and not err["layers"][0]["b"].any()


def test_int8_compression_roundtrip():
    """JAX's test_int8_compression_roundtrip."""
    x = torch.from_numpy(np.random.RandomState(0).randn(1000).astype(
        np.float32) * 3)
    q, s = tcomp._quant_int8(x)
    deq = tcomp._dequant_int8(q, s, x.shape)
    assert float(torch.linalg.norm(deq - x) / torch.linalg.norm(x)) < 0.01


def test_error_feedback_preserves_signal():
    """JAX's test_error_feedback_preserves_signal: with error feedback the
    sum of 20 compressed steps approximates the sum of the raw
    gradients."""
    g = torch.from_numpy(np.random.RandomState(1).randn(512).astype(
        np.float32) * 1e-4)
    e = torch.zeros_like(g)
    total = torch.zeros_like(g)
    for _ in range(20):
        gf = g + e
        q, s = tcomp._quant_int8(gf)
        deq = tcomp._dequant_int8(q, s, g.shape)
        e = gf - deq
        total = total + deq
    raw_total = g * 20
    assert float(torch.linalg.norm(total - raw_total) /
                 torch.linalg.norm(raw_total)) < 0.05

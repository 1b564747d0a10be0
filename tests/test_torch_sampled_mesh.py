"""The sampled decode step over a data mesh or a vocab-sharded head, on
the CPU: every noise draw of the port is indexed by the global row and
the global vocab column (``row_offset``, a shard's column offset), so a
sampled step on any mesh commits what one rank commits, as GSPMD's
partition of JAX's global draw does.

* The sampled shard partials' plain versions (route A over a padded head,
  route C over stored logits), merged by ``sampling.combine_partials``
  over 1, 2 and 4 spawned gloo ranks, against the single-device sampled
  Stable-Max on the whole row at the same row offset: the token bit for
  bit, conf within 1e-6 relative.
* The decode step (``launch/steps.build_serve_step``) of a dense, a
  hybrid and an ssm smoke under T 0.8 (strategy stablemax and random),
  strategy random at T 0, and greedy, on meshes (1, 2), (2, 1) and (2, 2)
  (job "sampled" of tests/_torch_mesh_ranks.py), against the one-rank
  step on the full inputs: the gathered canvas, which holds the transfer
  and the tokens, equal (no near-tie is recorded at these sizes), and
  every ``model`` rank's canvas equal.  The cases cover route A (llada-8b
  with V 256), a replicated head (V 257), route C (recurrentgemma-2b
  with V 256) and a gathered head (mamba2-130m with V 288: shards of 144
  columns split MX blocks).
* The greedy canvases on those meshes equal the one-rank step's, as
  before; the sampled ones differ from the greedy ones (the draw
  reaches the tokens); the SPMD tick still refuses sampling, as JAX's.
"""
import functools

import _torch_mesh_ranks as ranks
import numpy as np
import pytest
import torch

from repro_torch.core import diffusion
from repro_torch.core import sampling
from repro_torch.kernels import fused_head_sampling as fhs
from repro_torch.kernels import stablemax_sampling as sms

torch.set_num_threads(1)

MESHES = [(1, 2), (2, 1), (2, 2)]
CASES = ranks.SAMPLED_CASES
POLICIES = [name for name, _, _ in ranks.SAMPLED_POLICIES]


@pytest.fixture(scope="module")
def combined(tmp_path_factory):
    return ranks.spawn("sampled_combine", 4,
                       tmp_path_factory.mktemp("sampled_combine"),
                       timeout=120.0)


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def mesh_run(request, tmp_path_factory):
    data, model = request.param
    got = ranks.spawn("sampled", data * model,
                      tmp_path_factory.mktemp("sampled"), timeout=240.0,
                      data=data, model=model)
    return request.param, got


@functools.lru_cache(maxsize=None)
def one_rank(case):
    return ranks.sampled_run(case)


def _single(kind, fmt, sup=None):
    h, w, logits = (torch.from_numpy(a)
                    for a in ranks.sampled_partials_inputs())
    kw = dict(temperature=0.8, seed=ranks.SAMPLED_SEED,
              row_offset=ranks.SAMPLED_ROW0)
    if kind == "head":
        return fhs.fused_head_stable_max(h, w, fmt, suppress_id=sup, **kw)
    return sms.stable_max_plain(logits, fmt, suppress_id=100, **kw)


@pytest.mark.parametrize("n", ranks.SHARDS)
@pytest.mark.parametrize("fmt", ranks.FMTS)
def test_sampled_partials_merge_to_single_device(combined, n, fmt):
    for sup in ranks.SUPPRESS:
        conf, idx = combined["head", n, fmt, sup]
        want_c, want_i = _single("head", fmt, sup)
        np.testing.assert_array_equal(idx, want_i.numpy())
        np.testing.assert_allclose(conf, want_c.numpy(), rtol=1e-6)
    conf, idx = combined["logits", n, fmt]
    want_c, want_i = _single("logits", fmt)
    np.testing.assert_array_equal(idx, want_i.numpy())
    np.testing.assert_allclose(conf, want_c.numpy(), rtol=1e-6)


def test_row_offset_draws_the_global_rows():
    """A row offset draws what the rows of a larger batch draw there: the
    second half of a doubled batch equals the half at offset R, in the
    fused head, Stable-Max, both shard entries and the random
    strategy's draw."""
    h, w, logits = (torch.from_numpy(a)
                    for a in ranks.sampled_partials_inputs())
    R = h.shape[0]
    kw = dict(temperature=0.8, seed=9)
    for fn, a, b in ((fhs.fused_head_sampling, h, (w,)),):
        whole = fn(torch.cat([a, a]), *b, **kw)
        half = fn(a, *b, row_offset=R, **kw)
        for x, y in zip(whole, half):
            np.testing.assert_array_equal(x[R:].numpy(), y.numpy())
    whole = sms.stablemax_sampling(torch.cat([logits, logits]), **kw)
    half = sms.stablemax_sampling(logits, row_offset=R, **kw)
    for x, y in zip(whole, half):
        np.testing.assert_array_equal(x[R:].numpy(), y.numpy())
    whole = sms.stablemax_shard_partials(torch.cat([logits, logits]), **kw)
    half = sms.stablemax_shard_partials(logits, row_offset=R, **kw)
    for x, y in zip(whole, half):
        np.testing.assert_array_equal(x[R:].numpy(), y.numpy())
    whole = fhs.head_shard_partials(torch.cat([h, h]), w[:, :256], **kw)
    half = fhs.head_shard_partials(h, w[:, :256], row_offset=R, **kw)
    assert len(half) == 5
    for x, y in zip(whole, half):
        np.testing.assert_array_equal(x[R:].numpy(), y.numpy())
    u = sampling.random_select(9, (6, 8), "cpu")
    np.testing.assert_array_equal(
        sampling.random_select(9, (3, 8), "cpu", row_offset=3).numpy(),
        u[3:].numpy())
    assert not torch.equal(half[1], whole[1][:R]) or \
        not torch.equal(half[3], whole[3][:R])


def test_greedy_shard_partials_keep_three_outputs():
    h, w, logits = (torch.from_numpy(a)
                    for a in ranks.sampled_partials_inputs())
    assert len(fhs.head_shard_partials(h, w[:, :256])) == 3
    assert len(sms.stablemax_shard_partials(logits)) == 3


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("case", CASES)
def test_sampled_decode_matches_one_rank(mesh_run, case, policy):
    (data, model), got = mesh_run
    want = one_rank(case)[policy]
    canvas = got[case][policy]
    np.testing.assert_array_equal(canvas, want)
    if model > 1:
        assert got[case]["model equal", policy]


@pytest.mark.parametrize("case", CASES)
def test_sampling_reaches_the_tokens(case):
    """The sampled steps commit other tokens than the greedy step (so
    the mesh comparison above tests the draw), and each commits
    exactly k tokens per row."""
    run = one_rank(case)
    cfg = ranks.tp_config(case)
    _, x, k = ranks.step_inputs(cfg)
    assert not np.array_equal(run["hot"], run["greedy"])
    assert not np.array_equal(run["random"], run["greedy"])
    for name in POLICIES:
        changed = (run[name] != x).sum(axis=1)
        np.testing.assert_array_equal(changed, k)


def test_spmd_tick_still_refuses_sampling():
    from repro_torch.configs import base
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.registry import build_model
    model = build_model(base.get_config("llada-8b", smoke=True), "meta")
    for s in (sampling.SamplingConfig(temperature=0.7),
              sampling.SamplingConfig(strategy="random")):
        dcfg = diffusion.DiffusionConfig(gen_length=16, block_length=8,
                                         steps_per_block=4, sampling=s)
        with pytest.raises(NotImplementedError, match="greedy"):
            diffusion.check_spmd(model, dcfg, mesh_lib.shape_mesh(2, 1),
                                 jit_steps=False)

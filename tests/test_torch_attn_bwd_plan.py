"""The launch plan of attention's backward kernel and the bf16 arithmetic of
its tensor-core route, on the CPU (no JAX, no card).

* ``kernels/flash_bidir.bwd_plan`` at the shapes the backward runs in
  chip_smoke.py (llada-8b's and qwen2-0.5b's training attention,
  recurrentgemma-2b's D 256, causal, (2, 1024), the f32 case) and at
  small ones: every packed row of a group lies in exactly one block of
  the dk/dv pass's row split, each block whole 32-row chunks and at least
  ``BWD_MIN_SPLIT_ROWS`` rows; the dk/dv pass covers the card's SMs
  where the rows allow, and the dq pass takes the warps whose busiest SM
  finishes first by the plan's model; no split where one fills the card; every
  instantiation's shared memory fits the 227 KB a block may take; the
  scratch sizes are the ones csrc/flash_bidir_bwd.cu reads.
* A plain emulation of the kernel's bf16 route (S, dP, the statistics and
  every sum in f32; P and dS rounded to ``BWD_P_TERMS`` bf16 terms before
  their products; dk and dv summed block by block in the plan's row
  split) held against ``flash_bidir_bwd_plain`` in f32 under chip_smoke's
  bf16 gate: the error beyond one bf16 ulp at most twice the plain bf16
  version's, at reduced copies of the chip's bf16 backward cases.  It
  shows before any chip run that one bf16 rounding of P and dS keeps
  that gate.
"""
import numpy as np
import pytest
import torch

from repro_torch.analysis import registry
from repro_torch.kernels import flash_bidir as fb

torch.set_num_threads(1)

BF16 = torch.bfloat16
N_SM = fb.H100_SMS

# (B, S, Hq, Hkv, D): chip_smoke's backward cases, then small shapes
PLAN_SHAPES = [
    (8, 128, 32, 32, 128),     # llada-8b training
    (8, 128, 14, 2, 64),       # qwen2-0.5b training
    (4, 256, 10, 1, 256),      # recurrentgemma-2b's D 256
    (4, 96, 32, 32, 128),      # causal at llada-8b's heads
    (2, 256, 10, 1, 256),      # causal D 256, window 64
    (2, 1024, 32, 32, 128),    # llada-8b at 1,024 positions
    (3, 40, 6, 2, 64),         # the f32 case's shape
    (1, 7, 3, 1, 16),
    (2, 33, 8, 2, 96),
    (1, 2048, 16, 1, 256),
]


def _split_blocks(plan, n_rows):
    return [(s * plan.split_rows, min((s + 1) * plan.split_rows, n_rows))
            for s in range(plan.n_split)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_split_covers_every_row_once(shape, masked):
    B, S, Hq, Hkv, D = shape
    plan = fb.bwd_plan(B, S, S, Hq, Hkv, D, BF16, masked=masked)
    n_rows = Hq // Hkv * S
    blocks = _split_blocks(plan, n_rows)
    seen = np.zeros(n_rows, dtype=np.int64)
    for lo, hi in blocks:
        assert lo < hi, "an empty block"
        seen[lo:hi] += 1
    assert (seen == 1).all()
    assert plan.split_rows % fb.BWD_BM == 0
    if plan.n_split > 1:
        assert plan.split_rows >= fb.BWD_MIN_SPLIT_ROWS


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_fills_the_card_where_the_rows_allow(shape, masked):
    B, S, Hq, Hkv, D = shape
    plan = fb.bwd_plan(B, S, S, Hq, Hkv, D, BF16, masked=masked)
    n_rows = Hq // Hkv * S
    base = -(-S // fb.BWD_BN) * Hkv * B
    assert plan.dkv_ctas == base * plan.n_split
    if base >= N_SM:
        assert plan.n_split == 1            # one split fills the card
    elif n_rows >= fb.BWD_MIN_SPLIT_ROWS * -(-N_SM // base):
        # the rows allow a split that fills the card: the dk/dv grid
        # covers 90% of the SMs or more, in at most two waves
        per_sm = fb._per_sm(fb.bwd_dkv_warps(plan.tile), plan.dkv_smem)
        assert 0.9 * N_SM <= plan.dkv_ctas <= 2 * N_SM * per_sm
    # dq: no other warp count makes the busiest SM finish sooner by the
    # plan's model (ties to the most warps)
    def dq_time(w):
        ctas = -(-n_rows // (16 * w)) * Hkv * B
        return fb._sm_time(ctas, min(w, -(-n_rows // 16)) + 0.5, w,
                           fb.bwd_dq_smem(plan.tile, masked, w), N_SM)
    allowed = range(1, fb.bwd_dq_max_warps(plan.tile, masked) + 1)
    assert plan.dq_warps in allowed
    assert plan.dq_ctas == -(-n_rows // (16 * plan.dq_warps)) * Hkv * B
    assert dq_time(plan.dq_warps) == min(map(dq_time, allowed))


def test_sm_time_model():
    """The plan's model: one wave of 4-warp CTAs over every SM takes a
    CTA's work; a second wave doubles it; 8 resident warps run at 6 warps'
    rate."""
    smem = 1024
    assert fb._sm_time(N_SM, 4.0, 4, smem, N_SM) == 1.0
    assert fb._sm_time(2 * N_SM, 4.0, 4, smem, N_SM) == 8.0 / 6.0
    assert fb._sm_time(N_SM, 8.0, 8, smem, N_SM) == 8.0 / 6.0
    big = fb.SMEM_LIMIT_BYTES // 2 + 1      # one CTA an SM
    assert fb._sm_time(2 * N_SM, 4.0, 4, big, N_SM) == 2.0


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_scratch_and_shared_memory(shape):
    B, S, Hq, Hkv, D = shape
    G, n_rows = Hq // Hkv, Hq // Hkv * S
    plan = fb.bwd_plan(B, S, S, Hq, Hkv, D, BF16)
    assert plan.route == "tensor cores" and plan.tile >= D
    # 64-key dq tiles unless a mask can cut or the tile is 256 wide
    assert plan.dq_keys == (32 if plan.tile == 256 else 64)
    assert fb.bwd_plan(B, S, S, Hq, Hkv, D, BF16, masked=True).dq_keys == 32
    assert plan.stats_floats == 3 * B * Hkv * (-(-n_rows // 4) * 4)
    assert plan.part_floats == (2 * plan.n_split * B * S * Hkv * D
                                if plan.n_split > 1 else 0)
    assert plan.dq_smem <= fb.SMEM_LIMIT_BYTES
    assert plan.dkv_smem <= fb.SMEM_LIMIT_BYTES
    f32 = fb.bwd_plan(B, S, S, Hq, Hkv, D, torch.float32)
    assert (f32.route, f32.n_split, f32.part_floats) == ("CUDA cores", 1, 0)
    assert f32.stats_floats == 3 * B * Hq * S and G * S == n_rows


def test_every_backward_instantiation_fits_and_is_stated():
    for dt in fb.TILES:
        for masked in (False, True):
            assert fb.bwd_dq_smem(
                dt, masked, fb.bwd_dq_max_warps(dt, masked)) <= \
                fb.SMEM_LIMIT_BYTES
        assert fb.bwd_dkv_smem(dt) <= fb.SMEM_LIMIT_BYTES
    specs = {sp.kernel: sp for sp in registry.smem_specs()
             if sp.library == "flash_bidir_bwd"}
    assert all(sp.total_bytes <= registry.SMEM_LIMIT_BYTES
               for sp in specs.values())
    want = {f"flash_bidir_bwd_{k}<{t}, {d}>" for k in ("dq", "dkv")
            for t in ("float", "bf16") for d in (1, 2, 4, 8)}
    want |= {f"flash_bidir_bwd_{k}_wide<{t}>" for k in ("stats", "dq", "dkv")
             for t in ("float", "bf16")}
    want |= {f"flash_bidir_bwd_{k}_tc<{dt}{m}>" for k in ("dq", "dkv")
             for dt in fb.TILES for m in ("", ", true")}
    want.add("flash_bidir_bwd_split_sum")
    # bf16 scores: the MASKED tensor-core kernels with BS, and the prescale
    want |= {f"flash_bidir_bwd_{k}_tc<{dt}, true, true>" for k in ("dq", "dkv")
             for dt in fb.TILES}
    want |= {f"flash_bidir_bwd_qscale<{t}>" for t in ("float", "bf16")}
    # the cached forward's backward: BAOS's prep and sums, and the MASKED
    # tensor-core kernels with two terms of q and dO (QT = 2)
    want |= {f"flash_bidir_bwd_baos_{k}<{t}>" for k in ("prep", "sums")
             for t in ("float", "bf16")}
    want |= {f"flash_bidir_bwd_{k}_tc<{dt}, true, {bs}, 2>"
             for k in ("dq", "dkv") for dt in fb.TILES
             for bs in ("false", "true")}
    assert set(specs) == want
    assert specs["flash_bidir_bwd_dq_tc<256>"].dynamic_bytes == \
        (2 * 2 * 32 + 2 * 16 * 8) * 264 * 2
    assert specs["flash_bidir_bwd_dq_tc<128>"].dynamic_bytes == \
        (2 * 3 * 64 + 2 * 16 * 8) * 136 * 2
    assert specs["flash_bidir_bwd_dq_tc<128, true>"].dynamic_bytes == \
        (2 * 3 * 32 + 2 * 16 * 8) * 136 * 2
    assert specs["flash_bidir_bwd_dkv_tc<256>"].dynamic_bytes == \
        (2 * 64 + 2 * 3 * 32) * 264 * 2 + 3 * 3 * 32 * 4


# ---------------------------------------------------------------------------
# the tensor-core route's arithmetic, emulated
# ---------------------------------------------------------------------------

def bf16_ulp(x):
    """One bf16 ulp at each value of x (chip_smoke.bf16_ulp)."""
    _, e = torch.frexp(x.float())
    ulp = torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)
    return torch.where(x == 0, 0.0, ulp)


def bf16_terms(x, n):
    """x as n bf16 terms t_i = bf16(x - t_0 - ... - t_(i-1)), in f32."""
    out = []
    for _ in range(n):
        t = x.to(BF16).float()
        out.append(t)
        x = x - t
    return out


def emulate_tc_bwd(q, k, v, dout, kv_valid, window, causal, terms):
    """The bf16 route's function as csrc/flash_bidir_bwd.cu computes it:
    f32 S = D^-1/2 Q K^T and dP = dO V^T of the bf16 inputs, the row's max
    and 1 / l (l = Skv on a row with no valid key), delta = sum p dp, P and
    dS as ``terms`` bf16 terms each, every product f32-accumulated, dk and
    dv summed over the plan's row blocks in order, each output rounded
    once to bf16."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5
    plan = fb.bwd_plan(B, Sq, Skv, Hq, Hkv, D, BF16,
                       masked=kv_valid is not None or window is not None
                       or causal)
    qf, dof = q.float(), dout.float()
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    ok = fb._mask(B, Sq, Skv, kv_valid, window, 0, q.device, causal=causal)
    s = torch.where(ok, torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale,
                    -1e30)
    dead = ~ok.any(-1, keepdim=True)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    l = torch.where(dead, float(Skv), e.sum(-1, keepdim=True))
    p = e * (1.0 / torch.clamp(l, min=1e-30))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = torch.where(dead, 0.0, (p * dp).sum(-1, keepdim=True))
    ds = torch.where(ok, p * (dp - delta), 0.0)
    p_t, ds_t = bf16_terms(p, terms), bf16_terms(ds, terms)
    dq = sum(torch.einsum("bhqk,bkhd->bqhd", t, kf) for t in ds_t) * scale
    # packed row r = pos * G + g of q head hk * G + g
    row = (torch.arange(Sq)[None, :] * G + torch.arange(Hq)[:, None] % G)
    dk = dv = 0.0
    for s_lo in range(0, G * Sq, plan.split_rows):
        sel = ((row >= s_lo) & (row < s_lo + plan.split_rows)).float()
        sel = sel[None, :, :, None]
        part_k = sum(torch.einsum("bhqk,bqhd->bkhd", t * sel, qf)
                     for t in ds_t)
        part_v = sum(torch.einsum("bhqk,bqhd->bkhd", t * sel, dof)
                     for t in p_t)
        dk = dk + part_k.reshape(B, Skv, Hkv, G, D).sum(3)
        dv = dv + part_v.reshape(B, Skv, Hkv, G, D).sum(3)
    return dq.to(BF16), (dk * scale).to(BF16), dv.to(BF16)


# reduced copies of chip_smoke's bf16 backward cases: (B, S, Hq, Hkv, D,
# window, kv_valid lengths, causal)
EMU_CASES = [
    ("llada-8b training", (2, 128, 4, 4, 128, None, None, False)),
    ("qwen2-0.5b training", (2, 128, 7, 1, 64, None, None, False)),
    ("D 256 window 2048 kv_valid", (2, 256, 5, 1, 256, 2048, (256, 77),
                                    False)),
    ("causal llada-8b shape", (2, 96, 4, 4, 128, None, None, True)),
    ("causal D 256 window 64 kv_valid", (2, 256, 5, 1, 256, 64, (256, 129),
                                         True)),
    ("a row with no valid key", (3, 40, 6, 2, 64, 7, (40, 0, 13), False)),
]


def _case_inputs(seed, B, S, Hq, Hkv, D, lens):
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(BF16)
    q, dout = mk(B, S, Hq, D), mk(B, S, Hq, D)
    k, v = mk(B, S, Hkv, D), mk(B, S, Hkv, D)
    valid = None if lens is None else (
        torch.arange(S)[None, :] < torch.tensor(lens)[:, None])
    return q, k, v, dout, valid


def _gate_ratios(case, terms):
    B, S, Hq, Hkv, D, win, lens, causal = case
    q, k, v, dout, valid = _case_inputs(0, B, S, Hq, Hkv, D, lens)
    args = (q, k, v, dout, valid, win, 0, causal)
    ref = fb.flash_bidir_bwd_plain(*(t.float() for t in args[:4]),
                                   *args[4:])
    plain = fb.flash_bidir_bwd_plain(*args)
    got = emulate_tc_bwd(q, k, v, dout, valid, win, causal, terms)
    out = []
    for g, p, r in zip(got, plain, ref):
        assert bool(torch.isfinite(g.float()).all())
        e_k = float(((g.float() - r).abs() - bf16_ulp(r)).max())
        e_p = float((p.float() - r).abs().max())
        out.append(e_k / e_p)
    if valid is not None:
        dead = ~valid.any(1)
        assert not got[0][dead].any() and not got[1][dead].any()
    return out


@pytest.mark.parametrize("what,case", EMU_CASES,
                         ids=[w for w, _ in EMU_CASES])
def test_bf16_route_rounding_keeps_the_gate(what, case):
    """chip_smoke's bf16 gate on the emulated kernel: dq, dk and dv each
    within one ulp plus twice the plain bf16 version's error."""
    ratios = _gate_ratios(case, fb.BWD_P_TERMS)
    assert max(ratios) <= 2.0, (what, ratios)


@pytest.mark.parametrize("what,case", EMU_CASES[:3],
                         ids=[w for w, _ in EMU_CASES[:3]])
def test_two_terms_would_leave_almost_no_error_beyond_rounding(what, case):
    """hi + lo terms of P and dS (the alternative the kernel does not
    take) leave under 1% of the budget: the rounding of P and dS is what
    the gate sees of the one-term route."""
    one, two = _gate_ratios(case, 1), _gate_ratios(case, 2)
    assert max(two) <= 0.01 and max(two) < max(one) / 10, (what, one, two)

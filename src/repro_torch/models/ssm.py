"""Mamba2 (SSD, state-space duality) backbone, ported from
src/repro/models/ssm.py.

The chunked SSD scan (Dao & Gu 2024, Listing 1): a within-chunk quadratic
("attention-like") term plus an inter-chunk linear recurrence over the
chunk states.  The model is attention-free and has no KV cache.  Its warm
step is a full recompute that also checkpoints, per layer, the SSM state
at the active block's start (the chunk state at ``capture_at // chunk``)
and the W - 1 pre-conv rows before it; a refine step replays the segment
from them and leaves them as they are.  The SSM is causal, so the suffix
cannot reach the active block and cache modes dual and prefix coincide.
With BAOS on, the captured state is MX fake-quantized in
``baos_cfg.kv_format`` through core/mx (the state plays the cache's role),
as JAX does; no kernel of the port runs here.

JAX computes both scans outside any Pallas kernel, so they stay plain
PyTorch: the inter-chunk recurrence loops over the chunks (6 at 96
positions), never over positions.  Every segment fed to the model must be
a multiple of ``SSD_CHUNK``: ``ssd_chunked`` raises JAX's ValueError
otherwise.

Parameters: ``embed`` (V, d), ``layers`` (a list of dicts ``norm`` (the
config's norm, rms or ln: ``transformer.apply_norm``),
``in_proj``, ``conv_w`` (W, conv_dim), ``conv_b``, ``A_log``, ``D``,
``dt_bias`` (nh,) f32, ``gate_norm`` (d_inner,) (an RMSNorm whatever
the config's norm, as in JAX), ``out_proj``),
``final_norm`` and ``lm_head`` (d, V).  The cache: ``state``
(n_layers, B, nh, hp, dn) f32 and ``conv`` (n_layers, B, W - 1, conv_dim),
written in place by a warm step (JAX returns a new one).

Inside a step over a mesh with |model| > 1 (launch/steps.py) the block
runs on this rank's shards (``mamba_block``), the embedding and the LM
head as the transformer's (models/tp.py).  ``norm`` and ``final_norm``
act on the residual stream, whole on every rank with whole weights
("embed" maps to no mesh axis), so LayerNorm needs no sum over
``model``; the gated RMSNorm over the sharded d_inner sums its squares
(``tp.rms_norm``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch import device as device_lib
from repro_torch.core import baos as baos_lib
from repro_torch.core import mx
from repro_torch.kernels import fused_head_sampling
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import layers, tp as tp_lib, transformer
from repro_torch.models.config import ModelConfig

# SSD chunk length: divides every segment fed to the model
SSD_CHUNK = 16


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., l) -> (..., l, l) lower-triangular pairwise sums
    segsum[i, j] = sum_{k=j+1..i} a_k for i >= j, else -inf."""
    l = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((l, l), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor,
                h0: Optional[torch.Tensor] = None, chunk: int = SSD_CHUNK
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan.  x (b, s, h, p), dt (b, s, h), A (h,), B, C (b, s, g, n).
    Returns (y (b, s, h, p) f32, chunk_states (b, nc + 1, h, p, n) f32):
    chunk_states[:, i] is the state at the start of chunk i (position
    i * chunk), the last one the final state."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError(f"seq {s} not a multiple of ssd chunk {chunk}")
    nc, rep, f32 = s // chunk, h // g, torch.float32
    xd = (x * dt[..., None]).to(f32)                        # (b,s,h,p)
    Bh = B.repeat_interleave(rep, dim=2).to(f32)            # (b,s,h,n)
    Ch = C.repeat_interleave(rep, dim=2).to(f32)
    a = (A[None, None, :] * dt).to(f32)                     # (b,s,h) < 0

    def ch(t):
        return t.reshape(b, nc, chunk, *t.shape[2:])
    xc, Bc, Cc = ch(xd), ch(Bh), ch(Ch)
    ac_h = ch(a).transpose(2, 3)                            # (b,nc,h,Q)

    # intra-chunk (quadratic) term: (C B^T ∘ L) x per chunk and head
    Lmat = torch.exp(_segsum(ac_h))                         # (b,nc,h,Q,Q)
    scores = torch.einsum("bclhn,bcshn->bchls", Cc, Bc) * Lmat
    y_intra = torch.einsum("bchls,bcshp->bclhp", scores, xc)

    # chunk states
    cum = torch.cumsum(ac_h, dim=-1)                        # (b,nc,h,Q)
    decay_to_end = torch.exp(cum[..., -1:] - cum)
    S_c = torch.einsum("bcshp,bcshn->bchpn",
                       xc * decay_to_end.transpose(2, 3)[..., None], Bc)

    # inter-chunk recurrence, one step per chunk
    chunk_decay = torch.exp(cum[..., -1])                   # (b,nc,h)
    state = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
             if h0 is None else h0.to(f32))
    starts = []
    for c in range(nc):
        starts.append(state)
        state = state * chunk_decay[:, c, :, None, None] + S_c[:, c]
    starts_t = torch.stack(starts, dim=1)                   # (b,nc,h,p,n)
    all_states = torch.cat([starts_t, state[:, None]], dim=1)

    y_inter = torch.einsum("bclhn,bchpn->bclhp", Cc, starts_t) * \
        torch.exp(cum).transpose(2, 3)[..., None]
    return (y_intra + y_inter).reshape(b, s, h, p), all_states


def ssd_ref(x, dt, A, B, C, h0=None) -> torch.Tensor:
    """Sequential recurrence, one position at a time (the tests' oracle;
    never on a path)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    Bh = B.repeat_interleave(rep, dim=2).to(torch.float32)
    Ch = C.repeat_interleave(rep, dim=2).to(torch.float32)
    xd = (x * dt[..., None]).to(torch.float32)
    a = torch.exp((A[None, None, :] * dt).to(torch.float32))
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if h0 is None else h0.to(torch.float32))
    ys = []
    for t in range(s):
        state = state * a[:, t][..., None, None] + \
            xd[:, t][..., None] * Bh[:, t][..., None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    return torch.stack(ys, dim=1)


# ---------------------------------------------------------------------------
# Mamba2 block + model
# ---------------------------------------------------------------------------

def mamba_dims(cfg: ModelConfig) -> Tuple[int, int, int, int, int, int]:
    """(d_inner, headdim, nheads, ngroups, d_state, conv_dim)."""
    d_inner = 2 * cfg.d_model
    headdim = cfg.ssm_head_dim
    ngroups = 1
    return (d_inner, headdim, d_inner // headdim, ngroups, cfg.ssm_state,
            d_inner + 2 * ngroups * cfg.ssm_state)


def mamba_block(x: torch.Tensor, lp: Dict, cfg: ModelConfig,
                h0: Optional[torch.Tensor] = None,
                conv_state: Optional[torch.Tensor] = None,
                chunk: int = SSD_CHUNK, capture_at=None):
    """x (B, S, d_model), normed -> (y, chunk_states, the W - 1 pre-conv
    rows before ``capture_at`` or None).

    Under the tensor-parallel body (models/tp.py) with ``d_inner``
    sharded over ``model`` (JAX's ``mamba_layer_specs`` under GSPMD) the
    block runs on this rank's shards:

      * the in_proj output [z | xBC | dt] whole on every rank (gathered
        when in_proj's columns are sharded: a column shard cuts across
        the pieces and the heads);
      * the depthwise conv on this rank's channels of xBC when ``conv_w``
        and the conv cache shard (a channel shard is not a head
        boundary), gathered whole; else on every channel;
      * the SSD scan on this rank's heads when they divide over ``model``
        (the state cache then holds those heads), else on every head; B
        and C whole either way;
      * the gated RMSNorm on this rank's channels, its sum of squares
        summed over ``model``, then ``out_proj`` row-parallel.

    Every rank then feeds a different part of the whole to the loss, so a
    replicated leaf (A_log, D, dt_bias, a whole conv) enters through
    ``tp.copy_in`` and the gathers sum their gradient over ``model``."""
    d_inner, hp, nh, ng, dn, conv_dim = mamba_dims(cfg)
    B_, S, _ = x.shape
    W = cfg.conv_width
    axis = tp_lib.model_axis()
    r0, r1 = tp_lib.shard_range(d_inner, lp["gate_norm"].shape[0], axis)
    part = r1 - r0 != d_inner
    conv_sharded = lp["conv_w"].shape[1] != conv_dim
    if axis is not None and not part and (
            conv_sharded or lp["in_proj"].shape[1] != 2 * d_inner +
            2 * ng * dn + nh):
        raise ValueError(f"mamba block over |model| {axis.size}: d_inner "
                         f"{d_inner} is whole but in_proj or the conv is "
                         f"sharded")
    rep = tp_lib.copy_in if part else (lambda t: t)
    zxbcdt = tp_lib.col(x, lp["in_proj"], 2 * d_inner + 2 * ng * dn + nh,
                        gather=part)
    z, xbc_raw, dtv = torch.split(zxbcdt, [d_inner, conv_dim, nh], dim=-1)
    conv_w, conv_b = lp["conv_w"], lp["conv_b"]
    if conv_sharded:
        c0, c1 = tp_lib.shard_range(conv_dim, conv_w.shape[1], axis)
        xbc_raw = xbc_raw[..., c0:c1]
    else:
        conv_w, conv_b = rep(conv_w), rep(conv_b)
    conv_capture = (None if capture_at is None
                    else layers.capture_rows(xbc_raw, capture_at, W - 1))
    xbc = F.silu(layers.causal_conv(xbc_raw, conv_w, conv_state) + conv_b)
    if conv_sharded:
        xbc = mesh_lib.gather(xbc, -1, axis)
    xs, Bv, Cv = torch.split(xbc, [d_inner, ng * dn, ng * dn], dim=-1)
    h0_, h1_ = ((r0 // hp, r1 // hp) if part and nh % axis.size == 0
                else (0, nh))
    xs = xs.reshape(B_, S, nh, hp)[:, :, h0_:h1_]
    dt = layers.softplus(dtv[..., h0_:h1_].to(torch.float32) +
                         rep(lp["dt_bias"])[h0_:h1_])
    A = -torch.exp(rep(lp["A_log"])[h0_:h1_])
    y, states = ssd_chunked(xs, dt, A, Bv.reshape(B_, S, ng, dn),
                            Cv.reshape(B_, S, ng, dn), h0, chunk)
    y = y + rep(lp["D"])[h0_:h1_][None, None, :, None] * \
        xs.to(torch.float32)
    y = y.reshape(B_, S, -1).to(x.dtype)
    if y.shape[-1] != r1 - r0:
        y = y[..., r0:r1]
    y = tp_lib.rms_norm(y * F.silu(z[..., r0:r1]), lp["gate_norm"], d_inner,
                        cfg.norm_eps)
    return tp_lib.row(y, lp["out_proj"], d_inner), states, conv_capture


class MambaModel:
    """Mamba2 dLLM backbone on one device, with the transformer's forward
    contract (``cfg``, ``init``, ``init_cache``, ``forward``)."""

    supports_head_mode = False

    def __init__(self, cfg: ModelConfig,
                 device: Union[str, torch.device] = "cuda"):
        if cfg.family != "ssm":
            raise ValueError(f"MambaModel runs family 'ssm', not "
                             f"{cfg.family!r}")
        self.cfg = cfg
        self.chunk = SSD_CHUNK
        self.device = device_lib.resolve(device)

    def init(self, seed: int = 0) -> Dict:
        """Seeded parameters with the JAX package's distributions (torch's
        draws; for parity convert JAX's with ``bridge``)."""
        cfg, dev = self.cfg, self.device
        d_inner, hp, nh, ng, dn, conv_dim = mamba_dims(cfg)
        gen = layers.seeded_generator(dev, seed)
        dt, f32 = cfg.torch_dtype, torch.float32

        def dense(d_in, d_out):
            return layers.dense_init(gen, d_in, d_out, dt, dev)

        stack = []
        for _ in range(cfg.n_layers):
            conv_w = torch.randn((cfg.conv_width, conv_dim), generator=gen,
                                 dtype=f32, device=dev) * 0.1
            stack.append({
                "norm": transformer.norm_params(cfg, cfg.d_model, dev),
                "in_proj": dense(cfg.d_model, 2 * d_inner + 2 * ng * dn + nh),
                "conv_w": conv_w.to(dt),
                "conv_b": torch.zeros((conv_dim,), dtype=dt, device=dev),
                "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=f32,
                                                  device=dev)),
                "D": torch.ones((nh,), dtype=f32, device=dev),
                "dt_bias": torch.zeros((nh,), dtype=f32, device=dev),
                "gate_norm": torch.ones((d_inner,), dtype=dt, device=dev),
                "out_proj": dense(d_inner, cfg.d_model)})
        return {"embed": layers.embed_init(gen, cfg.vocab, cfg.d_model, dt,
                                           dev),
                "layers": stack,
                "final_norm": transformer.norm_params(cfg, cfg.d_model,
                                                      dev),
                "lm_head": fused_head_sampling.pad_head(
                    dense(cfg.d_model, cfg.vocab))}

    def param_specs(self) -> Dict:
        """The logical axes of ``init``'s tree, JAX's ``param_specs``
        (``mamba_layer_specs`` per layer)."""
        layer = {"norm": transformer.norm_specs(self.cfg.norm),
                 "in_proj": ("embed", "mlp"),
                 "conv_w": (None, "mlp"), "conv_b": ("mlp",),
                 "A_log": (None,), "D": (None,), "dt_bias": (None,),
                 "gate_norm": ("mlp",), "out_proj": ("mlp", "embed")}
        return {"embed": ("vocab", "embed"),
                "layers": [dict(layer) for _ in range(self.cfg.n_layers)],
                "final_norm": transformer.norm_specs(self.cfg.norm),
                "lm_head": ("embed", "vocab")}

    def cache_specs(self, act_len: Optional[int] = None) -> Dict:
        return {"state": ("layers", "batch", "heads", None, None),
                "conv": ("layers", "batch", None, "mlp")}

    def init_cache(self, batch: int, s_tot: int,
                   act_len: Optional[int] = None,
                   device: Union[str, torch.device, None] = None) -> Dict:
        """The zeroed state (n_layers, B, nh, hp, dn) f32 and conv rows
        (n_layers, B, W - 1, conv_dim); ``s_tot`` sizes nothing (no KV).
        ``act_len`` (the split attention cache) is inapplicable: no KV
        cache, as in JAX.
        ``device="meta"`` gives shapes and dtypes without allocating."""
        cfg = self.cfg
        dev = self.device if device is None else device
        d_inner, hp, nh, ng, dn, conv_dim = mamba_dims(cfg)
        return {"state": torch.zeros((cfg.n_layers, batch, nh, hp, dn),
                                     dtype=torch.float32, device=dev),
                "conv": torch.zeros((cfg.n_layers, batch,
                                     cfg.conv_width - 1, conv_dim),
                                    dtype=cfg.torch_dtype, device=dev)}

    def forward(self, params: Dict, tokens: torch.Tensor, *,
                cache: Optional[Dict] = None, seg_start=0, kv_valid=None,
                baos_cfg: Optional[baos_lib.BAOSConfig] = None,
                calibrate: bool = False, calib_mask=None,
                logits_slice=None, head_mode: str = "logits", quant=None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
        """tokens (B, S) -> (logits (B, S', V), the cache).  Without a
        cache a full forward; with one and ``calibrate`` the warm step (a
        full forward that writes each layer's state and conv rows captured
        at ``logits_slice[0]``, or 0 without a slice, into the cache); with
        one and no ``calibrate`` a refine step that replays the segment
        from the cache.  ``seg_start``, ``kv_valid`` and ``calib_mask`` are
        ignored, as in JAX (the SSM is causal and has no KV); ``quant``
        reaches only the LM head product, as in JAX."""
        layers.check_head_mode(head_mode)
        cfg = self.cfg
        x = transformer.embed(params, cfg, tokens)
        warm = calibrate and cache is not None
        capture_at = (logits_slice[0] if warm and logits_slice is not None
                      else 0)
        for i, lp in enumerate(params["layers"]):
            h = transformer.apply_norm(x, lp["norm"], cfg)
            if cache is None:
                y, _, _ = mamba_block(h, lp, cfg, chunk=self.chunk)
            elif warm:
                y, states, conv0 = mamba_block(h, lp, cfg, chunk=self.chunk,
                                               capture_at=capture_at)
                s0 = _chunk_state(states, capture_at, self.chunk)
                if baos_cfg is not None and baos_cfg.enabled:
                    s0 = mx.mx_fake_quant(s0, baos_cfg.kv_format)
                cache["state"][i].copy_(s0)
                cache["conv"][i].copy_(conv0)
            else:
                y, _, _ = mamba_block(h, lp, cfg, cache["state"][i],
                                      cache["conv"][i], self.chunk)
            x = x + y
        x = transformer.apply_norm(x, params["final_norm"], cfg)
        if logits_slice is not None:
            x = transformer.rows(x, *logits_slice)
        return transformer.head_logits(x, params, cfg, quant), cache


def _chunk_state(states: torch.Tensor, capture_at, chunk: int
                 ) -> torch.Tensor:
    """states (b, nc + 1, ...) at chunk capture_at // chunk (an int or a
    one-element device tensor)."""
    if isinstance(capture_at, torch.Tensor):
        idx = torch.div(capture_at.reshape(1).to(torch.int64), chunk,
                        rounding_mode="floor")
        return states.index_select(1, idx)[:, 0]
    return states[:, capture_at // chunk]

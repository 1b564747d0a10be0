"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks + local
attention, ported from src/repro/models/rglru.py.

The layer pattern is (rec, rec, attn) repeated: 26 layers are 8 triples
and 2 tail recurrent layers.  The attention layers follow the dense model
(a windowed MQA KV cache, BAOS-smoothed: transformer.cache_attention, so
flash_bidir and baos_mx_quant on the card); the recurrent layers follow
the SSM model (a warm step captures each layer's RG-LRU hidden state at
``capture_at - 1`` and its W - 1 pre-conv rows before ``capture_at``; a
refine step replays the segment from them and leaves them as they are).

``rglru_scan`` is JAX's ``lax.associative_scan``, recursion for recursion:
O(log S) levels of strided even/odd slices, never a loop over positions,
so the order of the f32 combines is XLA's.  JAX computes it outside any
Pallas kernel, so it stays plain PyTorch.

Parameters: ``embed``, ``triples`` (a list of ``{"rec1", "rec2",
"attn"}``), ``tail`` (a list of 2), ``final_norm``, ``lm_head``; each
sub-layer a dict ``ln1``, ``ln2``, ``temporal`` (rec: ``w_y``,
``w_gate``, ``conv_w``, ``conv_b``, ``w_a``, ``b_a``, ``w_x``, ``b_x``,
``lam`` f32, ``w_out``; attn: ``wq``, ``wk``, ``wv``, ``wo``) and
``mlp`` (``w_gate``, ``w_up``, ``w_down``: GeGLU).  ``ln1``, ``ln2`` and
``final_norm`` are the config's norm, rms or ln
(``transformer.apply_norm``).  As in JAX the stack reads neither
``cfg.ffn`` (the MLP is always GeGLU) nor ``cfg.attn_mode`` (attention is
always bidirectional) nor ``cfg.score_dtype``: its attention layers keep
f32 scores (JAX's rglru passes no score dtype), without a cache and
through ``transformer.cache_attention``'s default.  The cache: ``k``,
``v`` (nt, B, s_tot, Hkv, D), the four BAOS calibration arrays
(nt, B, 1, Hkv, D) f32, ``rec_state`` (nt, 2, B, d_rnn) f32 and
``rec_conv`` (nt, 2, B, W - 1, d_rnn) (batch on axis 2), ``tail_state``
(2, B, d_rnn) f32 and ``tail_conv`` (2, B, W - 1, d_rnn), written in place.

Inside a step over a mesh with |model| > 1 (launch/steps.py) the layers
run on this rank's shards (models/tp.py): ``rec_block`` and the GeGLU MLP
as their docstrings say, the attention layers as the transformer's
(local or gathered heads, a head- or context-parallel cache), the
recurrent cache leaves sharded with their channels.  The norms act on
the residual stream, whose rows are whole on every rank, with whole
weights ("embed" maps to no mesh axis): LayerNorm's mean and variance
need no sum over ``model``, unlike the gated RMSNorm of a sharded channel
dim (``tp.rms_norm``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch import device as device_lib
from repro_torch.core import baos as baos_lib
from repro_torch.kernels import fused_head_sampling
from repro_torch.models import layers, tp as tp_lib, transformer
from repro_torch.models.config import ModelConfig

RGLRU_C = 8.0
ATTN_KEYS = ("k", "v", "k_center", "k_scale", "v_center", "v_scale")


# ---------------------------------------------------------------------------
# RG-LRU recurrence
# ---------------------------------------------------------------------------

def _combine(lhs, rhs):
    a1, b1 = lhs
    a2, b2 = rhs
    return a2 * a1, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], ... along dim 1 (even one longer, or
    the same length)."""
    m = odd.shape[1]
    out = torch.stack([even[:, :m], odd], dim=2).reshape(
        (odd.shape[0], 2 * m) + odd.shape[2:])
    if even.shape[1] > m:
        out = torch.cat([out, even[:, m:]], dim=1)
    return out


def associative_scan(a: torch.Tensor, b: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of h -> a h + b along dim 1: ``jax.lax.
    associative_scan`` with ``_combine``, the same recursion (pairs
    combined, the half-length scan, the even positions filled in)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd = associative_scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]),
                                     (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        odd_head = (odd[0][:, :-1], odd[1][:, :-1])
    else:
        odd_head = odd
    ea, eb = _combine(odd_head, (a[:, 2::2], b[:, 2::2]))
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, odd[0]), _interleave(eb, odd[1])


def rglru_scan(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
               lam: torch.Tensor, h0: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """x, r, i (B, S, D); lam (D,) the learnable Λ.
    h_t = a_t h_(t-1) + sqrt(1 - a_t^2) (i_t ⊙ x_t),
    a_t = exp(-c softplus(Λ) r_t).  Returns h (B, S, D) f32."""
    f32 = torch.float32
    log_a = -RGLRU_C * layers.softplus(lam)[None, None, :] * r.to(f32)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=0.0)) * \
        (i.to(f32) * x.to(f32))
    sa, sb = associative_scan(a, b)
    if h0 is None:
        return sb
    return sb + sa * h0[:, None, :].to(f32)


def rglru_ref(x, r, i, lam, h0=None) -> torch.Tensor:
    """Sequential recurrence, one position at a time (the tests' oracle;
    never on a path)."""
    log_a = -RGLRU_C * layers.softplus(lam)[None, :]
    B, S, D = x.shape
    h = (torch.zeros((B, D), dtype=torch.float32, device=x.device)
         if h0 is None else h0.to(torch.float32))
    hs = []
    for t in range(S):
        a = torch.exp(log_a * r[:, t].to(torch.float32))
        h = a * h + torch.sqrt(torch.clamp(1 - a * a, min=0)) * \
            (i[:, t] * x[:, t]).to(torch.float32)
        hs.append(h)
    return torch.stack(hs, dim=1)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def rec_block(x: torch.Tensor, p: Dict, cfg: ModelConfig, h0=None,
              conv_state=None, capture_at=None):
    """Griffin's recurrent temporal block on its normed input x
    (B, S, d_model).  Returns (y, h at capture_at - 1 (B, d_rnn) f32 or
    None, the W - 1 pre-conv rows before capture_at or None).

    Under the tensor-parallel body (models/tp.py, JAX's ``rec_block_specs``)
    the recurrence width shards over ``model`` where it divides: ``w_y``
    and ``w_gate`` are column products, the conv, ``lam`` and the scan run
    on this rank's channels, the square gates ``w_a``/``w_x`` (rows over
    ``model``) are row-parallel with the rank keeping its channels of the
    sum (``tp.row_gate``), and ``w_out`` is row-parallel."""
    W, dr = cfg.conv_width, cfg.d_rnn
    hin = tp_lib.copy_in(x)
    y = tp_lib.col(x, p["w_y"], dr, hin=hin)
    gate = layers.gelu(tp_lib.col(x, p["w_gate"], dr, hin=hin))
    conv_cap = (None if capture_at is None
                else layers.capture_rows(y, capture_at, W - 1))
    y = layers.causal_conv(y, p["conv_w"], conv_state) + p["conv_b"]
    r = torch.sigmoid(tp_lib.row_gate(y, p["w_a"], p["b_a"], dr))
    i = torch.sigmoid(tp_lib.row_gate(y, p["w_x"], p["b_x"], dr))
    h = rglru_scan(y, r, i, p["lam"], h0)
    h_cap = None if capture_at is None else layers.row_at(h, capture_at)
    out = tp_lib.row(h.to(x.dtype) * gate, p["w_out"], dr)
    return out, h_cap, conv_cap


def geglu_mlp(x: torch.Tensor, p: Dict, d_ff: int) -> torch.Tensor:
    """The GeGLU MLP; under the tensor-parallel body ``w_gate``/``w_up``
    column products and ``w_down`` row-parallel, as the transformer's
    FFN."""
    hin = tp_lib.copy_in(x)
    h = layers.gelu(tp_lib.col(x, p["w_gate"], d_ff, hin=hin)) * \
        tp_lib.col(x, p["w_up"], d_ff, hin=hin)
    return tp_lib.row(h, p["w_down"], d_ff)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

class GriffinModel:
    """The Griffin stack on one device: ``n_layers // 3`` (rec, rec, attn)
    triples and 2 tail rec layers, with the transformer's forward contract
    (``cfg``, ``init``, ``init_cache``, ``forward``)."""

    supports_head_mode = False

    def __init__(self, cfg: ModelConfig,
                 device: Union[str, torch.device] = "cuda"):
        if cfg.family != "hybrid":
            raise ValueError(f"GriffinModel runs family 'hybrid', not "
                             f"{cfg.family!r}")
        if cfg.n_layers % 3 != 2:
            raise ValueError(
                f"expect 3k+2 layers (rec,rec,attn)*k + 2; "
                f"got n_layers={cfg.n_layers}")
        self.cfg = cfg
        self.n_triples = cfg.n_layers // 3
        self.device = device_lib.resolve(device)

    # -- params ------------------------------------------------------------
    def init(self, seed: int = 0) -> Dict:
        """Seeded parameters with the JAX package's distributions (torch's
        draws; for parity convert JAX's with ``bridge``)."""
        cfg, dev = self.cfg, self.device
        gen = layers.seeded_generator(dev, seed)
        dt, f32 = cfg.torch_dtype, torch.float32
        d, dr = cfg.d_model, cfg.d_rnn
        hq, hkv = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head

        def dense(d_in, d_out):
            return layers.dense_init(gen, d_in, d_out, dt, dev)

        def vec(n, fill, dtype=dt):
            return torch.full((n,), fill, dtype=dtype, device=dev)

        def sub(kind):
            if kind == "rec":
                conv_w = torch.randn((cfg.conv_width, dr), generator=gen,
                                     dtype=f32, device=dev) * 0.1
                temporal = {"w_y": dense(d, dr), "w_gate": dense(d, dr),
                            "conv_w": conv_w.to(dt), "conv_b": vec(dr, 0.0),
                            "w_a": dense(dr, dr), "b_a": vec(dr, 0.0),
                            "w_x": dense(dr, dr), "b_x": vec(dr, 0.0),
                            "lam": vec(dr, 0.7, f32), "w_out": dense(dr, d)}
            else:
                temporal = {"wq": dense(d, hq), "wk": dense(d, hkv),
                            "wv": dense(d, hkv), "wo": dense(hq, d)}
            return {"ln1": transformer.norm_params(cfg, d, dev),
                    "ln2": transformer.norm_params(cfg, d, dev),
                    "temporal": temporal,
                    "mlp": {"w_gate": dense(d, cfg.d_ff),
                            "w_up": dense(d, cfg.d_ff),
                            "w_down": dense(cfg.d_ff, d)}}

        return {"embed": layers.embed_init(gen, cfg.vocab, d, dt, dev),
                "triples": [{"rec1": sub("rec"), "rec2": sub("rec"),
                             "attn": sub("attn")}
                            for _ in range(self.n_triples)],
                "tail": [sub("rec") for _ in range(2)],
                "final_norm": transformer.norm_params(cfg, d, dev),
                "lm_head": fused_head_sampling.pad_head(
                    dense(d, cfg.vocab))}

    def _sub_specs(self, kind: str) -> Dict:
        if kind == "rec":
            t = {"w_y": ("embed", "mlp"), "w_gate": ("embed", "mlp"),
                 "conv_w": (None, "mlp"), "conv_b": ("mlp",),
                 "w_a": ("mlp", None), "b_a": ("mlp",),
                 "w_x": ("mlp", None), "b_x": ("mlp",),
                 "lam": ("mlp",), "w_out": ("mlp", "embed")}
        else:
            t = {"wq": ("embed", "heads"), "wk": ("embed", "heads"),
                 "wv": ("embed", "heads"), "wo": ("heads", "embed")}
        norm = transformer.norm_specs(self.cfg.norm)
        return {"ln1": norm, "ln2": norm, "temporal": t,
                "mlp": {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
                        "w_down": ("mlp", "embed")}}

    def param_specs(self) -> Dict:
        """The logical axes of ``init``'s tree, JAX's ``param_specs``."""
        return {"embed": ("vocab", "embed"),
                "triples": [{"rec1": self._sub_specs("rec"),
                             "rec2": self._sub_specs("rec"),
                             "attn": self._sub_specs("attn")}
                            for _ in range(self.n_triples)],
                "tail": [self._sub_specs("rec") for _ in range(2)],
                "final_norm": transformer.norm_specs(self.cfg.norm),
                "lm_head": ("embed", "vocab")}

    # -- cache ---------------------------------------------------------------
    def cache_specs(self, act_len: Optional[int] = None) -> Dict:
        kv = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
        cal = ("layers", "batch", None, "kv_heads", "head_dim")
        return {"k": kv, "v": kv, "k_center": cal, "k_scale": cal,
                "v_center": cal, "v_scale": cal,
                "rec_state": ("layers", None, "batch", "mlp"),
                "rec_conv": ("layers", None, "batch", None, "mlp"),
                "tail_state": (None, "batch", "mlp"),
                "tail_conv": (None, "batch", None, "mlp")}

    def init_cache(self, batch: int, s_tot: int,
                   act_len: Optional[int] = None,
                   device: Union[str, torch.device, None] = None) -> Dict:
        """Zeroed K/V, identity calibration, zeroed recurrent states and
        conv rows, with JAX's shapes and dtypes; ``device="meta"`` gives
        shapes and dtypes without allocating.  ``act_len`` (the split
        attention cache) is not applied to the hybrid, as in JAX."""
        cfg = self.cfg
        dev = self.device if device is None else device
        nt, dt, f32 = self.n_triples, cfg.torch_dtype, torch.float32
        kv = (nt, batch, s_tot, cfg.n_kv_heads, cfg.d_head)
        cal = (nt, batch, 1, cfg.n_kv_heads, cfg.d_head)
        W1, dr = cfg.conv_width - 1, cfg.d_rnn

        def full(shape, fill, dtype):
            return torch.full(shape, fill, dtype=dtype, device=dev)

        return {"k": full(kv, 0.0, dt), "v": full(kv, 0.0, dt),
                "k_center": full(cal, 0.0, f32),
                "k_scale": full(cal, 1.0, f32),
                "v_center": full(cal, 0.0, f32),
                "v_scale": full(cal, 1.0, f32),
                "rec_state": full((nt, 2, batch, dr), 0.0, f32),
                "rec_conv": full((nt, 2, batch, W1, dr), 0.0, dt),
                "tail_state": full((2, batch, dr), 0.0, f32),
                "tail_conv": full((2, batch, W1, dr), 0.0, dt)}

    # -- forward -------------------------------------------------------------
    def _rec_sub(self, x, p, h0=None, conv=None, capture_at=None):
        cfg = self.cfg
        y, hc, cc = rec_block(transformer.apply_norm(x, p["ln1"], cfg),
                              p["temporal"], cfg, h0, conv, capture_at)
        x = x + y
        x = x + geglu_mlp(transformer.apply_norm(x, p["ln2"], cfg), p["mlp"],
                          cfg.d_ff)
        return x, hc, cc

    def _attn_sub(self, x, p, lcache, *, seg_start, positions, kv_valid,
                  baos_cfg, calibrate, calib_mask):
        cfg = self.cfg
        h = transformer.apply_norm(x, p["ln1"], cfg)
        layout = transformer.attn_layout(p["temporal"], cfg)
        q, k, v = transformer.qkv(h, p["temporal"], cfg, positions,
                                  layout=layout)
        if lcache is None:
            # no cache: every position is valid and kv_valid is ignored,
            # as in JAX
            attn = layers.attention(q, k, v, window=cfg.window)
        else:
            attn = transformer.cache_attention(
                q, k, v, lcache, seg_start, kv_valid, cfg, baos_cfg,
                calibrate, calib_mask)
        x = x + transformer.out_proj(attn, p["temporal"]["wo"], cfg,
                                     layout=layout)
        return x + geglu_mlp(transformer.apply_norm(x, p["ln2"], cfg),
                             p["mlp"], cfg.d_ff)

    def forward(self, params: Dict, tokens: torch.Tensor, *,
                cache: Optional[Dict] = None, seg_start=0,
                kv_valid: Optional[torch.Tensor] = None,
                baos_cfg: Optional[baos_lib.BAOSConfig] = None,
                calibrate: bool = False,
                calib_mask: Optional[torch.Tensor] = None,
                logits_slice=None, head_mode: str = "logits", quant=None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
        """tokens (B, S) at positions seg_start + r -> (logits (B, S', V),
        the cache).  Without a cache a full forward (attention over every
        position, ``kv_valid`` ignored).  With one and ``calibrate``, the
        warm step: the attention layers write their K/V (and with BAOS the
        calibration) as the dense model does, the recurrent layers their
        state and conv rows captured at ``logits_slice[0]`` (0 without a
        slice).  With one and no ``calibrate``, a refine step: K/V written
        at ``seg_start``, the recurrent layers replayed from the cache.
        ``quant`` reaches only the LM head product, as in JAX."""
        layers.check_head_mode(head_mode)
        cfg = self.cfg
        baos_cfg = baos_cfg or baos_lib.BAOSConfig(enabled=False)
        B, S = tokens.shape
        if cache is not None:
            s_tot = transformer.cache_len(cache)
            if not isinstance(seg_start, torch.Tensor) and \
                    not 0 <= seg_start <= s_tot - S:
                raise ValueError(f"segment [{seg_start}, {seg_start + S}) "
                                 f"does not fit a {s_tot}-long cache")
        x = transformer.embed(params, cfg, tokens)
        positions = transformer.start_of(seg_start) + torch.arange(
            S, device=x.device)
        warm = calibrate and cache is not None
        capture_at = (logits_slice[0] if warm and logits_slice is not None
                      else 0)
        attn_kw = dict(seg_start=seg_start, positions=positions,
                       kv_valid=kv_valid, baos_cfg=baos_cfg,
                       calibrate=calibrate, calib_mask=calib_mask)

        def rec(x, p, state, conv):
            """One rec sub-layer; ``state``/``conv`` its cache views."""
            if cache is None:
                return self._rec_sub(x, p)[0]
            if not warm:
                return self._rec_sub(x, p, state, conv)[0]
            x, hc, cc = self._rec_sub(x, p, capture_at=capture_at)
            state.copy_(hc)
            conv.copy_(cc)
            return x

        for t, tp in enumerate(params["triples"]):
            for j, name in enumerate(("rec1", "rec2")):
                x = rec(x, tp[name],
                        *((None, None) if cache is None else
                          (cache["rec_state"][t, j], cache["rec_conv"][t, j])))
            lcache = (None if cache is None else
                      {name: cache[name][t] for name in ATTN_KEYS})
            x = self._attn_sub(x, tp["attn"], lcache, **attn_kw)
        for j, tp in enumerate(params["tail"]):
            x = rec(x, tp,
                    *((None, None) if cache is None else
                      (cache["tail_state"][j], cache["tail_conv"][j])))
        x = transformer.apply_norm(x, params["final_norm"], cfg)
        if logits_slice is not None:
            x = transformer.rows(x, *logits_slice)
        return transformer.head_logits(x, params, cfg, quant), cache

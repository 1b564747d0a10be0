"""Block-Adaptive Online Smoothing (BAOS) of the dLLM KV cache, ported from
src/repro/core/baos.py.

Paper §4.4: blocked diffusion decoding recomputes the whole KV cache at
the warm step of every generation block, and BAOS uses that step as a free
online calibration point:

  * per-channel center c (mean, or the min/max midpoint), (B, 1, H, D)
  * per-channel radius f = max(x_max - c, c - x_min) ** alpha

The cache holds x_s = (x - c) / f through the MX quantizer
(kernels/baos_mx_quant.py on the card).  Attention folds the inverse scale
into the query (Q_s = Q * f_k) and corrects its output (out * f_v + c_v);
the K center cancels inside the softmax.  KV tensors are (B, S, H, D) and
calibration reduces over axis 1.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core import mx
from repro_torch.kernels import baos_mx_quant

# the KV formats the CUDA kernel quantizes: every format of core/mx
KV_FORMATS = tuple(baos_mx_quant.FMT_CODES)


@dataclasses.dataclass(frozen=True)
class BAOSConfig:
    enabled: bool = True
    variant: str = "minmax"          # "mean" (c = temporal mean) | "minmax"
    alpha: float = 1.0               # per-channel power transform, Eq. 9
    kv_format: str = "mxint4"        # MX format for the smoothed cache
    eps: float = 1e-6
    # "full_seq" reduces over the whole warm sequence; "active_block" over
    # the active block only (the paper's §4.4.2 scope)
    calib_scope: str = "full_seq"    # "full_seq" | "active_block"


class BAOSCalib(NamedTuple):
    """Per-generation-block calibration, each (B, 1, H_kv, D) f32."""
    k_center: torch.Tensor
    k_scale: torch.Tensor
    v_center: torch.Tensor
    v_scale: torch.Tensor


def _calibrate_one(x: torch.Tensor, cfg: BAOSConfig,
                   seq_mask: Optional[torch.Tensor] = None):
    """x (B, S, H, D) -> (center, scale), each (B, 1, H, D); ``seq_mask``
    (B, S) restricts the reduction (the active-block scope)."""
    xf = x.to(torch.float32)
    if seq_mask is not None:
        m = seq_mask[:, :, None, None].to(torch.bool)
        big = 3.4e38
        xmax = torch.amax(torch.where(m, xf, -big), dim=1, keepdim=True)
        xmin = torch.amin(torch.where(m, xf, big), dim=1, keepdim=True)
        mf = m.to(torch.float32)
        mean = torch.sum(xf * mf, dim=1, keepdim=True) / (
            torch.sum(mf, dim=1, keepdim=True) + 1e-9)
    else:
        xmax = torch.amax(xf, dim=1, keepdim=True)
        xmin = torch.amin(xf, dim=1, keepdim=True)
        mean = torch.mean(xf, dim=1, keepdim=True)
    if cfg.variant == "mean":
        center = mean
    elif cfg.variant == "minmax":
        center = 0.5 * (xmax + xmin)
    else:
        raise ValueError(f"unknown BAOS variant {cfg.variant!r}")
    f = torch.maximum(xmax - center, center - xmin)        # Eq. 8
    f = torch.clamp(f, min=cfg.eps)
    return center, f ** cfg.alpha                           # Eq. 9


def calibrate(k: torch.Tensor, v: torch.Tensor, cfg: BAOSConfig,
              seq_mask: Optional[torch.Tensor] = None) -> BAOSCalib:
    """Warm-step calibration from the freshly computed K/V (B, S, H, D)."""
    kc, kf = _calibrate_one(k, cfg, seq_mask)
    vc, vf = _calibrate_one(v, cfg, seq_mask)
    return BAOSCalib(kc, kf, vc, vf)


def identity_calib(batch: int, kv_heads: int, head_dim: int,
                   device="cpu") -> BAOSCalib:
    shape = (batch, 1, kv_heads, head_dim)
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    o = torch.ones(shape, dtype=torch.float32, device=device)
    return BAOSCalib(z, o, z, o)


def smooth_quantize(x: torch.Tensor, center: torch.Tensor,
                    scale: torch.Tensor, cfg: BAOSConfig,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(x - c)/f -> MX fake-quant in x's dtype (what the KV cache holds),
    written into ``out`` when given.  Enabled, this is the baos_mx_quant
    kernel on the card; disabled, the smoothing alone."""
    if cfg.enabled:
        return baos_mx_quant.baos_mx_quant(x, center, scale, cfg.kv_format,
                                           out=out)
    y = ((x.to(torch.float32) - center) / scale).to(x.dtype)
    return y if out is None else out.copy_(y)


def smooth_quantize_kv(k: torch.Tensor, v: torch.Tensor, calib: BAOSCalib,
                       cfg: BAOSConfig):
    ks = smooth_quantize(k, calib.k_center, calib.k_scale, cfg)
    vs = smooth_quantize(v, calib.v_center, calib.v_scale, cfg)
    return ks, vs


def _per_q_head(t: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    return torch.repeat_interleave(t, num_q_heads // t.shape[2], dim=2)


def scale_query(q: torch.Tensor, calib: BAOSCalib, num_q_heads: int
                ) -> torch.Tensor:
    """Q_s = Q * f_k in q's dtype, f_k broadcast per GQA group (the JAX
    model's rounding; the port's attention kernel applies f_k in f32)."""
    return q * _per_q_head(calib.k_scale.to(q.dtype), num_q_heads)


def correct_output(out_s: torch.Tensor, calib: BAOSCalib, num_q_heads: int
                   ) -> torch.Tensor:
    """Undo the V smoothing after attention: out = out_s * f_v + c_v."""
    fv = _per_q_head(calib.v_scale.to(out_s.dtype), num_q_heads)
    cv = _per_q_head(calib.v_center.to(out_s.dtype), num_q_heads)
    return out_s * fv + cv


def dequantize_kv(ks: torch.Tensor, vs: torch.Tensor, calib: BAOSCalib):
    """Reference unsmoothing (tests and checks; attention never needs it)."""
    k = ks.to(torch.float32) * calib.k_scale + calib.k_center
    v = vs.to(torch.float32) * calib.v_scale + calib.v_center
    return k.to(ks.dtype), v.to(vs.dtype)


def check_supported(cfg: BAOSConfig) -> None:
    """Raise for a KV format that core/mx does not know (every format it
    knows has a kernel)."""
    if cfg.enabled and cfg.kv_format not in mx.FORMATS:
        raise ValueError(f"unknown BAOS kv_format {cfg.kv_format!r}; "
                         f"core/mx knows {sorted(mx.FORMATS)}")


def outlier_channel_overlap(x_warm: torch.Tensor, x_refine: torch.Tensor,
                            top_frac: float = 0.01) -> torch.Tensor:
    """Paper §4.4.1's metric: the fraction of the top-|channel| (H, D)
    indices shared between the warm step's x (B, S, H, D) and a
    refinement step's (>70% in the paper's profiling); f32."""
    def top_idx(x):
        mag = torch.mean(torch.abs(x.to(torch.float32)), dim=(0, 1))
        flat = mag.reshape(-1)
        k = max(1, int(flat.shape[0] * top_frac))
        return torch.topk(flat, k).indices, k

    iw, k = top_idx(x_warm)
    ir, _ = top_idx(x_refine)
    shared = torch.sum(torch.isin(iw, ir))
    return shared.to(torch.float32) / k

// Helpers shared by the port's CUDA kernels: dtype conversion, warp
// reductions, the constants the Pallas kernels use (-1e30 for a masked
// score, 2^30 for "no index"), the counter-based Gumbel stream, the MX
// fake-quant of one 32-wide block per warp, and the merge of per-tile
// Stable-Max partials.  Every reduction leaves its result in all 32 lanes,
// taken from lane 0 so the lanes agree bit for bit.
//
// No fast-math anywhere: the MX exponent rule ceil(log2(amax / grid_max))
// and the Gumbel log must call the full-precision log2f/logf that
// torch.log2/torch.log call on the card, and divisions must be IEEE
// divisions, so that each kernel agrees with its plain PyTorch version.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu

constexpr float NEG = -1e30f;
constexpr int BIG = 1 << 30;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to storage type T (round to nearest even) and back to f32.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return __shfl_sync(FULL_MASK, v, 0);
}

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// Counter-based Gumbel noise (core/sampling.counter_gumbel)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// core/sampling.counter_gumbel, element by element.
__device__ __forceinline__ float counter_gumbel(uint32_t seed, uint32_t row,
                                                uint32_t col) {
  uint32_t h = mix32(row * 0x9E3779B9u ^ seed);
  h = mix32(h ^ col * 0x85EBCA6Bu);
  float u = (static_cast<float>(h >> 8) + 0.5f) * (1.0f / 16777216.0f);
  return -logf(-logf(u));
}

// ---------------------------------------------------------------------------
// MX fake-quant (core/mx.mx_fake_quant), one 32-wide block per warp
// ---------------------------------------------------------------------------

// Format codes: 0-2 are the sampling formats (core/sampling.SUPPORTED_FMTS
// order), 3-4 the integer KV formats of BAOS.
enum Fmt {
  FMT_NONE = 0,
  FMT_BF16 = 1,
  FMT_MXFP8 = 2,
  FMT_MXINT8 = 3,
  FMT_MXINT4 = 4
};

// OCP MX element grids: the largest magnitude and, for the INT formats,
// the fraction bits and the integer clip range.
__device__ __forceinline__ float grid_max(int fmt) {
  return fmt == FMT_MXFP8 ? 448.f : (fmt == FMT_MXINT8 ? 127.f / 64.f : 1.75f);
}

// Quantize one element already divided by its block's shared scale.
__device__ __forceinline__ float quant_element(float y, int fmt) {
  if (fmt == FMT_MXFP8) {
    // clip first: OCP MX saturates, and torch's cast is checked against it
    const float x = fminf(fmaxf(y, -448.f), 448.f);
    const __nv_fp8_storage_t q8 =
        __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3);
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(q8, __NV_E4M3)));
  }
  const bool int8 = fmt == FMT_MXINT8;
  const float step = int8 ? 64.f : 4.f;        // 2^frac_bits
  const float lo = int8 ? -128.f : -8.f, hi = int8 ? 127.f : 7.f;
  // round half away from zero: sign(t) * floor(|t| + 0.5); t is exact
  // (a power-of-two multiple), so no contraction can change it
  const float t = __fmul_rn(y, step);
  const float mag = floorf(__fadd_rn(fabsf(t), 0.5f));
  const float r = t > 0.f ? mag : (t < 0.f ? -mag : 0.f);
  return __fmul_rn(fminf(fmaxf(r, lo), hi), 1.f / step);
}

// Fake-quant of one value per lane; the warp's 32 lanes are one MX block
// (pad lanes hold 0).  Must be called by all 32 lanes together.  The result
// is rounded to T, as core/mx.mx_fake_quant returns its input's dtype.
template <typename T>
__device__ __forceinline__ float fake_quant(float v, int fmt) {
  if (fmt == FMT_NONE) return v;
  if (fmt == FMT_BF16) return round_to<T>(round_to<__nv_bfloat16>(v));
  const float amax = warp_max(fabsf(v));
  float scale = 1.f;
  if (amax > 0.f) {
    float e = ceilf(log2f(amax / grid_max(fmt)));
    e = fminf(fmaxf(e, -127.f), 127.f);
    scale = exp2f(e);
  }
  return round_to<T>(__fmul_rn(quant_element(v / scale, fmt), scale));
}

// ---------------------------------------------------------------------------
// Merge of per-tile Stable-Max partials (core/sampling.combine_partials)
// ---------------------------------------------------------------------------

// One warp merges one row's n_vt partials: m = max m_t,
// s = sum s_t e^(m_t - m), the index the lowest column among the tiles
// holding the max -- or, with Gumbel, among the tiles holding the best
// score, with z_at from that tile.  conf = 1/s, or e^(z_at - m)/s.
__device__ __forceinline__ void combine_row(
    const float* __restrict__ part_m, const int* __restrict__ part_i,
    const float* __restrict__ part_s, const float* __restrict__ part_b,
    const float* __restrict__ part_z, int r, int n_vt, bool gumbel,
    float* __restrict__ conf, int* __restrict__ token) {
  const int lane = threadIdx.x & 31;
  const size_t base = static_cast<size_t>(r) * n_vt;
  float m = NEG;
  for (int t = lane; t < n_vt; t += 32) m = fmaxf(m, part_m[base + t]);
  m = warp_max(m);
  float s = 0.f;
  for (int t = lane; t < n_vt; t += 32)
    s += part_s[base + t] * expf(part_m[base + t] - m);
  s = warp_sum(s);
  int idx = BIG;
  float zat = NEG;
  if (!gumbel) {
    for (int t = lane; t < n_vt; t += 32)
      if (part_m[base + t] >= m) idx = min(idx, part_i[base + t]);
    idx = warp_min(idx);
  } else {
    float best = -INFINITY;
    for (int t = lane; t < n_vt; t += 32) best = fmaxf(best, part_b[base + t]);
    best = warp_max(best);
    for (int t = lane; t < n_vt; t += 32) {
      if (part_b[base + t] >= best && part_i[base + t] < idx) {
        idx = part_i[base + t];
        zat = part_z[base + t];
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const int oi = __shfl_xor_sync(FULL_MASK, idx, o);
      const float oz = __shfl_xor_sync(FULL_MASK, zat, o);
      if (oi < idx) {
        idx = oi;
        zat = oz;
      }
    }
  }
  if (lane == 0) {
    conf[r] = gumbel ? expf(zat - m) / s : 1.f / s;
    token[r] = idx;
  }
}

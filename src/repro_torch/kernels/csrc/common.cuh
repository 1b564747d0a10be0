// Helpers shared by the port's CUDA kernels: dtype conversion, warp
// reductions, the constants the Pallas kernels use (-1e30 for a masked
// score, 2^30 for "no index"), the counter-based Gumbel stream, the MX
// fake-quant of one 32-wide block per warp, 8-wide lanes with one MX block
// per quad (16-byte loads, block scales computed once per quad), the merge
// of per-tile Stable-Max partials, and PTX wrappers for cp.async, ldmatrix
// and mma.sync (bf16 in, f32 accumulate).  Every reduction leaves its result
// in all 32 lanes, taken from lane 0 so the lanes agree bit for bit.
//
// No fast-math anywhere: the MX exponent rule ceil(log2(amax / grid_max))
// and the Gumbel log must call the full-precision log2f/logf that
// torch.log2/torch.log call on the card, and divisions must be IEEE
// divisions (or multiplies by an exact inverse power of two, which round
// alike), so that each kernel agrees with its plain PyTorch version.  The
// one approximation is stablemax_sampling's exp-sum, which feeds conf
// alone (ex2.approx; conf is held to 1e-2).
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

// bf16 attention scores (JAX's score_dtype=bfloat16): a score or a
// probability rounded to bf16, kept as an f32, and a masked score,
// bf16(-1e30) = -1.578125 * 2^99 (below -1e30, so a row's running max
// starts at -1e30 and stays there while every key is masked).
__device__ __forceinline__ float bf16r(float x) {
  return round_to<__nv_bfloat16>(x);
}
constexpr float NEG_BF16 = -0x1.94p+99f;

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

// core/sampling.counter_gumbel, element by element.  row and col are the
// global (flattened B * L row, vocab column) of the logit: a kernel adds
// its row offset (the rank's first row under a data mesh) and its column
// offset (the shard's first column under a vocab-sharded head).
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

// Format codes (core/mx.FMT_CODES): every format of core/mx, for the
// sampling logits and for the BAOS KV cache alike.
enum Fmt {
  FMT_NONE = 0,
  FMT_BF16 = 1,
  FMT_MXFP8 = 2,
  FMT_MXINT8 = 3,
  FMT_MXINT4 = 4,
  FMT_MXFP6 = 5,
  FMT_MXFP4 = 6
};

// OCP MX element grids: the largest magnitude and, for the INT formats,
// the fraction bits and the integer clip range.
__device__ __forceinline__ float grid_max(int fmt) {
  switch (fmt) {
    case FMT_MXFP8: return 448.f;
    case FMT_MXINT8: return 127.f / 64.f;
    case FMT_MXFP6: return 28.f;
    case FMT_MXFP4: return 6.f;
    default: return 1.75f;
  }
}

// 2^e exactly, for an integer e in [-149, 127] (below -126 a subnormal).
__device__ __forceinline__ float pow2i(int e) {
  return e >= -126 ? __int_as_float((e + 127) << 23)
                   : __int_as_float(1 << (e + 149));
}

// core/mx._quant_grid on the e3m2 (mbits 2, emin -2, largest point 28) or
// e2m1 (1, 0, 6) grid: |y| to the nearest grid point, a midpoint up, then
// the sign.  In the binade [2^e, 2^(e+1)), and below 2^emin, the grid step
// is q = 2^(max(e, emin) - mbits) and the midpoints are (k + 0.5) q: with
// s = |y| / q (exact, a power of two) and t = floor(s), the nearest point
// is (t + 1) q where s - t >= 0.5 (exact: Sterbenz), else t q, capped at
// the largest point.  (floor(s + 0.5) would round s + 0.5 below 2^emin.)
__device__ __forceinline__ float quant_fp_grid(float y, int mbits, int emin,
                                               float top) {
  const float a = fabsf(y);
  if (a != a) return y;                        // NaN stays NaN
  const int e = max(((__float_as_int(a) >> 23) & 0xff) - 127, emin);
  const float s = __fmul_rn(a, pow2i(mbits - e));
  float t = floorf(s);
  if (__fsub_rn(s, t) >= 0.5f) t = __fadd_rn(t, 1.f);
  const float mag = fminf(__fmul_rn(t, pow2i(e - mbits)), top);
  return y > 0.f ? mag : (y < 0.f ? -mag : 0.f);
}

// Quantize one element already divided by its block's shared scale.
__device__ __forceinline__ float quant_element(float y, int fmt) {
  if (fmt == FMT_MXFP6) return quant_fp_grid(y, 2, -2, 28.f);
  if (fmt == FMT_MXFP4) return quant_fp_grid(y, 1, 0, 6.f);
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

// The exponent of the shared scale of an MX block whose largest magnitude
// is amax: clip(ceil(log2(amax / grid_max)), -127, 127), or 0 for amax 0.
__device__ __forceinline__ int mx_block_exp(float amax, int fmt) {
  if (!(amax > 0.f)) return 0;
  const float e = ceilf(log2f(amax / grid_max(fmt)));
  return static_cast<int>(fminf(fmaxf(e, -127.f), 127.f));
}

// The shared power-of-two scale of that block, 2^e (1 for amax 0).
__device__ __forceinline__ float mx_block_scale(float amax, int fmt) {
  return exp2f(static_cast<float>(mx_block_exp(amax, fmt)));
}

// Fake-quant of one value per lane; the warp's 32 lanes are one MX block
// (pad lanes hold 0).  Must be called by all 32 lanes together.  The result
// is rounded to T, as core/mx.mx_fake_quant returns its input's dtype.
template <typename T>
__device__ __forceinline__ float fake_quant(float v, int fmt) {
  if (fmt == FMT_NONE) return v;
  if (fmt == FMT_BF16) return round_to<T>(round_to<__nv_bfloat16>(v));
  const float scale = mx_block_scale(warp_max(fabsf(v)), fmt);
  return round_to<T>(__fmul_rn(quant_element(v / scale, fmt), scale));
}

// ---------------------------------------------------------------------------
// 8-wide lanes, one MX block per quad (baos_mx_quant, stablemax_sampling)
// ---------------------------------------------------------------------------
// A lane owns 8 consecutive elements: one 16-byte load of bf16, two of f32.
// The four lanes of a quad (lanes 4k..4k+3) then hold one 32-wide MX block,
// so a block's amax is a reduction over the quad alone.

__device__ __forceinline__ void unpack_bf16x2(uint32_t w, float& lo,
                                              float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The 8 values at p as f32: 16-byte loads when vec (p 16-byte aligned) and
// n == 8, else scalar loads of the first n (0 <= n <= 8) and 0 for the rest.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, int n,
                                      bool vec, float (&v)[8]) {
  if (vec && n == 8) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
    unpack_bf16x2(w.x, v[0], v[1]);
    unpack_bf16x2(w.y, v[2], v[3]);
    unpack_bf16x2(w.z, v[4], v[5]);
    unpack_bf16x2(w.w, v[6], v[7]);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = j < n ? __bfloat162float(p[j]) : 0.f;
  }
}

__device__ __forceinline__ void load8(const float* p, int n, bool vec,
                                      float (&v)[8]) {
  if (vec && n == 8) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = j < n ? p[j] : 0.f;
  }
}

// v rounded to T, 8 values at p: 16-byte stores when vec, else scalar.
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8],
                                       bool vec) {
  if (vec) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                   pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) p[j] = __float2bfloat16_rn(v[j]);
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8],
                                       bool vec) {
  if (vec) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) p[j] = v[j];
  }
}

// round_to<T> of 8 values; bf16 rounds in pairs (cvt.rn.bf16x2.f32).
template <typename T>
__device__ __forceinline__ void round8(float (&v)[8]) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int j = 0; j < 8; j += 2) unpack_bf16x2(pack_bf16x2(v[j], v[j + 1]),
                                                 v[j], v[j + 1]);
  }
}

// quant_element of 8 values already multiplied by their block's inverse
// scale.  mxfp8 converts in pairs (cvt.rn.satfinite.e4m3x2.f32): for finite
// y the same value as quant_element's clip to +-448 and SATFINITE cast,
// since |y| <= 448 rounds alike either way and larger |y| saturates to 448
// either way.  The e4m3 bytes come back to f32 by bit moves, not through
// the conversion unit: sign to bit 31, exponent and mantissa to bits
// 26..20, which reads as the value times 2^-120 (subnormal codes
// included), then an exact multiply by 2^120.
__device__ __forceinline__ float e4m3_to_f32(uint32_t q) {
  const float v = __uint_as_float((q & 0x80u) << 24 | (q & 0x7fu) << 20);
  return __fmul_rn(v, 1.329227995784916e36f);     // 2^120
}

__device__ __forceinline__ void quant8(float (&y)[8], int fmt) {
  if (fmt == FMT_MXFP8) {
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint16_t q;
      asm("cvt.rn.satfinite.e4m3x2.f32 %0, %1, %2;"
          : "=h"(q)
          : "f"(y[j + 1]), "f"(y[j]));
      y[j] = e4m3_to_f32(q);
      y[j + 1] = e4m3_to_f32(q >> 8);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) y[j] = quant_element(y[j], fmt);
  }
}

// The scales of two MX blocks per quad, one per row or step u of the
// caller: a[u] is this lane's amax over its 8 values of block u.  A
// reduce-scatter over the quad (2 shuffles) leaves block 0's amax in lanes
// 0-1 and block 1's in lanes 2-3, which apply mx_block_scale's rule to it,
// so each block's exponent is computed by two lanes, not once per value;
// 4 shuffles then give every lane of the quad each block's scale and its
// exact inverse 2^-e, built from the exponent bits, never as 1 / scale.
// v * inv equals the IEEE quotient v / scale bit for bit, subnormal results
// included (both round the same real number), wherever exp2f gives exactly
// 2^e.  On the H100 it does for every e but -127, whose 2^e is subnormal
// (chip_smoke.py checks torch.exp2, which calls it); where it does not, inv
// is 0 and scale_down8 divides, as the plain version does.  Must be called
// by all 32 lanes together.
__device__ __forceinline__ void quad_block_scales(const float (&a)[2],
                                                  int fmt, float (&scale)[2],
                                                  float (&inv)[2]) {
  const bool hi = threadIdx.x & 2;
  float amax = fmaxf(hi ? a[1] : a[0],
                     __shfl_xor_sync(FULL_MASK, hi ? a[0] : a[1], 2));
  amax = fmaxf(amax, __shfl_xor_sync(FULL_MASK, amax, 1));
  const int e = mx_block_exp(amax, fmt);
  const float sc = exp2f(static_cast<float>(e));
  const int quad = threadIdx.x & 28;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    scale[u] = __shfl_sync(FULL_MASK, sc, quad + 2 * u);
    const int eu = __shfl_sync(FULL_MASK, e, quad + 2 * u);
    inv[u] = scale[u] == pow2i(eu) ? pow2i(-eu) : 0.f;
  }
}

// v / scale for the 8 values of one block: the multiply by the exact
// inverse, or the IEEE division where there is none (inv 0).
__device__ __forceinline__ void scale_down8(float (&v)[8], float scale,
                                            float inv) {
  if (inv != 0.f) {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __fmul_rn(v[j], inv);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = v[j] / scale;
  }
}

// ---------------------------------------------------------------------------
// Asynchronous copies and tensor-core tiles (cp.async, ldmatrix, mma.sync)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1.  With ok false nothing is read
// and the 16 bytes are zero-filled (src must still be a valid address).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8, and register i receives matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same, each matrix transposed on the way into the registers.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col) in bf16 with f32 accumulation.
// Fragments (g = lane / 4, c = lane % 4): a = {A[g][2c..], A[g+8][2c..],
// A[g][2c+8..], A[g+8][2c+8..]}, b = {B[2c..][g], B[2c+8..][g]},
// d = {C[g][2c], C[g][2c+1], C[g+8][2c], C[g+8][2c+1]}.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// Merge of per-tile Stable-Max partials (core/sampling.combine_partials)
// ---------------------------------------------------------------------------

// One warp merges one row's n_vt partials into the row's partial of a
// vocab shard, (m, global idx, s), written in place of (conf, token) for a
// merge across ranks (core/sampling.combine_partials): m = max m_t,
// s = sum s_t e^(m_t - m), the lowest column among the tiles holding m,
// plus col_offset.  With Gumbel the index is the lowest column among the
// tiles holding the best score, and the shard's best score and the logit
// at its index go to b_out and z_out.  A row with no valid column (n_vt =
// 0: a shard of pad only) gets m = NEG, s = 0, idx = BIG (and best -inf),
// which no combine picks.
__device__ __forceinline__ void shard_merge_row(
    const float* __restrict__ part_m, const int* __restrict__ part_i,
    const float* __restrict__ part_s, const float* __restrict__ part_b,
    const float* __restrict__ part_z, int r, int n_vt, int col_offset,
    bool gumbel, float* __restrict__ m_out, int* __restrict__ idx_out,
    float* __restrict__ s_out, float* __restrict__ b_out,
    float* __restrict__ z_out) {
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
  float best = -INFINITY, zat = NEG;
  if (!gumbel) {
    for (int t = lane; t < n_vt; t += 32)
      if (part_m[base + t] >= m) idx = min(idx, part_i[base + t]);
    idx = warp_min(idx);
  } else {
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
    const bool empty = !(m > NEG);
    m_out[r] = m;
    s_out[r] = empty ? 0.f : s;
    idx_out[r] = empty ? BIG : idx + col_offset;
    if (gumbel) {
      b_out[r] = empty ? -INFINITY : best;
      z_out[r] = empty ? NEG : zat;
    }
  }
}

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

// ---------------------------------------------------------------------------
// Kernel attributes (the static-analysis gate's shared-memory check)
// ---------------------------------------------------------------------------

// One kernel instantiation a library launches: its name, its address and
// the dynamic shared memory its largest launch requests, in bytes.
struct KernelAttr {
  const char* name;
  const void* fn;
  int dyn_smem;
};

// cudaFuncGetAttributes of table[i]: its static shared memory and
// registers per thread, beside the dynamic shared memory its launch
// requests (analysis/smem_budget.py states the same figures).
inline int kernel_attrs(const KernelAttr* table, int n, int i,
                        const char** name, int* static_smem, int* regs,
                        int* dyn_smem) {
  if (i < 0 || i >= n) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, table[i].fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *name = table[i].name;
  *static_smem = static_cast<int>(a.sharedSizeBytes);
  *regs = a.numRegs;
  *dyn_smem = table[i].dyn_smem;
  return 0;
}

#define KERNEL_ATTR(NAME, DYN) \
  KernelAttr { #NAME, reinterpret_cast<const void*>(&NAME), (DYN) }

// The two C entry points of a library's table ATTRS: <lib>_kernel_count and
// <lib>_kernel_attrs (name, static smem, registers, dynamic smem of entry i).
#define KERNEL_ATTR_ENTRIES(LIB, ATTRS)                                     \
  extern "C" int LIB##_kernel_count() {                                    \
    return static_cast<int>(sizeof(ATTRS) / sizeof(ATTRS[0]));             \
  }                                                                        \
  extern "C" int LIB##_kernel_attrs(int i, const char** name, int* smem,   \
                                    int* regs, int* dyn) {                 \
    return kernel_attrs(ATTRS, LIB##_kernel_count(), i, name, smem, regs,  \
                        dyn);                                              \
  }

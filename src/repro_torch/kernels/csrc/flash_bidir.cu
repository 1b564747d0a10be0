// Bidirectional GQA flash attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel `flash_bidir` in src/repro/kernels/flash_bidir.py,
// the twin of the model's layers.attention.  Non-causal attention with an
// online softmax over KV tiles in f32, GQA by index (KV head = q_head // G,
// nothing repeated in memory), the BAOS fusion of the Pallas kernel
// (q * f_k * D^-1/2 on the way in, out * f_v + c_v at the end), the optional
// |q_pos - k_pos| < window mask with query row r at position q_offset + r
// (a segment of a longer cache) and key j at j, and a per-row kv_valid
// (B, Skv) mask that the Pallas kernel lacks.  Masked scores are -1e30
// (not -inf), so a row with no valid key averages every key, as the
// reference does; keys past Skv (the ragged last tile) get probability 0,
// so no divisibility is required.  The output divides by max(l, 1e-30).
//
// What bounds it: at the main-path shape (B 4, S 96, H 32, D 128, bf16) one
// layer moves 12.6 MB (q, k, v, out) and does 0.6 GFLOP, so the card could
// finish it in about 4 us (bytes).  This first version runs the two products with
// f32 FMAs from shared memory on the CUDA cores and is bound by those
// operations; mma/wgmma tiles are the next step.
//
// Design: one CTA per (q tile of 16 rows, q head, batch row), 4 warps, each
// warp owning 4 query rows.  Per 32-key tile the K and V tiles are staged
// in shared memory as f32 (K padded against bank conflicts); lane j scores
// key j, the row max and sum are warp shuffles, and each lane accumulates
// D/32 output dimensions, broadcasting p_j by shuffle.
#include "common.cuh"

namespace {

constexpr int BQ = 16;      // query rows per CTA
constexpr int BK = 32;      // keys per tile: one per lane
constexpr int WARPS = 4;
constexpr int RPW = BQ / WARPS;

template <typename T, int DPL>
__global__ void __launch_bounds__(32 * WARPS)
flash_bidir_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v,
                   const unsigned char* __restrict__ kv_valid,
                   const float* __restrict__ fk, const float* __restrict__ fv,
                   const float* __restrict__ cv, T* __restrict__ out, int Sq,
                   int Skv, int Hq, int Hkv, float scale, int window,
                   int q_offset) {
  constexpr int D = 32 * DPL;
  __shared__ float qs[BQ][D];
  __shared__ float ks[BK][D + 1];
  __shared__ float vs[BK][D];

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t cal = (static_cast<size_t>(b) * Hkv + hk) * D;

  for (int e = tid; e < BQ * D; e += 32 * WARPS) {
    const int r = e / D, dd = e % D, gq = q0 + r;
    float x = 0.f;
    if (gq < Sq) {
      x = to_f32(q[((static_cast<size_t>(b) * Sq + gq) * Hq + h) * D + dd]);
      if (fk != nullptr) x *= fk[cal + dd];
    }
    qs[r][dd] = x * scale;
  }

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < Skv; k0 += BK) {
    __syncthreads();  // previous tile fully read (and the q tile written)
    for (int e = tid; e < BK * D; e += 32 * WARPS) {
      const int j = e / D, dd = e % D, gk = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (gk < Skv) {
        const size_t o = ((static_cast<size_t>(b) * Skv + gk) * Hkv + hk) * D + dd;
        kx = to_f32(k[o]);
        vx = to_f32(v[o]);
      }
      ks[j][dd] = kx;
      vs[j][dd] = vx;
    }
    __syncthreads();

    const int gk = k0 + lane;
    const bool in_range = gk < Skv;
    const bool valid = in_range &&
        (kv_valid == nullptr || kv_valid[static_cast<size_t>(b) * Skv + gk]);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int row = warp * RPW + i, gq = q0 + row;
      float s = 0.f;
#pragma unroll 8
      for (int dd = 0; dd < D; ++dd) s = fmaf(qs[row][dd], ks[lane][dd], s);
      const bool ok =
          valid && (window <= 0 || abs(q_offset + gq - gk) < window);
      s = in_range ? (ok ? s : NEG) : -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(s));
      const float p = expf(s - m_new);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(p);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[i][j] *= corr;
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        const float pk = __shfl_sync(FULL_MASK, p, kk);
#pragma unroll
        for (int j = 0; j < DPL; ++j)
          acc[i][j] = fmaf(pk, vs[kk][lane + 32 * j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int gq = q0 + warp * RPW + i;
    if (gq >= Sq) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int dd = lane + 32 * j;
      float o = acc[i][j] * inv_l;
      if (fv != nullptr) o *= fv[cal + dd];
      if (cv != nullptr) o += cv[cal + dd];
      out[((static_cast<size_t>(b) * Sq + gq) * Hq + h) * D + dd] = from_f32<T>(o);
    }
  }
}

template <typename T, int DPL>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_valid, const void* fk, const void* fv,
                   const void* cv, void* out, int B, int Sq, int Skv, int Hq,
                   int Hkv, float scale, int window, int q_offset,
                   cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_bidir_kernel<T, DPL><<<grid, 32 * WARPS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const unsigned char*>(kv_valid),
      static_cast<const float*>(fk), static_cast<const float*>(fv),
      static_cast<const float*>(cv), static_cast<T*>(out), Sq, Skv, Hq, Hkv,
      scale, window, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const void* kv_valid, const void* fk, const void* fv,
                       const void* cv, void* out, int B, int Sq, int Skv,
                       int Hq, int Hkv, float scale, int window,
                       int q_offset, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 1>(q, k, v, kv_valid, fk, fv, cv, out, B, Sq, Skv, Hq,
                          Hkv, scale, window, q_offset, stream);
    case 64:
      return launch<T, 2>(q, k, v, kv_valid, fk, fv, cv, out, B, Sq, Skv, Hq,
                          Hkv, scale, window, q_offset, stream);
    case 128:
      return launch<T, 4>(q, k, v, kv_valid, fk, fv, cv, out, B, Sq, Skv, Hq,
                          Hkv, scale, window, q_offset, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D) and out (B, Sq, Hq, D), all f32
// (is_bf16 = 0) or all bf16, contiguous; D in {32, 64, 128}.  kv_valid
// (B, Skv) bool and fk/fv/cv (B, Hkv, D) f32 may each be null.  scale is
// the softmax scale (D^-1/2, rounded to f32 by the caller); window <= 0
// means no window; query row r sits at position q_offset + r.
extern "C" int flash_bidir_launch(const void* q, const void* k, const void* v,
                                  const void* kv_valid, const void* fk,
                                  const void* fv, const void* cv, void* out,
                                  int B, int Sq, int Skv, int Hq, int Hkv,
                                  int D, float scale, int window, int q_offset,
                                  int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? dispatch_d<__nv_bfloat16>(D, q, k, v, kv_valid, fk, fv, cv,
                                          out, B, Sq, Skv, Hq, Hkv, scale,
                                          window, q_offset, st)
              : dispatch_d<float>(D, q, k, v, kv_valid, fk, fv, cv, out, B, Sq,
                                  Skv, Hq, Hkv, scale, window, q_offset, st));
}

extern "C" const char* flash_bidir_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

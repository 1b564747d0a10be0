// Backward of bidirectional GQA attention for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package trains through jax.grad of the
// jnp attention in src/repro/models/layers.py (XLA differentiates it; there
// is no Pallas backward and no custom_vjp).  The port's forward runs the
// hand-written csrc/flash_bidir.cu, so its gradient is a kernel too:
// kernels/flash_bidir.py wraps both in a torch.autograd.Function.
//
// What it computes, for q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D) and the
// output gradient dO (B, Sq, Hq, D), KV head = q head // G, G = Hq / Hkv,
// and the forward's masks (kv_valid (B, Skv), |q_offset + r - j| <
// window, and with causal != 0 j <= q_offset + r, the JAX model's causal
// mode):
//   s_ij  = D^-1/2 q_i . k_j, -1e30 where masked (a constant: no gradient)
//   p_ij  = exp(s_ij - m_i) / max(l_i, 1e-30)   (m_i, l_i recomputed)
//   dp_ij = dO_i . v_j
//   delta_i = sum_j p_ij dp_ij   (= dO_i . o_i, with o_i in f32)
//   ds_ij = p_ij (dp_ij - delta_i), 0 where masked
//   dq_i = D^-1/2 sum_j ds_ij k_j
//   dk_j = D^-1/2 sum_(i, heads of the group) ds_ij q_i
//   dv_j = sum_(i, heads of the group) p_ij dO_i
// A row with no valid key has p = 1 / Skv on every key (the forward
// averages V there): it adds to dv, and its dq and its share of dk are 0.
// Keys past Skv (the ragged last tile) have p = 0.
//
// Design (simple first; the tensor cores wait for a later redesign): f32
// on the CUDA cores for bf16 and f32 inputs alike, each value converted
// once on its way into shared memory, every sum in f32, each output
// rounded once to the input dtype.  Two kernels, one after the other on
// the caller's stream:
//   1. dq: one CTA per (16-row q tile, q head, batch row), 4 warps of 4
//      rows, lane j scoring key j of a 32-key tile staged in shared memory
//      ([32][DT + 1] floats: lane-strided reads hit 32 banks).  A first
//      pass over the key tiles recomputes each row's max and sum (the
//      forward's online softmax) and delta_i, the sum of p_ij dp_ij under
//      the same online rescaling; a second pass forms ds and sums
//      ds_ij k_j into the row's dq, lane c holding columns c + 32 t.
//      delta is not taken as dO . o from the forward's output: o is
//      rounded to the activation dtype, and in bf16 that rounding, against
//      dp_ij - delta_i (a small difference where attention is near
//      uniform), cost qwen2-0.5b's query and key projections a gradient
//      cosine of 0.93-0.98 to an f32 reference where plain attention
//      under autograd kept 0.99-0.997 (24 layers, random weights, B 8 x S
//      128).  It writes (m, l, delta) of every row to a scratch buffer for
//      kernel 2.
//   2. dk, dv: one CTA per (32-key tile, KV head, batch row), 8 warps.
//      It walks every query row of every q head of the group in chunks of
//      16 rows: the warps score the chunk (row r on warp r % 8, lane j on
//      key j) into shared p and ds tiles, then every thread adds the
//      chunk to the columns it owns (key = lane, DT / 8 contiguous
//      columns = warp's share, read as 16-byte broadcasts).  The sum over
//      the group's heads stays inside the CTA.
// No atomics: every output element is summed by one thread in a fixed
// order, so two launches give the same bits.
//
// Head dims: tiles DT = 32, 64, 128 and 256 columns (a multiple of 8 up to
// 256 runs in the smallest that holds it, columns past D loaded as zeros
// and not stored).  Shared memory at DT 256: 98.6 KB (dq), 102.8 KB (dk,
// dv), under the 227 KB a block may take.
//
// What bounds it: the card could finish the function on its bytes (llada-8b's
// training shape, B 8, S 128, 32 heads, D 128: 67 MB read and written,
// 0.020 ms; its 4 products, 4.3 GFLOP, take 0.004 ms on the tensor cores).
// This kernel instead does 9 D scalar f32 multiply-adds per (row, key,
// head) with the recomputed scores, each reading shared memory: it is
// bound by that issue rate, far above either bound (PERF.md).
#include "common.cuh"

namespace {

constexpr int BQ = 16;       // query rows per dq CTA
constexpr int BK = 32;       // keys per tile: one per lane
constexpr int QWARPS = 4;
constexpr int RPW = BQ / QWARPS;
constexpr int KWARPS = 8;    // warps of a dk/dv CTA
constexpr int RC = 16;       // query rows per chunk of the dk/dv CTA

constexpr int dq_smem_bytes(int DT) {
  return (2 * BQ * DT + 2 * BK * (DT + 1)) * 4;
}
constexpr int dkv_smem_bytes(int DT) {
  return (2 * BK * (DT + 1) + 2 * RC * DT + 2 * RC * BK + 4 * RC) * 4;
}

__device__ __forceinline__ bool key_ok(const unsigned char* kv_valid, int b,
                                       int Skv, int gk) {
  return gk < Skv &&
         (kv_valid == nullptr || kv_valid[static_cast<size_t>(b) * Skv + gk]);
}

// Whether key position kp is in reach of query position qp (the forward's
// in_reach).
__device__ __forceinline__ bool in_reach(int qp, int kp, int window,
                                         int causal) {
  return (!causal || kp <= qp) && (window <= 0 || abs(qp - kp) < window);
}

// Stage keys [k0, k0 + BK) of KV head hk of `src` as f32 rows of dst
// ([BK][DT + 1]); keys past Skv and columns past D are zeros.
template <typename T, int DT>
__device__ __forceinline__ void stage_keys(float (*dst)[DT + 1],
                                           const T* __restrict__ src, int b,
                                           int k0, int hk, int Skv, int Hkv,
                                           int D, int tid, int nthreads) {
  for (int e = tid; e < BK * DT; e += nthreads) {
    const int j = e / DT, dd = e % DT, gk = k0 + j;
    float x = 0.f;
    if (gk < Skv && dd < D)
      x = to_f32(src[((static_cast<size_t>(b) * Skv + gk) * Hkv + hk) * D + dd]);
    dst[j][dd] = x;
  }
}

template <typename T, int DPL>
__global__ void __launch_bounds__(32 * QWARPS)
flash_bidir_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const unsigned char* __restrict__ kv_valid,
                   T* __restrict__ dq, float* __restrict__ stats, int B,
                   int Sq, int Skv, int Hq, int Hkv, int D, float scale,
                   int window, int q_offset, int causal) {
  constexpr int DT = 32 * DPL;
  extern __shared__ __align__(16) float smem_dq[];
  float(*qs)[DT] = reinterpret_cast<float(*)[DT]>(smem_dq);
  float(*dos)[DT] = reinterpret_cast<float(*)[DT]>(smem_dq + BQ * DT);
  float(*ks)[DT + 1] = reinterpret_cast<float(*)[DT + 1]>(smem_dq + 2 * BQ * DT);
  float(*vs)[DT + 1] =
      reinterpret_cast<float(*)[DT + 1]>(smem_dq + 2 * BQ * DT + BK * (DT + 1));

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nthreads = 32 * QWARPS;

  for (int e = tid; e < BQ * DT; e += nthreads) {
    const int r = e / DT, dd = e % DT, gq = q0 + r;
    float x = 0.f, g = 0.f;
    if (gq < Sq && dd < D) {
      const size_t idx = ((static_cast<size_t>(b) * Sq + gq) * Hq + h) * D + dd;
      x = to_f32(q[idx]);
      g = to_f32(dout[idx]);
    }
    qs[r][dd] = x;
    dos[r][dd] = g;
  }

  // pass 1: each row's max, sum and sum of e_ij dp_ij over every key tile
  // (online, as the forward's softmax)
  float m[RPW], l[RPW], pdp[RPW];
  int qpos[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = NEG;
    l[i] = pdp[i] = 0.f;
    qpos[i] = q_offset + q0 + warp * RPW + i;
  }
  for (int k0 = 0; k0 < Skv; k0 += BK) {
    __syncthreads();   // previous tile read (and the q rows written)
    stage_keys<T, DT>(ks, k, b, k0, hk, Skv, Hkv, D, tid, nthreads);
    stage_keys<T, DT>(vs, v, b, k0, hk, Skv, Hkv, D, tid, nthreads);
    __syncthreads();
    const int gk = k0 + lane;
    const bool in_range = gk < Skv;
    const bool valid = key_ok(kv_valid, b, Skv, gk);
    float s[RPW], dp[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < DT; ++dd) {
      const float kx = ks[lane][dd], vx = vs[lane][dd];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        s[i] = fmaf(qs[warp * RPW + i][dd], kx, s[i]);
        dp[i] = fmaf(dos[warp * RPW + i][dd], vx, dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const bool ok = valid && in_reach(qpos[i], gk, window, causal);
      const float x = in_range ? (ok ? s[i] * scale : NEG) : -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(x));
      const float corr = expf(m[i] - m_new), e = expf(x - m_new);
      l[i] = l[i] * corr + warp_sum(e);
      pdp[i] = pdp[i] * corr + warp_sum(in_range ? e * dp[i] : 0.f);
      m[i] = m_new;
    }
  }

  float inv_l[RPW], delta[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    inv_l[i] = 1.f / fmaxf(l[i], 1e-30f);
    delta[i] = pdp[i] * inv_l[i];
    const int gq = q0 + warp * RPW + i;
    if (lane == 0 && gq < Sq) {
      const size_t si = (static_cast<size_t>(b) * Hq + h) * Sq + gq;
      const size_t n = static_cast<size_t>(B) * Hq * Sq;
      stats[si] = m[i];
      stats[n + si] = l[i];
      stats[2 * n + si] = delta[i];
    }
  }

  // pass 2: ds and dq
  float acc[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[i][t] = 0.f;

  for (int k0 = 0; k0 < Skv; k0 += BK) {
    __syncthreads();
    stage_keys<T, DT>(ks, k, b, k0, hk, Skv, Hkv, D, tid, nthreads);
    stage_keys<T, DT>(vs, v, b, k0, hk, Skv, Hkv, D, tid, nthreads);
    __syncthreads();
    const int gk = k0 + lane;
    const bool in_range = gk < Skv;
    const bool valid = key_ok(kv_valid, b, Skv, gk);
    float s[RPW], dp[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < DT; ++dd) {
      const float kx = ks[lane][dd], vx = vs[lane][dd];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        s[i] = fmaf(qs[warp * RPW + i][dd], kx, s[i]);
        dp[i] = fmaf(dos[warp * RPW + i][dd], vx, dp[i]);
      }
    }
    float ds[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const bool ok =
          in_range && valid && in_reach(qpos[i], gk, window, causal);
      ds[i] = ok ? expf(s[i] * scale - m[i]) * inv_l[i] * (dp[i] - delta[i])
                 : 0.f;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsk[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) dsk[i] = __shfl_sync(FULL_MASK, ds[i], kk);
#pragma unroll
      for (int t = 0; t < DPL; ++t) {
        const float kx = ks[kk][lane + 32 * t];
#pragma unroll
        for (int i = 0; i < RPW; ++i) acc[i][t] = fmaf(dsk[i], kx, acc[i][t]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int gq = q0 + warp * RPW + i;
    if (gq >= Sq) continue;
    const size_t row = ((static_cast<size_t>(b) * Sq + gq) * Hq + h) * D;
#pragma unroll
    for (int t = 0; t < DPL; ++t) {
      const int dd = lane + 32 * t;
      if (dd < D) dq[row + dd] = from_f32<T>(acc[i][t] * scale);
    }
  }
}

template <typename T, int DPL>
__global__ void __launch_bounds__(32 * KWARPS)
flash_bidir_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const unsigned char* __restrict__ kv_valid,
                    const float* __restrict__ stats, T* __restrict__ dk,
                    T* __restrict__ dv, int B, int Sq, int Skv, int Hq,
                    int Hkv, int D, float scale, int window, int q_offset,
                    int causal) {
  constexpr int DT = 32 * DPL;
  constexpr int NC = DT / KWARPS;    // contiguous columns a thread owns
  extern __shared__ __align__(16) float smem_dkv[];
  float(*ks)[DT + 1] = reinterpret_cast<float(*)[DT + 1]>(smem_dkv);
  float(*vs)[DT + 1] = reinterpret_cast<float(*)[DT + 1]>(smem_dkv + BK * (DT + 1));
  float* rest = smem_dkv + 2 * BK * (DT + 1);
  float(*qs)[DT] = reinterpret_cast<float(*)[DT]>(rest);
  float(*dos)[DT] = reinterpret_cast<float(*)[DT]>(rest + RC * DT);
  float(*ps)[BK] = reinterpret_cast<float(*)[BK]>(rest + 2 * RC * DT);
  float(*dss)[BK] = reinterpret_cast<float(*)[BK]>(rest + 2 * RC * DT + RC * BK);
  float* row_m = rest + 2 * RC * DT + 2 * RC * BK;
  float* row_il = row_m + RC;
  float* row_delta = row_il + RC;
  int* row_pos = reinterpret_cast<int*>(row_delta + RC);

  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv, n_rows = G * Sq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nthreads = 32 * KWARPS;
  const size_t n_stats = static_cast<size_t>(B) * Hq * Sq;

  stage_keys<T, DT>(ks, k, b, k0, hk, Skv, Hkv, D, tid, nthreads);
  stage_keys<T, DT>(vs, v, b, k0, hk, Skv, Hkv, D, tid, nthreads);
  const int gk = k0 + lane;
  const bool in_range = gk < Skv;
  const bool valid = key_ok(kv_valid, b, Skv, gk);

  float adk[NC], adv[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) adk[c] = adv[c] = 0.f;

  // rows t = g * Sq + pos of the group: q head hk * G + g at position pos
  for (int t0 = 0; t0 < n_rows; t0 += RC) {
    __syncthreads();   // the previous chunk read (and the K/V tile written)
    for (int e = tid; e < RC * DT; e += nthreads) {
      const int r = e / DT, dd = e % DT, t = t0 + r;
      float x = 0.f, g = 0.f;
      if (t < n_rows && dd < D) {
        const int hh = hk * G + t / Sq, pos = t % Sq;
        const size_t idx = ((static_cast<size_t>(b) * Sq + pos) * Hq + hh) * D + dd;
        x = to_f32(q[idx]);
        g = to_f32(dout[idx]);
      }
      qs[r][dd] = x;
      dos[r][dd] = g;
    }
    if (tid < RC) {
      const int t = t0 + tid;
      if (t < n_rows) {
        const int hh = hk * G + t / Sq, pos = t % Sq;
        const size_t si = (static_cast<size_t>(b) * Hq + hh) * Sq + pos;
        row_m[tid] = stats[si];
        row_il[tid] = 1.f / fmaxf(stats[n_stats + si], 1e-30f);
        row_delta[tid] = stats[2 * n_stats + si];
        row_pos[tid] = q_offset + pos;
      } else {               // a row past the last: p = 0, ds = 0
        row_m[tid] = 0.f;
        row_il[tid] = 0.f;
        row_delta[tid] = 0.f;
        row_pos[tid] = 0;
      }
    }
    __syncthreads();

    // the chunk's p and ds: rows warp and warp + 8, lane j on key j
    constexpr int RW = RC / KWARPS;
    float s[RW], dp[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < DT; ++dd) {
      const float kx = ks[lane][dd], vx = vs[lane][dd];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        s[i] = fmaf(qs[warp + KWARPS * i][dd], kx, s[i]);
        dp[i] = fmaf(dos[warp + KWARPS * i][dd], vx, dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = warp + KWARPS * i;
      const bool ok = valid && in_reach(row_pos[r], gk, window, causal);
      const float p =
          in_range ? expf((ok ? s[i] * scale : NEG) - row_m[r]) * row_il[r]
                   : 0.f;
      ps[r][lane] = p;
      dss[r][lane] = ok && in_range ? p * (dp[i] - row_delta[r]) : 0.f;
    }
    __syncthreads();

    // every thread: key lane, columns warp * NC .. warp * NC + NC - 1
#pragma unroll 4
    for (int r = 0; r < RC; ++r) {
      const float pr = ps[r][lane], dsr = dss[r][lane];
#pragma unroll
      for (int c = 0; c < NC; c += 4) {
        const float4 g4 = *reinterpret_cast<const float4*>(&dos[r][warp * NC + c]);
        const float4 q4 = *reinterpret_cast<const float4*>(&qs[r][warp * NC + c]);
        adv[c] = fmaf(pr, g4.x, adv[c]);
        adv[c + 1] = fmaf(pr, g4.y, adv[c + 1]);
        adv[c + 2] = fmaf(pr, g4.z, adv[c + 2]);
        adv[c + 3] = fmaf(pr, g4.w, adv[c + 3]);
        adk[c] = fmaf(dsr, q4.x, adk[c]);
        adk[c + 1] = fmaf(dsr, q4.y, adk[c + 1]);
        adk[c + 2] = fmaf(dsr, q4.z, adk[c + 2]);
        adk[c + 3] = fmaf(dsr, q4.w, adk[c + 3]);
      }
    }
  }

  if (!in_range) return;
  const size_t row = ((static_cast<size_t>(b) * Skv + gk) * Hkv + hk) * D;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int dd = warp * NC + c;
    if (dd < D) {
      dk[row + dd] = from_f32<T>(adk[c] * scale);
      dv[row + dd] = from_f32<T>(adv[c]);
    }
  }
}

template <typename T, int DPL>
cudaError_t launch(const T* q, const T* k, const T* v, const T* dout, const unsigned char* kv_valid, T* dq, T* dk,
                   T* dv, float* stats, int B, int Sq, int Skv, int Hq,
                   int Hkv, int D, float scale, int window, int q_offset,
                   int causal, cudaStream_t stream) {
  constexpr int DT = 32 * DPL;
  static const cudaError_t attr_dq = cudaFuncSetAttribute(
      flash_bidir_bwd_dq<T, DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dq_smem_bytes(DT));
  if (attr_dq != cudaSuccess) return attr_dq;
  static const cudaError_t attr_dkv = cudaFuncSetAttribute(
      flash_bidir_bwd_dkv<T, DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dkv_smem_bytes(DT));
  if (attr_dkv != cudaSuccess) return attr_dkv;
  const dim3 grid_q((Sq + BQ - 1) / BQ, Hq, B);
  flash_bidir_bwd_dq<T, DPL><<<grid_q, 32 * QWARPS, dq_smem_bytes(DT), stream>>>(
      q, k, v, dout, kv_valid, dq, stats, B, Sq, Skv, Hq, Hkv, D, scale,
      window, q_offset, causal);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_k((Skv + BK - 1) / BK, Hkv, B);
  flash_bidir_bwd_dkv<T, DPL><<<grid_k, 32 * KWARPS, dkv_smem_bytes(DT), stream>>>(
      q, k, v, dout, kv_valid, stats, dk, dv, B, Sq, Skv, Hq, Hkv, D, scale,
      window, q_offset, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* dout,
                     const unsigned char* kv_valid, void* dq, void* dk,
                     void* dv, float* stats, int B, int Sq, int Skv, int Hq,
                     int Hkv, int D, float scale, int window, int q_offset,
                     int causal, cudaStream_t stream) {
#define FBB_LAUNCH(DPL)                                                     \
  return launch<T, DPL>(                                                    \
      static_cast<const T*>(q), static_cast<const T*>(k),                   \
      static_cast<const T*>(v), static_cast<const T*>(dout), kv_valid,      \
      static_cast<T*>(dq),                                                  \
      static_cast<T*>(dk), static_cast<T*>(dv), stats, B, Sq, Skv, Hq, Hkv, \
      D, scale, window, q_offset, causal, stream)
  if (D < 8 || D > 256 || D % 8) return cudaErrorInvalidValue;
  if (D <= 32) FBB_LAUNCH(1);
  if (D <= 64) FBB_LAUNCH(2);
  if (D <= 128) FBB_LAUNCH(4);
  FBB_LAUNCH(8);
#undef FBB_LAUNCH
}

}  // namespace

// q, dout, dq (B, Sq, Hq, D) and k, v, dk, dv (B, Skv, Hkv, D), all f32
// (is_bf16 = 0) or all bf16, contiguous; D a multiple of 8 in [8, 256];
// kv_valid (B, Skv) bool or null; stats an f32 scratch of 3 * B * Hq * Sq
// (each row's max, sum and delta, written by the first kernel, read by the
// second).  scale is D^-1/2 as the forward took it; window <= 0 means no
// window; query row r sits at position q_offset + r; causal != 0 masks
// keys past each row's position.
extern "C" int flash_bidir_bwd_launch(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* kv_valid,
                                      void* dq, void* dk, void* dv,
                                      void* stats, int B, int Sq, int Skv,
                                      int Hq, int Hkv, int D, float scale,
                                      int window, int q_offset, int causal,
                                      int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* valid = static_cast<const unsigned char*>(kv_valid);
  auto* sc = static_cast<float*>(stats);
  if (is_bf16)
    return static_cast<int>(dispatch<__nv_bfloat16>(
        q, k, v, dout, valid, dq, dk, dv, sc, B, Sq, Skv, Hq, Hkv, D,
        scale, window, q_offset, causal, st));
  return static_cast<int>(dispatch<float>(q, k, v, dout, valid, dq, dk, dv,
                                          sc, B, Sq, Skv, Hq, Hkv, D, scale,
                                          window, q_offset, causal, st));
}

namespace {
// every instantiation the entry point above launches
const KernelAttr ATTRS[] = {
    KERNEL_ATTR((flash_bidir_bwd_dq<float, 1>), dq_smem_bytes(32)),
    KERNEL_ATTR((flash_bidir_bwd_dkv<float, 1>), dkv_smem_bytes(32)),
    KERNEL_ATTR((flash_bidir_bwd_dq<float, 2>), dq_smem_bytes(64)),
    KERNEL_ATTR((flash_bidir_bwd_dkv<float, 2>), dkv_smem_bytes(64)),
    KERNEL_ATTR((flash_bidir_bwd_dq<float, 4>), dq_smem_bytes(128)),
    KERNEL_ATTR((flash_bidir_bwd_dkv<float, 4>), dkv_smem_bytes(128)),
    KERNEL_ATTR((flash_bidir_bwd_dq<float, 8>), dq_smem_bytes(256)),
    KERNEL_ATTR((flash_bidir_bwd_dkv<float, 8>), dkv_smem_bytes(256)),
    KERNEL_ATTR((flash_bidir_bwd_dq<__nv_bfloat16, 1>), dq_smem_bytes(32)),
    KERNEL_ATTR((flash_bidir_bwd_dkv<__nv_bfloat16, 1>), dkv_smem_bytes(32)),
    KERNEL_ATTR((flash_bidir_bwd_dq<__nv_bfloat16, 2>), dq_smem_bytes(64)),
    KERNEL_ATTR((flash_bidir_bwd_dkv<__nv_bfloat16, 2>), dkv_smem_bytes(64)),
    KERNEL_ATTR((flash_bidir_bwd_dq<__nv_bfloat16, 4>), dq_smem_bytes(128)),
    KERNEL_ATTR((flash_bidir_bwd_dkv<__nv_bfloat16, 4>), dkv_smem_bytes(128)),
    KERNEL_ATTR((flash_bidir_bwd_dq<__nv_bfloat16, 8>), dq_smem_bytes(256)),
    KERNEL_ATTR((flash_bidir_bwd_dkv<__nv_bfloat16, 8>), dkv_smem_bytes(256)),
};
}  // namespace

KERNEL_ATTR_ENTRIES(flash_bidir_bwd, ATTRS)

extern "C" const char* flash_bidir_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

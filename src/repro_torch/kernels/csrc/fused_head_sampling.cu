// Fused LM head + Stable-Max sampling for Hopper (sm_90a).
//
// Replaces the Pallas kernel `fused_head_sampling` in
// src/repro/kernels/fused_head_sampling.py.  hidden (R, d) @ w_head (d, V)
// is reduced straight into per-row (max, first-occurrence argmax, exp-sum)
// -- or, with temperature > 0, the counter-Gumbel (best, argmax, z_at) --
// so the (R, V) logits never reach device memory.
//
// What bounds it: at the main-path shape (R = 64 rows, d = 4096,
// V = 126464, bf16) the work is one pass over w_head, 1.04 GB, about
// 0.31 ms at 3.35 TB/s, and 66 GFLOP.  This first version does the product
// with f32 FMAs on the CUDA cores, so it is bound by those operations, well
// above the byte bound; tensor cores (wgmma) are the next step.
//
// Design:
//   * The Pallas grid (R/8, V/chunk) re-reads every weight slab once per
//     8-row tile.  Here one CTA holds up to 128 rows, so w_head streams from
//     device memory once per call.
//   * V is split across CTAs in 64-column ranges: whole 32-wide MX blocks,
//     aligned to column 0 exactly as a full-row fake-quant aligns them.
//   * The product is tiled over d in shared memory (32-deep stages) and
//     accumulated in f32 registers.
//   * The epilogue runs per 32-column MX block, one warp's lanes: cast to the
//     activation dtype, x logit_scale, fake-quant (bf16 / MXFP8 with the
//     block amax from a warp shuffle), mask pad columns and the suppressed
//     id, then the online reduction.  Each CTA writes one partial per row.
//   * A second small kernel merges the partials with the combine_partials
//     rule of core/sampling.py: ties go to the lowest global column, and for
//     Gumbel only a strictly greater score replaces the best so far.
// No fast-math: the MX exponent rule ceil(log2(amax / 448)) and the Gumbel
// log must use the full-precision library functions.
#include "common.cuh"

namespace {

constexpr int TN = 64;        // vocab columns per CTA: two MX blocks
constexpr int TK = 32;        // depth of one shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, each 4 columns x RPT rows

template <typename T, int RPT>
__global__ void __launch_bounds__(THREADS)
head_partials_kernel(const T* __restrict__ hidden, const T* __restrict__ w,
                     int R, int d, int V, int fmt, float logit_scale,
                     float temperature, uint32_t seed, int suppress_id,
                     float* __restrict__ part_m, int* __restrict__ part_i,
                     float* __restrict__ part_s, float* __restrict__ part_b,
                     float* __restrict__ part_z) {
  constexpr int TM = 16 * RPT;
  constexpr int MAIN = TK * (TM + 1) + TK * TN;
  constexpr int EPI = TM * (TN + 1);
  __shared__ __align__(16) float smem[MAIN > EPI ? MAIN : EPI];
  // main loop: hidden tile transposed (padded against bank conflicts) and
  // weight tile; the epilogue reuses the same bytes for the logit tile
  float(*hs)[TM + 1] = reinterpret_cast<float(*)[TM + 1]>(smem);
  float(*ws)[TN] = reinterpret_cast<float(*)[TN]>(smem + TK * (TM + 1));
  float(*zs)[TN + 1] = reinterpret_cast<float(*)[TN + 1]>(smem);

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int v0 = blockIdx.x * TN, r0 = blockIdx.y * TM;

  float acc[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += TK) {
    for (int e = tid; e < TM * TK; e += THREADS) {
      const int r = e / TK, kk = e % TK, gr = r0 + r, gk = k0 + kk;
      hs[kk][r] = (gr < R && gk < d)
                      ? to_f32(hidden[static_cast<size_t>(gr) * d + gk])
                      : 0.f;
    }
    for (int e = tid; e < TK * TN; e += THREADS) {
      const int kk = e / TN, c = e % TN, gk = k0 + kk, gc = v0 + c;
      ws[kk][c] = (gk < d && gc < V)
                      ? to_f32(w[static_cast<size_t>(gk) * V + gc])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float a = hs[kk][ty * RPT + i];
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) zs[ty * RPT + i][tx * 4 + j] = acc[i][j];
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const bool gumbel = temperature > 0.f;
  // logit_scale joins the product in the activation dtype, as a weakly
  // typed Python float does in the JAX reference
  const float scale_t = round_to<T>(logit_scale);
  for (int r = warp; r < TM; r += THREADS / 32) {
    const int gr = r0 + r;
    if (gr >= R) break;
    float z[2];
    int col[2];
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      col[b] = v0 + 32 * b + lane;
      float v = round_to<T>(zs[r][32 * b + lane]);   // f32 acc -> act dtype
      v = round_to<T>(v * scale_t);                   // x logit_scale
      v = fake_quant<T>(v, fmt);    // pad columns are zero logits here
      if (col[b] >= V || col[b] == suppress_id) v = NEG;
      z[b] = v;
    }
    const float m = warp_max(fmaxf(z[0], z[1]));
    const float s = warp_sum(expf(z[0] - m) + expf(z[1] - m));
    int idx = warp_min(min(z[0] >= m ? col[0] : BIG, z[1] >= m ? col[1] : BIG));
    float best = NEG, zat = NEG;
    if (gumbel) {
      const float sc0 = z[0] / temperature + counter_gumbel(seed, gr, col[0]);
      const float sc1 = z[1] / temperature + counter_gumbel(seed, gr, col[1]);
      best = warp_max(fmaxf(sc0, sc1));
      idx = warp_min(min(sc0 >= best ? col[0] : BIG, sc1 >= best ? col[1] : BIG));
      zat = warp_max(col[0] == idx ? z[0] : (col[1] == idx ? z[1] : NEG));
    }
    if (lane == 0) {
      const size_t o = static_cast<size_t>(gr) * gridDim.x + blockIdx.x;
      part_m[o] = m;
      part_i[o] = idx;
      part_s[o] = s;
      if (gumbel) {
        part_b[o] = best;
        part_z[o] = zat;
      }
    }
  }
}

// One warp per row merges the row's n_vt partials (common.cuh
// combine_row: the combine_partials rule of core/sampling.py).
__global__ void head_combine_kernel(const float* __restrict__ part_m,
                                    const int* __restrict__ part_i,
                                    const float* __restrict__ part_s,
                                    const float* __restrict__ part_b,
                                    const float* __restrict__ part_z, int R,
                                    int n_vt, int gumbel,
                                    float* __restrict__ conf,
                                    int* __restrict__ token) {
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= R) return;
  combine_row(part_m, part_i, part_s, part_b, part_z, r, n_vt, gumbel != 0,
              conf, token);
}

template <typename T, int RPT>
cudaError_t launch_partials(const void* hidden, const void* w, int R, int d,
                            int V, int fmt, float logit_scale,
                            float temperature, uint32_t seed, int suppress_id,
                            void* pm, void* pi, void* ps, void* pb, void* pz,
                            cudaStream_t stream) {
  constexpr int TM = 16 * RPT;
  const dim3 grid((V + TN - 1) / TN, (R + TM - 1) / TM);
  head_partials_kernel<T, RPT><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(hidden), static_cast<const T*>(w), R, d, V, fmt,
      logit_scale, temperature, seed, suppress_id, static_cast<float*>(pm),
      static_cast<int*>(pi), static_cast<float*>(ps), static_cast<float*>(pb),
      static_cast<float*>(pz));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rows(int R, const void* hidden, const void* w, int d,
                          int V, int fmt, float logit_scale, float temperature,
                          uint32_t seed, int suppress_id, void* pm, void* pi,
                          void* ps, void* pb, void* pz, cudaStream_t stream) {
#define FHS_LAUNCH(RPT)                                                     \
  return launch_partials<T, RPT>(hidden, w, R, d, V, fmt, logit_scale,      \
                                 temperature, seed, suppress_id, pm, pi, ps, \
                                 pb, pz, stream)
  if (R <= 16) FHS_LAUNCH(1);
  if (R <= 32) FHS_LAUNCH(2);
  if (R <= 64) FHS_LAUNCH(4);
  FHS_LAUNCH(8);
#undef FHS_LAUNCH
}

}  // namespace

// Number of 64-column vocab tiles: the partials workspace is (R, tiles).
extern "C" int fused_head_sampling_tiles(int V) { return (V + TN - 1) / TN; }

// hidden (R, d) and w (d, V), both f32 (is_bf16 = 0) or both bf16; the
// partials workspace part_* is (R, tiles) each (part_b/part_z only read
// and written when temperature > 0); conf (R,) f32, token (R,) i32.
// fmt: 0 none, 1 bf16, 2 mxfp8_e4m3.  suppress_id < 0 suppresses nothing.
extern "C" int fused_head_sampling_launch(
    const void* hidden, const void* w, void* part_m, void* part_i,
    void* part_s, void* part_b, void* part_z, void* conf, void* token, int R,
    int d, int V, int is_bf16, int fmt, float logit_scale, float temperature,
    unsigned int seed, int suppress_id, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? dispatch_rows<__nv_bfloat16>(R, hidden, w, d, V, fmt,
                                             logit_scale, temperature, seed,
                                             suppress_id, part_m, part_i,
                                             part_s, part_b, part_z, st)
              : dispatch_rows<float>(R, hidden, w, d, V, fmt, logit_scale,
                                     temperature, seed, suppress_id, part_m,
                                     part_i, part_s, part_b, part_z, st);
  if (err != cudaSuccess) return err;
  const int n_vt = (V + TN - 1) / TN;
  head_combine_kernel<<<(R + 3) / 4, 128, 0, st>>>(
      static_cast<const float*>(part_m), static_cast<const int*>(part_i),
      static_cast<const float*>(part_s), static_cast<const float*>(part_b),
      static_cast<const float*>(part_z), R, n_vt, temperature > 0.f,
      static_cast<float*>(conf), static_cast<int*>(token));
  return cudaGetLastError();
}

extern "C" const char* fused_head_sampling_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

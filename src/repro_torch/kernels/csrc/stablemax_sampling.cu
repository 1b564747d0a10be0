// One-pass Stable-Max over stored logits, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `stablemax_sampling` in
// src/repro/kernels/stablemax_sampling.py, and computes all of
// core/sampling.stable_max in one launch: per row of logits (R, V), the
// sampling fake-quant of each 32-column block (any format of core/mx:
// none | bf16 | mxfp8_e4m3 | mxint8 | mxint4 | mxfp6_e3m2 | mxfp4_e2m1,
// common.cuh's rules, the format a template argument), the suppressed id set to -1e30 after the
// quantization (so it still counts toward its block's amax), then the
// online (max m, first-occurrence argmax, exp-sum s): conf = 1/s.  With
// temperature > 0 the token is the counter-Gumbel argmax of z/T + g and
// conf = e^(z_at - m)/s, the stream the fused head draws.
//
// What bounds it: bytes, if the instructions keep up.  At the unfused
// tick's shape (R 64 rows, V 126464, bf16) the logits are 16.2 MB, about
// 4.8 us at 3.35 TB/s (the head GEMM has just written them, so they come
// from L2).  That leaves about 20 instructions per logit, and the
// exponentials and conversions run on quarter-rate units (16 per SM and
// clock), so those are what the design counts.
//
// Design:
//   * A lane takes 8 consecutive columns per 16-byte load (two for f32),
//     so a quad holds one MX block.  A CTA (256 threads) walks its column
//     range in passes of STEPS = 2 steps of 2048 columns, each lane's 2
//     loads issued together.  The 2 steps are the 2 blocks of common.cuh
//     quad_block_scales: two quad lanes compute each block's scale, and
//     the elementwise quotient becomes a multiply by the exact inverse
//     power of two (the division stays where exp2f is not exact, on the
//     H100 only at e = -127).  The e4m3 codes come back to f32 by bit
//     moves (common.cuh quant8), the other MX grids through
//     quant_element, and a product q * 2^e that bf16 holds exactly is
//     not rounded again.  fmt none and bf16 have no block step.
//   * Per pass a lane folds its 16 quantized logits at once: their max
//     first; only when it beats the lane's running max does the lane look
//     for the first column holding it and rescale its sum (a branch per
//     pass, not per logit).  Then 16 exponentials with no branch,
//     ex2.approx.ftz of z * log2(e) - m * log2(e) (one FMA each), summed as
//     a tree.  The token depends only on the quantized z, so greedy tokens
//     stay exact; the exp-sum feeds conf alone, which is held to 1e-2
//     relative.  The Gumbel path (T > 0) keeps counter_gumbel per logit
//     with the strict-greater, lowest-column rule.
//   * The wrapper splits V into whole-MX-block ranges from the SM count
//     (kernels/stablemax_sampling.vocab_plan): grid (ranges, R).  Lanes,
//     then the 8 warps, merge with the combine rule (ties to the lowest
//     column), each CTA writes one partial per row, and a second kernel
//     merges the (R, ranges) partials (common.cuh combine_row).  It takes
//     about a seventh of the pair's device time on the H100, under the
//     share at which folding it in would pay (PERF.md); a last-CTA-merges
//     fold through a completion counter and a merge inside a thread block
//     cluster per row each measured no faster.
//   * Any V and any row alignment: a row whose start is not 16-byte
//     aligned, and the chunk that crosses the range's end, load scalar
//     values; columns past V are zero logits for the block amax, then
//     left out.
// Route C (stablemax_sampling_shard_launch) runs the same per-CTA kernel
// on one rank's vocab shard of stored logits and merges its partials into
// the shard's (m, global idx, s), for the decode step over a vocab-sharded
// head of a model without a head mode (launch/steps.py).
// What holds it back on the H100 (clock64 spans per pass): the arithmetic
// per logit, most of it the MX quantization, and CTAs of equal work that
// finish far apart.  Loading the next pass under this one, in registers or
// through a cp.async ring in shared memory, ran slower.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int STEPS = 2;                 // MX blocks per quad and pass
constexpr int STEP_COLS = 8 * THREADS;   // 2048 columns: 64 MX blocks
constexpr float LOG2E = 1.4426950408889634f;

// Online Stable-Max state of one lane, or of a merged set of lanes.
struct State {
  float m, s;     // running max and exp-sum relative to m
  int i;          // column of the max (greedy) or of the best score (Gumbel)
  float b, z;     // best Gumbel score and the logit at its column
};

// The state of no column: the identity of merge.
__device__ __forceinline__ State empty_state() {
  return {NEG, 0.f, BIG, -INFINITY, NEG};
}

// 2^x, approximate (2 ulp), subnormal results flushed to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a <- merge(a, o), the combine rule; order-free apart from the rounding
// of s.
__device__ __forceinline__ void merge(State& a, const State& o, bool gumbel) {
  const float m = fmaxf(a.m, o.m);
  a.s = a.s * ex2((a.m - m) * LOG2E) + o.s * ex2((o.m - m) * LOG2E);
  if (!gumbel) {
    if (o.m > a.m || (o.m == a.m && o.i < a.i)) a.i = o.i;
  } else if (o.b > a.b || (o.b == a.b && o.i < a.i)) {
    a.i = o.i;
    a.b = o.b;
    a.z = o.z;
  }
  a.m = m;
}

__device__ __forceinline__ State shfl_state(const State& st, int o) {
  return {__shfl_xor_sync(FULL_MASK, st.m, o),
          __shfl_xor_sync(FULL_MASK, st.s, o),
          __shfl_xor_sync(FULL_MASK, st.i, o),
          __shfl_xor_sync(FULL_MASK, st.b, o),
          __shfl_xor_sync(FULL_MASK, st.z, o)};
}

// Merge the states of lanes 0 .. 2 * o - 1 into lane 0.
__device__ __forceinline__ void merge_lanes(State& st, int o, bool gumbel) {
  for (; o > 0; o >>= 1) merge(st, shfl_state(st, o), gumbel);
}

// The sampling fake-quant of one pass: z[u] holds this lane's 8 logits of
// step u, which lie in one MX block with the rest of its quad.
template <typename T, int FMT>
__device__ __forceinline__ void fake_quant_pass(float (&z)[STEPS][8]) {
  if (FMT >= FMT_MXFP8) {        // the MX formats
    float amax[STEPS], scale[STEPS], inv[STEPS];
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      amax[u] = fabsf(z[u][0]);
#pragma unroll
      for (int j = 1; j < 8; ++j) amax[u] = fmaxf(amax[u], fabsf(z[u][j]));
    }
    quad_block_scales(amax, FMT, scale, inv);
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      scale_down8(z[u], scale[u], inv[u]);
      quant8(z[u], FMT);
#pragma unroll
      for (int j = 0; j < 8; ++j) z[u][j] = __fmul_rn(z[u][j], scale[u]);
      // q * 2^e has at most 8 significant bits (mxint8's k / 64, |k| <=
      // 128; e4m3 4, e3m2 3, mxint4 3, e2m1 2): bf16 holds it exactly
      // unless it falls below the normal range
      if (scale[u] < 1e-30f) round8<T>(z[u]);
    }
  } else if (FMT == FMT_BF16) {
#pragma unroll
    for (int u = 0; u < STEPS; ++u) round8<__nv_bfloat16>(z[u]);
  }
}

// Fold one pass of quantized logits into the lane's state: z[u][j] is
// column c0 + u * STEP_COLS + j, so (u, j) order is column order.  mL is
// st.m * log2(e).
template <bool GUMBEL>
__device__ __forceinline__ void fold_pass(State& st, float& mL,
                                          const float (&z)[STEPS][8], int c0,
                                          const int (&n)[STEPS],
                                          float temperature, uint32_t seed,
                                          int r) {
  float cm = -INFINITY;
#pragma unroll
  for (int u = 0; u < STEPS; ++u) {
    const float lo = fmaxf(fmaxf(z[u][0], z[u][1]), fmaxf(z[u][2], z[u][3]));
    const float hi = fmaxf(fmaxf(z[u][4], z[u][5]), fmaxf(z[u][6], z[u][7]));
    cm = fmaxf(cm, fmaxf(lo, hi));
  }
  if (cm > st.m) {               // strictly greater: the first occurrence
    if (!GUMBEL) {
      int k = BIG;
#pragma unroll
      for (int u = STEPS - 1; u >= 0; --u)
#pragma unroll
        for (int j = 7; j >= 0; --j) k = z[u][j] == cm ? u * STEP_COLS + j : k;
      st.i = c0 + k;
    }
    st.s *= ex2((st.m - cm) * LOG2E);
    st.m = cm;
    mL = cm * LOG2E;
  }
  if (st.m == NEG) {
    // only suppressed columns so far: each adds e^(z - m) = 1, as in the
    // plain version (z * log2(e) - mL would not be exact at this scale)
#pragma unroll
    for (int u = 0; u < STEPS; ++u)
#pragma unroll
      for (int j = 0; j < 8; ++j) st.s += z[u][j] == NEG ? 1.f : 0.f;
  } else {
    float e = 0.f;
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      float p[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) p[j] = ex2(fmaf(z[u][j], LOG2E, -mL));
      e += ((p[0] + p[1]) + (p[2] + p[3])) + ((p[4] + p[5]) + (p[6] + p[7]));
    }
    st.s += e;
  }
  if (GUMBEL) {
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= n[u]) break;
        const int c = c0 + u * STEP_COLS + j;
        const float sc = z[u][j] / temperature + counter_gumbel(seed, r, c);
        if (sc > st.b) {
          st.b = sc;
          st.i = c;
          st.z = z[u][j];
        }
      }
    }
  }
}

struct Args {
  int V, cols;                   // cols: columns per CTA, a multiple of 32
  float temperature;
  const uint32_t* seed;          // in device memory, read when GUMBEL
  int suppress_id;               // < 0: none
  float *part_m, *part_s, *part_b, *part_z;
  int* part_i;
};

// grid (ranges, R): CTA (x, r) folds columns [x * cols, (x + 1) * cols) of
// row r into part_*[r, x].
template <typename T, int FMT, bool GUMBEL>
__global__ void __launch_bounds__(THREADS)
stablemax_kernel(const T* __restrict__ logits, const Args a) {
  __shared__ State warp_state[WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.y;
  const int c_begin = blockIdx.x * a.cols;
  const int c_end = min(c_begin + a.cols, a.V);
  const T* row = logits + static_cast<size_t>(r) * a.V;
  // 16-byte loads need the row start 16-byte aligned
  const bool vec = reinterpret_cast<uintptr_t>(row) % 16 == 0;

  // the seed lives in device memory: a captured graph reads each tick's
  const uint32_t seed = GUMBEL ? *a.seed : 0u;
  State st = empty_state();
  float mL = NEG * LOG2E;
  for (int base = c_begin; base < c_end; base += STEPS * STEP_COLS) {
    const int c0 = base + 8 * threadIdx.x;
    float z[STEPS][8];
    int n[STEPS];
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      // a step with no column forms no pointer: one past the logits' end
      // was read as a 16-byte load, which faults where the logits end on
      // a page ((512, 256000) bf16 ends on a 2 MiB boundary)
      const int c = c0 + u * STEP_COLS;
      n[u] = max(0, min(8, c_end - c));
      if (n[u] > 0) {
        load8(row + c, n[u], vec, z[u]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) z[u][j] = 0.f;
      }
    }
    fake_quant_pass<T, FMT>(z);
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      const int c = c0 + u * STEP_COLS;
      if (static_cast<unsigned>(a.suppress_id - c) < 8u) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (c + j == a.suppress_id) z[u][j] = NEG;
      }
      if (n[u] < 8) {            // columns of the next range, or past V
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (j >= n[u]) z[u][j] = -INFINITY;
      }
    }
    fold_pass<GUMBEL>(st, mL, z, c0, n, a.temperature, seed, r);
  }
  merge_lanes(st, 16, GUMBEL);
  if (lane == 0) warp_state[warp] = st;
  __syncthreads();
  if (warp != 0) return;
  st = lane < WARPS ? warp_state[lane] : empty_state();
  merge_lanes(st, WARPS / 2, GUMBEL);
  if (lane == 0) {
    const size_t o = static_cast<size_t>(r) * gridDim.x + blockIdx.x;
    a.part_m[o] = st.m;
    a.part_i[o] = st.i;
    a.part_s[o] = st.s;
    if (GUMBEL) {
      a.part_b[o] = st.b;
      a.part_z[o] = st.z;
    }
  }
}

__global__ void stablemax_combine_kernel(const float* __restrict__ part_m,
                                         const int* __restrict__ part_i,
                                         const float* __restrict__ part_s,
                                         const float* __restrict__ part_b,
                                         const float* __restrict__ part_z,
                                         int R, int n_vt, int gumbel,
                                         float* __restrict__ conf,
                                         int* __restrict__ token) {
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= R) return;
  combine_row(part_m, part_i, part_s, part_b, part_z, r, n_vt, gumbel != 0,
              conf, token);
}

// Route C, the vocab-shard entry: one warp per row merges the row's n_vt
// greedy per-CTA partials into (m, global idx, s) (common.cuh
// shard_merge_row), which the decode step over a vocab-sharded head
// merges across ranks (core/sampling.combine_partials).
__global__ void stablemax_shard_merge_kernel(const float* __restrict__ part_m,
                                             const int* __restrict__ part_i,
                                             const float* __restrict__ part_s,
                                             int R, int n_vt, int col_offset,
                                             float* __restrict__ m_out,
                                             int* __restrict__ idx_out,
                                             float* __restrict__ s_out) {
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= R) return;
  shard_merge_row(part_m, part_i, part_s, r, n_vt, col_offset, m_out,
                  idx_out, s_out);
}

template <typename T, int FMT, bool GUMBEL>
cudaError_t launch(const T* logits, int R, const Args& a,
                   cudaStream_t stream) {
  const dim3 grid((a.V + a.cols - 1) / a.cols, R);
  stablemax_kernel<T, FMT, GUMBEL><<<grid, THREADS, 0, stream>>>(logits, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* logits, int R, int fmt, const Args& a,
                   cudaStream_t stream) {
  const T* x = static_cast<const T*>(logits);
  const bool g = a.temperature > 0.f;
  switch (fmt) {
    case FMT_NONE:
      return g ? launch<T, FMT_NONE, true>(x, R, a, stream)
               : launch<T, FMT_NONE, false>(x, R, a, stream);
    case FMT_BF16:
      return g ? launch<T, FMT_BF16, true>(x, R, a, stream)
               : launch<T, FMT_BF16, false>(x, R, a, stream);
    case FMT_MXFP8:
      return g ? launch<T, FMT_MXFP8, true>(x, R, a, stream)
               : launch<T, FMT_MXFP8, false>(x, R, a, stream);
    case FMT_MXINT8:
      return g ? launch<T, FMT_MXINT8, true>(x, R, a, stream)
               : launch<T, FMT_MXINT8, false>(x, R, a, stream);
    case FMT_MXINT4:
      return g ? launch<T, FMT_MXINT4, true>(x, R, a, stream)
               : launch<T, FMT_MXINT4, false>(x, R, a, stream);
    case FMT_MXFP6:
      return g ? launch<T, FMT_MXFP6, true>(x, R, a, stream)
               : launch<T, FMT_MXFP6, false>(x, R, a, stream);
    default:
      return g ? launch<T, FMT_MXFP4, true>(x, R, a, stream)
               : launch<T, FMT_MXFP4, false>(x, R, a, stream);
  }
}

}  // namespace

// logits (R, V) contiguous, f32 (is_bf16 = 0) or bf16; cols, a positive
// multiple of 32, the columns per CTA; the partials workspace part_* is
// (R, ceil(V / cols)) each (part_b/part_z only read and written when
// temperature > 0); conf (R,) f32, token (R,) i32.  fmt: a code of
// common.cuh Fmt (core/mx.FMT_CODES), 0 none to 6 mxfp4_e2m1.
// suppress_id < 0 suppresses nothing.  seed: the uint32
// counter-Gumbel seed in device memory (the low word of an int64 holding
// it), read only when temperature > 0.
extern "C" int stablemax_sampling_launch(
    const void* logits, void* part_m, void* part_i, void* part_s,
    void* part_b, void* part_z, void* conf, void* token, int R, int V,
    int cols, int is_bf16, int fmt, float temperature, const void* seed,
    int suppress_id, void* stream) {
  if (fmt < FMT_NONE || fmt > FMT_MXFP4 || cols <= 0 || cols % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0 || V == 0) return 0;
  const Args a = {V,
                  cols,
                  temperature,
                  static_cast<const uint32_t*>(seed),
                  suppress_id,
                  static_cast<float*>(part_m),
                  static_cast<float*>(part_s),
                  static_cast<float*>(part_b),
                  static_cast<float*>(part_z),
                  static_cast<int*>(part_i)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16 ? launch<__nv_bfloat16>(logits, R, fmt, a, st)
                            : launch<float>(logits, R, fmt, a, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  stablemax_combine_kernel<<<(R + 3) / 4, 128, 0, st>>>(
      static_cast<const float*>(part_m), static_cast<const int*>(part_i),
      static_cast<const float*>(part_s), static_cast<const float*>(part_b),
      static_cast<const float*>(part_z), R, (V + cols - 1) / cols,
      temperature > 0.f, static_cast<float*>(conf), static_cast<int*>(token));
  return static_cast<int>(cudaGetLastError());
}

// Route C: the greedy partials of one vocab shard of stored logits.
// logits (R, V) contiguous, f32 (is_bf16 = 0) or bf16, are the shard's
// columns, global columns col_offset .. col_offset + V - 1; V a multiple
// of 32, so the shard's MX blocks are the full row's.  suppress_id is a
// column of the shard (< 0: none).  cols and the partials workspace
// part_m/part_i/part_s (R, ceil(V / cols)) as stablemax_sampling_launch's;
// m_out, s_out (R,) f32 and idx_out (R,) i32 receive the merged (m,
// global idx, s), s relative to m.
extern "C" int stablemax_sampling_shard_launch(
    const void* logits, void* part_m, void* part_i, void* part_s,
    void* m_out, void* idx_out, void* s_out, int R, int V, int cols,
    int is_bf16, int fmt, int suppress_id, int col_offset, void* stream) {
  if (fmt < FMT_NONE || fmt > FMT_MXFP4 || cols <= 0 || cols % 32 ||
      V % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0 || V == 0) return 0;
  const Args a = {V,
                  cols,
                  0.f,
                  nullptr,
                  suppress_id,
                  static_cast<float*>(part_m),
                  static_cast<float*>(part_s),
                  nullptr,
                  nullptr,
                  static_cast<int*>(part_i)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16 ? launch<__nv_bfloat16>(logits, R, fmt, a, st)
                            : launch<float>(logits, R, fmt, a, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  stablemax_shard_merge_kernel<<<(R + 3) / 4, 128, 0, st>>>(
      static_cast<const float*>(part_m), static_cast<const int*>(part_i),
      static_cast<const float*>(part_s), R, (V + cols - 1) / cols,
      col_offset, static_cast<float*>(m_out), static_cast<int*>(idx_out),
      static_cast<float*>(s_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* stablemax_sampling_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

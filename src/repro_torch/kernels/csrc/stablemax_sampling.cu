// One-pass Stable-Max over stored logits, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `stablemax_sampling` in
// src/repro/kernels/stablemax_sampling.py, and computes all of
// core/sampling.stable_max in one launch: per row of logits (R, V), the
// sampling fake-quant of each 32-column block (none | bf16 | mxfp8_e4m3,
// common.cuh fake_quant), the suppressed id set to -1e30 after the
// quantization (so it still counts toward its block's amax), then the
// online (max m, first-occurrence argmax, exp-sum s): conf = 1/s.  With
// temperature > 0 the token is the counter-Gumbel argmax of z/T + g and
// conf = e^(z_at - m)/s, the stream the fused head draws.
//
// What bounds it: bytes.  At the unfused tick's shape (R 64 rows,
// V 126464, bf16) the logits are 16.2 MB, about 4.8 us at 3.35 TB/s; the
// work is a few operations and one exp per logit.
//
// Design: V splits across CTAs in 2048-column tiles (64 MX blocks), one
// CTA per (tile, row), so 64 rows make 3968 CTAs for the 132 SMs.  Each
// warp walks its tile's blocks one lane per column; every lane keeps its
// own online state (strictly greater replaces, so a lane keeps its first
// occurrence), the CTA merges lanes and warps with the combine rule, and a
// second kernel merges the per-tile partials exactly as the fused head
// does (common.cuh combine_row): ties go to the lowest column.
#include "common.cuh"

namespace {

constexpr int TV = 2048;      // vocab columns per CTA: 64 MX blocks
constexpr int WARPS = 8;

// Online Stable-Max state of one lane, or of a merged set of lanes.
struct State {
  float m, s;     // running max and exp-sum relative to m
  int i;          // column of the max (greedy) or of the best score (Gumbel)
  float b, z;     // best Gumbel score and the logit at its column
};

// a <- merge(a, b); order-free apart from the rounding of s.
__device__ __forceinline__ void merge(State& a, const State& o, bool gumbel) {
  const float m = fmaxf(a.m, o.m);
  a.s = a.s * expf(a.m - m) + o.s * expf(o.m - m);
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

template <typename T>
__global__ void __launch_bounds__(32 * WARPS)
stablemax_partials_kernel(const T* __restrict__ logits, int V, int fmt,
                          float temperature, uint32_t seed, int suppress_id,
                          float* __restrict__ part_m, int* __restrict__ part_i,
                          float* __restrict__ part_s,
                          float* __restrict__ part_b,
                          float* __restrict__ part_z) {
  __shared__ State warp_state[WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.y, v0 = blockIdx.x * TV;
  const bool gumbel = temperature > 0.f;
  const T* row = logits + static_cast<size_t>(r) * V;

  State st = {NEG, 0.f, BIG, -INFINITY, NEG};
  for (int c0 = v0 + 32 * warp; c0 < min(v0 + TV, V); c0 += 32 * WARPS) {
    const int col = c0 + lane;
    // pad columns past V are zero logits for the block amax, then skipped
    float z = col < V ? to_f32(row[col]) : 0.f;
    z = fake_quant<T>(z, fmt);
    if (col >= V) continue;
    if (col == suppress_id) z = NEG;
    if (z > st.m) {
      st.s = st.s * expf(st.m - z) + 1.f;
      st.m = z;
      if (!gumbel) st.i = col;
    } else {
      st.s += expf(z - st.m);
    }
    if (gumbel) {
      const float sc = z / temperature + counter_gumbel(seed, r, col);
      if (sc > st.b) {
        st.b = sc;
        st.i = col;
        st.z = z;
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) merge(st, shfl_state(st, o), gumbel);
  if (lane == 0) warp_state[warp] = st;
  __syncthreads();
  if (threadIdx.x != 0) return;
  st = warp_state[0];
  for (int w = 1; w < WARPS; ++w) merge(st, warp_state[w], gumbel);
  const size_t o = static_cast<size_t>(r) * gridDim.x + blockIdx.x;
  part_m[o] = st.m;
  part_i[o] = st.i;
  part_s[o] = st.s;
  if (gumbel) {
    part_b[o] = st.b;
    part_z[o] = st.z;
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

template <typename T>
cudaError_t launch_partials(const void* logits, int R, int V, int fmt,
                            float temperature, uint32_t seed, int suppress_id,
                            void* pm, void* pi, void* ps, void* pb, void* pz,
                            cudaStream_t stream) {
  const dim3 grid((V + TV - 1) / TV, R);
  stablemax_partials_kernel<T><<<grid, 32 * WARPS, 0, stream>>>(
      static_cast<const T*>(logits), V, fmt, temperature, seed, suppress_id,
      static_cast<float*>(pm), static_cast<int*>(pi), static_cast<float*>(ps),
      static_cast<float*>(pb), static_cast<float*>(pz));
  return cudaGetLastError();
}

}  // namespace

// Number of vocab tiles: the partials workspace is (R, tiles).
extern "C" int stablemax_sampling_tiles(int V) { return (V + TV - 1) / TV; }

// logits (R, V) contiguous, f32 (is_bf16 = 0) or bf16; the partials
// workspace part_* is (R, tiles) each (part_b/part_z only read and written
// when temperature > 0); conf (R,) f32, token (R,) i32.  fmt: 0 none,
// 1 bf16, 2 mxfp8_e4m3.  suppress_id < 0 suppresses nothing.
extern "C" int stablemax_sampling_launch(
    const void* logits, void* part_m, void* part_i, void* part_s,
    void* part_b, void* part_z, void* conf, void* token, int R, int V,
    int is_bf16, int fmt, float temperature, unsigned int seed,
    int suppress_id, void* stream) {
  if (fmt != FMT_NONE && fmt != FMT_BF16 && fmt != FMT_MXFP8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0 || V == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch_partials<__nv_bfloat16>(logits, R, V, fmt, temperature,
                                               seed, suppress_id, part_m,
                                               part_i, part_s, part_b, part_z,
                                               st)
              : launch_partials<float>(logits, R, V, fmt, temperature, seed,
                                       suppress_id, part_m, part_i, part_s,
                                       part_b, part_z, st);
  if (err != cudaSuccess) return err;
  stablemax_combine_kernel<<<(R + 3) / 4, 128, 0, st>>>(
      static_cast<const float*>(part_m), static_cast<const int*>(part_i),
      static_cast<const float*>(part_s), static_cast<const float*>(part_b),
      static_cast<const float*>(part_z), R, (V + TV - 1) / TV,
      temperature > 0.f, static_cast<float*>(conf), static_cast<int*>(token));
  return cudaGetLastError();
}

extern "C" const char* stablemax_sampling_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

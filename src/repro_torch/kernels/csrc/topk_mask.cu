// Top-k transfer mask over the active block for Hopper (sm_90a).
//
// Replaces the Pallas kernel `topk_mask` in src/repro/kernels/topk_mask.py.
// Per row of L positions: unmasked confidences become -1e30, the stable
// descending rank is r_i = #{c_j > c_i} + #{j < i, c_j == c_i}, and
// transfer_i = masked_i && r_i < min(k, #masked) -- the exact tie order of
// the reference, which a sort that is not stable would break.
//
// What bounds it: launch latency.  At the main-path shape (4 x 16) it
// moves about 400 bytes and does a few thousand compares, so its byte
// bound is about a tenth of a nanosecond while one launch of an empty
// kernel costs microseconds (chip_smoke.py measures that floor beside it).
// The design therefore works on what surrounds the kernel, not its body:
//   * it reads the caller's types -- the bool mask as bytes, k as int32 or
//     int64 -- and writes the bool transfer mask as bytes, so a top-k call
//     is one launch (no cast kernels before or after it);
//   * it is a plain launch.  Programmatic dependent launch, which would let
//     its launch overlap the kernel before it, was measured in the graphed
//     tick on an H100 and lost: the gap before this kernel grew from
//     0.05-0.45 us to about 1.0 us (the kernels before it are PyTorch's,
//     which never trigger their dependents early; PERF.md).
// Two routes, chosen by the caller from L (kernels/topk_mask.route):
//   * "warp", L <= 64: one warp owns one row, each lane holds positions
//     lane and lane + 32 in registers, the row sits in 256 bytes of shared
//     memory for the O(L^2) compares, and the masked count is two ballots;
//   * "cta", any L: one CTA of 256 threads owns one row.  Each thread
//     ranks up to 4 of its own positions (held in registers) per pass
//     while the row's masked confidences stream through shared memory in
//     1024-position tiles (4 KB: the mask folds into the value as -1e30),
//     so no L is too long; the first pass counts the masked positions
//     with __syncthreads_count as it stages the tiles.  Every thread
//     reads the same four tile words at a time (a broadcast 16-byte load,
//     no bank conflict); the compares are O(L^2 / 256) per thread.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int ROWS_PER_CTA = 4;

template <typename KT>
__global__ void __launch_bounds__(32 * ROWS_PER_CTA)
topk_mask_kernel(const float* __restrict__ conf,
                 const uint8_t* __restrict__ mask, const KT* __restrict__ k,
                 uint8_t* __restrict__ out, int R, int L) {
  __shared__ float cs[ROWS_PER_CTA][64];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * ROWS_PER_CTA + warp;
  const size_t base = static_cast<size_t>(r) * L;
  const int i0 = lane, i1 = lane + 32;
  if (r >= R) return;  // whole warp leaves; only __syncwarp below
  const bool m0 = i0 < L && mask[base + i0] != 0;
  const bool m1 = i1 < L && mask[base + i1] != 0;
  const float c0 = m0 ? conf[base + i0] : NEG;
  const float c1 = m1 ? conf[base + i1] : NEG;
  cs[warp][i0] = c0;
  cs[warp][i1] = c1;
  __syncwarp();
  const int n_masked = __popc(__ballot_sync(FULL_MASK, m0)) +
                       __popc(__ballot_sync(FULL_MASK, m1));
  const long long take = min(static_cast<long long>(k[r]),
                             static_cast<long long>(n_masked));
  int rank0 = 0, rank1 = 0;
  for (int j = 0; j < L; ++j) {
    const float cj = cs[warp][j];
    rank0 += (cj > c0) || (cj == c0 && j < i0);
    rank1 += (cj > c1) || (cj == c1 && j < i1);
  }
  if (i0 < L) out[base + i0] = m0 && rank0 < take;
  if (i1 < L) out[base + i1] = m1 && rank1 < take;
}

template <typename KT>
void launch(const float* conf, const uint8_t* mask, const KT* k, uint8_t* out,
            int R, int L, cudaStream_t stream) {
  topk_mask_kernel<KT>
      <<<(R + ROWS_PER_CTA - 1) / ROWS_PER_CTA, 32 * ROWS_PER_CTA, 0, stream>>>(
          conf, mask, k, out, R, L);
}

constexpr int CTA_THREADS = 256;
constexpr int CTA_OWN = 4;       // positions a thread ranks per pass
constexpr int CTA_TILE = 1024;   // positions of the row per shared tile

template <typename KT>
__global__ void __launch_bounds__(CTA_THREADS)
topk_mask_kernel_cta(const float* __restrict__ conf,
                     const uint8_t* __restrict__ mask,
                     const KT* __restrict__ k, uint8_t* __restrict__ out,
                     int L) {
  __shared__ __align__(16) float cs[CTA_TILE];
  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * L;
  int n_masked = 0;
  for (int i0 = 0; i0 < L; i0 += CTA_THREADS * CTA_OWN) {
    float ci[CTA_OWN];
    bool mi[CTA_OWN];
    int rank[CTA_OWN];
#pragma unroll
    for (int u = 0; u < CTA_OWN; ++u) {
      const int i = i0 + u * CTA_THREADS + tid;
      mi[u] = i < L && mask[base + i] != 0;
      ci[u] = mi[u] ? conf[base + i] : NEG;
      rank[u] = 0;
    }
    for (int j0 = 0; j0 < L; j0 += CTA_TILE) {
      __syncthreads();                  // the previous tile is read
#pragma unroll
      for (int e = tid; e < CTA_TILE; e += CTA_THREADS) {
        const int j = j0 + e;
        const bool mj = j < L && mask[base + j] != 0;
        cs[e] = mj ? conf[base + j] : NEG;
        // the first pass over the row also counts its masked positions
        // (a uniform trip count: every thread reaches each call)
        if (i0 == 0) n_masked += __syncthreads_count(mj);
      }
      __syncthreads();
      const int n = min(CTA_TILE, L - j0);
      // four tile words a step (one broadcast 16-byte shared load), the
      // tail one by one: the ranks count exactly the row's positions
      int e = 0;
      for (; e + 4 <= n; e += 4) {
        const float4 c4 = *reinterpret_cast<const float4*>(&cs[e]);
        const float cj[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + e + q;
#pragma unroll
          for (int u = 0; u < CTA_OWN; ++u)     // branch-free compares
            rank[u] += static_cast<int>(cj[q] > ci[u]) +
                       static_cast<int>((cj[q] == ci[u]) &
                                        (j < i0 + u * CTA_THREADS + tid));
        }
      }
      for (; e < n; ++e) {
        const float cj = cs[e];
        const int j = j0 + e;
#pragma unroll
        for (int u = 0; u < CTA_OWN; ++u)
          rank[u] += static_cast<int>(cj > ci[u]) +
                     static_cast<int>((cj == ci[u]) &
                                      (j < i0 + u * CTA_THREADS + tid));
      }
    }
    const long long take = min(static_cast<long long>(k[blockIdx.x]),
                               static_cast<long long>(n_masked));
#pragma unroll
    for (int u = 0; u < CTA_OWN; ++u) {
      const int i = i0 + u * CTA_THREADS + tid;
      if (i < L) out[base + i] = mi[u] && rank[u] < take;
    }
  }
}

template <typename KT>
void launch_cta(const float* conf, const uint8_t* mask, const KT* k,
                uint8_t* out, int R, int L, cudaStream_t stream) {
  topk_mask_kernel_cta<KT><<<R, CTA_THREADS, 0, stream>>>(conf, mask, k, out,
                                                          L);
}

__global__ void empty_kernel() {}

}  // namespace

// conf (R, L) f32, mask (R, L) bool (one byte each), k (R,) int32
// (k_is_int64 = 0) or int64 -> out (R, L) bool.  route 0 is the warp
// route (L <= 64), route 1 the CTA route (any L).
extern "C" int topk_mask_launch(const void* conf, const void* mask,
                                const void* k, void* out, int R, int L,
                                int k_is_int64, int route, void* stream) {
  if (L < 1 || R < 0 || route < 0 || route > 1 || (route == 0 && L > 64))
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  const float* c = static_cast<const float*>(conf);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  uint8_t* o = static_cast<uint8_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k_is_int64) {
    const auto* kk = static_cast<const long long*>(k);
    if (route == 0) launch(c, m, kk, o, R, L, st);
    else launch_cta(c, m, kk, o, R, L, st);
  } else {
    const auto* kk = static_cast<const int*>(k);
    if (route == 0) launch(c, m, kk, o, R, L, st);
    else launch_cta(c, m, kk, o, R, L, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// One launch of an empty kernel (1 CTA of 32 threads): the card's floor for
// the device time of any launch, measured beside this kernel.
extern "C" int topk_mask_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

namespace {
// every instantiation the entry points above launch
const KernelAttr ATTRS[] = {
    KERNEL_ATTR(topk_mask_kernel<int>, 0),
    KERNEL_ATTR(topk_mask_kernel<long long>, 0),
    KERNEL_ATTR(topk_mask_kernel_cta<int>, 0),
    KERNEL_ATTR(topk_mask_kernel_cta<long long>, 0),
    KERNEL_ATTR(empty_kernel, 0),
};
}  // namespace

KERNEL_ATTR_ENTRIES(topk_mask, ATTRS)

extern "C" const char* topk_mask_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

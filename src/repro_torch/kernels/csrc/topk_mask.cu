// Top-k transfer mask over the active block for Hopper (sm_90a).
//
// Replaces the Pallas kernel `topk_mask` in src/repro/kernels/topk_mask.py.
// Per row of L <= 64 positions: unmasked confidences become -1e30, the
// stable descending rank is r_i = #{c_j > c_i} + #{j < i, c_j == c_i}, and
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
// The body is unchanged: one warp owns one row, each lane holds positions
// lane and lane + 32 in registers, the row sits in 256 bytes of shared
// memory for the O(L^2) compares, and the masked count is two ballots.
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

__global__ void empty_kernel() {}

}  // namespace

// conf (R, L) f32, mask (R, L) bool (one byte each), k (R,) int32
// (k_is_int64 = 0) or int64 -> out (R, L) bool.
extern "C" int topk_mask_launch(const void* conf, const void* mask,
                                const void* k, void* out, int R, int L,
                                int k_is_int64, void* stream) {
  if (L < 1 || L > 64 || R < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  const float* c = static_cast<const float*>(conf);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  uint8_t* o = static_cast<uint8_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k_is_int64)
    launch(c, m, static_cast<const long long*>(k), o, R, L, st);
  else
    launch(c, m, static_cast<const int*>(k), o, R, L, st);
  return static_cast<int>(cudaGetLastError());
}

// One launch of an empty kernel (1 CTA of 32 threads): the card's floor for
// the device time of any launch, measured beside this kernel.
extern "C" int topk_mask_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* topk_mask_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

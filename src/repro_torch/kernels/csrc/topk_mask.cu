// Top-k transfer mask over the active block for Hopper (sm_90a).
//
// Replaces the Pallas kernel `topk_mask` in src/repro/kernels/topk_mask.py.
// Per row of L <= 64 positions: unmasked confidences become -1e30, the
// stable descending rank is r_i = #{c_j > c_i} + #{j < i, c_j == c_i}, and
// transfer_i = masked_i && r_i < min(k, #masked) -- the exact tie order of
// the reference, which a sort that is not stable would break.
//
// What bounds it: nothing on this card.  At the main-path shape (4 x 16)
// it moves a few hundred bytes and does a few thousand compares, so its
// time is launch latency.  One warp owns one row: each lane holds positions
// lane and lane + 32 in registers, the row sits in 256 bytes of shared
// memory for the O(L^2) compares, and the masked count is two ballots.
#include "common.cuh"

namespace {

constexpr int ROWS_PER_CTA = 4;

__global__ void __launch_bounds__(32 * ROWS_PER_CTA)
topk_mask_kernel(const float* __restrict__ conf, const int* __restrict__ mask,
                 const int* __restrict__ k, int* __restrict__ out, int R,
                 int L) {
  __shared__ float cs[ROWS_PER_CTA][64];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * ROWS_PER_CTA + warp;
  if (r >= R) return;  // whole warp leaves; only __syncwarp below
  const float* c = conf + static_cast<size_t>(r) * L;
  const int* mk = mask + static_cast<size_t>(r) * L;
  const int i0 = lane, i1 = lane + 32;
  const bool m0 = i0 < L && mk[i0] != 0;
  const bool m1 = i1 < L && mk[i1] != 0;
  const float c0 = m0 ? c[i0] : NEG;
  const float c1 = m1 ? c[i1] : NEG;
  cs[warp][i0] = c0;
  cs[warp][i1] = c1;
  __syncwarp();
  const int n_masked = __popc(__ballot_sync(FULL_MASK, m0)) +
                       __popc(__ballot_sync(FULL_MASK, m1));
  const int take = min(k[r], n_masked);
  int rank0 = 0, rank1 = 0;
  for (int j = 0; j < L; ++j) {
    const float cj = cs[warp][j];
    rank0 += (cj > c0) || (cj == c0 && j < i0);
    rank1 += (cj > c1) || (cj == c1 && j < i1);
  }
  if (i0 < L) out[static_cast<size_t>(r) * L + i0] = m0 && rank0 < take;
  if (i1 < L) out[static_cast<size_t>(r) * L + i1] = m1 && rank1 < take;
}

}  // namespace

// conf (R, L) f32, mask (R, L) i32 {0, 1}, k (R,) i32 -> out (R, L) i32.
extern "C" int topk_mask_launch(const void* conf, const void* mask,
                                const void* k, void* out, int R, int L,
                                void* stream) {
  if (L < 1 || L > 64) return static_cast<int>(cudaErrorInvalidValue);
  topk_mask_kernel<<<(R + ROWS_PER_CTA - 1) / ROWS_PER_CTA,
                     32 * ROWS_PER_CTA, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(conf), static_cast<const int*>(mask),
      static_cast<const int*>(k), static_cast<int*>(out), R, L);
  return cudaGetLastError();
}

extern "C" const char* topk_mask_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

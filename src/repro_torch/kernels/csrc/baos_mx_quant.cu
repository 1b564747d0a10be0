// BAOS smoothing + MX fake-quant of the KV write-back, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `baos_mx_quant` in
// src/repro/kernels/baos_mx_quant.py.  Per channel (b, h, d) of a K or V
// tensor (B, S, H, D): x_s = (x - c) / f with the BAOS calibration c, f
// (B, 1, H, D) f32, then the MX fake-quant of each 32-wide block along D
// (mxint4 | mxint8 | mxfp8_e4m3, core/mx.mx_fake_quant's rules, common.cuh
// fake_quant), and the result cast to x's dtype.  The output goes through
// its own pointer and strides, so the caller can hand it the KV cache slice
// itself: the smoothed, quantized K/V are written in place, as the paper's
// warm step writes the cache, and never round-trip through a temporary.
//
// What bounds it: bytes.  At the warm tick's shape (B 4, S 96, H 32,
// D 128, bf16) one call reads 3.1 MB and writes 3.1 MB, about 1.9 us at
// 3.35 TB/s, and does a handful of operations per element.  The tick makes
// 64 calls (K and V of 32 layers), so launch latency dominates.
//
// Design: one warp per MX block, one element per lane; the block amax is a
// warp shuffle.  One CTA row per (b, s), so the index math is two 32-bit
// operations.  True IEEE division for (x - c)/f and for the block scale,
// so kernel and plain version agree bit for bit.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps: 8 MX blocks of one (b, s) row

// grid (B * S, ceil(H * D / THREADS)): blockIdx.x is the (b, s) row, and
// thread t of CTA y the element h * D + dd = y * THREADS + t of that row,
// so each warp's 32 lanes are one MX block (D is a multiple of 32).
template <typename T>
__global__ void __launch_bounds__(THREADS)
baos_mx_quant_kernel(const T* __restrict__ x, const float* __restrict__ c,
                     const float* __restrict__ f, T* __restrict__ out, int S,
                     int HD, long long x_sb, long long x_ss, long long o_sb,
                     long long o_ss, int fmt) {
  const int hd = blockIdx.y * THREADS + threadIdx.x;
  if (hd - static_cast<int>(threadIdx.x & 31) >= HD) return;  // whole warps
  const int b = blockIdx.x / S, s = blockIdx.x % S;
  const size_t cal = static_cast<size_t>(b) * HD + hd;
  const float v = (to_f32(x[b * x_sb + s * x_ss + hd]) - c[cal]) / f[cal];
  out[b * o_sb + s * o_ss + hd] = from_f32<T>(fake_quant<float>(v, fmt));
}

template <typename T>
cudaError_t launch(const void* x, const void* c, const void* f, void* out,
                   int B, int S, int H, int D, long long x_sb, long long x_ss,
                   long long o_sb, long long o_ss, int fmt,
                   cudaStream_t stream) {
  const dim3 grid(B * S, (H * D + THREADS - 1) / THREADS);
  baos_mx_quant_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(c),
      static_cast<const float*>(f), static_cast<T*>(out), S, H * D, x_sb,
      x_ss, o_sb, o_ss, fmt);
  return cudaGetLastError();
}

}  // namespace

// x (B, S, H, D) and out (B, S, H, D), both f32 (is_bf16 = 0) or both bf16,
// each with (H, D) contiguous and the given B and S strides in elements;
// c and f (B, 1, H, D) f32 contiguous; D a multiple of 32.  fmt:
// 2 mxfp8_e4m3, 3 mxint8, 4 mxint4 (common.cuh Fmt).
extern "C" int baos_mx_quant_launch(const void* x, const void* c,
                                    const void* f, void* out, int B, int S,
                                    int H, int D, long long x_sb,
                                    long long x_ss, long long o_sb,
                                    long long o_ss, int fmt, int is_bf16,
                                    void* stream) {
  if (D % 32 || (fmt != FMT_MXFP8 && fmt != FMT_MXINT8 && fmt != FMT_MXINT4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(B) * S * H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? launch<__nv_bfloat16>(x, c, f, out, B, S, H, D, x_sb, x_ss,
                                      o_sb, o_ss, fmt, st)
              : launch<float>(x, c, f, out, B, S, H, D, x_sb, x_ss, o_sb,
                              o_ss, fmt, st));
}

extern "C" const char* baos_mx_quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

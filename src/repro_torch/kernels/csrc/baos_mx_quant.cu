// BAOS smoothing + MX fake-quant of the KV write-back, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `baos_mx_quant` in
// src/repro/kernels/baos_mx_quant.py.  Per channel (b, h, d) of a K or V
// tensor (B, S, H, D): x_s = (x - c) / f with the BAOS calibration c, f
// (B, 1, H, D) f32, then the MX fake-quant of each 32-wide block along D
// in any format of core/mx.FORMATS (mxint4 | mxint8 | mxfp8_e4m3 |
// mxfp6_e3m2 | mxfp4_e2m1, core/mx.mx_fake_quant's rules, common.cuh
// quant_element; bf16 rounds each value to bf16, none keeps it), and the
// result cast to x's dtype.  The output goes through
// its own pointer and strides, so the caller can hand it the KV cache slice
// itself: the smoothed, quantized K/V are written in place, as the paper's
// warm step writes the cache, and never round-trip through a temporary.
//
// What bounds it: bytes, in principle.  At the warm tick's shape (B 4,
// S 96, H 32, D 128, bf16) one call reads 3.1 MB and writes 3.1 MB, about
// 1.9 us at 3.35 TB/s; the K/V were just written by the QKV projection, so
// they are read from L2.
// With one element per thread the first port spent its time on
// instructions (two IEEE divisions, a 5-shuffle warp amax, log2f and exp2f
// per element) and on 6,144 CTAs that each ended after one element.
//
// Design:
//   * A lane owns 8 consecutive channels (one 16-byte load of bf16, two of
//     f32), so a quad holds one 32-wide MX block along D and the block amax
//     is a reduction over the quad (common.cuh quad_block_scales).
//   * A CTA covers one b, a run of 512 channels and 8 sequence rows: 4 row
//     groups of 64 threads, each thread ROWS = 2 rows.  A thread loads its
//     8 channels' c and f into registers once and issues its 2 rows' loads
//     together; the 4 row groups share the calibration through L1, so L2
//     serves c and f once per 8 rows, not once per element.  The main
//     shape launches (8, 12, 4) = 384 CTAs of 256 threads, about 3 per SM.
//     On the H100 this ran faster than 1024 channels x 4 rows per thread
//     (one thread per block scale, but half the warps in flight).
//   * The 2 rows are the 2 blocks of quad_block_scales: two quad lanes
//     compute each block's scale (IEEE division, log2f, exp2f), and the
//     elementwise quotient v / scale becomes v * 2^-e, equal bit for bit
//     (a block whose exp2f is not exactly 2^e, on the H100 only e = -127,
//     keeps the division).
//   * (x - c) / f stays an IEEE division, as the plain version divides; the
//     integer and fp6/fp4 grid rounding keep quant_element's explicit
//     __fmul_rn/__fadd_rn, and mxfp8 its saturating e4m3 cast.  What holds the kernel back is
//     each thread's one chain of loads, divisions, block exponent and
//     quantization: with the division or the quantization taken out (not
//     exact), the kernel ran measurably faster on the H100.
//   * 16-byte loads and stores need x, out, c and f 16-byte aligned with
//     B/S strides to match; otherwise the same kernel runs on scalar loads
//     and stores.
#include "common.cuh"

namespace {

constexpr int CH_THREADS = 64;     // threads along H * D: 512 channels
constexpr int GROUPS = 4;          // row groups of CH_THREADS threads
constexpr int ROWS = 2;            // sequence rows per thread: the blocks
constexpr int THREADS = CH_THREADS * GROUPS;
constexpr int CHANNELS = 8 * CH_THREADS;
constexpr int CTA_ROWS = ROWS * GROUPS;

// grid (ceil(H * D / CHANNELS), ceil(S / CTA_ROWS), B): thread t of CTA
// (x, y, b) owns channels hd = 8 * (x * CH_THREADS + t % CH_THREADS) ..
// hd + 7 of the ROWS rows from (y * GROUPS + t / CH_THREADS) * ROWS.  Lanes
// past H * D and rows past S take part in the shuffles and store nothing;
// D is a multiple of 32, so a quad is live or dead as a whole.  The format
// is a template argument, so each instantiation holds its own rounding and
// no per-value branch on the format.
template <typename T, int FMT>
__global__ void __launch_bounds__(THREADS)
baos_mx_quant_kernel(const T* __restrict__ x, const float* __restrict__ c,
                     const float* __restrict__ f, T* __restrict__ out, int S,
                     int HD, long long x_sb, long long x_ss, long long o_sb,
                     long long o_ss, bool vec) {
  const int t = threadIdx.x % CH_THREADS, g = threadIdx.x / CH_THREADS;
  const int hd = 8 * (blockIdx.x * CH_THREADS + t);
  const bool live = hd < HD;
  const int b = blockIdx.z, s0 = (blockIdx.y * GROUPS + g) * ROWS;
  const size_t cal = static_cast<size_t>(b) * HD + hd;
  // lanes past H * D and rows past S form no pointer and read nothing
  // (as in stablemax_sampling.cu: a pointer past the end was read)
  float cc[8] = {}, ff[8] = {};
  if (live) {
    load8(c + cal, 8, vec, cc);
    load8(f + cal, 8, vec, ff);
  }
  float v[ROWS][8] = {};
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (live && s0 + r < S)
      load8(x + b * x_sb + (s0 + r) * x_ss + hd, 8, vec, v[r]);
  }
  float amax[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    amax[r] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[r][j] = live ? (v[r][j] - cc[j]) / ff[j] : 0.f;
      amax[r] = fmaxf(amax[r], fabsf(v[r][j]));
    }
  }
  constexpr bool MX = FMT != FMT_NONE && FMT != FMT_BF16;
  float scale[ROWS], inv[ROWS];
  if constexpr (MX) quad_block_scales(amax, FMT, scale, inv);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if constexpr (MX) {
      scale_down8(v[r], scale[r], inv[r]);
      quant8(v[r], FMT);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[r][j] = __fmul_rn(v[r][j], scale[r]);
    } else if constexpr (FMT == FMT_BF16) {
      round8<__nv_bfloat16>(v[r]);
    }
    if (live && s0 + r < S)
      store8(out + b * o_sb + (s0 + r) * o_ss + hd, v[r], vec);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int FMT>
cudaError_t launch(const void* x, const void* c, const void* f, void* out,
                   int B, int S, int H, int D, long long x_sb, long long x_ss,
                   long long o_sb, long long o_ss, cudaStream_t stream) {
  const long long step = 16 / sizeof(T);     // elements per 16 bytes
  const bool vec = aligned16(x) && aligned16(out) && aligned16(c) &&
                   aligned16(f) && x_sb % step == 0 && x_ss % step == 0 &&
                   o_sb % step == 0 && o_ss % step == 0;
  const dim3 grid((H * D + CHANNELS - 1) / CHANNELS,
                  (S + CTA_ROWS - 1) / CTA_ROWS, B);
  baos_mx_quant_kernel<T, FMT><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(c),
      static_cast<const float*>(f), static_cast<T*>(out), S, H * D, x_sb,
      x_ss, o_sb, o_ss, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* c, const void* f, void* out,
                   int B, int S, int H, int D, long long x_sb, long long x_ss,
                   long long o_sb, long long o_ss, int fmt,
                   cudaStream_t stream) {
#define BAOS_FMT(F)                                                      \
  case F:                                                                \
    return launch<T, F>(x, c, f, out, B, S, H, D, x_sb, x_ss, o_sb, o_ss, \
                        stream)
  switch (fmt) {
    BAOS_FMT(FMT_NONE);
    BAOS_FMT(FMT_BF16);
    BAOS_FMT(FMT_MXFP8);
    BAOS_FMT(FMT_MXINT8);
    BAOS_FMT(FMT_MXINT4);
    BAOS_FMT(FMT_MXFP6);
    BAOS_FMT(FMT_MXFP4);
    default:
      return cudaErrorInvalidValue;
  }
#undef BAOS_FMT
}

}  // namespace

// x (B, S, H, D) and out (B, S, H, D), both f32 (is_bf16 = 0) or both bf16,
// each with (H, D) contiguous and the given B and S strides in elements;
// c and f (B, 1, H, D) f32 contiguous; D a multiple of 32.  fmt: 0 none,
// 1 bf16, 2 mxfp8_e4m3, 3 mxint8, 4 mxint4, 5 mxfp6_e3m2, 6 mxfp4_e2m1
// (common.cuh Fmt).
extern "C" int baos_mx_quant_launch(const void* x, const void* c,
                                    const void* f, void* out, int B, int S,
                                    int H, int D, long long x_sb,
                                    long long x_ss, long long o_sb,
                                    long long o_ss, int fmt, int is_bf16,
                                    void* stream) {
  if (D % 32 || fmt < FMT_NONE || fmt > FMT_MXFP4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(B) * S * H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? launch<__nv_bfloat16>(x, c, f, out, B, S, H, D, x_sb, x_ss,
                                      o_sb, o_ss, fmt, st)
              : launch<float>(x, c, f, out, B, S, H, D, x_sb, x_ss, o_sb,
                              o_ss, fmt, st));
}

namespace {
// every instantiation the entry point above launches
const KernelAttr ATTRS[] = {
    KERNEL_ATTR((baos_mx_quant_kernel<float, FMT_NONE>), 0),
    KERNEL_ATTR((baos_mx_quant_kernel<float, FMT_BF16>), 0),
    KERNEL_ATTR((baos_mx_quant_kernel<float, FMT_MXFP8>), 0),
    KERNEL_ATTR((baos_mx_quant_kernel<float, FMT_MXINT8>), 0),
    KERNEL_ATTR((baos_mx_quant_kernel<float, FMT_MXINT4>), 0),
    KERNEL_ATTR((baos_mx_quant_kernel<float, FMT_MXFP6>), 0),
    KERNEL_ATTR((baos_mx_quant_kernel<float, FMT_MXFP4>), 0),
    KERNEL_ATTR((baos_mx_quant_kernel<__nv_bfloat16, FMT_NONE>), 0),
    KERNEL_ATTR((baos_mx_quant_kernel<__nv_bfloat16, FMT_BF16>), 0),
    KERNEL_ATTR((baos_mx_quant_kernel<__nv_bfloat16, FMT_MXFP8>), 0),
    KERNEL_ATTR((baos_mx_quant_kernel<__nv_bfloat16, FMT_MXINT8>), 0),
    KERNEL_ATTR((baos_mx_quant_kernel<__nv_bfloat16, FMT_MXINT4>), 0),
    KERNEL_ATTR((baos_mx_quant_kernel<__nv_bfloat16, FMT_MXFP6>), 0),
    KERNEL_ATTR((baos_mx_quant_kernel<__nv_bfloat16, FMT_MXFP4>), 0),
};
}  // namespace

KERNEL_ATTR_ENTRIES(baos_mx_quant, ATTRS)

extern "C" const char* baos_mx_quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

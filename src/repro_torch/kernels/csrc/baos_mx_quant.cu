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
//     B/S strides to match and D a multiple of 8; otherwise the same
//     kernel runs on scalar loads and stores.
//   * A head dim that is not a multiple of 32 (the RAGGED instantiations):
//     each head's channels are laid out as if D were rounded up to 32, the
//     tail past D a zero that no lane loads or stores, so the last MX block
//     of a head takes its amax over its real columns, as core/mx's zero
//     padding gives.
//
// The backward (baos_mx_quant_bwd_kernel and baos_mx_quant_bwd_sum below,
// entry baos_mx_quant_bwd_launch) replaces no Pallas kernel: the JAX
// package differentiates core/baos.smooth_quantize with jax.grad.
#include "common.cuh"

namespace {

constexpr int CH_THREADS = 64;     // threads along H * D: 512 channels
constexpr int GROUPS = 4;          // row groups of CH_THREADS threads
constexpr int ROWS = 2;            // sequence rows per thread: the blocks
constexpr int THREADS = CH_THREADS * GROUPS;
constexpr int CHANNELS = 8 * CH_THREADS;
constexpr int CTA_ROWS = ROWS * GROUPS;

// grid (ceil(H * Dp / CHANNELS), ceil(S / CTA_ROWS), B), Dp = D rounded up
// to 32: thread t of CTA (x, y, b) owns channels hd = 8 * (x * CH_THREADS
// + t % CH_THREADS) .. hd + 7 of the ROWS rows from (y * GROUPS + t /
// CH_THREADS) * ROWS, in rows of Dp channels a head.  Lanes past H * Dp
// and rows past S take part in the shuffles and store nothing; Dp is a
// multiple of 32, so a quad is live or dead as a whole.  RAGGED (D not a
// multiple of 32): channel hd is column d = hd % Dp of head hd / Dp, and
// the columns from D to Dp are the last MX block's zero tail, as core/mx
// pads it: zeros in the block amax, never loaded or stored.  Otherwise
// Dp = D and hd is the channel itself.  The format is a template
// argument, so each instantiation holds its own rounding and no per-value
// branch on the format.
template <typename T, int FMT, bool RAGGED = false>
__global__ void __launch_bounds__(THREADS)
baos_mx_quant_kernel(const T* __restrict__ x, const float* __restrict__ c,
                     const float* __restrict__ f, T* __restrict__ out, int S,
                     int H, int D, int Dp, long long x_sb, long long x_ss,
                     long long o_sb, long long o_ss, bool vec) {
  const int t = threadIdx.x % CH_THREADS, g = threadIdx.x / CH_THREADS;
  const int hd = 8 * (blockIdx.x * CH_THREADS + t);
  const bool live = hd < H * Dp;
  int ch = hd, n = 8;        // the first channel's offset; channels held
  if constexpr (RAGGED) {
    const int d = hd % Dp;
    ch = (hd / Dp) * D + d;
    n = max(0, min(8, D - d));
  }
  const int b = blockIdx.z, s0 = (blockIdx.y * GROUPS + g) * ROWS;
  const size_t cal = static_cast<size_t>(b) * H * D + ch;
  // lanes past H * Dp (or wholly in a zero tail) and rows past S form no
  // pointer and read nothing (as in stablemax_sampling.cu: a pointer past
  // the end was read)
  float cc[8] = {}, ff[8] = {};
  if (live && n > 0) {
    load8(c + cal, n, vec, cc);
    load8(f + cal, n, vec, ff);
  }
  float v[ROWS][8] = {};
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (live && n > 0 && s0 + r < S)
      load8(x + b * x_sb + (s0 + r) * x_ss + ch, n, vec, v[r]);
  }
  float amax[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    amax[r] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[r][j] = live && j < n ? (v[r][j] - cc[j]) / ff[j] : 0.f;
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
    if (!live || s0 + r >= S) continue;
    T* dst = out + b * o_sb + (s0 + r) * o_ss + ch;
    if (n == 8) {
      store8(dst, v[r], vec);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < n) dst[j] = from_f32<T>(v[r][j]);
    }
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
  // a head's channels start 16-byte aligned only where D is a multiple of 8
  const bool vec = aligned16(x) && aligned16(out) && aligned16(c) &&
                   aligned16(f) && x_sb % step == 0 && x_ss % step == 0 &&
                   o_sb % step == 0 && o_ss % step == 0 && D % 8 == 0;
  const int Dp = (D + 31) / 32 * 32;
  const dim3 grid((H * Dp + CHANNELS - 1) / CHANNELS,
                  (S + CTA_ROWS - 1) / CTA_ROWS, B);
  const auto* xt = static_cast<const T*>(x);
  const auto* ct = static_cast<const float*>(c);
  const auto* ft = static_cast<const float*>(f);
  auto* ot = static_cast<T*>(out);
  if (Dp == D)
    baos_mx_quant_kernel<T, FMT><<<grid, THREADS, 0, stream>>>(
        xt, ct, ft, ot, S, H, D, Dp, x_sb, x_ss, o_sb, o_ss, vec);
  else
    baos_mx_quant_kernel<T, FMT, true><<<grid, THREADS, 0, stream>>>(
        xt, ct, ft, ot, S, H, D, Dp, x_sb, x_ss, o_sb, o_ss, vec);
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

// The backward (baos_mx_quant_bwd): jax.grad of core/baos.smooth_quantize,
// per format.  From the output gradient g (x's dtype, contiguous), the MX
// fake-quant's cotangent g' of x_s = (x - c) / f: 0 for the integer
// formats, fp6 and fp4 (their round and grid lookup have no derivative);
// for mxfp8 e4m3(g * scale) / scale, the cotangent cast to e4m3 as the VJP
// of JAX's float8 cast casts it (without saturation: NaN past 464),
// halved at |x_s / scale| = 448 (jnp.clip's tie) and 0 beyond; bf16(g)
// for bf16, g for none.  Then dx = g' / f (x's dtype) and each CTA's
// partial sums over its CTA_ROWS rows of dc = -g' / f and df =
// -g' (x - c) / f^2 (the 4 row groups summed in order 0..3), into
// part (2, B, ceil(S / CTA_ROWS), H, D) f32; baos_mx_quant_bwd_sum adds
// the chunks in order.  The thread layout and the block scales are the
// forward's (quad_block_scales over a quad's two rows), so scale is the
// forward's, bit for bit.  The zero formats load nothing and store zeros.
template <typename T, int FMT, bool RAGGED = false>
__global__ void __launch_bounds__(THREADS)
baos_mx_quant_bwd_kernel(const T* __restrict__ x, const float* __restrict__ c,
                         const float* __restrict__ f,
                         const T* __restrict__ g, T* __restrict__ dx,
                         float* __restrict__ part, int S, int H, int D,
                         int Dp, long long x_sb, long long x_ss, bool vec) {
  __shared__ float red[2][GROUPS][CH_THREADS][8];
  const int t = threadIdx.x % CH_THREADS, grp = threadIdx.x / CH_THREADS;
  const int hd = 8 * (blockIdx.x * CH_THREADS + t);
  const bool live = hd < H * Dp;
  int ch = hd, n = 8;
  if constexpr (RAGGED) {
    const int d = hd % Dp;
    ch = (hd / Dp) * D + d;
    n = max(0, min(8, D - d));
  }
  const int b = blockIdx.z, s0 = (blockIdx.y * GROUPS + grp) * ROWS;
  const size_t cal = static_cast<size_t>(b) * H * D + ch;
  constexpr bool ZERO = FMT == FMT_MXINT8 || FMT == FMT_MXINT4 ||
                        FMT == FMT_MXFP6 || FMT == FMT_MXFP4;
  float sc[8] = {}, sf[8] = {};
  float dv[ROWS][8] = {};
  if constexpr (!ZERO) {
    float cc[8] = {}, ff[8] = {};
    if (live && n > 0) {
      load8(c + cal, n, vec, cc);
      load8(f + cal, n, vec, ff);
    }
    float v[ROWS][8] = {}, gg[ROWS][8] = {}, a[ROWS][8];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (live && n > 0 && s0 + r < S) {
        load8(x + b * x_sb + (s0 + r) * x_ss + ch, n, vec, v[r]);
        load8(g + (static_cast<size_t>(b) * S + s0 + r) * H * D + ch, n,
              vec, gg[r]);
      }
    }
    float amax[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      amax[r] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        a[r][j] = v[r][j] - cc[j];
        v[r][j] = live && j < n ? a[r][j] / ff[j] : 0.f;
        amax[r] = fmaxf(amax[r], fabsf(v[r][j]));
      }
    }
    if constexpr (FMT == FMT_MXFP8) {
      float scale[ROWS], inv[ROWS];
      quad_block_scales(amax, FMT, scale, inv);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        scale_down8(v[r], scale[r], inv[r]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float w = fabsf(v[r][j]) < 448.f    ? 1.f
                          : fabsf(v[r][j]) == 448.f ? 0.5f
                                                    : 0.f;
          const __nv_fp8_storage_t q8 = __nv_cvt_float_to_fp8(
              gg[r][j] * scale[r], __NV_NOSAT, __NV_E4M3);
          const float c8 =
              __half2float(__half(__nv_cvt_fp8_to_halfraw(q8, __NV_E4M3)));
          gg[r][j] = c8 * w / scale[r];
        }
      }
    } else if constexpr (FMT == FMT_BF16) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) round8<__nv_bfloat16>(gg[r]);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (!live || s0 + r >= S) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= n) continue;
        const float tj = gg[r][j] / ff[j];
        dv[r][j] = tj;
        sc[j] -= tj;
        sf[j] -= gg[r][j] * a[r][j] / (ff[j] * ff[j]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (!live || s0 + r >= S) continue;
    T* dst = dx + (static_cast<size_t>(b) * S + s0 + r) * H * D + ch;
    if (n == 8) {
      store8(dst, dv[r], vec);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < n) dst[j] = from_f32<T>(dv[r][j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    red[0][grp][t][j] = sc[j];
    red[1][grp][t][j] = sf[j];
  }
  __syncthreads();
  if (grp != 0 || !live) return;
  const int n_y = gridDim.y;
  const size_t HD = static_cast<size_t>(H) * D;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j >= n) continue;
    float a0 = red[0][0][t][j], a1 = red[1][0][t][j];
#pragma unroll
    for (int u = 1; u < GROUPS; ++u) {
      a0 += red[0][u][t][j];
      a1 += red[1][u][t][j];
    }
    const size_t o = (static_cast<size_t>(b) * n_y + blockIdx.y) * HD + ch + j;
    part[o] = a0;
    part[static_cast<size_t>(gridDim.z) * n_y * HD + o] = a1;
  }
}

// dc and df (B, 1, H, D) f32 from the partials, the chunks in order.
__global__ void __launch_bounds__(256)
baos_mx_quant_bwd_sum(const float* __restrict__ part, float* __restrict__ dc,
                      float* __restrict__ df, int B, int n_y, long long HD) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= B * HD) return;
  const long long b = i / HD, hd = i % HD;
  const long long half = static_cast<long long>(B) * n_y * HD;
  float a0 = 0.f, a1 = 0.f;
  for (int y = 0; y < n_y; ++y) {
    const long long o = (b * n_y + y) * HD + hd;
    a0 += part[o];
    a1 += part[half + o];
  }
  dc[i] = a0;
  df[i] = a1;
}

template <typename T, int FMT>
cudaError_t launch_bwd(const void* x, const void* c, const void* f,
                       const void* g, void* dx, void* dc, void* df,
                       void* part, int B, int S, int H, int D, long long x_sb,
                       long long x_ss, cudaStream_t stream) {
  const long long step = 16 / sizeof(T);
  const bool vec = aligned16(x) && aligned16(c) && aligned16(f) &&
                   aligned16(g) && aligned16(dx) && x_sb % step == 0 &&
                   x_ss % step == 0 && D % 8 == 0;
  const int Dp = (D + 31) / 32 * 32;
  const dim3 grid((H * Dp + CHANNELS - 1) / CHANNELS,
                  (S + CTA_ROWS - 1) / CTA_ROWS, B);
  const auto* xt = static_cast<const T*>(x);
  const auto* ct = static_cast<const float*>(c);
  const auto* ft = static_cast<const float*>(f);
  const auto* gt = static_cast<const T*>(g);
  auto* dxt = static_cast<T*>(dx);
  auto* pt = static_cast<float*>(part);
  if (Dp == D)
    baos_mx_quant_bwd_kernel<T, FMT><<<grid, THREADS, 0, stream>>>(
        xt, ct, ft, gt, dxt, pt, S, H, D, Dp, x_sb, x_ss, vec);
  else
    baos_mx_quant_bwd_kernel<T, FMT, true><<<grid, THREADS, 0, stream>>>(
        xt, ct, ft, gt, dxt, pt, S, H, D, Dp, x_sb, x_ss, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long HD = static_cast<long long>(H) * D;
  baos_mx_quant_bwd_sum<<<static_cast<unsigned>((B * HD + 255) / 256), 256,
                          0, stream>>>(pt, static_cast<float*>(dc),
                                       static_cast<float*>(df), B,
                                       static_cast<int>(grid.y), HD);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* c, const void* f,
                       const void* g, void* dx, void* dc, void* df,
                       void* part, int B, int S, int H, int D, long long x_sb,
                       long long x_ss, int fmt, cudaStream_t stream) {
#define BAOS_BWD_FMT(F)                                                      \
  case F:                                                                    \
    return launch_bwd<T, F>(x, c, f, g, dx, dc, df, part, B, S, H, D, x_sb,  \
                            x_ss, stream)
  switch (fmt) {
    BAOS_BWD_FMT(FMT_NONE);
    BAOS_BWD_FMT(FMT_BF16);
    BAOS_BWD_FMT(FMT_MXFP8);
    BAOS_BWD_FMT(FMT_MXINT8);
    BAOS_BWD_FMT(FMT_MXINT4);
    BAOS_BWD_FMT(FMT_MXFP6);
    BAOS_BWD_FMT(FMT_MXFP4);
    default:
      return cudaErrorInvalidValue;
  }
#undef BAOS_BWD_FMT
}

}  // namespace

// The backward: x (B, S, H, D) with (H, D) contiguous and the given B and S
// strides (the forward's input), c and f (B, 1, H, D) f32, g and dx
// (B, S, H, D) contiguous of x's dtype, dc and df (B, 1, H, D) f32, part an
// f32 scratch of 2 * B * ceil(S / 8) * H * D floats; fmt as below.
extern "C" int baos_mx_quant_bwd_launch(const void* x, const void* c,
                                        const void* f, const void* g,
                                        void* dx, void* dc, void* df,
                                        void* part, int B, int S, int H,
                                        int D, long long x_sb, long long x_ss,
                                        int fmt, int is_bf16, void* stream) {
  if (D < 1 || fmt < FMT_NONE || fmt > FMT_MXFP4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(B) * H * D == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? launch_bwd<__nv_bfloat16>(x, c, f, g, dx, dc, df, part, B, S,
                                          H, D, x_sb, x_ss, fmt, st)
              : launch_bwd<float>(x, c, f, g, dx, dc, df, part, B, S, H, D,
                                  x_sb, x_ss, fmt, st));
}

// x (B, S, H, D) and out (B, S, H, D), both f32 (is_bf16 = 0) or both bf16,
// each with (H, D) contiguous and the given B and S strides in elements;
// c and f (B, 1, H, D) f32 contiguous; any D >= 1 (the last MX block of a
// D that is not a multiple of 32 is partial: its amax over its columns).
// fmt: 0 none,
// 1 bf16, 2 mxfp8_e4m3, 3 mxint8, 4 mxint4, 5 mxfp6_e3m2, 6 mxfp4_e2m1
// (common.cuh Fmt).
extern "C" int baos_mx_quant_launch(const void* x, const void* c,
                                    const void* f, void* out, int B, int S,
                                    int H, int D, long long x_sb,
                                    long long x_ss, long long o_sb,
                                    long long o_ss, int fmt, int is_bf16,
                                    void* stream) {
  if (D < 1 || fmt < FMT_NONE || fmt > FMT_MXFP4)
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
    KERNEL_ATTR((baos_mx_quant_kernel<float, FMT_NONE, true>), 0),
    KERNEL_ATTR((baos_mx_quant_kernel<float, FMT_BF16, true>), 0),
    KERNEL_ATTR((baos_mx_quant_kernel<float, FMT_MXFP8, true>), 0),
    KERNEL_ATTR((baos_mx_quant_kernel<float, FMT_MXINT8, true>), 0),
    KERNEL_ATTR((baos_mx_quant_kernel<float, FMT_MXINT4, true>), 0),
    KERNEL_ATTR((baos_mx_quant_kernel<float, FMT_MXFP6, true>), 0),
    KERNEL_ATTR((baos_mx_quant_kernel<float, FMT_MXFP4, true>), 0),
    KERNEL_ATTR((baos_mx_quant_kernel<__nv_bfloat16, FMT_NONE, true>), 0),
    KERNEL_ATTR((baos_mx_quant_kernel<__nv_bfloat16, FMT_BF16, true>), 0),
    KERNEL_ATTR((baos_mx_quant_kernel<__nv_bfloat16, FMT_MXFP8, true>), 0),
    KERNEL_ATTR((baos_mx_quant_kernel<__nv_bfloat16, FMT_MXINT8, true>), 0),
    KERNEL_ATTR((baos_mx_quant_kernel<__nv_bfloat16, FMT_MXINT4, true>), 0),
    KERNEL_ATTR((baos_mx_quant_kernel<__nv_bfloat16, FMT_MXFP6, true>), 0),
    KERNEL_ATTR((baos_mx_quant_kernel<__nv_bfloat16, FMT_MXFP4, true>), 0),
    KERNEL_ATTR((baos_mx_quant_bwd_kernel<float, FMT_NONE>), 0),
    KERNEL_ATTR((baos_mx_quant_bwd_kernel<float, FMT_BF16>), 0),
    KERNEL_ATTR((baos_mx_quant_bwd_kernel<float, FMT_MXFP8>), 0),
    KERNEL_ATTR((baos_mx_quant_bwd_kernel<float, FMT_MXINT8>), 0),
    KERNEL_ATTR((baos_mx_quant_bwd_kernel<float, FMT_MXINT4>), 0),
    KERNEL_ATTR((baos_mx_quant_bwd_kernel<float, FMT_MXFP6>), 0),
    KERNEL_ATTR((baos_mx_quant_bwd_kernel<float, FMT_MXFP4>), 0),
    KERNEL_ATTR((baos_mx_quant_bwd_kernel<float, FMT_NONE, true>), 0),
    KERNEL_ATTR((baos_mx_quant_bwd_kernel<float, FMT_BF16, true>), 0),
    KERNEL_ATTR((baos_mx_quant_bwd_kernel<float, FMT_MXFP8, true>), 0),
    KERNEL_ATTR((baos_mx_quant_bwd_kernel<float, FMT_MXINT8, true>), 0),
    KERNEL_ATTR((baos_mx_quant_bwd_kernel<float, FMT_MXINT4, true>), 0),
    KERNEL_ATTR((baos_mx_quant_bwd_kernel<float, FMT_MXFP6, true>), 0),
    KERNEL_ATTR((baos_mx_quant_bwd_kernel<float, FMT_MXFP4, true>), 0),
    KERNEL_ATTR((baos_mx_quant_bwd_kernel<__nv_bfloat16, FMT_NONE>), 0),
    KERNEL_ATTR((baos_mx_quant_bwd_kernel<__nv_bfloat16, FMT_BF16>), 0),
    KERNEL_ATTR((baos_mx_quant_bwd_kernel<__nv_bfloat16, FMT_MXFP8>), 0),
    KERNEL_ATTR((baos_mx_quant_bwd_kernel<__nv_bfloat16, FMT_MXINT8>), 0),
    KERNEL_ATTR((baos_mx_quant_bwd_kernel<__nv_bfloat16, FMT_MXINT4>), 0),
    KERNEL_ATTR((baos_mx_quant_bwd_kernel<__nv_bfloat16, FMT_MXFP6>), 0),
    KERNEL_ATTR((baos_mx_quant_bwd_kernel<__nv_bfloat16, FMT_MXFP4>), 0),
    KERNEL_ATTR((baos_mx_quant_bwd_kernel<__nv_bfloat16, FMT_NONE, true>), 0),
    KERNEL_ATTR((baos_mx_quant_bwd_kernel<__nv_bfloat16, FMT_BF16, true>), 0),
    KERNEL_ATTR((baos_mx_quant_bwd_kernel<__nv_bfloat16, FMT_MXFP8, true>), 0),
    KERNEL_ATTR((baos_mx_quant_bwd_kernel<__nv_bfloat16, FMT_MXINT8, true>), 0),
    KERNEL_ATTR((baos_mx_quant_bwd_kernel<__nv_bfloat16, FMT_MXINT4, true>), 0),
    KERNEL_ATTR((baos_mx_quant_bwd_kernel<__nv_bfloat16, FMT_MXFP6, true>), 0),
    KERNEL_ATTR((baos_mx_quant_bwd_kernel<__nv_bfloat16, FMT_MXFP4, true>), 0),
    KERNEL_ATTR(baos_mx_quant_bwd_sum, 0),
};
}  // namespace

KERNEL_ATTR_ENTRIES(baos_mx_quant, ATTRS)

extern "C" const char* baos_mx_quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

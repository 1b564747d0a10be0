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
// 0.31 ms at 3.35 TB/s, and 66 GFLOP: 64 FLOP per byte of w_head, far
// below the 295 at which the tensor cores would bound it.  So the bf16
// route is built to keep w_head streaming:
//   * The product runs on the tensor cores (mma.sync m16n8k16, bf16 in,
//     f32 accumulate: the Pallas kernel's own jnp.dot arithmetic), A from
//     ldmatrix, B from ldmatrix.trans since w_head is N-major.
//   * One CTA per SM owns a contiguous range of whole 32-column MX blocks
//     (kernels/fused_head_sampling.column_plan, computed by the wrapper),
//     walks it in 256-column tiles, and keeps one of its two shared-memory
//     stages (128-deep slices of w_head and hidden, 85 KB each) in flight
//     with cp.async while the tensor cores work on the other: 85 KB in
//     flight per SM, over three times what Little's law asks at 3.35 TB/s.
//     On the H100 fewer, deeper stages ran faster than more, shallower
//     ones (fewer barriers per byte).
//     The (tile, depth) loop is one sequence, so the next tile's loads run
//     under this tile's epilogue.
//   * The epilogue works on the accumulators in registers.  A warp owns
//     32 rows x 64 columns; for one row a 32-column MX block lies in one
//     quad (8 values per lane), so two xor shuffles give the block amax.
//     Every format of core/mx (common.cuh Fmt) quantizes there, the
//     format a template argument of the kernel (one instantiation per MX
//     format, and one for none and bf16, which leave bf16 logits as they
//     are): a per-value branch on a runtime format slowed mxfp8 itself.
//     Per logit: f32 -> activation dtype -> x logit_scale -> fake-quant ->
//     mask pad columns and the suppressed id, then an online fold into the
//     lane's running (m, s, idx[, best, z_at]) per row, in increasing
//     column order.
//   * Quads, then the four column warps, merge with the combine rule; the
//     CTA writes one partial per row, (R, n_cta) in all, and a second
//     small kernel merges them (common.cuh combine_row): ties go to the
//     lowest column, and for Gumbel only a strictly greater score replaces
//     the best so far.
//   * More than 64 rows add a grid dimension: w_head is read once per
//     group of 64 rows.
//   * A vocabulary that is not a multiple of 8 (minicpm-2b: V 122753): a
//     row of w_head would not start on a 16-byte address, so the head is
//     stored once, at load, with its rows padded to ldw, a multiple of 8
//     (kernels/fused_head_sampling.pad_head), as the Pallas kernel pads V
//     to its chunk.  The kernel takes the logical V and ldw; columns >= V
//     enter the MX block amax as zeros and every reduction as -inf, so
//     neither the pad's content nor a ragged last block changes a logit.
// The f32 route runs on the CUDA cores (f32 FMAs, 64-column CTAs): TF32
// would change its arithmetic.
//
// Route A (fused_head_sampling_shard_launch) serves the SPMD tick's and
// the decode step's vocab-sharded head: the same per-CTA partials over one
// rank's (d, V/n) shard of a head padded to MX-block shard boundaries,
// then a merge that writes per-row (m, global idx, s), and when it samples
// (best, z_at), for the cross-rank combine.  The Gumbel noise is drawn at
// the global row and column, so a sampled step on any mesh draws what one
// device draws.  It moves V/n of
// the head's bytes, so its bound is the single-device bound over n.
// No fast-math: the MX exponent rule ceil(log2(amax / 448)) and the Gumbel
// log must use the full-precision library functions.
#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32 route: the product with f32 FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int TN = 64;        // vocab columns per CTA: two MX blocks
constexpr int TK = 32;        // depth of one shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, each 4 columns x RPT rows

template <typename T, int RPT>
__global__ void __launch_bounds__(THREADS)
head_partials_kernel(const T* __restrict__ hidden, const T* __restrict__ w,
                     int R, int d, int V, int ldw, int fmt,
                     float logit_scale,
                     float temperature, const uint32_t* __restrict__ seed_ptr,
                     int suppress_id, int row_offset, int noise_col,
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
                      ? to_f32(w[static_cast<size_t>(gk) * ldw + gc])
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
  // the seed lives in device memory: a captured graph reads each tick's
  const uint32_t seed = gumbel ? *seed_ptr : 0u;
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
      // the noise of the global row and column
      const uint32_t nr = gr + row_offset;
      const float sc0 = z[0] / temperature +
                        counter_gumbel(seed, nr, col[0] + noise_col);
      const float sc1 = z[1] / temperature +
                        counter_gumbel(seed, nr, col[1] + noise_col);
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

template <int RPT>
cudaError_t launch_f32(const float* hidden, const float* w, int R, int d,
                       int V, int ldw, int fmt, float logit_scale,
                       float temperature,
                       const uint32_t* seed, int suppress_id, int row_offset,
                       int noise_col, float* pm, int* pi,
                       float* ps, float* pb, float* pz, cudaStream_t stream) {
  constexpr int TM = 16 * RPT;
  const dim3 grid((V + TN - 1) / TN, (R + TM - 1) / TM);
  head_partials_kernel<float, RPT><<<grid, THREADS, 0, stream>>>(
      hidden, w, R, d, V, ldw, fmt, logit_scale, temperature, seed,
      suppress_id, row_offset, noise_col, pm, pi, ps, pb, pz);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(int R, const float* hidden, const float* w, int d,
                         int V, int ldw, int fmt, float logit_scale,
                         float temperature,
                         const uint32_t* seed, int suppress_id,
                         int row_offset, int noise_col, float* pm, int* pi,
                         float* ps, float* pb, float* pz, cudaStream_t stream) {
#define FHS_LAUNCH(RPT)                                                    \
  return launch_f32<RPT>(hidden, w, R, d, V, ldw, fmt, logit_scale,        \
                         temperature, seed, suppress_id, row_offset,       \
                         noise_col, pm, pi, ps, pb, pz, stream)
  if (R <= 16) FHS_LAUNCH(1);
  if (R <= 32) FHS_LAUNCH(2);
  if (R <= 64) FHS_LAUNCH(4);
  FHS_LAUNCH(8);
#undef FHS_LAUNCH
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores fed by a cp.async ring
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int TC_ROWS = 64;      // hidden rows per CTA (one row group)
constexpr int TC_BN = 256;       // vocab columns per tile
constexpr int TC_BK = 128;       // depth of one stage
constexpr int TC_STAGES = 2;
constexpr int TC_THREADS = 256;  // 8 warps: 2 (rows) x 4 (columns)
// shared rows padded by 16 bytes: ldmatrix's eight row addresses then fall
// in eight different bank groups
constexpr int TC_WP = TC_BN + 8;
constexpr int TC_HP = TC_BK + 8;
constexpr int TC_W_STAGE = TC_BK * TC_WP;    // elements
constexpr int TC_H_STAGE = TC_ROWS * TC_HP;
constexpr int TC_SMEM = TC_STAGES * (TC_W_STAGE + TC_H_STAGE) * 2;  // bytes

// One row's running Stable-Max partial: max logit m, exp-sum s relative to
// m, index i (argmax of the logit, or with Gumbel of the score), best
// Gumbel score b and the logit z at i.
struct Part {
  float m, s, b, z;
  int i;
};

__device__ __forceinline__ Part empty_part() { return {NEG, 0.f, -INFINITY, NEG, BIG}; }

// a <- merge(a, o): combine_partials' rule (common.cuh combine_row).
__device__ __forceinline__ void merge_part(Part& a, const Part& o,
                                           bool gumbel) {
  const float m = fmaxf(a.m, o.m);
  a.s = a.s * expf(a.m - m) + o.s * expf(o.m - m);
  if (gumbel) {
    if (o.b > a.b || (o.b == a.b && o.i < a.i)) {
      a.b = o.b;
      a.i = o.i;
      a.z = o.z;
    }
  } else if (o.m > a.m || (o.m == a.m && o.i < a.i)) {
    a.i = o.i;
  }
  a.m = m;
}

__device__ __forceinline__ Part shfl_xor_part(const Part& p, int mask) {
  return {__shfl_xor_sync(FULL_MASK, p.m, mask),
          __shfl_xor_sync(FULL_MASK, p.s, mask),
          __shfl_xor_sync(FULL_MASK, p.b, mask),
          __shfl_xor_sync(FULL_MASK, p.z, mask),
          __shfl_xor_sync(FULL_MASK, p.i, mask)};
}

// Fold one lane's 8 values of one row's MX block (columns col0 + 8j + e for
// value 2j + e, increasing) into the row's partial p.  Pad columns hold
// -inf and never count.  The Gumbel noise is drawn at global row
// noise_row and global column col + noise_col.
__device__ __forceinline__ void fold_group(Part& p, const float (&z)[8],
                                           int col0, uint32_t noise_row,
                                           int noise_col, bool gumbel,
                                           float temperature, uint32_t seed) {
  float lm = z[0];
  int lq = 0;
#pragma unroll
  for (int q = 1; q < 8; ++q)
    if (z[q] > lm) {               // strict: the first occurrence stays
      lm = z[q];
      lq = q;
    }
  const float mn = fmaxf(p.m, lm);
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < 8; ++q) s += expf(z[q] - mn);
  p.s = p.s * expf(p.m - mn) + s;
  if (gumbel) {
    float lb = -INFINITY, lz = NEG;
    int lbq = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int col = col0 + (q >> 1) * 8 + (q & 1);
      const float sc = z[q] / temperature +
                       counter_gumbel(seed, noise_row, col + noise_col);
      if (sc > lb) {
        lb = sc;
        lbq = q;
        lz = z[q];
      }
    }
    if (lb > p.b) {
      p.b = lb;
      p.i = col0 + (lbq >> 1) * 8 + (lbq & 1);
      p.z = lz;
    }
  } else if (lm > p.m) {
    p.i = col0 + (lq >> 1) * 8 + (lq & 1);
  }
  p.m = mn;
}

// The MX fake-quant of one lane's 8 logits of a block whose largest
// magnitude, over its quad, is amax: core/mx's rule (the IEEE quotient by
// the block's power-of-two scale, the element grid of FMT, times the
// scale) rounded to bf16, as the plain version returns the logits' dtype.
// FMT is a constant, so each format's element rule is inlined.
template <int FMT>
__device__ __forceinline__ void quant_block8(float (&z)[8], float amax) {
  const float scale = mx_block_scale(amax, FMT);
#pragma unroll
  for (int q = 0; q < 8; ++q)
    z[q] = round_to<bf16>(__fmul_rn(quant_element(z[q] / scale, FMT), scale));
}

// Fold one finished 64 x 256 tile: this warp's 32 x 64 accumulators, whose
// columns start at wcol (global), rows at wrow.
template <int FMT>
__device__ __forceinline__ void fold_tile(const float (&acc)[2][8][4],
                                          Part (&part)[2][2], int wrow,
                                          int wcol, int R, int c_end,
                                          float scale_t, bool gumbel,
                                          float temperature, uint32_t seed,
                                          int suppress_id, int row_offset,
                                          int noise_col, int g, int c) {
#pragma unroll
  for (int blk = 0; blk < 2; ++blk) {
    const int b0 = wcol + 32 * blk;           // first column of the block
    if (b0 >= c_end) break;                   // warp-uniform
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (wrow + 16 * i >= R) break;          // warp-uniform
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col0 = b0 + 2 * c;
        float z[8];
        float amax = 0.f;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          // f32 accumulator -> activation dtype -> x logit_scale; a column
          // past the range is a zero logit for the block amax (past c_end
          // within a block only at c_end == V: ranges hold whole blocks)
          float v = round_to<bf16>(acc[i][4 * blk + (q >> 1)][2 * h + (q & 1)]);
          v = round_to<bf16>(v * scale_t);
          if (col0 + (q >> 1) * 8 + (q & 1) >= c_end) v = 0.f;
          z[q] = v;
          amax = fmaxf(amax, fabsf(v));
        }
        if constexpr (FMT >= FMT_MXFP8) {
          amax = fmaxf(amax, __shfl_xor_sync(FULL_MASK, amax, 1));
          amax = fmaxf(amax, __shfl_xor_sync(FULL_MASK, amax, 2));
          quant_block8<FMT>(z, amax);
        }                 // FMT_BF16 is exact on bf16 logits; FMT_NONE too
        const int row = wrow + 16 * i + g + 8 * h;
        if (row >= R) continue;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int col = col0 + (q >> 1) * 8 + (q & 1);
          if (col >= c_end) z[q] = -INFINITY;
          else if (col == suppress_id) z[q] = NEG;
        }
        fold_group(part[i][h], z, col0, row + row_offset, noise_col, gumbel,
                   temperature, seed);
      }
    }
  }
}

template <int FMT>
__global__ void __launch_bounds__(TC_THREADS, 1)
head_partials_tc_kernel(const bf16* __restrict__ hidden,
                        const bf16* __restrict__ w, int R, int d, int V,
                        int ldw, int cols_per_cta, float logit_scale,
                        float temperature,
                        const uint32_t* __restrict__ seed_ptr, int suppress_id,
                        int row_offset, int noise_col,
                        float* __restrict__ part_m, int* __restrict__ part_i,
                        float* __restrict__ part_s,
                        float* __restrict__ part_b,
                        float* __restrict__ part_z) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Part merged[4][TC_ROWS];        // per column warp, per row
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);        // [STAGES][BK][WP]
  bf16* hs = ws + TC_STAGES * TC_W_STAGE;              // [STAGES][ROWS][HP]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, c = lane & 3;
  const int c_begin = blockIdx.x * cols_per_cta;
  const int c_end = min(c_begin + cols_per_cta, V);
  const int r0 = blockIdx.y * TC_ROWS;
  const int n_k = (d + TC_BK - 1) / TC_BK;
  const int n_it = (c_end - c_begin + TC_BN - 1) / TC_BN * n_k;
  const bool gumbel = temperature > 0.f;
  const uint32_t seed = gumbel ? *seed_ptr : 0u;  // from device memory
  // logit_scale joins the product in the activation dtype, as a weakly
  // typed Python float does in the JAX reference
  const float scale_t = round_to<bf16>(logit_scale);

  // stage `it`: the (tile it / n_k, depth slice it % n_k) of w_head and the
  // matching hidden slice; 16-byte chunks past d, past the CTA's columns or
  // past R are zero-filled without a read (d and ldw are multiples of 8; a
  // chunk that starts before V and ends past it reads the row's pad)
  auto load_stage = [&](int it) {
    const int st = it % TC_STAGES, k0 = (it % n_k) * TC_BK;
    const int n0 = c_begin + (it / n_k) * TC_BN;
    bf16* wd = ws + st * TC_W_STAGE;
#pragma unroll
    for (int e = tid; e < TC_BK * (TC_BN / 8); e += TC_THREADS) {
      const int kk = e / (TC_BN / 8), cc = (e % (TC_BN / 8)) * 8;
      const int gk = k0 + kk, gc = n0 + cc;
      const bool ok = gk < d && gc < c_end;
      cp_async_16(smem_addr(wd + kk * TC_WP + cc),
                  ok ? w + static_cast<size_t>(gk) * ldw + gc : w, ok);
    }
    bf16* hd = hs + st * TC_H_STAGE;
#pragma unroll
    for (int e = tid; e < TC_ROWS * (TC_BK / 8); e += TC_THREADS) {
      const int r = e / (TC_BK / 8), kc = (e % (TC_BK / 8)) * 8;
      const int gr = r0 + r, gk = k0 + kc;
      const bool ok = gr < R && gk < d;
      cp_async_16(smem_addr(hd + r * TC_HP + kc),
                  ok ? hidden + static_cast<size_t>(gr) * d + gk : hidden, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < n_it) load_stage(s);
    cp_async_commit();
  }

  Part part[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) part[i][h] = empty_part();
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<TC_STAGES - 2>();      // stage `it` has landed
    __syncthreads();                     // ... for every thread, and stage
    //                                      it - 1 is no longer being read
    if (it + TC_STAGES - 1 < n_it) load_stage(it + TC_STAGES - 1);
    cp_async_commit();

    const bf16* wt = ws + (it % TC_STAGES) * TC_W_STAGE;
    const bf16* ht = hs + (it % TC_STAGES) * TC_H_STAGE;
#pragma unroll
    for (int ks = 0; ks < TC_BK / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(a[i], smem_addr(ht + (wm * 32 + i * 16 + (lane & 15)) * TC_HP
                                    + ks * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bm[4];
        ldmatrix_x4_trans(bm, smem_addr(wt + (ks * 16 + (lane & 15)) * TC_WP
                                        + wn * 64 + jp * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * jp], a[i], bm[0], bm[1]);
          mma_bf16(acc[i][2 * jp + 1], a[i], bm[2], bm[3]);
        }
      }
    }

    if (it % n_k == n_k - 1) {           // the tile's product is complete
      fold_tile<FMT>(acc, part, r0 + wm * 32,
                     c_begin + (it / n_k) * TC_BN + wn * 64, R, c_end,
                     scale_t, gumbel, temperature, seed, suppress_id,
                     row_offset, noise_col, g, c);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }

  // a row's partial lives in the 4 lanes of a quad in each of 4 warps
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      merge_part(part[i][h], shfl_xor_part(part[i][h], 1), gumbel);
      merge_part(part[i][h], shfl_xor_part(part[i][h], 2), gumbel);
      if (c == 0) merged[wn][wm * 32 + i * 16 + g + 8 * h] = part[i][h];
    }
  __syncthreads();
  if (tid < TC_ROWS && r0 + tid < R) {
    Part p = merged[0][tid];
#pragma unroll
    for (int j = 1; j < 4; ++j) merge_part(p, merged[j][tid], gumbel);
    const size_t o = static_cast<size_t>(r0 + tid) * gridDim.x + blockIdx.x;
    part_m[o] = p.m;
    part_i[o] = p.i;
    part_s[o] = p.s;
    if (gumbel) {
      part_b[o] = p.b;
      part_z[o] = p.z;
    }
  }
}

template <int FMT>
cudaError_t launch_tc(const bf16* hidden, const bf16* w, int R, int d, int V,
                      int ldw, int cols_per_cta, int n_parts,
                      float logit_scale, float temperature,
                      const uint32_t* seed, int suppress_id, int row_offset,
                      int noise_col, float* pm, int* pi, float* ps,
                      float* pb, float* pz, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      head_partials_tc_kernel<FMT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(n_parts, (R + TC_ROWS - 1) / TC_ROWS);
  head_partials_tc_kernel<FMT><<<grid, TC_THREADS, TC_SMEM, stream>>>(
      hidden, w, R, d, V, ldw, cols_per_cta, logit_scale, temperature, seed,
      suppress_id, row_offset, noise_col, pm, pi, ps, pb, pz);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const bf16* hidden, const bf16* w, int R, int d,
                        int V, int ldw, int cols_per_cta, int n_parts,
                        int fmt,
                        float logit_scale, float temperature,
                        const uint32_t* seed, int suppress_id,
                        int row_offset, int noise_col, float* pm, int* pi,
                        float* ps, float* pb, float* pz,
                        cudaStream_t stream) {
  if (d % 8 || ldw % 8 || ldw < V || cols_per_cta <= 0 ||
      cols_per_cta % 32 ||
      static_cast<long long>(cols_per_cta) * n_parts < V ||
      static_cast<long long>(cols_per_cta) * (n_parts - 1) >= V)
    return cudaErrorInvalidValue;
#define FHS_TC(F)                                                           \
  return launch_tc<F>(hidden, w, R, d, V, ldw, cols_per_cta, n_parts,       \
                      logit_scale, temperature, seed, suppress_id,          \
                      row_offset, noise_col, pm, pi, ps, pb, pz, stream)
  switch (fmt) {
    case FMT_MXFP8: FHS_TC(FMT_MXFP8);
    case FMT_MXINT8: FHS_TC(FMT_MXINT8);
    case FMT_MXINT4: FHS_TC(FMT_MXINT4);
    case FMT_MXFP6: FHS_TC(FMT_MXFP6);
    case FMT_MXFP4: FHS_TC(FMT_MXFP4);
    default: FHS_TC(FMT_NONE);     // none and bf16: bf16 logits stay as is
  }
#undef FHS_TC
}

// Route A, the vocab-shard entry: one warp per row merges the row's n_vt
// per-CTA partials and writes the partials themselves, (m, global idx, s)
// and with Gumbel (best, z_at), in place of (conf, token) (common.cuh
// shard_merge_row): the SPMD tick and the decode step merge them across
// ranks (core/sampling.combine_partials).
__global__ void head_shard_merge_kernel(
    const float* __restrict__ part_m, const int* __restrict__ part_i,
    const float* __restrict__ part_s, const float* __restrict__ part_b,
    const float* __restrict__ part_z, int R, int n_vt, int col_offset,
    int gumbel, float* __restrict__ m_out, int* __restrict__ idx_out,
    float* __restrict__ s_out, float* __restrict__ b_out,
    float* __restrict__ z_out) {
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= R) return;
  shard_merge_row(part_m, part_i, part_s, part_b, part_z, r, n_vt,
                  col_offset, gumbel != 0, m_out, idx_out, s_out, b_out,
                  z_out);
}

}  // namespace

// Number of 64-column vocab tiles of the f32 route: its partials
// workspace is (R, tiles).
extern "C" int fused_head_sampling_tiles(int V) { return (V + TN - 1) / TN; }

// hidden (R, d) and w (d, V) with rows ldw >= V elements apart, both f32
// (is_bf16 = 0) or both bf16; the
// partials workspace part_* is (R, n_parts) each (part_b/part_z only read
// and written when temperature > 0); conf (R,) f32, token (R,) i32.
// The bf16 route takes the column plan: cols_per_cta columns (whole MX
// blocks) for each of n_parts CTAs, covering V; it needs d and ldw to be
// multiples of 8 (16-byte rows).  The f32 route ignores cols_per_cta and
// takes n_parts = fused_head_sampling_tiles(V).
// fmt: a code of common.cuh Fmt (core/mx.FMT_CODES), 0 none to 6
// mxfp4_e2m1.  suppress_id < 0 suppresses nothing.
// seed_ptr: the uint32 counter-Gumbel seed in device memory (the low word
// of an int64 holding it), read only when temperature > 0; row_offset:
// the global row of row 0, at which the noise is drawn (a data shard's
// first row).
extern "C" int fused_head_sampling_launch(
    const void* hidden, const void* w, void* part_m, void* part_i,
    void* part_s, void* part_b, void* part_z, void* conf, void* token, int R,
    int d, int V, int ldw, int is_bf16, int fmt, float logit_scale,
    float temperature, const void* seed_ptr, int suppress_id, int row_offset,
    int cols_per_cta, int n_parts, void* stream) {
  if (fmt < FMT_NONE || fmt > FMT_MXFP4) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* seed = static_cast<const uint32_t*>(seed_ptr);
  float* pm = static_cast<float*>(part_m);
  int* pi = static_cast<int*>(part_i);
  float* ps = static_cast<float*>(part_s);
  float* pb = static_cast<float*>(part_b);
  float* pz = static_cast<float*>(part_z);
  cudaError_t err;
  if (is_bf16) {
    err = launch_bf16(static_cast<const bf16*>(hidden),
                      static_cast<const bf16*>(w), R, d, V, ldw, cols_per_cta,
                      n_parts, fmt, logit_scale, temperature, seed,
                      suppress_id, row_offset, 0, pm, pi, ps, pb, pz, st);
  } else {
    if (n_parts != (V + TN - 1) / TN || ldw < V) return cudaErrorInvalidValue;
    err = dispatch_f32(R, static_cast<const float*>(hidden),
                       static_cast<const float*>(w), d, V, ldw, fmt,
                       logit_scale, temperature, seed, suppress_id,
                       row_offset, 0, pm, pi, ps, pb, pz, st);
  }
  if (err != cudaSuccess) return err;
  head_combine_kernel<<<(R + 3) / 4, 128, 0, st>>>(
      pm, pi, ps, pb, pz, R, n_parts, temperature > 0.f,
      static_cast<float*>(conf), static_cast<int*>(token));
  return cudaGetLastError();
}

// Route A: the partials of one vocab shard.  w (d, V) is the shard's
// first V columns that lie below the true vocabulary (the rest of its
// ldw >= V columns are the zero pad of pad_head_for_mesh, whose logits are
// the zeros a ragged block is padded with), at global column col_offset;
// suppress_id is a column of the shard (< 0: none).  The per-CTA partials
// are the single-device entry's (cols_per_cta and n_parts as there);
// m_out, s_out (R,) f32 and idx_out (R,) i32 receive the merged (m, global
// idx, s).  With temperature > 0 the index is that of the best Gumbel
// score, the noise drawn at the global row (row_offset onward) and column
// (seed_ptr as fused_head_sampling_launch's), and b_out, z_out (R,) f32
// receive the best score and the logit at the index (part_b, part_z,
// b_out and z_out are only touched then).  V = 0 (a shard of pad only)
// launches the merge alone.
extern "C" int fused_head_sampling_shard_launch(
    const void* hidden, const void* w, void* part_m, void* part_i,
    void* part_s, void* part_b, void* part_z, void* m_out, void* idx_out,
    void* s_out, void* b_out, void* z_out, int R, int d, int V, int ldw,
    int is_bf16, int fmt, float logit_scale, float temperature,
    const void* seed_ptr, int suppress_id, int col_offset, int row_offset,
    int cols_per_cta, int n_parts, void* stream) {
  if (fmt < FMT_NONE || fmt > FMT_MXFP4 || V < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* seed = static_cast<const uint32_t*>(seed_ptr);
  float* pm = static_cast<float*>(part_m);
  int* pi = static_cast<int*>(part_i);
  float* ps = static_cast<float*>(part_s);
  float* pb = static_cast<float*>(part_b);
  float* pz = static_cast<float*>(part_z);
  int n_vt = 0;
  if (V > 0) {
    cudaError_t err;
    if (is_bf16) {
      err = launch_bf16(static_cast<const bf16*>(hidden),
                        static_cast<const bf16*>(w), R, d, V, ldw,
                        cols_per_cta, n_parts, fmt, logit_scale, temperature,
                        seed, suppress_id, row_offset, col_offset, pm, pi,
                        ps, pb, pz, st);
    } else {
      if (n_parts != (V + TN - 1) / TN || ldw < V) return cudaErrorInvalidValue;
      err = dispatch_f32(R, static_cast<const float*>(hidden),
                         static_cast<const float*>(w), d, V, ldw, fmt,
                         logit_scale, temperature, seed, suppress_id,
                         row_offset, col_offset, pm, pi, ps, pb, pz, st);
    }
    if (err != cudaSuccess) return err;
    n_vt = n_parts;
  }
  head_shard_merge_kernel<<<(R + 3) / 4, 128, 0, st>>>(
      pm, pi, ps, pb, pz, R, n_vt, col_offset, temperature > 0.f,
      static_cast<float*>(m_out), static_cast<int*>(idx_out),
      static_cast<float*>(s_out), static_cast<float*>(b_out),
      static_cast<float*>(z_out));
  return cudaGetLastError();
}

namespace {
// every instantiation the entry points above launch
const KernelAttr ATTRS[] = {
    KERNEL_ATTR((head_partials_kernel<float, 1>), 0),
    KERNEL_ATTR((head_partials_kernel<float, 2>), 0),
    KERNEL_ATTR((head_partials_kernel<float, 4>), 0),
    KERNEL_ATTR((head_partials_kernel<float, 8>), 0),
    KERNEL_ATTR((head_partials_tc_kernel<FMT_NONE>), TC_SMEM),
    KERNEL_ATTR((head_partials_tc_kernel<FMT_MXFP8>), TC_SMEM),
    KERNEL_ATTR((head_partials_tc_kernel<FMT_MXINT8>), TC_SMEM),
    KERNEL_ATTR((head_partials_tc_kernel<FMT_MXINT4>), TC_SMEM),
    KERNEL_ATTR((head_partials_tc_kernel<FMT_MXFP6>), TC_SMEM),
    KERNEL_ATTR((head_partials_tc_kernel<FMT_MXFP4>), TC_SMEM),
    KERNEL_ATTR(head_combine_kernel, 0),
    KERNEL_ATTR(head_shard_merge_kernel, 0),
};
}  // namespace

KERNEL_ATTR_ENTRIES(fused_head_sampling, ATTRS)

extern "C" const char* fused_head_sampling_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

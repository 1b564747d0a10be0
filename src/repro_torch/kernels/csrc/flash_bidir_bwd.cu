// Backward of bidirectional GQA attention for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package trains through jax.grad of the
// jnp attention in src/repro/models/layers.py (XLA differentiates it; there
// is no Pallas backward and no custom_vjp).  The port's forward runs the
// hand-written csrc/flash_bidir.cu, so its gradient is a kernel too:
// kernels/flash_bidir.py wraps both in a torch.autograd.Function.
//
// What it computes, for q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D) and the
// output gradient dO (B, Sq, Hq, D), KV head = q head // G, G = Hq / Hkv,
// and the forward's masks (kv_valid (B, Skv), |q_offset + r - j| <
// window, and with causal != 0 j <= q_offset + r, the JAX model's causal
// mode):
//   s_ij  = D^-1/2 q_i . k_j, -1e30 where masked (a constant: no gradient)
//   p_ij  = exp(s_ij - m_i) / max(l_i, 1e-30)   (m_i, l_i recomputed)
//   dp_ij = dO_i . v_j
//   delta_i = sum_j p_ij dp_ij   (= dO_i . o_i, with o_i in f32)
//   ds_ij = p_ij (dp_ij - delta_i), 0 where masked
//   dq_i = D^-1/2 sum_j ds_ij k_j
//   dk_j = D^-1/2 sum_(i, heads of the group) ds_ij q_i
//   dv_j = sum_(i, heads of the group) p_ij dO_i
// A row with no valid key has p = 1 / Skv on every key (the forward
// averages V there): it adds to dv, and its dq and its share of dk are 0.
// Keys past Skv (the ragged last tile) have p = 0.  delta is not taken as
// dO . o from the forward's output: o is rounded to the activation dtype,
// and in bf16 that rounding, against dp_ij - delta_i (a small difference
// where attention is near uniform), cost qwen2-0.5b's query and key
// projections a gradient cosine of 0.93-0.98 to an f32 reference where
// plain attention under autograd kept 0.99-0.997.
//
// bf16 route, on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate; ldmatrix from bf16 tiles that arrive through cp.async
// rings of 3 stages, 2 for kernel 1 at D 256).  Rows are packed as in the
// forward: row r of a KV head's group is q head hk * G + r % G at
// position r / G, so every K/V tile staged in shared memory serves all G
// q heads of its rows.
//   1. flash_bidir_bwd_dq_tc: one CTA per (16 x warps packed rows, KV
//      head, batch row), 16 rows a warp.  Pass 0 forms S = Q K^T and
//      dP = dO V^T tile by tile (64 keys; 32 under a mask and at D 256)
//      and keeps each row's max, sum and sum of e_ij dp_ij online (the
//      forward's softmax); it writes
//      (m, 1/l, delta) of every row to an f32 scratch.  Pass 1 forms S and
//      dP again, dS from the final statistics, and dq += dS K.
//   2. flash_bidir_bwd_dkv_tc: one CTA per (64-key tile, KV head, batch
//      row, row split), a warp per 16 keys (two at D 256: one sums dV, the
//      other dK, so each keeps 128 f32 accumulators a thread and nothing
//      spills).  It walks its split's rows in chunks of 32 and forms
//      S^T = K Q^T and dP^T = V dO^T with the keys as the mma's rows, so
//      P^T and dS^T, from the scratch's statistics, are the A fragments of
//      dV += P^T dO and dK += dS^T Q without leaving registers.
//   3. flash_bidir_bwd_split_sum (only with n_split > 1).
// S and dP are formed three times per (row, key, q head): pass 0, pass 1
// and kernel 2 (S four times at D 256, where both warps of a key need P).
// The statistics are never recomputed: the scratch carries them from
// kernel 1 to kernel 2.
//
// The row split: a grouped query gives kernel 2 few CTAs (Skv / 64 x Hkv
// x B: 16 at D 256's (4, 256, 10 on 1), 32 at qwen2-0.5b's (8, 128, 14 on
// 2)).  The launcher (kernels/flash_bidir.bwd_plan) cuts the G x Sq rows
// of a group into n_split contiguous blocks of split_rows (a multiple of
// 32, at least 128 rows, at most two waves of CTAs), the cut whose
// busiest SM finishes first by its model of an SM's rate; it also picks
// kernel 1's warps.  With n_split > 1 each CTA writes its f32 partial
// sums to a scratch of (2, n_split, B, Skv, Hkv, D), and kernel 3 adds
// the splits in the fixed order 0, 1, ..., n_split - 1 and rounds once.
// No atomics anywhere: every output element is summed in a fixed order,
// so two launches give the same bits.  With n_split == 1 kernel 2 writes
// dk and dv itself.  The wrapper allocates both scratches; the kernels
// allocate nothing.
//
// Rounding: q, k, v and dO are exact bf16 operands, and S, dP, the row
// statistics and every sum are f32.  P and dS enter their products as
// one bf16 rounding each (2^-9 relative), where the forward splits P into
// three bf16 terms: a gradient is held to the plain bf16 version's error
// (one ulp more, at most 2x), and a test-only emulation of this
// arithmetic at the smoke shapes (tests/test_torch_attn_bwd_plan.py)
// stays within 0.3-0.7 of that budget with one rounding (the card:
// 0.52-0.71).  Each output is rounded once.
//
// Masks: each bf16 kernel has a MASKED instantiation, which the launcher
// takes where kv_valid, a window or the causal mask is given; the others
// test only whether a key lies past Skv, and walk 64-key tiles in kernel
// 1 (together 15-25% less time than the masked kernels at llada-8b's and
// qwen2-0.5b's training shapes and at (2, 1024), PERF.md).
//
// Key tiles out of reach: under a window or the causal mask, kernel 1
// walks only the key tiles its rows reach and kernel 2 only the row
// chunks that reach its keys (the forward's tile_range rule).  A row with
// no valid key in its reach has no valid key at all; kernel 1 gives it
// l = Skv (p = 1 / Skv on every key), and a kernel-2 CTA that finds such
// a row of its split outside its walk walks every chunk of the split.
//
// What bounds it: the card could finish the function on its bytes.  At
// llada-8b's training shape (B 8, S 128, 32 heads, D 128) it reads and
// writes 58.7 MB (0.0175 ms) and needs 4.3 GFLOP (S, dP, dV, dK, dQ less
// one: 0.0043 ms at 989 TFLOP/s); this kernel does 9 of those products
// (S and dP three times), 9.7 GFLOP, 0.0098 ms at the peak rate that
// mma.sync does not reach.  At (2, 1024, 32 on 32, 128) the products
// bound it: 68.7 GFLOP needed, 154.6 done (0.156 ms at the peak).
// PERF.md has the times.
//
// f32 route, on the CUDA cores (TF32 would change its arithmetic): two
// kernels, each value converted once on its way into shared memory.
//   1. flash_bidir_bwd_dq: one CTA per (16-row q tile, q head, batch
//      row), 4 warps of 4 rows, lane j scoring key j of a 32-key tile
//      ([32][DT + 1] floats: lane-strided reads hit 32 banks); pass 1
//      recomputes (m, l, delta), pass 2 sums ds_ij k_j into dq; (m, l,
//      delta) go to the scratch (3, B, Hq, Sq) for kernel 2.
//   2. flash_bidir_bwd_dkv: one CTA per (32-key tile, KV head, batch row),
//      8 warps, walking every row of the group in chunks of 16 (key =
//      lane, DT / 8 columns a warp).
//
// Head dims: any D.  Tiles DT = 32, 64, 128 and 256 columns (a D up to
// 256 runs in the smallest that holds it, columns past D loaded as zeros
// and not stored); bf16 at a D that is not a multiple of 8 takes the f32
// route's kernels on bf16 operands (one value a load: such rows are not
// 16 bytes apart).  D past 256 takes the wide route, on the CUDA cores
// for either dtype: flash_bidir_bwd_stats_wide writes each row's (m, l,
// delta) once, then flash_bidir_bwd_dq_wide and flash_bidir_bwd_dkv_wide
// each split their output columns over CTAs in slices of 256 and read
// those statistics; every slice forms S and dP over the full D in chunks
// of 128 columns, in one order (wide_s_dp), so the slices of a row use the
// same bits.  No atomics: each output element is one CTA's.
//
// bf16 scores (bf16_scores != 0; jax.grad of JAX's bf16-score attention):
// kernel 0, flash_bidir_bwd_qscale, writes qg = bf16(q * scale) (scale
// rounded to q's dtype) into a scratch that every other kernel reads in
// place of q.  S = bf16(qg . bf16(k)) without a scale, masked bf16(-1e30);
// P = bf16(exp(bf16(S - bf16(m)))) unnormalized, l = sum P (kernel 1
// online, as the forward); dP = bf16(bf16(dp / l) - bf16(delta / l)) (the
// cotangent of P from o and from l, each bf16) and dS = bf16(P dP), 0
// where masked; dq = bf16(sum dS k) x D^-1/2, dk = bf16(sum dS qg) (no
// D^-1/2) and dv = bf16(sum (P / l) dO): where JAX rounds.  jax.grad also
// sends the softmax max's cotangent, -sum_j dS_ij, to the row's keys at
// the max (split over ties), which restores what dS's roundings take from
// a row's shift invariance (without it qwen2-0.5b's key-bias gradients
// fell to cosines of 0.975-0.987 to f32 on the card, where plain kept
// 0.992-0.996); so do the kernels (bf16_mcorr: an f32 sum of the row's dS
// in a pass of its own before dq's -- kernel 1's pass 1b, the wide route's
// statistics kernel -- written as a fourth statistics row that every dq
// and dk/dv kernel adds to the dS of the row's keys at the max).  The
// tensor-core route takes the MASKED instantiations with BS alone; the
// split sum then scales dk by 1.  The CUDA-core and wide kernels take a
// runtime flag.
//
// The cached forward (jax.grad of JAX's forward with a cache; BwdExtra):
//   * BAOS (out = o_s f_v + c_v, o_s attention of q f_k over the smoothed
//     K/V): kernel 0 is flash_bidir_bwd_baos_prep, which writes q f_k and
//     dO f_v in f32 -- for bf16 as two bf16 terms t0 = bf16(x), t1 =
//     bf16(x - t0) each, which the tensor-core kernels (QT = 2, MASKED
//     instantiations only) enter into every product as two products, and
//     the CUDA-core and wide kernels add as they stage -- so the
//     backward differentiates the forward's f32 fusion, not a bf16
//     rounding of it (with bf16 scores q's term is qg, one bf16 value, as
//     the forward rounds it).  The dq pass writes dqs, the gradient of
//     q f_k, in f32 (dq32); the last kernel, flash_bidir_bwd_baos_sums,
//     rounds dq = dqs f_k once and forms df_k = sum dqs q, df_v = sum dO
//     o_s and dc_v = sum dO per (batch row, KV head, column) over the
//     group's packed rows, a warp per row stripe in a fixed order and the
//     stripes in order: no atomics, the same bits every launch.  o_s, the
//     uncorrected output, is the forward kernel's (launched by the
//     wrapper with f_k alone).  dk and dv are in the smoothed space.
//   * Route B (a second source k2/v2, key j at q_offset + j): every walk
//     over keys takes the cache's tiles in reach, then the second
//     source's (Src, src_of), under one (m, l); the dk/dv grid's tiles are
//     the cache's (none with skip0: its K/V need no gradient), then the
//     second source's, each CTA's keys of one source and its sums to that
//     source's dk/dv, with split partials (part2) and split sums of its
//     own.  A row with no valid key averages every key of both sources.
//   * A device query offset: every kernel reads the int64 at off in place
//     of q_offset (offset_of), for the masks and the REACH walks alike.
//
// Shared memory at DT 256: kernel 1 at 8 warps 202.8 KB,
// kernel 2 170.1 KB (bf16); 98.6 KB and 102.8 KB (f32).  Registers from
// 120 to 252 a thread, no spill (PERF.md).
#include "common.cuh"

namespace {

constexpr int BQ = 16;       // query rows per dq CTA
constexpr int BK = 32;       // keys per tile: one per lane
constexpr int QWARPS = 4;
constexpr int RPW = BQ / QWARPS;
constexpr int KWARPS = 8;    // warps of a dk/dv CTA
constexpr int RC = 16;       // query rows per chunk of the dk/dv CTA

constexpr int dq_smem_bytes(int DT) {
  return (2 * BQ * DT + 2 * BK * (DT + 1)) * 4;
}
constexpr int dkv_smem_bytes(int DT) {
  return (2 * BK * (DT + 1) + 2 * RC * DT + 2 * RC * BK + 5 * RC) * 4;
}

__device__ __forceinline__ bool key_ok(const unsigned char* kv_valid, int b,
                                       int Skv, int gk) {
  return gk < Skv &&
         (kv_valid == nullptr || kv_valid[static_cast<size_t>(b) * Skv + gk]);
}

// Whether key position kp is in reach of query position qp (the forward's
// in_reach).
__device__ __forceinline__ bool in_reach(int qp, int kp, int window,
                                         int causal) {
  return (!causal || kp <= qp) && (window <= 0 || abs(qp - kp) < window);
}

// Stage keys [k0, k0 + BK) of KV head hk of `src` as f32 rows of dst
// ([BK][DT + 1]); keys past Skv and columns past D are zeros; bs: each
// value rounded to bf16 (bf16 scores read bf16(k) and bf16(v)).
template <typename T, int DT>
__device__ __forceinline__ void stage_keys(float (*dst)[DT + 1],
                                           const T* __restrict__ src, int b,
                                           int k0, int hk, int Skv, int Hkv,
                                           int D, int tid, int nthreads,
                                           int bs) {
  for (int e = tid; e < BK * DT; e += nthreads) {
    const int j = e / DT, dd = e % DT, gk = k0 + j;
    float x = 0.f;
    if (gk < Skv && dd < D)
      x = to_f32(src[((static_cast<size_t>(b) * Skv + gk) * Hkv + hk) * D + dd]);
    dst[j][dd] = bs ? bf16r(x) : x;
  }
}

// What a launch of the cached forward's backward adds to the cache-less
// one, passed by value to every kernel; a null pointer (or S2 = 0) turns
// its part off.
template <typename T>
struct Ext {
  const T* k2;                  // route B: (B, S2, Hkv, D), key j at
  const T* v2;                  //   position q_offset + j
  const unsigned char* valid2;  // (B, S2) bool or null
  int S2;                       // 0: no second source
  T* dk2;                       // its gradients (null: not wanted, no pass)
  T* dv2;
  float* part2;                 // its split partials (n_split > 1)
  int skip0;                    // the cache's dk/dv not wanted: no pass
  const T* q_lo;                // BAOS: second bf16 terms of q * f_k and
  const T* dout_lo;             //   dO * f_v (null: none)
  float* dq32;                  // BAOS: dq of q * f_k in f32 (null: dq in T)
  const long long* off;         // the query offset in device memory, or null
};

// The query offset: the int64 at `off` when given (a graph's block start),
// else the host's int.
__device__ __forceinline__ int offset_of(int q_offset, const long long* off) {
  return off != nullptr ? static_cast<int>(*off) : q_offset;
}

// One key source of a walk or of a dk/dv CTA: the cache (source 0, key j
// at position j) or route B's second source (key j at q_offset + j).
template <typename T>
struct Src {
  const T* k;
  const T* v;
  const unsigned char* valid;
  int n;       // keys
  int pos0;    // the position of key 0
};

template <typename T>
__device__ __forceinline__ Src<T> src_of(int s, const T* k, const T* v,
                                         const unsigned char* kv_valid,
                                         int Skv, const Ext<T>& ex,
                                         int q_offset) {
  return s == 0 ? Src<T>{k, v, kv_valid, Skv, 0}
                : Src<T>{ex.k2, ex.v2, ex.valid2, ex.S2, q_offset};
}

// A q or dO element as f32: its first term, plus its second where BAOS
// splits q * f_k or dO * f_v into two bf16 terms.
template <typename T>
__device__ __forceinline__ float two_terms(const T* hi, const T* lo,
                                           size_t i) {
  return lo != nullptr ? to_f32(hi[i]) + to_f32(lo[i]) : to_f32(hi[i]);
}

// BAOS, kernel 0 of its launch: q * f_k and dO * f_v in f32 (f_k, f_v of
// the row's KV head), written as one term in q's dtype (f32), or as two
// bf16 terms t0 = bf16(x), t1 = bf16(x - t0), which carry the f32 value
// to 2^-17 of it, as the forward's SPLIT terms carry q * f_k.  With bf16
// scores q's term is qg = bf16(q * f_k * scale) (scale rounded to q's
// dtype), one term, as the forward rounds it.  n values of q's size, 4 a
// thread; the kernels after it read these in place of q and dO.
template <typename T>
__global__ void __launch_bounds__(256)
flash_bidir_bwd_baos_prep(const T* __restrict__ q, const T* __restrict__ dout,
                          const float* __restrict__ fk,
                          const float* __restrict__ fv, T* __restrict__ q_hi,
                          T* __restrict__ q_lo, T* __restrict__ d_hi,
                          T* __restrict__ d_lo, long long n, int Sq, int Hq,
                          int Hkv, int D, float scale, int bs) {
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  const int G = Hq / Hkv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long e = i0 + i;
    if (e >= n) break;
    const long long row = e / D;                 // (b * Sq + pos) * Hq + h
    const int dd = static_cast<int>(e % D);
    const int hk = static_cast<int>(row % Hq) / G;
    const long long b = row / Hq / Sq;
    const size_t cal = (static_cast<size_t>(b) * Hkv + hk) * D + dd;
    float xq = to_f32(q[e]), xd = to_f32(dout[e]);
    if (fk != nullptr) xq *= fk[cal];
    if (fv != nullptr) xd *= fv[cal];
    if (bs) xq = bf16r(xq * scale);
    q_hi[e] = from_f32<T>(xq);
    d_hi[e] = from_f32<T>(xd);
    if (q_lo != nullptr) q_lo[e] = from_f32<T>(xq - to_f32(q_hi[e]));
    if (d_lo != nullptr) d_lo[e] = from_f32<T>(xd - to_f32(d_hi[e]));
  }
}

// BAOS, the last kernel of its launch: per (batch row, KV head, 32
// columns), a warp per row stripe walking the group's G x Sq packed rows
// (row r: position r / G, q head hk * G + r % G) in a fixed order, then
// the 8 stripes summed in order 0..7 (no atomics: the same bits every
// launch): dq = dq32 * f_k rounded once to q's dtype; df_k = sum dq32 * q
// (dq32 is the gradient of q * f_k), df_v = sum dO * o_s (o_s the
// uncorrected output) and dc_v = sum dO, each (B, Hkv, D) f32 where its
// pointer is given.
constexpr int SUM_WARPS = 8;

template <typename T>
__global__ void __launch_bounds__(32 * SUM_WARPS)
flash_bidir_bwd_baos_sums(const T* __restrict__ q, const T* __restrict__ dout,
                          const T* __restrict__ o_s,
                          const float* __restrict__ dq32,
                          const float* __restrict__ fk, T* __restrict__ dq,
                          float* __restrict__ dfk, float* __restrict__ dfv,
                          float* __restrict__ dcv, int Sq, int Hq, int Hkv,
                          int D) {
  __shared__ float part[3][SUM_WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int dd = blockIdx.x * 32 + lane, hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv, n_rows = G * Sq;
  const bool col = dd < D;
  const size_t cal = (static_cast<size_t>(b) * Hkv + hk) * D + dd;
  const float f = col && fk != nullptr ? fk[cal] : 1.f;
  float sk = 0.f, sv = 0.f, sc = 0.f;
  for (int r = warp; col && r < n_rows; r += SUM_WARPS) {
    const size_t i =
        ((static_cast<size_t>(b) * Sq + r / G) * Hq + hk * G + r % G) * D + dd;
    const float g = dq32[i];
    dq[i] = from_f32<T>(g * f);
    if (dfk != nullptr) sk = fmaf(g, to_f32(q[i]), sk);
    const float od = to_f32(dout[i]);
    if (dfv != nullptr) sv = fmaf(od, to_f32(o_s[i]), sv);
    sc += od;
  }
  part[0][warp][lane] = sk;
  part[1][warp][lane] = sv;
  part[2][warp][lane] = sc;
  __syncthreads();
  if (warp != 0 || !col) return;
#pragma unroll
  for (int w = 1; w < SUM_WARPS; ++w) {
    sk += part[0][w][lane];
    sv += part[1][w][lane];
    sc += part[2][w][lane];
  }
  if (dfk != nullptr) dfk[cal] = sk;
  if (dfv != nullptr) dfv[cal] = sv;
  if (dcv != nullptr) dcv[cal] = sc;
}

// bf16 scores' query operand: qg = bf16(q * scale) (scale rounded to q's
// dtype by the caller), stored in q's dtype, which the kernels below read
// in place of q (kernel 0 of a bf16-score launch; n values, 4 a thread).
template <typename T>
__global__ void __launch_bounds__(256)
flash_bidir_bwd_qscale(const T* __restrict__ q, T* __restrict__ qg,
                       long long n, float scale) {
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i0 + i < n) qg[i0 + i] = from_f32<T>(bf16r(to_f32(q[i0 + i]) * scale));
}

// bf16 scores (JAX's jax.grad of its bf16-score attention): the
// unnormalized probability P = bf16(exp(bf16(S - bf16(m)))) of a bf16
// score S, and dS = bf16(P * bf16(bf16(dp / l) - bf16(delta / l))): the
// cotangent of P is bf16 (its two parts, from o and from l, each rounded),
// and dS is their bf16 product.
__device__ __forceinline__ float bf16_p(float s, float m) {
  return bf16r(expf(bf16r(s - bf16r(m))));
}
__device__ __forceinline__ float bf16_dp(float dp, float inv_l,
                                         float delta) {
  return bf16r(bf16r(dp * inv_l) - bf16r(delta * inv_l));
}
__device__ __forceinline__ float bf16_ds(float s, float m, float dp,
                                         float inv_l, float delta) {
  return bf16r(bf16_p(bf16r(s), m) * bf16_dp(dp, inv_l, delta));
}
// The softmax max's cotangent (jax.grad sends -sum_j dS_ij through m to
// the row's keys at the max, split evenly over ties): from a row's f32 sum
// of dS and its count of valid keys at the max, the bf16 term each such
// key's dS takes on (0 for a row whose max is a mask's).
__device__ __forceinline__ float bf16_mcorr(float eps, float ties) {
  return ties > 0.f ? bf16r(bf16r(-eps) / ties) : 0.f;
}
// dS of a valid key (bf16_ds) with that term added where S is the row max.
__device__ __forceinline__ float bf16_ds_m(float s, float m, float dp,
                                           float inv_l, float delta,
                                           float mc) {
  const float ds = bf16_ds(s, m, dp, inv_l, delta);
  return bf16r(s) == m ? bf16r(ds + mc) : ds;
}
// dq from its f32 sum: x D^-1/2; with bf16 scores bf16(sum) x D^-1/2 (JAX's
// dq of qg comes out of a bf16 product).
__device__ __forceinline__ float dq_of(float acc, float scale, int bs) {
  return (bs ? bf16r(acc) : acc) * scale;
}

template <typename T, int DPL>
__global__ void __launch_bounds__(32 * QWARPS)
flash_bidir_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const unsigned char* __restrict__ kv_valid,
                   T* __restrict__ dq, float* __restrict__ stats, int B,
                   int Sq, int Skv, int Hq, int Hkv, int D, float scale,
                   int window, int q_offset, int causal, int bs, Ext<T> ex) {
  constexpr int DT = 32 * DPL;
  extern __shared__ __align__(16) float smem_dq[];
  float(*qs)[DT] = reinterpret_cast<float(*)[DT]>(smem_dq);
  float(*dos)[DT] = reinterpret_cast<float(*)[DT]>(smem_dq + BQ * DT);
  float(*ks)[DT + 1] = reinterpret_cast<float(*)[DT + 1]>(smem_dq + 2 * BQ * DT);
  float(*vs)[DT + 1] =
      reinterpret_cast<float(*)[DT + 1]>(smem_dq + 2 * BQ * DT + BK * (DT + 1));

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nthreads = 32 * QWARPS;
  q_offset = offset_of(q_offset, ex.off);
  // the key tiles: the cache's, then the second source's
  const int n0t = (Skv + BK - 1) / BK, n_t = n0t + (ex.S2 + BK - 1) / BK;

  for (int e = tid; e < BQ * DT; e += nthreads) {
    const int r = e / DT, dd = e % DT, gq = q0 + r;
    float x = 0.f, g = 0.f;
    if (gq < Sq && dd < D) {
      const size_t idx = ((static_cast<size_t>(b) * Sq + gq) * Hq + h) * D + dd;
      x = two_terms(q, ex.q_lo, idx);
      g = two_terms(dout, ex.dout_lo, idx);
    }
    qs[r][dd] = x;
    dos[r][dd] = g;
  }

  // key tile t: its source and its first key
  auto tile = [&](int t, int& k0) {
    const int si = t >= n0t;
    k0 = (si ? t - n0t : t) * BK;
    return src_of<T>(si, k, v, kv_valid, Skv, ex, q_offset);
  };
  // s_i = q_i . k_lane and dp_i = dO_i . v_lane for the key tile at k0 of
  // source sr, staged after a barrier (the previous tile read, the q rows
  // written)
  auto tile_sdp = [&](const Src<T>& sr, int k0, float (&s)[RPW],
                      float (&dp)[RPW]) {
    __syncthreads();
    stage_keys<T, DT>(ks, sr.k, b, k0, hk, sr.n, Hkv, D, tid, nthreads, bs);
    stage_keys<T, DT>(vs, sr.v, b, k0, hk, sr.n, Hkv, D, tid, nthreads, bs);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < DT; ++dd) {
      const float kx = ks[lane][dd], vx = vs[lane][dd];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        s[i] = fmaf(qs[warp * RPW + i][dd], kx, s[i]);
        dp[i] = fmaf(dos[warp * RPW + i][dd], vx, dp[i]);
      }
    }
  };

  // pass 1: each row's max, sum and sum of e_ij dp_ij over every key tile
  // (online, as the forward's softmax)
  float m[RPW], l[RPW], pdp[RPW];
  int qpos[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = NEG;
    l[i] = pdp[i] = 0.f;
    qpos[i] = q_offset + q0 + warp * RPW + i;
  }
  for (int ti = 0; ti < n_t; ++ti) {
    int k0;
    const Src<T> sr = tile(ti, k0);
    float s[RPW], dp[RPW];
    tile_sdp(sr, k0, s, dp);
    const int gk = k0 + lane;
    const bool in_range = gk < sr.n;
    const bool valid = key_ok(sr.valid, b, sr.n, gk);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const bool ok =
          valid && in_reach(qpos[i], sr.pos0 + gk, window, causal);
      const float x = in_range ? (ok ? (bs ? bf16r(s[i]) : s[i] * scale)
                                     : (bs ? NEG_BF16 : NEG))
                               : -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(x));
      const float corr = expf(m[i] - m_new);
      const float e = bs ? bf16r(expf(bf16r(x - bf16r(m_new))))
                         : expf(x - m_new);
      l[i] = l[i] * corr + warp_sum(e);
      pdp[i] = pdp[i] * corr + warp_sum(in_range ? e * dp[i] : 0.f);
      m[i] = m_new;
    }
  }

  float inv_l[RPW], delta[RPW], mc[RPW], eps[RPW], ties[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    inv_l[i] = 1.f / fmaxf(l[i], 1e-30f);
    delta[i] = pdp[i] * inv_l[i];
    mc[i] = eps[i] = ties[i] = 0.f;
  }
  // bf16 scores, pass 1b: each row's sum of dS and its keys at the max
  // (bf16_mcorr)
  for (int ti = 0; bs && ti < n_t; ++ti) {
    int k0;
    const Src<T> sr = tile(ti, k0);
    float s[RPW], dp[RPW];
    tile_sdp(sr, k0, s, dp);
    const int gk = k0 + lane;
    const bool ok_k = gk < sr.n && key_ok(sr.valid, b, sr.n, gk);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const bool ok =
          ok_k && in_reach(qpos[i], sr.pos0 + gk, window, causal);
      eps[i] += warp_sum(ok ? bf16_ds(s[i], m[i], dp[i], inv_l[i], delta[i])
                            : 0.f);
      ties[i] += warp_sum(ok && bf16r(s[i]) == m[i] ? 1.f : 0.f);
    }
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    mc[i] = bf16_mcorr(eps[i], ties[i]);
    const int gq = q0 + warp * RPW + i;
    if (lane == 0 && gq < Sq) {
      const size_t si = (static_cast<size_t>(b) * Hq + h) * Sq + gq;
      const size_t n = static_cast<size_t>(B) * Hq * Sq;
      stats[si] = m[i];
      stats[n + si] = l[i];
      stats[2 * n + si] = delta[i];
      if (bs) stats[3 * n + si] = mc[i];
    }
  }

  // pass 2: ds and dq
  float acc[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[i][t] = 0.f;

  for (int ti = 0; ti < n_t; ++ti) {
    int k0;
    const Src<T> sr = tile(ti, k0);
    float s[RPW], dp[RPW];
    tile_sdp(sr, k0, s, dp);
    const int gk = k0 + lane;
    const bool in_range = gk < sr.n;
    const bool valid = key_ok(sr.valid, b, sr.n, gk);
    float ds[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const bool ok = in_range && valid &&
                      in_reach(qpos[i], sr.pos0 + gk, window, causal);
      ds[i] = !ok ? 0.f
              : bs ? bf16_ds_m(s[i], m[i], dp[i], inv_l[i], delta[i], mc[i])
                   : expf(s[i] * scale - m[i]) * inv_l[i] * (dp[i] - delta[i]);
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsk[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) dsk[i] = __shfl_sync(FULL_MASK, ds[i], kk);
#pragma unroll
      for (int t = 0; t < DPL; ++t) {
        const float kx = ks[kk][lane + 32 * t];
#pragma unroll
        for (int i = 0; i < RPW; ++i) acc[i][t] = fmaf(dsk[i], kx, acc[i][t]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int gq = q0 + warp * RPW + i;
    if (gq >= Sq) continue;
    const size_t row = ((static_cast<size_t>(b) * Sq + gq) * Hq + h) * D;
#pragma unroll
    for (int t = 0; t < DPL; ++t) {
      const int dd = lane + 32 * t;
      if (dd >= D) continue;
      const float g = dq_of(acc[i][t], scale, bs);
      if (ex.dq32 != nullptr)
        ex.dq32[row + dd] = g;
      else
        dq[row + dd] = from_f32<T>(g);
    }
  }
}

template <typename T, int DPL>
__global__ void __launch_bounds__(32 * KWARPS)
flash_bidir_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const unsigned char* __restrict__ kv_valid,
                    const float* __restrict__ stats, T* __restrict__ dk,
                    T* __restrict__ dv, int B, int Sq, int Skv, int Hq,
                    int Hkv, int D, float scale, int window, int q_offset,
                    int causal, int bs, Ext<T> ex) {
  constexpr int DT = 32 * DPL;
  constexpr int NC = DT / KWARPS;    // contiguous columns a thread owns
  extern __shared__ __align__(16) float smem_dkv[];
  float(*ks)[DT + 1] = reinterpret_cast<float(*)[DT + 1]>(smem_dkv);
  float(*vs)[DT + 1] = reinterpret_cast<float(*)[DT + 1]>(smem_dkv + BK * (DT + 1));
  float* rest = smem_dkv + 2 * BK * (DT + 1);
  float(*qs)[DT] = reinterpret_cast<float(*)[DT]>(rest);
  float(*dos)[DT] = reinterpret_cast<float(*)[DT]>(rest + RC * DT);
  float(*ps)[BK] = reinterpret_cast<float(*)[BK]>(rest + 2 * RC * DT);
  float(*dss)[BK] = reinterpret_cast<float(*)[BK]>(rest + 2 * RC * DT + RC * BK);
  float* row_m = rest + 2 * RC * DT + 2 * RC * BK;
  float* row_il = row_m + RC;
  float* row_delta = row_il + RC;
  float* row_mc = row_delta + RC;   // bf16 scores: bf16_mcorr's term
  int* row_pos = reinterpret_cast<int*>(row_mc + RC);

  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv, n_rows = G * Sq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nthreads = 32 * KWARPS;
  const size_t n_stats = static_cast<size_t>(B) * Hq * Sq;
  q_offset = offset_of(q_offset, ex.off);
  // the CTA's key tile: the cache's tiles first (none with skip0), then
  // the second source's
  const int n0t = ex.skip0 ? 0 : (Skv + BK - 1) / BK;
  const int si = static_cast<int>(blockIdx.x) >= n0t;
  const int k0 = (si ? blockIdx.x - n0t : blockIdx.x) * BK;
  const Src<T> sr = src_of<T>(si, k, v, kv_valid, Skv, ex, q_offset);
  T* dk_o = si ? ex.dk2 : dk;
  T* dv_o = si ? ex.dv2 : dv;

  stage_keys<T, DT>(ks, sr.k, b, k0, hk, sr.n, Hkv, D, tid, nthreads, bs);
  stage_keys<T, DT>(vs, sr.v, b, k0, hk, sr.n, Hkv, D, tid, nthreads, bs);
  const int gk = k0 + lane;
  const bool in_range = gk < sr.n;
  const bool valid = key_ok(sr.valid, b, sr.n, gk);

  float adk[NC], adv[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) adk[c] = adv[c] = 0.f;

  // rows t = g * Sq + pos of the group: q head hk * G + g at position pos
  for (int t0 = 0; t0 < n_rows; t0 += RC) {
    __syncthreads();   // the previous chunk read (and the K/V tile written)
    for (int e = tid; e < RC * DT; e += nthreads) {
      const int r = e / DT, dd = e % DT, t = t0 + r;
      float x = 0.f, g = 0.f;
      if (t < n_rows && dd < D) {
        const int hh = hk * G + t / Sq, pos = t % Sq;
        const size_t idx = ((static_cast<size_t>(b) * Sq + pos) * Hq + hh) * D + dd;
        x = two_terms(q, ex.q_lo, idx);
        g = two_terms(dout, ex.dout_lo, idx);
      }
      qs[r][dd] = x;
      dos[r][dd] = g;
    }
    if (tid < RC) {
      const int t = t0 + tid;
      if (t < n_rows) {
        const int hh = hk * G + t / Sq, pos = t % Sq;
        const size_t si = (static_cast<size_t>(b) * Hq + hh) * Sq + pos;
        row_m[tid] = stats[si];
        row_il[tid] = 1.f / fmaxf(stats[n_stats + si], 1e-30f);
        row_delta[tid] = stats[2 * n_stats + si];
        row_mc[tid] = bs ? stats[3 * n_stats + si] : 0.f;
        row_pos[tid] = q_offset + pos;
      } else {               // a row past the last: p = 0, ds = 0
        row_m[tid] = 0.f;
        row_il[tid] = 0.f;
        row_delta[tid] = 0.f;
        row_mc[tid] = 0.f;
        row_pos[tid] = 0;
      }
    }
    __syncthreads();

    // the chunk's p and ds: rows warp and warp + 8, lane j on key j
    constexpr int RW = RC / KWARPS;
    float s[RW], dp[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < DT; ++dd) {
      const float kx = ks[lane][dd], vx = vs[lane][dd];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        s[i] = fmaf(qs[warp + KWARPS * i][dd], kx, s[i]);
        dp[i] = fmaf(dos[warp + KWARPS * i][dd], vx, dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = warp + KWARPS * i;
      const bool ok =
          valid && in_reach(row_pos[r], sr.pos0 + gk, window, causal);
      if (bs) {
        const float pu =
            in_range ? bf16_p(ok ? bf16r(s[i]) : NEG_BF16, row_m[r]) : 0.f;
        ps[r][lane] = pu * row_il[r];
        dss[r][lane] = ok && in_range
            ? bf16_ds_m(s[i], row_m[r], dp[i], row_il[r], row_delta[r],
                        row_mc[r])
            : 0.f;
      } else {
        const float p =
            in_range ? expf((ok ? s[i] * scale : NEG) - row_m[r]) * row_il[r]
                     : 0.f;
        ps[r][lane] = p;
        dss[r][lane] = ok && in_range ? p * (dp[i] - row_delta[r]) : 0.f;
      }
    }
    __syncthreads();

    // every thread: key lane, columns warp * NC .. warp * NC + NC - 1
#pragma unroll 4
    for (int r = 0; r < RC; ++r) {
      const float pr = ps[r][lane], dsr = dss[r][lane];
#pragma unroll
      for (int c = 0; c < NC; c += 4) {
        const float4 g4 = *reinterpret_cast<const float4*>(&dos[r][warp * NC + c]);
        const float4 q4 = *reinterpret_cast<const float4*>(&qs[r][warp * NC + c]);
        adv[c] = fmaf(pr, g4.x, adv[c]);
        adv[c + 1] = fmaf(pr, g4.y, adv[c + 1]);
        adv[c + 2] = fmaf(pr, g4.z, adv[c + 2]);
        adv[c + 3] = fmaf(pr, g4.w, adv[c + 3]);
        adk[c] = fmaf(dsr, q4.x, adk[c]);
        adk[c + 1] = fmaf(dsr, q4.y, adk[c + 1]);
        adk[c + 2] = fmaf(dsr, q4.z, adk[c + 2]);
        adk[c + 3] = fmaf(dsr, q4.w, adk[c + 3]);
      }
    }
  }

  if (!in_range) return;
  const size_t row = ((static_cast<size_t>(b) * sr.n + gk) * Hkv + hk) * D;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int dd = warp * NC + c;
    if (dd < D) {
      dk_o[row + dd] = from_f32<T>(bs ? bf16r(adk[c]) : adk[c] * scale);
      dv_o[row + dd] = from_f32<T>(bs ? bf16r(adv[c]) : adv[c]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int TC_STAGES = 3;      // cp.async ring depth (dk/dv; dq below)
constexpr int TC_MAX_WARPS = 8;   // of a dq CTA, 16 rows each
constexpr int KV_BN = 64;         // keys per dk/dv CTA: 4 key warps of 16
constexpr int KV_BM = 32;         // rows per chunk of the dk/dv walk
constexpr int SMEM_LIMIT = 232448;

// The dq kernel's K/V tiles: 64 keys (half the barriers and A-fragment
// loads of 32 a product); 32 at DT 256, where a warp's 64-key S and dP
// would not fit in registers beside its dq, and where a mask can cut
// (MASKED), where 32 skip finer and waste less of a short causal walk
// (the 4 x 96 causal case ran 10% slower in 64-key tiles, PERF.md).
__host__ __device__ constexpr int dq_bkv(int DT, bool masked) {
  return DT == 256 || masked ? 32 : 64;
}

// The dq kernel's K/V ring depth: 2 at DT 256, where a third stage would
// leave room for 7 warps' rows, 3 below.
__host__ __device__ constexpr int dq_stages(int DT) {
  return DT == 256 ? 2 : 3;
}

// Dynamic shared memory of a dq CTA of `warps` warps at tile width DT, in
// bytes: the K and V rings and each warp's q and dO rows (QT bf16 terms
// of each: 2 with BAOS), bf16 rows padded by 16 bytes (ldmatrix's eight
// row addresses hit eight bank groups).
constexpr int dq_tc_smem_bytes(int DT, bool masked, int warps, int QT = 1) {
  return (2 * dq_stages(DT) * dq_bkv(DT, masked) + 2 * QT * 16 * warps) *
         (DT + 8) * 2;
}

// The most warps a dq CTA takes at tile width DT.
constexpr int dq_tc_max_warps(int DT, bool masked, int QT = 1) {
  int w = TC_MAX_WARPS;
  while (w > 1 && dq_tc_smem_bytes(DT, masked, w, QT) > SMEM_LIMIT) --w;
  return w;
}

// Warps of a dk/dv CTA per key warp: at DT 256 one accumulates dV and one
// dK for the same 16 keys (both sums in one warp would take 256 f32
// registers a thread); below, one warp accumulates both.
__host__ __device__ constexpr int dkv_roles(int DT) {
  return DT == 256 ? 2 : 1;
}

// Rows of the statistics scratch a packed row has on the tensor-core
// route: m, 1/l, delta, and with bf16 scores bf16_mcorr's term.
__host__ __device__ constexpr int stat_rows(bool bs) { return bs ? 4 : 3; }

// The dk/dv kernel's ring depth: 2 at DT 256 with BAOS's two terms of q
// and dO (a third stage would pass the shared memory a block takes), 3
// otherwise.
__host__ __device__ constexpr int dkv_stages(int DT, int QT) {
  return DT == 256 && QT == 2 ? 2 : TC_STAGES;
}

// Dynamic shared memory of a dk/dv CTA at tile width DT, in bytes: its K
// and V tile, and a ring of row chunks (QT terms of the q and dO rows, and
// the rows' statistics).
constexpr int dkv_tc_smem_bytes(int DT, bool bs = false, int QT = 1) {
  return (2 * KV_BN + 2 * QT * dkv_stages(DT, QT) * KV_BM) * (DT + 8) * 2 +
         dkv_stages(DT, QT) * stat_rows(bs) * KV_BM * 4;
}

// The row-statistics scratch holds, per (batch row, KV head), stat_rows
// rows of NR floats (m, 1/l, delta of each packed row, and with bf16
// scores bf16_mcorr's term), NR = G * Sq rounded up to 4 so that a chunk's
// statistics are 16-byte copies.
__host__ __device__ __forceinline__ int stats_stride(int n_rows) {
  return (n_rows + 3) & ~3;
}

__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// Items [lo, lo + n) of BT holding items j in [jlo, jhi] of len items.
__device__ __forceinline__ void tiles_of(int jlo, int jhi, int len, int BT,
                                         int& lo, int& n) {
  jlo = max(jlo, 0);
  jhi = min(jhi, len - 1);
  lo = jlo <= jhi ? jlo / BT : 0;
  n = jlo <= jhi ? jhi / BT - lo + 1 : 0;
}

constexpr int FAR = 1 << 30;

// The key positions some query position in [qmin, qmax] reaches: |q - k|
// < window, and k <= q if causal (the forward's tile_range).
__device__ __forceinline__ void keys_reached(int qmin, int qmax, int window,
                                             int causal, int& lo, int& hi) {
  lo = window > 0 ? qmin - window + 1 : -FAR;
  hi = causal ? qmax : (window > 0 ? qmax + window - 1 : FAR);
}

// The query positions that reach some key position in [kmin, kmax].
__device__ __forceinline__ void queries_reaching(int kmin, int kmax,
                                                 int window, int causal,
                                                 int& lo, int& hi) {
  lo = causal ? kmin : (window > 0 ? kmin - window + 1 : -FAR);
  hi = window > 0 ? kmax + window - 1 : FAR;
}

// dq and the row statistics.  One CTA per (16 * warps packed rows, KV
// head, batch row); row r of a group is q head hk * G + r % G at position
// r / G, as in the forward, so the K/V tiles a CTA stages serve every q
// head of its rows.  Pass 0 forms S and dP over the key tiles in reach
// and keeps each row's max, sum and sum of e_ij dp_ij online; pass 1
// forms them again with the final statistics and sums dS K into dq.  BS:
// bf16 scores (q is then qg = bf16(q D^-1/2); S rounded to bf16, P and dS
// as bf16_p and bf16_ds, dq = bf16(dS K) D^-1/2).  QT = 2 (BAOS): q and
// dO are two bf16 terms each (ex.q_lo, ex.dout_lo; a null one zeros), S
// and dP the sums of the two terms' products.  The walk takes the cache's
// key tiles in reach, then route B's second source's (ex.S2 keys at
// q_offset + j), under one (m, l).
template <int DT, bool MASKED = false, bool BS = false, int QT = 1>
__global__ void __launch_bounds__(32 * TC_MAX_WARPS, 1)
flash_bidir_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const unsigned char* __restrict__ kv_valid,
                      bf16* __restrict__ dq, float* __restrict__ stats,
                      int Sq, int Skv, int Hq, int Hkv, int D, float scale,
                      int window, int q_offset, int causal, Ext<bf16> ex) {
  constexpr int DP = DT + 8;
  constexpr int KT = DT / 16;      // depth steps of S and dP
  constexpr int NT = DT / 8;       // 8-column tiles of dq
  constexpr int STAGES = dq_stages(DT);
  constexpr int BKV = dq_bkv(DT, MASKED);
  constexpr int NK = BKV / 8;      // 8-key tiles of a K/V tile
  constexpr int KV_STAGE = BKV * DP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // [STAGES][BKV][DP]
  bf16* vs = ks + STAGES * KV_STAGE;              // [STAGES][BKV][DP]
  bf16* rs = vs + STAGES * KV_STAGE;  // [warps][q terms, dO terms][16][DP]

  const int G = Hq / Hkv, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3, nwarps = blockDim.x >> 5;
  const int n_rows = G * Sq, NR = stats_stride(n_rows);
  const int r_lo = blockIdx.x * nwarps * 16;
  const int r_hi = min(r_lo + nwarps * 16, n_rows) - 1;
  const int row0 = r_lo + warp * 16;
  q_offset = offset_of(q_offset, ex.off);
  const int n_all = Skv + ex.S2;       // keys of both sources
  // the key tiles the CTA's rows reach: the cache's [t_lo, t_lo + n_w0),
  // then the second source's [t_lo1, t_lo1 + n_w1)
  int t_lo = 0, n_w0 = (Skv + BKV - 1) / BKV;
  int t_lo1 = 0, n_w1 = (ex.S2 + BKV - 1) / BKV;
  if (MASKED && (window > 0 || causal)) {
    int lo, hi;
    keys_reached(q_offset + r_lo / G, q_offset + r_hi / G, window, causal,
                 lo, hi);
    tiles_of(lo, hi, Skv, BKV, t_lo, n_w0);
    if (ex.S2 > 0)
      tiles_of(lo == -FAR ? lo : lo - q_offset,
               hi == FAR ? hi : hi - q_offset, ex.S2, BKV, t_lo1, n_w1);
  }
  const int n_w = n_w0 + n_w1;
  // walk tile w: its source and its first key
  auto tile = [&](int w, int& k0) {
    const int si = w >= n_w0;
    k0 = (si ? t_lo1 + w - n_w0 : t_lo + w) * BKV;
    return src_of<bf16>(si, k, v, kv_valid, Skv, ex, q_offset);
  };

  auto load_kv = [&](int w) {
    bf16* kd = ks + (w % STAGES) * KV_STAGE;
    bf16* vd = vs + (w % STAGES) * KV_STAGE;
    int k0;
    const Src<bf16> sr = tile(w, k0);
    for (int e = tid; e < BKV * (DT / 8); e += blockDim.x) {
      const int j = e / (DT / 8), dc = (e % (DT / 8)) * 8, key = k0 + j;
      const bool ok = key < sr.n && dc < D;
      const size_t o =
          ok ? ((static_cast<size_t>(b) * sr.n + key) * Hkv + hk) * D + dc
             : 0;
      cp_async_16(smem_addr(kd + j * DP + dc), sr.k + o, ok);
      cp_async_16(smem_addr(vd + j * DP + dc), sr.v + o, ok);
    }
  };

  // this warp's 16 q and dO rows, each in QT terms (rows past G * Sq,
  // columns past D and a null term zero-filled), in the first group with
  // the first K/V tiles
  bf16* qw = rs + warp * 2 * QT * 16 * DP;
  bf16* dw = qw + QT * 16 * DP;
#pragma unroll
  for (int e = lane; e < 16 * (DT / 8); e += 32) {
    const int r = e / (DT / 8), dc = (e % (DT / 8)) * 8, row = row0 + r;
    const bool ok = row < n_rows && dc < D;
    const size_t o =
        ok ? ((static_cast<size_t>(b) * Sq + row / G) * Hq + hk * G + row % G)
                 * D + dc
           : 0;
#pragma unroll
    for (int t = 0; t < QT; ++t) {
      const bf16* qt = t == 0 ? q : ex.q_lo;
      const bf16* dt = t == 0 ? dout : ex.dout_lo;
      const bool okq = ok && qt != nullptr, okd = ok && dt != nullptr;
      cp_async_16(smem_addr(qw + (t * 16 + r) * DP + dc),
                  okq ? qt + o : q, okq);
      cp_async_16(smem_addr(dw + (t * 16 + r) * DP + dc),
                  okd ? dt + o : dout, okd);
    }
  }
  auto prefetch = [&]() {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n_w) load_kv(s);
      cp_async_commit();
    }
    cp_async_wait<STAGES - 2>();
    __syncthreads();
  };

  // the lane's two rows: g and g + 8 of the warp's 16
  int qpos[2];
  bool live[2];
  size_t orow[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + g + 8 * hh;
    live[hh] = row < n_rows;
    const int r = live[hh] ? row : 0;
    qpos[hh] = q_offset + r / G;
    orow[hh] =
        ((static_cast<size_t>(b) * Sq + r / G) * Hq + hk * G + r % G) * D;
  }

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, pdp[2] = {0.f, 0.f};
  float il[2], dl[2];
  // BS: each row's sum of dS and its keys at the max, then bf16_mcorr's
  // term (pass 1; the dq product is pass 2)
  float eps[2] = {0.f, 0.f}, ties[2] = {0.f, 0.f}, mc[2] = {0.f, 0.f};
  constexpr int NPASS = BS ? 3 : 2;
  constexpr int SR = stat_rows(BS);
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

#pragma unroll 1
  for (int pass = 0; pass < NPASS; ++pass) {
    prefetch();
    for (int w = 0; w < n_w; ++w) {
      cp_async_wait<STAGES - 2>();      // tile w has landed
      __syncthreads();                     // ... for all; w - 1 is read
      if (w + STAGES - 1 < n_w) load_kv(w + STAGES - 1);
      cp_async_commit();
      const bf16* kt = ks + (w % STAGES) * KV_STAGE;
      const bf16* vt = vs + (w % STAGES) * KV_STAGE;
      int k0;
      const Src<bf16> sr = tile(w, k0);

      // kv_valid of this lane's keys (key 8j + 2c + e of the tile at
      // 2j + e), read after the products so the loads overlap them
      unsigned char kvv[2 * NK];
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + 2 * c + e;
          kvv[2 * j + e] = MASKED && sr.valid != nullptr && key < sr.n
                               ? sr.valid[static_cast<size_t>(b) * sr.n + key]
                               : 1;
        }

      // S = Q K^T and dP = dO V^T: 16 rows x BKV keys, NK 8-key tiles
      float st[NK][4], dpt[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t aq[QT][4], ad[QT][4];
        const int ao = (lane & 15) * DP + kk * 16 + (lane >> 4) * 8;
#pragma unroll
        for (int t = 0; t < QT; ++t) {
          ldmatrix_x4(aq[t], smem_addr(qw + t * 16 * DP + ao));
          ldmatrix_x4(ad[t], smem_addr(dw + t * 16 * DP + ao));
        }
#pragma unroll
        for (int jp = 0; jp < NK / 2; ++jp) {
          const int bo = (jp * 16 + (lane & 7) + (lane >> 4) * 8) * DP +
                         kk * 16 + ((lane >> 3) & 1) * 8;
          uint32_t bk[4], bv[4];
          ldmatrix_x4(bk, smem_addr(kt + bo));
          ldmatrix_x4(bv, smem_addr(vt + bo));
#pragma unroll
          for (int t = 0; t < QT; ++t) {
            mma_bf16(st[2 * jp], aq[t], bk[0], bk[1]);
            mma_bf16(st[2 * jp + 1], aq[t], bk[2], bk[3]);
            mma_bf16(dpt[2 * jp], ad[t], bv[0], bv[1]);
            mma_bf16(dpt[2 * jp + 1], ad[t], bv[2], bv[3]);
          }
        }
      }

      // x D^-1/2; -1e30 for a masked key, -inf (probability 0) past the
      // source's last key
      bool okm[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + 2 * c + e;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const bool ok =
                key < sr.n && (!MASKED || (kvv[2 * j + e] != 0 &&
                                           in_reach(qpos[hh], sr.pos0 + key,
                                                    window, causal)));
            float& x = st[j][2 * hh + e];
            okm[j][2 * hh + e] = ok;
            x = key < sr.n ? (ok ? (BS ? bf16r(x) : x * scale)
                                 : (BS ? NEG_BF16 : NEG))
                           : -INFINITY;
          }
        }

      if (pass == 0) {
        // online max, sum and sum of e_ij dp_ij, the max over the quad
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float mx = NEG;
#pragma unroll
          for (int j = 0; j < NK; ++j)
            mx = fmaxf(mx, fmaxf(st[j][2 * hh], st[j][2 * hh + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 2));
          const float m_new = fmaxf(m[hh], mx);
          const float corr = expf(m[hh] - m_new);
          m[hh] = m_new;
          l[hh] *= corr;
          pdp[hh] *= corr;
#pragma unroll
          for (int j = 0; j < NK; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float x = st[j][2 * hh + e];
              const float p = BS ? bf16_p(x, m_new) : expf(x - m_new);
              l[hh] += p;
              pdp[hh] += p * dpt[j][2 * hh + e];
            }
        }
      } else {
        // dS = P (dP - delta), 0 where masked; dq += dS K, 16 keys a step
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hh = e >> 1;
            if (BS) {
              const float x = st[j][e];
              const bool tie = okm[j][e] && x == m[hh];
              float ds = okm[j][e] ? bf16r(bf16_p(x, m[hh]) *
                                           bf16_dp(dpt[j][e], il[hh], dl[hh]))
                                   : 0.f;
              if (pass == 1) {
                eps[hh] += ds;
                ties[hh] += tie ? 1.f : 0.f;
              } else if (tie) {
                ds = bf16r(ds + mc[hh]);
              }
              st[j][e] = ds;
            } else {
              const float p = expf(st[j][e] - m[hh]) * il[hh];
              st[j][e] = okm[j][e] ? p * (dpt[j][e] - dl[hh]) : 0.f;
            }
          }
        if (BS && pass == 1) continue;     // the sums alone: no product
#pragma unroll
        for (int kk = 0; kk < NK / 2; ++kk) {
          uint32_t a[4] = {pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                           pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                           pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                           pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
#pragma unroll
          for (int np = 0; np < DT / 16; ++np) {
            uint32_t bk[4];
            ldmatrix_x4_trans(bk, smem_addr(kt + (kk * 16 + (lane & 15)) * DP
                                            + np * 16 + (lane >> 4) * 8));
            mma_bf16(acc[2 * np], a, bk[0], bk[1]);
            mma_bf16(acc[2 * np + 1], a, bk[2], bk[3]);
          }
        }
      }
    }
    cp_async_wait<0>();                    // the walk's trailing groups
    __syncthreads();                       // every tile read: ring free
    if (pass == NPASS - 1) break;
    if (pass == 1) {                       // BS: bf16_mcorr's term
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        eps[hh] += __shfl_xor_sync(FULL_MASK, eps[hh], 1);
        eps[hh] += __shfl_xor_sync(FULL_MASK, eps[hh], 2);
        ties[hh] += __shfl_xor_sync(FULL_MASK, ties[hh], 1);
        ties[hh] += __shfl_xor_sync(FULL_MASK, ties[hh], 2);
        mc[hh] = bf16_mcorr(eps[hh], ties[hh]);
        const int row = row0 + g + 8 * hh;
        if (c == 0 && row < NR)
          stats[((static_cast<size_t>(b) * Hkv + hk) * SR + 3) * NR + row] =
              live[hh] ? mc[hh] : 0.f;
      }
      continue;
    }

    // the rows' statistics.  A row with no valid key in its reach has no
    // valid key at all: it averages every key (l = Skv, m = -1e30; its ds
    // is 0 on every key, so delta is unused and written as 0).
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(FULL_MASK, l[hh], 1);
      l[hh] += __shfl_xor_sync(FULL_MASK, l[hh], 2);
      pdp[hh] += __shfl_xor_sync(FULL_MASK, pdp[hh], 1);
      pdp[hh] += __shfl_xor_sync(FULL_MASK, pdp[hh], 2);
      const bool dead = m[hh] == NEG;
      il[hh] = 1.f / fmaxf(dead ? static_cast<float>(n_all) : l[hh], 1e-30f);
      dl[hh] = dead ? 0.f : pdp[hh] * il[hh];
      const int row = row0 + g + 8 * hh;
      if (c == 0 && row < NR) {           // rows past G * Sq: zeros
        float* sr = stats + (static_cast<size_t>(b) * Hkv + hk) * SR * NR + row;
        sr[0] = live[hh] ? m[hh] : 0.f;
        sr[NR] = live[hh] ? il[hh] : 0.f;
        sr[2 * NR] = live[hh] ? dl[hh] : 0.f;
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (!live[hh]) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int dd = 8 * n + 2 * c;
      if (dd >= D) break;                // D is a multiple of 8
      const float g0 = dq_of(acc[n][2 * hh], scale, BS);
      const float g1 = dq_of(acc[n][2 * hh + 1], scale, BS);
      if (ex.dq32 != nullptr)
        *reinterpret_cast<float2*>(ex.dq32 + orow[hh] + dd) =
            make_float2(g0, g1);
      else
        *reinterpret_cast<__nv_bfloat162*>(dq + orow[hh] + dd) =
            __floats2bfloat162_rn(g0, g1);
    }
  }
}

// dk and dv.  One CTA per (64-key tile, KV head, batch row, row split):
// key warp kw owns keys 16 kw .. 16 kw + 15 of the tile and walks the
// split's packed rows in chunks of 32, forming S^T = K Q^T and
// dP^T = V dO^T with the keys as the mma's rows, so that P^T and dS^T are
// the A fragments of dV += P^T dO and dK += dS^T Q without leaving
// registers.  n_split == 1: dk, dv written; else f32 partials of split s
// into part[0 (dk) / 1 (dv)][s], summed by flash_bidir_bwd_split_sum.  BS:
// bf16 scores (q is qg, as in the dq kernel; P^T V's operand bf16(P / l),
// dS as bf16_ds; dk = bf16(dS^T qg), no D^-1/2).  QT = 2 (BAOS): q and dO
// in two bf16 terms each, every product over both.  The grid's key tiles
// are the cache's (none with ex.skip0), then the second source's (none
// without ex.dk2), each CTA's keys of one source, its sums to that
// source's dk/dv (or partials).
template <int DT, bool MASKED = false, bool BS = false, int QT = 1>
__global__ void __launch_bounds__(128 * dkv_roles(DT), 1)
flash_bidir_bwd_dkv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const unsigned char* __restrict__ kv_valid,
                       const float* __restrict__ stats,
                       bf16* __restrict__ dk, bf16* __restrict__ dv,
                       float* __restrict__ part, int B, int Sq, int Skv,
                       int Hq, int Hkv, int D, int split_rows, int n_split,
                       float scale, int window, int q_offset, int causal,
                       Ext<bf16> ex) {
  constexpr int ROLES = dkv_roles(DT);
  constexpr int NA = ROLES == 1 ? 2 : 1;   // accumulators a warp keeps
  constexpr int DP = DT + 8;
  constexpr int KT = DT / 16;
  constexpr int NT = DT / 8;
  constexpr int NJ = KV_BM / 8;            // 8-row tiles of a chunk
  constexpr int STAGES = dkv_stages(DT, QT);
  constexpr int CH = 2 * QT * KV_BM * DP;  // a chunk's q and dO rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // [BN][DP]
  bf16* vs = ks + KV_BN * DP;                     // [BN][DP]
  bf16* ring = vs + KV_BN * DP;   // [STAGES][q terms, dO terms][BM][DP]
  constexpr int SR = stat_rows(BS);
  float* sts = reinterpret_cast<float*>(ring + STAGES * CH);
  //                          [STAGES][m, 1/l, delta (, BS: mcorr)][BM]

  q_offset = offset_of(q_offset, ex.off);
  const int n0t = ex.skip0 ? 0 : (Skv + KV_BN - 1) / KV_BN;
  const int si = static_cast<int>(blockIdx.x) >= n0t;
  const int k0 = (si ? blockIdx.x - n0t : blockIdx.x) * KV_BN;
  const Src<bf16> sr = src_of<bf16>(si, k, v, kv_valid, Skv, ex, q_offset);
  if (si) {
    dk = ex.dk2;
    dv = ex.dv2;
    part = ex.part2;
  }
  const int hk = blockIdx.y;
  const int b = blockIdx.z / n_split, split = blockIdx.z % n_split;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int kw = warp & 3, role = warp >> 2;
  const bool do_v = ROLES == 1 || role == 0;
  const bool do_k = ROLES == 1 || role == 1;
  const int G = Hq / Hkv, n_rows = G * Sq, NR = stats_stride(n_rows);
  const float* st_b = stats + (static_cast<size_t>(b) * Hkv + hk) * SR * NR;
  const int s_lo = split * split_rows;
  const int s_hi = min(s_lo + split_rows, n_rows);
  const bool reach = MASKED && (window > 0 || causal);

  // the chunks of the split whose rows reach the tile's keys
  int c_lo = s_lo / KV_BM, n_c = (s_hi - s_lo + KV_BM - 1) / KV_BM;
  if (reach) {
    int lo, hi;
    queries_reaching(sr.pos0 + k0, sr.pos0 + min(k0 + KV_BN, sr.n) - 1,
                     window, causal, lo, hi);
    using ll = long long;
    const ll plo = max(static_cast<ll>(lo) - q_offset, 0LL);
    const ll phi = min(static_cast<ll>(hi) - q_offset, static_cast<ll>(Sq - 1));
    const ll rlo = max(plo * G, static_cast<ll>(s_lo));
    const ll rhi = min(phi * G + G - 1, static_cast<ll>(s_hi - 1));
    const int f_lo = c_lo, f_n = n_c;
    if (plo > phi || rlo > rhi) {
      n_c = 0;
    } else {
      c_lo = static_cast<int>(rlo / KV_BM);
      n_c = static_cast<int>(rhi / KV_BM) - c_lo + 1;
    }
    // a row of the split with no valid key (m = -1e30) averages every key,
    // in reach or not: then the CTA walks every chunk of its split
    bool lost = false;
    for (int r = s_lo + tid; r < s_hi; r += blockDim.x)
      if (r < c_lo * KV_BM || r >= (c_lo + n_c) * KV_BM)
        lost |= st_b[r] == NEG;
    if (__syncthreads_or(lost)) {
      c_lo = f_lo;
      n_c = f_n;
    }
  }

  // the K/V tile (keys past Skv and columns past D zero-filled), in the
  // first group with the first chunks
  for (int e = tid; e < KV_BN * (DT / 8); e += blockDim.x) {
    const int j = e / (DT / 8), dc = (e % (DT / 8)) * 8, key = k0 + j;
    const bool ok = key < sr.n && dc < D;
    const size_t o =
        ok ? ((static_cast<size_t>(b) * sr.n + key) * Hkv + hk) * D + dc : 0;
    cp_async_16(smem_addr(ks + j * DP + dc), sr.k + o, ok);
    cp_async_16(smem_addr(vs + j * DP + dc), sr.v + o, ok);
  }
  auto load_chunk = [&](int w) {
    bf16* qd = ring + (w % STAGES) * CH;
    bf16* dd = qd + QT * KV_BM * DP;
    float* sd = sts + (w % STAGES) * SR * KV_BM;
    const int r0 = (c_lo + w) * KV_BM;
    for (int e = tid; e < KV_BM * (DT / 8); e += blockDim.x) {
      const int i = e / (DT / 8), dc = (e % (DT / 8)) * 8, row = r0 + i;
      const bool ok = row < s_hi && dc < D;
      const size_t o =
          ok ? ((static_cast<size_t>(b) * Sq + row / G) * Hq + hk * G +
                row % G) * D + dc
             : 0;
#pragma unroll
      for (int t = 0; t < QT; ++t) {
        const bf16* qt = t == 0 ? q : ex.q_lo;
        const bf16* dt = t == 0 ? dout : ex.dout_lo;
        const bool okq = ok && qt != nullptr, okd = ok && dt != nullptr;
        cp_async_16(smem_addr(qd + (t * KV_BM + i) * DP + dc),
                    okq ? qt + o : q, okq);
        cp_async_16(smem_addr(dd + (t * KV_BM + i) * DP + dc),
                    okd ? dt + o : dout, okd);
      }
    }
    // rows past G * Sq: zeros (p = 0, ds = 0)
    for (int e = tid; e < SR * (KV_BM / 4); e += blockDim.x) {
      const int which = e / (KV_BM / 4), i = (e % (KV_BM / 4)) * 4;
      const bool ok = r0 + i < NR;
      cp_async_16(smem_addr(sd + which * KV_BM + i),
                  st_b + which * NR + (ok ? r0 + i : 0), ok);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_c) load_chunk(s);
    cp_async_commit();
  }

  // the lane's two keys: g and g + 8 of the warp's 16
  int key[2];
  bool kin[2], kok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key[i] = k0 + kw * 16 + g + 8 * i;
    kin[i] = key[i] < sr.n;
    kok[i] = kin[i] && (!MASKED || sr.valid == nullptr ||
                        sr.valid[static_cast<size_t>(b) * sr.n + key[i]]);
  }

  float acc[NA][NT][4];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][n][e] = 0.f;

  const bf16* kwp = ks + kw * 16 * DP;
  const bf16* vwp = vs + kw * 16 * DP;
  for (int w = 0; w < n_c; ++w) {
    cp_async_wait<STAGES - 2>();           // chunk w (and the tile) landed
    __syncthreads();                       // ... for all; w - 1 is read
    if (w + STAGES - 1 < n_c) load_chunk(w + STAGES - 1);
    cp_async_commit();
    const bf16* qc = ring + (w % STAGES) * CH;
    const bf16* dc = qc + QT * KV_BM * DP;
    const float* sm = sts + (w % STAGES) * SR * KV_BM;
    const int r0 = (c_lo + w) * KV_BM;

    // S^T and dP^T: 16 keys x 32 rows, four 8-row tiles
    float st[NJ][4], dpt[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      const int ao = (lane & 15) * DP + kk * 16 + (lane >> 4) * 8;
      uint32_t ak[4], av[4];
      ldmatrix_x4(ak, smem_addr(kwp + ao));
      if (do_k) ldmatrix_x4(av, smem_addr(vwp + ao));
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        const int bo = (jp * 16 + (lane & 7) + (lane >> 4) * 8) * DP +
                       kk * 16 + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int t = 0; t < QT; ++t) {
          uint32_t bq[4];
          ldmatrix_x4(bq, smem_addr(qc + t * KV_BM * DP + bo));
          mma_bf16(st[2 * jp], ak, bq[0], bq[1]);
          mma_bf16(st[2 * jp + 1], ak, bq[2], bq[3]);
          if (do_k) {
            uint32_t bd[4];
            ldmatrix_x4(bd, smem_addr(dc + t * KV_BM * DP + bo));
            mma_bf16(dpt[2 * jp], av, bd[0], bd[1]);
            mma_bf16(dpt[2 * jp + 1], av, bd[2], bd[3]);
          }
        }
      }
    }

    // P^T and dS^T in place: element (key g + 8i, row 8j + 2c + e) at
    // [j][2i + e]
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int ri = 8 * j + 2 * c;
      const float2 mm = *reinterpret_cast<const float2*>(sm + ri);
      const float2 ll = *reinterpret_cast<const float2*>(sm + KV_BM + ri);
      const float2 de = *reinterpret_cast<const float2*>(sm + 2 * KV_BM + ri);
      const float2 mcv = BS ? *reinterpret_cast<const float2*>(
                                  sm + 3 * KV_BM + ri)
                            : make_float2(0.f, 0.f);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pos = q_offset + (r0 + ri + e) / G;
        const float rm = e ? mm.y : mm.x, rl = e ? ll.y : ll.x;
        const float rd = e ? de.y : de.x, rc = e ? mcv.y : mcv.x;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const bool ok = kok[i] && (!reach || in_reach(pos, sr.pos0 + key[i],
                                                        window, causal));
          float& x = st[j][2 * i + e];
          if (BS) {
            const float sb = bf16r(x);
            const float pu = kin[i] ? bf16_p(ok ? sb : NEG_BF16, rm) : 0.f;
            x = pu * rl;
            if (do_k) {
              float& y = dpt[j][2 * i + e];
              y = ok ? bf16r(pu * bf16_dp(y, rl, rd)) : 0.f;
              if (ok && sb == rm) y = bf16r(y + rc);
            }
          } else {
            const float p =
                kin[i] ? expf((ok ? x * scale : NEG) - rm) * rl : 0.f;
            x = p;
            if (do_k) {
              float& y = dpt[j][2 * i + e];
              y = ok ? p * (y - rd) : 0.f;
            }
          }
        }
      }
    }

    // dV += P^T dO and dK += dS^T Q, 16 rows a step
#pragma unroll
    for (int t = 0; t < NJ / 2; ++t) {
      uint32_t pa[4], da[4];
      if (do_v) {
        pa[0] = pack_bf16(st[2 * t][0], st[2 * t][1]);
        pa[1] = pack_bf16(st[2 * t][2], st[2 * t][3]);
        pa[2] = pack_bf16(st[2 * t + 1][0], st[2 * t + 1][1]);
        pa[3] = pack_bf16(st[2 * t + 1][2], st[2 * t + 1][3]);
      }
      if (do_k) {
        da[0] = pack_bf16(dpt[2 * t][0], dpt[2 * t][1]);
        da[1] = pack_bf16(dpt[2 * t][2], dpt[2 * t][3]);
        da[2] = pack_bf16(dpt[2 * t + 1][0], dpt[2 * t + 1][1]);
        da[3] = pack_bf16(dpt[2 * t + 1][2], dpt[2 * t + 1][3]);
      }
#pragma unroll
      for (int np = 0; np < DT / 16; ++np) {
        const int bo = (t * 16 + (lane & 15)) * DP + np * 16 + (lane >> 4) * 8;
#pragma unroll
        for (int u = 0; u < QT; ++u) {
          if (do_v) {
            uint32_t bo4[4];
            ldmatrix_x4_trans(bo4, smem_addr(dc + u * KV_BM * DP + bo));
            mma_bf16(acc[0][2 * np], pa, bo4[0], bo4[1]);
            mma_bf16(acc[0][2 * np + 1], pa, bo4[2], bo4[3]);
          }
          if (do_k) {
            uint32_t bq4[4];
            ldmatrix_x4_trans(bq4, smem_addr(qc + u * KV_BM * DP + bo));
            mma_bf16(acc[NA - 1][2 * np], da, bq4[0], bq4[1]);
            mma_bf16(acc[NA - 1][2 * np + 1], da, bq4[2], bq4[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  const size_t n_out = static_cast<size_t>(B) * sr.n * Hkv * D;
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    // which: 0 dk, 1 dv
    const int which = ROLES == 1 ? (a == 0 ? 1 : 0) : (role == 0 ? 1 : 0);
    const float f = which == 0 && !BS ? scale : 1.f;
    bf16* out = which == 0 ? dk : dv;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!kin[i]) continue;
      const size_t row =
          ((static_cast<size_t>(b) * sr.n + key[i]) * Hkv + hk) * D;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int dd = 8 * n + 2 * c;
        if (dd >= D) break;
        const float x0 = acc[a][n][2 * i], x1 = acc[a][n][2 * i + 1];
        if (n_split == 1) {
          *reinterpret_cast<__nv_bfloat162*>(out + row + dd) =
              __floats2bfloat162_rn(x0 * f, x1 * f);
        } else {
          float* pp = part + (static_cast<size_t>(which) * n_split + split)
                                 * n_out + row + dd;
          *reinterpret_cast<float2*>(pp) = make_float2(x0, x1);
        }
      }
    }
  }
}

// dk and dv from the n_split partials: four consecutive elements a
// thread, the splits summed in order 0, 1, ..., dk times D^-1/2, each
// rounded once.
__global__ void __launch_bounds__(256)
flash_bidir_bwd_split_sum(const float* __restrict__ part,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          long long n4, int n_split, float scale) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n4) return;
  const float4* p4 = reinterpret_cast<const float4*>(part);
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    const float4* src = p4 + static_cast<long long>(which) * n_split * n4 + i;
    float4 s = src[0];
    for (int sp = 1; sp < n_split; ++sp) {
      const float4 x = src[static_cast<long long>(sp) * n4];
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    const float f = which == 0 ? scale : 1.f;
    uint2 o;
    o.x = pack_bf16(s.x * f, s.y * f);
    o.y = pack_bf16(s.z * f, s.w * f);
    *reinterpret_cast<uint2*>((which == 0 ? dk : dv) + 4 * i) = o;
  }
}

template <int DT, bool MASKED, bool BS = false, int QT = 1>
cudaError_t launch_tc(const bf16* q, const bf16* k, const bf16* v,
                      const bf16* dout, const unsigned char* kv_valid,
                      bf16* dq, bf16* dk, bf16* dv, float* stats, float* part,
                      int B, int Sq, int Skv, int Hq, int Hkv, int D,
                      float scale, int window, int q_offset, int causal,
                      int dq_warps, int n_split, int split_rows,
                      const Ext<bf16>& ex, cudaStream_t stream) {
  constexpr int max_w = dq_tc_max_warps(DT, MASKED, QT);
  const int n_rows = (Hq / Hkv) * Sq;
  if (dq_warps < 1 || dq_warps > max_w || n_split < 1 || split_rows < 1 ||
      split_rows % KV_BM != 0 ||
      static_cast<long long>(n_split) * split_rows < n_rows ||
      static_cast<long long>(n_split - 1) * split_rows >= n_rows ||
      (n_split > 1 && ((!ex.skip0 && part == nullptr) ||
                       (ex.dk2 != nullptr && ex.part2 == nullptr))))
    return cudaErrorInvalidValue;
  static const cudaError_t attr_dq = cudaFuncSetAttribute(
      flash_bidir_bwd_dq_tc<DT, MASKED, BS, QT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      dq_tc_smem_bytes(DT, MASKED, max_w, QT));
  if (attr_dq != cudaSuccess) return attr_dq;
  static const cudaError_t attr_dkv = cudaFuncSetAttribute(
      flash_bidir_bwd_dkv_tc<DT, MASKED, BS, QT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      dkv_tc_smem_bytes(DT, BS, QT));
  if (attr_dkv != cudaSuccess) return attr_dkv;
  const dim3 grid_q((n_rows + 16 * dq_warps - 1) / (16 * dq_warps), Hkv, B);
  flash_bidir_bwd_dq_tc<DT, MASKED, BS, QT><<<grid_q, 32 * dq_warps,
                                              dq_tc_smem_bytes(DT, MASKED,
                                                               dq_warps, QT),
                                              stream>>>(
      q, k, v, dout, kv_valid, dq, stats, Sq, Skv, Hq, Hkv, D, scale, window,
      q_offset, causal, ex);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // key tiles of the cache (unless skipped), then of the second source
  const int n0t = ex.skip0 ? 0 : (Skv + KV_BN - 1) / KV_BN;
  const int n1t = ex.dk2 != nullptr ? (ex.S2 + KV_BN - 1) / KV_BN : 0;
  if (n0t + n1t == 0) return cudaSuccess;
  const dim3 grid_k(n0t + n1t, Hkv, B * n_split);
  flash_bidir_bwd_dkv_tc<DT, MASKED, BS, QT><<<grid_k, 128 * dkv_roles(DT),
                                               dkv_tc_smem_bytes(DT, BS, QT),
                                               stream>>>(
      q, k, v, dout, kv_valid, stats, dk, dv, part, B, Sq, Skv, Hq, Hkv, D,
      split_rows, n_split, scale, window, q_offset, causal, ex);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  // each source's split sum
  for (int src = 0; src < 2; ++src) {
    if (src == 0 ? n0t == 0 : n1t == 0) continue;
    const long long n4 =
        static_cast<long long>(B) * (src == 0 ? Skv : ex.S2) * Hkv * D / 4;
    flash_bidir_bwd_split_sum<<<static_cast<unsigned>((n4 + 255) / 256), 256,
                                0, stream>>>(
        src == 0 ? part : ex.part2, src == 0 ? dk : ex.dk2,
        src == 0 ? dv : ex.dv2, n4, n_split, BS ? 1.f : scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The CUDA-core route: f32, and bf16 at a head dim that is not a multiple
// of 8 (the tensor-core route's 16-byte loads cannot start such rows; these
// kernels load one value at a time).
template <typename T, int DPL>
cudaError_t launch_cc(const T* q, const T* k, const T* v, const T* dout,
                      const unsigned char* kv_valid, T* dq, T* dk, T* dv,
                      float* stats, int B, int Sq, int Skv, int Hq, int Hkv,
                      int D, float scale, int window, int q_offset,
                      int causal, int bs, const Ext<T>& ex,
                      cudaStream_t stream) {
  constexpr int DT = 32 * DPL;
  static const cudaError_t attr_dq = cudaFuncSetAttribute(
      flash_bidir_bwd_dq<T, DPL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem_bytes(DT));
  if (attr_dq != cudaSuccess) return attr_dq;
  static const cudaError_t attr_dkv = cudaFuncSetAttribute(
      flash_bidir_bwd_dkv<T, DPL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_smem_bytes(DT));
  if (attr_dkv != cudaSuccess) return attr_dkv;
  const dim3 grid_q((Sq + BQ - 1) / BQ, Hq, B);
  flash_bidir_bwd_dq<T, DPL>
      <<<grid_q, 32 * QWARPS, dq_smem_bytes(DT), stream>>>(
          q, k, v, dout, kv_valid, dq, stats, B, Sq, Skv, Hq, Hkv, D, scale,
          window, q_offset, causal, bs, ex);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n0t = ex.skip0 ? 0 : (Skv + BK - 1) / BK;
  const int n1t = ex.dk2 != nullptr ? (ex.S2 + BK - 1) / BK : 0;
  if (n0t + n1t == 0) return cudaSuccess;
  const dim3 grid_k(n0t + n1t, Hkv, B);
  flash_bidir_bwd_dkv<T, DPL>
      <<<grid_k, 32 * KWARPS, dkv_smem_bytes(DT), stream>>>(
          q, k, v, dout, kv_valid, stats, dk, dv, B, Sq, Skv, Hq, Hkv, D,
          scale, window, q_offset, causal, bs, ex);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Head dims past 256: the CUDA-core route with the output columns split
// over CTAs
// ---------------------------------------------------------------------------

constexpr int WIDE_DV = 256;   // output columns of a dq or dk/dv CTA
constexpr int WIDE_CH = 128;   // columns of one chunk of the S and dP products

// Shared memory of the chunked S and dP products (wide_s_dp), in floats:
// 16 rows of q and dO, and 32 keys of K and V, one chunk wide.
constexpr int WIDE_SDP = 2 * 16 * WIDE_CH + 2 * BK * (WIDE_CH + 1);

constexpr int wide_stats_smem_bytes() { return WIDE_SDP * 4; }
constexpr int wide_dq_smem_bytes() {
  return (WIDE_SDP + BK * WIDE_DV) * 4;
}
constexpr int wide_dkv_smem_bytes() {
  return (WIDE_SDP + 2 * RC * BK + 5 * RC + 2 * RC * WIDE_DV) * 4;
}

// s_i = q_i . k_lane and dp_i = dO_i . v_lane over every column, for the
// rows rows[i] of 16 staged rows (row r's first element at row_off(r) in q
// and dout, or -1 past the last row) against key k0 + lane: chunk by chunk
// of WIDE_CH columns, in increasing order, one FMA chain each -- the same
// order in every CTA that forms them, so every column slice of one row
// forms the same bits (bs: K and V rounded to bf16 as they are staged).
// Starts with a barrier, so the caller's earlier reads of any shared
// memory are done; ends without one.
template <typename T, int R, typename RowOff>
__device__ __forceinline__ void wide_s_dp(
    const T* __restrict__ q, const T* __restrict__ dout, const Ext<T>& ex,
    const Src<T>& sr, RowOff row_off, int b, int k0, int hk, int Hkv, int D,
    int tid, int nthreads, const int (&rows)[R], float* smem, float (&s)[R],
    float (&dp)[R], int bs) {
  float(*qs)[WIDE_CH] = reinterpret_cast<float(*)[WIDE_CH]>(smem);
  float(*dos)[WIDE_CH] = reinterpret_cast<float(*)[WIDE_CH]>(
      smem + 16 * WIDE_CH);
  float(*ks)[WIDE_CH + 1] = reinterpret_cast<float(*)[WIDE_CH + 1]>(
      smem + 2 * 16 * WIDE_CH);
  float(*vs)[WIDE_CH + 1] = reinterpret_cast<float(*)[WIDE_CH + 1]>(
      smem + 2 * 16 * WIDE_CH + BK * (WIDE_CH + 1));
  const int lane = tid & 31;
#pragma unroll
  for (int i = 0; i < R; ++i) s[i] = dp[i] = 0.f;
  for (int d0 = 0; d0 < D; d0 += WIDE_CH) {
    __syncthreads();
    for (int e = tid; e < 16 * WIDE_CH; e += nthreads) {
      const int r = e / WIDE_CH, c = e % WIDE_CH, dd = d0 + c;
      const long long o = row_off(r);
      float x = 0.f, g = 0.f;
      if (o >= 0 && dd < D) {
        x = two_terms(q, ex.q_lo, o + dd);
        g = two_terms(dout, ex.dout_lo, o + dd);
      }
      qs[r][c] = x;
      dos[r][c] = g;
    }
    for (int e = tid; e < BK * WIDE_CH; e += nthreads) {
      const int j = e / WIDE_CH, c = e % WIDE_CH, dd = d0 + c, gk = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (gk < sr.n && dd < D) {
        const size_t o = ((static_cast<size_t>(b) * sr.n + gk) * Hkv + hk) * D + dd;
        kx = to_f32(sr.k[o]);
        vx = to_f32(sr.v[o]);
      }
      ks[j][c] = bs ? bf16r(kx) : kx;
      vs[j][c] = bs ? bf16r(vx) : vx;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < WIDE_CH; ++c) {
      const float kx = ks[lane][c], vx = vs[lane][c];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        s[i] = fmaf(qs[rows[i]][c], kx, s[i]);
        dp[i] = fmaf(dos[rows[i]][c], vx, dp[i]);
      }
    }
  }
}

// Kernel 1 of the wide route: each row's (m, l, delta) over every key,
// written once to the scratch (3, B, Hq, Sq), which every column slice of
// kernels 2 and 3 then reads.  One CTA per (16-row q tile, q head, batch
// row), the f32 route's pass 1.
template <typename T>
__global__ void __launch_bounds__(32 * QWARPS)
flash_bidir_bwd_stats_wide(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const T* __restrict__ dout,
                           const unsigned char* __restrict__ kv_valid,
                           float* __restrict__ stats, int B, int Sq, int Skv,
                           int Hq, int Hkv, int D, float scale, int window,
                           int q_offset, int causal, int bs, Ext<T> ex) {
  extern __shared__ __align__(16) float smem_ws[];
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  q_offset = offset_of(q_offset, ex.off);
  const int n0t = (Skv + BK - 1) / BK, n_t = n0t + (ex.S2 + BK - 1) / BK;
  auto row_off = [&](int r) -> long long {
    return q0 + r < Sq
               ? ((static_cast<long long>(b) * Sq + q0 + r) * Hq + h) * D
               : -1;
  };
  int rows[RPW], qpos[RPW];
  float m[RPW], l[RPW], pdp[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    rows[i] = warp * RPW + i;
    qpos[i] = q_offset + q0 + rows[i];
    m[i] = NEG;
    l[i] = pdp[i] = 0.f;
  }
  for (int ti = 0; ti < n_t; ++ti) {
    const int si = ti >= n0t, k0 = (si ? ti - n0t : ti) * BK;
    const Src<T> sr = src_of<T>(si, k, v, kv_valid, Skv, ex, q_offset);
    float s[RPW], dp[RPW];
    wide_s_dp<T, RPW>(q, dout, ex, sr, row_off, b, k0, hk, Hkv, D, tid,
                      32 * QWARPS, rows, smem_ws, s, dp, bs);
    const int gk = k0 + lane;
    const bool in_range = gk < sr.n;
    const bool valid = key_ok(sr.valid, b, sr.n, gk);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const bool ok =
          valid && in_reach(qpos[i], sr.pos0 + gk, window, causal);
      const float x = in_range ? (ok ? (bs ? bf16r(s[i]) : s[i] * scale)
                                     : (bs ? NEG_BF16 : NEG))
                               : -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(x));
      const float corr = expf(m[i] - m_new);
      const float e = bs ? bf16_p(x, m_new) : expf(x - m_new);
      l[i] = l[i] * corr + warp_sum(e);
      pdp[i] = pdp[i] * corr + warp_sum(in_range ? e * dp[i] : 0.f);
      m[i] = m_new;
    }
  }
  // bf16 scores: each row's sum of dS and its keys at the max
  // (bf16_mcorr), a second walk over every key
  float il[RPW], delta[RPW], eps[RPW], ties[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    il[i] = 1.f / fmaxf(l[i], 1e-30f);
    delta[i] = pdp[i] * il[i];
    eps[i] = ties[i] = 0.f;
  }
  for (int ti = 0; bs && ti < n_t; ++ti) {
    const int si = ti >= n0t, k0 = (si ? ti - n0t : ti) * BK;
    const Src<T> sr = src_of<T>(si, k, v, kv_valid, Skv, ex, q_offset);
    float s[RPW], dp[RPW];
    wide_s_dp<T, RPW>(q, dout, ex, sr, row_off, b, k0, hk, Hkv, D, tid,
                      32 * QWARPS, rows, smem_ws, s, dp, bs);
    const int gk = k0 + lane;
    const bool ok_k = gk < sr.n && key_ok(sr.valid, b, sr.n, gk);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const bool ok =
          ok_k && in_reach(qpos[i], sr.pos0 + gk, window, causal);
      eps[i] += warp_sum(ok ? bf16_ds(s[i], m[i], dp[i], il[i], delta[i])
                            : 0.f);
      ties[i] += warp_sum(ok && bf16r(s[i]) == m[i] ? 1.f : 0.f);
    }
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int gq = q0 + rows[i];
    if (lane == 0 && gq < Sq) {
      const size_t si = (static_cast<size_t>(b) * Hq + h) * Sq + gq;
      const size_t n = static_cast<size_t>(B) * Hq * Sq;
      stats[si] = m[i];
      stats[n + si] = l[i];
      stats[2 * n + si] = delta[i];
      if (bs) stats[3 * n + si] = bf16_mcorr(eps[i], ties[i]);
    }
  }
}

// Kernel 2 of the wide route: dq's columns [256 slice, 256 slice + 256)
// for a 16-row q tile of one q head and batch row (blockIdx.x = tile *
// n_slices + slice), from the scratch's statistics: S and dP formed over
// every column (wide_s_dp), dS, then dq += dS K on the slice's columns.
template <typename T>
__global__ void __launch_bounds__(32 * QWARPS)
flash_bidir_bwd_dq_wide(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const unsigned char* __restrict__ kv_valid,
                        const float* __restrict__ stats, T* __restrict__ dq,
                        int B, int Sq, int Skv, int Hq, int Hkv, int D,
                        float scale, int window, int q_offset, int causal,
                        int n_slices, int bs, Ext<T> ex) {
  constexpr int DPL = WIDE_DV / 32;
  extern __shared__ __align__(16) float smem_wq[];
  float(*ksl)[WIDE_DV] = reinterpret_cast<float(*)[WIDE_DV]>(smem_wq + WIDE_SDP);
  const int q0 = (blockIdx.x / n_slices) * BQ;
  const int c0 = (blockIdx.x % n_slices) * WIDE_DV;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nthreads = 32 * QWARPS;
  const size_t n_stats = static_cast<size_t>(B) * Hq * Sq;
  q_offset = offset_of(q_offset, ex.off);
  const int n0t = (Skv + BK - 1) / BK, n_t = n0t + (ex.S2 + BK - 1) / BK;
  auto row_off = [&](int r) -> long long {
    return q0 + r < Sq
               ? ((static_cast<long long>(b) * Sq + q0 + r) * Hq + h) * D
               : -1;
  };
  int rows[RPW], qpos[RPW];
  float m[RPW], inv_l[RPW], delta[RPW], mc[RPW], acc[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    rows[i] = warp * RPW + i;
    const int gq = min(q0 + rows[i], Sq - 1);
    const size_t si = (static_cast<size_t>(b) * Hq + h) * Sq + gq;
    qpos[i] = q_offset + q0 + rows[i];
    m[i] = stats[si];
    inv_l[i] = 1.f / fmaxf(stats[n_stats + si], 1e-30f);
    delta[i] = stats[2 * n_stats + si];
    mc[i] = bs ? stats[3 * n_stats + si] : 0.f;
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[i][t] = 0.f;
  }
  for (int ti = 0; ti < n_t; ++ti) {
    const int si = ti >= n0t, k0 = (si ? ti - n0t : ti) * BK;
    const Src<T> sr = src_of<T>(si, k, v, kv_valid, Skv, ex, q_offset);
    float s[RPW], dp[RPW];
    wide_s_dp<T, RPW>(q, dout, ex, sr, row_off, b, k0, hk, Hkv, D, tid,
                      nthreads, rows, smem_wq, s, dp, bs);
    // the slice's columns of K (the previous tile's were read before
    // wide_s_dp's first barrier)
    for (int e = tid; e < BK * WIDE_DV; e += nthreads) {
      const int j = e / WIDE_DV, dd = c0 + e % WIDE_DV, gk = k0 + j;
      const float kx =
          gk < sr.n && dd < D
              ? to_f32(sr.k[((static_cast<size_t>(b) * sr.n + gk) * Hkv + hk) * D + dd])
              : 0.f;
      ksl[j][e % WIDE_DV] = bs ? bf16r(kx) : kx;
    }
    __syncthreads();
    const int gk = k0 + lane;
    const bool in_range = gk < sr.n;
    const bool valid = key_ok(sr.valid, b, sr.n, gk);
    float ds[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const bool ok = in_range && valid &&
                      in_reach(qpos[i], sr.pos0 + gk, window, causal);
      ds[i] = !ok ? 0.f
              : bs ? bf16_ds_m(s[i], m[i], dp[i], inv_l[i], delta[i], mc[i])
                   : expf(s[i] * scale - m[i]) * inv_l[i] * (dp[i] - delta[i]);
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsk[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) dsk[i] = __shfl_sync(FULL_MASK, ds[i], kk);
#pragma unroll
      for (int t = 0; t < DPL; ++t) {
        const float kx = ksl[kk][lane + 32 * t];
#pragma unroll
        for (int i = 0; i < RPW; ++i) acc[i][t] = fmaf(dsk[i], kx, acc[i][t]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int gq = q0 + rows[i];
    if (gq >= Sq) continue;
    const size_t row = ((static_cast<size_t>(b) * Sq + gq) * Hq + h) * D;
#pragma unroll
    for (int t = 0; t < DPL; ++t) {
      const int dd = c0 + lane + 32 * t;
      if (dd >= D) continue;
      const float g = dq_of(acc[i][t], scale, bs);
      if (ex.dq32 != nullptr)
        ex.dq32[row + dd] = g;
      else
        dq[row + dd] = from_f32<T>(g);
    }
  }
}

// Kernel 3 of the wide route: dk's and dv's columns [256 slice, 256 slice
// + 256) for a 32-key tile of one KV head and batch row (blockIdx.x = tile
// * n_slices + slice), walking every row of the group in chunks of 16 as
// the f32 route's dk/dv kernel does: S and dP over every column
// (wide_s_dp), P and dS from the scratch's statistics, then dV += P^T dO and
// dK += dS^T Q on the slice's columns (key lane, 32 columns a warp).
template <typename T>
__global__ void __launch_bounds__(32 * KWARPS)
flash_bidir_bwd_dkv_wide(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const unsigned char* __restrict__ kv_valid,
                         const float* __restrict__ stats, T* __restrict__ dk,
                         T* __restrict__ dv, int B, int Sq, int Skv, int Hq,
                         int Hkv, int D, float scale, int window,
                         int q_offset, int causal, int n_slices, int bs,
                         Ext<T> ex) {
  constexpr int NC = WIDE_DV / KWARPS;
  constexpr int RW = RC / KWARPS;
  extern __shared__ __align__(16) float smem_wk[];
  float* rest = smem_wk + WIDE_SDP;
  float(*ps)[BK] = reinterpret_cast<float(*)[BK]>(rest);
  float(*dss)[BK] = reinterpret_cast<float(*)[BK]>(rest + RC * BK);
  float* row_m = rest + 2 * RC * BK;
  float* row_il = row_m + RC;
  float* row_delta = row_il + RC;
  float* row_mc = row_delta + RC;   // bf16 scores: bf16_mcorr's term
  int* row_pos = reinterpret_cast<int*>(row_mc + RC);
  float(*qsl)[WIDE_DV] =
      reinterpret_cast<float(*)[WIDE_DV]>(rest + 2 * RC * BK + 5 * RC);
  float(*dosl)[WIDE_DV] = reinterpret_cast<float(*)[WIDE_DV]>(
      rest + 2 * RC * BK + 5 * RC + RC * WIDE_DV);

  const int c0 = (blockIdx.x % n_slices) * WIDE_DV;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv, n_rows = G * Sq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nthreads = 32 * KWARPS;
  const size_t n_stats = static_cast<size_t>(B) * Hq * Sq;
  q_offset = offset_of(q_offset, ex.off);
  // the CTA's key tile: the cache's first (none with skip0), then the
  // second source's
  const int n0t = ex.skip0 ? 0 : (Skv + BK - 1) / BK;
  const int tile = static_cast<int>(blockIdx.x) / n_slices;
  const int si = tile >= n0t, k0 = (si ? tile - n0t : tile) * BK;
  const Src<T> sr = src_of<T>(si, k, v, kv_valid, Skv, ex, q_offset);
  if (si) {
    dk = ex.dk2;
    dv = ex.dv2;
  }
  const int gk = k0 + lane;
  const bool in_range = gk < sr.n;
  const bool valid = key_ok(sr.valid, b, sr.n, gk);

  float adk[NC], adv[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) adk[c] = adv[c] = 0.f;
  int rows[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) rows[i] = warp + KWARPS * i;

  // rows t = g * Sq + pos of the group: q head hk * G + g at position pos
  for (int t0 = 0; t0 < n_rows; t0 += RC) {
    auto row_off = [&](int r) -> long long {
      const int t = t0 + r;
      return t < n_rows ? ((static_cast<long long>(b) * Sq + t % Sq) * Hq +
                           hk * G + t / Sq) * D
                        : -1;
    };
    float s[RW], dp[RW];
    wide_s_dp<T, RW>(q, dout, ex, sr, row_off, b, k0, hk, Hkv, D, tid,
                     nthreads, rows, smem_wk, s, dp, bs);
    // the chunk's statistics and its rows' slice columns (the previous
    // chunk's were read before wide_s_dp's first barrier)
    if (tid < RC) {
      const int t = t0 + tid;
      if (t < n_rows) {
        const int hh = hk * G + t / Sq, pos = t % Sq;
        const size_t si = (static_cast<size_t>(b) * Hq + hh) * Sq + pos;
        row_m[tid] = stats[si];
        row_il[tid] = 1.f / fmaxf(stats[n_stats + si], 1e-30f);
        row_delta[tid] = stats[2 * n_stats + si];
        row_mc[tid] = bs ? stats[3 * n_stats + si] : 0.f;
        row_pos[tid] = q_offset + pos;
      } else {               // a row past the last: p = 0, ds = 0
        row_m[tid] = 0.f;
        row_il[tid] = 0.f;
        row_delta[tid] = 0.f;
        row_mc[tid] = 0.f;
        row_pos[tid] = 0;
      }
    }
    for (int e = tid; e < RC * WIDE_DV; e += nthreads) {
      const int r = e / WIDE_DV, dd = c0 + e % WIDE_DV;
      const long long o = row_off(r);
      float x = 0.f, g = 0.f;
      if (o >= 0 && dd < D) {
        x = two_terms(q, ex.q_lo, o + dd);
        g = two_terms(dout, ex.dout_lo, o + dd);
      }
      qsl[r][e % WIDE_DV] = x;
      dosl[r][e % WIDE_DV] = g;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = rows[i];
      const bool ok =
          valid && in_reach(row_pos[r], sr.pos0 + gk, window, causal);
      if (bs) {
        const float pu =
            in_range ? bf16_p(ok ? bf16r(s[i]) : NEG_BF16, row_m[r]) : 0.f;
        ps[r][lane] = pu * row_il[r];
        dss[r][lane] = ok && in_range
            ? bf16_ds_m(s[i], row_m[r], dp[i], row_il[r], row_delta[r],
                        row_mc[r])
            : 0.f;
      } else {
        const float p =
            in_range ? expf((ok ? s[i] * scale : NEG) - row_m[r]) * row_il[r]
                     : 0.f;
        ps[r][lane] = p;
        dss[r][lane] = ok && in_range ? p * (dp[i] - row_delta[r]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < RC; ++r) {
      const float pr = ps[r][lane], dsr = dss[r][lane];
#pragma unroll
      for (int c = 0; c < NC; c += 4) {
        const float4 g4 = *reinterpret_cast<const float4*>(&dosl[r][warp * NC + c]);
        const float4 q4 = *reinterpret_cast<const float4*>(&qsl[r][warp * NC + c]);
        adv[c] = fmaf(pr, g4.x, adv[c]);
        adv[c + 1] = fmaf(pr, g4.y, adv[c + 1]);
        adv[c + 2] = fmaf(pr, g4.z, adv[c + 2]);
        adv[c + 3] = fmaf(pr, g4.w, adv[c + 3]);
        adk[c] = fmaf(dsr, q4.x, adk[c]);
        adk[c + 1] = fmaf(dsr, q4.y, adk[c + 1]);
        adk[c + 2] = fmaf(dsr, q4.z, adk[c + 2]);
        adk[c + 3] = fmaf(dsr, q4.w, adk[c + 3]);
      }
    }
  }

  if (!in_range) return;
  const size_t row = ((static_cast<size_t>(b) * sr.n + gk) * Hkv + hk) * D;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int dd = c0 + warp * NC + c;
    if (dd < D) {
      dk[row + dd] = from_f32<T>(bs ? bf16r(adk[c]) : adk[c] * scale);
      dv[row + dd] = from_f32<T>(bs ? bf16r(adv[c]) : adv[c]);
    }
  }
}

template <typename T>
cudaError_t launch_wide(const T* q, const T* k, const T* v, const T* dout,
                        const unsigned char* kv_valid, T* dq, T* dk, T* dv,
                        float* stats, int B, int Sq, int Skv, int Hq,
                        int Hkv, int D, float scale, int window,
                        int q_offset, int causal, int bs, const Ext<T>& ex,
                        cudaStream_t stream) {
  static const cudaError_t attr_st = cudaFuncSetAttribute(
      flash_bidir_bwd_stats_wide<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, wide_stats_smem_bytes());
  if (attr_st != cudaSuccess) return attr_st;
  static const cudaError_t attr_dq = cudaFuncSetAttribute(
      flash_bidir_bwd_dq_wide<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, wide_dq_smem_bytes());
  if (attr_dq != cudaSuccess) return attr_dq;
  static const cudaError_t attr_dkv = cudaFuncSetAttribute(
      flash_bidir_bwd_dkv_wide<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, wide_dkv_smem_bytes());
  if (attr_dkv != cudaSuccess) return attr_dkv;
  const int n_slices = (D + WIDE_DV - 1) / WIDE_DV;
  const int n_qt = (Sq + BQ - 1) / BQ;
  flash_bidir_bwd_stats_wide<T>
      <<<dim3(n_qt, Hq, B), 32 * QWARPS, wide_stats_smem_bytes(), stream>>>(
          q, k, v, dout, kv_valid, stats, B, Sq, Skv, Hq, Hkv, D, scale,
          window, q_offset, causal, bs, ex);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bidir_bwd_dq_wide<T><<<dim3(n_qt * n_slices, Hq, B), 32 * QWARPS,
                               wide_dq_smem_bytes(), stream>>>(
      q, k, v, dout, kv_valid, stats, dq, B, Sq, Skv, Hq, Hkv, D, scale,
      window, q_offset, causal, n_slices, bs, ex);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n0t = ex.skip0 ? 0 : (Skv + BK - 1) / BK;
  const int n1t = ex.dk2 != nullptr ? (ex.S2 + BK - 1) / BK : 0;
  if (n0t + n1t == 0) return cudaSuccess;
  flash_bidir_bwd_dkv_wide<T>
      <<<dim3((n0t + n1t) * n_slices, Hkv, B), 32 * KWARPS,
          wide_dkv_smem_bytes(), stream>>>(
          q, k, v, dout, kv_valid, stats, dk, dv, B, Sq, Skv, Hq, Hkv, D,
          scale, window, q_offset, causal, n_slices, bs, ex);
  return cudaGetLastError();
}

// The tile width a head dim up to 256 runs in: the smallest of 32, 64,
// 128, 256 that holds it (0: D past 256, the wide route's).
int tile_of(int D) {
  if (D < 1 || D > 256) return 0;
  return D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256;
}

// The CUDA-core routes of element type T.
template <typename T>
cudaError_t dispatch_cc(const T* q, const T* k, const T* v, const T* dout,
                        const unsigned char* kv_valid, T* dq, T* dk, T* dv,
                        float* stats, int B, int Sq, int Skv, int Hq,
                        int Hkv, int D, float scale, int window,
                        int q_offset, int causal, int bs, const Ext<T>& ex,
                        cudaStream_t stream) {
#define FBB_ARGS                                                            \
  (q, k, v, dout, kv_valid, dq, dk, dv, stats, B, Sq, Skv, Hq, Hkv, D,      \
   scale, window, q_offset, causal, bs, ex, stream)
  switch (tile_of(D)) {
    case 32: return launch_cc<T, 1> FBB_ARGS;
    case 64: return launch_cc<T, 2> FBB_ARGS;
    case 128: return launch_cc<T, 4> FBB_ARGS;
    case 256: return launch_cc<T, 8> FBB_ARGS;
    default: return launch_wide<T> FBB_ARGS;
  }
#undef FBB_ARGS
}

}  // namespace

// The cached forward's part of a launch (kernels/flash_bidir.py _Extra
// mirrors it field by field); null for the cache-less backward.
struct BwdExtra {
  int baos;                   // BAOS: q * f_k in, out * f_v + c_v out
  const void* fk;             // (B, Hkv, D) f32, or null (1)
  const void* fv;             // (B, Hkv, D) f32, or null (1)
  const void* o_s;            // the uncorrected output (q's size and dtype),
                              //   read for df_v
  void* dfk;                  // (B, Hkv, D) f32 outputs, each may be null
  void* dfv;
  void* dcv;
  void* q_hi;                 // scratches of q's size and dtype for the
  void* q_lo;                 //   terms of q * f_k and dO * f_v (the _lo
  void* d_hi;                 //   pair bf16 only)
  void* d_lo;
  void* dq32;                 // f32 scratch of q's size: dq of q * f_k
  const void* k2;             // route B's second source (B, S2, Hkv, D),
  const void* v2;             //   q's dtype, and valid2 (B, S2) bool or
  const void* valid2;         //   null; S2 = 0: none
  int S2;
  void* dk2;                  // its gradients (null: not wanted)
  void* dv2;
  void* part2;                // its split partials (n_split > 1)
  int skip0;                  // the cache's dk/dv not wanted
  const void* q_offset_dev;   // the query offset as an int64, or null
};

namespace {

template <typename T>
Ext<T> ext_of(const BwdExtra* x, bool bs) {
  if (x == nullptr) return Ext<T>{};
  const bool baos = x->baos != 0;
  return Ext<T>{static_cast<const T*>(x->k2), static_cast<const T*>(x->v2),
                static_cast<const unsigned char*>(x->valid2),
                x->k2 != nullptr ? x->S2 : 0, static_cast<T*>(x->dk2),
                static_cast<T*>(x->dv2), static_cast<float*>(x->part2),
                x->skip0,
                baos && !bs ? static_cast<const T*>(x->q_lo) : nullptr,
                baos ? static_cast<const T*>(x->d_lo) : nullptr,
                baos ? static_cast<float*>(x->dq32) : nullptr,
                static_cast<const long long*>(x->q_offset_dev)};
}

// BAOS's first kernel (the terms of q * f_k and dO * f_v) and its last
// (dq and the calibration's gradients), around the others.
template <typename T>
cudaError_t baos_prep(const T* q, const T* dout, const BwdExtra& x, int B,
                      int Sq, int Hq, int Hkv, int D, float scale, int bs,
                      cudaStream_t st) {
  const long long n = static_cast<long long>(B) * Sq * Hq * D;
  flash_bidir_bwd_baos_prep<T><<<static_cast<unsigned>((n + 1023) / 1024),
                                 256, 0, st>>>(
      q, dout, static_cast<const float*>(x.fk),
      static_cast<const float*>(x.fv), static_cast<T*>(x.q_hi),
      bs ? nullptr : static_cast<T*>(x.q_lo), static_cast<T*>(x.d_hi),
      static_cast<T*>(x.d_lo), n, Sq, Hq, Hkv, D, scale, bs);
  return cudaGetLastError();
}

template <typename T>
cudaError_t baos_sums(const T* q, const T* dout, T* dq, const BwdExtra& x,
                      int B, int Sq, int Hq, int Hkv, int D,
                      cudaStream_t st) {
  flash_bidir_bwd_baos_sums<T><<<dim3((D + 31) / 32, Hkv, B), 32 * SUM_WARPS,
                                 0, st>>>(
      q, dout, static_cast<const T*>(x.o_s),
      static_cast<const float*>(x.dq32), static_cast<const float*>(x.fk), dq,
      static_cast<float*>(x.dfk), static_cast<float*>(x.dfv),
      static_cast<float*>(x.dcv), Sq, Hq, Hkv, D);
  return cudaGetLastError();
}

}  // namespace

// q, dout, dq (B, Sq, Hq, D) and k, v, dk, dv (B, Skv, Hkv, D), all f32
// (is_bf16 = 0) or all bf16, contiguous; any D >= 1; kv_valid (B, Skv)
// bool or null.  scale is D^-1/2 as the forward took
// it; window <= 0 means no window; query row r sits at position
// q_offset + r; causal != 0 masks keys past each row's position.
// stats: an f32 scratch, 3 * B * Hkv * NR floats on the tensor-core route
// (NR = G * Sq rounded up to 4), 3 * B * Hq * Sq on the CUDA-core and wide
// routes, 4 in place of 3 with bf16 scores; written by the first kernel,
// read by the others.  Tensor-core
// route only (bf16, D a multiple of 8 up to 256): dq_warps (1 to
// the tile's most, 16 rows each) a dq CTA's warps; the G * Sq rows of a
// group cut into n_split blocks of split_rows (a multiple of 32, the last
// block not empty); part an f32 scratch of 2 * n_split * B * Skv * Hkv * D
// floats when n_split > 1 (else may be null).  kernels/flash_bidir.bwd_plan
// chooses them (bf16 scores and BAOS: the MASKED plan, BAOS's with two
// terms).  bf16_scores != 0: JAX's bf16 scores; scale is then D^-1/2
// rounded to q's dtype, and qg a scratch of q's size and dtype that kernel
// 0 (flash_bidir_bwd_qscale) fills with bf16(q * scale) for the others to
// read in place of q.  ext (null: none): BAOS, route B's second source
// and the device offset (BwdExtra); with BAOS kernel 0 is
// flash_bidir_bwd_baos_prep (qg not read) and the last
// flash_bidir_bwd_baos_sums, which writes dq.
extern "C" int flash_bidir_bwd_launch(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* kv_valid,
                                      void* dq, void* dk, void* dv,
                                      void* stats, void* part, void* qg,
                                      int B, int Sq, int Skv, int Hq,
                                      int Hkv, int D, float scale,
                                      int window, int q_offset, int causal,
                                      int is_bf16, int bf16_scores,
                                      int dq_warps, int n_split,
                                      int split_rows, const void* ext,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* valid = static_cast<const unsigned char*>(kv_valid);
  auto* sc = static_cast<float*>(stats);
  const auto* x = static_cast<const BwdExtra*>(ext);
  const bool baos = x != nullptr && x->baos != 0;
  const int bs = bf16_scores != 0;
  const void* q0 = q;          // q and dO as given (BAOS's sums read them)
  const void* dout0 = dout;
  if (D < 1 || (bs && !baos && qg == nullptr) ||
      (baos && (x->q_hi == nullptr || x->d_hi == nullptr ||
                x->dq32 == nullptr ||
                (is_bf16 && (x->d_lo == nullptr ||
                             (!bs && x->q_lo == nullptr))) ||
                (x->dfv != nullptr && x->o_s == nullptr))) ||
      (x != nullptr && x->k2 != nullptr &&
       (x->v2 == nullptr || x->S2 < 1 ||
        (x->dk2 == nullptr) != (x->dv2 == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (baos) {
    const cudaError_t err =
        is_bf16 ? baos_prep<bf16>(static_cast<const bf16*>(q),
                                  static_cast<const bf16*>(dout), *x, B, Sq,
                                  Hq, Hkv, D, scale, bs, st)
                : baos_prep<float>(static_cast<const float*>(q),
                                   static_cast<const float*>(dout), *x, B, Sq,
                                   Hq, Hkv, D, scale, bs, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    q = x->q_hi;
    dout = x->d_hi;
  } else if (bs) {
    const long long n = static_cast<long long>(B) * Sq * Hq * D;
    const unsigned grid = static_cast<unsigned>((n + 1023) / 1024);
    if (is_bf16)
      flash_bidir_bwd_qscale<bf16><<<grid, 256, 0, st>>>(
          static_cast<const bf16*>(q), static_cast<bf16*>(qg), n, scale);
    else
      flash_bidir_bwd_qscale<float><<<grid, 256, 0, st>>>(
          static_cast<const float*>(q), static_cast<float*>(qg), n, scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    q = qg;
  }
  cudaError_t err;
  if (is_bf16 && (D % 8 != 0 || tile_of(D) == 0)) {
    err = dispatch_cc<bf16>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), valid,
        static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
        sc, B, Sq, Skv, Hq, Hkv, D, scale, window, q_offset, causal, bs,
        ext_of<bf16>(x, bs), st);
  } else if (is_bf16) {
    const Ext<bf16> ex = ext_of<bf16>(x, bs);
#define FBB_TC_AS(DT, M, BS, QT)                                            \
  launch_tc<DT, M, BS, QT>(                                                 \
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),             \
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), valid,   \
      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),\
      sc, static_cast<float*>(part), B, Sq, Skv, Hq, Hkv, D, scale, window, \
      q_offset, causal, dq_warps, n_split, split_rows, ex, st)
#define FBB_TC(DT)                                                          \
  err = baos ? (bs ? FBB_TC_AS(DT, true, true, 2)                           \
                   : FBB_TC_AS(DT, true, false, 2))                         \
        : bs ? FBB_TC_AS(DT, true, true, 1)                                 \
        : masked ? FBB_TC_AS(DT, true, false, 1)                            \
                 : FBB_TC_AS(DT, false, false, 1);                          \
  break
    // MASKED: a mask can hide a key (kv_valid of either source, a window
    // or causal); the other instantiations test only a key's place in the
    // last tile.  bf16 scores and BAOS take the MASKED walk whatever the
    // masks.
    const bool masked = valid != nullptr || ex.valid2 != nullptr ||
                        window > 0 || causal;
    switch (tile_of(D)) {
      case 32: FBB_TC(32);
      case 64: FBB_TC(64);
      case 128: FBB_TC(128);
      default: FBB_TC(256);
    }
#undef FBB_TC
#undef FBB_TC_AS
  } else {
    err = dispatch_cc<float>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), valid,
        static_cast<float*>(dq), static_cast<float*>(dk),
        static_cast<float*>(dv), sc, B, Sq, Skv, Hq, Hkv, D, scale, window,
        q_offset, causal, bs, ext_of<float>(x, bs), st);
  }
  if (err != cudaSuccess || !baos) return static_cast<int>(err);
  err = is_bf16 ? baos_sums<bf16>(static_cast<const bf16*>(q0),
                                  static_cast<const bf16*>(dout0),
                                  static_cast<bf16*>(dq), *x, B, Sq, Hq, Hkv,
                                  D, st)
                : baos_sums<float>(static_cast<const float*>(q0),
                                   static_cast<const float*>(dout0),
                                   static_cast<float*>(dq), *x, B, Sq, Hq,
                                   Hkv, D, st);
  return static_cast<int>(err);
}

namespace {
// every instantiation the entry point above launches, with the dynamic
// shared memory of its largest launch (a dq CTA at its most warps)
const KernelAttr ATTRS[] = {
    KERNEL_ATTR((flash_bidir_bwd_dq<float, 1>), dq_smem_bytes(32)),
    KERNEL_ATTR((flash_bidir_bwd_dkv<float, 1>), dkv_smem_bytes(32)),
    KERNEL_ATTR((flash_bidir_bwd_dq<float, 2>), dq_smem_bytes(64)),
    KERNEL_ATTR((flash_bidir_bwd_dkv<float, 2>), dkv_smem_bytes(64)),
    KERNEL_ATTR((flash_bidir_bwd_dq<float, 4>), dq_smem_bytes(128)),
    KERNEL_ATTR((flash_bidir_bwd_dkv<float, 4>), dkv_smem_bytes(128)),
    KERNEL_ATTR((flash_bidir_bwd_dq<float, 8>), dq_smem_bytes(256)),
    KERNEL_ATTR((flash_bidir_bwd_dkv<float, 8>), dkv_smem_bytes(256)),
    KERNEL_ATTR((flash_bidir_bwd_dq<bf16, 1>), dq_smem_bytes(32)),
    KERNEL_ATTR((flash_bidir_bwd_dkv<bf16, 1>), dkv_smem_bytes(32)),
    KERNEL_ATTR((flash_bidir_bwd_dq<bf16, 2>), dq_smem_bytes(64)),
    KERNEL_ATTR((flash_bidir_bwd_dkv<bf16, 2>), dkv_smem_bytes(64)),
    KERNEL_ATTR((flash_bidir_bwd_dq<bf16, 4>), dq_smem_bytes(128)),
    KERNEL_ATTR((flash_bidir_bwd_dkv<bf16, 4>), dkv_smem_bytes(128)),
    KERNEL_ATTR((flash_bidir_bwd_dq<bf16, 8>), dq_smem_bytes(256)),
    KERNEL_ATTR((flash_bidir_bwd_dkv<bf16, 8>), dkv_smem_bytes(256)),
    KERNEL_ATTR(flash_bidir_bwd_stats_wide<float>, wide_stats_smem_bytes()),
    KERNEL_ATTR(flash_bidir_bwd_dq_wide<float>, wide_dq_smem_bytes()),
    KERNEL_ATTR(flash_bidir_bwd_dkv_wide<float>, wide_dkv_smem_bytes()),
    KERNEL_ATTR(flash_bidir_bwd_stats_wide<bf16>, wide_stats_smem_bytes()),
    KERNEL_ATTR(flash_bidir_bwd_dq_wide<bf16>, wide_dq_smem_bytes()),
    KERNEL_ATTR(flash_bidir_bwd_dkv_wide<bf16>, wide_dkv_smem_bytes()),
    KERNEL_ATTR(flash_bidir_bwd_dq_tc<32>,
                dq_tc_smem_bytes(32, false, dq_tc_max_warps(32, false))),
    KERNEL_ATTR(flash_bidir_bwd_dkv_tc<32>, dkv_tc_smem_bytes(32)),
    KERNEL_ATTR((flash_bidir_bwd_dq_tc<32, true>),
                dq_tc_smem_bytes(32, true, dq_tc_max_warps(32, true))),
    KERNEL_ATTR((flash_bidir_bwd_dkv_tc<32, true>), dkv_tc_smem_bytes(32)),
    KERNEL_ATTR(flash_bidir_bwd_dq_tc<64>,
                dq_tc_smem_bytes(64, false, dq_tc_max_warps(64, false))),
    KERNEL_ATTR(flash_bidir_bwd_dkv_tc<64>, dkv_tc_smem_bytes(64)),
    KERNEL_ATTR((flash_bidir_bwd_dq_tc<64, true>),
                dq_tc_smem_bytes(64, true, dq_tc_max_warps(64, true))),
    KERNEL_ATTR((flash_bidir_bwd_dkv_tc<64, true>), dkv_tc_smem_bytes(64)),
    KERNEL_ATTR(flash_bidir_bwd_dq_tc<128>,
                dq_tc_smem_bytes(128, false, dq_tc_max_warps(128, false))),
    KERNEL_ATTR(flash_bidir_bwd_dkv_tc<128>, dkv_tc_smem_bytes(128)),
    KERNEL_ATTR((flash_bidir_bwd_dq_tc<128, true>),
                dq_tc_smem_bytes(128, true, dq_tc_max_warps(128, true))),
    KERNEL_ATTR((flash_bidir_bwd_dkv_tc<128, true>), dkv_tc_smem_bytes(128)),
    KERNEL_ATTR(flash_bidir_bwd_dq_tc<256>,
                dq_tc_smem_bytes(256, false, dq_tc_max_warps(256, false))),
    KERNEL_ATTR(flash_bidir_bwd_dkv_tc<256>, dkv_tc_smem_bytes(256)),
    KERNEL_ATTR((flash_bidir_bwd_dq_tc<256, true>),
                dq_tc_smem_bytes(256, true, dq_tc_max_warps(256, true))),
    KERNEL_ATTR((flash_bidir_bwd_dkv_tc<256, true>), dkv_tc_smem_bytes(256)),
    KERNEL_ATTR(flash_bidir_bwd_split_sum, 0),
    KERNEL_ATTR((flash_bidir_bwd_dq_tc<32, true, true>),
                dq_tc_smem_bytes(32, true, dq_tc_max_warps(32, true))),
    KERNEL_ATTR((flash_bidir_bwd_dkv_tc<32, true, true>),
                dkv_tc_smem_bytes(32, true)),
    KERNEL_ATTR((flash_bidir_bwd_dq_tc<64, true, true>),
                dq_tc_smem_bytes(64, true, dq_tc_max_warps(64, true))),
    KERNEL_ATTR((flash_bidir_bwd_dkv_tc<64, true, true>),
                dkv_tc_smem_bytes(64, true)),
    KERNEL_ATTR((flash_bidir_bwd_dq_tc<128, true, true>),
                dq_tc_smem_bytes(128, true, dq_tc_max_warps(128, true))),
    KERNEL_ATTR((flash_bidir_bwd_dkv_tc<128, true, true>),
                dkv_tc_smem_bytes(128, true)),
    KERNEL_ATTR((flash_bidir_bwd_dq_tc<256, true, true>),
                dq_tc_smem_bytes(256, true, dq_tc_max_warps(256, true))),
    KERNEL_ATTR((flash_bidir_bwd_dkv_tc<256, true, true>),
                dkv_tc_smem_bytes(256, true)),
    KERNEL_ATTR(flash_bidir_bwd_qscale<float>, 0),
    KERNEL_ATTR(flash_bidir_bwd_qscale<bf16>, 0),
    KERNEL_ATTR(flash_bidir_bwd_baos_prep<float>, 0),
    KERNEL_ATTR(flash_bidir_bwd_baos_prep<bf16>, 0),
    KERNEL_ATTR(flash_bidir_bwd_baos_sums<float>, 0),
    KERNEL_ATTR(flash_bidir_bwd_baos_sums<bf16>, 0),
    KERNEL_ATTR((flash_bidir_bwd_dq_tc<32, true, false, 2>),
                dq_tc_smem_bytes(32, true, dq_tc_max_warps(32, true, 2), 2)),
    KERNEL_ATTR((flash_bidir_bwd_dkv_tc<32, true, false, 2>),
                dkv_tc_smem_bytes(32, false, 2)),
    KERNEL_ATTR((flash_bidir_bwd_dq_tc<32, true, true, 2>),
                dq_tc_smem_bytes(32, true, dq_tc_max_warps(32, true, 2), 2)),
    KERNEL_ATTR((flash_bidir_bwd_dkv_tc<32, true, true, 2>),
                dkv_tc_smem_bytes(32, true, 2)),
    KERNEL_ATTR((flash_bidir_bwd_dq_tc<64, true, false, 2>),
                dq_tc_smem_bytes(64, true, dq_tc_max_warps(64, true, 2), 2)),
    KERNEL_ATTR((flash_bidir_bwd_dkv_tc<64, true, false, 2>),
                dkv_tc_smem_bytes(64, false, 2)),
    KERNEL_ATTR((flash_bidir_bwd_dq_tc<64, true, true, 2>),
                dq_tc_smem_bytes(64, true, dq_tc_max_warps(64, true, 2), 2)),
    KERNEL_ATTR((flash_bidir_bwd_dkv_tc<64, true, true, 2>),
                dkv_tc_smem_bytes(64, true, 2)),
    KERNEL_ATTR((flash_bidir_bwd_dq_tc<128, true, false, 2>),
                dq_tc_smem_bytes(128, true, dq_tc_max_warps(128, true, 2), 2)),
    KERNEL_ATTR((flash_bidir_bwd_dkv_tc<128, true, false, 2>),
                dkv_tc_smem_bytes(128, false, 2)),
    KERNEL_ATTR((flash_bidir_bwd_dq_tc<128, true, true, 2>),
                dq_tc_smem_bytes(128, true, dq_tc_max_warps(128, true, 2), 2)),
    KERNEL_ATTR((flash_bidir_bwd_dkv_tc<128, true, true, 2>),
                dkv_tc_smem_bytes(128, true, 2)),
    KERNEL_ATTR((flash_bidir_bwd_dq_tc<256, true, false, 2>),
                dq_tc_smem_bytes(256, true, dq_tc_max_warps(256, true, 2), 2)),
    KERNEL_ATTR((flash_bidir_bwd_dkv_tc<256, true, false, 2>),
                dkv_tc_smem_bytes(256, false, 2)),
    KERNEL_ATTR((flash_bidir_bwd_dq_tc<256, true, true, 2>),
                dq_tc_smem_bytes(256, true, dq_tc_max_warps(256, true, 2), 2)),
    KERNEL_ATTR((flash_bidir_bwd_dkv_tc<256, true, true, 2>),
                dkv_tc_smem_bytes(256, true, 2)),
};
}  // namespace

KERNEL_ATTR_ENTRIES(flash_bidir_bwd, ATTRS)

extern "C" const char* flash_bidir_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

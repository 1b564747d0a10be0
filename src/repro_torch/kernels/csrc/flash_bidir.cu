// Bidirectional GQA flash attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel `flash_bidir` in src/repro/kernels/flash_bidir.py,
// the twin of the model's layers.attention.  Bidirectional attention with an
// online softmax over KV tiles in f32, GQA by index (KV head = q_head // G,
// nothing repeated in memory), the BAOS fusion of the Pallas kernel
// (q * f_k * D^-1/2 on the way in, out * f_v + c_v at the end), the optional
// |q_pos - k_pos| < window mask with query row r at position q_offset + r
// (a segment of a longer cache) and key j at j, and a per-row kv_valid
// (B, Skv) mask that the Pallas kernel lacks.  With causal != 0 it is the
// JAX model's causal mode (layers._mask_bias): a key attends only where
// k_pos <= q_pos (and, with a window, q_pos - k_pos < window).  Masked
// scores are -1e30 (not -inf), so a row with no valid key averages every
// key, as the reference does; keys past Skv (the ragged last tile) get
// probability 0, so no divisibility is required.  The output divides by
// max(l, 1e-30).
//
// The query offset: a host int, or (q_offset_dev not null) an int64 in
// device memory that every CTA reads at its start, so a captured CUDA
// graph attends at each replay's block start without a host read.
//
// Key tiles out of reach: in the kernels' REACH instantiations, which the
// launcher picks unless every key is in reach of every row (reach_walk), a
// CTA walks only the tiles of each source that hold a key some query row
// of it can reach (tile_range).  A masked key adds exactly 0 once a row
// has seen one valid key (its probability exp(-1e30 - m) is 0, and the
// correction exp(-1e30 - m) clears what masked keys added before), so
// skipping them leaves such a row's sums as they were.  A row that finds
// no valid key in its reach averages every key of both sources; if the
// CTA has one, it walks every tile again from the start (the walk without
// skipping).
//
// What bounds it: at the main-path shape (B 4, S 96, H 32, D 128, bf16) one
// layer moves 12.6 MB (q, k, v, out) and does 0.6 GFLOP, so the card could
// finish it in about 4 us (bytes).
//
// bf16 route, on the tensor cores (mma.sync m16n8k16, f32 accumulate):
//   * One CTA per (q tile, KV head, batch row).  The G query heads of a KV
//     head are one tile of G * Sq rows (row r: position r / G, head
//     hk * G + r % G), so they share each K/V tile in shared memory; up to
//     8 warps of 16 rows each.  At the main shape that is 128 CTAs of 6
//     warps, one wave.
//   * K and V stream through a 3-stage cp.async ring of 32-key tiles (keys
//     past Skv zero-filled); K feeds the score product through ldmatrix,
//     V the output product through ldmatrix.trans.
//   * The Pallas kernel keeps q, k and v in f32 and runs both products in
//     f32.  Here K and V are bf16 and exact.  Without BAOS q is bf16 and
//     exact too: the score product is one bf16 product, f32-accumulated,
//     and D^-1/2 scales the f32 scores.  With BAOS, q * f_k (f32) and in
//     every case the f32 probabilities P are split into SPLIT bf16 terms
//     (x = t0 + t1 + ..., t_i = bf16(x - t0 - ... - t_(i-1))), and every
//     term runs through the tensor cores into the same f32 accumulator.
//     Three terms carry 24 bits, the f32 significand, so the products keep
//     the Pallas kernel's function.  P is the score accumulator reused as
//     the A fragment (FA2), so it never leaves registers.
//   * What bounds it on the card: the products at the mma.sync rate, three
//     of them per P tile.
//   * Online softmax per row in f32 (row max and sum over the quad),
//     out * (1 / max(l, 1e-30)) * f_v + c_v in f32, rounded once.
// f32 route, on the CUDA cores (TF32 would change its arithmetic): one CTA
// per (16-row q tile, q head, batch row), K/V tiles staged as f32 in
// dynamic shared memory, lane j scoring key j with f32 FMAs.
//
// Route B, a second K/V source (the split active-block cache of
// models/transformer.py): k2/v2 (B, S2, Hkv, D) with kv_valid2 (B, S2),
// key j of it at position q_offset + j (the active block sits at the
// refined segment's start), in the same smoothed space as the cache.  Both
// routes walk its tiles after the cache's, in the same online softmax, so
// the two sources merge exactly as the JAX model's two partials do; the
// BAOS fusion is applied once (q * f_k before, out * f_v + c_v after) and
// the output rounds once.  A tile never spans the two sources: each one's
// last tile is ragged on its own length.  Bound: the bytes of both K/V
// sources, q and out.
//
// Head dims: any D.  Both routes are instantiated for tiles of DT = 32, 64,
// 128 and 256 columns; a head dim up to 256 runs in the smallest tile
// DT >= D, its columns past D loaded as zeros by predicated loads (they
// add nothing to a score) and never stored.  bf16 takes the tensor-core
// route where D is a multiple of 8; at any other D its rows are not 16
// bytes apart, so the 16-byte cp.async loads cannot start every row, and
// it takes the CUDA-core kernel on bf16 operands (flash_bidir_kernel<bf16,
// ...>: one value a load, converted to f32 in shared memory; no padded
// copy).  D past 256 takes flash_bidir_wide_kernel (CUDA cores, f32 or
// bf16): its CTAs split the output columns into slices of 256, and each
// forms the full-D scores in chunks of 128 columns in the same order, so
// the slices of a row hold bit-identical (m, l).  D^-1/2 is the true D's on
// every route (the caller's scale).  At DT 256
// (recurrentgemma-2b) the bf16 route keeps q in shared memory as before
// and its 3-stage ring of 32-key K/V tiles takes 99 KB; beside it shared
// memory holds the query rows of 8 warps without BAOS (168 KB in all) and,
// with BAOS's three q terms a warp, of 5 (226 KB of the 227):
// tc_max_warps.  The output accumulators are 128 f32 registers a thread.
//
// bf16 scores (bf16_scores != 0; JAX's score_dtype=bfloat16): every route
// rounds where JAX's attention_partials does, scale then being D^-1/2
// rounded to the activations' dtype: the query operand is bf16(q * f_k *
// scale) (f_k and the products in f32), K and V are read as bf16 (exact
// for bf16 tensors), S = bf16(the f32 sum) without a scale, a masked score
// bf16(-1e30), P = bf16(exp(bf16(S - bf16(m)))) with m the row's running
// max (JAX's is its chunk's max: a rounding of its own), l = sum P and P V
// in f32.  The tensor-core route has BS instantiations (one q term, with
// BAOS too, rewritten in shared memory after it lands; P one exact term,
// not SPLIT: at DT 256 with BAOS 8 warps fit where SPLIT's q terms allow
// 5); the CUDA-core and wide kernels take a runtime flag, two roundings
// among their FMAs.  A masked key still adds exactly 0 once a row has
// seen a valid key (exp of about -1e30 is 0), and a row with no valid key
// keeps m = -1e30 (bf16(-1e30) lies below it), so its P is 1 on every key
// and the REACH walk's second pass finds it as before.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int BQ = 16;      // query rows per CTA
constexpr int BK = 32;      // keys per tile: one per lane
constexpr int WARPS = 4;
constexpr int RPW = BQ / WARPS;

// Dynamic shared memory of the f32 route at tile width DT, in bytes.
constexpr int f32_smem_bytes(int DT) {
  return (BQ * DT + BK * (DT + 1) + BK * DT) * 4;
}

// The K/V source of tile t of the walk: the cache's tiles, then those of
// the second source (n_t1 tiles of the first).
struct KvSrc {
  int len, t0, pos0;   // keys, first key of the tile, position of key 0
  int second;
};

__device__ __forceinline__ KvSrc kv_src(int t, int n_t1, int BKT, int Skv,
                                        int S2, int q_offset) {
  return t < n_t1 ? KvSrc{Skv, t * BKT, 0, 0}
                  : KvSrc{S2, (t - n_t1) * BKT, q_offset, 1};
}

// The tiles a CTA whose query rows sit at positions [qmin, qmax] walks:
// n1 tiles of the cache from lo1 and n2 of the second source from lo2
// (walk index i: tile lo1 + i, then n_t1 + lo2 + i - n1).  All of them
// without a window and the causal mask.
struct TileRange {
  int lo1, n1, lo2, n2;
  __device__ __forceinline__ int tile(int i, int n_t1) const {
    return i < n1 ? lo1 + i : n_t1 + lo2 + (i - n1);
  }
};

// Tiles [lo, lo + n) of BKT keys holding keys j in [jlo, jhi] of a source
// of len keys.
__device__ __forceinline__ void tiles_of(int jlo, int jhi, int len, int BKT,
                                         int& lo, int& n) {
  jlo = max(jlo, 0);
  jhi = min(jhi, len - 1);
  lo = jlo <= jhi ? jlo / BKT : 0;
  n = jlo <= jhi ? jhi / BKT - lo + 1 : 0;
}

__device__ __forceinline__ TileRange tile_range(int qmin, int qmax,
                                                int window, int causal,
                                                int Skv, int S2, int BKT,
                                                int q_offset) {
  // the key positions some row reaches: |q - k| < window, k <= q if causal
  const int far = 1 << 30;
  const int plo = window > 0 ? qmin - window + 1 : -far;
  const int phi = causal ? qmax : (window > 0 ? qmax + window - 1 : far);
  TileRange r;
  tiles_of(plo, phi, Skv, BKT, r.lo1, r.n1);
  tiles_of(plo - q_offset, phi - q_offset, S2, BKT, r.lo2, r.n2);
  return r;
}

// The offset the kernel attends at: the host's, or the int64 in device
// memory (one load, the same address for every thread of the CTA).
__device__ __forceinline__ int query_offset(int q_offset,
                                            const long long* q_offset_dev) {
  return q_offset_dev != nullptr ? static_cast<int>(__ldg(q_offset_dev))
                                 : q_offset;
}

// Whether key position kp is in reach of query position qp.
__device__ __forceinline__ bool in_reach(int qp, int kp, int window,
                                         int causal) {
  return (!causal || kp <= qp) && (window <= 0 || abs(qp - kp) < window);
}

// REACH: the walk over the tiles in reach and the reach test (see the
// top).  Without it the kernel walks every tile once; the launcher picks
// it only where every key is in reach (reach_walk).  It keeps the window's
// test all the same, written inline: without the test, or with it through
// a helper, nvcc scheduled the tile loop 8-32% slower on the H100
// (PERF.md).
template <typename T, int DPL, bool REACH = false>
__global__ void __launch_bounds__(32 * WARPS)
flash_bidir_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v,
                   const unsigned char* __restrict__ kv_valid,
                   const T* __restrict__ k2, const T* __restrict__ v2,
                   const unsigned char* __restrict__ kv_valid2, int S2,
                   const float* __restrict__ fk, const float* __restrict__ fv,
                   const float* __restrict__ cv, T* __restrict__ out, int Sq,
                   int Skv, int Hq, int Hkv, int D, float scale, int window,
                   int q_offset, const long long* __restrict__ q_offset_dev,
                   int causal, int bs) {
  constexpr int DT = 32 * DPL;   // tile width; columns >= D are zeros
  extern __shared__ __align__(16) float smem_f32[];
  float(*qs)[DT] = reinterpret_cast<float(*)[DT]>(smem_f32);
  float(*ks)[DT + 1] = reinterpret_cast<float(*)[DT + 1]>(smem_f32 + BQ * DT);
  float(*vs)[DT] = reinterpret_cast<float(*)[DT]>(
      smem_f32 + BQ * DT + BK * (DT + 1));

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t cal = (static_cast<size_t>(b) * Hkv + hk) * D;
  q_offset = query_offset(q_offset, q_offset_dev);

  for (int e = tid; e < BQ * DT; e += 32 * WARPS) {
    const int r = e / DT, dd = e % DT, gq = q0 + r;
    float x = 0.f;
    if (gq < Sq && dd < D) {
      x = to_f32(q[((static_cast<size_t>(b) * Sq + gq) * Hq + h) * D + dd]);
      if (fk != nullptr) x *= fk[cal + dd];
    }
    qs[r][dd] = bs ? bf16r(x * scale) : x * scale;
  }
  const float masked = bs ? NEG_BF16 : NEG;

  const int n_t1 = (Skv + BK - 1) / BK;
  const int n_t2 = k2 != nullptr ? (S2 + BK - 1) / BK : 0;
  // pass 0 walks the tiles in reach, pass 1 (if needed) every tile
  TileRange walk =
      REACH ? tile_range(q_offset + q0, q_offset + min(q0 + BQ, Sq) - 1,
                         window, causal, Skv, k2 != nullptr ? S2 : 0, BK,
                         q_offset)
            : TileRange{0, n_t1, 0, n_t2};
  const bool full = !REACH || (walk.n1 == n_t1 && walk.n2 == n_t2);

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll 1
  for (int pass = 0;; ++pass) {   // pass 1: every tile (see the top)
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      m[i] = NEG;
      l[i] = 0.f;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[i][j] = 0.f;
    }

    const int n_w = walk.n1 + walk.n2;
    for (int w = 0; w < n_w; ++w) {
      const KvSrc src = kv_src(REACH ? walk.tile(w, n_t1) : w, n_t1, BK, Skv,
                               S2, q_offset);
      const T* kk_src = src.second ? k2 : k;
      const T* vv_src = src.second ? v2 : v;
      const unsigned char* val = src.second ? kv_valid2 : kv_valid;
      const int k0 = src.t0;
      __syncthreads();  // previous tile fully read (and the q tile written)
      for (int e = tid; e < BK * DT; e += 32 * WARPS) {
        const int j = e / DT, dd = e % DT, gk = k0 + j;
        float kx = 0.f, vx = 0.f;
        if (gk < src.len && dd < D) {
          const size_t o =
              ((static_cast<size_t>(b) * src.len + gk) * Hkv + hk) * D + dd;
          kx = to_f32(kk_src[o]);
          vx = to_f32(vv_src[o]);
        }
        ks[j][dd] = bs ? bf16r(kx) : kx;
        vs[j][dd] = bs ? bf16r(vx) : vx;
      }
      __syncthreads();

      const int gk = k0 + lane;
      const bool in_range = gk < src.len;
      const bool valid = in_range &&
          (val == nullptr || val[static_cast<size_t>(b) * src.len + gk]);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int row = warp * RPW + i, gq = q0 + row;
        float s = 0.f;
#pragma unroll 8
        for (int dd = 0; dd < DT; ++dd) s = fmaf(qs[row][dd], ks[lane][dd], s);
        const bool ok = valid && (REACH ? in_reach(q_offset + gq,
                                                   src.pos0 + gk, window,
                                                   causal)
                                           : (window <= 0 ||
                                              abs(q_offset + gq -
                                                  (src.pos0 + gk)) < window));
        s = in_range ? (ok ? (bs ? bf16r(s) : s) : masked) : -INFINITY;
        const float m_new = fmaxf(m[i], warp_max(s));
        const float p = bs ? bf16r(expf(bf16r(s - bf16r(m_new))))
                           : expf(s - m_new);
        const float corr = expf(m[i] - m_new);
        l[i] = l[i] * corr + warp_sum(p);
        m[i] = m_new;
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[i][j] *= corr;
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) {
          const float pk = __shfl_sync(FULL_MASK, p, kk);
#pragma unroll
          for (int j = 0; j < DPL; ++j)
            acc[i][j] = fmaf(pk, vs[kk][lane + 32 * j], acc[i][j]);
        }
      }
    }
    if (full || pass == 1) break;
    bool lost = false;       // a live row with no valid key in its reach
#pragma unroll
    for (int i = 0; i < RPW; ++i)
      lost |= q0 + warp * RPW + i < Sq && m[i] == NEG;
    if (!__syncthreads_or(lost)) break;
    walk = TileRange{0, n_t1, 0, n_t2};
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int gq = q0 + warp * RPW + i;
    if (gq >= Sq) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int dd = lane + 32 * j;
      if (dd >= D) break;
      float o = acc[i][j] * inv_l;
      if (fv != nullptr) o *= fv[cal + dd];
      if (cv != nullptr) o += cv[cal + dd];
      out[((static_cast<size_t>(b) * Sq + gq) * Hq + h) * D + dd] = from_f32<T>(o);
    }
  }
}

// The CUDA-core route: f32, and bf16 at a head dim that is not a multiple
// of 8 (its rows are not 16 bytes apart, so the tensor-core route's
// 16-byte loads cannot start every row; this kernel loads one value at a
// time).
template <typename T, int DPL, bool REACH>
cudaError_t launch_cc(const T* q, const T* k, const T* v,
                      const unsigned char* kv_valid, const T* k2,
                      const T* v2, const unsigned char* kv_valid2, int S2,
                      const float* fk,
                      const float* fv, const float* cv, T* out, int B,
                      int Sq, int Skv, int Hq, int Hkv, int D, float scale,
                      int window, int q_offset, const long long* q_offset_dev,
                      int causal, int bs, cudaStream_t stream) {
  constexpr int smem = f32_smem_bytes(32 * DPL);
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bidir_kernel<T, DPL, REACH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_bidir_kernel<T, DPL, REACH><<<grid, 32 * WARPS, smem, stream>>>(
      q, k, v, kv_valid, k2, v2, kv_valid2, S2, fk, fv, cv, out, Sq, Skv, Hq,
      Hkv, D, scale, window, q_offset, q_offset_dev, causal, bs);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Head dims past 256: the CUDA-core route with the output columns split
// over CTAs
// ---------------------------------------------------------------------------

constexpr int WIDE_DV = 256;   // output columns of a CTA (8 a lane)
constexpr int WIDE_CH = 128;   // columns of one chunk of the score product

// Dynamic shared memory of a wide CTA, in bytes: a chunk of the q rows and
// of the K tile, and the CTA's columns of the V tile.
constexpr int wide_smem_bytes() {
  return (BQ * WIDE_CH + BK * (WIDE_CH + 1) + BK * WIDE_DV) * 4;
}

// One CTA per (16-row q tile, output slice, q head, batch row): blockIdx.x
// = tile * n_slices + slice, the slice's columns [256 slice, 256 slice +
// 256).  Every slice forms each row's full-D scores the same way, chunk by
// chunk of WIDE_CH columns in increasing order, each chunk's q * f_k * D^-1/2
// and K staged in f32 and summed by one FMA chain a lane (the CUDA-core
// route's arithmetic): so the slices of a row form bit-identical scores,
// hence the same running (m, l) and the same probabilities, and each
// writes its own columns of one output.  The walk, the masks and the BAOS
// fusion are the CUDA-core route's.
template <typename T, bool REACH = false>
__global__ void __launch_bounds__(32 * WARPS)
flash_bidir_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const unsigned char* __restrict__ kv_valid,
                        const T* __restrict__ k2, const T* __restrict__ v2,
                        const unsigned char* __restrict__ kv_valid2, int S2,
                        const float* __restrict__ fk,
                        const float* __restrict__ fv,
                        const float* __restrict__ cv, T* __restrict__ out,
                        int Sq, int Skv, int Hq, int Hkv, int D, float scale,
                        int window, int q_offset,
                        const long long* __restrict__ q_offset_dev,
                        int causal, int n_slices, int bs) {
  constexpr int DPL = WIDE_DV / 32;
  extern __shared__ __align__(16) float smem_wide[];
  float(*qs)[WIDE_CH] = reinterpret_cast<float(*)[WIDE_CH]>(smem_wide);
  float(*ks)[WIDE_CH + 1] =
      reinterpret_cast<float(*)[WIDE_CH + 1]>(smem_wide + BQ * WIDE_CH);
  float(*vs)[WIDE_DV] = reinterpret_cast<float(*)[WIDE_DV]>(
      smem_wide + BQ * WIDE_CH + BK * (WIDE_CH + 1));

  const int q0 = (blockIdx.x / n_slices) * BQ;
  const int c0 = (blockIdx.x % n_slices) * WIDE_DV;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t cal = (static_cast<size_t>(b) * Hkv + hk) * D;
  q_offset = query_offset(q_offset, q_offset_dev);

  const int n_t1 = (Skv + BK - 1) / BK;
  const int n_t2 = k2 != nullptr ? (S2 + BK - 1) / BK : 0;
  TileRange walk =
      REACH ? tile_range(q_offset + q0, q_offset + min(q0 + BQ, Sq) - 1,
                         window, causal, Skv, k2 != nullptr ? S2 : 0, BK,
                         q_offset)
            : TileRange{0, n_t1, 0, n_t2};
  const bool full = !REACH || (walk.n1 == n_t1 && walk.n2 == n_t2);

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll 1
  for (int pass = 0;; ++pass) {   // pass 1: every tile (see the top)
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      m[i] = NEG;
      l[i] = 0.f;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[i][j] = 0.f;
    }

    const int n_w = walk.n1 + walk.n2;
    for (int w = 0; w < n_w; ++w) {
      const KvSrc src = kv_src(REACH ? walk.tile(w, n_t1) : w, n_t1, BK, Skv,
                               S2, q_offset);
      const T* kk_src = src.second ? k2 : k;
      const T* vv_src = src.second ? v2 : v;
      const unsigned char* val = src.second ? kv_valid2 : kv_valid;
      const int k0 = src.t0;
      float s[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) s[i] = 0.f;
      for (int d0 = 0; d0 < D; d0 += WIDE_CH) {
        __syncthreads();  // the previous chunk (and the previous tile) read
        for (int e = tid; e < BQ * WIDE_CH; e += 32 * WARPS) {
          const int r = e / WIDE_CH, dd = d0 + e % WIDE_CH, gq = q0 + r;
          float x = 0.f;
          if (gq < Sq && dd < D) {
            x = to_f32(q[((static_cast<size_t>(b) * Sq + gq) * Hq + h) * D + dd]);
            if (fk != nullptr) x *= fk[cal + dd];
          }
          qs[r][e % WIDE_CH] = bs ? bf16r(x * scale) : x * scale;
        }
        for (int e = tid; e < BK * WIDE_CH; e += 32 * WARPS) {
          const int j = e / WIDE_CH, dd = d0 + e % WIDE_CH, gk = k0 + j;
          const float kx =
              gk < src.len && dd < D
                  ? to_f32(kk_src[((static_cast<size_t>(b) * src.len + gk) *
                                   Hkv + hk) * D + dd])
                  : 0.f;
          ks[j][e % WIDE_CH] = bs ? bf16r(kx) : kx;
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const int row = warp * RPW + i;
#pragma unroll 8
          for (int dd = 0; dd < WIDE_CH; ++dd)
            s[i] = fmaf(qs[row][dd], ks[lane][dd], s[i]);
        }
      }
      // this slice's columns of the V tile (the previous tile's were read
      // before the first chunk's barrier)
      for (int e = tid; e < BK * WIDE_DV; e += 32 * WARPS) {
        const int j = e / WIDE_DV, dd = c0 + e % WIDE_DV, gk = k0 + j;
        const float vx =
            gk < src.len && dd < D
                ? to_f32(vv_src[((static_cast<size_t>(b) * src.len + gk) *
                                 Hkv + hk) * D + dd])
                : 0.f;
        vs[j][e % WIDE_DV] = bs ? bf16r(vx) : vx;
      }
      __syncthreads();

      const int gk = k0 + lane;
      const bool in_range = gk < src.len;
      const bool valid = in_range &&
          (val == nullptr || val[static_cast<size_t>(b) * src.len + gk]);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int gq = q0 + warp * RPW + i;
        const bool ok = valid && (REACH ? in_reach(q_offset + gq,
                                                   src.pos0 + gk, window,
                                                   causal)
                                           : (window <= 0 ||
                                              abs(q_offset + gq -
                                                  (src.pos0 + gk)) < window));
        const float x = in_range ? (ok ? (bs ? bf16r(s[i]) : s[i])
                                       : (bs ? NEG_BF16 : NEG))
                                 : -INFINITY;
        const float m_new = fmaxf(m[i], warp_max(x));
        const float p = bs ? bf16r(expf(bf16r(x - bf16r(m_new))))
                           : expf(x - m_new);
        const float corr = expf(m[i] - m_new);
        l[i] = l[i] * corr + warp_sum(p);
        m[i] = m_new;
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[i][j] *= corr;
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) {
          const float pk = __shfl_sync(FULL_MASK, p, kk);
#pragma unroll
          for (int j = 0; j < DPL; ++j)
            acc[i][j] = fmaf(pk, vs[kk][lane + 32 * j], acc[i][j]);
        }
      }
    }
    if (full || pass == 1) break;
    bool lost = false;       // a live row with no valid key in its reach
#pragma unroll
    for (int i = 0; i < RPW; ++i)
      lost |= q0 + warp * RPW + i < Sq && m[i] == NEG;
    if (!__syncthreads_or(lost)) break;
    walk = TileRange{0, n_t1, 0, n_t2};
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int gq = q0 + warp * RPW + i;
    if (gq >= Sq) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int dd = c0 + lane + 32 * j;
      if (dd >= D) break;
      float o = acc[i][j] * inv_l;
      if (fv != nullptr) o *= fv[cal + dd];
      if (cv != nullptr) o += cv[cal + dd];
      out[((static_cast<size_t>(b) * Sq + gq) * Hq + h) * D + dd] = from_f32<T>(o);
    }
  }
}

template <typename T, bool REACH>
cudaError_t launch_wide(const T* q, const T* k, const T* v,
                        const unsigned char* kv_valid, const T* k2,
                        const T* v2, const unsigned char* kv_valid2, int S2,
                        const float* fk, const float* fv, const float* cv,
                        T* out, int B, int Sq, int Skv, int Hq, int Hkv,
                        int D, float scale, int window, int q_offset,
                        const long long* q_offset_dev, int causal, int bs,
                        cudaStream_t stream) {
  constexpr int smem = wide_smem_bytes();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bidir_wide_kernel<T, REACH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const int n_slices = (D + WIDE_DV - 1) / WIDE_DV;
  const dim3 grid((Sq + BQ - 1) / BQ * n_slices, Hq, B);
  flash_bidir_wide_kernel<T, REACH><<<grid, 32 * WARPS, smem, stream>>>(
      q, k, v, kv_valid, k2, v2, kv_valid2, S2, fk, fv, cv, out, Sq, Skv, Hq,
      Hkv, D, scale, window, q_offset, q_offset_dev, causal, n_slices, bs);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores, split-bf16 operands
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int TC_BKV = 32;       // keys per stage
constexpr int TC_STAGES = 3;
constexpr int TC_MAX_WARPS = 8;  // 16 query rows each
constexpr int SPLIT = 3;         // bf16 terms of an f32 operand

// The next split term of (x0, x1) as one bf16x2 register; x0, x1 keep the
// residual (exact in f32).
__device__ __forceinline__ uint32_t split_term(float& x0, float& x1) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(x0, x1);
  x0 -= __low2float(t);
  x1 -= __high2float(t);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// Dynamic shared memory of one CTA of `warps` warps with QS terms of q at
// tile width DT, in bytes: the K and V rings, each warp's q terms and the
// three BAOS vectors.
template <int DT, int QS>
constexpr int tc_smem_bytes(int warps) {
  return (2 * TC_STAGES * TC_BKV + warps * QS * 16) * (DT + 8) * 2 + 3 * DT * 4;
}

// The most warps a CTA takes at tile width DT with QS q terms: TC_MAX_WARPS,
// or fewer where their q rows would not fit the 227 KB of shared memory.
template <int DT, int QS>
constexpr int tc_max_warps() {
  int w = TC_MAX_WARPS;
  while (w > 1 && tc_smem_bytes<DT, QS>(w) > 232448) --w;
  return w;
}

// QS is the number of bf16 terms of the query operand: 1 without BAOS (q is
// bf16 and exact, D^-1/2 scales the f32 scores), SPLIT with f_k (q * f_k
// is f32).  DT is the tile width, D <= DT the head dim: columns past D are
// loaded as zeros and not stored.  REACH as in the CUDA-core route.  BS
// (with QS 1): bf16 scores -- the query operand is bf16(q * f_k * D^-1/2),
// rewritten in place, S is rounded to bf16 from the f32 accumulator, P =
// bf16(exp(bf16(S - bf16(m)))) enters P V as one term.
template <int DT, int QS, bool REACH = false, bool BS = false>
__global__ void __launch_bounds__(32 * TC_MAX_WARPS, 1)
flash_bidir_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const unsigned char* __restrict__ kv_valid,
                      const bf16* __restrict__ k2,
                      const bf16* __restrict__ v2,
                      const unsigned char* __restrict__ kv_valid2, int S2,
                      const float* __restrict__ fk,
                      const float* __restrict__ fv,
                      const float* __restrict__ cv, bf16* __restrict__ out,
                      int Sq, int Skv, int Hq, int Hkv, int D, float scale,
                      int window, int q_offset,
                      const long long* __restrict__ q_offset_dev, int causal) {
  constexpr int DP = DT + 8;     // shared rows padded by 16 bytes: ldmatrix's
  //                                eight row addresses hit eight bank groups
  constexpr int KT = DT / 16;    // depth steps of the score product
  constexpr int NT = DT / 8;     // 8-column tiles of the output
  constexpr int KV_STAGE = TC_BKV * DP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);    // [STAGES][BKV][DP]
  bf16* vs = ks + TC_STAGES * KV_STAGE;            // [STAGES][BKV][DP]
  bf16* qs = vs + TC_STAGES * KV_STAGE;            // [warps][QS][16][DP]

  const int G = Hq / Hkv, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3, nwarps = blockDim.x >> 5;
  const int n_rows = G * Sq;
  const int row0 = (blockIdx.x * nwarps + warp) * 16;
  const size_t cal = (static_cast<size_t>(b) * Hkv + hk) * D;
  const int n_t1 = (Skv + TC_BKV - 1) / TC_BKV;
  const int n_t2 = k2 != nullptr ? (S2 + TC_BKV - 1) / TC_BKV : 0;
  float* cals = reinterpret_cast<float*>(qs + nwarps * QS * 16 * DP);
  //                                                 [3][DT]: f_k, f_v, c_v
  q_offset = query_offset(q_offset, q_offset_dev);
  // the CTA's rows [r_lo, r_hi] sit at positions q_offset + row / G
  const int r_lo = blockIdx.x * nwarps * 16;
  const int r_hi = min(r_lo + nwarps * 16, n_rows) - 1;
  // pass 0 walks the tiles in reach, pass 1 (if needed) every tile
  TileRange walk =
      REACH ? tile_range(q_offset + r_lo / G, q_offset + r_hi / G, window,
                         causal, Skv, k2 != nullptr ? S2 : 0, TC_BKV,
                         q_offset)
            : TileRange{0, n_t1, 0, n_t2};
  const bool full = !REACH || (walk.n1 == n_t1 && walk.n2 == n_t2);
  // walk index w: tile w of the sources without REACH
  auto tile = [&](int w) { return REACH ? walk.tile(w, n_t1) : w; };

  // walk index w into ring slot w % TC_STAGES, tile t of the sources
  auto load_kv = [&](int w, int t) {
    bf16* kd = ks + (w % TC_STAGES) * KV_STAGE;
    bf16* vd = vs + (w % TC_STAGES) * KV_STAGE;
    const KvSrc src = kv_src(t, n_t1, TC_BKV, Skv, S2, q_offset);
    const bf16* kk_src = src.second ? k2 : k;
    const bf16* vv_src = src.second ? v2 : v;
    for (int e = tid; e < TC_BKV * (DT / 8); e += blockDim.x) {
      const int j = e / (DT / 8), dc = (e % (DT / 8)) * 8, key = src.t0 + j;
      const bool ok = key < src.len && dc < D;
      const size_t o =
          ok ? ((static_cast<size_t>(b) * src.len + key) * Hkv + hk) * D + dc
             : 0;
      cp_async_16(smem_addr(kd + j * DP + dc), kk_src + o, ok);
      cp_async_16(smem_addr(vd + j * DP + dc), vv_src + o, ok);
    }
  };

  // group 0: this warp's 16 q rows (raw, into the slot of term 0; rows past
  // G * Sq and columns past D zero-filled), the BAOS vectors and the first
  // K/V tile of pass 0's walk
  bf16* qw = qs + warp * QS * 16 * DP;
#pragma unroll
  for (int e = lane; e < 16 * (DT / 8); e += 32) {
    const int r = e / (DT / 8), dc = (e % (DT / 8)) * 8, row = row0 + r;
    const bool ok = row < n_rows && dc < D;
    const size_t o =
        ok ? ((static_cast<size_t>(b) * Sq + row / G) * Hq + hk * G + row % G)
                 * D + dc
           : 0;
    cp_async_16(smem_addr(qw + r * DP + dc), q + o, ok);
  }
  if (warp == 0)
    for (int e = lane; e < 3 * (DT / 4); e += 32) {
      const float* src = e < DT / 4 ? fk : (e < DT / 2 ? fv : cv);
      const int c4 = (e % (DT / 4)) * 4;   // columns past D: zeros, so
      if (src != nullptr)                  // q * f_k is 0 there, not NaN
        cp_async_16(smem_addr(cals + e * 4), src + cal + (c4 < D ? c4 : 0),
                    c4 < D);
    }
  // the first tiles of a walk into the ring, landed for every thread
  auto prefetch = [&]() {
#pragma unroll
    for (int s = 0; s < TC_STAGES - 1; ++s) {
      if (s < walk.n1 + walk.n2) load_kv(s, tile(s));
      cp_async_commit();
    }
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();
  };
  prefetch();

  if (BS) {
    // bf16 scores: the query operand bf16(q * f_k * D^-1/2), the products
    // in f32 (f_k only with BAOS), 8 values a lane at a time; each lane
    // rewrites the chunks it loaded
#pragma unroll
    for (int e = lane; e < 16 * (DT / 8); e += 32) {
      const int r = e / (DT / 8), dc = (e % (DT / 8)) * 8;
      uint4 raw = *reinterpret_cast<const uint4*>(qw + r * DP + dc);
      uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 pair =
            *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
        float x0 = __low2float(pair), x1 = __high2float(pair);
        if (fk != nullptr) {
          x0 *= cals[dc + 2 * i];
          x1 *= cals[dc + 2 * i + 1];
        }
        const __nv_bfloat162 t = __floats2bfloat162_rn(x0 * scale,
                                                       x1 * scale);
        w[i] = *reinterpret_cast<const uint32_t*>(&t);
      }
      *reinterpret_cast<uint4*>(qw + r * DP + dc) = raw;
    }
    __syncwarp();
  }
  if (QS > 1) {
    // q * f_k in f32 as QS bf16 terms, 8 values a lane at a time; each lane
    // rewrites the chunks it loaded
#pragma unroll
    for (int e = lane; e < 16 * (DT / 8); e += 32) {
      const int r = e / (DT / 8), dc = (e % (DT / 8)) * 8;
      const uint4 raw = *reinterpret_cast<const uint4*>(qw + r * DP + dc);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
      float x[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 pair =
            *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
        x[2 * i] = __low2float(pair) * cals[dc + 2 * i];
        x[2 * i + 1] = __high2float(pair) * cals[dc + 2 * i + 1];
      }
#pragma unroll
      for (int t = 0; t < QS; ++t) {
        uint4 term;
        term.x = split_term(x[0], x[1]);
        term.y = split_term(x[2], x[3]);
        term.z = split_term(x[4], x[5]);
        term.w = split_term(x[6], x[7]);
        *reinterpret_cast<uint4*>(qw + (t * 16 + r) * DP + dc) = term;
      }
    }
    __syncwarp();
  }

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
    orow[hh] = ((static_cast<size_t>(b) * Sq + r / G) * Hq + hk * G + r % G) * D;
  }

  float o[NT][4];
  float m[2], l[2];
#pragma unroll 1
  for (int pass = 0;; ++pass) {   // pass 1: every tile (see the top)
    if (pass == 1) prefetch();
    const int n_w = walk.n1 + walk.n2;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    m[0] = m[1] = NEG;
    l[0] = l[1] = 0.f;

    for (int w = 0; w < n_w; ++w) {
      cp_async_wait<TC_STAGES - 2>();      // walk tile w has landed
      __syncthreads();                     // ... for all, and tile w - 1 is
      //                                      no longer being read
      if (w + TC_STAGES - 1 < n_w)
        load_kv(w + TC_STAGES - 1, tile(w + TC_STAGES - 1));
      cp_async_commit();
      const bf16* kt = ks + (w % TC_STAGES) * KV_STAGE;
      const bf16* vt = vs + (w % TC_STAGES) * KV_STAGE;
      const KvSrc src = kv_src(tile(w), n_t1, TC_BKV, Skv, S2, q_offset);
      const unsigned char* val = src.second ? kv_valid2 : kv_valid;

      // kv_valid of this lane's keys (key 8j + 2c + e of the tile at 2j + e),
      // loaded without a branch here and read after the score product, so
      // the loads overlap it
      unsigned char kvv[8];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = src.t0 + 8 * j + 2 * c + e;
          kvv[2 * j + e] = val != nullptr && key < src.len
                               ? val[static_cast<size_t>(b) * src.len + key]
                               : 1;
        }

      // scores: 16 rows x 32 keys, four 8-key tiles
      float st[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t a[QS][4];
#pragma unroll
        for (int s = 0; s < QS; ++s)
          ldmatrix_x4(a[s], smem_addr(qw + (s * 16 + (lane & 15)) * DP + kk * 16
                                      + (lane >> 4) * 8));
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t bk[4];
          ldmatrix_x4(bk, smem_addr(kt + (jp * 16 + (lane & 7) + (lane >> 4) * 8)
                                    * DP + kk * 16 + ((lane >> 3) & 1) * 8));
#pragma unroll
          for (int s = QS - 1; s >= 0; --s) {      // small terms first
            mma_bf16(st[2 * jp], a[s], bk[0], bk[1]);
            mma_bf16(st[2 * jp + 1], a[s], bk[2], bk[3]);
          }
        }
      }

      // x D^-1/2 (BS: rounded to bf16, the scale already in q); masks:
      // -1e30 (BS: bf16(-1e30)) for a masked key, -inf (probability 0)
      // past the source's length
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = src.t0 + 8 * j + 2 * c + e;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const bool ok =
                kvv[2 * j + e] != 0 &&
                (REACH ? in_reach(qpos[hh], src.pos0 + key, window, causal)
                       : (window <= 0 ||
                          abs(qpos[hh] - (src.pos0 + key)) < window));
            float& x = st[j][2 * hh + e];
            x = key < src.len ? (ok ? (BS ? bf16r(x) : x * scale)
                                    : (BS ? NEG_BF16 : NEG))
                              : -INFINITY;
          }
        }

      // online softmax, each row's statistics over its quad
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = NEG;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mx = fmaxf(mx, fmaxf(st[j][2 * hh], st[j][2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 2));
        const float m_new = fmaxf(m[hh], mx);
        const float corr = expf(m[hh] - m_new);
        m[hh] = m_new;
        if (corr != 1.f) {                 // exact: most tiles keep the max
          l[hh] *= corr;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            o[n][2 * hh] *= corr;
            o[n][2 * hh + 1] *= corr;
          }
        }
        const float mb = bf16r(m_new);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = st[j][2 * hh + e];
            const float p = BS ? bf16r(expf(bf16r(x - mb))) : expf(x - m_new);
            st[j][2 * hh + e] = p;
            l[hh] += p;
          }
      }

      // out += P V: the score tile is the A fragment, 16 keys at a time (BS:
      // P is bf16, one exact term)
      constexpr int PS = BS ? 1 : SPLIT;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        float x[8] = {st[2 * kk][0], st[2 * kk][1], st[2 * kk][2],
                      st[2 * kk][3], st[2 * kk + 1][0], st[2 * kk + 1][1],
                      st[2 * kk + 1][2], st[2 * kk + 1][3]};
        uint32_t pa[PS][4];
#pragma unroll
        for (int s = 0; s < PS; ++s)
#pragma unroll
          for (int r = 0; r < 4; ++r) pa[s][r] = split_term(x[2 * r], x[2 * r + 1]);
#pragma unroll
        for (int np = 0; np < DT / 16; ++np) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, smem_addr(vt + (kk * 16 + (lane & 15)) * DP
                                          + np * 16 + (lane >> 4) * 8));
#pragma unroll
          for (int s = PS - 1; s >= 0; --s) {
            mma_bf16(o[2 * np], pa[s], bv[0], bv[1]);
            mma_bf16(o[2 * np + 1], pa[s], bv[2], bv[3]);
          }
        }
      }
    }
    if (full || pass == 1) break;
    cp_async_wait<0>();                    // the walk's trailing (empty) groups
    // m is the quad's: a live row with no valid key in its reach
    const bool lost = (live[0] && m[0] == NEG) || (live[1] && m[1] == NEG);
    if (!__syncthreads_or(lost)) break;    // also: every tile read
    walk = TileRange{0, n_t1, 0, n_t2};
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(FULL_MASK, l[hh], 1);
    l[hh] += __shfl_xor_sync(FULL_MASK, l[hh], 2);
    if (!live[hh]) continue;
    // one reciprocal per row (the CUDA-core route's rule too), not an IEEE
    // division per value
    const float inv_l = 1.f / fmaxf(l[hh], 1e-30f);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int dd = 8 * n + 2 * c;
      if (dd >= D) break;                // D is a multiple of 8
      float o0 = o[n][2 * hh] * inv_l, o1 = o[n][2 * hh + 1] * inv_l;
      if (fv != nullptr) {
        o0 = __fmul_rn(o0, cals[DT + dd]);
        o1 = __fmul_rn(o1, cals[DT + dd + 1]);
      }
      if (cv != nullptr) {
        o0 = __fadd_rn(o0, cals[2 * DT + dd]);
        o1 = __fadd_rn(o1, cals[2 * DT + dd + 1]);
      }
      *reinterpret_cast<__nv_bfloat162*>(out + orow[hh] + dd) =
          __floats2bfloat162_rn(o0, o1);
    }
  }
}

template <int DT, int QS, bool REACH, bool BS = false>
cudaError_t launch_bf16(const bf16* q, const bf16* k, const bf16* v,
                        const unsigned char* kv_valid, const bf16* k2,
                        const bf16* v2, const unsigned char* kv_valid2,
                        int S2, const float* fk,
                        const float* fv, const float* cv, bf16* out, int B,
                        int Sq, int Skv, int Hq, int Hkv, int D, float scale,
                        int window, int q_offset, const long long* q_offset_dev,
                        int causal, cudaStream_t stream) {
  constexpr int max_warps = tc_max_warps<DT, QS>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bidir_tc_kernel<DT, QS, REACH, BS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      tc_smem_bytes<DT, QS>(max_warps));
  if (attr != cudaSuccess) return attr;
  const int rows = (Hq / Hkv) * Sq;
  const int warps = rows >= 16 * max_warps ? max_warps : (rows + 15) / 16;
  const dim3 grid((rows + 16 * warps - 1) / (16 * warps), Hkv, B);
  flash_bidir_tc_kernel<DT, QS, REACH, BS>
      <<<grid, 32 * warps, tc_smem_bytes<DT, QS>(warps), stream>>>(
          q, k, v, kv_valid, k2, v2, kv_valid2, S2, fk, fv, cv, out, Sq, Skv,
          Hq, Hkv, D, scale, window, q_offset, q_offset_dev, causal);
  return cudaGetLastError();
}

// The tile width a head dim up to 256 runs in: the smallest of 32, 64,
// 128, 256 that holds it (0: D past 256, the wide kernel's).
int tile_of(int D) {
  if (D < 1 || D > 256) return 0;
  return D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256;
}

// The CUDA-core routes of element type T: D up to 256 in its tile, D past
// 256 in the wide kernel.
template <typename T>
cudaError_t dispatch_cc(int D, const T* q, const T* k, const T* v,
                        const unsigned char* kv_valid, const T* k2,
                        const T* v2, const unsigned char* kv_valid2, int S2,
                        const float* fk, const float* fv, const float* cv,
                        T* out, int B, int Sq, int Skv, int Hq, int Hkv,
                        float scale, int window, int q_offset,
                        const long long* q_offset_dev, int causal, bool reach,
                        int bs, cudaStream_t stream) {
#define FB_ARGS                                                              \
  (q, k, v, kv_valid, k2, v2, kv_valid2, S2, fk, fv, cv, out, B, Sq, Skv,    \
   Hq, Hkv, D, scale, window, q_offset, q_offset_dev, causal, bs, stream)
#define FB_LAUNCH(DPL)                                                       \
  return reach ? launch_cc<T, DPL, true> FB_ARGS                             \
               : launch_cc<T, DPL, false> FB_ARGS
  switch (tile_of(D)) {
    case 32: FB_LAUNCH(1);
    case 64: FB_LAUNCH(2);
    case 128: FB_LAUNCH(4);
    case 256: FB_LAUNCH(8);
    default:
      return reach ? launch_wide<T, true> FB_ARGS
                   : launch_wide<T, false> FB_ARGS;
  }
#undef FB_LAUNCH
#undef FB_ARGS
}

// bf16: the tensor-core route at a head dim that is a multiple of 8 up to
// 256, the CUDA-core routes at any other; bs: bf16 scores (one query term
// with BAOS too).
cudaError_t dispatch_bf16(int D, const bf16* q, const bf16* k, const bf16* v,
                          const unsigned char* kv_valid, const bf16* k2,
                          const bf16* v2, const unsigned char* kv_valid2,
                          int S2, const float* fk,
                          const float* fv, const float* cv, bf16* out, int B,
                          int Sq, int Skv, int Hq, int Hkv, float scale,
                          int window, int q_offset,
                          const long long* q_offset_dev, int causal,
                          bool reach, int bs, cudaStream_t stream) {
  if (D % 8 != 0 || tile_of(D) == 0)
    return dispatch_cc<bf16>(D, q, k, v, kv_valid, k2, v2, kv_valid2, S2, fk,
                             fv, cv, out, B, Sq, Skv, Hq, Hkv, scale, window,
                             q_offset, q_offset_dev, causal, reach, bs,
                             stream);
#define FB_LAUNCH_AS(DT, QS, R, BS)                                          \
  launch_bf16<DT, QS, R, BS>(q, k, v, kv_valid, k2, v2, kv_valid2, S2, fk,   \
                             fv, cv, out, B, Sq, Skv, Hq, Hkv, D, scale,     \
                             window, q_offset, q_offset_dev, causal, stream)
#define FB_LAUNCH(DT)                                                        \
  return bs ? (reach ? FB_LAUNCH_AS(DT, 1, true, true)                       \
                     : FB_LAUNCH_AS(DT, 1, false, true))                     \
            : fk == nullptr                                                  \
             ? (reach ? FB_LAUNCH_AS(DT, 1, true, false)                     \
                      : FB_LAUNCH_AS(DT, 1, false, false))                   \
             : (reach ? FB_LAUNCH_AS(DT, SPLIT, true, false)                 \
                      : FB_LAUNCH_AS(DT, SPLIT, false, false))
  switch (tile_of(D)) {
    case 32: FB_LAUNCH(32);
    case 64: FB_LAUNCH(64);
    case 128: FB_LAUNCH(128);
    default: FB_LAUNCH(256);
  }
#undef FB_LAUNCH
#undef FB_LAUNCH_AS
}

// Whether a launch takes the REACH instantiation: unless every key is in
// reach of every row, i.e. with the causal mask, a window and an offset
// the host cannot see, or a window that the widest distance between a
// query position and a key position (at a corner of their ranges)
// reaches.  Where this picks the plain instantiation, REACH would walk
// every tile and mask no key: the pick decides the speed alone.
bool reach_walk(int window, int causal, int q_offset, bool device_offset,
                int Sq, int Skv, int S2) {
  if (causal) return true;
  if (window <= 0) return false;
  if (device_offset) return true;
  const long long off = q_offset;
  return std::max({off + Sq - 1, Skv - 1 - off, Sq - 1LL, S2 - 1LL}) >=
         window;
}

}  // namespace

// q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D) and out (B, Sq, Hq, D), all f32
// (is_bf16 = 0) or all bf16, contiguous; any D >= 1.  kv_valid
// (B, Skv) bool and fk/fv/cv (B, Hkv, D) f32 may each be null.  scale is
// the softmax scale (D^-1/2, rounded to f32 by the caller); window <= 0
// means no window; query row r sits at position q_offset + r, where
// q_offset is read from the int64 at q_offset_dev when that is not null;
// causal != 0 masks keys past each row's position.  Route B:
// k2/v2 (B, S2, Hkv, D) of q's dtype, contiguous, a second K/V source
// whose key j sits at q_offset + j, with kv_valid2 (B, S2) bool (may be
// null); k2 null (S2 ignored): the cache alone.  bf16_scores != 0: JAX's
// bf16 scores (scale is then D^-1/2 rounded to the activations' dtype).
extern "C" int flash_bidir_launch(const void* q, const void* k, const void* v,
                                  const void* kv_valid, const void* k2,
                                  const void* v2, const void* kv_valid2,
                                  int S2, const void* fk,
                                  const void* fv, const void* cv, void* out,
                                  int B, int Sq, int Skv, int Hq, int Hkv,
                                  int D, float scale, int window, int q_offset,
                                  const void* q_offset_dev, int causal,
                                  int is_bf16, int bf16_scores,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k2 != nullptr && (v2 == nullptr || S2 < 1)) return cudaErrorInvalidValue;
  const auto* valid = static_cast<const unsigned char*>(kv_valid);
  const auto* valid2 = static_cast<const unsigned char*>(kv_valid2);
  const auto* fk_ = static_cast<const float*>(fk);
  const auto* fv_ = static_cast<const float*>(fv);
  const auto* cv_ = static_cast<const float*>(cv);
  const auto* off = static_cast<const long long*>(q_offset_dev);
  const bool reach = reach_walk(window, causal, q_offset, off != nullptr, Sq,
                                Skv, k2 != nullptr ? S2 : 0);
  if (D < 1) return cudaErrorInvalidValue;
  if (!is_bf16)
    return static_cast<int>(dispatch_cc<float>(
        D, static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), valid, static_cast<const float*>(k2),
        static_cast<const float*>(v2), valid2, S2, fk_, fv_, cv_,
        static_cast<float*>(out), B, Sq, Skv, Hq, Hkv, scale, window,
        q_offset, off, causal, reach, bf16_scores != 0, st));
  return static_cast<int>(dispatch_bf16(
      D, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), valid, static_cast<const bf16*>(k2),
      static_cast<const bf16*>(v2), valid2, S2, fk_, fv_, cv_,
      static_cast<bf16*>(out), B, Sq, Skv, Hq, Hkv, scale, window, q_offset,
      off, causal, reach, bf16_scores != 0, st));
}

namespace {
// every instantiation the entry points above launch, with the dynamic
// shared memory of its largest launch (the bf16 route's at its most warps)
const KernelAttr ATTRS[] = {
    KERNEL_ATTR((flash_bidir_kernel<float, 1>), f32_smem_bytes(32)),
    KERNEL_ATTR((flash_bidir_kernel<float, 1, true>),
                f32_smem_bytes(32)),
    KERNEL_ATTR((flash_bidir_kernel<float, 2>), f32_smem_bytes(64)),
    KERNEL_ATTR((flash_bidir_kernel<float, 2, true>),
                f32_smem_bytes(64)),
    KERNEL_ATTR((flash_bidir_kernel<float, 4>), f32_smem_bytes(128)),
    KERNEL_ATTR((flash_bidir_kernel<float, 4, true>),
                f32_smem_bytes(128)),
    KERNEL_ATTR((flash_bidir_kernel<float, 8>), f32_smem_bytes(256)),
    KERNEL_ATTR((flash_bidir_kernel<float, 8, true>),
                f32_smem_bytes(256)),
    KERNEL_ATTR((flash_bidir_kernel<bf16, 1>), f32_smem_bytes(32)),
    KERNEL_ATTR((flash_bidir_kernel<bf16, 1, true>), f32_smem_bytes(32)),
    KERNEL_ATTR((flash_bidir_kernel<bf16, 2>), f32_smem_bytes(64)),
    KERNEL_ATTR((flash_bidir_kernel<bf16, 2, true>), f32_smem_bytes(64)),
    KERNEL_ATTR((flash_bidir_kernel<bf16, 4>), f32_smem_bytes(128)),
    KERNEL_ATTR((flash_bidir_kernel<bf16, 4, true>), f32_smem_bytes(128)),
    KERNEL_ATTR((flash_bidir_kernel<bf16, 8>), f32_smem_bytes(256)),
    KERNEL_ATTR((flash_bidir_kernel<bf16, 8, true>), f32_smem_bytes(256)),
    KERNEL_ATTR((flash_bidir_wide_kernel<float>), wide_smem_bytes()),
    KERNEL_ATTR((flash_bidir_wide_kernel<float, true>), wide_smem_bytes()),
    KERNEL_ATTR((flash_bidir_wide_kernel<bf16>), wide_smem_bytes()),
    KERNEL_ATTR((flash_bidir_wide_kernel<bf16, true>), wide_smem_bytes()),
    KERNEL_ATTR((flash_bidir_tc_kernel<32, 1>),
                (tc_smem_bytes<32, 1>(tc_max_warps<32, 1>()))),
    KERNEL_ATTR((flash_bidir_tc_kernel<32, 1, true>),
                (tc_smem_bytes<32, 1>(tc_max_warps<32, 1>()))),
    KERNEL_ATTR((flash_bidir_tc_kernel<32, SPLIT>),
                (tc_smem_bytes<32, SPLIT>(tc_max_warps<32, SPLIT>()))),
    KERNEL_ATTR((flash_bidir_tc_kernel<32, SPLIT, true>),
                (tc_smem_bytes<32, SPLIT>(tc_max_warps<32, SPLIT>()))),
    KERNEL_ATTR((flash_bidir_tc_kernel<64, 1>),
                (tc_smem_bytes<64, 1>(tc_max_warps<64, 1>()))),
    KERNEL_ATTR((flash_bidir_tc_kernel<64, 1, true>),
                (tc_smem_bytes<64, 1>(tc_max_warps<64, 1>()))),
    KERNEL_ATTR((flash_bidir_tc_kernel<64, SPLIT>),
                (tc_smem_bytes<64, SPLIT>(tc_max_warps<64, SPLIT>()))),
    KERNEL_ATTR((flash_bidir_tc_kernel<64, SPLIT, true>),
                (tc_smem_bytes<64, SPLIT>(tc_max_warps<64, SPLIT>()))),
    KERNEL_ATTR((flash_bidir_tc_kernel<128, 1>),
                (tc_smem_bytes<128, 1>(tc_max_warps<128, 1>()))),
    KERNEL_ATTR((flash_bidir_tc_kernel<128, 1, true>),
                (tc_smem_bytes<128, 1>(tc_max_warps<128, 1>()))),
    KERNEL_ATTR((flash_bidir_tc_kernel<128, SPLIT>),
                (tc_smem_bytes<128, SPLIT>(tc_max_warps<128, SPLIT>()))),
    KERNEL_ATTR((flash_bidir_tc_kernel<128, SPLIT, true>),
                (tc_smem_bytes<128, SPLIT>(tc_max_warps<128, SPLIT>()))),
    KERNEL_ATTR((flash_bidir_tc_kernel<256, 1>),
                (tc_smem_bytes<256, 1>(tc_max_warps<256, 1>()))),
    KERNEL_ATTR((flash_bidir_tc_kernel<256, 1, true>),
                (tc_smem_bytes<256, 1>(tc_max_warps<256, 1>()))),
    KERNEL_ATTR((flash_bidir_tc_kernel<256, SPLIT>),
                (tc_smem_bytes<256, SPLIT>(tc_max_warps<256, SPLIT>()))),
    KERNEL_ATTR((flash_bidir_tc_kernel<256, SPLIT, true>),
                (tc_smem_bytes<256, SPLIT>(tc_max_warps<256, SPLIT>()))),
    KERNEL_ATTR((flash_bidir_tc_kernel<32, 1, false, true>),
                (tc_smem_bytes<32, 1>(tc_max_warps<32, 1>()))),
    KERNEL_ATTR((flash_bidir_tc_kernel<32, 1, true, true>),
                (tc_smem_bytes<32, 1>(tc_max_warps<32, 1>()))),
    KERNEL_ATTR((flash_bidir_tc_kernel<64, 1, false, true>),
                (tc_smem_bytes<64, 1>(tc_max_warps<64, 1>()))),
    KERNEL_ATTR((flash_bidir_tc_kernel<64, 1, true, true>),
                (tc_smem_bytes<64, 1>(tc_max_warps<64, 1>()))),
    KERNEL_ATTR((flash_bidir_tc_kernel<128, 1, false, true>),
                (tc_smem_bytes<128, 1>(tc_max_warps<128, 1>()))),
    KERNEL_ATTR((flash_bidir_tc_kernel<128, 1, true, true>),
                (tc_smem_bytes<128, 1>(tc_max_warps<128, 1>()))),
    KERNEL_ATTR((flash_bidir_tc_kernel<256, 1, false, true>),
                (tc_smem_bytes<256, 1>(tc_max_warps<256, 1>()))),
    KERNEL_ATTR((flash_bidir_tc_kernel<256, 1, true, true>),
                (tc_smem_bytes<256, 1>(tc_max_warps<256, 1>()))),
};
}  // namespace

KERNEL_ATTR_ENTRIES(flash_bidir, ATTRS)

extern "C" const char* flash_bidir_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

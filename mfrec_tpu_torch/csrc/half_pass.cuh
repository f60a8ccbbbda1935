// K1 on Hopper: one sorted-window alternating-SGD half-pass.
//
// Replaces the Pallas TPU kernel mfrec_tpu/ops/pallas_half_pass.py
// (_kernel_tloop, entered through half_pass_batch; its grid and resident
// variants _kernel and _kernel_resident compute the same batch step).
// The TPU kernel runs one batch of B ratings per call against a W-row
// window of the updated factor side, T gradient sweeps each:
//
//     fu   = bf16(win)[kl]                       exact gather of the
//                                                bf16-rounded window
//     dot  = sum_k fu*ff                         f32 (k <= 128), or the
//                                                bf16-rounded products
//                                                summed in f32 (k > 128)
//     pred = clamp(mu + dot) | 1 + dot | lo + sigmoid(dot)*(hi-lo)
//     err  = (r - pred)*m                        SSE from the t=0 residual
//     acc  = sum_b bf16(eff_b*ff_b) into row kl_b, in f32
//     win += lrv*(acc/max(cnt,1) - regv*win*[cnt>0])       (row_mean)
//     win += lrv*(acc - regv*win*cnt)                       (otherwise)
//
// with cnt = sum_b bf16(m_b) per row.
//
// Work list.  Window rows do not interact: row w's update reads only
// win[w] and the ratings with kl_b = w.  So a half-pass is, for each
// updated row, its segments (the row's ratings in one batch) in batch
// order, each run for T sweeps on that row alone; rows a batch's window
// covers but no rating touches keep their values.  The host builds the
// segment table once per layout (ops/half_pass_kernel.py:
// build_segments): the masked-in entries grouped by (row, batch), each
// entry's fixed-side row index, rating and mask, each segment's count,
// and the rows in longest-first order.  One call covers a whole
// half-pass (or any list of batches): one 8-warp block per updated row,
// four blocks an SM; thread c of the block owns column c of the row for
// all of its segments' sweeps, so the window never leaves the SM.  Each
// block writes its row's SSE; the wrapper sums them.  The factor matrix
// is updated in place.
//
// What bounds it on an H100.  Per rating and sweep the math is 4k FLOP
// (dot, eff*ff, accumulate): 2k lane-FMAs, one clock of one SM at k = 66.
// The bytes a half-pass must move (the segment table and both factor
// sides once) take under 0.1 ms.  So the bound is operations, and the
// kernel is bound by the instructions it issues around them and by where
// its fixed rows come from.  Every rating and sweep has to read its fixed
// row (k values) from somewhere on the chip, multiply it twice, round k
// products to bf16 and add them.  In a warp whose lane l owns columns l,
// l+32, ... that is, per rating and column slot, a load (and a shift from
// bf16), an FMA, a multiply, half a packed conversion, an unpack and an
// add; with the dot's cross-lane sum, the residual and the broadcast of
// eff, about 28 warp instructions a rating at k = 66, 7 clocks of one SM
// at four issues a clock; measured, 9.4 clocks on an H100 over a
// half-pass whose entries are all staged (the parent design issued about
// 40 and took 23, most of the rest waiting on its per-sweep gathers).  A
// rating whose fixed row comes from L2 instead of shared memory costs
// about three times as much: 160 bytes a rating and sweep at L2's rate.
// What the design does:
//
// * Staging.  A segment's first `cap` entries (fixed row, rating, mask)
//   are copied into shared memory once per segment, and its T sweeps
//   read them from there: no index load, no gather, no L1/L2 round trip
//   and no bounds test per sweep (U zero rows follow the staged ones).
//   `cap` follows from k and the fixed side's type (stage_capacity
//   below, which the wrapper reads through half_pass_stage; 50 KB an
//   8-warp block, four blocks an SM, 100 KB a cluster block, two an SM):
//   360 entries at k = 66 in bf16 and 117 at k = 102 in f32 (726 and 240
//   in clusters).
//   A longer segment streams its other entries from global memory
//   (L1/L2) on every sweep, as before.  Which entries are staged follows
//   from the segment's length and k alone.  The copy is plain loads: it
//   is paid once per T sweeps (T = 128 and 32 on the main paths).
// * The dot's cross-lane sum is transposed: a warp takes U = 4 ratings a
//   step, and a butterfly that halves the values a lane carries at each
//   level (offsets 16, 8) leaves each lane one rating's partial, finished
//   by three plain levels: 6 shuffles for 4 ratings instead of 20.  The
//   residual is computed once per rating, in the 8 lanes that hold its
//   dot (the parent ran it, and the logistic link's expf, in all 32), and
//   eff is broadcast by one shuffle a rating.
// * The tail columns.  k = 66 and 102 leave 2 and 6 columns past the full
//   slots; a third (fourth) slot would spend 32 lanes on them.  They are
//   packed one to a lane: lane l takes tail column l % 8 of rating l / 8,
//   adds its term before the dot's last levels, and its eff is its own.
// * The product rounding is one packed cvt.rn.bf16x2.f32 for two
//   ratings' products of a column (bf16_round2; bit for bit
//   __float2bfloat16_rn on every finite input), half the conversions of
//   one a product; measured faster than four integer operations a value.
// * The sweep's update is paid once per block: each warp writes its
//   column partials to shared memory, and after one barrier thread c
//   sums the warps' partials of column c in warp order, updates win[c]
//   and writes bf16(win[c]) for the next sweep's reads; a second barrier
//   publishes it.  The parent had every warp redo the whole update.
//
// Hot rows' chains.  A popular item's ratings are one block's chain of
// segments x T sweeps on one SM, which no schedule on one SM shortens.
// Rows of at least CLUSTER_ROW ratings with long segments (k <= 160) run
// as a thread-block cluster of CLUSTER = 8 blocks of 16 warps (two per
// SM), launched on a second stream beside the 8-warp blocks.  Each block
// owns a fixed slice of every segment's entries (staged as above) and
// reduces its warps to a block partial in shared memory; after a cluster
// barrier every block sums the cluster's partials over distributed
// shared memory in rank order, so every block computes the same new row.
// The partials are double-buffered: one cluster barrier per sweep.  Rank
// 0 writes the row and the SSE.  A cluster pays that barrier every sweep,
// so short segments stay in 8-warp blocks.  No atomics anywhere: two
// launches give the same bits.
//
// Each including .cu defines K1_LOGISTIC (the link) and K1_FF16 (the
// fixed side is bf16, else f32); half_pass_launch below dispatches on k.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC.  Plain C interface, loaded by ctypes.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef K1_LOGISTIC
#error "define K1_LOGISTIC (0 or 1) before including half_pass.cuh"
#endif
#ifndef K1_FF16
#error "define K1_FF16 (0 or 1) before including half_pass.cuh"
#endif

namespace {

namespace cg = cooperative_groups;

constexpr int NW_NARROW = 8;       // warps per block, most rows (4 an SM)
constexpr int NW_CLUSTER = 16;     // warps per block of a cluster row,
                                   // two blocks per SM (64 registers)
constexpr int CLUSTER = 8;         // blocks per cluster row
constexpr int U = 4;               // ratings a warp takes per step
constexpr int GRP = 32 / U;        // lanes that finish one rating's dot
constexpr int MAX_KJ = 8;          // column slots per lane: k <= 256
constexpr int MAX_KJ_CLUSTER = 5;  // clusters: k <= 160
constexpr int SMEM_MAX = 232448;   // shared memory a block may ask for
// the bytes a block stages a segment's entries in: an 8-warp block's
// share of four an SM, a cluster block's of two an SM, beside each
// block's partials (fixed_smem_floats)
constexpr int STAGE_BYTES = 50 * 1024;
constexpr int CLUSTER_STAGE_BYTES = 100 * 1024;

#if K1_FF16
typedef __nv_bfloat16 fix_t;
#else
typedef float fix_t;
#endif

struct Params {
  float* F_upd;                    // [rows, k] f32, updated in place
  const fix_t* F_fix;              // [rows_fix, k] bf16 or f32
  const int* blk_row;              // [n_blocks] updated row of block x
  const int* blk_seg0;             // [n_blocks] its first segment
  const int* blk_seg1;             // [n_blocks] one past its last
  const int* seg_ptr;              // [n_seg + 1] entry offsets
  const float* seg_cnt;            // [n_seg] sum of bf16(m)
  const int* ent_fix;              // [n_ent] fixed-side row
  const float* ent_r;              // [n_ent] rating
  const float* ent_m;              // [n_ent] mask (nonzero)
  const float* lrv;                // [k]
  const float* regv;               // [k]
  float base;                      // prediction base: mu, or 1 (no bias)
  float lo_c, hi_c;                // clamp bounds (+-inf: no clamp)
  float lo_r, hi_r;                // the logistic link's range
  int k, T, row_mean;
  int cap;                         // entries of a segment (slice) staged:
                                   // stage_capacity(k, cluster)
  float* sse_rows;                 // [n_blocks]
};

// round to nearest even to bf16, as f32: two values with one packed
// conversion (cvt.rn.bf16x2.f32, a to the low half, b to the high half);
// bit for bit __float2bfloat16_rn on every finite input
__device__ __forceinline__ void bf16_round2(float a, float b, float& ra,
                                            float& rb) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const uint32_t w = *reinterpret_cast<const uint32_t*>(&h);
  ra = __uint_as_float(w << 16);
  rb = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: every lane adds the same pairs, so all lanes end equal
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float fix_val(fix_t x) {
#if K1_FF16
  return __bfloat162float(x);
#else
  return x;
#endif
}

// (err, eff) of one rating from its dot
__device__ __forceinline__ void residual(const Params& p, float dot, float r,
                                         float m, float& err, float& eff) {
#if K1_LOGISTIC
  const float rng_w = p.hi_r - p.lo_r;
  const float sig = 1.f / (1.f + expf(-dot));
  const float pred = p.lo_r + sig * rng_w;
  err = (r - pred) * m;
  eff = err * sig * (1.f - sig) * rng_w;
#else
  const float pred = fminf(fmaxf(p.base + dot, p.lo_c), p.hi_c);
  err = (r - pred) * m;
  eff = err;
#endif
}

// The first levels of the dot's sum over the warp: a butterfly that
// halves the U values a lane carries each level (lanes whose level bit is
// set keep the upper half), so that lane l ends with a partial of rating
// l / GRP; the GRP lanes of a rating then finish it with plain levels.
template <int N>
__device__ __forceinline__ void fold(float (&v)[U], int lane, int o) {
  if constexpr (N > 1) {
    const bool up = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float keep = up ? v[i + N / 2] : v[i];
      const float send = up ? v[i] : v[i + N / 2];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
    fold<N / 2>(v, lane, o >> 1);
  }
}

// a dot term: the f32 product fused into the sum for k <= 128, else the
// product rounded to bf16 first (two terms, one conversion)
template <bool DOT_F32>
__device__ __forceinline__ void dot_add2(float& d0, float& d1, float f,
                                         float a0, float a1) {
  if constexpr (DOT_F32) {
    d0 = fmaf(f, a0, d0);
    d1 = fmaf(f, a1, d1);
  } else {
    float r0, r1;
    bf16_round2(__fmul_rn(f, a0), __fmul_rn(f, a1), r0, r1);
    d0 += r0;
    d1 += r1;
  }
}

// One warp step: the U ratings from entry b on (of those before end),
// lane l owning columns l + 32 j (j < KJ) of each and, with TAIL, column
// 32 KJ + l % GRP (the k - 32 KJ <= GRP tail columns) of rating l / GRP.
// STAGED: b indexes the staged arrays, whose rows past the segment's end
// are zeros, so every slot loads without a test (a slot past k reads the
// next row's columns, finite values that meet fu = 0); otherwise b is a
// global entry id, the entries past end read entry end - 1 and count with
// m = 0, and the fixed rows are gathered from F_fix.  Either way an entry
// past the end adds exact zeros: m = 0 gives err = 0, so bf16(0*ff) = 0.
template <int KJ, bool TAIL, bool STAGED>
__device__ __forceinline__ void step(const Params& p, int lane, int b,
                                     int end, const float* st_r,
                                     const float* st_m, const fix_t* st_ff,
                                     const float (&fu)[KJ], float fu_t,
                                     float (&acc)[KJ], float& acc_t,
                                     float& sse, bool first) {
  constexpr bool DOT_F32 = KJ + TAIL <= 4;        // k <= 128
  const int k = p.k;
  const int mine = b + lane / GRP;                // the rating this lane
  const int c_t = 32 * KJ + lane % GRP;           // finishes, its tail
  float ff[U][KJ], ff_t = 0.f, r, m;
  if constexpr (STAGED) {
    const fix_t* row = st_ff + static_cast<size_t>(b) * k + lane;
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < KJ; ++j) ff[u][j] = fix_val(row[u * k + 32 * j]);
    if constexpr (TAIL)
      ff_t = fix_val(st_ff[static_cast<size_t>(mine) * k + c_t]);
    r = st_r[mine];
    m = st_m[mine];
  } else {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const fix_t* row =
          p.F_fix + static_cast<size_t>(p.ent_fix[min(b + u, end - 1)]) * k;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int c = lane + 32 * j;
        ff[u][j] = c < k ? fix_val(row[c]) : 0.f;
      }
    }
    const int e = min(mine, end - 1);
    if constexpr (TAIL)
      ff_t = c_t < k ? fix_val(p.F_fix[static_cast<size_t>(p.ent_fix[e]) * k
                                       + c_t])
                     : 0.f;
    r = p.ent_r[e];
    m = mine < end ? p.ent_m[e] : 0.f;
  }

  float part[U];
#pragma unroll
  for (int u = 0; u < U; ++u) part[u] = 0.f;
#pragma unroll
  for (int j = 0; j < KJ; ++j)
#pragma unroll
    for (int u = 0; u < U; u += 2)
      dot_add2<DOT_F32>(part[u], part[u + 1], fu[j], ff[u][j], ff[u + 1][j]);
  fold<U>(part, lane, 16);
  float dot = part[0];
  if constexpr (TAIL) {                           // this lane's tail term
    if constexpr (DOT_F32) {
      dot = fmaf(fu_t, ff_t, dot);
    } else {
      float r0, r1;
      bf16_round2(__fmul_rn(fu_t, ff_t), 0.f, r0, r1);
      dot += r0;
    }
  }
#pragma unroll
  for (int o = GRP / 2; o > 0; o >>= 1)
    dot += __shfl_xor_sync(0xffffffffu, dot, o);
  float err, eff_mine;
  residual(p, dot, r, m, err, eff_mine);
  if (first && lane % GRP == 0) sse += err * err;
  float eff[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    eff[u] = __shfl_sync(0xffffffffu, eff_mine, u * GRP);
#pragma unroll
  for (int j = 0; j < KJ; ++j)
#pragma unroll
    for (int u = 0; u < U; u += 2) {
      float r0, r1;
      bf16_round2(eff[u] * ff[u][j], eff[u + 1] * ff[u + 1][j], r0, r1);
      acc[j] += r0;
      acc[j] += r1;
    }
  if constexpr (TAIL) {
    float r0, r1;
    bf16_round2(eff_mine * ff_t, 0.f, r0, r1);
    acc_t += r0;
  }
}

// Shared memory of a block: the warps' partials, the window read and the
// cluster's block partials over NC = 32 (KJ + TAIL) column slots, the
// SSE, then the staged entries: cap rows and U zero rows past a
// segment's end (a step reads up to U - 1 past it), and the last slot's
// overhang past k.
template <int KJ, bool TAIL, int NW>
__host__ __device__ constexpr int fixed_smem_floats() {
  return (NW + 3) * 32 * (KJ + TAIL) + NW;
}

__host__ __device__ constexpr size_t stage_bytes(int cap, int k, int nc) {
  return static_cast<size_t>(cap + U) * (2 * sizeof(float) + k * sizeof(fix_t))
         + static_cast<size_t>(nc) * sizeof(fix_t);
}

// The entries of a segment (of a cluster block's slice) a block stages:
// as many as fill its STAGE_BYTES (CLUSTER_STAGE_BYTES) by stage_bytes.
// 360 at k = 66 in bf16 and 117 at k = 102 in f32 (726 and 240 in a
// cluster).  Every count of staged entries comes from here
// (half_pass_stage).
__host__ __device__ constexpr int stage_capacity(int k, bool cluster) {
  const int fb = static_cast<int>(sizeof(fix_t));
  const int budget = cluster ? CLUSTER_STAGE_BYTES : STAGE_BYTES;
  const int cap = (budget - 32 * ((k + 31) / 32) * fb) /
                  (k * fb + 2 * static_cast<int>(sizeof(float))) - U;
  return cap > 0 ? cap : 0;
}

// The row of block ``blk``: KJ full column slots per lane and, with TAIL,
// the tail columns packed as in ``step``; NW warps per block;
// CLUSTER_ROWS: the row is split over the CLUSTER blocks of a cluster,
// ``rank`` this block's.
template <int KJ, bool TAIL, int NW, bool CLUSTER_ROWS>
__device__ __forceinline__ void run_row(const Params& p, int blk, int rank) {
  constexpr int NC = 32 * (KJ + TAIL);            // column slots
  extern __shared__ __align__(16) float smem[];
  float* red = smem;                              // [NW][NC]
  float* fu_s = red + NW * NC;                    // [NC] bf16(win)
  float* bpart = fu_s + NC;                       // [2][NC] (clusters)
  float* sse_w = bpart + 2 * NC;                  // [NW]
  float* st_r = sse_w + NW;                       // [cap + U]
  float* st_m = st_r + p.cap + U;                 // [cap + U]
  fix_t* st_ff = reinterpret_cast<fix_t*>(st_m + p.cap + U);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = p.k;
  float* wrow = p.F_upd + static_cast<size_t>(p.blk_row[blk]) * k;

  // thread c owns column c: its window value and rates
  const int c_own = threadIdx.x;
  const bool owner = c_own < k;
  float win = 0.f, lrv = 0.f, regv = 0.f;
  if (owner) {
    win = wrow[c_own];
    lrv = p.lrv[c_own];
    regv = p.regv[c_own];
  }
  if (c_own < NC) fu_s[c_own] = owner ? bf16_round(win) : 0.f;
  float sse = 0.f;
  int buf = 0;

  for (int s = p.blk_seg0[blk]; s < p.blk_seg1[blk]; ++s) {
    int e0 = p.seg_ptr[s];
    int e1 = p.seg_ptr[s + 1];
    const float cnt = p.seg_cnt[s];
    // row_mean: the mean gradient, decay only on a live row; otherwise
    // the sum, decay times the count
    const float den = p.row_mean ? fmaxf(cnt, 1.f) : 1.f;
    const float rc = p.row_mean ? (cnt > 0.f ? 1.f : 0.f) : cnt;
    if constexpr (CLUSTER_ROWS) {             // this block's fixed slice
      const int piece = (e1 - e0 + CLUSTER - 1) / CLUSTER;
      e0 = min(e1, e0 + rank * piece);
      e1 = min(e1, e0 + piece);
    }
    const int n = e1 - e0;
    const int nst = min(n, p.cap);
    // stage the first nst entries and zero what a step reads past them
    // (the last sweep's barrier has freed the buffers)
#pragma unroll 2
    for (int i = warp; i < nst; i += NW) {
      const int e = e0 + i;
      const fix_t* src = p.F_fix + static_cast<size_t>(p.ent_fix[e]) * k;
      fix_t* dst = st_ff + static_cast<size_t>(i) * k;
#pragma unroll
      for (int j = 0; j < KJ + TAIL; ++j) {
        const int c = lane + 32 * j;
        if (c < k) dst[c] = src[c];
      }
      if (lane == 0) {
        st_r[i] = p.ent_r[e];
        st_m[i] = p.ent_m[e];
      }
    }
    for (int i = threadIdx.x; i < U * k + NC; i += NW * 32)
      st_ff[static_cast<size_t>(nst) * k + i] = fix_t(0.f);
    if (threadIdx.x < U) {
      st_r[nst + threadIdx.x] = 0.f;
      st_m[nst + threadIdx.x] = 0.f;
    }
    __syncthreads();
    for (int t = 0; t < p.T; ++t) {
      float fu[KJ], acc[KJ], acc_t = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        fu[j] = fu_s[lane + 32 * j];
        acc[j] = 0.f;
      }
      const float fu_t = TAIL ? fu_s[32 * KJ + lane % GRP] : 0.f;
      for (int b = warp * U; b < nst; b += NW * U)
        step<KJ, TAIL, true>(p, lane, b, nst, st_r, st_m, st_ff, fu, fu_t,
                             acc, acc_t, sse, t == 0);
      for (int b = e0 + nst + warp * U; b < e1; b += NW * U)
        step<KJ, TAIL, false>(p, lane, b, e1, st_r, st_m, st_ff, fu, fu_t,
                              acc, acc_t, sse, t == 0);
#pragma unroll
      for (int j = 0; j < KJ; ++j) red[warp * NC + lane + 32 * j] = acc[j];
      if constexpr (TAIL) {                   // the U ratings' tail sums
#pragma unroll
        for (int o = GRP; o < 32; o <<= 1)
          acc_t += __shfl_xor_sync(0xffffffffu, acc_t, o);
        if (lane < GRP) red[warp * NC + 32 * KJ + lane] = acc_t;
      }
      __syncthreads();
      float tot = 0.f;
      if constexpr (CLUSTER_ROWS) {
        // the block's partial, then every block sums the cluster's
        // partials over distributed shared memory in rank order
        cg::cluster_group cl = cg::this_cluster();
        if (owner) {
          float v = 0.f;
#pragma unroll
          for (int w = 0; w < NW; ++w) v += red[w * NC + c_own];
          bpart[buf * NC + c_own] = v;
        }
        cl.sync();
        if (owner) {
#pragma unroll
          for (int q = 0; q < CLUSTER; ++q)
            tot += cl.map_shared_rank(bpart + buf * NC, q)[c_own];
        }
      } else if (owner) {
        // the warps' partials in a fixed order
#pragma unroll
        for (int w = 0; w < NW; ++w) tot += red[w * NC + c_own];
      }
      if (owner) {
        const float reg = regv * win;
        win = win + lrv * (__fdiv_rn(tot, den) - reg * rc);
        fu_s[c_own] = bf16_round(win);
      }
      __syncthreads();
      buf ^= 1;
    }
  }

  if ((!CLUSTER_ROWS || rank == 0) && owner) wrow[c_own] = win;
  sse = warp_sum(sse);
  if (lane == 0) sse_w[warp] = sse;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) s += sse_w[w];
    sse_w[0] = s;
  }
  if constexpr (CLUSTER_ROWS) {
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    if (rank == 0 && threadIdx.x == 0) {
      float s = 0.f;
      for (int q = 0; q < CLUSTER; ++q)
        s += cl.map_shared_rank(&sse_w[0], q)[0];
      p.sse_rows[blk] = s;
    }
    cl.sync();                      // no block leaves while rank 0 reads
  } else if (threadIdx.x == 0) {
    p.sse_rows[blk] = sse_w[0];
  }
}

// four blocks an SM (64 registers) where the slots leave room, else two
template <int KJ, bool TAIL>
__global__ void __launch_bounds__(NW_NARROW * 32, KJ + TAIL <= 4 ? 4 : 2)
half_pass_rows(const Params p, int blk_begin) {
  run_row<KJ, TAIL, NW_NARROW, false>(p, blk_begin + blockIdx.x, 0);
}

template <int KJ, bool TAIL>
__global__ void __launch_bounds__(NW_CLUSTER * 32, 2)
half_pass_cluster_rows(const Params p, int blk_begin) {
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  run_row<KJ, TAIL, NW_CLUSTER, true>(p, blk_begin + blockIdx.x / CLUSTER,
                                      rank);
}

// The kernel a width and block kind run, its threads and its dynamic
// shared memory (the block's partials and its staged entries at
// stage_capacity), with the kernel's attribute set to allow it.
template <int KJ, bool TAIL>
cudaError_t prepare(int k, bool cluster, const void** fn, int* threads,
                    size_t* smem) {
  if (cluster) {
    constexpr bool fits = KJ + TAIL <= MAX_KJ_CLUSTER;
    if (!fits) return cudaErrorInvalidValue;
    constexpr int KC = fits ? KJ : 1;
    constexpr bool TC = fits && TAIL;
    *fn = reinterpret_cast<const void*>(half_pass_cluster_rows<KC, TC>);
    *threads = NW_CLUSTER * 32;
    *smem = fixed_smem_floats<KC, TC, NW_CLUSTER>() * sizeof(float) +
            stage_bytes(stage_capacity(k, true), k, 32 * (KC + TC));
  } else {
    *fn = reinterpret_cast<const void*>(half_pass_rows<KJ, TAIL>);
    *threads = NW_NARROW * 32;
    *smem = fixed_smem_floats<KJ, TAIL, NW_NARROW>() * sizeof(float) +
            stage_bytes(stage_capacity(k, false), k, 32 * (KJ + TAIL));
  }
  if (*smem > SMEM_MAX) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

template <int KJ, bool TAIL>
cudaError_t launch(const Params& p, int blk_begin, int blk_end, bool cluster,
                   cudaStream_t stream) {
  const void* fn;
  int threads;
  size_t smem;
  cudaError_t err = prepare<KJ, TAIL>(p.k, cluster, &fn, &threads, &smem);
  if (err != cudaSuccess) return err;
  if (cluster) {
    constexpr bool fits = KJ + TAIL <= MAX_KJ_CLUSTER;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((blk_end - blk_begin) * CLUSTER);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(
        &cfg, half_pass_cluster_rows<(fits ? KJ : 1), (fits && TAIL)>, p,
        blk_begin);
  }
  half_pass_rows<KJ, TAIL>
      <<<blk_end - blk_begin, threads, smem, stream>>>(p, blk_begin);
  return cudaGetLastError();
}

// the blocks an SM holds of the kernel a width and block kind run, at its
// shared memory and registers
template <int KJ, bool TAIL>
cudaError_t blocks_per_sm(int k, bool cluster, int* blocks) {
  const void* fn;
  int threads;
  size_t smem;
  cudaError_t err = prepare<KJ, TAIL>(k, cluster, &fn, &threads, &smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, threads,
                                                       smem);
}

// f.template run<KJ, TAIL>() for width k: KJ full column slots a lane
// and, with TAIL, the columns past them packed one to a lane when there
// are at most GRP of them (k = 66: 2, k = 102: 6)
template <class F>
cudaError_t by_width(int k, const F& f) {
  const int full = k / 32;
  if (full >= 1 && k % 32 >= 1 && k % 32 <= GRP) {
    switch (full) {
      case 1: return f.template run<1, true>();
      case 2: return f.template run<2, true>();
      case 3: return f.template run<3, true>();
      case 4: return f.template run<4, true>();
      case 5: return f.template run<5, true>();
      case 6: return f.template run<6, true>();
      default: return f.template run<7, true>();
    }
  }
  switch ((k + 31) / 32) {
    case 1: return f.template run<1, false>();
    case 2: return f.template run<2, false>();
    case 3: return f.template run<3, false>();
    case 4: return f.template run<4, false>();
    case 5: return f.template run<5, false>();
    case 6: return f.template run<6, false>();
    case 7: return f.template run<7, false>();
    default: return f.template run<8, false>();
  }
}

struct Launch {
  const Params& p;
  int blk_begin, blk_end;
  bool cluster;
  cudaStream_t stream;
  template <int KJ, bool TAIL>
  cudaError_t run() const {
    return launch<KJ, TAIL>(p, blk_begin, blk_end, cluster, stream);
  }
};

struct Occupancy {
  int k;
  bool cluster;
  int* blocks;
  template <int KJ, bool TAIL>
  cudaError_t run() const {
    return blocks_per_sm<KJ, TAIL>(k, cluster, blocks);
  }
};

__global__ void bf16_round_pairs(const float* x, float* y, long long n) {
  const long long i = 2 * (static_cast<long long>(blockIdx.x) * blockDim.x +
                           threadIdx.x);
  if (i + 1 < n) {
    bf16_round2(x[i], x[i + 1], y[i], y[i + 1]);
  } else if (i < n) {
    float unused;
    bf16_round2(x[i], 0.f, y[i], unused);
  }
}

}  // namespace

extern "C" {

// K1 over blocks [blk_begin, blk_end) of a segment table (one half-pass
// or any list of batches): as thread-block clusters of CLUSTER blocks
// when ``wide`` (k <= 160), else 8-warp blocks; each block stages up to
// stage_capacity(k, wide) entries of a segment (or of its slice) in
// shared memory.  fix_bf16 must match this build's fixed-side type.
// Returns a cudaError_t (0 = launched).  k in 1..256, T >= 1.
int half_pass_launch(float* F_upd, const void* F_fix, int fix_bf16,
                     const int* blk_row, const int* blk_seg0,
                     const int* blk_seg1, int blk_begin, int blk_end,
                     int wide, const int* seg_ptr, const float* seg_cnt,
                     const int* ent_fix, const float* ent_r,
                     const float* ent_m, const float* lrv, const float* regv,
                     float base, float lo_c, float hi_c, float lo_r,
                     float hi_r, int k, int T, int row_mean, float* sse_rows,
                     void* stream) {
  if (k < 1 || k > 32 * MAX_KJ || T < 1 || blk_begin < 0 ||
      blk_end < blk_begin || (fix_bf16 != 0) != (K1_FF16 != 0) ||
      (wide && k > 32 * MAX_KJ_CLUSTER))
    return static_cast<int>(cudaErrorInvalidValue);
  if (blk_end == blk_begin) return 0;
  Params p;
  p.F_upd = F_upd;
  p.F_fix = static_cast<const fix_t*>(F_fix);
  p.blk_row = blk_row;
  p.blk_seg0 = blk_seg0;
  p.blk_seg1 = blk_seg1;
  p.seg_ptr = seg_ptr;
  p.seg_cnt = seg_cnt;
  p.ent_fix = ent_fix;
  p.ent_r = ent_r;
  p.ent_m = ent_m;
  p.lrv = lrv;
  p.regv = regv;
  p.base = base;
  p.lo_c = lo_c;
  p.hi_c = hi_c;
  p.lo_r = lo_r;
  p.hi_r = hi_r;
  p.k = k;
  p.T = T;
  p.row_mean = row_mean;
  p.cap = stage_capacity(k, wide != 0);
  p.sse_rows = sse_rows;
  return static_cast<int>(by_width(
      k, Launch{p, blk_begin, blk_end, wide != 0,
                static_cast<cudaStream_t>(stream)}));
}

// How a block of this build stages a segment at width k (``wide``: a
// cluster row's block): *cap entries of a segment (of its slice) kept in
// shared memory for the T sweeps, the segment split over *slices blocks,
// and *blocks_per_sm such blocks an SM at their shared memory and
// registers (skipped when null).  For the wrapper's counts of staged
// entries and for the tests.  Returns a cudaError_t.
int half_pass_stage(int k, int wide, int* cap, int* slices,
                    int* blocks_per_sm) {
  if (k < 1 || k > 32 * MAX_KJ || (wide && k > 32 * MAX_KJ_CLUSTER))
    return static_cast<int>(cudaErrorInvalidValue);
  *cap = stage_capacity(k, wide != 0);
  *slices = wide ? CLUSTER : 1;
  if (blocks_per_sm == nullptr) return 0;
  return static_cast<int>(
      by_width(k, Occupancy{k, wide != 0, blocks_per_sm}));
}

// The kernel's product rounding (bf16_round2) over x[0, n), two values a
// conversion: y[i] is x[i] rounded to bf16, as f32.  For its test against
// __float2bfloat16_rn.
int half_pass_bf16_round(const float* x, float* y, long long n,
                         void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const long long blocks = ((n + 1) / 2 + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  bf16_round_pairs<<<static_cast<unsigned>(blocks), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(x, y, n);
  return static_cast<int>(cudaGetLastError());
}

const char* half_pass_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

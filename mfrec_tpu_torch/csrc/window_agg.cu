// K4 on Hopper: sorted-window gradient aggregation.
//
// Replaces the Pallas TPU kernel mfrec_tpu/ops/pallas_window_agg.py
// (_agg_kernel, entered through window_aggregate).  The TPU kernel sums
// per-sample rows g [B, k] into a W-row window by window-local ids kl [B]:
//
//     gsum[w] = sum_{j: kl_j = w, m_j > 0} bf16(g_j)      summed in f32
//     cnt[w]  = #{j: kl_j = w, m_j > 0}
//
// by building a [chunk, W] one-hot tile in VMEM and running it through
// the MXU.  On Hopper that product is wasted work: it is a segmented sum.
// Four entry points:
//
// window_agg_launch -- one call of the JAX signature (any kl, sorted or
//   not), in two launches.  The first, one block of 32 warps, builds each
//   window row's index list once: a stable counting sort of the masked-in
//   entries by kl into a [B] permutation and [W+1] row offsets.  Warp q
//   counts its contiguous piece of the batch per row (one __match_any_sync
//   per 32 ids, the per-(row, warp) counts in shared memory, or in a
//   global scratch when W is large), one block-wide scan turns the counts
//   into offsets, and warp q then places its ids, 32 at a time, each at
//   its row's running offset plus its rank among the same row's lanes.
//   The second launch runs one 32-warp block per window row over that
//   row's list only: the warps split the list into contiguous pieces, each
//   lane owns columns l, l+32, ... (k <= 256) and sums its piece in index
//   order, eight rows' loads in flight, and a shared-memory sum in warp
//   order ends the block.  So counts are exact, a row's sum is the same
//   from run to run (no atomics), and a hot row that fills the whole batch
//   is spread over 32 warps.
//
// scan_agg_launch -- a whole phase of a sorted-pass layout in one call
//   (the scan of _scan_window_agg in mfrec_tpu/ops/sgd_mf.py, target +=
//   gsum per batch).  It walks K1's segment table: one warp per target
//   row, which adds the row's per-batch segment sums into the row in
//   batch order, target = ((target + s_1) + s_2) + ..., as the scan does.
//   The rows to sum arrive in the table's entry order (the caller gathers
//   them).
//
// step_agg_launch -- the SVD++ / FN item step of a whole epoch in one
//   call (the scans y_step of mfrec_tpu/ops/sgd_mf.py and xy_step of
//   mfrec_tpu/ops/fn.py, which call _agg_window once per item batch).
//   For every updated row y (an item), over its segments in batch order:
//
//     y += step * agg_s( bf16( (c_e * G[u_e] - decay * y) * m_e ) )
//
//   agg_s the f32 sum over the segment's entries (divided by max(count,
//   1) with row_mean), y the row's value before that segment, c_e 1 or a
//   per-entry weight (FN's residual for X).  Window rows do not interact,
//   so the per-batch scan is, per row, a chain over the row's segments:
//   the row stays in registers across them.  Up to two targets share the
//   gathered G row (FN's X and Y).  The longest rows (at least
//   STEP_BLOCK_ROW entries: the hot items) take a whole 16-warp block,
//   whose warps split each segment into contiguous pieces and combine
//   their partials in warp order; every other row takes one warp.  G is
//   gathered by index inside the kernel (it stays in L2), never
//   materialized per entry.
//
// gather_agg_launch -- the SVD++ and FN user-side phases of a whole epoch
//   in one call each, with the per-entry rows gathered inside the kernel
//   (by the table's ent_fix, as step_agg_launch gathers G), never
//   materialized:
//
//     sum mode:     target[row] += agg_s( bf16( src[fix_e] ) )
//     error mode:   target[row] += agg_s( bf16( err_e * src[fix_e][:kt] ) ),
//                   err_e = (r_e - clamp(mu + prow[row] . src[fix_e], lo,
//                           hi)) * m_e
//     profile mode: target[row] += agg_s( bf16( res_e * src[fix_e]
//                                               + src2[fix_e] ) ),
//                   res_e = r_e - ((mu + bu[row]) + bi[fix_e])
//
//   agg_s the f32 sum over segment s, added into the row in batch order
//   as scan_agg_launch adds it.  The sum mode is SVD++'s phase 1 (A = sum
//   of the user's Y rows), the error mode phase 4 of SVD++ and FN (G =
//   the error-weighted Q rows, prow the effective user rows, src the
//   augmented Qaug of width k = kt + 2), the profile mode FN's phase 1
//   (A = sum of the user's residual-weighted X rows plus Y rows, src X,
//   src2 Y; each product rounded, then the sum, as torch computes
//   them: no contraction into an FMA).  The profile mode without its
//   bf16 rounding (a compile-time switch) is FN's served profiles, summed
//   in full f32.  One template serves all three: the error mode reads
//   the block's prow row once into registers, and each entry's dot is
//   each lane's fmaf over its columns, then a xor-butterfly over the warp
//   (every lane ends with the same sum, so no broadcast).  A warp has UU
//   entries' gathers in flight.  The longest rows (from the wrapper's
//   AGG_BLOCK_ROW entries: the heavy users) take a whole 16-warp block,
//   whose warps split each segment into contiguous pieces and combine
//   their partials in warp order, as the item step's hot rows do; every
//   other row takes one warp.  At the Netflix shape (100,480,507 entries, k = 100) the rows
//   these phases used to build first are 40 GB each; here the device
//   holds none of them.
//
// Every row is rounded to bf16 (round to nearest even) inside the
// kernel, from f32: a caller never rounds first.
//
// What bounds it on an H100.  Each is a pass over its rows, bound by
// bytes at 3.35 TB/s: for one call of the JAX shape (B=16384 masked-in
// rows, k=66, W=128) g is 4.33 MB, kl and mask 0.13 MB, the window 34 KB
// out: ~4.5 MB, 1.3 us.  The parent design scanned all B ids in each of
// the W blocks (W x B x 8 bytes from L1/L2, 16 MB at the JAX shape) with
// a dependent L2 round trip per 32 ids, 3-4x slower than index_add_; the
// index list reads the ids twice in one block and each row block then
// reads only its own rows, so what is left is the two launches' latency
// and, on a batch that is one hot row, one SM's L2 bandwidth.  For a
// whole phase of the ML-10M user layout (8,346,084 rows, k=64) the rows
// are 2.14 GB, the table and the target rows 0.04 GB: 0.65 ms.  The item
// step reads the table's ent_fix and ent_m once (67 MB), G once from
// memory (18 MB; its 2.1 GB of gathers hit L2) and the targets once each
// way; the hot item's chain (~70,000 entries in one block) bounds it.
//
// The gathered phases read the table's ent_fix (and ent_r, ent_m in the
// error mode) once, the target rows once each way and prow once, and
// gather 4 k bytes an entry from src, which stays in L2 (Qaug at the
// Netflix shape is 7.2 MB): 0.4 / 1.2 GB from memory for the sum and the
// error mode, 0.12 / 0.36 ms; the error mode's 4 k + 7 operations an
// entry take 0.61 ms at the FP32 peak.  The profile mode reads ent_fix
// and ent_r once, b_u once a row, and gathers X's and Y's rows and b_j
// (8 k + 4 bytes an entry, 14.3 MB at the Netflix shape: in L2); its 3 k
// + 3 operations an entry take 0.46 ms at the FP32 peak at k = 100.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC.  Plain C interface, loaded by ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_KJ = 8;          // column slots per lane: k <= 256
constexpr int NW_INDEX = 32;       // warps of the index-list block
constexpr int NW_CALL = 32;        // warps per row block, per-call sum
constexpr int NW_SCAN = 8;         // warps (rows) per block, phase kernel
constexpr int NW_STEP = 16;        // warps per block, item step
constexpr int U = 4;               // rows in flight per warp
constexpr int TILE = 16;           // ids a lane holds at a time
// the index-list counts stay in shared memory up to this many bytes
constexpr int INDEX_SMEM_MAX = 96 * 1024;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---- window_agg_launch, launch 1: the rows' index lists --------------------
//
// hist [W][NW_INDEX]: first the count of row w's ids in warp q's piece,
// then (after the scan) the running offset where warp q puts its next one.
__global__ void __launch_bounds__(NW_INDEX * 32)
window_index_kernel(const int* __restrict__ kl,
                    const float* __restrict__ mask, int B, int W,
                    int* hist_global, int* __restrict__ row_ptr,
                    int* __restrict__ perm) {
  extern __shared__ int hist_shared[];
  __shared__ int warp_tot[NW_INDEX];
  int* hist = hist_global ? hist_global : hist_shared;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_hist = W * NW_INDEX;
  for (int e = threadIdx.x; e < n_hist; e += blockDim.x) hist[e] = 0;
  __syncthreads();
  // warp q's piece of the batch, in whole groups of 32 ids
  const int piece = ((B + NW_INDEX - 1) / NW_INDEX + 31) & ~31;
  const int j0 = warp * piece;
  const int j1 = min(B, j0 + piece);
  // 1) counts per (row, warp); one writer per address, so no atomics
  for (int t0 = j0; t0 < j1; t0 += 32 * TILE) {
    int key[TILE];
#pragma unroll
    for (int q = 0; q < TILE; ++q) {
      const int j = t0 + 32 * q + lane;
      const bool in = j < j1;            // both loads in flight at once
      const int kv = in ? kl[j] : -1;
      const float mv = in ? mask[j] : 0.f;
      key[q] = mv > 0.f ? kv : -1;
    }
#pragma unroll
    for (int q = 0; q < TILE; ++q) {
      const unsigned peers = __match_any_sync(0xffffffffu, key[q]);
      if (key[q] >= 0 && lane == 31 - __clz(peers))
        hist[key[q] * NW_INDEX + warp] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();
  // 2) exclusive scan of hist in (row, warp) order: thread t takes a
  // contiguous run of it
  const int per = (n_hist + blockDim.x - 1) / blockDim.x;
  const int e0 = min(n_hist, static_cast<int>(threadIdx.x) * per);
  const int e1 = min(n_hist, e0 + per);
  int mine = 0;
  for (int e = e0; e < e1; ++e) mine += hist[e];
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = warp_tot[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    warp_tot[lane] = v;                  // inclusive over the warps
  }
  __syncthreads();
  int off = incl - mine + (warp ? warp_tot[warp - 1] : 0);
  for (int e = e0; e < e1; ++e) {
    const int c = hist[e];
    hist[e] = off;
    if (e % NW_INDEX == 0) row_ptr[e / NW_INDEX] = off;
    off += c;
  }
  if (threadIdx.x == 0) row_ptr[W] = warp_tot[31];
  __syncthreads();
  // 3) place: index order within a row, so the sort is stable
  const unsigned below = (1u << lane) - 1u;
  for (int t0 = j0; t0 < j1; t0 += 32 * TILE) {
    int key[TILE];
#pragma unroll
    for (int q = 0; q < TILE; ++q) {
      const int j = t0 + 32 * q + lane;
      const bool in = j < j1;            // both loads in flight at once
      const int kv = in ? kl[j] : -1;
      const float mv = in ? mask[j] : 0.f;
      key[q] = mv > 0.f ? kv : -1;
    }
#pragma unroll
    for (int q = 0; q < TILE; ++q) {
      const unsigned peers = __match_any_sync(0xffffffffu, key[q]);
      int* slot = key[q] >= 0 ? &hist[key[q] * NW_INDEX + warp] : nullptr;
      if (slot) perm[*slot + __popc(peers & below)] = t0 + 32 * q + lane;
      __syncwarp();
      if (slot && lane == 31 - __clz(peers)) *slot += __popc(peers);
      __syncwarp();
    }
  }
}

// ---- window_agg_launch, launch 2: one block per window row -----------------
template <int KJ>
__global__ void __launch_bounds__(NW_CALL * 32)
window_sum_kernel(const float* __restrict__ g, const int* __restrict__ row_ptr,
                  const int* __restrict__ perm, int k,
                  float* __restrict__ gsum, float* __restrict__ cnt) {
  constexpr int UC = KJ <= 3 ? 2 * U : U;   // rows in flight per warp
  __shared__ float part[NW_CALL][32 * KJ];
  const int w = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p0 = row_ptr[w];
  const int p1 = row_ptr[w + 1];
  const int piece = (p1 - p0 + NW_CALL - 1) / NW_CALL;
  const int a0 = min(p1, p0 + warp * piece);
  const int a1 = min(p1, a0 + piece);
  float acc[KJ];
#pragma unroll
  for (int jj = 0; jj < KJ; ++jj) acc[jj] = 0.f;
  for (int base = a0; base < a1; base += 32) {
    const int n = min(32, a1 - base);
    const int mine = lane < n ? perm[base + lane] : 0;
    for (int q = 0; q < n; q += UC) {
      float v[UC][KJ];
#pragma unroll
      for (int u = 0; u < UC; ++u) {
        const int j = __shfl_sync(0xffffffffu, mine, (q + u) & 31);
        const bool ok = q + u < n;
        const size_t row = static_cast<size_t>(j) * k;
#pragma unroll
        for (int jj = 0; jj < KJ; ++jj) {
          const int c = lane + 32 * jj;
          v[u][jj] = (ok && c < k) ? g[row + c] : 0.f;
        }
      }
      // in index order: the sum does not depend on the schedule
#pragma unroll
      for (int u = 0; u < UC; ++u) {
        if (q + u >= n) break;
#pragma unroll
        for (int jj = 0; jj < KJ; ++jj) acc[jj] += bf16_round(v[u][jj]);
      }
    }
  }
#pragma unroll
  for (int jj = 0; jj < KJ; ++jj) part[warp][lane + 32 * jj] = acc[jj];
  __syncthreads();
  // the warps' sums in warp order: one thread per column
  for (int c = threadIdx.x; c < k; c += blockDim.x) {
    float s = 0.f;
#pragma unroll 8
    for (int q = 0; q < NW_CALL; ++q) s += part[q][c];
    gsum[static_cast<size_t>(w) * k + c] = s;
  }
  if (threadIdx.x == 0) cnt[w] = static_cast<float>(p1 - p0);
}

// ---- scan_agg_launch --------------------------------------------------------
template <int KJ>
__global__ void __launch_bounds__(NW_SCAN * 32)
scan_agg_kernel(float* __restrict__ target, const float* __restrict__ vals,
                const int* __restrict__ blk_row,
                const int* __restrict__ blk_seg0,
                const int* __restrict__ blk_seg1,
                const int* __restrict__ seg_ptr, int n_rows, int k,
                int mean) {
  const int x = blockIdx.x * NW_SCAN + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (x >= n_rows) return;
  const size_t trow = static_cast<size_t>(blk_row[x]) * k;
  float acc[KJ];
#pragma unroll
  for (int jj = 0; jj < KJ; ++jj) {
    const int c = lane + 32 * jj;
    acc[jj] = c < k ? target[trow + c] : 0.f;
  }
  const int s1 = blk_seg1[x];
  for (int s = blk_seg0[x]; s < s1; ++s) {
    const int e0 = seg_ptr[s];
    const int e1 = seg_ptr[s + 1];
    float sum[KJ];
#pragma unroll
    for (int jj = 0; jj < KJ; ++jj) sum[jj] = 0.f;
    for (int e = e0; e < e1; e += U) {
      float v[U][KJ];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool ok = e + u < e1;
        const size_t row = static_cast<size_t>(ok ? e + u : e0) * k;
#pragma unroll
        for (int jj = 0; jj < KJ; ++jj) {
          const int c = lane + 32 * jj;
          v[u][jj] = (ok && c < k) ? vals[row + c] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (e + u >= e1) break;
#pragma unroll
        for (int jj = 0; jj < KJ; ++jj) sum[jj] += bf16_round(v[u][jj]);
      }
    }
    if (mean) {
      const float den = static_cast<float>(max(e1 - e0, 1));
#pragma unroll
      for (int jj = 0; jj < KJ; ++jj) sum[jj] = sum[jj] / den;
    }
#pragma unroll
    for (int jj = 0; jj < KJ; ++jj) acc[jj] += sum[jj];
  }
#pragma unroll
  for (int jj = 0; jj < KJ; ++jj) {
    const int c = lane + 32 * jj;
    if (c < k) target[trow + c] = acc[jj];
  }
}

// ---- step_agg_launch --------------------------------------------------------
struct StepArgs {                  // step_agg_launch's arguments
  float* tgt[2];                   // [rows, k] each, updated in place
  const float* coef[2];            // [n_ent] per-entry weight, or null (1)
  float decay[2];
  const float* G;                  // [rows_fix, k]
  const int* blk_row;
  const int* blk_seg0;
  const int* blk_seg1;
  const int* seg_ptr;
  const int* ent_fix;
  const float* ent_m;
  float step;
  int k, n_rows, n_long, row_mean, nt;
};

// one row's chain of segments; BLOCK: all NW_STEP warps on the row,
// splitting each segment, else one warp
template <int KJ, int NT, int UU, bool BLOCK>
__device__ __forceinline__ void step_row(const StepArgs& a, int x, int warp,
                                         int lane,
                                         float (*red)[NW_STEP][NT * KJ * 32]) {
  const int k = a.k;
  const size_t yrow = static_cast<size_t>(a.blk_row[x]) * k;
  float y[NT][KJ];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int c = lane + 32 * j;
      y[t][j] = c < k ? a.tgt[t][yrow + c] : 0.f;
    }
  int buf = 0;
  const int s1 = a.blk_seg1[x];
  for (int s = a.blk_seg0[x]; s < s1; ++s) {
    const int e0 = a.seg_ptr[s];
    const int e1 = a.seg_ptr[s + 1];
    int b0 = e0, b1 = e1;
    if constexpr (BLOCK) {
      const int piece = (e1 - e0 + NW_STEP - 1) / NW_STEP;
      b0 = min(e1, e0 + warp * piece);
      b1 = min(e1, b0 + piece);
    }
    float dy[NT][KJ], acc[NT][KJ];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        dy[t][j] = __fmul_rn(a.decay[t], y[t][j]);
        acc[t][j] = 0.f;
      }
    for (int e = b0; e < b1; e += UU) {
      float gv[UU][KJ], m[UU], cf[UU][NT];
#pragma unroll
      for (int u = 0; u < UU; ++u) {
        const bool ok = e + u < b1;
        const int i = ok ? e + u : e0;
        const size_t row = static_cast<size_t>(a.ent_fix[i]) * k;
        m[u] = a.ent_m[i];
#pragma unroll
        for (int t = 0; t < NT; ++t) cf[u][t] = a.coef[t] ? a.coef[t][i] : 1.f;
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          const int c = lane + 32 * j;
          gv[u][j] = (ok && c < k) ? a.G[row + c] : 0.f;
        }
      }
      // in entry order, as index_add_ of the batch's window takes them
#pragma unroll
      for (int u = 0; u < UU; ++u) {
        if (e + u >= b1) break;
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int j = 0; j < KJ; ++j) {
            const float cg = a.coef[t] ? __fmul_rn(cf[u][t], gv[u][j])
                                       : gv[u][j];
            acc[t][j] += bf16_round(__fmul_rn(__fsub_rn(cg, dy[t][j]), m[u]));
          }
      }
    }
    if constexpr (BLOCK) {
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int j = 0; j < KJ; ++j)
          red[buf][warp][(t * KJ + j) * 32 + lane] = acc[t][j];
      __syncthreads();
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          float tot = 0.f;
#pragma unroll
          for (int w = 0; w < NW_STEP; ++w)
            tot += red[buf][w][(t * KJ + j) * 32 + lane];
          acc[t][j] = tot;
        }
      buf ^= 1;
    }
    const float den = fmaxf(static_cast<float>(e1 - e0), 1.f);
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float gs = a.row_mean ? __fdiv_rn(acc[t][j], den) : acc[t][j];
        y[t][j] = __fadd_rn(y[t][j], __fmul_rn(a.step, gs));
      }
  }
  if (!BLOCK || warp == 0) {
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int c = lane + 32 * j;
        if (c < k) a.tgt[t][yrow + c] = y[t][j];
      }
  }
}

template <int KJ, int NT>
__global__ void __launch_bounds__(NW_STEP * 32)
step_agg_kernel(const StepArgs a) {
  constexpr int UU = NT * KJ <= 4 ? 2 * U : U;
  __shared__ float red[2][NW_STEP][NT * KJ * 32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (static_cast<int>(blockIdx.x) < a.n_long) {     // block-uniform
    step_row<KJ, NT, UU, true>(a, blockIdx.x, warp, lane, red);
  } else {
    const int x = a.n_long + (blockIdx.x - a.n_long) * NW_STEP + warp;
    if (x < a.n_rows) step_row<KJ, NT, UU, false>(a, x, warp, lane, red);
  }
}

// ---- gather_agg_launch ------------------------------------------------------
struct GatherArgs {                // gather_agg_launch's arguments
  float* target;                   // [rows, kt], updated in place
  const float* src;                // [rows_fix, k], gathered by ent_fix
  const float* prow;               // [rows, k]: error mode, or null
  const float* src2;               // [rows_fix, k]: profile mode, or null
  const float* bu;                 // [rows]: profile mode
  const float* bi;                 // [rows_fix]: profile mode
  const int* blk_row;
  const int* blk_seg0;
  const int* blk_seg1;
  const int* seg_ptr;
  const int* ent_fix;
  const float* ent_r;
  const float* ent_m;
  float mu, lo, hi;
  int k, kt, n_rows, n_long, round;
};

// the modes of gather_row
constexpr int GATHER_SUM = 0;
constexpr int GATHER_ERR = 1;
constexpr int GATHER_PROFILE = 2;

__device__ __forceinline__ float maybe_round(float x, bool round) {
  return round ? bf16_round(x) : x;
}

// one row's segments; BLOCK: all NW_STEP warps on the row, splitting each
// segment, else one warp; ROUND: each row rounded to bf16 before its sum
template <int KJ, int MODE, bool ROUND, int UU, bool BLOCK>
__device__ __forceinline__ void gather_row(const GatherArgs& a, int x,
                                           int warp, int lane,
                                           float (*red)[NW_STEP][KJ * 32]) {
  constexpr bool ERR = MODE == GATHER_ERR;
  constexpr bool PROF = MODE == GATHER_PROFILE;
  const int k = a.k;
  const int kt = a.kt;
  const size_t row = static_cast<size_t>(a.blk_row[x]);
  float acc[KJ], p[KJ];
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    const int c = lane + 32 * j;
    acc[j] = c < kt ? a.target[row * kt + c] : 0.f;
    p[j] = (ERR && c < k) ? a.prow[row * k + c] : 0.f;
  }
  // the profile mode's mu + b_u, once a row
  const float base = PROF ? __fadd_rn(a.mu, a.bu[row]) : 0.f;
  int buf = 0;
  const int s1 = a.blk_seg1[x];
  for (int s = a.blk_seg0[x]; s < s1; ++s) {
    const int e0 = a.seg_ptr[s];
    const int e1 = a.seg_ptr[s + 1];
    int b0 = e0, b1 = e1;
    if constexpr (BLOCK) {
      const int piece = (e1 - e0 + NW_STEP - 1) / NW_STEP;
      b0 = min(e1, e0 + warp * piece);
      b1 = min(e1, b0 + piece);
    }
    float sum[KJ];
#pragma unroll
    for (int j = 0; j < KJ; ++j) sum[j] = 0.f;
    for (int e = b0; e < b1; e += UU) {
      float v[UU][KJ], r[UU], m[UU];
#pragma unroll
      for (int u = 0; u < UU; ++u) {
        const bool ok = e + u < b1;
        const int i = ok ? e + u : b0;
        const int f = a.ent_fix[i];
        const size_t g = static_cast<size_t>(f) * k;
        if constexpr (ERR) {
          r[u] = a.ent_r[i];
          m[u] = a.ent_m[i];
        }
        if constexpr (PROF)     // r - ((mu + b_u) + b_j), as torch sums it
          r[u] = __fsub_rn(a.ent_r[i], __fadd_rn(base, a.bi[f]));
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          const int c = lane + 32 * j;
          v[u][j] = (ok && c < k) ? a.src[g + c] : 0.f;
        }
        if constexpr (PROF) {
#pragma unroll
          for (int j = 0; j < KJ; ++j) {
            const int c = lane + 32 * j;
            v[u][j] = (ok && c < k)
                          ? __fadd_rn(__fmul_rn(r[u], v[u][j]), a.src2[g + c])
                          : 0.f;
          }
        }
      }
      if constexpr (ERR) {
        float d[UU];
#pragma unroll
        for (int u = 0; u < UU; ++u) {
          d[u] = 0.f;
#pragma unroll
          for (int j = 0; j < KJ; ++j) d[u] = fmaf(p[j], v[u][j], d[u]);
        }
        // a butterfly: every lane ends with the same sum
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int u = 0; u < UU; ++u)
            d[u] += __shfl_xor_sync(0xffffffffu, d[u], o);
#pragma unroll
        for (int u = 0; u < UU; ++u) {
          const float pred = fminf(fmaxf(__fadd_rn(a.mu, d[u]), a.lo), a.hi);
          const float err = __fmul_rn(__fsub_rn(r[u], pred), m[u]);
#pragma unroll
          for (int j = 0; j < KJ; ++j) v[u][j] = __fmul_rn(err, v[u][j]);
        }
      }
      // in entry order, as scan_agg_launch sums the gathered rows
#pragma unroll
      for (int u = 0; u < UU; ++u) {
        if (e + u >= b1) break;
#pragma unroll
        for (int j = 0; j < KJ; ++j) sum[j] += maybe_round(v[u][j], ROUND);
      }
    }
    if constexpr (BLOCK) {
#pragma unroll
      for (int j = 0; j < KJ; ++j) red[buf][warp][j * 32 + lane] = sum[j];
      __syncthreads();
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        float tot = 0.f;
#pragma unroll
        for (int w = 0; w < NW_STEP; ++w) tot += red[buf][w][j * 32 + lane];
        sum[j] = tot;
      }
      buf ^= 1;
    }
#pragma unroll
    for (int j = 0; j < KJ; ++j) acc[j] += sum[j];
  }
  if (!BLOCK || warp == 0) {
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int c = lane + 32 * j;
      if (c < kt) a.target[row * kt + c] = acc[j];
    }
  }
}

template <int KJ, int MODE, bool ROUND>
__global__ void __launch_bounds__(NW_STEP * 32)
gather_agg_kernel(const GatherArgs a) {
  constexpr int UU = KJ <= 2 ? 2 * U : U;
  __shared__ float red[2][NW_STEP][KJ * 32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (static_cast<int>(blockIdx.x) < a.n_long) {     // block-uniform
    gather_row<KJ, MODE, ROUND, UU, true>(a, blockIdx.x, warp, lane, red);
  } else {
    const int x = a.n_long + (blockIdx.x - a.n_long) * NW_STEP + warp;
    if (x < a.n_rows)
      gather_row<KJ, MODE, ROUND, UU, false>(a, x, warp, lane, red);
  }
}

struct CallArgs {                  // window_agg_launch's arguments
  const float* g;
  const int* kl;
  const float* mask;
  int B, k, W;
  float* gsum;
  float* cnt;
  int* row_ptr;
  int* perm;
  int* hist;
};

struct ScanArgs {                  // scan_agg_launch's arguments
  float* target;
  const float* vals;
  const int* blk_row;
  const int* blk_seg0;
  const int* blk_seg1;
  const int* seg_ptr;
  int n_rows, k, mean;
};

size_t index_smem(int W) {
  const size_t bytes = static_cast<size_t>(W) * NW_INDEX * sizeof(int);
  return bytes <= INDEX_SMEM_MAX ? bytes : 0;
}

template <int KJ>
cudaError_t launch(const CallArgs& a, cudaStream_t s) {
  const size_t smem = index_smem(a.W);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        window_index_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        INDEX_SMEM_MAX);
    if (e != cudaSuccess) return e;
  }
  window_index_kernel<<<1, NW_INDEX * 32, smem, s>>>(
      a.kl, a.mask, a.B, a.W, smem ? nullptr : a.hist, a.row_ptr, a.perm);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  window_sum_kernel<KJ><<<a.W, NW_CALL * 32, 0, s>>>(a.g, a.row_ptr, a.perm,
                                                     a.k, a.gsum, a.cnt);
  return cudaGetLastError();
}

template <int KJ>
cudaError_t launch(const ScanArgs& a, cudaStream_t s) {
  const int blocks = (a.n_rows + NW_SCAN - 1) / NW_SCAN;
  scan_agg_kernel<KJ><<<blocks, NW_SCAN * 32, 0, s>>>(
      a.target, a.vals, a.blk_row, a.blk_seg0, a.blk_seg1, a.seg_ptr,
      a.n_rows, a.k, a.mean);
  return cudaGetLastError();
}

template <int KJ>
cudaError_t launch(const StepArgs& a, cudaStream_t s) {
  const int blocks =
      a.n_long + (a.n_rows - a.n_long + NW_STEP - 1) / NW_STEP;
  if (a.nt == 2) {
    if (KJ > MAX_KJ / 2) return cudaErrorInvalidValue;
    step_agg_kernel<(KJ > MAX_KJ / 2 ? MAX_KJ / 2 : KJ), 2>
        <<<blocks, NW_STEP * 32, 0, s>>>(a);
  } else {
    step_agg_kernel<KJ, 1><<<blocks, NW_STEP * 32, 0, s>>>(a);
  }
  return cudaGetLastError();
}

template <int KJ>
cudaError_t launch(const GatherArgs& a, cudaStream_t s) {
  const int blocks =
      a.n_long + (a.n_rows - a.n_long + NW_STEP - 1) / NW_STEP;
  if (a.prow)
    gather_agg_kernel<KJ, GATHER_ERR, true><<<blocks, NW_STEP * 32, 0, s>>>(a);
  else if (a.src2 && a.round)
    gather_agg_kernel<KJ, GATHER_PROFILE, true>
        <<<blocks, NW_STEP * 32, 0, s>>>(a);
  else if (a.src2)
    gather_agg_kernel<KJ, GATHER_PROFILE, false>
        <<<blocks, NW_STEP * 32, 0, s>>>(a);
  else
    gather_agg_kernel<KJ, GATHER_SUM, true><<<blocks, NW_STEP * 32, 0, s>>>(a);
  return cudaGetLastError();
}

// the column slots per lane, KJ = ceil(k / 32), as a template argument
template <class Args>
int dispatch(const Args& a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((a.k + 31) / 32) {
    case 1: err = launch<1>(a, s); break;
    case 2: err = launch<2>(a, s); break;
    case 3: err = launch<3>(a, s); break;
    case 4: err = launch<4>(a, s); break;
    case 5: err = launch<5>(a, s); break;
    case 6: err = launch<6>(a, s); break;
    case 7: err = launch<7>(a, s); break;
    default: err = launch<8>(a, s); break;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Bytes of int scratch window_agg_launch needs beside row_ptr [W+1] and
// perm [B]: the per-(row, warp) counts when they do not fit in shared
// memory, else 0.
long long window_agg_scratch_ints(int W) {
  return index_smem(W) ? 0 : static_cast<long long>(W) * NW_INDEX;
}

// gsum [W, k] and cnt [W] of g [B, k] by kl [B] under mask [B]; every
// output row is written.  row_ptr [W+1], perm [B] and hist
// [window_agg_scratch_ints(W)] are scratch.  Returns a cudaError_t (0:
// launched).  The caller checks 0 <= kl < W for the masked-in rows
// (others never match).
int window_agg_launch(const float* g, const int* kl, const float* mask,
                      int B, int k, int W, float* gsum, float* cnt,
                      int* row_ptr, int* perm, int* hist, void* stream) {
  if (k < 1 || k > 32 * MAX_KJ || B < 0 || W < 1 ||
      (!index_smem(W) && hist == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(CallArgs{g, kl, mask, B, k, W, gsum, cnt, row_ptr, perm,
                           hist},
                  stream);
}

// target[blk_row[x]] += the segment sums of rows x in [0, n_rows), each
// segment s summing vals[seg_ptr[s]:seg_ptr[s+1]] (divided by its length
// when mean), in segment order.  Returns a cudaError_t.
int scan_agg_launch(float* target, const float* vals, const int* blk_row,
                    const int* blk_seg0, const int* blk_seg1,
                    const int* seg_ptr, int n_rows, int k, int mean,
                    void* stream) {
  if (k < 1 || k > 32 * MAX_KJ || n_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  return dispatch(ScanArgs{target, vals, blk_row, blk_seg0, blk_seg1,
                           seg_ptr, n_rows, k, mean},
                  stream);
}

// The item step over rows x in [0, n_rows) of a segment table: nt (1 or
// 2) targets [rows, k], each with its per-entry weight coef_t (null: 1)
// and decay_t; rows [0, n_long) run one block each.  k * nt <= 256.
// Returns a cudaError_t.
int step_agg_launch(float* tgt0, float* tgt1, const float* coef0,
                    const float* coef1, float decay0, float decay1,
                    const float* G, const int* blk_row, const int* blk_seg0,
                    const int* blk_seg1, const int* seg_ptr,
                    const int* ent_fix, const float* ent_m, float step,
                    int k, int n_rows, int n_long, int row_mean, int nt,
                    void* stream) {
  if (k < 1 || nt < 1 || nt > 2 || k * nt > 32 * MAX_KJ || n_rows < 0 ||
      n_long < 0 || n_long > n_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  StepArgs a;
  a.tgt[0] = tgt0;
  a.tgt[1] = tgt1;
  a.coef[0] = coef0;
  a.coef[1] = coef1;
  a.decay[0] = decay0;
  a.decay[1] = decay1;
  a.G = G;
  a.blk_row = blk_row;
  a.blk_seg0 = blk_seg0;
  a.blk_seg1 = blk_seg1;
  a.seg_ptr = seg_ptr;
  a.ent_fix = ent_fix;
  a.ent_m = ent_m;
  a.step = step;
  a.k = k;
  a.n_rows = n_rows;
  a.n_long = n_long;
  a.row_mean = row_mean;
  a.nt = nt;
  return dispatch(a, stream);
}

// The gathered phase over rows x in [0, n_rows) of a segment table: with
// prow and src2 null, target[blk_row[x]] += the segment sums of the bf16
// rows src[ent_fix[e]] (kt = k); with prow, of bf16(err_e *
// src[ent_fix[e]][:kt]), err_e = (ent_r[e] - clamp(mu + prow[blk_row[x]]
// . src[ent_fix[e]], lo, hi)) * ent_m[e]; with src2 (and bu, bi), of
// res_e * src[ent_fix[e]] + src2[ent_fix[e]] (kt = k), res_e = ent_r[e] -
// ((mu + bu[blk_row[x]]) + bi[ent_fix[e]]), rounded to bf16 when round,
// else summed in full f32.  Rows [0, n_long) run one block each.  kt <= k
// <= 256; indexing in size_t.  Returns a cudaError_t.
int gather_agg_launch(float* target, const float* src, const float* prow,
                      const float* src2, const float* bu, const float* bi,
                      const int* blk_row, const int* blk_seg0,
                      const int* blk_seg1, const int* seg_ptr,
                      const int* ent_fix, const float* ent_r,
                      const float* ent_m, float mu, float lo, float hi,
                      int k, int kt, int n_rows, int n_long, int round,
                      void* stream) {
  if (k < 1 || k > 32 * MAX_KJ || kt < 1 || kt > k ||
      (!prow && kt != k) || (prow && src2) ||
      (src2 && (!bu || !bi)) || (!src2 && !round) || n_rows < 0 ||
      n_long < 0 || n_long > n_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  GatherArgs a;
  a.target = target;
  a.src = src;
  a.prow = prow;
  a.src2 = src2;
  a.bu = bu;
  a.bi = bi;
  a.round = round;
  a.blk_row = blk_row;
  a.blk_seg0 = blk_seg0;
  a.blk_seg1 = blk_seg1;
  a.seg_ptr = seg_ptr;
  a.ent_fix = ent_fix;
  a.ent_r = ent_r;
  a.ent_m = ent_m;
  a.mu = mu;
  a.lo = lo;
  a.hi = hi;
  a.k = k;
  a.kt = kt;
  a.n_rows = n_rows;
  a.n_long = n_long;
  return dispatch(a, stream);
}

const char* window_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

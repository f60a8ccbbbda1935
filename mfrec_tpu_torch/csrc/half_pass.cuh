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
// Design.  Window rows do not interact: row w's update reads only win[w]
// and the ratings with kl_b = w.  So a half-pass is, for each updated
// row, its segments (the row's ratings in one batch) in batch order,
// each run for T sweeps on that row alone; rows a batch's window covers
// but no rating touches keep their values.  The host builds the segment
// table once per layout (ops/half_pass_kernel.py: build_segments): the
// masked-in entries grouped by (row, batch), each entry's fixed-side row
// index, rating and mask, each segment's count, and the rows in
// longest-first order.  One call covers a whole half-pass (or any list
// of batches): one 8-warp block per updated row keeps the row in
// registers for all of its segments' sweeps, so the window never leaves
// the SM.  Within a sweep the warps split the segment's ratings, U = 4 at
// a time for memory-level parallelism; in a warp, lane l owns columns l,
// l+32, ... (k <= 256), the prediction dot is a butterfly shuffle sum
// (bit-identical in every lane), and each lane accumulates its columns of
// bf16(eff*ff).  A shared-memory sum over the warps (in a fixed order, so
// every warp computes the same new row) ends the sweep.  The fixed-side
// rows are gathered by index inside the kernel (the TPU path gathers them
// in XLA before the call); they stay in L1/L2 across the T sweeps.  Each
// block writes its row's SSE; the wrapper sums them.  The factor matrix
// is updated in place.
//
// What bounds it on an H100.  Per rating and sweep the math is about
// 4k FLOP (dot, eff*ff, accumulate): at the ML-10M shape (8,346,084
// ratings per half-pass, k=66, T=128) 282 GFLOP per half-pass, 4.2 ms at
// the 67 TFLOP/s FP32 peak; the bytes each half-pass must move (the
// segment table and both factor sides once) are about 0.2 GB, 0.06 ms at
// 3.35 TB/s.  So it is bound by operations, and the kernel by its
// instruction rate: a lane-per-column warp spends its instructions per
// rating and sweep on the column slots, the shuffle tree and the
// per-rating scalar work repeated in every lane.  Two things of the first
// version cost instructions or chain latency that the function does not
// need, and the design removes both:
//
// * Runtime options in the inner loop (the f32-dot select, which also
//   kept the dot from fusing into FMAs, the fixed side's type in every
//   load, the link, bias and clamp branches, the row-mean select).  Now
//   the link and the fixed side's type are compile-time (one build each),
//   the k <= 128 f32-dot rule follows from the column slots (a template
//   parameter), the clamp is a pair of bounds (+-inf when off:
//   fminf/fmaxf give the same bits for every finite value), the
//   prediction's base is a scalar (1 for bias_mode none, else mu), and
//   row_mean is a per-segment divisor and decay weight (divisor 1 and
//   weight cnt when off; __fdiv_rn by 1 is exact).
// * Hot rows' chains.  A popular item's ratings are one block's chain of
//   segments x T sweeps on one SM, which no schedule on one SM shortens.
//   Rows of at least CLUSTER_ROW ratings with long segments (k <= 160)
//   run as a thread-block cluster of CLUSTER = 8 blocks of 16 warps (two
//   per SM), launched on a second stream beside the 8-warp blocks.  Each
//   block owns a fixed slice of every segment's entries and reduces its
//   warps to a block partial in shared memory; after a cluster barrier
//   every block sums the cluster's partials over distributed shared
//   memory in rank order, so every block computes the same new row and
//   the result is deterministic.  The partials are double-buffered: one
//   cluster barrier per sweep.  Rank 0 writes the row and the SSE.  A
//   cluster pays that barrier every sweep, so short segments stay in
//   8-warp blocks.
//
// Packing the tail columns of the U ratings in flight into one shared
// column slot (k=66: 2.25 slots a rating instead of 3) measured slower
// on the H100 (its selects and combine cost more than the slot), and is
// not in this kernel.
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

constexpr int NW_NARROW = 8;       // warps per block, most rows
constexpr int NW_CLUSTER = 16;     // warps per block of a cluster row,
                                   // two blocks per SM (64 registers)
constexpr int CLUSTER = 8;         // blocks per cluster row
constexpr int U = 4;               // ratings a warp takes per step
constexpr int MAX_KJ = 8;          // column slots per lane: k <= 256
constexpr int MAX_KJ_CLUSTER = 5;  // clusters: k <= 160

struct Params {
  float* F_upd;                    // [rows, k] f32, updated in place
  const void* F_fix;               // [rows_fix, k] bf16 or f32
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
  float* sse_rows;                 // [n_blocks]
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: every lane adds the same pairs, so all lanes end equal
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float load_fix(const Params& p, size_t i) {
#if K1_FF16
  return __bfloat162float(static_cast<const __nv_bfloat16*>(p.F_fix)[i]);
#else
  return static_cast<const float*>(p.F_fix)[i];
#endif
}

// one term of the prediction's dot: f32 products fused into the sum for
// k <= 128, else each product rounded to bf16 before the f32 sum
template <bool DOT_F32>
__device__ __forceinline__ float dot_add(float d, float a, float b) {
  return DOT_F32 ? fmaf(a, b, d) : d + bf16_round(__fmul_rn(a, b));
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

// The row of block ``blk``, KJ column slots per lane, NW warps per block;
// CLUSTER_ROWS: the row is split over the CLUSTER blocks of a cluster,
// ``rank`` this block's.
template <int KJ, int NW, bool CLUSTER_ROWS>
__device__ __forceinline__ void run_row(const Params& p, int blk, int rank) {
  constexpr bool DOT_F32 = KJ <= 4;               // k <= 128
  constexpr int NRED = CLUSTER_ROWS ? 1 : 2;
  __shared__ float red[NRED][NW][KJ * 32];
  __shared__ float bpart[CLUSTER_ROWS ? 2 : 1][CLUSTER_ROWS ? KJ * 32 : 1];
  __shared__ float tot_s[CLUSTER_ROWS ? KJ * 32 : 1];
  __shared__ float sse_w[NW];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = p.k;
  float* wrow = p.F_upd + static_cast<size_t>(p.blk_row[blk]) * k;

  float win[KJ], lrv[KJ], regv[KJ];
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    const int c = lane + 32 * j;
    const bool on = c < k;
    win[j] = on ? wrow[c] : 0.f;
    lrv[j] = on ? p.lrv[c] : 0.f;
    regv[j] = on ? p.regv[c] : 0.f;
  }
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
    for (int t = 0; t < p.T; ++t) {
      float fu[KJ], acc[KJ];
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        fu[j] = bf16_round(win[j]);
        acc[j] = 0.f;
      }
      for (int base = e0 + warp * U; base < e1; base += NW * U) {
        float ff[U][KJ], r[U], m[U], part[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = base + u;
          const bool ok = e < e1;
          // a slot past the segment's end reads nothing and adds exact
          // zeros: m = 0 gives err = 0, so bf16(0*ff) = 0
          r[u] = ok ? p.ent_r[e] : 0.f;
          m[u] = ok ? p.ent_m[e] : 0.f;
          const size_t row = static_cast<size_t>(ok ? p.ent_fix[e] : 0) * k;
#pragma unroll
          for (int j = 0; j < KJ; ++j) {
            const int c = lane + 32 * j;
            ff[u][j] = (ok && c < k) ? load_fix(p, row + c) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float d = 0.f;
#pragma unroll
          for (int j = 0; j < KJ; ++j) d = dot_add<DOT_F32>(d, fu[j], ff[u][j]);
          part[u] = d;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) part[u] = warp_sum(part[u]);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float err, eff;
          residual(p, part[u], r[u], m[u], err, eff);
          if (t == 0) sse += err * err;
#pragma unroll
          for (int j = 0; j < KJ; ++j) acc[j] += bf16_round(eff * ff[u][j]);
        }
      }
      // sum the warps' partial sums in a fixed order
      float* rw = red[CLUSTER_ROWS ? 0 : buf][warp];
#pragma unroll
      for (int j = 0; j < KJ; ++j) rw[lane + 32 * j] = acc[j];
      __syncthreads();
      float tot[KJ];
      if constexpr (CLUSTER_ROWS) {
        // the block's partial, then every block sums the cluster's
        // partials over distributed shared memory in rank order
        cg::cluster_group cl = cg::this_cluster();
        if (threadIdx.x < KJ * 32) {
          float b = 0.f;
#pragma unroll
          for (int w = 0; w < NW; ++w) b += red[0][w][threadIdx.x];
          bpart[buf][threadIdx.x] = b;
        }
        cl.sync();
        if (threadIdx.x < KJ * 32) {
          float c = 0.f;
#pragma unroll
          for (int q = 0; q < CLUSTER; ++q)
            c += cl.map_shared_rank(&bpart[buf][0], q)[threadIdx.x];
          tot_s[threadIdx.x] = c;
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < KJ; ++j) tot[j] = tot_s[lane + 32 * j];
      } else {
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          float v = 0.f;
#pragma unroll
          for (int w = 0; w < NW; ++w) v += red[buf][w][lane + 32 * j];
          tot[j] = v;
        }
      }
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float reg = regv[j] * win[j];
        win[j] = win[j] + lrv[j] * (__fdiv_rn(tot[j], den) - reg * rc);
      }
      buf ^= 1;
    }
  }

  if ((!CLUSTER_ROWS || rank == 0) && warp == 0) {
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int c = lane + 32 * j;
      if (c < k) wrow[c] = win[j];
    }
  }
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

template <int KJ>
__global__ void __launch_bounds__(NW_NARROW * 32)
half_pass_rows(const Params p, int blk_begin) {
  run_row<KJ, NW_NARROW, false>(p, blk_begin + blockIdx.x, 0);
}

template <int KJ>
__global__ void __launch_bounds__(NW_CLUSTER * 32, 2)
half_pass_cluster_rows(const Params p, int blk_begin) {
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  run_row<KJ, NW_CLUSTER, true>(p, blk_begin + blockIdx.x / CLUSTER, rank);
}

template <int KJ>
cudaError_t launch_cluster(const Params& p, int blk_begin, int blk_end,
                           cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((blk_end - blk_begin) * CLUSTER);
  cfg.blockDim = dim3(NW_CLUSTER * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, half_pass_cluster_rows<KJ>, p, blk_begin);
}

template <int KJ>
cudaError_t launch(const Params& p, int blk_begin, int blk_end, bool cluster,
                   cudaStream_t stream) {
  if (cluster) {
    if (KJ > MAX_KJ_CLUSTER) return cudaErrorInvalidValue;
    return launch_cluster<(KJ > MAX_KJ_CLUSTER ? MAX_KJ_CLUSTER : KJ)>(
        p, blk_begin, blk_end, stream);
  }
  half_pass_rows<KJ><<<blk_end - blk_begin, NW_NARROW * 32, 0, stream>>>(
      p, blk_begin);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K1 over blocks [blk_begin, blk_end) of a segment table (one half-pass
// or any list of batches): as thread-block clusters of CLUSTER blocks
// when ``wide`` (k <= 160), else 8-warp blocks.  fix_bf16 must match this build's
// fixed-side type.  Returns a cudaError_t (0 = launched).  k in 1..256,
// T >= 1.
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
  p.F_fix = F_fix;
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
  p.sse_rows = sse_rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool c = wide != 0;
  cudaError_t err;
  switch ((k + 31) / 32) {
    case 1: err = launch<1>(p, blk_begin, blk_end, c, s); break;
    case 2: err = launch<2>(p, blk_begin, blk_end, c, s); break;
    case 3: err = launch<3>(p, blk_begin, blk_end, c, s); break;
    case 4: err = launch<4>(p, blk_begin, blk_end, c, s); break;
    case 5: err = launch<5>(p, blk_begin, blk_end, c, s); break;
    case 6: err = launch<6>(p, blk_begin, blk_end, c, s); break;
    case 7: err = launch<7>(p, blk_begin, blk_end, c, s); break;
    default: err = launch<8>(p, blk_begin, blk_end, c, s); break;
  }
  return static_cast<int>(err);
}

const char* half_pass_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

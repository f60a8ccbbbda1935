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
// of batches): one block per updated row keeps the row in registers for
// all of its segments' sweeps, so the window never leaves the SM.  A
// block has 8 warps, or 32 for the long rows (at least 4,096 ratings, the
// hot items), which the wrapper launches on a second stream beside the
// 8-warp blocks.  Within a sweep the warps split the segment's ratings, four at
// a time for memory-level parallelism; in a warp, lane l owns columns
// l, l+32, ... (k <= 256), the prediction dot is a butterfly shuffle
// sum (bit-identical in every lane), and each lane accumulates its
// columns of bf16(eff*ff).  A shared-memory sum over the warps (in a
// fixed order, so every warp computes the same new row) ends the sweep.
// The fixed-side rows are gathered by index inside the kernel (the TPU
// path gathers them in XLA before the call); they stay in L1/L2 across
// the T sweeps.  Each block writes its row's SSE; the wrapper sums them.
// The factor matrix is updated in place.
//
// What bounds it on an H100.  Per rating and sweep the math is about
// 4k FLOP (dot, eff*ff, accumulate): at the ML-10M shape (8,346,084
// ratings per half-pass, k=66, T=128) 282 GFLOP per half-pass, 4.2 ms at
// the 67 TFLOP/s FP32 peak; the bytes each half-pass must move (the
// segment table and both factor sides once) are about 0.2 GB, 0.06 ms at
// 3.35 TB/s.  So it is bound by operations, and this first kernel is
// bound by instruction issue: a lane-per-column warp spends about 45
// instructions per rating and sweep at k=66 (a third of its lanes idle
// on the last column slot, the shuffle tree and the per-rating scalar
// work repeated in every lane).  A hot row (an item rated by most users)
// is one block's sequential chain of segments x T sweeps on one SM,
// which no schedule shortens and which is latency-bound (each rating
// gathers a fixed row from L2); its 32 warps keep 4x the loads of an
// 8-warp block in flight, and the longest-first order starts those
// chains first.  Splitting a hot row over a thread-block cluster, and
// packing two ratings per warp, are left for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC.  Plain C interface, loaded by ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW_NARROW = 8;       // warps per block, most rows
constexpr int NW_WIDE = 32;        // warps per block, long rows
constexpr int U = 4;               // ratings a warp takes per step
constexpr int MAX_KJ = 8;          // column slots per lane: k <= 256
constexpr int MAX_KJ_WIDE = 5;     // wide blocks: k <= 160 (48 KB of
                                   // static shared memory)

struct Params {
  float* F_upd;                    // [rows, k] f32, updated in place
  const void* F_fix;               // [rows_fix, k] bf16 or f32
  int fix_bf16;
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
  float mu, lo_r, hi_r;
  int k, T;
  int clamp_pred, row_mean, bias_none, logistic, dot_f32;
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

template <int KJ>
__device__ __forceinline__ void load_row(const Params& p, int fr, int lane,
                                         float (&ff)[KJ]) {
  const size_t base = static_cast<size_t>(fr) * p.k;
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    const int c = lane + 32 * j;
    float v = 0.f;
    if (c < p.k) {
      v = p.fix_bf16
              ? __bfloat162float(
                    static_cast<const __nv_bfloat16*>(p.F_fix)[base + c])
              : static_cast<const float*>(p.F_fix)[base + c];
    }
    ff[j] = v;
  }
}

template <int KJ, int NW>
__global__ void __launch_bounds__(NW * 32)
half_pass_rows(const Params p, int blk_begin) {
  __shared__ float red[2][NW][KJ * 32];
  __shared__ float sse_w[NW];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int blk = blk_begin + blockIdx.x;
  float* wrow = p.F_upd + static_cast<size_t>(p.blk_row[blk]) * p.k;

  float win[KJ], lrv[KJ], regv[KJ];
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    const int c = lane + 32 * j;
    const bool on = c < p.k;
    win[j] = on ? wrow[c] : 0.f;
    lrv[j] = on ? p.lrv[c] : 0.f;
    regv[j] = on ? p.regv[c] : 0.f;
  }
  const float rng_w = p.hi_r - p.lo_r;
  float sse = 0.f;
  int buf = 0;

  for (int s = p.blk_seg0[blk]; s < p.blk_seg1[blk]; ++s) {
    const int e0 = p.seg_ptr[s];
    const int e1 = p.seg_ptr[s + 1];
    const float cnt = p.seg_cnt[s];
    const float alive = cnt > 0.f ? 1.f : 0.f;
    const float den = fmaxf(cnt, 1.f);
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
          if (ok) {
            load_row<KJ>(p, p.ent_fix[e], lane, ff[u]);
          } else {
#pragma unroll
            for (int j = 0; j < KJ; ++j) ff[u][j] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float d = 0.f;
#pragma unroll
          for (int j = 0; j < KJ; ++j) {
            const float prod = fu[j] * ff[u][j];
            d += p.dot_f32 ? prod : bf16_round(prod);
          }
          part[u] = d;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) part[u] = warp_sum(part[u]);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float dot = part[u];
          float err, eff;
          if (p.logistic) {
            const float sig = 1.f / (1.f + expf(-dot));
            const float pred = p.lo_r + sig * rng_w;
            err = (r[u] - pred) * m[u];
            eff = err * sig * (1.f - sig) * rng_w;
          } else {
            float pred = p.bias_none ? 1.f + dot : p.mu + dot;
            if (p.clamp_pred) pred = fminf(fmaxf(pred, p.lo_r), p.hi_r);
            err = (r[u] - pred) * m[u];
            eff = err;
          }
          if (t == 0) sse += err * err;
#pragma unroll
          for (int j = 0; j < KJ; ++j) acc[j] += bf16_round(eff * ff[u][j]);
        }
      }
      // sum the warps' partial sums in a fixed order; the two buffers
      // let the next sweep write while a slow warp still reads this one
#pragma unroll
      for (int j = 0; j < KJ; ++j) red[buf][warp][lane + 32 * j] = acc[j];
      __syncthreads();
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        float tot = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) tot += red[buf][w][lane + 32 * j];
        const float reg = regv[j] * win[j];
        const float gsum = p.row_mean ? __fdiv_rn(tot, den) - reg * alive
                                      : tot - reg * cnt;
        win[j] = win[j] + lrv[j] * gsum;
      }
      buf ^= 1;
    }
  }

  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int c = lane + 32 * j;
      if (c < p.k) wrow[c] = win[j];
    }
  }
  if (lane == 0) sse_w[warp] = sse;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) s += sse_w[w];
    p.sse_rows[blk] = s;
  }
}

template <int KJ>
cudaError_t launch(const Params& p, int blk_begin, int blk_end, int wide,
                   cudaStream_t stream) {
  if (wide) {
    if (KJ > MAX_KJ_WIDE) return cudaErrorInvalidValue;
    half_pass_rows<(KJ > MAX_KJ_WIDE ? MAX_KJ_WIDE : KJ), NW_WIDE>
        <<<blk_end - blk_begin, NW_WIDE * 32, 0, stream>>>(p, blk_begin);
  } else {
    half_pass_rows<KJ, NW_NARROW>
        <<<blk_end - blk_begin, NW_NARROW * 32, 0, stream>>>(p, blk_begin);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K1 over blocks [blk_begin, blk_end) of a segment table (one half-pass
// or any list of batches), with blocks of 32 warps when ``wide`` (k <=
// 160), else of 8.  Returns a cudaError_t (0 = launched).  k in 1..256,
// T >= 1.
int half_pass_launch(float* F_upd, const void* F_fix, int fix_bf16,
                     const int* blk_row, const int* blk_seg0,
                     const int* blk_seg1, int blk_begin, int blk_end,
                     int wide, const int* seg_ptr,
                     const float* seg_cnt, const int* ent_fix,
                     const float* ent_r, const float* ent_m,
                     const float* lrv, const float* regv, float mu, int k,
                     int T, float lo_r, float hi_r, int clamp_pred,
                     int row_mean, int bias_none, int logistic, int dot_f32,
                     float* sse_rows, void* stream) {
  if (k < 1 || k > 32 * MAX_KJ || T < 1 || blk_begin < 0 ||
      blk_end < blk_begin || (wide && k > 32 * MAX_KJ_WIDE))
    return static_cast<int>(cudaErrorInvalidValue);
  if (blk_end == blk_begin) return 0;
  Params p;
  p.F_upd = F_upd;
  p.F_fix = F_fix;
  p.fix_bf16 = fix_bf16;
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
  p.mu = mu;
  p.lo_r = lo_r;
  p.hi_r = hi_r;
  p.k = k;
  p.T = T;
  p.clamp_pred = clamp_pred;
  p.row_mean = row_mean;
  p.bias_none = bias_none;
  p.logistic = logistic;
  p.dot_f32 = dot_f32;
  p.sse_rows = sse_rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((k + 31) / 32) {
    case 1: err = launch<1>(p, blk_begin, blk_end, wide, s); break;
    case 2: err = launch<2>(p, blk_begin, blk_end, wide, s); break;
    case 3: err = launch<3>(p, blk_begin, blk_end, wide, s); break;
    case 4: err = launch<4>(p, blk_begin, blk_end, wide, s); break;
    case 5: err = launch<5>(p, blk_begin, blk_end, wide, s); break;
    case 6: err = launch<6>(p, blk_begin, blk_end, wide, s); break;
    case 7: err = launch<7>(p, blk_begin, blk_end, wide, s); break;
    default: err = launch<8>(p, blk_begin, blk_end, wide, s); break;
  }
  return static_cast<int>(err);
}

const char* half_pass_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

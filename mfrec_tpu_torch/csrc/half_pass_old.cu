// P1 on Hopper: the round-2 sorted-window batch step, kept for A/B runs
// against K1.
//
// Replaces the Pallas TPU kernel tools/ab_kernel.py (_kernel_old, entered
// through half_pass_batch_old with W, lo 1, hi 5, clamp_pred, row_mean,
// no bias_none).  Per batch of B ratings against a W-row window, T
// sweeps of
//
//     fu   = bf16(win)[kl]                       exact gather of the
//                                                bf16-rounded window
//     dot  = sum_k fu*ff                         f32 at every k
//     pred = clamp(mu + dot, 1, 5); err = (r - pred)*m; SSE from t = 0
//     g    = err*ff - regv*fu*m                  per rating
//     acc  = sum_b bf16([g_b | m_b]) into row kl_b, in f32
//     win += lrv * acc[:, :k] / max(acc[:, k], 1)
//
// It differs from K1 (csrc/half_pass.cu) in four ways: the
// regularization term rides each rating and is rounded to bf16 with the
// error term; the count is summed every sweep from the bf16 m column; no
// alive mask; no bf16-product rule for k > 128.
//
// Design: K1's.  Window rows do not interact (a row with no rating gets
// g = 0 and count 0, so it keeps its value), so a half-pass is, per
// updated row, its per-batch segments in batch order, T sweeps each,
// over the segment table that ops/half_pass_kernel.py build_segments
// makes (entries with m = 0 add exact zeros to both the sums and the
// count, and are left out).  One block per row keeps it in registers
// through all of its segments; 8 warps, or 32 for rows of >= 4,096
// ratings on a second stream; lanes own columns l, l+32, ...; the dot is
// a butterfly shuffle sum; a fixed-order shared-memory sum over the warps
// ends each sweep.  The products that JAX rounds one by one (err*ff,
// regv*fu*m and their difference) are rounded one by one here too
// (__fmul_rn / __fsub_rn: no FMA contraction before the bf16 rounding).
//
// What bounds it on an H100: operations, as K1.  Per rating and sweep
// the function needs 6k FLOP (dot 2k; err*ff, (regv*fu)*m and the
// difference 3k, regv*fu being the row's own; accumulate k) against K1's
// 4k; the bytes (the segment table and both factor sides once) are
// negligible beside them.  The kernel takes regv*fu for every rating
// (7k): taking it once a sweep gives the same bits but made the A/B
// tool's epoch 7.5 % slower on the H100 (PERF.md).  Like K1 it is
// issue-bound in practice.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC.  Plain C interface, loaded by ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW_NARROW = 8;
constexpr int NW_WIDE = 32;
constexpr int U = 4;               // ratings a warp takes per step
constexpr int MAX_KJ = 8;          // k <= 256
constexpr int MAX_KJ_WIDE = 5;     // wide blocks: k <= 160

struct Params {
  float* F_upd;                    // [rows, k] f32, updated in place
  const void* F_fix;               // [rows_fix, k] bf16 or f32
  int fix_bf16;
  const int* blk_row;              // [n_blocks]
  const int* blk_seg0;
  const int* blk_seg1;
  const int* seg_ptr;              // [n_seg + 1]
  const int* ent_fix;              // [n_ent]
  const float* ent_r;
  const float* ent_m;
  const float* lrv;                // [k]
  const float* regv;               // [k]
  float mu;
  int k, T;
  float* sse_rows;                 // [n_blocks]
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
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
half_pass_old_rows(const Params p, int blk_begin) {
  __shared__ float red[2][NW][KJ * 32];
  __shared__ float red_cnt[2][NW];
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
  float sse = 0.f;
  int buf = 0;

  for (int s = p.blk_seg0[blk]; s < p.blk_seg1[blk]; ++s) {
    const int e0 = p.seg_ptr[s];
    const int e1 = p.seg_ptr[s + 1];
    for (int t = 0; t < p.T; ++t) {
      float fu[KJ], acc[KJ];
      float cnt = 0.f;
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
          // a slot past the segment's end adds exact zeros (m = 0)
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
          for (int j = 0; j < KJ; ++j) d += fu[j] * ff[u][j];
          part[u] = d;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) part[u] = warp_sum(part[u]);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float pred = fminf(fmaxf(p.mu + part[u], 1.f), 5.f);
          const float err = (r[u] - pred) * m[u];
          if (t == 0) sse += err * err;
#pragma unroll
          for (int j = 0; j < KJ; ++j) {
            const float g = __fsub_rn(
                __fmul_rn(err, ff[u][j]),
                __fmul_rn(__fmul_rn(regv[j], fu[j]), m[u]));
            acc[j] += bf16_round(g);
          }
          cnt += bf16_round(m[u]);
        }
      }
#pragma unroll
      for (int j = 0; j < KJ; ++j) red[buf][warp][lane + 32 * j] = acc[j];
      if (lane == 0) red_cnt[buf][warp] = cnt;
      __syncthreads();
      float c = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) c += red_cnt[buf][w];
      const float den = fmaxf(c, 1.f);
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        float tot = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) tot += red[buf][w][lane + 32 * j];
        win[j] = win[j] + lrv[j] * __fdiv_rn(tot, den);
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
    half_pass_old_rows<(KJ > MAX_KJ_WIDE ? MAX_KJ_WIDE : KJ), NW_WIDE>
        <<<blk_end - blk_begin, NW_WIDE * 32, 0, stream>>>(p, blk_begin);
  } else {
    half_pass_old_rows<KJ, NW_NARROW>
        <<<blk_end - blk_begin, NW_NARROW * 32, 0, stream>>>(p, blk_begin);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// P1 over blocks [blk_begin, blk_end) of a segment table, in blocks of 32
// warps when ``wide`` (k <= 160), else of 8.  Returns a cudaError_t (0 =
// launched).  k in 1..256, T >= 1.
int half_pass_old_launch(float* F_upd, const void* F_fix, int fix_bf16,
                         const int* blk_row, const int* blk_seg0,
                         const int* blk_seg1, int blk_begin, int blk_end,
                         int wide, const int* seg_ptr, const int* ent_fix,
                         const float* ent_r, const float* ent_m,
                         const float* lrv, const float* regv, float mu, int k,
                         int T, float* sse_rows, void* stream) {
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
  p.ent_fix = ent_fix;
  p.ent_r = ent_r;
  p.ent_m = ent_m;
  p.lrv = lrv;
  p.regv = regv;
  p.mu = mu;
  p.k = k;
  p.T = T;
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

const char* half_pass_old_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

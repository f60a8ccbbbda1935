// K1f on Hopper: a sorted-window half-pass in which one column moves.
//
// FN's user half-pass (mfrec_tpu/ops/fn.py:141-252, through K1 with the
// factor columns' rates zeroed) trains b_u alone: every column of the
// updated rows but ``col`` has rate 0, so K1 leaves them as they are and
// spends its 4 k T operations a rating on one scalar.  With those columns
// and the fixed side constant over the half-pass, the part of K1's dot
// they give is the same in every sweep:
//
//     s_e  = sum_{c != col} bf16(a_c) * ff_c      (f32; the products
//                                                 rounded to bf16 first
//                                                 for k > 128, as K1)
//     w_e  = ff_col                               (1: Q's constant column)
//
// K1f forms s_e once an entry and then runs K1's T sweeps on the one
// column, as FN runs K1 (identity link, learned biases, f32 fixed rows):
// with x the row's value in column col,
//
//     dot  = s_e + bf16(x) * w_e                  (bf16-rounded product
//                                                 for k > 128)
//     pred = clamp(mu + dot)
//     err  = (r - pred)*m                         SSE from the t=0 residual
//     acc  = sum_seg bf16(err * w_e)              in f32
//     x   += lrv_col*(acc/max(cnt,1) - regv_col*x*[cnt>0])    (row_mean)
//     x   += lrv_col*(acc - regv_col*x*cnt)                    (otherwise)
//
// and writes column col back; every other column is left untouched.
//
// Work list: K1's segment table (ops/half_pass_kernel.py: build_segments)
// as it is, rows longest first.  A row's segments run in batch order, T
// sweeps each.  Each entry's record (s_e, w_e, r, m) is formed once, by a
// warp that gathers the entry's fixed row with coalesced loads, U = 4
// entries a step (K1's transposed butterfly for the dot's sum), and kept
// on chip for the T sweeps:
//
// * Rows of at most WARP_CAP entries: a warp each, eight to a block, the
//   records in the warp's WARP_CAP slots of shared memory.  A sweep is a
//   lane's entries in order, one butterfly over the warp (every lane ends
//   with the same sum), and the update, computed alike in every lane.
// * Longer rows (heavy users up to a whole batch in one segment): a block
//   each, the records in the block's BLOCK_CAP slots of shared memory and
//   the rest in a global scratch the wrapper allocates (ovf_off gives each
//   such block its region: its row's length less BLOCK_CAP).  A sweep
//   ends with the warps' sums in shared memory (double-buffered: one
//   barrier a sweep), added in warp order by every thread.
//
// The long rows lead the table (they are its longest), so blocks
// [0, n_long) take a row each and every later block eight rows.  No
// atomics, every sum in a fixed order: two launches give the same bits.
// One launch a half-pass, on the caller's stream.
//
// What bounds it on an H100: the gather.  Forming s_e reads each entry's
// fixed row once (408 bytes at FN's k = 102 in f32) from L2, where the
// fixed side (7.2 MB at Netflix) stays; the sweeps are about ten
// operations an entry each, on records in shared memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC.  Plain C interface, loaded by ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;                       // warps a block
constexpr int U = 4;                        // entries a warp's dot step takes
constexpr int GRP = 32 / U;                 // lanes that finish one dot
constexpr int MAX_KJ = 8;                   // column slots a lane: k <= 256
constexpr int WARP_CAP = 384;               // records a warp's row keeps
constexpr int BLOCK_CAP = NW * WARP_CAP;    // records a block's row keeps
                                            // (48 KB: four blocks an SM)

struct Params {
  float* F_upd;                    // [rows, k] f32; column col updated
  const float* F_fix;              // [rows_fix, k]
  const int* blk_row;              // [n_blocks] the table's rows
  const int* blk_seg0;             // [n_blocks] a row's first segment
  const int* blk_seg1;             // [n_blocks] one past its last
  const int* seg_ptr;              // [n_seg + 1] entry offsets
  const float* seg_cnt;            // [n_seg] sum of bf16(m)
  const int* ent_fix;              // [n_ent] fixed-side row
  const float* ent_r;              // [n_ent] rating
  const float* ent_m;              // [n_ent] mask (nonzero)
  const float* lrv;                // [k] (only lrv[col] is read)
  const float* regv;               // [k]
  float mu;                        // the global mean
  float lo_c, hi_c;                // clamp bounds (+-inf: no clamp)
  int k, col, T, row_mean;
  int n_long, n_blocks;            // rows [0, n_long) run as blocks
  const int* ovf_off;              // [n_long] a long row's scratch offset
  float4* ovf;                     // the records past BLOCK_CAP
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

// K1's transposed butterfly: lane l ends with a partial of entry l / GRP
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

// The records of a segment's n entries from global entry e0 on: warp wg of
// the g warps on the row takes the U-entry groups wg, wg + g, ...; lane
// l's slot j holds column l + 32 j, a[j] its bf16 row value (0 at col and
// past k).  Record i goes to slot i of ``stash`` below ``cap``, else to
// ``ovf[i - cap]``.
template <int KJ, bool DOT_F32>
__device__ __forceinline__ void form_records(const Params& p,
                                             const float (&a)[KJ], int e0,
                                             int n, int wg, int g, int lane,
                                             float4* stash, float4* ovf,
                                             int cap) {
  const float* F = p.F_fix;
  const int k = p.k;
  for (int b = wg * U; b < n; b += g * U) {
    int fx[U];
#pragma unroll
    for (int u = 0; u < U; ++u) fx[u] = p.ent_fix[e0 + min(b + u, n - 1)];
    float v[U][KJ];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int c = lane + 32 * j;
        v[u][j] = c < k ? F[static_cast<size_t>(fx[u]) * k + c] : 0.f;
      }
    float part[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      part[u] = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        if constexpr (DOT_F32)
          part[u] = fmaf(a[j], v[u][j], part[u]);
        else
          part[u] += bf16_round(__fmul_rn(a[j], v[u][j]));
      }
    }
    fold<U>(part, lane, 16);
    float dot = part[0];
#pragma unroll
    for (int o = GRP / 2; o > 0; o >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    const int mine = lane / GRP;
    const int i = b + mine;
    if (lane % GRP == 0 && i < n) {
      int f = fx[0];
#pragma unroll
      for (int u = 1; u < U; ++u)
        if (u == mine) f = fx[u];
      const int e = e0 + i;
      const float4 rec = make_float4(dot, F[static_cast<size_t>(f) * k + p.col],
                                     p.ent_r[e], p.ent_m[e]);
      if (i < cap)
        stash[i] = rec;
      else
        ovf[i - cap] = rec;
    }
  }
}

// Row ``blk`` of the table: BLOCK, on the whole block (records in the
// block's stash and its scratch region), else on this warp alone
// (``stash``: the warp's slots).
template <int KJ, bool BLOCK>
__device__ __forceinline__ void run_row(const Params& p, int blk,
                                        float4* stash, float* red,
                                        float* sse_w) {
  constexpr bool DOT_F32 = KJ <= 4;           // k <= 128, as K1
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = p.k;
  const int col = p.col;
  float* wrow = p.F_upd + static_cast<size_t>(p.blk_row[blk]) * k;
  float a[KJ];
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    const int c = lane + 32 * j;
    a[j] = (c < k && c != col) ? bf16_round(wrow[c]) : 0.f;
  }
  float x = wrow[col];
  const float lr = p.lrv[col];
  const float reg = p.regv[col];
  const int cap = BLOCK ? BLOCK_CAP : WARP_CAP;
  float4* ovf = BLOCK ? p.ovf + p.ovf_off[blk] : nullptr;
  const int tid = BLOCK ? threadIdx.x : lane;
  const int nthreads = BLOCK ? NW * 32 : 32;
  float sse = 0.f;
  int buf = 0;

  for (int s = p.blk_seg0[blk]; s < p.blk_seg1[blk]; ++s) {
    const int e0 = p.seg_ptr[s];
    const int n = p.seg_ptr[s + 1] - e0;
    const float cnt = p.seg_cnt[s];
    // row_mean: the mean gradient, decay only on a live row; otherwise
    // the sum, decay times the count
    const float den = p.row_mean ? fmaxf(cnt, 1.f) : 1.f;
    const float rc = p.row_mean ? (cnt > 0.f ? 1.f : 0.f) : cnt;
    form_records<KJ, DOT_F32>(p, a, e0, n, BLOCK ? warp : 0,
                                    BLOCK ? NW : 1, lane, stash, ovf, cap);
    if constexpr (BLOCK)
      __syncthreads();
    else
      __syncwarp();
    for (int t = 0; t < p.T; ++t) {
      const float x16 = bf16_round(x);
      float acc = 0.f;
      for (int i = tid; i < n; i += nthreads) {
        const float4 q = i < cap ? stash[i] : ovf[i - cap];
        const float dot = DOT_F32 ? fmaf(x16, q.y, q.x)
                                  : q.x + bf16_round(__fmul_rn(x16, q.y));
        const float err =
            (q.z - fminf(fmaxf(p.mu + dot, p.lo_c), p.hi_c)) * q.w;
        if (t == 0) sse += err * err;
        acc += bf16_round(err * q.y);
      }
      float tot = warp_sum(acc);
      if constexpr (BLOCK) {
        // the warps' sums in warp order, in every thread
        if (lane == 0) red[buf * NW + warp] = tot;
        __syncthreads();
        tot = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) tot += red[buf * NW + w];
        buf ^= 1;
      }
      const float rx = reg * x;
      x = x + lr * (__fdiv_rn(tot, den) - rx * rc);
    }
    if constexpr (!BLOCK) __syncwarp();    // before the next segment's records
  }

  sse = warp_sum(sse);
  if constexpr (BLOCK) {
    if (lane == 0) sse_w[warp] = sse;
    __syncthreads();
    if (threadIdx.x == 0) {
      float tot = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) tot += sse_w[w];
      p.sse_rows[blk] = tot;
      wrow[col] = x;
    }
  } else if (lane == 0) {
    p.sse_rows[blk] = sse;
    wrow[col] = x;
  }
}

// four blocks an SM at up to four column slots (k <= 128), else two
template <int KJ>
__global__ void __launch_bounds__(NW * 32, KJ <= 4 ? 4 : 2)
frozen_half_pass_rows(const Params p) {
  extern __shared__ __align__(16) float4 stash[];
  __shared__ float red[2 * NW];
  __shared__ float sse_w[NW];
  const int b = blockIdx.x;
  if (b < p.n_long) {
    run_row<KJ, true>(p, b, stash, red, sse_w);
  } else {
    const int warp = threadIdx.x >> 5;
    const int blk = p.n_long + (b - p.n_long) * NW + warp;
    if (blk < p.n_blocks)
      run_row<KJ, false>(p, blk, stash + warp * WARP_CAP, red, sse_w);
  }
}

constexpr size_t STASH_BYTES = BLOCK_CAP * sizeof(float4);

template <int KJ>
cudaError_t prepare(const void** fn) {
  *fn = reinterpret_cast<const void*>(frozen_half_pass_rows<KJ>);
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(STASH_BYTES));
}

struct Launch {
  const Params& p;
  int grid;
  cudaStream_t stream;
  template <int KJ>
  cudaError_t run() const {
    const void* fn;
    cudaError_t err = prepare<KJ>(&fn);
    if (err != cudaSuccess) return err;
    frozen_half_pass_rows<KJ><<<grid, NW * 32, STASH_BYTES, stream>>>(p);
    return cudaGetLastError();
  }
};

struct Occupancy {
  int* blocks;
  template <int KJ>
  cudaError_t run() const {
    const void* fn;
    cudaError_t err = prepare<KJ>(&fn);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, NW * 32,
                                                         STASH_BYTES);
  }
};

// f.template run<KJ>() for width k (KJ = ceil(k / 32) column slots a lane)
template <class F>
cudaError_t by_width(int k, const F& f) {
  switch ((k + 31) / 32) {
    case 1: return f.template run<1>();
    case 2: return f.template run<2>();
    case 3: return f.template run<3>();
    case 4: return f.template run<4>();
    case 5: return f.template run<5>();
    case 6: return f.template run<6>();
    case 7: return f.template run<7>();
    default: return f.template run<MAX_KJ>();
  }
}

}  // namespace

extern "C" {

// K1f over a whole segment table of n_blocks rows, the first n_long of
// them (longer than WARP_CAP entries) a block each, the others a warp
// each; ovf_off [n_long] gives each long row its region of ovf (records
// past BLOCK_CAP: at least its length less BLOCK_CAP).  Every column of
// F_upd but col must have rate 0: K1f writes column col alone.  Returns a
// cudaError_t (0 = launched).  k in 1..256, 0 <= col < k, T >= 1.
int frozen_half_pass_launch(float* F_upd, const float* F_fix,
                            const int* blk_row, const int* blk_seg0,
                            const int* blk_seg1, int n_blocks, int n_long,
                            const int* ovf_off, void* ovf,
                            const int* seg_ptr, const float* seg_cnt,
                            const int* ent_fix, const float* ent_r,
                            const float* ent_m, const float* lrv,
                            const float* regv, float mu, float lo_c,
                            float hi_c, int k, int col, int T, int row_mean,
                            float* sse_rows, void* stream) {
  if (k < 1 || k > 32 * MAX_KJ || col < 0 || col >= k || T < 1 ||
      n_long < 0 || n_blocks < n_long)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks == 0) return 0;
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
  p.mu = mu;
  p.lo_c = lo_c;
  p.hi_c = hi_c;
  p.k = k;
  p.col = col;
  p.T = T;
  p.row_mean = row_mean;
  p.n_long = n_long;
  p.n_blocks = n_blocks;
  p.ovf_off = ovf_off;
  p.ovf = static_cast<float4*>(ovf);
  p.sse_rows = sse_rows;
  const int grid = n_long + (n_blocks - n_long + NW - 1) / NW;
  return static_cast<int>(
      by_width(k, Launch{p, grid, static_cast<cudaStream_t>(stream)}));
}

// The kernel's geometry: *warp_cap entries a row may have to run on one
// warp, *block_cap records a long row keeps in shared memory, and (unless
// blocks_per_sm is null) the blocks an SM holds at width k.  Returns a
// cudaError_t.
int frozen_half_pass_geometry(int k, int* warp_cap, int* block_cap,
                              int* blocks_per_sm) {
  if (k < 1 || k > 32 * MAX_KJ) return static_cast<int>(cudaErrorInvalidValue);
  *warp_cap = WARP_CAP;
  *block_cap = BLOCK_CAP;
  if (blocks_per_sm == nullptr) return 0;
  return static_cast<int>(by_width(k, Occupancy{blocks_per_sm}));
}

const char* frozen_half_pass_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

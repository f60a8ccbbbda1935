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
// Two entry points:
//
// window_agg_launch -- one call of the JAX signature (any kl, sorted or
//   not).  One block per window row w, 16 warps.  The warps split the
//   batch's index range into 16 contiguous pieces; a warp reads its
//   piece's kl and mask 32 at a time, finds the rows of w with a ballot
//   and sums them, lane by lane over the columns (lane l owns columns l,
//   l+32, ...; k <= 256), four rows' loads in flight at a time.  A
//   shared-memory sum over the warps, in warp order, ends the block.  So
//   a row's sum is the same from run to run (no atomics), and a hot row
//   that fills a whole batch is spread over 16 warps.
//
// scan_agg_launch -- a whole phase of a sorted-pass layout in one call
//   (the scan of _scan_window_agg in mfrec_tpu/ops/sgd_mf.py, target +=
//   gsum per batch).  It walks K1's segment table: one warp per target
//   row, which adds the row's per-batch segment sums into the row in
//   batch order, target = ((target + s_1) + s_2) + ..., as the scan does.
//   The rows to sum arrive in the table's entry order (the caller gathers
//   them).
//
// Every row is rounded to bf16 (round to nearest even) inside the
// kernel, from f32: a caller never rounds first.
//
// What bounds it on an H100.  Each is a pass over its rows, bound by
// bytes at 3.35 TB/s: for one call of the JAX shape (B=16384 masked-in
// rows, k=66, W=128) g is 4.33 MB, kl and mask 0.13 MB, the window 34 KB
// out: ~4.5 MB, 1.3 us.  For a whole phase of the ML-10M user layout
// (8,346,084 rows, k=64) the rows are 2.14 GB, the table and the target
// rows 0.04 GB: 0.65 ms.  The phase kernel reads each row once, in entry
// order (coalesced 256-byte rows), with 4 loads in flight per warp and
// 69,878 warps, which is enough to keep the memory busy.  The per-call
// kernel reads g once too, but every block scans the whole kl and mask
// (W x B x 8 bytes from L1/L2: 16 MB at the JAX shape); that scan, not
// device memory, is its floor in this first version.  Staging the rows
// with cp.async/TMA, and a run table for the sorted case, are left for
// later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC.  Plain C interface, loaded by ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_KJ = 8;          // column slots per lane: k <= 256
constexpr int NW_CALL = 16;        // warps per block, per-call kernel
constexpr int NW_SCAN = 8;         // warps (rows) per block, phase kernel
constexpr int U = 4;               // rows in flight per warp

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int KJ>
__global__ void __launch_bounds__(NW_CALL * 32)
window_agg_kernel(const float* __restrict__ g, const int* __restrict__ kl,
                  const float* __restrict__ mask, int B, int k,
                  float* __restrict__ gsum, float* __restrict__ cnt) {
  __shared__ float part[NW_CALL][32 * KJ];
  __shared__ int part_cnt[NW_CALL];
  const int w = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // the warp's piece of the index range, in whole ballots
  const int piece = ((B + NW_CALL - 1) / NW_CALL + 31) & ~31;
  const int j0 = warp * piece;
  const int j1 = min(B, j0 + piece);
  float acc[KJ];
#pragma unroll
  for (int jj = 0; jj < KJ; ++jj) acc[jj] = 0.f;
  int n = 0;
  for (int base = j0; base < j1; base += 32) {
    const int j = base + lane;
    const bool hit = j < j1 && kl[j] == w && mask[j] > 0.f;
    unsigned bits = __ballot_sync(0xffffffffu, hit);
    while (bits) {
      int js[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        js[u] = -1;
        if (bits) {
          js[u] = base + __ffs(bits) - 1;
          bits &= bits - 1;
        }
      }
      float v[U][KJ];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const size_t row = static_cast<size_t>(js[u] < 0 ? 0 : js[u]) * k;
#pragma unroll
        for (int jj = 0; jj < KJ; ++jj) {
          const int c = lane + 32 * jj;
          v[u][jj] = (js[u] >= 0 && c < k) ? g[row + c] : 0.f;
        }
      }
      // in index order: the sum does not depend on the schedule
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (js[u] < 0) break;
        ++n;
#pragma unroll
        for (int jj = 0; jj < KJ; ++jj) acc[jj] += bf16_round(v[u][jj]);
      }
    }
  }
#pragma unroll
  for (int jj = 0; jj < KJ; ++jj) part[warp][lane + 32 * jj] = acc[jj];
  if (lane == 0) part_cnt[warp] = n;
  __syncthreads();
  // the warps' sums in warp order: one thread per column
  for (int c = threadIdx.x; c < k; c += blockDim.x) {
    float s = 0.f;
#pragma unroll 4
    for (int q = 0; q < NW_CALL; ++q) s += part[q][c];
    gsum[static_cast<size_t>(w) * k + c] = s;
  }
  if (threadIdx.x == 0) {
    int t = 0;
    for (int q = 0; q < NW_CALL; ++q) t += part_cnt[q];
    cnt[w] = static_cast<float>(t);
  }
}

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

struct CallArgs {                  // window_agg_launch's arguments
  const float* g;
  const int* kl;
  const float* mask;
  int B, k, W;
  float* gsum;
  float* cnt;
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

template <int KJ>
cudaError_t launch(const CallArgs& a, cudaStream_t s) {
  window_agg_kernel<KJ><<<a.W, NW_CALL * 32, 0, s>>>(a.g, a.kl, a.mask, a.B,
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

// gsum [W, k] and cnt [W] of g [B, k] by kl [B] under mask [B]; every
// output row is written.  Returns a cudaError_t (0: launched).  The
// caller checks 0 <= kl < W for the masked-in rows (others never match).
int window_agg_launch(const float* g, const int* kl, const float* mask,
                      int B, int k, int W, float* gsum, float* cnt,
                      void* stream) {
  if (k < 1 || k > 32 * MAX_KJ || B < 0 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(CallArgs{g, kl, mask, B, k, W, gsum, cnt}, stream);
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

const char* window_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

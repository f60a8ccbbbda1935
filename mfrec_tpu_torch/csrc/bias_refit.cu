// B1 on Hopper: the BellKor bias refit over a layout's segment table.
//
// No TPU counterpart: the JAX package computes the fixed biases with numpy
// on the host (mfrec_tpu/models/mf.py, compute_items_bias_bk and
// compute_users_bias_bk), and so does the port on a CPU model
// (mfrec_tpu_torch/models/mf.py).  With the overall mean mu:
//
//     bi[i] = f32( sum_{e in row i} f64( f32(r_e - f32(mu)) ) / (K3 + n_i) )
//     bu[u] = f32( sum_{e in row u} f64( f32(f32(r_e - f32(mu)) - bi[i_e]) )
//                  / (K2 + n_u) )
//
// and 0 for a row with no rating.  That is numpy's own arithmetic: NumPy 2
// keeps v - mu and the residual in f32, np.bincount sums its weights in
// f64, the quotient is f64 and the result is cast to f32.  Only the order
// of the f64 sum differs here.
//
// The input is K1's segment table (ops/half_pass_kernel.py,
// build_segments) of the layout whose rows are the biases' rows: the
// item-axis layout for bi (the item pass), the user-axis layout for bu
// (the user pass, which gathers bi by the table's ent_fix).  Row x of the
// table (blk_row[x]) owns the entries seg_ptr[blk_seg0[x]] ..
// seg_ptr[blk_seg1[x]] - 1, contiguous and in table order, each one
// rating (the table holds only masked-in entries, and a sorted-pass
// layout's masks are 0 or 1), so n is the range's length.
//
// One warp a row: lane l sums entries l, l + 32, l + 64, ... in that order
// in f64 (UU entries' loads in flight), and a fixed xor-butterfly adds the
// lanes.  The longest rows (from the wrapper's BLOCK_ROW entries: the hot
// items) take a whole NW-warp block: thread t sums entries t, t + 32 NW,
// ... the same way, each warp folds its lanes, and thread 0 adds the
// warps' sums in warp order.  No atomics and no order that depends on
// timing, so the same table gives the same bits on every run.  Rows the
// table does not name are left as the caller zeroed them.
//
// What bounds it on an H100: bytes.  The item pass reads ent_r once (4
// bytes an entry), the user pass ent_r and ent_fix (8 bytes) and gathers
// bi, which stays in L2 (71 KB at the Netflix shape); the row list, its
// offsets and the output add 24 bytes a row.  At the Netflix shape
// (100,480,507 ratings, 480,189 users, 17,770 items) that is 1.22 GB,
// 0.36 ms at 3.35 TB/s.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC.  Plain C interface, loaded by ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 16;             // warps per block: rows, or one long row
constexpr int UU = 4;              // entries in flight per thread

struct RefitArgs {                 // bias_refit_launch's arguments
  float* out;                      // [rows], zeroed by the caller
  const float* bi;                 // [rows_fix]: the user pass, else null
  const int* blk_row;
  const int* blk_seg0;
  const int* blk_seg1;
  const int* seg_ptr;
  const int* ent_fix;
  const float* ent_r;
  float mu;                        // f32(mu)
  double K;                        // the shrinkage, K3 or K2
  int n_rows, n_long;
};

// the f64 sum of the residuals of entries e0 + t, e0 + t + T, ... < e1,
// added in that order
template <bool USER>
__device__ __forceinline__ double strided_sum(const RefitArgs& a, int64_t e0,
                                              int64_t e1, int t, int T) {
  double acc = 0.0;
  for (int64_t e = e0 + t; e < e1; e += static_cast<int64_t>(UU) * T) {
    float r[UU], b[UU];
    int f[UU];
#pragma unroll
    for (int u = 0; u < UU; ++u) {
      const int64_t i = e + static_cast<int64_t>(u) * T;
      const bool ok = i < e1;
      r[u] = ok ? a.ent_r[i] : 0.f;
      if constexpr (USER) f[u] = ok ? a.ent_fix[i] : -1;
    }
    if constexpr (USER) {
#pragma unroll
      for (int u = 0; u < UU; ++u) b[u] = f[u] >= 0 ? a.bi[f[u]] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UU; ++u) {
      if (e + static_cast<int64_t>(u) * T >= e1) break;
      float x = __fsub_rn(r[u], a.mu);
      if constexpr (USER) x = __fsub_rn(x, b[u]);
      acc = __dadd_rn(acc, static_cast<double>(x));
    }
  }
  return acc;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void write_bias(const RefitArgs& a, int x, int n,
                                           double dev) {
  const float b = __double2float_rn(
      __ddiv_rn(dev, __dadd_rn(a.K, static_cast<double>(n))));
  a.out[a.blk_row[x]] = isnan(b) ? 0.f : b;     // numpy's nan_to_num
}

template <bool USER>
__global__ void __launch_bounds__(NW * 32) bias_refit_kernel(const RefitArgs a) {
  __shared__ double red[NW];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (static_cast<int>(blockIdx.x) < a.n_long) {     // block-uniform
    const int x = blockIdx.x;
    const int e0 = a.seg_ptr[a.blk_seg0[x]];
    const int e1 = a.seg_ptr[a.blk_seg1[x]];
    const double v =
        warp_sum(strided_sum<USER>(a, e0, e1, threadIdx.x, NW * 32));
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
      double dev = 0.0;
#pragma unroll
      for (int w = 0; w < NW; ++w) dev = __dadd_rn(dev, red[w]);
      write_bias(a, x, e1 - e0, dev);
    }
  } else {
    const int x = a.n_long + (blockIdx.x - a.n_long) * NW + warp;
    if (x >= a.n_rows) return;
    const int e0 = a.seg_ptr[a.blk_seg0[x]];
    const int e1 = a.seg_ptr[a.blk_seg1[x]];
    const double dev = warp_sum(strided_sum<USER>(a, e0, e1, lane, 32));
    if (lane == 0) write_bias(a, x, e1 - e0, dev);
  }
}

}  // namespace

extern "C" {

// The biases of rows x in [0, n_rows) of a segment table into
// out[blk_row[x]]: the item pass with bi null, the user pass (residuals
// less bi[ent_fix]) with it.  Rows [0, n_long) run one block each.
// Returns a cudaError_t (0: launched).
int bias_refit_launch(float* out, const float* bi, const int* blk_row,
                      const int* blk_seg0, const int* blk_seg1,
                      const int* seg_ptr, const int* ent_fix,
                      const float* ent_r, float mu, double K, int n_rows,
                      int n_long, void* stream) {
  if (n_rows < 0 || n_long < 0 || n_long > n_rows ||
      (bi != nullptr && ent_fix == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  const RefitArgs a{out,     bi,    blk_row, blk_seg0, blk_seg1, seg_ptr,
                    ent_fix, ent_r, mu,      K,        n_rows,   n_long};
  const int blocks = n_long + (n_rows - n_long + NW - 1) / NW;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bi != nullptr)
    bias_refit_kernel<true><<<blocks, NW * 32, 0, s>>>(a);
  else
    bias_refit_kernel<false><<<blocks, NW * 32, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* bias_refit_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// K2 on Hopper, M given: warm-started Jacobi-preconditioned CG on R
// batched k x k systems.
//
// Replaces the Pallas TPU kernel mfrec_tpu/ops/pallas_cg.py (_kernel,
// entered through pcg_solve_resident).  Per system r, with M [k, k], b and
// x0 [k], all f32, `steps` iterations of the PCG written out in pcg.cuh,
// whose device code this entry shares with the ALS bucket kernel
// (cg_bucket.cu).  The ALS path runs that kernel; this entry stays as the
// counterpart of pcg_solve_resident on a given M.
//
// Design.  One warp per system, up to 4 in a block.  M is read from
// device memory once, with 16-byte loads where k is a multiple of 4, into
// shared memory at the odd row stride of pcg.cuh, and every mat-vec of
// the `steps + 1` reads it from there.  Where one system's M does not fit
// in a block's shared memory (k above about 240; k = 256 takes 263 KB),
// the mat-vec streams M's rows from device memory (L2).
//
// What bounds it on an H100.  The bytes: M once, b, x0 and x once,
// 4 R (k^2 + 3k) bytes; the operations 2 R k^2 (steps + 1).  At the ALS
// epoch's shape (80,573 systems at k = 64 in 16 buckets, steps 3 to 6)
// that is 1.38 GB against 2.6 to 4.6 GFLOP: bound by bytes, 0.41 ms per
// epoch at 3.35 TB/s.  Each product of a mat-vec costs a shared-memory
// read, so at k = 64 a warp spends about 128 shared reads per mat-vec;
// with 12-13 warps resident per SM the loads of some systems overlap the
// iterations of others.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC.  Plain C interface, loaded by ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pcg.cuh"

namespace {

constexpr int MAX_WPB = 4;         // warps (systems) per block

template <int NR, bool SMEM>
__global__ void __launch_bounds__(32 * MAX_WPB)
pcg_kernel(const float* __restrict__ M, const float* __restrict__ b,
           const float* __restrict__ x0, float* __restrict__ out,
           long long R, int k, int ld, int steps, int vec4) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long sys = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (sys >= R) return;            // no block barrier below: warps only
  const float* Mg = M + sys * k * k;
  float* Ms = smem + (size_t)warp * (k * ld + k);
  float* vs = Ms + k * ld;

  if (SMEM) {                      // M -> shared memory, once
    if (vec4) {
      const int q4 = k >> 2;
      const float4* Mg4 = reinterpret_cast<const float4*>(Mg);
      const int n4 = k * q4;
#pragma unroll 4
      for (int t = lane; t < n4; t += 32) {
        const float4 w = __ldg(Mg4 + t);
        const int i = t / q4;
        float* d = Ms + i * ld + ((t - i * q4) << 2);
        d[0] = w.x;
        d[1] = w.y;
        d[2] = w.z;
        d[3] = w.w;
      }
    } else {
      for (int i = 0; i < k; ++i)
        for (int j = lane; j < k; j += 32)
          Ms[i * ld + j] = __ldg(Mg + (long long)i * k + j);
    }
    __syncwarp();
  }
  k2::pcg_warp<NR, SMEM, true>(Ms, vs, ld, Mg, b + sys * k, x0 + sys * k,
                               out + sys * k, k, steps, lane);
}

template <int NR>
int launch(const float* M, const float* b, const float* x0, float* out,
           long long R, int k, int steps, cudaStream_t st) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  const int ld = k | 1;
  const size_t per = (size_t)(k * ld + k) * sizeof(float);
  const bool smem = per <= (size_t)optin;
  int wpb = MAX_WPB;
  size_t bytes = 0;
  if (smem) {
    const size_t fit = (size_t)optin / per;
    wpb = fit < (size_t)MAX_WPB ? (int)fit : MAX_WPB;
    bytes = per * wpb;
    err = cudaFuncSetAttribute(pcg_kernel<NR, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (R + wpb - 1) / wpb;
  const int vec4 = (k % 4 == 0) && ((uintptr_t)M % 16 == 0);
  if (smem) {
    pcg_kernel<NR, true><<<(unsigned)blocks, 32 * wpb, bytes, st>>>(
        M, b, x0, out, R, k, ld, steps, vec4);
  } else if constexpr (NR == 8) {  // only k > 128 can outgrow a block
    pcg_kernel<NR, false><<<(unsigned)blocks, 32 * wpb, 0, st>>>(
        M, b, x0, out, R, k, ld, steps, vec4);
  } else {
    return (int)cudaErrorInvalidConfiguration;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [R, k] = `steps` warm-started Jacobi-PCG iterations on M [R, k, k],
// b [R, k] from x0 [R, k], all f32 and contiguous.  Returns a cudaError_t
// (0 = launched).  The caller checks shapes: 1 <= k <= 256, steps >= 0,
// 1 <= R < 2^31 * 4.
int pcg_launch(const float* M, const float* b, const float* x0, float* out,
               long long R, int k, int steps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= 32) return launch<1>(M, b, x0, out, R, k, steps, st);
  if (k <= 64) return launch<2>(M, b, x0, out, R, k, steps, st);
  if (k <= 128) return launch<4>(M, b, x0, out, R, k, steps, st);
  return launch<8>(M, b, x0, out, R, k, steps, st);
}

const char* pcg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

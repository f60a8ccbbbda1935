// K2 on Hopper: warm-started Jacobi-preconditioned CG on R batched k x k
// systems.
//
// Replaces the Pallas TPU kernel mfrec_tpu/ops/pallas_cg.py (_kernel,
// entered through pcg_solve_resident), which the ALS CG half-sweeps call
// once per nnz bucket (mfrec_tpu/ops/als.py: _bucket_cg_body).  Per system
// r, with M [k, k], b and x0 [k], all f32:
//
//     D  = max(diag M, 1e-12)                    Jacobi preconditioner
//     r  = b - M x0,  z = r / D,  p = z,  rz = r.z
//     steps times:
//         q     = M p                            (M v)_i = sum_j M[i,j] v_j
//         denom = p.q
//         a     = denom > 1e-20 ? rz / max(denom, 1e-20) : 0
//         x    += a p,  r -= a q,  z = r / D
//         rzn   = r.z
//         beta  = rz > 1e-20 ? rzn / max(rz, 1e-20) : 0
//         p     = z + beta p,  rz = rzn
//     out = x
//
// The mat-vec is row-wise and uses no symmetry: the CG path's bf16 Gram
// assembly (ops/als.py, weights applied to one operand) is not symmetric
// when the confidences vary (alpha > 0).  z = r / D is an IEEE division:
// the build uses no fast-math.
//
// Design.  One warp per system.  M is read from device memory once, into
// shared memory with an odd row stride ld = k | 1 (lane l reading row l
// column j hits bank (l*ld + j) mod 32, all different), and every
// mat-vec of the `steps + 1` reads it from there: lanes own rows
// l, l+32, ... (NR = ceil(k/32) slots of x, r, z, p, D in registers),
// the vector is staged in the warp's k floats of shared memory and read
// as broadcasts, each lane sums its rows' products in column order.  The
// dot products are butterfly shuffle sums, bit-identical in every lane,
// so every lane takes the same step sizes.  A block holds up to 4 warps.
// Where one system's M does not fit in a block's shared memory (k above
// about 240; k = 256 takes 263 KB), the mat-vec streams M's rows from
// device memory (L2) instead: for each row the lanes read its columns
// coalesced and a shuffle sum gives the row's product.
//
// What bounds it on an H100.  The bytes: M once, b, x0 and x once,
// 4 R (k^2 + 3k) bytes; the operations 2 R k^2 (steps + 1).  At the ALS
// epoch's shape (80,573 systems at k = 64 in 16 buckets, steps 3 to 6)
// that is 1.38 GB against 2.6 to 4.6 GFLOP: bound by bytes, 0.41 ms per
// epoch at 3.35 TB/s.  This first kernel loads M with 16-byte loads (k a
// multiple of 4) and then iterates on it from shared memory, where each
// product costs a shared-memory read, so at k = 64 a warp spends about
// 128 shared reads per mat-vec; with 12-13 warps resident per SM the
// loads of some systems overlap the iterations of others.  A pipelined
// load (cp.async or TMA into a ring) and fusing the Gram assembly into
// the kernel are left for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC.  Plain C interface, loaded by ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float EPS = 1e-20f;
constexpr float DIAG_MIN = 1e-12f;
constexpr int MAX_WPB = 4;         // warps (systems) per block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// q = M v from shared memory: lanes on rows, v staged in vs[0:k].
template <int NR>
__device__ __forceinline__ void matvec_smem(const float* Ms, float* vs,
                                            int ld, int k, int lane,
                                            const float (&v)[NR],
                                            float (&q)[NR]) {
#pragma unroll
  for (int s = 0; s < NR; ++s) {
    const int i = lane + 32 * s;
    if (i < k) vs[i] = v[s];
  }
  __syncwarp();
  const float* row[NR];
#pragma unroll
  for (int s = 0; s < NR; ++s) {
    const int i = lane + 32 * s;
    row[s] = Ms + (i < k ? i : k - 1) * ld;      // lanes past k: discarded
    q[s] = 0.f;
  }
#pragma unroll 4
  for (int j = 0; j < k; ++j) {
    const float vj = vs[j];
#pragma unroll
    for (int s = 0; s < NR; ++s) q[s] = fmaf(row[s][j], vj, q[s]);
  }
#pragma unroll
  for (int s = 0; s < NR; ++s)
    if (lane + 32 * s >= k) q[s] = 0.f;
  __syncwarp();                    // vs is rewritten by the next mat-vec
}

// q = M v from device memory: for each row, lanes on columns, then a
// shuffle sum; lane (i mod 32) keeps row i's product in slot i / 32.
template <int NR>
__device__ __forceinline__ void matvec_global(const float* __restrict__ Mg,
                                              int k, int lane,
                                              const float (&v)[NR],
                                              float (&q)[NR]) {
#pragma unroll
  for (int s = 0; s < NR; ++s) q[s] = 0.f;
#pragma unroll
  for (int s2 = 0; s2 < NR; ++s2) {
    for (int l2 = 0; l2 < 32; ++l2) {
      const int i = 32 * s2 + l2;
      if (i >= k) break;                          // uniform in the warp
      const float* row = Mg + (long long)i * k;
      float part = 0.f;
#pragma unroll
      for (int s = 0; s < NR; ++s) {
        const int j = lane + 32 * s;
        if (j < k) part = fmaf(__ldg(row + j), v[s], part);
      }
      part = warp_sum(part);
      if (lane == l2) q[s2] = part;
    }
  }
}

template <int NR>
__device__ __forceinline__ float dot(const float (&a)[NR],
                                     const float (&b)[NR]) {
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < NR; ++t) s = fmaf(a[t], b[t], s);
  return warp_sum(s);
}

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

  const float* bg = b + sys * k;
  const float* xg = x0 + sys * k;
  float x[NR], r[NR], z[NR], p[NR], D[NR], q[NR];
#pragma unroll
  for (int s = 0; s < NR; ++s) {
    const int i = lane + 32 * s;
    const bool ok = i < k;
    x[s] = ok ? __ldg(xg + i) : 0.f;
    r[s] = ok ? __ldg(bg + i) : 0.f;
    const float dii = ok ? (SMEM ? Ms[i * ld + i]
                                 : __ldg(Mg + (long long)i * k + i))
                         : 1.f;
    D[s] = fmaxf(dii, DIAG_MIN);
  }
  if (SMEM)
    matvec_smem<NR>(Ms, vs, ld, k, lane, x, q);
  else
    matvec_global<NR>(Mg, k, lane, x, q);
#pragma unroll
  for (int s = 0; s < NR; ++s) {
    r[s] = r[s] - q[s];
    z[s] = r[s] / D[s];
    p[s] = z[s];
  }
  float rz = dot<NR>(r, z);
  for (int it = 0; it < steps; ++it) {
    if (SMEM)
      matvec_smem<NR>(Ms, vs, ld, k, lane, p, q);
    else
      matvec_global<NR>(Mg, k, lane, p, q);
    const float denom = dot<NR>(p, q);
    const float a = denom > EPS ? rz / fmaxf(denom, EPS) : 0.f;
#pragma unroll
    for (int s = 0; s < NR; ++s) {
      x[s] = x[s] + a * p[s];
      r[s] = r[s] - a * q[s];
      z[s] = r[s] / D[s];
    }
    const float rzn = dot<NR>(r, z);
    const float beta = rz > EPS ? rzn / fmaxf(rz, EPS) : 0.f;
#pragma unroll
    for (int s = 0; s < NR; ++s) p[s] = z[s] + beta * p[s];
    rz = rzn;
  }
  float* og = out + sys * k;
#pragma unroll
  for (int s = 0; s < NR; ++s) {
    const int i = lane + 32 * s;
    if (i < k) og[i] = x[s];
  }
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

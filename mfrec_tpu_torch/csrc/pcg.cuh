// K2's iteration, shared by its two entries: pcg_launch (csrc/pcg.cu, M
// given) and cg_bucket_launch (csrc/cg_bucket.cu, M assembled in the same
// kernel).  One warp solves one system, per system r with M [k, k], b and
// x0 [k], all f32:
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
// (weights on one operand) is not symmetric when the confidences vary
// (alpha > 0).  z = r / D is an IEEE division: the builds use no
// fast-math.
//
// M lies in shared memory with an odd row stride ld = k | 1 (lane l
// reading row l column j hits bank (l*ld + j) mod 32, all different):
// lanes own rows l, l+32, ... (NR = ceil(k/32) slots of x, r, z, p, D in
// registers), the vector is staged in the warp's k floats of shared
// memory and read as broadcasts, each lane sums its rows' products in
// column order.  The dot products are butterfly shuffle sums,
// bit-identical in every lane, so every lane takes the same step sizes.
// Where M does not fit in shared memory (k above about 240), the mat-vec
// streams M's rows from device memory instead: for each row the lanes
// read its columns coalesced and a shuffle sum gives the row's product.
#pragma once

#include <cuda_runtime.h>

namespace k2 {

constexpr float EPS = 1e-20f;
constexpr float DIAG_MIN = 1e-12f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// A load from device memory: through the read-only path where the data
// is constant for the whole kernel (NC), a plain load where this kernel
// wrote it.
template <bool NC>
__device__ __forceinline__ float gload(const float* p) {
  if constexpr (NC) return __ldg(p);
  return *p;
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
template <int NR, bool NC>
__device__ __forceinline__ void matvec_global(const float* Mg, int k,
                                              int lane, const float (&v)[NR],
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
        if (j < k) part = fmaf(gload<NC>(row + j), v[s], part);
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

// One warp: `steps` PCG iterations on one system, from x0, into out.
// SMEM: M in Ms (row stride ld, vs the warp's k floats of staging);
// otherwise M in Mg [k, k] (row stride k), loaded as gload<NC>.  b and x0
// are read with gload<NC> too; b may lie in shared memory when !NC.
template <int NR, bool SMEM, bool NC>
__device__ __forceinline__ void pcg_warp(const float* Ms, float* vs, int ld,
                                         const float* Mg, const float* b,
                                         const float* x0, float* out, int k,
                                         int steps, int lane) {
  float x[NR], r[NR], z[NR], p[NR], D[NR], q[NR];
#pragma unroll
  for (int s = 0; s < NR; ++s) {
    const int i = lane + 32 * s;
    const bool ok = i < k;
    x[s] = ok ? gload<NC>(x0 + i) : 0.f;
    r[s] = ok ? gload<NC>(b + i) : 0.f;
    const float dii = ok ? (SMEM ? Ms[i * ld + i]
                                 : gload<NC>(Mg + (long long)i * k + i))
                         : 1.f;
    D[s] = fmaxf(dii, DIAG_MIN);
  }
  if constexpr (SMEM)
    matvec_smem<NR>(Ms, vs, ld, k, lane, x, q);
  else
    matvec_global<NR, NC>(Mg, k, lane, x, q);
#pragma unroll
  for (int s = 0; s < NR; ++s) {
    r[s] = r[s] - q[s];
    z[s] = r[s] / D[s];
    p[s] = z[s];
  }
  float rz = dot<NR>(r, z);
  for (int it = 0; it < steps; ++it) {
    if constexpr (SMEM)
      matvec_smem<NR>(Ms, vs, ld, k, lane, p, q);
    else
      matvec_global<NR, NC>(Mg, k, lane, p, q);
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
#pragma unroll
  for (int s = 0; s < NR; ++s) {
    const int i = lane + 32 * s;
    if (i < k) out[i] = x[s];
  }
}

}  // namespace k2

// S1 on Hopper: one strictly sequential epoch of single-feature Funk SGD.
//
// Has no Pallas counterpart: it replaces the JAX function
// mfrec_tpu/ops/sgd_mf.py serial_feature_epoch (a lax.fori_loop that XLA
// compiles into one device loop per feature epoch).  For each rating s of
// the stream, in order, with u = uidx[s], i = iidx[s] and f32 arithmetic:
//
//   'none'    base = cache[s] > 0 ? cache[s] : 1
//   'fixed'   base = cache[s] > 0 ? cache[s] : (mu + bi[i]) + bu[u]
//             p = clamp(base + pf[u]*qf[i])
//   'learned' p = clamp(((((mu + bi[i]) + bu[u]) + dot) - P[u,f]*Q[i,f])
//                       + pf[u]*qf[i])
//             with dot = P[u].Q[i] summed over the k columns in order,
//             from the feature's starting P and Q
//   p = clamp(p + trailing);  err = r[s] - p;  sse += err*err
//   'learned': bu[u] += lr_bu*(err - K_bu*bu[u]); bi[i] likewise
//   update_items: qf[i] += lr*(err*pf[u] - K*qf[i])
//   update_users: pf[u] += lr*(err*qf[i] - K*pf[u])    (both pre-update)
//
// and rmse = sqrt(sse / n) into a device scalar.  Every operation is
// __fmul_rn / __fadd_rn / __fsub_rn, in the order above: no FMA
// contraction, so the kernel equals its plain version
// (ops/serial_kernel.py serial_feature_epoch_ref) bit for bit.
//
// Design.  One launch per feature epoch, one block.  Where the columns
// fit (pf, qf and, when learned, bu and bi: (U + I) * 4 bytes each, up to
// SMEM_LIMIT), the block loads them into shared memory and writes them
// back at the end; otherwise lane 0 works on them in device memory.
// Warp 0 walks the stream: its 32 lanes stage a chunk of 32 ratings
// (u, i, r and the base, or in learned mode the dot and P[u,f]*Q[i,f],
// which do not depend on the chain) while lane 0 walks the chunk before
// it, the next chunk's loads issued before the walk.  The bias mode and
// the two fold-in masks are template parameters.
//
// What bounds it on an H100.  Not the bytes: the stream is read once
// (16 bytes a rating), the columns once each way; 100,000 ratings of the
// ML-100K shape move 1.6 MB, 0.5 us at 3.35 TB/s.  The bound is the
// dependency chain: each rating reads pf[u] and qf[i], which the rating
// before may just have written, so the epoch takes at least n dependent
// shared-memory round trips.  serial_funk_chain_probe measures that
// floor: one thread chasing n dependent shared-memory loads.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC.  Plain C interface, loaded by ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int CHUNK = 32;
constexpr int SMEM_LIMIT = 227 * 1024 - 4096;   // dynamic, beside staging

enum Mode { NONE = 0, FIXED = 1, LEARNED = 2 };

struct Scalars {
  float lr, K, mu, lr_bu, lr_bi, K_bu, K_bi, lo, hi, trailing;
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  // jnp.clip / torch.clamp: NaN stays NaN
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

template <int MODE, bool UPD_U, bool UPD_I, bool SMEM>
__global__ void __launch_bounds__(BLOCK)
serial_funk_kernel(float* __restrict__ pf_g, float* __restrict__ qf_g,
                   const float* __restrict__ cache,
                   const int* __restrict__ uidx, const int* __restrict__ iidx,
                   const float* __restrict__ r, float* __restrict__ bu_g,
                   float* __restrict__ bi_g, const float* __restrict__ P,
                   const float* __restrict__ Q, int n, int U, int I, int k,
                   int f, Scalars sc, float* __restrict__ rmse_out) {
  extern __shared__ float cols[];
  __shared__ int su[2][CHUNK], si[2][CHUNK];
  __shared__ float sr[2][CHUNK], sb[2][CHUNK], sq[2][CHUNK];

  float* pf = pf_g;
  float* qf = qf_g;
  float* bu = bu_g;
  float* bi = bi_g;
  if (SMEM) {
    pf = cols;
    qf = cols + U;
    for (int t = threadIdx.x; t < U; t += BLOCK) pf[t] = pf_g[t];
    for (int t = threadIdx.x; t < I; t += BLOCK) qf[t] = qf_g[t];
    if (MODE == LEARNED) {
      bu = qf + I;
      bi = bu + U;
      for (int t = threadIdx.x; t < U; t += BLOCK) bu[t] = bu_g[t];
      for (int t = threadIdx.x; t < I; t += BLOCK) bi[t] = bi_g[t];
    }
    __syncthreads();
  }

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    // the per-lane staging of one rating: base (none/fixed) or dot and
    // P[u,f]*Q[i,f] (learned), none of which depends on the chain
    auto stage = [&](int buf, int u, int i, float rv, float cv) {
      su[buf][lane] = u;
      si[buf][lane] = i;
      sr[buf][lane] = rv;
      if (MODE == LEARNED) {
        const float* Pu = P + (size_t)u * k;
        const float* Qi = Q + (size_t)i * k;
        float d = __fmul_rn(Pu[0], Qi[0]);
        for (int c = 1; c < k; ++c) d = __fadd_rn(d, __fmul_rn(Pu[c], Qi[c]));
        sb[buf][lane] = d;
        sq[buf][lane] = __fmul_rn(Pu[f], Qi[f]);
      } else if (MODE == FIXED) {
        sb[buf][lane] = cv > 0.f
            ? cv : __fadd_rn(__fadd_rn(sc.mu, bi_g[i]), bu_g[u]);
      } else {
        sb[buf][lane] = cv > 0.f ? cv : 1.f;
      }
    };

    float sse = 0.f;
    if (lane < n) stage(0, uidx[lane], iidx[lane], r[lane], cache[lane]);
    __syncwarp();
    for (int c0 = 0, buf = 0; c0 < n; c0 += CHUNK, buf ^= 1) {
      // the next chunk's loads, issued before the walk
      const int nx = c0 + CHUNK + lane;
      const bool has = nx < n;
      const int nu = has ? uidx[nx] : 0;
      const int ni = has ? iidx[nx] : 0;
      const float nr = has ? r[nx] : 0.f;
      const float nc = has ? cache[nx] : 0.f;
      if (lane == 0) {
        const int m = min(CHUNK, n - c0);
        for (int j = 0; j < m; ++j) {
          const int u = su[buf][j];
          const int i = si[buf][j];
          const float cf = pf[u];
          const float mf = qf[i];
          float p;
          if (MODE == LEARNED) {
            float t = __fadd_rn(sc.mu, bi[i]);
            t = __fadd_rn(t, bu[u]);
            t = __fadd_rn(t, sb[buf][j]);
            t = __fsub_rn(t, sq[buf][j]);
            p = clampf(__fadd_rn(t, __fmul_rn(cf, mf)), sc.lo, sc.hi);
          } else {
            p = clampf(__fadd_rn(sb[buf][j], __fmul_rn(cf, mf)), sc.lo,
                       sc.hi);
          }
          p = clampf(__fadd_rn(p, sc.trailing), sc.lo, sc.hi);
          const float err = __fsub_rn(sr[buf][j], p);
          sse = __fadd_rn(sse, __fmul_rn(err, err));
          if (MODE == LEARNED) {
            const float bu_u = bu[u];
            const float bi_i = bi[i];
            bu[u] = __fadd_rn(bu_u, __fmul_rn(sc.lr_bu, __fsub_rn(
                err, __fmul_rn(sc.K_bu, bu_u))));
            bi[i] = __fadd_rn(bi_i, __fmul_rn(sc.lr_bi, __fsub_rn(
                err, __fmul_rn(sc.K_bi, bi_i))));
          }
          if (UPD_I)
            qf[i] = __fadd_rn(mf, __fmul_rn(sc.lr, __fsub_rn(
                __fmul_rn(err, cf), __fmul_rn(sc.K, mf))));
          if (UPD_U)
            pf[u] = __fadd_rn(cf, __fmul_rn(sc.lr, __fsub_rn(
                __fmul_rn(err, mf), __fmul_rn(sc.K, cf))));
        }
      }
      __syncwarp();
      if (has) stage(buf ^ 1, nu, ni, nr, nc);
      __syncwarp();
    }
    if (lane == 0) *rmse_out = __fsqrt_rn(__fdiv_rn(sse, (float)n));
  }

  if (SMEM) {
    __syncthreads();
    for (int t = threadIdx.x; t < U; t += BLOCK) pf_g[t] = pf[t];
    for (int t = threadIdx.x; t < I; t += BLOCK) qf_g[t] = qf[t];
    if (MODE == LEARNED) {
      for (int t = threadIdx.x; t < U; t += BLOCK) bu_g[t] = bu[t];
      for (int t = threadIdx.x; t < I; t += BLOCK) bi_g[t] = bi[t];
    }
  }
}

template <int MODE, bool UPD_U, bool UPD_I, bool SMEM>
int launch_one(float* pf, float* qf, const float* cache, const int* uidx,
               const int* iidx, const float* r, float* bu, float* bi,
               const float* P, const float* Q, int n, int U, int I, int k,
               int f, const Scalars& sc, float* rmse, cudaStream_t st) {
  auto kernel = serial_funk_kernel<MODE, UPD_U, UPD_I, SMEM>;
  size_t shm = 0;
  if (SMEM) {
    shm = (size_t)(U + I) * sizeof(float) * (MODE == LEARNED ? 2 : 1);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<1, BLOCK, shm, st>>>(pf, qf, cache, uidx, iidx, r, bu, bi, P, Q,
                                n, U, I, k, f, sc, rmse);
  return (int)cudaGetLastError();
}

template <int MODE, bool SMEM>
int by_masks(int upd_u, int upd_i, float* pf, float* qf, const float* cache,
             const int* uidx, const int* iidx, const float* r, float* bu,
             float* bi, const float* P, const float* Q, int n, int U, int I,
             int k, int f, const Scalars& sc, float* rmse, cudaStream_t st) {
#define S1_ARGS pf, qf, cache, uidx, iidx, r, bu, bi, P, Q, n, U, I, k, f, \
                sc, rmse, st
  if (upd_u && upd_i) return launch_one<MODE, true, true, SMEM>(S1_ARGS);
  if (upd_u) return launch_one<MODE, true, false, SMEM>(S1_ARGS);
  if (upd_i) return launch_one<MODE, false, true, SMEM>(S1_ARGS);
  return launch_one<MODE, false, false, SMEM>(S1_ARGS);
#undef S1_ARGS
}

template <int MODE>
int by_smem(int smem, int upd_u, int upd_i, float* pf, float* qf,
            const float* cache, const int* uidx, const int* iidx,
            const float* r, float* bu, float* bi, const float* P,
            const float* Q, int n, int U, int I, int k, int f,
            const Scalars& sc, float* rmse, cudaStream_t st) {
  if (smem)
    return by_masks<MODE, true>(upd_u, upd_i, pf, qf, cache, uidx, iidx, r,
                                bu, bi, P, Q, n, U, I, k, f, sc, rmse, st);
  return by_masks<MODE, false>(upd_u, upd_i, pf, qf, cache, uidx, iidx, r,
                               bu, bi, P, Q, n, U, I, k, f, sc, rmse, st);
}

__global__ void chain_probe_kernel(int n, int m, int* out) {
  extern __shared__ int tab[];
  for (int t = threadIdx.x; t < m; t += blockDim.x) tab[t] = (t + 1) % m;
  __syncthreads();
  if (threadIdx.x == 0) {
    int j = 0;
    for (int s = 0; s < n; ++s) j = tab[j];
    out[0] = j;
  }
}

}  // namespace

extern "C" {

// The shared-memory bytes the columns need (0 if they do not fit): the
// caller chooses the path with it.
long long serial_funk_smem_bytes(int U, int I, int learned) {
  const long long b = (long long)(U + I) * 4 * (learned ? 2 : 1);
  return b <= SMEM_LIMIT ? b : 0;
}

// One feature epoch over n >= 1 ratings, in place on pf [U], qf [I] and,
// in learned mode, bu [U], bi [I]; rmse [1] out.  P [U, k] and Q [I, k]
// are read in learned mode only (k >= 1, 0 <= f < k).  mode: 0 none, 1
// fixed, 2 learned.  smem: keep the columns in shared memory (the caller
// checks serial_funk_smem_bytes).  Returns a cudaError_t (0 = launched).
int serial_funk_launch(float* pf, float* qf, const float* cache,
                       const int* uidx, const int* iidx, const float* r,
                       float* bu, float* bi, const float* P, const float* Q,
                       int n, int U, int I, int k, int f, int mode,
                       int upd_u, int upd_i, int smem, float lr, float K,
                       float mu, float lr_bu, float lr_bi, float K_bu,
                       float K_bi, float lo, float hi, float trailing,
                       float* rmse, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scalars sc{lr, K, mu, lr_bu, lr_bi, K_bu, K_bi, lo, hi, trailing};
  if (mode == LEARNED)
    return by_smem<LEARNED>(smem, upd_u, upd_i, pf, qf, cache, uidx, iidx,
                            r, bu, bi, P, Q, n, U, I, k, f, sc, rmse, st);
  if (mode == FIXED)
    return by_smem<FIXED>(smem, upd_u, upd_i, pf, qf, cache, uidx, iidx, r,
                          bu, bi, P, Q, n, U, I, k, f, sc, rmse, st);
  return by_smem<NONE>(smem, upd_u, upd_i, pf, qf, cache, uidx, iidx, r, bu,
                       bi, P, Q, n, U, I, k, f, sc, rmse, st);
}

// The chain floor: one thread follows n dependent shared-memory loads
// through an m-entry table (1 <= m <= 8192); out [1] receives the last
// index, so the chain cannot be optimized away.
int serial_funk_chain_probe(int n, int m, int* out, void* stream) {
  chain_probe_kernel<<<1, 256, (size_t)m * sizeof(int),
                       static_cast<cudaStream_t>(stream)>>>(n, m, out);
  return (int)cudaGetLastError();
}

const char* serial_funk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

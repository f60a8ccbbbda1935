// S2 on Hopper: a call's serial kernel-MF epochs and their convergence
// rule, in one launch.
//
// Has no Pallas counterpart: it replaces the JAX function
// mfrec_tpu/ops/kmf.py kmf_serial_epoch (a lax.fori_loop that XLA
// compiles into one device loop an epoch) and the driver loop around it
// (mfrec_tpu/models/kmf.py:333-355).  For each rating s of the stream, in
// order, with u = uidx[s], i = iidx[s] and f32 arithmetic:
//
//   dot = (P[u].Q[i] + bu[u]) + bi[i]
//   logistic: sig = 1 / (1 + exp(-dot)); pred = lo + sig*rng;
//             dgrad = (sig*(1 - sig))*rng          (rng = hi - lo)
//   linear:   pred = dot; dgrad = 1
//   err = r[s] - pred;  sse += err*err;  grad = err*dgrad
//   cf = P[u]; mf = Q[i]                            (pre-update rows)
//   update_users: bu[u] += lr*(grad - K_bias*bu[u])
//   update_items: bi[i] += lr*(grad - K_bias*bi[i])
//   update_items: Q[i]  += lr*(grad*cf - K_items*mf)
//   update_users: P[u]  += lr*(grad*mf - K_users*cf)
//
// and rmse = sqrt(sse / n).  The dot is each lane's columns (l, l + 32,
// ...) summed in order from +0, then an xor-shuffle tree (offsets 16, 8,
// 4, 2, 1): every lane ends with the same sum.  Every operation is
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn in the order above, with
// no FMA contraction, so the kernel equals its plain version
// (ops/kmf_serial_kernel.py kmf_serial_epoch_ref, tree_dot) bit for bit
// wherever expf equals torch.exp.  Between epochs the launch applies the
// JAX model's ConvergenceDriver rule, in double as Python compares, and
// stops after the first non-finite rmse:
//
//   while ep < min_epochs or rmse <= rmse_last - min_improvement:
//       if ep >= max_epochs: break
//       rmse_last = rmse; rmse = <epoch>; ep += 1
//       if rmse is not finite: break
//
// writing each epoch's rmse and, at the end, the count of epochs.
//
// Design.  One warp walks the stream.  Lane l holds columns l, l + 32, ...
// of the rating's P and Q rows (k <= 256: at most 8 a lane) and both
// biases, in registers.  A row the next rating shares stays there; a row
// it does not share is written back (its bias by lane 0, then a warp
// barrier) and the next rating's row, loaded while the current rating's
// chain ran, takes its place.  Every row in device memory is up to date
// except the two in registers, so that load never reads a stale row.  The
// ids run two ratings ahead.  A fold-in (one user, ~20 items) keeps P[u]
// in registers for the whole launch.
//
// What bounds it on an H100.  Not the bytes: an ML-100K epoch (80,000
// ratings, k = 40) reads about 30 MB, 9 us at 3.35 TB/s.  The chain does:
// a rating waits for the one before it on its user or item, and its chain
// is the lane sums, five shuffles, the link (expf and a division) and the
// updates.  Where consecutive ratings share no row, the next rows' loads
// overlap the current chain.  kmf_serial_chain_probe measures that chain
// alone, outside this kernel: no loads, stores, selects or hand-over.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC.  Plain C interface, loaded by ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LANES = 32;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  float *P, *Q, *bu, *bi;              // [U, k], [I, k], [U], [I]
  const int *uidx, *iidx;              // the stream's rows
  const float* r;                      // its ratings
  int* out;                            // [cap] rmse bits, then the count
  int n, k, upd_u, upd_i;
  float lr, K_u, K_i, K_b, lo, rng;
  int min_ep, max_ep, cap;
  double min_imp;
};

// a value in a register: the chain's scalars, read once from the kernel's
// parameters (inside the chain they would be re-read from the constant
// bank)
__device__ __forceinline__ float reg(float x) {
  float y;
  asm("mov.b32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// p ? a : b as one select, never a branch in the chain
__device__ __forceinline__ float pick(int p, float a, float b) {
  float y;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.s32 q, %3, 0;\n\t"
      "selp.f32 %0, %1, %2, q;\n\t}"
      : "=f"(y) : "f"(a), "f"(b), "r"(p));
  return y;
}

// the JAX driver's rule: does epoch ep + 1 run?
__device__ __forceinline__ bool keep_going(int ep, double rmse,
                                           double rmse_last, const Args& a) {
  return (ep < a.min_ep || rmse <= rmse_last - a.min_imp) && ep < a.max_ep;
}

template <int NC>
__device__ __forceinline__ void load_row(float (&x)[NC], const float* row,
                                         int k, int lane) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = c * LANES + lane;
    x[c] = col < k ? row[col] : 0.f;
  }
}

template <int NC>
__device__ __forceinline__ void store_row(const float (&x)[NC], float* row,
                                          int k, int lane) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = c * LANES + lane;
    if (col < k) row[col] = x[c];
  }
}

// the dot of the lanes' columns: each lane's in order from +0, then the
// xor-shuffle tree; every lane returns the same sum
template <int NC>
__device__ __forceinline__ float tree_dot(const float (&x)[NC],
                                          const float (&y)[NC]) {
  float p = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) p = __fadd_rn(p, __fmul_rn(x[c], y[c]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    p = __fadd_rn(p, __shfl_xor_sync(FULL, p, off));
  return p;
}

template <int NC, bool LOGISTIC>
__global__ void __launch_bounds__(LANES) kmf_serial_kernel(const Args a) {
  const int lane = threadIdx.x;
  const int n = a.n, k = a.k;
  const int uu = a.upd_u, ui = a.upd_i;
  const float lr = reg(a.lr), K_u = reg(a.K_u), K_i = reg(a.K_i),
              K_b = reg(a.K_b), lo = reg(a.lo), rng = reg(a.rng);
  double rm = 2.0, rl = 2.0;          // ConvergenceDriver's start
  int e = 0;
  bool go = a.cap > 0 && keep_going(0, rm, rl, a);
  if (!go) {
    if (lane == 0) a.out[a.cap] = 0;
    return;
  }
  // rating s's rows in registers; the ids of s + 1 and s + 2 ahead
  int u = a.uidx[0], i = a.iidx[0];
  float rv = a.r[0];
  float x[NC], y[NC];
  load_row<NC>(x, a.P + (size_t)u * k, k, lane);
  load_row<NC>(y, a.Q + (size_t)i * k, k, lane);
  float ub = a.bu[u], ib = a.bi[i];
  int s1 = n > 1 ? 1 : 0;
  int s2 = n > 2 ? 2 : 0;
  int u1 = a.uidx[s1], i1 = a.iidx[s1];
  while (go) {
    float sse = 0.f;
    for (int s = 0; s < n; ++s) {
      // ahead of the chain: the ids of s + 2, rating s + 1's value and
      // the rows it does not share with s (all up to date in memory)
      const int u2 = a.uidx[s2], i2 = a.iidx[s2];
      const float rv1 = a.r[s1];
      const bool nu = u1 != u, ni = i1 != i;
      float xn[NC], yn[NC];
      float ubn = 0.f, ibn = 0.f;
      if (nu) {
        load_row<NC>(xn, a.P + (size_t)u1 * k, k, lane);
        ubn = a.bu[u1];
      }
      if (ni) {
        load_row<NC>(yn, a.Q + (size_t)i1 * k, k, lane);
        ibn = a.bi[i1];
      }
      // the chain
      const float dot = __fadd_rn(__fadd_rn(tree_dot<NC>(x, y), ub), ib);
      float err, grad;
      if (LOGISTIC) {
        const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-dot)));
        const float pred = __fadd_rn(lo, __fmul_rn(sig, rng));
        const float dg = __fmul_rn(__fmul_rn(sig, __fsub_rn(1.f, sig)), rng);
        err = __fsub_rn(rv, pred);
        grad = __fmul_rn(err, dg);
      } else {
        err = __fsub_rn(rv, dot);
        grad = err;                      // err * 1
      }
      sse = __fadd_rn(sse, __fmul_rn(err, err));
      // every update computed, the masks as selects
      ub = pick(uu, __fadd_rn(ub, __fmul_rn(lr, __fsub_rn(
                        grad, __fmul_rn(K_b, ub)))), ub);
      ib = pick(ui, __fadd_rn(ib, __fmul_rn(lr, __fsub_rn(
                        grad, __fmul_rn(K_b, ib)))), ib);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float cf = x[c], mf = y[c];
        y[c] = pick(ui, __fadd_rn(mf, __fmul_rn(lr, __fsub_rn(
                            __fmul_rn(grad, cf), __fmul_rn(K_i, mf)))), mf);
        x[c] = pick(uu, __fadd_rn(cf, __fmul_rn(lr, __fsub_rn(
                            __fmul_rn(grad, mf), __fmul_rn(K_u, cf)))), cf);
      }
      // hand over to rating s + 1: a row it does not share goes back
      bool stored = false;
      if (nu) {
        if (uu) {
          store_row<NC>(x, a.P + (size_t)u * k, k, lane);
          if (lane == 0) a.bu[u] = ub;
          stored = true;
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) x[c] = xn[c];
        ub = ubn;
      }
      if (ni) {
        if (ui) {
          store_row<NC>(y, a.Q + (size_t)i * k, k, lane);
          if (lane == 0) a.bi[i] = ib;
          stored = true;
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) y[c] = yn[c];
        ib = ibn;
      }
      if (stored) __syncwarp();          // the biases, for every lane's loads
      u = u1;
      i = i1;
      rv = rv1;
      u1 = u2;
      i1 = i2;
      s1 = s1 + 1 == n ? 0 : s1 + 1;
      s2 = s2 + 1 == n ? 0 : s2 + 1;
    }
    const float rmse = __fsqrt_rn(__fdiv_rn(sse, (float)n));
    if (lane == 0) a.out[e] = __float_as_int(rmse);
    rl = rm;
    rm = (double)rmse;
    ++e;
    go = e < a.cap && isfinite(rmse) && keep_going(e, rm, rl, a);
  }
  // the rows still in registers (rating 0's, clean, or the last one's)
  if (uu) {
    store_row<NC>(x, a.P + (size_t)u * k, k, lane);
    if (lane == 0) a.bu[u] = ub;
  }
  if (ui) {
    store_row<NC>(y, a.Q + (size_t)i * k, k, lane);
    if (lane == 0) a.bi[i] = ib;
  }
  if (lane == 0) a.out[a.cap] = e;
}

// one rating's chain alone, as one warp holding the rows needs it: the
// dot (each lane's products in order, the five shuffles), the link (expf,
// the correctly rounded reciprocal), the error and sse, the bias and row
// updates.  Every rating is on one (u, i), so each waits for the one
// before; nothing is loaded, stored or selected inside the loop.  out[0]
// holds 0 on entry (the start values cannot be folded into constants);
// out[1] receives a sum of the result, so the chain is not optimized away.
template <int NC, bool LOGISTIC>
__global__ void __launch_bounds__(LANES) chain_probe_kernel(int n,
                                                            float* out) {
  const int lane = threadIdx.x;
  const float z = out[0];
  const float lr = __fadd_rn(0.001f, z), K_u = __fadd_rn(0.1f, z),
              K_i = __fadd_rn(0.1f, z), K_b = __fadd_rn(0.007f, z),
              lo = __fadd_rn(1.f, z), rng = __fadd_rn(4.f, z);
  float x[NC], y[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    x[c] = __fadd_rn(0.1f, z);
    y[c] = __fadd_rn(0.1f, z);
  }
  float ub = z, ib = z, sse = z;
  for (int s = 0; s < n; ++s) {
    const float rv = (float)(1 + (s & 3));
    const float dot = __fadd_rn(__fadd_rn(tree_dot<NC>(x, y), ub), ib);
    float err, grad;
    if (LOGISTIC) {
      const float sig = __frcp_rn(__fadd_rn(1.f, expf(-dot)));
      const float pred = __fadd_rn(lo, __fmul_rn(sig, rng));
      const float dg = __fmul_rn(__fmul_rn(sig, __fsub_rn(1.f, sig)), rng);
      err = __fsub_rn(rv, pred);
      grad = __fmul_rn(err, dg);
    } else {
      err = __fsub_rn(rv, dot);
      grad = err;
    }
    sse = __fadd_rn(sse, __fmul_rn(err, err));
    ub = __fadd_rn(ub, __fmul_rn(lr, __fsub_rn(grad, __fmul_rn(K_b, ub))));
    ib = __fadd_rn(ib, __fmul_rn(lr, __fsub_rn(grad, __fmul_rn(K_b, ib))));
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float cf = x[c], mf = y[c];
      y[c] = __fadd_rn(mf, __fmul_rn(lr, __fsub_rn(__fmul_rn(grad, cf),
                                                   __fmul_rn(K_i, mf))));
      x[c] = __fadd_rn(cf, __fmul_rn(lr, __fsub_rn(__fmul_rn(grad, mf),
                                                   __fmul_rn(K_u, cf))));
    }
  }
  float t = __fadd_rn(__fadd_rn(sse, ub), ib);
#pragma unroll
  for (int c = 0; c < NC; ++c) t = __fadd_rn(t, __fadd_rn(x[c], y[c]));
  if (lane == 0) out[1] = t;
}

template <int NC>
int probe_nc(int n, int logistic, float* out, cudaStream_t st) {
  if (logistic)
    chain_probe_kernel<NC, true><<<1, LANES, 0, st>>>(n, out);
  else
    chain_probe_kernel<NC, false><<<1, LANES, 0, st>>>(n, out);
  return (int)cudaGetLastError();
}

template <int NC>
int launch_nc(int logistic, const Args& a, cudaStream_t st) {
  if (logistic)
    kmf_serial_kernel<NC, true><<<1, LANES, 0, st>>>(a);
  else
    kmf_serial_kernel<NC, false><<<1, LANES, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// A call's epochs over the n >= 1 ratings (uidx, iidx, r), until the rule
// stops, an epoch's rmse is not finite or cap epochs ran, in place on P
// [U, k] and Q [I, k] (row-major, 1 <= k <= 256) and bu [U], bi [I].  The
// ids must lie in range.  The rule starts at epoch 0 with rmse and
// rmse_last 2.0, as ConvergenceDriver does.  out [cap + 1]: each epoch's
// rmse (f32 bits), then the count of epochs.  logistic: 1 the
// logistic link, 0 the linear one.  Returns a cudaError_t (0 = launched).
int kmf_serial_converge(float* P, float* Q, float* bu, float* bi,
                        const int* uidx, const int* iidx, const float* r,
                        int n, int k, int logistic, int upd_u, int upd_i,
                        float lr, float K_u, float K_i, float K_b, float lo,
                        float rng, int min_ep, int max_ep, double min_imp,
                        int cap, int* out, void* stream) {
  if (n < 1 || k < 1 || k > 256 || cap < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a;
  a.P = P; a.Q = Q; a.bu = bu; a.bi = bi;
  a.uidx = uidx; a.iidx = iidx; a.r = r; a.out = out;
  a.n = n; a.k = k; a.upd_u = upd_u; a.upd_i = upd_i;
  a.lr = lr; a.K_u = K_u; a.K_i = K_i; a.K_b = K_b; a.lo = lo; a.rng = rng;
  a.min_ep = min_ep; a.max_ep = max_ep; a.cap = cap; a.min_imp = min_imp;
  const int nc = (k + LANES - 1) / LANES;
  if (nc <= 1) return launch_nc<1>(logistic, a, st);
  if (nc <= 2) return launch_nc<2>(logistic, a, st);
  if (nc <= 4) return launch_nc<4>(logistic, a, st);
  return launch_nc<8>(logistic, a, st);
}

// One rating's dependent chain at width k (1 <= k <= 256), n ratings in
// one warp (out [2]: out[0] must hold 0 on entry; out[1] receives a sum).
int kmf_serial_chain_probe(int n, int k, int logistic, float* out,
                           void* stream) {
  if (n < 1 || k < 1 || k > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = (k + LANES - 1) / LANES;
  if (nc <= 1) return probe_nc<1>(n, logistic, out, st);
  if (nc <= 2) return probe_nc<2>(n, logistic, out, st);
  if (nc <= 4) return probe_nc<4>(n, logistic, out, st);
  return probe_nc<8>(n, logistic, out, st);
}

const char* kmf_serial_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// S1 on Hopper: a feature's serial Funk epochs and its convergence rule,
// in one launch.
//
// Has no Pallas counterpart: it replaces the JAX function
// mfrec_tpu/ops/sgd_mf.py serial_feature_epoch (a lax.fori_loop that XLA
// compiles into one device loop per feature epoch) and the per-feature
// loop around it (mfrec_tpu/models/gd.py:910-927).  For each rating s of
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
// and rmse = sqrt(sse / n).  Every operation is __fmul_rn / __fadd_rn /
// __fsub_rn in the order above: no FMA contraction, so the kernel equals
// its plain version (ops/serial_kernel.py serial_feature_epoch_ref) bit
// for bit.  Between epochs the launch applies the rule of the JAX model,
// in double as Python compares:
//
//   while ep < min_epochs or rmse <= rmse_last - min_improvement:
//       if ep >= max_epochs: break
//       rmse_last = rmse; rmse = <epoch>; ep += 1
//
// writing each epoch's rmse and, at the end, the count of epochs.
//
// Design.  One block.  Its threads first compute what does not depend on
// the chain, once a launch: the cached base of every rating or, learned,
// its dot and P[u,f]*Q[i,f] (P and Q do not change within a feature), and
// load the stream's distinct rows (pf, qf and, learned, bu, bi) into a
// compact table in shared memory where it fits (the wrapper decides,
// serial_kernel.TABLE_LIMIT; else warp 0 works on the columns in device
// memory).  Warp 0 then walks the stream in chunks of 32 ratings, lane j
// on rating 32c + j, the chunks' records arriving by cp.async three
// chunks ahead.  A host-built schedule (ops/serial_kernel.py
// build_schedule, a word a rating) gives each rating its round inside the
// chunk (one more than the latest earlier rating of the chunk it depends
// on: a round's ratings share no row) and, for each of its two rows,
// where its current value is:
//   - an earlier lane of this chunk wrote it: that lane's register,
//     by a shuffle in the rating's round;
//   - a lane of the chunk before wrote it last: that lane's register, by
//     a shuffle at the chunk's start (across epochs too: the stream is
//     treated as cyclic, and at launch start the registers hold the last
//     chunk's rows);
//   - otherwise the table, loaded one chunk ahead.
// A rating that writes a row last in its chunk stores it.  So a row
// passes from rating to rating in registers and never waits for a store
// and a reload.  The chain's scalars sit in registers, the clamp is
// max.NaN / min.NaN and the fold-in masks are selects: no branch and no
// constant-bank load in the chain.  Warp 1 sums sse in stream order (each
// chunk's 32 err*err, lane 0's first; named barriers hand the chunks
// over) and applies the rule at each epoch's end, so warp 0 never waits
// on those 32 dependent adds.  A fold-in (one user, ~20 items) is one
// chunk: its pf[u] moves from lane to lane by shuffles and the table is
// touched only at the launch's ends.
//
// What bounds it on an H100.  Not the bytes: 100,000 ratings of the
// ML-100K shape move 1.6 MB an epoch, 0.5 us at 3.35 TB/s.  The rounds
// do: a chunk takes as many dependent rating chains (~12 f32 operations
// each, plus a shuffle) as its longest chain of ratings sharing rows,
// and a fixed cost for its loads, shuffles and hand-over.
// serial_funk_chain_probe measures one rating's chain alone.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC.  Plain C interface, loaded by ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 512;
constexpr int CHUNK = 32;
constexpr int STAGES = 4;
constexpr unsigned FULL = 0xffffffffu;

enum Mode { NONE = 0, FIXED = 1, LEARNED = 2 };
enum Src { SRC_TABLE = 0, SRC_PREV = 1, SRC_IN = 2 };

// the schedule word of a rating (ops/serial_kernel.py build_schedule)
__device__ __forceinline__ int w_round(int w) { return w & 31; }
__device__ __forceinline__ int w_usrc(int w) { return (w >> 5) & 3; }
__device__ __forceinline__ int w_ulane(int w) { return (w >> 7) & 31; }
__device__ __forceinline__ int w_isrc(int w) { return (w >> 12) & 3; }
__device__ __forceinline__ int w_ilane(int w) { return (w >> 14) & 31; }
__device__ __forceinline__ bool w_ulast(int w) { return (w >> 19) & 1; }
__device__ __forceinline__ bool w_ilast(int w) { return (w >> 20) & 1; }

struct Args {
  float *pf, *qf, *bu, *bi;            // columns and biases, device memory
  float* cache;
  const float *r, *P, *Q;
  const int *uidx, *iidx;              // the stream's global ids
  const int *lu, *li, *sched;          // the plan: row ids, schedule words
  const int *ucols, *icols;            // the table's global rows
  float* aux;                          // [n] base or dot, [n] P[u,f]*Q[i,f]
  int* out;                            // [cap] rmse bits, then the count
  int n, nu, ni, k, f, upd_u, upd_i;
  int su, si;                          // the columns' strides (elements)
  int cache_out;                       // freeze the feature into cache
  float lr, K, mu, lr_bu, lr_bi, K_bu, K_bi, lo, hi, trailing;
  int ep0, min_ep, max_ep, cap;
  double rmse0, rmse_last0, min_imp;
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  // jnp.clip / torch.clamp, NaN stays NaN: max.NaN and min.NaN keep it
  float y;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(y) : "f"(x), "f"(lo));
  asm("min.NaN.f32 %0, %0, %1;" : "+f"(y) : "f"(hi));
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

// a value in a register: the chain's scalars, read once from the kernel's
// parameters (inside the chain they would be re-read from the constant
// bank)
__device__ __forceinline__ float reg(float x) {
  float y;
  asm("mov.b32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct Sc {
  float lr, K, mu, lr_bu, lr_bi, K_bu, K_bi, lo, hi, tr;
  int uu, ui;
};

__device__ __forceinline__ Sc scalars(const Args& a) {
  return Sc{reg(a.lr), reg(a.K), reg(a.mu), reg(a.lr_bu), reg(a.lr_bi),
            reg(a.K_bu), reg(a.K_bi), reg(a.lo), reg(a.hi), reg(a.trailing),
            a.upd_u, a.upd_i};
}

// named barriers between warp 0 (the walk) and warp 1 (sse and the rule);
// barrier 0 is __syncthreads
constexpr int BAR_FULL = 1;          // + slot: a chunk's err*err written
constexpr int BAR_EMPTY = 3;         // + slot: read
constexpr int BAR_DECIDED = 5;       // the epoch's rule applied

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 64;" ::"r"(id) : "memory");
}

// the JAX model's per-feature rule: does epoch ep + 1 run?
__device__ __forceinline__ bool keep_going(int ep, double rmse,
                                           double rmse_last, const Args& a) {
  return (ep < a.min_ep || rmse <= rmse_last - a.min_imp) && ep < a.max_ep;
}

struct Rec {                 // one lane's rating of a chunk
  int u, i, w;
  float r, a0, a1;
};

struct Rows {                // its rows: pf[u], qf[i], bu[u], bi[i]
  float cf, mf, ub, ib;
};

// the stream's records reach warp 0 through a ring of STAGES chunks in
// shared memory, by cp.async three chunks ahead: no register waits on a
// load from device memory
struct Ring {
  int id[STAGES][3][CHUNK];       // table rows u, i; the schedule word
  float fl[STAGES][3][CHUNK];     // r; the base or dot; P[u,f]*Q[i,f]
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// chunk c's records into ring slot t (one group a call, even empty)
template <int MODE>
__device__ __forceinline__ void fetch(const Args& a, Ring& ring, int c,
                                      int t, int lane) {
  const int s = c * CHUNK + lane;
  if (s < a.n) {
    cp_async4(&ring.id[t][0][lane], a.lu + s);
    cp_async4(&ring.id[t][1][lane], a.li + s);
    cp_async4(&ring.id[t][2][lane], a.sched + s);
    cp_async4(&ring.fl[t][0][lane], a.r + s);
    cp_async4(&ring.fl[t][1][lane], a.aux + s);
    if (MODE == LEARNED) cp_async4(&ring.fl[t][2][lane], a.aux + a.n + s);
  }
  cp_commit();
}

// a lane's record of chunk c from ring slot t; past the stream's end a
// rating on row 0 that nothing reads
template <int MODE>
__device__ __forceinline__ Rec read(const Ring& ring, int n, int c, int t,
                                    int lane) {
  Rec d;
  const bool ok = c * CHUNK + lane < n;
  d.u = ok ? ring.id[t][0][lane] : 0;
  d.i = ok ? ring.id[t][1][lane] : 0;
  d.w = ok ? ring.id[t][2][lane] : 0;
  d.r = ring.fl[t][0][lane];
  d.a0 = ring.fl[t][1][lane];
  d.a1 = MODE == LEARNED ? ring.fl[t][2][lane] : 0.f;
  return d;
}

// the columns: the table (stride 1), or device memory at stride su, si
template <int MODE>
__device__ __forceinline__ Rows load_rows(const float* pf, const float* qf,
                                          const float* bu, const float* bi,
                                          int su, int si, const Rec& d) {
  Rows x;
  x.cf = pf[(size_t)d.u * su];
  x.mf = qf[(size_t)d.i * si];
  x.ub = MODE == LEARNED ? bu[d.u] : 0.f;
  x.ib = MODE == LEARNED ? bi[d.i] : 0.f;
  return x;
}

// the rows other lanes hold: src SRC_PREV at a chunk's start, SRC_IN in
// a round; every lane takes part in the shuffles
template <int MODE>
__device__ __forceinline__ void take(Rows& x, const Rows& held, int w,
                                     int src, bool mine) {
  const float cf = __shfl_sync(FULL, held.cf, w_ulane(w));
  const float mf = __shfl_sync(FULL, held.mf, w_ilane(w));
  float ub = 0.f, ib = 0.f;
  if (MODE == LEARNED) {
    ub = __shfl_sync(FULL, held.ub, w_ulane(w));
    ib = __shfl_sync(FULL, held.ib, w_ilane(w));
  }
  if (mine && w_usrc(w) == src) {
    x.cf = cf;
    x.ub = ub;
  }
  if (mine && w_isrc(w) == src) {
    x.mf = mf;
    x.ib = ib;
  }
}

// one rating: the chain, in the reference's order; the new rows into nw
template <int MODE>
__device__ __forceinline__ float step(const Sc& k, const Rec& d,
                                      const Rows& x, Rows& nw) {
  float p;
  if (MODE == LEARNED) {
    float t = __fadd_rn(k.mu, x.ib);
    t = __fadd_rn(t, x.ub);
    t = __fadd_rn(t, d.a0);
    t = __fsub_rn(t, d.a1);
    p = clampf(__fadd_rn(t, __fmul_rn(x.cf, x.mf)), k.lo, k.hi);
  } else {
    p = clampf(__fadd_rn(d.a0, __fmul_rn(x.cf, x.mf)), k.lo, k.hi);
  }
  p = clampf(__fadd_rn(p, k.tr), k.lo, k.hi);
  const float err = __fsub_rn(d.r, p);
  if (MODE == LEARNED) {
    nw.ub = __fadd_rn(x.ub, __fmul_rn(k.lr_bu, __fsub_rn(
        err, __fmul_rn(k.K_bu, x.ub))));
    nw.ib = __fadd_rn(x.ib, __fmul_rn(k.lr_bi, __fsub_rn(
        err, __fmul_rn(k.K_bi, x.ib))));
  }
  const float mf = __fadd_rn(x.mf, __fmul_rn(k.lr, __fsub_rn(
      __fmul_rn(err, x.cf), __fmul_rn(k.K, x.mf))));
  const float cf = __fadd_rn(x.cf, __fmul_rn(k.lr, __fsub_rn(
      __fmul_rn(err, x.mf), __fmul_rn(k.K, x.cf))));
  nw.mf = pick(k.ui, mf, x.mf);
  nw.cf = pick(k.uu, cf, x.cf);
  return __fmul_rn(err, err);
}

struct Sums {                        // warp 0 -> warp 1
  float e2[2][CHUNK];                // two chunks' err*err in flight
  int go;                            // the rule's answer
  int done;                          // the rule stopped the feature
};

// warp 0: the epochs, chunk by chunk; each chunk's err*err to warp 1
template <int MODE, bool TABLE>
__device__ void walk(const Args& a, Ring& ring, Sums& sums, float* pf,
                     float* qf, float* bu, float* bi) {
  const int lane = threadIdx.x;
  const int n = a.n;
  const int nch = (n + CHUNK - 1) / CHUNK;
  const int su = TABLE ? 1 : a.su, si = TABLE ? 1 : a.si;
  const Sc k = scalars(a);
  fetch<MODE>(a, ring, nch - 1, 0, lane);
  cp_wait<0>();
  // what the chunk before chunk 0 left in the registers: at launch start
  // the last chunk's rows as the table holds them
  Rows nw = load_rows<MODE>(pf, qf, bu, bi, su, si,
                            read<MODE>(ring, n, nch - 1, 0, lane));
  for (int t = 0; t < 3; ++t) fetch<MODE>(a, ring, t % nch, t, lane);
  cp_wait<2>();
  Rec d0 = read<MODE>(ring, n, 0, 0, lane);
  Rows m0 = load_rows<MODE>(pf, qf, bu, bi, su, si, d0);
  int c1 = 1 % nch, c3 = 3 % nch;      // (c + 1) % nch, (c + 3) % nch
  unsigned g = 0;                      // chunks walked in this launch
  bool go = a.cap > 0 && keep_going(a.ep0, a.rmse0, a.rmse_last0, a);
  while (go) {
    for (int c = 0; c < nch; ++c, ++g) {
      fetch<MODE>(a, ring, c3, (g + 3) % STAGES, lane);
      cp_wait<2>();
      const Rec d1 = read<MODE>(ring, n, c1, (g + 1) % STAGES, lane);
      const bool ok = c * CHUNK + lane < n;
      const int w = d0.w;
      Rows x = m0;
      take<MODE>(x, nw, w, SRC_PREV, ok);
      const int lvl = ok ? w_round(w) : 0;
      const int rounds = (int)__reduce_max_sync(FULL, (unsigned)lvl) + 1;
      float e2 = 0.f;
      for (int rr = 0; rr < rounds; ++rr) {
        const bool act = ok && lvl == rr;
        if (rr > 0) take<MODE>(x, nw, w, SRC_IN, act);
        // every lane runs the chain; the round's lanes keep it
        Rows y = nw;
        const float ey = step<MODE>(k, d0, x, y);
        if (act) {
          nw = y;
          e2 = ey;
        }
      }
      // the next chunk's rows: every row it reads from the table was
      // last written two chunks back or earlier, and stored
      const Rows m1 = load_rows<MODE>(pf, qf, bu, bi, su, si, d1);
      if (ok && w_ulast(w)) {
        if (a.upd_u) pf[(size_t)d0.u * su] = nw.cf;
        if (MODE == LEARNED) bu[d0.u] = nw.ub;
      }
      if (ok && w_ilast(w)) {
        if (a.upd_i) qf[(size_t)d0.i * si] = nw.mf;
        if (MODE == LEARNED) bi[d0.i] = nw.ib;
      }
      const int slot = g & 1;
      if (g >= 2) bar_sync(BAR_EMPTY + slot);
      sums.e2[slot][lane] = e2;        // 0 past the stream's end
      bar_arrive(BAR_FULL + slot);
      if (!TABLE) __threadfence_block();
      __syncwarp();
      d0 = d1;
      m0 = m1;
      c1 = c1 + 1 == nch ? 0 : c1 + 1;
      c3 = c3 + 1 == nch ? 0 : c3 + 1;
    }
    bar_sync(BAR_DECIDED);
    go = sums.go;
  }
  // warp 1's last two arrivals at the slots' empty barriers
  for (unsigned h = g < 2 ? 2 : g; h < g + 2; ++h) bar_sync(BAR_EMPTY + (h & 1));
  cp_wait<0>();
}

// warp 1: sse in stream order, lane 0's term first, then the rule
template <int MODE>
__device__ void summer(const Args& a, Sums& sums) {
  const int lane = threadIdx.x & 31;
  const int n = a.n;
  const int nch = (n + CHUNK - 1) / CHUNK;
  double rm = a.rmse0, rl = a.rmse_last0;
  bool go = a.cap > 0 && keep_going(a.ep0, rm, rl, a);
  int e = 0;
  unsigned g = 0;
  while (go) {
    float sse = 0.f;
    for (int c = 0; c < nch; ++c, ++g) {
      const int slot = g & 1;
      bar_sync(BAR_FULL + slot);
      const float v = sums.e2[slot][lane];
      bar_arrive(BAR_EMPTY + slot);
#pragma unroll
      for (int j = 0; j < CHUNK; ++j)
        sse = __fadd_rn(sse, __shfl_sync(FULL, v, j));
    }
    const float rmse = __fsqrt_rn(__fdiv_rn(sse, (float)n));
    if (lane == 0) a.out[e] = __float_as_int(rmse);
    rl = rm;
    rm = (double)rmse;
    ++e;
    go = e < a.cap && keep_going(a.ep0 + e, rm, rl, a);
    if (lane == 0) sums.go = go;
    bar_arrive(BAR_DECIDED);
  }
  if (lane == 0) {
    a.out[a.cap] = e;
    sums.done = !keep_going(a.ep0 + e, rm, rl, a);
  }
}

template <int MODE, bool TABLE>
__global__ void __launch_bounds__(BLOCK)
serial_funk_kernel(const Args a) {
  extern __shared__ float tab[];
  __shared__ Ring ring;
  __shared__ Sums sums;
  float* pf = a.pf;
  float* qf = a.qf;
  float* bu = a.bu;
  float* bi = a.bi;
  if (TABLE) {
    pf = tab;
    qf = tab + a.nu;
    bu = qf + a.ni;
    bi = bu + a.nu;
    for (int t = threadIdx.x; t < a.nu; t += BLOCK) {
      pf[t] = a.pf[(size_t)a.ucols[t] * a.su];
      if (MODE == LEARNED) bu[t] = a.bu[a.ucols[t]];
    }
    for (int t = threadIdx.x; t < a.ni; t += BLOCK) {
      qf[t] = a.qf[(size_t)a.icols[t] * a.si];
      if (MODE == LEARNED) bi[t] = a.bi[a.icols[t]];
    }
  }
  // what does not depend on the chain, once a launch
  for (int s = threadIdx.x; s < a.n; s += BLOCK) {
    const int u = a.uidx[s];
    const int i = a.iidx[s];
    if (MODE == LEARNED) {
      const float* Pu = a.P + (size_t)u * a.k;
      const float* Qi = a.Q + (size_t)i * a.k;
      float d = __fmul_rn(Pu[0], Qi[0]);
      for (int c = 1; c < a.k; ++c) d = __fadd_rn(d, __fmul_rn(Pu[c], Qi[c]));
      a.aux[s] = d;
      a.aux[a.n + s] = __fmul_rn(Pu[a.f], Qi[a.f]);
    } else {
      const float cv = a.cache[s];
      a.aux[s] = cv > 0.f ? cv
          : MODE == FIXED ? __fadd_rn(__fadd_rn(a.mu, a.bi[i]), a.bu[u])
                          : 1.f;
    }
  }
  __syncthreads();
  if (threadIdx.x < 32)
    walk<MODE, TABLE>(a, ring, sums, pf, qf, bu, bi);
  else if (threadIdx.x < 64)
    summer<MODE>(a, sums);
  __syncthreads();
  if (TABLE) {
    for (int t = threadIdx.x; t < a.nu; t += BLOCK) {
      if (a.upd_u) a.pf[(size_t)a.ucols[t] * a.su] = pf[t];
      if (MODE == LEARNED) a.bu[a.ucols[t]] = bu[t];
    }
    for (int t = threadIdx.x; t < a.ni; t += BLOCK) {
      if (a.upd_i) a.qf[(size_t)a.icols[t] * a.si] = qf[t];
      if (MODE == LEARNED) a.bi[a.icols[t]] = bi[t];
    }
  }
  // the converged feature into the rating cache (ops/sgd_mf.py
  // update_cache): clamp(base + pf[u]*qf[i]), base as the prologue took
  // it; only once the rule stopped the feature
  if (MODE != LEARNED && a.cache_out) {
    __syncthreads();
    if (sums.done) {
      const Sc k = scalars(a);
      for (int s = threadIdx.x; s < a.n; s += BLOCK)
        a.cache[s] = clampf(__fadd_rn(a.aux[s], __fmul_rn(
            a.pf[(size_t)a.uidx[s] * a.su], a.qf[(size_t)a.iidx[s] * a.si])),
            k.lo, k.hi);
    }
  }
}

long long table_bytes(int nu, int ni, int learned) {
  return (long long)(nu + ni) * 4 * (learned ? 2 : 1);
}

template <int MODE, bool TABLE>
int launch_one(const Args& a, cudaStream_t st) {
  auto kernel = serial_funk_kernel<MODE, TABLE>;
  size_t shm = 0;
  if (TABLE) {
    shm = (size_t)table_bytes(a.nu, a.ni, MODE == LEARNED);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<1, BLOCK, shm, st>>>(a);
  return (int)cudaGetLastError();
}

template <int MODE>
int by_table(int table, const Args& a, cudaStream_t st) {
  return table ? launch_one<MODE, true>(a, st)
               : launch_one<MODE, false>(a, st);
}

// one rating's chain alone: one thread, its rows in registers, every
// rating on the same user and item, so each waits for the one before
__global__ void chain_probe_kernel(int n, float* out) {
  if (threadIdx.x != 0) return;
  float cf = 0.1f, mf = 0.1f, sse = 0.f;
  const float base = 3.5f, lr = 0.01f, K = 0.02f, lo = 1.f, hi = 5.f;
  const float tr = out[1];             // 0, from the caller
  for (int s = 0; s < n; ++s) {
    const float rv = (float)(1 + (s & 3));
    float p = clampf(__fadd_rn(base, __fmul_rn(cf, mf)), lo, hi);
    p = clampf(__fadd_rn(p, tr), lo, hi);
    const float err = __fsub_rn(rv, p);
    sse = __fadd_rn(sse, __fmul_rn(err, err));
    const float nm = __fadd_rn(mf, __fmul_rn(lr, __fsub_rn(
        __fmul_rn(err, cf), __fmul_rn(K, mf))));
    cf = __fadd_rn(cf, __fmul_rn(lr, __fsub_rn(__fmul_rn(err, mf),
                                               __fmul_rn(K, cf))));
    mf = nm;
  }
  out[0] = cf + mf + sse;
}

}  // namespace

extern "C" {

// Feature f's epochs over the n >= 1 ratings, until the rule stops or
// cap epochs ran, in place on pf [U] and qf [I] (strides su, si: they
// may be columns of P and Q) and, learned, bu [U], bi [I].  cache [n]:
// the ratings' cached predictions; with cache_out (not learned) the
// launch in which the rule stops freezes the feature into it (cap may
// be 0 for that alone).  uidx, iidx: the stream's global ids; lu, li, sched: the plan
// (table rows or, without the table, global ids; the schedule words);
// ucols [nu], icols [ni]: the table's global rows (table = 1).  P [U, k]
// and Q [I, k] are read in learned mode only (0 <= f < k).  aux: scratch
// of n floats (2n learned).  The rule starts at epoch ep0 with rmse0 and
// rmse_last0 (2.0, 2.0 for a feature's first launch).  out [cap + 1]:
// each epoch's rmse (f32 bits), then the count of epochs.  mode: 0 none,
// 1 fixed, 2 learned.  Returns a cudaError_t (0 = launched).
int serial_funk_converge(
    float* pf, float* qf, int su, int si, float* bu, float* bi, float* cache,
    int cache_out,
    const int* uidx, const int* iidx, const float* r, const int* lu,
    const int* li, const int* sched, const int* ucols, const int* icols,
    int nu, int ni, int table, const float* P, const float* Q, int k, int f,
    float* aux, int n, int mode, int upd_u, int upd_i, float lr, float K,
    float mu, float lr_bu, float lr_bi, float K_bu, float K_bi, float lo,
    float hi, float trailing, int ep0, double rmse0, double rmse_last0,
    int min_ep, int max_ep, double min_imp, int cap, int* out,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a;
  a.pf = pf; a.qf = qf; a.su = su; a.si = si; a.bu = bu; a.bi = bi;
  a.cache_out = cache_out;
  a.cache = cache; a.r = r; a.P = P; a.Q = Q;
  a.uidx = uidx; a.iidx = iidx; a.lu = lu; a.li = li; a.sched = sched;
  a.ucols = ucols; a.icols = icols; a.aux = aux; a.out = out;
  a.n = n; a.nu = nu; a.ni = ni; a.k = k; a.f = f;
  a.upd_u = upd_u; a.upd_i = upd_i;
  a.lr = lr; a.K = K; a.mu = mu; a.lr_bu = lr_bu; a.lr_bi = lr_bi;
  a.K_bu = K_bu; a.K_bi = K_bi; a.lo = lo; a.hi = hi; a.trailing = trailing;
  a.ep0 = ep0; a.min_ep = min_ep; a.max_ep = max_ep; a.cap = cap;
  a.rmse0 = rmse0; a.rmse_last0 = rmse_last0; a.min_imp = min_imp;
  if (mode == LEARNED) return by_table<LEARNED>(table, a, st);
  if (mode == FIXED) return by_table<FIXED>(table, a, st);
  return by_table<NONE>(table, a, st);
}

// One rating's dependent chain, n times in one thread (out [2]: out[1]
// must hold 0 on entry; out[0] receives a sum, so the chain cannot be
// optimized away).
int serial_funk_chain_probe(int n, float* out, void* stream) {
  chain_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(n,
                                                                      out);
  return (int)cudaGetLastError();
}

const char* serial_funk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

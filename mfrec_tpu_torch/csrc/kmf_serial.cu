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
// Design.  A rating waits only for the last earlier rating on its user or
// its item, so ratings that share no row may run side by side.  A plan
// built once a call on the host (ops/kmf_serial_kernel.py kmf_plan, over
// S1's schedule, ops/serial_kernel.py build_schedule) cuts the stream
// into chunks of 32 ratings, gives each rating its round in its chunk (0,
// or one more than the latest earlier rating of the chunk on its user or
// item: a round's ratings share no row) and, for each of its two rows,
// where the row's current value is, and deals each chunk's ratings to NW
// compute warps as job lists in round order (a rating goes to the warp of
// a rating whose row it reads, else to the least loaded warp).  One
// block: the compute warps and a summing warp.  A warp runs a job as one
// rating: lane l holds columns l, l + 32, ... of both rows (k <= 256: at
// most 8 a lane), so its arithmetic is the one-warp walk's.  One barrier
// a chunk; inside a chunk the warps run their job lists side by side.
//
// Rows pass in shared memory.  Every rating of a chunk has a slot (its
// user row and bias, its item row and bias) in one of three buffers that
// turn over chunk by chunk.  A job takes each of its rows from:
//   - the registers of its warp's previous job, if that job wrote it;
//   - SRC_IN: the slot of the earlier rating of its chunk that wrote it,
//     after that warp flags the slot with the chunk's generation (another
//     warp), or after the warp's barrier (this warp);
//   - SRC_PREV: the slot of the rating of the chunk before that wrote it
//     last (the stream is cyclic: chunk 0's is the last chunk of the
//     epoch before; at launch start that buffer holds the last chunk's
//     rows as device memory holds them);
//   - SRC_TABLE: its own slot, into which its warp copied the row from
//     device memory by cp.async a chunk ahead (its last writer lies two
//     chunks back or more, and stored it).
// A job writes a row into its own slot only where the next rating on the
// row reads it there; the chunk's last writer of a row stores it to
// device memory (a side the launch does not update is never stored).  A
// job's stores run, predicated, during the next job's chain.  So no
// device-memory read lies in a chain.  The chunks' records (the ids, the
// word, the rating) and job tables come by cp.async three chunks ahead.
// Each job's err*err reaches a slot by its place in the stream; the
// summing warp adds a chunk's slots in stream order, as the plain version
// does, while the compute warps run the next chunk, and applies the rule
// at each epoch's end.  A fold-in of at most 32 ratings is one chunk run
// by one warp: its user row passes in registers, its item rows from epoch
// to epoch in shared memory; device memory is read only at launch start.
//
// What bounds it on an H100.  Not the bytes: an ML-100K epoch (80,000
// ratings, k = 40) reads about 30 MB, 9 us at 3.35 TB/s.  The stream's
// longest dependency chain (992 ratings at ML-100K) times one rating's
// chain (kmf_serial_chain_probe: the dot's products and xor tree, expf,
// the reciprocal, the updates; about 160 ns) is 0.16 ms.  What holds S2
// above that: a warp issues its job's instructions one after another
// (the chain, the row hand-over, the stores), and a chunk waits for its
// busiest warp and its barrier.

// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC.  Plain C interface, loaded by ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LANES = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int CHUNK = 32;              // ratings a chunk (the schedule's)
constexpr int NW = 16;                 // compute warps
constexpr int BLOCK = (NW + 1) * LANES;
constexpr int STAGES = 4;              // the records' ring: chunks g..g+3
constexpr int BUFS = 3;                // slot buffers: chunks g-1, g, g+1
constexpr int WS = (NW + 4) / 4 * 4;   // a chunk's job table: NW + 1 starts

enum Src { SRC_TABLE = 0, SRC_PREV = 1, SRC_IN = 2 };

// the plan's schedule word: ops/serial_kernel.py build_schedule's, its
// round field replaced by the rating's lane in its chunk
__device__ __forceinline__ int w_lane(int w) { return w & 31; }
__device__ __forceinline__ int w_usrc(int w) { return (w >> 5) & 3; }
__device__ __forceinline__ int w_ulane(int w) { return (w >> 7) & 31; }
__device__ __forceinline__ int w_isrc(int w) { return (w >> 12) & 3; }
__device__ __forceinline__ int w_ilane(int w) { return (w >> 14) & 31; }
__device__ __forceinline__ bool w_ulast(int w) { return (w >> 19) & 1; }
__device__ __forceinline__ bool w_ilast(int w) { return (w >> 20) & 1; }
// the side's row is in the registers of the warp's previous job; it is in
// another warp's slot, flagged when written
constexpr int REG_U = 1 << 21, REG_I = 1 << 22;
constexpr int WAIT_U = 1 << 23, WAIT_I = 1 << 24;
// another warp waits on the job's slot: it flags the slot when written
constexpr int NOTIFY = 1 << 25;
// the next job on the side's row reads it from this job's slot
constexpr int STORE_U = 1 << 26, STORE_I = 1 << 27;
// the job reads a slot its own warp wrote in this chunk
constexpr int SYNC = 1 << 28;

struct Args {
  float *P, *Q, *bu, *bi;              // [U, k], [I, k], [U], [I]
  const int4* rec;                     // [nch * 32]: u, i, word, r bits
  const int* wst;                      // [nch, WS]: each warp's first job
  int* out;                            // [cap] rmse bits, then the count
  int n, nch, k, upd_u, upd_i, vec;
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

struct Sc {
  float lr, K_u, K_i, K_b, lo, rng;
  int uu, ui;
};

__device__ __forceinline__ Sc scalars(const Args& a) {
  return Sc{reg(a.lr), reg(a.K_u), reg(a.K_i), reg(a.K_b), reg(a.lo),
            reg(a.rng), a.upd_u, a.upd_i};
}

// the JAX driver's rule: does epoch ep + 1 run?
__device__ __forceinline__ bool keep_going(int ep, double rmse,
                                           double rmse_last, const Args& a) {
  return (ep < a.min_ep || rmse <= rmse_last - a.min_imp) && ep < a.max_ep;
}

// named barriers; 0 is __syncthreads
constexpr int BAR_FULL = 2;            // + slot: a chunk's err*err written
constexpr int BAR_EMPTY = 4;           // + slot: read by the summing warp
constexpr int BAR_DECIDED = 6;         // the epoch's rule applied

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// shared-memory operands are 32-bit shared-window addresses, formed once
// from a base: a generic pointer's conversion would re-read the block's
// cluster rank at every access
__device__ __forceinline__ unsigned smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(unsigned d, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(unsigned d, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Ring {                          // chunks' records, by stage
  int4 rec[STAGES][CHUNK];
  int wst[STAGES][WS];
};

struct Sums {                          // compute warps -> summing warp
  float e2[2][CHUNK];                  // two chunks' err*err, by lane
  int go;                              // the rule's answer
};

// a slot: the user row (NC * 32 columns, then the bias), then the item
// row; 16-byte aligned
template <int NC>
struct Slot {
  static constexpr int SIDE = NC * LANES + 4;
  static constexpr int SIZE = 2 * SIDE;
  static constexpr int BUF = CHUNK * SIZE;
};

__device__ __forceinline__ int chunk_size(int n, int c) {
  const int left = n - c * CHUNK;
  return left < CHUNK ? left : CHUNK;
}

// a row and its bias into a slot side by cp.async (the warp's lanes)
template <int NC>
__device__ __forceinline__ void fetch_row(unsigned dst, const float* row,
                                          const float* bias, int k,
                                          int vec, int lane) {
  if (vec) {
    for (int q = lane; q < (k >> 2); q += LANES)
      cp_async16(dst + 16 * q, row + 4 * q);
  } else {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = c * LANES + lane;
      if (col < k) cp_async4(dst + 4 * col, row + col);
    }
  }
  if (lane == LANES - 1) cp_async4(dst + 4 * NC * LANES, bias);
}

// the same, by plain loads and stores (the launch's start)
template <int NC>
__device__ __forceinline__ void copy_row(float* dst, const float* row,
                                         const float* bias, int k, int lane) {
  for (int col = lane; col < k; col += LANES) dst[col] = row[col];
  if (lane == 0) dst[NC * LANES] = *bias;
}

// the launch's start: the rows of a chunk's ratings (records recs, size
// ratings; all of them, or its table rows) into buffer buf, by plain
// copies, warp w taking ratings w, w + nw, ...
template <int NC>
__device__ __forceinline__ void copy_rows(const Args& a, const int4* recs,
                                          int size, float* buf, int w,
                                          int nw, int lane, bool all) {
  using S = Slot<NC>;
  for (int p = w; p < size; p += nw) {
    const int4 d = recs[p];
    float* slot = buf + w_lane(d.z) * S::SIZE;
    if (all || w_usrc(d.z) == SRC_TABLE)
      copy_row<NC>(slot, a.P + (size_t)d.x * a.k, a.bu + d.x, a.k, lane);
    if (all || w_isrc(d.z) == SRC_TABLE)
      copy_row<NC>(slot + S::SIDE, a.Q + (size_t)d.y * a.k, a.bi + d.y,
                   a.k, lane);
  }
}

// chunk c's records and job table into ring stage t (the compute warps'
// threads, one 16-byte copy each)
__device__ __forceinline__ void fetch_records(const Args& a, Ring& ring,
                                              int c, int t, int tid) {
  if (tid < CHUNK)
    cp_async16(smem(&ring.rec[t][tid]), a.rec + (size_t)c * CHUNK + tid);
  else if (tid < CHUNK + WS / 4)
    cp_async16(smem(&ring.wst[t][4 * (tid - CHUNK)]),
               a.wst + (size_t)c * WS + 4 * (tid - CHUNK));
}

// a warp's jobs in a chunk (ring stage t): lane q holds job q
__device__ __forceinline__ int4 my_jobs(const Ring& ring, int t, int w,
                                        int lane, int& cnt) {
  const int j0 = ring.wst[t][w];
  cnt = ring.wst[t][w + 1] - j0;
  return lane < cnt ? ring.rec[t][j0 + lane] : make_int4(0, 0, 0, 0);
}

__device__ __forceinline__ int4 shfl4(const int4 v, int q) {
  return make_int4(__shfl_sync(FULL, v.x, q), __shfl_sync(FULL, v.y, q),
                   __shfl_sync(FULL, v.z, q), __shfl_sync(FULL, v.w, q));
}

// the table rows of this warp's jobs in a chunk (ring stage t) into
// buffer buf by cp.async: only this warp reads them, after its own wait
template <int NC>
__device__ __forceinline__ void fetch_mine(const Args& a, const Ring& ring,
                                           int t, unsigned buf, int w,
                                           int lane) {
  using S = Slot<NC>;
  int cnt;
  const int4 mine = my_jobs(ring, t, w, lane, cnt);
  unsigned todo = __ballot_sync(
      FULL, lane < cnt && (w_usrc(mine.z) == SRC_TABLE ||
                           w_isrc(mine.z) == SRC_TABLE));
  while (todo) {
    const int q = __ffs(todo) - 1;
    todo &= todo - 1;
    const int4 d = shfl4(mine, q);
    const unsigned slot = buf + 4 * w_lane(d.z) * S::SIZE;
    if (w_usrc(d.z) == SRC_TABLE)
      fetch_row<NC>(slot, a.P + (size_t)d.x * a.k, a.bu + d.x, a.k, a.vec,
                    lane);
    if (w_isrc(d.z) == SRC_TABLE)
      fetch_row<NC>(slot + 4 * S::SIDE, a.Q + (size_t)d.y * a.k, a.bi + d.y,
                    a.k, a.vec, lane);
  }
}

__device__ __forceinline__ unsigned ld_acquire(unsigned p) {
  unsigned v;
  asm volatile("ld.acquire.cta.shared.u32 %0, [%1];"
               : "=r"(v) : "r"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned p, unsigned v) {
  asm volatile("st.release.cta.shared.u32 [%0], %1;"
               :: "r"(p), "r"(v) : "memory");
}

// a store done only where p holds, as one predicated instruction (no
// branch in a job's body)
__device__ __forceinline__ void sts_if(bool p, unsigned addr, float v) {
  asm volatile("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %0, 0;\n\t"
               "@q st.shared.f32 [%1], %2;\n\t}"
               :: "r"((int)p), "r"(addr), "f"(v)
               : "memory");
}

// a side's NC columns of this lane (l, l + 32, ...; the slot's padding
// past k too, which no load reads) where p holds, under one predicate
template <int NC>
__device__ __forceinline__ void sts_side(bool p, unsigned at,
                                         const float (&x)[NC]) {
#pragma unroll
  for (int c = 0; c < NC; c += 2) {
    if (c + 1 < NC) {
      asm volatile("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %0, 0;\n\t"
                   "@q st.shared.f32 [%1], %2;\n\t"
                   "@q st.shared.f32 [%1+128], %3;\n\t}"
                   :: "r"((int)p), "r"(at + 4 * c * LANES),
                   "f"(x[c]), "f"(x[c + 1 < NC ? c + 1 : c])
                   : "memory");
    } else {
      sts_if(p, at + 4 * c * LANES, x[c]);
    }
  }
}

__device__ __forceinline__ void stg_if(bool p, float* addr, float v) {
  asm volatile("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %0, 0;\n\t"
               "@q st.global.f32 [%1], %2;\n\t}"
               :: "r"((int)p), "l"(addr), "f"(v)
               : "memory");
}

// each lane's sum of its columns' products, in order from +0
template <int NC>
__device__ __forceinline__ float lane_sum(const float (&x)[NC],
                                          const float (&y)[NC]) {
  float p = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) p = __fadd_rn(p, __fmul_rn(x[c], y[c]));
  return p;
}

// the dot of the lanes' columns: the lane sums, then the xor-shuffle tree
// (offsets 16, 8, 4, 2, 1); every lane returns the same sum
template <int NC>
__device__ __forceinline__ float tree_dot(const float (&x)[NC],
                                          const float (&y)[NC]) {
  float p = lane_sum<NC>(x, y);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    p = __fadd_rn(p, __shfl_xor_sync(FULL, p, off));
  return p;
}

// a job's side: the previous job's (reg), or loaded from the slot its
// word names (its waits, if any, already done).  The slot's NC * 32
// columns are loaded whole and the columns past k (which a slot's store
// may fill) replaced by 0, as the plain version pads; no load is
// predicated
template <int NC>
__device__ __forceinline__ void take_side(int wd, int reg, int src,
                                          int lane_in, const float* cur,
                                          const float* prv, int side, int k,
                                          int lane, const float (&prev)[NC],
                                          float prevb, float (&x)[NC],
                                          float& b) {
  using S = Slot<NC>;
  const bool r = wd & reg;
  const float* at = (src == SRC_PREV ? prv : cur)
      + (src == SRC_TABLE ? w_lane(wd) : lane_in) * S::SIZE + side * S::SIDE;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float v = c * LANES + lane < k ? at[c * LANES + lane] : 0.f;
    x[c] = r ? prev[c] : v;
  }
  const float v = at[NC * LANES];
  b = r ? prevb : v;
}

// a job's tail: its rows into its own slot where a later job reads them
// there, a row its chunk writes last to device memory; nothing for wd
// 0.  Every store is predicated, none branched
template <int NC>
__device__ __forceinline__ void tail(const Args& a, const Sc& s, int wd,
                                     int u, int i, const float (&x)[NC],
                                     float ub, const float (&y)[NC],
                                     float ib, unsigned cur, int lane) {
  using S = Slot<NC>;
  const int k = a.k;
  const unsigned own = cur + 4 * w_lane(wd) * S::SIZE;
  const bool su = wd & STORE_U, si = wd & STORE_I;
  const bool gu = s.uu && w_ulast(wd), gi = s.ui && w_ilast(wd);
  float* prow = a.P + (size_t)u * k;
  float* qrow = a.Q + (size_t)i * k;
  sts_side<NC>(su, own + 4 * lane, x);
  sts_side<NC>(si, own + 4 * (S::SIDE + lane), y);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = c * LANES + lane;
    const bool in = col < k;
    stg_if(gu && in, prow + col, x[c]);
    stg_if(gi && in, qrow + col, y[c]);
  }
  const bool l0 = lane == 0;
  sts_if(su && l0, own + 4 * NC * LANES, ub);
  sts_if(si && l0, own + 4 * (S::SIDE + NC * LANES), ib);
  stg_if(gu && l0, a.bu + u, ub);
  stg_if(gi && l0, a.bi + i, ib);
}

// the compute warps: the epochs, chunk by chunk; in a chunk each warp
// runs its jobs in order.  A job's row written earlier in the chunk
// comes from the warp's registers (its previous job), from a slot this
// warp wrote, or from another warp's slot once that warp flags it with
// the chunk's generation; every job flags its own slot when written
template <int NC, bool LOGISTIC>
__device__ void walk(const Args& a, Ring& ring, Sums& sums, float* slots,
                     unsigned flag) {
  using S = Slot<NC>;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int nch = a.nch, k = a.k;
  const Sc s = scalars(a);
  const unsigned slots_s = smem(slots);
  int c3 = 3 % nch;                    // (c + 3) % nch
  unsigned g = 0;                      // chunks walked in this launch
  bool go = a.cap > 0 && keep_going(0, 2.0, 2.0, a);
  while (go) {
    for (int c = 0; c < nch; ++c, ++g) {
      const int t = g % STAGES;
      float* cur = slots + (g % BUFS) * S::BUF;
      const unsigned cur_s = slots_s + 4 * (g % BUFS) * S::BUF;
      const float* prv = slots + ((g + BUFS - 1) % BUFS) * S::BUF;
      float* e2 = sums.e2[g & 1];
      // every compute warp is past chunk c - 1, and the summing warp
      // has taken chunk c - 2's err*err
      bar_sync(BAR_EMPTY + (g & 1), BLOCK);
      // ahead, in one group: the table rows this warp takes in chunk
      // c + 1, the records of chunk c + 3; then the group of a chunk ago
      // (this warp's table rows of chunk c, the records of chunk c + 2)
      fetch_mine<NC>(a, ring, (g + 1) % STAGES,
                     slots_s + 4 * ((g + 1) % BUFS) * S::BUF, w, lane);
      fetch_records(a, ring, c3, (g + 3) % STAGES, tid);
      cp_commit();
      cp_wait<1>();
      __syncwarp();
      int cnt;
      const int4 mine = my_jobs(ring, t, w, lane, cnt);
      const unsigned gen = g + 1;
      // the job's rows (x, y); the previous job's results (px, py) until
      // its tail has run; lane q keeps job q's err*err
      float x[NC], y[NC], px[NC], py[NC];
      float ub, ib, pub = 0.f, pib = 0.f, e2q = 0.f;
      int pwd = 0, pu = 0, pi = 0;     // pwd 0: no previous job
#pragma unroll
      for (int c = 0; c < NC; ++c) px[c] = py[c] = 0.f;
      int4 d = shfl4(mine, 0);
      for (int q = 0; q < cnt; ++q) {
        const int wd = d.z, u = d.x, i = d.y;
        const float rv = __int_as_float(d.w);
        // a job another warp waits on flags its slot before this warp
        // may wait on another (no cycle of waits: a job waits only on
        // jobs of earlier rounds)
        if (pwd & NOTIFY) {
          tail<NC>(a, s, pwd, pu, pi, px, pub, py, pib, cur_s, lane);
          __syncwarp();
          if (lane == 0) st_release(flag + 4 * w_lane(pwd), gen);
          pwd = 0;
        }
        if (wd & (WAIT_U | WAIT_I | SYNC)) {
          // a row another warp writes in this chunk: after its flag; a
          // slot this warp wrote: after the warp's barrier
          if (wd & WAIT_U)
            while (ld_acquire(flag + 4 * w_ulane(wd)) != gen) {}
          if (wd & WAIT_I)
            while (ld_acquire(flag + 4 * w_ilane(wd)) != gen) {}
          __syncwarp();
        }
        take_side<NC>(wd, REG_U, w_usrc(wd), w_ulane(wd), cur, prv, 0, k,
                      lane, px, pub, x, ub);
        take_side<NC>(wd, REG_I, w_isrc(wd), w_ilane(wd), cur, prv, 1, k,
                      lane, py, pib, y, ib);
        d = shfl4(mine, q + 1 < cnt ? q + 1 : q);
        // the previous job's tail, in the gaps of this chain
        tail<NC>(a, s, pwd, pu, pi, px, pub, py, pib, cur_s, lane);
        // the chain
        const float dot = __fadd_rn(__fadd_rn(tree_dot<NC>(x, y), ub), ib);
        float err, grad;
        if (LOGISTIC) {
          const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-dot)));
          const float pred = __fadd_rn(s.lo, __fmul_rn(sig, s.rng));
          const float dg =
              __fmul_rn(__fmul_rn(sig, __fsub_rn(1.f, sig)), s.rng);
          err = __fsub_rn(rv, pred);
          grad = __fmul_rn(err, dg);
        } else {
          err = __fsub_rn(rv, dot);
          grad = err;                  // err * 1
        }
        // every update computed, the masks as selects
        ub = pick(s.uu, __fadd_rn(ub, __fmul_rn(s.lr, __fsub_rn(
                            grad, __fmul_rn(s.K_b, ub)))), ub);
        ib = pick(s.ui, __fadd_rn(ib, __fmul_rn(s.lr, __fsub_rn(
                            grad, __fmul_rn(s.K_b, ib)))), ib);
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const float cf = x[cc], mf = y[cc];
          y[cc] = pick(s.ui, __fadd_rn(mf, __fmul_rn(s.lr, __fsub_rn(
                      __fmul_rn(grad, cf), __fmul_rn(s.K_i, mf)))), mf);
          x[cc] = pick(s.uu, __fadd_rn(cf, __fmul_rn(s.lr, __fsub_rn(
                      __fmul_rn(grad, mf), __fmul_rn(s.K_u, cf)))), cf);
        }
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          px[cc] = x[cc];
          py[cc] = y[cc];
        }
        pub = ub;
        pib = ib;
        if (lane == q) e2q = __fmul_rn(err, err);
        pwd = wd;
        pu = u;
        pi = i;
      }
      tail<NC>(a, s, pwd, pu, pi, px, pub, py, pib, cur_s, lane);
      if (lane < cnt) e2[w_lane(mine.z)] = e2q;
      __syncwarp();
      if ((pwd & NOTIFY) && lane == 0)
        st_release(flag + 4 * w_lane(pwd), gen);
      bar_arrive(BAR_FULL + (g & 1), BLOCK);
      c3 = c3 + 1 == nch ? 0 : c3 + 1;
    }
    bar_sync(BAR_DECIDED, BLOCK);
    go = sums.go;
  }
  // the summing warp's last two arrivals at the slots' empty barriers
  if (g > 0) {
    bar_sync(BAR_EMPTY + (g & 1), BLOCK);
    bar_sync(BAR_EMPTY + ((g + 1) & 1), BLOCK);
  }
  cp_wait<0>();
}

// the summing warp: sse in stream order, each chunk's lane 0 first, then
// the rule
__device__ void summer(const Args& a, Sums& sums) {
  const int lane = threadIdx.x & 31;
  const int n = a.n, nch = a.nch;
  double rm = 2.0, rl = 2.0;           // ConvergenceDriver's start
  bool go = a.cap > 0 && keep_going(0, rm, rl, a);
  int e = 0;
  unsigned g = 0;
  if (go) {                            // chunks 0 and 1 may start at once
    bar_arrive(BAR_EMPTY, BLOCK);
    bar_arrive(BAR_EMPTY + 1, BLOCK);
  }
  while (go) {
    float sse = 0.f;
    for (int c = 0; c < nch; ++c, ++g) {
      const int slot = g & 1;
      bar_sync(BAR_FULL + slot, BLOCK);
      const float v = sums.e2[slot][lane];
      bar_arrive(BAR_EMPTY + slot, BLOCK);
      const int size = chunk_size(n, c);
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const float t = __shfl_sync(FULL, v, j);
        if (j < size) sse = __fadd_rn(sse, t);
      }
    }
    const float rmse = __fsqrt_rn(__fdiv_rn(sse, (float)n));
    if (lane == 0) a.out[e] = __float_as_int(rmse);
    rl = rm;
    rm = (double)rmse;
    ++e;
    go = e < a.cap && isfinite(rmse) && keep_going(e, rm, rl, a);
    if (lane == 0) sums.go = go;
    bar_arrive(BAR_DECIDED, BLOCK);
  }
  if (lane == 0) a.out[a.cap] = e;
}

template <int NC, bool LOGISTIC>
__global__ void __launch_bounds__(BLOCK) kmf_serial_kernel(const Args a) {
  using S = Slot<NC>;
  extern __shared__ __align__(16) float slots[];
  __shared__ Ring ring;
  __shared__ Sums sums;
  __shared__ unsigned flag[CHUNK];     // a slot's chunk generation
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int nch = a.nch;
  // the launch's start: the records of chunks 0, 1 and 2; the rows of
  // the last chunk as device memory holds them (what chunk 0 reads as
  // SRC_PREV) and chunk 0's table rows; the slots' flags
  for (int t = tid; t < 3 * CHUNK; t += BLOCK)
    ring.rec[t / CHUNK][t % CHUNK] =
        a.rec[(size_t)((t / CHUNK) % nch) * CHUNK + t % CHUNK];
  for (int t = tid; t < 3 * WS; t += BLOCK)
    ring.wst[t / WS][t % WS] = a.wst[(size_t)((t / WS) % nch) * WS + t % WS];
  if (tid < CHUNK) flag[tid] = 0;
  const int last = nch - 1;
  copy_rows<NC>(a, a.rec + (size_t)last * CHUNK, chunk_size(a.n, last),
                slots + (BUFS - 1) * S::BUF, w, BLOCK / LANES, lane, true);
  __syncthreads();                     // chunk 0's records, in the ring
  copy_rows<NC>(a, ring.rec[0], chunk_size(a.n, 0), slots, w, BLOCK / LANES,
                lane, false);
  __syncthreads();
  if (w < NW)
    walk<NC, LOGISTIC>(a, ring, sums, slots, smem(flag));
  else
    summer(a, sums);
}

// one rating's chain alone, as one warp holding the rows needs it: the
// dot (each lane's products in order, the xor-shuffle tree), the link
// (expf, the correctly rounded reciprocal), the error and sse, the bias
// and row updates.  Every rating is on one (u, i), so each waits for the one
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
  // the columns differ from lane to lane, as a row's do: a value the
  // compiler could prove the same in every lane would let it drop the
  // dot's cross-lane steps
  float x[NC], y[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float l = __fmul_rn((float)(c * LANES + lane), 0.001f);
    x[c] = __fadd_rn(__fadd_rn(0.1f, z), l);
    y[c] = __fsub_rn(__fadd_rn(0.1f, z), l);
  }
  float ub = z, ib = z, sse = z;
  for (int s = 0; s < n; ++s) {
    const float rv = (float)(1 + (s & 3));
    const float dot =
        __fadd_rn(__fadd_rn(tree_dot<NC>(x, y), ub), ib);
    float err, grad;
    if (LOGISTIC) {
      const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-dot)));
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

template <int NC, bool LOGISTIC>
int launch_one(const Args& a, cudaStream_t st) {
  auto kernel = kmf_serial_kernel<NC, LOGISTIC>;
  const size_t shm = (size_t)BUFS * Slot<NC>::BUF * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, BLOCK, shm, st>>>(a);
  return (int)cudaGetLastError();
}

template <int NC>
int launch_nc(int logistic, const Args& a, cudaStream_t st) {
  return logistic ? launch_one<NC, true>(a, st)
                  : launch_one<NC, false>(a, st);
}

}  // namespace

extern "C" {

// A call's epochs over the n >= 1 ratings of a plan (ops/kmf_serial_kernel
// .py kmf_plan: rec [nch * 32] records u, i, word, rating bits, each
// chunk's as its compute warps' job lists; wst [nch, WS] where each
// warp's jobs start; nw the compute warps the plan was dealt to, which
// must be this kernel's), until the rule stops, an epoch's rmse is not finite
// or cap epochs ran, in place on P [U, k] and Q [I, k] (row-major, 1 <= k
// <= 256) and bu [U], bi [I].  The ids must lie in range.  vec: rows may
// be copied 16 bytes at a time (k % 4 == 0, P and Q 16-byte aligned).
// The rule starts at epoch 0 with rmse and rmse_last 2.0, as
// ConvergenceDriver does.  out [cap + 1]: each epoch's rmse (f32 bits),
// then the count of epochs.  logistic: 1 the logistic link, 0 the linear
// one.  Returns a cudaError_t (0 = launched).
int kmf_serial_converge(float* P, float* Q, float* bu, float* bi,
                        const int* rec, const int* wst, int n, int nch,
                        int nw, int k, int logistic, int upd_u, int upd_i,
                        int vec, float lr, float K_u, float K_i, float K_b,
                        float lo, float rng, int min_ep, int max_ep,
                        double min_imp, int cap, int* out, void* stream) {
  if (n < 1 || nch != (n + CHUNK - 1) / CHUNK || nw != NW || k < 1 ||
      k > 256 || cap < 0 ||
      (vec && (k % 4 != 0 || (uintptr_t)P % 16 != 0 ||
               (uintptr_t)Q % 16 != 0)) ||
      (uintptr_t)rec % 16 != 0 || (uintptr_t)wst % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a;
  a.P = P; a.Q = Q; a.bu = bu; a.bi = bi;
  a.rec = reinterpret_cast<const int4*>(rec); a.wst = wst; a.out = out;
  a.n = n; a.nch = nch; a.k = k; a.upd_u = upd_u; a.upd_i = upd_i;
  a.vec = vec;
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

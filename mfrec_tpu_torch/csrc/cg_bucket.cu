// K2 on Hopper, fused: one ALS nnz bucket's gather, weighting, Gram on
// the tensor cores, right-hand side, warm-started Jacobi-PCG and the
// write-back of the solved rows, in one launch.
//
// Replaces the JAX package's bucket body mfrec_tpu/ops/als.py:99-106 (the
// bf16 gather F[nbr_idx], the bf16 weighting and the two einsums with f32
// accumulation) plus the Pallas TPU kernel it feeds,
// mfrec_tpu/ops/pallas_cg.py:26 (_kernel, entered through
// pcg_solve_resident).  For each system r of the bucket, with F bf16
// [n, kF] (kF >= k, a multiple of 8), HH f32 [k, k] (F^T F + reg I of the
// f32 fixed side), rows [R], idx, val and mask [R, L]:
//
//     cm1_l = (alpha > 0 ? alpha * val_l : c_pos) * mask_l        (f32)
//     Ab_l  = F[idx_l]                                            (bf16)
//     Awb_l = bf16(Ab_l * bf16(cm1_l))      the f32 product of the two
//                                           bf16 values, rounded to
//                                           nearest even
//     M     = HH + sum_l Awb_l^T Ab_l       f32 sums of exact products
//     b     = sum_l (1 + cm1_l) mask_l Ab_l f32
//     x     = `steps` PCG iterations on (M, b) from out[rows[r]] (pcg.cuh)
//     out[rows[r]] = x
//
// A padded slot (mask 0) contributes exactly 0 to M and b.  The kernel
// finds each row's count as one past its last slot with mask != 0 (it
// does not assume the real entries come first) and gathers and sums only
// up to there.  Ids are clamped into [0, n), as a JAX gather clamps them;
// a row id outside [0, n_upd) is not written, as a JAX scatter drops it.
//
// What bounds it on an H100, at the ALS epoch's shape (rank 64, 80,555
// systems in 16 buckets, 10.15M real entries per side): the bytes are
// the ids, values and mask at 12 B per slot read, the bf16 fixed side
// once and x0 and x (about 0.4 GB, 0.12 ms at 3.35 TB/s); the operations
// are the Gram over the real entries, 2 k^2 per entry and side (166
// GFLOP, 0.17 ms at 989 TFLOP/s bf16), plus 2 k^2 (steps + 1) per system
// of f32 PCG (0.04 ms at 67 TFLOP/s).  About 0.2 ms per epoch.  What
// this design meets instead: the gathers read the fixed side again from
// L2 for every entry (2.6 GB per epoch) as 16-byte copies, and mma.sync
// reaches about half of the tensor cores' wgmma rate.  Measured on an
// H100 80GB HBM3 at 700 W (per-block clock64 marks), the chunk loop takes
// about two thirds of a block's time and the PCG a fifth; within the loop
// the barrier seldom waits for data: issuing the copies takes about half
// of it, the products a quarter, b a fifth.  One bulk copy of the tensor
// memory accelerator a row (cp.async.bulk, completing on a barrier a
// stage) measured a quarter slower than the 16-byte copies; no other
// chunk size, ring depth or number of systems a block measured faster.
//
// Design.  A block of 4 warps takes `spb` systems (2 where the bucket has
// many rows, else 1); a row of more than 2 CLUSTER_SPAN slots is split
// over a thread-block cluster of up to 8 blocks, each taking a contiguous
// share of its chunks.  In a block:
//   - the block scans its systems' masks for their counts, all loads in
//     flight together, and asks L2 for the systems' x0 rows;
//   - the chunks of CH = 32 neighbour slots of its systems, system by
//     system (for k > 64 once for each pass over M's tiles), form one
//     stream, so the loads of a system's first chunks overlap the
//     products of the one before.  Each chunk's ids, values and mask are
//     copied with cp.async into a ring of NMS slots 2 NST - 2 chunks
//     ahead; its neighbour rows NST - 1 chunks ahead, 16 B per copy,
//     into a ring of NST stages in shared memory (row stride kp + 8
//     bf16: ldmatrix's 8 rows fall in 8 distinct bank groups; columns
//     from kF to kp are zero-filled).  The thread that issues a row also
//     stores bf16(cm1) and (1 + cm1) mask for it.  One barrier a chunk;
//   - the Gram runs on the tensor cores, mma.sync m16n8k16 bf16 -> f32:
//     A = Awb^T and B = Ab, both read from the ring by ldmatrix.trans;
//     the weighting bf16(Ab * w) is applied to A's fragments in
//     registers, one bf16x2 multiply a register.  Each warp owns a 32 x
//     32 tile of M (kp / 32 squared tiles; where they outnumber the warps
//     the chunks are streamed again for each further pass).  A chunk's 2 k-steps accumulate in
//     registers, then are added to the warp's running sum with IEEE f32
//     adds, so the tensor cores' own accumulation (which need not round
//     to nearest) spans 32 terms at most;
//   - b on the CUDA cores from the same ring: each thread sums one column
//     over a part of each chunk (f32, FMA), a chunk at a time, and the
//     parts are added in a fixed order;
//   - M = HH + the Gram goes to shared memory at pcg.cuh's odd stride.
//     In a cluster each rank keeps its partial Gram and b parts; after a
//     cluster barrier rank 0 adds them in rank order over distributed
//     shared memory, then HH.
// Then one warp per system runs pcg.cuh's iteration on it and writes the
// solved row in place.  M, Ab and Awb never reach device memory.  Where M
// does not fit in a block's shared memory beside the rings (k above about
// 200), it is written to a scratch buffer the wrapper allocates
// ([R, k, k] f32) and the iteration streams it from there (pcg.cuh's
// global mat-vec); no cluster then.  An optional copy of M and b
// ([R, k, k], [R, k]) is written for tests.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC.  Plain C interface, loaded by ctypes.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pcg.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int CH = 32;             // neighbour rows per chunk
constexpr int NST = 4;             // chunks in flight (the gather ring)
constexpr int NMS = 2 * NST - 2;   // slots of the ids/values/mask ring
constexpr int MAX_SPB = 2;         // systems a block
constexpr long long SPB_ROWS = 2048;   // buckets this long: 2 a block
constexpr int CLUSTER_SPAN = 4096; // slots a block of a cluster row takes
constexpr int MAX_CLUSTER = 8;     // blocks a cluster row

struct Args {
  const __nv_bfloat16* F;          // [n, kF]
  float* out;                      // [n_upd, k], updated in place
  const float* HH;                 // [k, k]
  const int* rows;                 // [R]
  const int* idx;                  // [R, L]
  const float* val;                // [R, L]
  const float* mask;               // [R, L]
  float* Mscr;                     // [R, k, k] where M is streamed, else 0
  float* Mout;                     // [R, k, k] copy of M, or 0
  float* bout;                     // [R, k] copy of b, or 0
  long long R, n, n_upd;
  int L, k, kF, ld, spb, csize, steps, vec4;
  float c_pos, alpha;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}

// 4 bytes (ids, values and mask of a row whose length is no multiple of 4)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16(x * w) for a pair, one bf16x2 multiply: the exact product
// rounded once to nearest even, as the f32 product of two bf16 values
// (exact) rounded to bf16 is.
__device__ __forceinline__ uint32_t scale2(uint32_t x, __nv_bfloat162 w) {
  __nv_bfloat162 v;
  memcpy(&v, &x, 4);
  const __nv_bfloat162 r = __hmul2(v, w);
  uint32_t o;
  memcpy(&o, &r, 4);
  return o;
}

// KT: M's 32 x 32 tiles a side (k <= 32 KT); the widths below are
// compile-time constants of it.
template <int KT>
struct Widths {
  static constexpr int kp = 32 * KT;          // k padded to the tiles
  static constexpr int ldr = kp + 8;          // the ring's row stride
  static constexpr int npass = (KT * KT + WARPS - 1) / WARPS;
  static constexpr int nsplit = kp >= THREADS ? 1 : THREADS / kp;  // b
  static constexpr int bps = kp * nsplit;     // floats of b's parts
  static constexpr int rpart = CH / nsplit;   // rows of a part
  static constexpr int NR = KT <= 1 ? 1 : KT <= 2 ? 2 : KT <= 4 ? 4 : 8;
};

template <int KT, bool SMEM>
__global__ void __launch_bounds__(THREADS, KT <= 2 ? 4 : 1)
cg_bucket_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using Wd = Widths<KT>;
  constexpr int kp = Wd::kp, ldr = Wd::ldr, npass = Wd::npass;
  constexpr int nsplit = Wd::nsplit, bps = Wd::bps, rpart = Wd::rpart;
  const int k = a.k, ld = a.ld, L = a.L;
  const int spb = a.spb, cs = a.csize;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* wv = ring + NST * CH * ldr;      // bf16(cm1) per slot
  float* cf = reinterpret_cast<float*>(wv + NST * CH);  // (1+cm1) mask
  int* mid = reinterpret_cast<int*>(cf + NST * CH);     // ids, values and
  float* mval = reinterpret_cast<float*>(mid + NMS * CH);  // mask ring
  float* mmask = mval + NMS * CH;
  float* bpart = mmask + NMS * CH;                // b's parts, per system
  float* bs = bpart + spb * bps;                  // b, per system
  int* red = reinterpret_cast<int*>(bs + spb * kp);
  int* scnt = red + MAX_SPB * WARPS;              // count, first and end
  int* slo = scnt + MAX_SPB;                      // chunk of this block,
  int* shi = slo + MAX_SPB;                       // per system
  int* srow = shi + MAX_SPB;                      // row, per system
  float* Msys = reinterpret_cast<float*>(srow + MAX_SPB);  // M, per system

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  // a cluster takes one system, each rank a contiguous share of its
  // chunks; a lone block takes spb systems
  const int rank = cs > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const long long base = cs > 1 ? (long long)(blockIdx.x / cs)
                                : (long long)blockIdx.x * spb;
  const int nq = (int)min((long long)(cs > 1 ? 1 : spb), a.R - base);
  constexpr int ntj = KT, ntiles = KT * KT;
  const int sys_floats = k * ld + k;
  const int nseg = nq * npass;       // (system, pass), in that order
  // the rows this thread issues: rows tid / 4, + 32, ... of a chunk,
  // 16 B pieces tid % 4, + 4, ...
  const int my_r = tid >> 2, my_q = tid & 3;
  // the fields the lambdas below read, as locals (a lambda that captured
  // the kernel parameter would take its address)
  const __nv_bfloat16* F = a.F;
  const int* idx = a.idx;
  const float* val = a.val;
  const float* mask = a.mask;
  const long long nF = a.n;
  const int kF = a.kF, vec4 = a.vec4;
  const float alpha = a.alpha, c_pos = a.c_pos;

  // each system's count: one past its last slot with mask != 0; the
  // loads of all the block's systems (and their row ids) in flight
  // together
  {
    const int myrow = tid < nq ? __ldg(a.rows + base + tid) : 0;
    int last[MAX_SPB];
#pragma unroll
    for (int q = 0; q < MAX_SPB; ++q) {
      last[q] = -1;
      if (q >= nq) continue;
      const float* mrow = mask + (base + q) * L;
      if (vec4) {
        const float4* m4 = reinterpret_cast<const float4*>(mrow);
        for (int t = tid; t < (L >> 2); t += THREADS) {
          const float4 w = __ldg(m4 + t);
          const int l = t << 2;
          last[q] = w.w != 0.f ? l + 3 : w.z != 0.f ? l + 2
                  : w.y != 0.f ? l + 1 : w.x != 0.f ? l : last[q];
        }
      } else {
        for (int l = tid; l < L; l += THREADS)
          if (__ldg(mrow + l) != 0.f) last[q] = l;
      }
    }
#pragma unroll
    for (int q = 0; q < MAX_SPB; ++q) {
#pragma unroll
      for (int m = 16; m >= 1; m >>= 1)
        last[q] = max(last[q], __shfl_xor_sync(0xffffffffu, last[q], m));
      if (lane == 0) red[q * WARPS + warp] = last[q];
    }
    __syncthreads();
    if (tid < nq) {
      int c = red[tid * WARPS];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) c = max(c, red[tid * WARPS + w]);
      c += 1;
      const int nch = (c + CH - 1) / CH;
      scnt[tid] = c;
      slo[tid] = nch * rank / cs;
      shi[tid] = nch * (rank + 1) / cs;
      srow[tid] = myrow;
    }
    __syncthreads();
  }

  // the systems' counts and chunk ranges, in registers (MAX_SPB == 2)
  static_assert(MAX_SPB == 2, "the selects below take two systems");
  const int cnt0 = scnt[0], lo0 = slo[0], hi0 = shi[0];
  const int cnt1 = nq > 1 ? scnt[1] : 0, lo1 = nq > 1 ? slo[1] : 0;
  const int hi1 = nq > 1 ? shi[1] : 0;
  auto cnt_of = [&](int q) { return q ? cnt1 : cnt0; };
  auto lo_of = [&](int q) { return q ? lo1 : lo0; };
  auto hi_of = [&](int q) { return q ? hi1 : hi0; };

  // the items, chunk c of system q in pass `pass`, in that order; a
  // cursor walks them, skipping systems without chunks (q == nq: past
  // the end)
  struct Cur {
    int q, pass, c;
  };
  auto skip = [&](Cur u) {
    while (u.q < nq && u.c >= hi_of(u.q)) {
      if (++u.pass == npass) {
        u.pass = 0;
        ++u.q;
      }
      if (u.q < nq) u.c = lo_of(u.q);
    }
    return u;
  };
  auto next = [&](Cur u) {
    if (u.q < nq) ++u.c;
    return skip(u);
  };
  // an item's ids, values and mask into slot ms, one array a warp: 16 B
  // copies where rows are 16-byte aligned, else 4 B; slots past the
  // count are zero-filled
  auto issue_meta = [&](Cur u, int ms) {
    if (u.q >= nq || warp >= 3) return;
    const long long off = (base + u.q) * L;
    const int l0 = u.c * CH, cnt = cnt_of(u.q);
    const float* src = warp == 0 ? reinterpret_cast<const float*>(idx)
                     : warp == 1 ? val : mask;
    float* dst = (warp == 0 ? reinterpret_cast<float*>(mid)
                  : warp == 1 ? mval : mmask) + ms * CH;
    if (vec4) {
      if (lane < CH / 4) {
        const int j = lane << 2;
        const int n = min(max(cnt - (l0 + j), 0), 4);
        cp_async16(dst + j, n ? src + off + l0 + j : src, 4 * n);
      }
    } else {
#pragma unroll
      for (int j = lane; j < CH; j += 32) {
        const bool have = l0 + j < cnt;
        cp_async4(dst + j, have ? src + off + l0 + j : src, have ? 4 : 0);
      }
    }
  };
  // an item's neighbour rows into stage st of the ring, from its ids in
  // slot ms, and its weights
  auto issue_rows = [&](Cur u, int st, int ms) {
    if (u.q >= nq) return;
#pragma unroll
    for (int rr = 0; rr < CH / 32; ++rr) {
      const int r = my_r + 32 * rr;
      const bool live = u.c * CH + r < cnt_of(u.q);
      const int id = mid[ms * CH + r];
      __nv_bfloat16* dst = ring + (st * CH + r) * ldr;
      const long long rid = id < 0 ? 0 : (id >= nF ? nF - 1 : id);
      const __nv_bfloat16* src = F + rid * kF;
#pragma unroll
      for (int pp = 0; pp < KT; ++pp) {  // kp / 8 pieces, 4 threads a row
        const int col = (my_q + 4 * pp) << 3;
        const bool have = live && col < kF;
        cp_async16(dst + col, have ? src + col : F, have ? 16 : 0);
      }
      if (my_q == 0) {
        float cm1 = 0.f, coef = 0.f;
        if (live) {
          const float v = mval[ms * CH + r], m = mmask[ms * CH + r];
          cm1 = __fmul_rn(alpha > 0.f ? __fmul_rn(alpha, v) : c_pos, m);
          coef = __fmul_rn(__fadd_rn(1.f, cm1), m);
        }
        wv[st * CH + r] = __float2bfloat16_rn(cm1);
        cf[st * CH + r] = coef;
      }
    }
  };
  auto wrap = [](int i, int n) { return i + 1 == n ? 0 : i + 1; };

  // the pipeline: at item f the rows of item f + NST - 1 are issued, and
  // the ids of item f + 2 NST - 2, one commit group each item; gst and
  // gms are the stage and slot of the rows issued next, mms the slot of
  // the ids issued next
  Cur gc = skip(Cur{0, 0, lo0}), mc = gc;
  int gst = 0, gms = 0, mms = 0;
#pragma unroll
  for (int j = 0; j < NST - 1; ++j) {
    issue_meta(mc, mms);
    mc = next(mc);
    mms = wrap(mms, NMS);
  }
  if (rank == 0 && tid < nq * 8) {   // the systems' x0 into L2, for the PCG
    const int q = tid >> 3, line = tid & 7, row = srow[q];
    if (row >= 0 && row < a.n_upd && line * 32 < k)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(
          a.out + (long long)row * k + line * 32));
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NST - 1; ++j) {
    issue_rows(gc, gst, gms);
    gc = next(gc);
    gst = wrap(gst, NST);
    gms = wrap(gms, NMS);
    issue_meta(mc, mms);
    mc = next(mc);
    mms = wrap(mms, NMS);
    cp_commit();
  }

  // b: this thread sums column bj[e] over rows br0[e] .. + rpart of each
  // chunk
  int bj[2], br0[2];
  bool bon[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int p = tid + THREADS * e;
    bon[e] = p < bps;
    bj[e] = p % kp;
    br0[e] = (p / kp) * rpart;
  }
  float bacc[2] = {0.f, 0.f};
  int st = 0;                        // the stage of the item computed next
  for (int seg = 0; seg < nseg; ++seg) {
    const int q = seg / npass, pass = seg - q * npass;
    const long long s = base + q;
    const int tile = pass * WARPS + warp;
    const bool active = tile < ntiles;
    const int i0 = (tile / ntj) << 5, j0 = (tile % ntj) << 5;
    float acc[2][4][4];
#pragma unroll
    for (int mi2 = 0; mi2 < 2; ++mi2)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi2][ni][e] = 0.f;
    const int chi = hi_of(q);
    for (int c = lo_of(q); c < chi; ++c, st = wrap(st, NST)) {
      cp_wait<NST - 2>();
      __syncthreads();               // this item landed; the last freed
      issue_rows(gc, gst, gms);
      gc = next(gc);
      gst = wrap(gst, NST);
      gms = wrap(gms, NMS);
      issue_meta(mc, mms);
      mc = next(mc);
      mms = wrap(mms, NMS);
      cp_commit();
      const __nv_bfloat16* S = ring + st * CH * ldr;
      const __nv_bfloat16* W = wv + st * CH;
      if (active) {
        float part[2][4][4];
#pragma unroll
        for (int mi2 = 0; mi2 < 2; ++mi2)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[mi2][ni][e] = 0.f;
        const int mat = lane >> 3, r8 = lane & 7;
#pragma unroll
        for (int ks = 0; ks < CH / 16; ++ks) {
          const int l0 = ks * 16;
          uint32_t A[2][4], B[4][2];
          __nv_bfloat162 w01, w89;
          memcpy(&w01, W + l0 + 2 * tig, 4);
          memcpy(&w89, W + l0 + 8 + 2 * tig, 4);
#pragma unroll
          for (int mi2 = 0; mi2 < 2; ++mi2) {
            // (i 0-7 | 8-15) x (l 0-7 | 8-15) of A = Awb^T
            ldsm_x4_t(A[mi2], S + (l0 + r8 + 8 * (mat >> 1)) * ldr + i0 +
                                  16 * mi2 + 8 * (mat & 1));
            A[mi2][0] = scale2(A[mi2][0], w01);
            A[mi2][1] = scale2(A[mi2][1], w01);
            A[mi2][2] = scale2(A[mi2][2], w89);
            A[mi2][3] = scale2(A[mi2][3], w89);
          }
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t t4[4];
            ldsm_x4_t(t4, S + (l0 + r8 + 8 * (mat & 1)) * ldr + j0 +
                              8 * (2 * np + (mat >> 1)));
            B[2 * np][0] = t4[0];
            B[2 * np][1] = t4[1];
            B[2 * np + 1][0] = t4[2];
            B[2 * np + 1][1] = t4[3];
          }
#pragma unroll
          for (int mi2 = 0; mi2 < 2; ++mi2)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
              mma_bf16(part[mi2][ni], A[mi2], B[ni][0], B[ni][1]);
        }
#pragma unroll
        for (int mi2 = 0; mi2 < 2; ++mi2)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[mi2][ni][e] = __fadd_rn(acc[mi2][ni][e], part[mi2][ni][e]);
      }
      if (pass == 0) {               // b: column j over a part of the chunk
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (bon[e]) {
            const int j = bj[e], r0 = br0[e];
            const float* c4 = cf + st * CH + r0;
            float t = 0.f;
#pragma unroll
            for (int r = 0; r < rpart; r += 4) {
              const float4 c = *reinterpret_cast<const float4*>(c4 + r);
              t = fmaf(c.x, __bfloat162float(S[(r0 + r) * ldr + j]), t);
              t = fmaf(c.y, __bfloat162float(S[(r0 + r + 1) * ldr + j]), t);
              t = fmaf(c.z, __bfloat162float(S[(r0 + r + 2) * ldr + j]), t);
              t = fmaf(c.w, __bfloat162float(S[(r0 + r + 3) * ldr + j]), t);
            }
            bacc[e] = __fadd_rn(bacc[e], t);
          }
        }
      }
    }
    // the segment's tile: M = HH + the Gram (a cluster: the rank's
    // partial Gram), and b's parts after the first pass
    if (active) {
      float* Mq = SMEM ? Msys + q * sys_floats : a.Mscr + s * k * k;
      const int ldq = SMEM ? ld : k;
#pragma unroll
      for (int mi2 = 0; mi2 < 2; ++mi2)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + 16 * mi2 + g + 8 * (e >> 1);
            const int j = j0 + 8 * ni + 2 * tig + (e & 1);
            if (i < k && j < k) {
              if (cs > 1) {
                Mq[i * ldq + j] = acc[mi2][ni][e];
              } else {
                const float v = __fadd_rn(__ldg(a.HH + i * k + j),
                                          acc[mi2][ni][e]);
                Mq[i * ldq + j] = v;
                if (a.Mout) a.Mout[s * k * k + i * k + j] = v;
              }
            }
          }
    }
    if (pass == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (bon[e]) bpart[q * bps + tid + THREADS * e] = bacc[e];
        bacc[e] = 0.f;
      }
    }
  }
  cp_wait<0>();
  __syncthreads();                   // every segment's M and b parts in

  if (cs > 1) {
    // rank 0 adds the ranks' partial Grams and b parts in rank order
    // over distributed shared memory, then HH
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    if (rank == 0) {
      const long long s = base;
      for (int t = tid; t < k * k; t += THREADS) {
        const int i = t / k, j = t - i * k;
        float v = Msys[i * ld + j];
        for (int r = 1; r < cs; ++r)
          v = __fadd_rn(v, cl.map_shared_rank(Msys, r)[i * ld + j]);
        v = __fadd_rn(__ldg(a.HH + t), v);
        Msys[i * ld + j] = v;
        if (a.Mout) a.Mout[s * k * k + t] = v;
      }
      for (int j = tid; j < kp; j += THREADS) {
        float t = 0.f;
        for (int r = 0; r < cs; ++r) {
          const float* bp = cl.map_shared_rank(bpart, r);
          float u = bp[j];
          for (int w = 1; w < nsplit; ++w) u = __fadd_rn(u, bp[w * kp + j]);
          t = r ? __fadd_rn(t, u) : u;
        }
        bs[j] = t;
        if (a.bout && j < k) a.bout[s * k + j] = t;
      }
    }
    cl.sync();                       // the others' shared memory is read
    if (rank != 0) return;
  } else {
    for (int q = 0; q < nq; ++q)     // b's parts, added in a fixed order
      for (int j = tid; j < kp; j += THREADS) {
        const float* bp = bpart + q * bps;
        float t = bp[j];
        for (int w = 1; w < nsplit; ++w) t = __fadd_rn(t, bp[w * kp + j]);
        bs[q * kp + j] = t;
        if (a.bout && j < k) a.bout[(base + q) * k + j] = t;
      }
    __syncthreads();
  }
  if (warp < nq) {                   // one warp a system: the PCG
    const long long s = base + warp;
    const int row = srow[warp];
    if (row < 0 || row >= a.n_upd) return;
    float* og = a.out + (long long)row * k;
    if constexpr (SMEM) {
      float* Ms = Msys + warp * sys_floats;
      k2::pcg_warp<Wd::NR, true, false>(Ms, Ms + k * ld, ld, nullptr,
                                        bs + warp * kp, og, og, k, a.steps,
                                        lane);
    } else {
      k2::pcg_warp<Wd::NR, false, false>(nullptr, nullptr, ld,
                                         a.Mscr + s * k * k, bs + warp * kp,
                                         og, og, k, a.steps, lane);
    }
  }
}

size_t smem_bytes(int k, int spb, bool smem) {
  const int kp = (k + 31) & ~31, ld = k | 1;
  const int bps = kp * (kp >= THREADS ? 1 : THREADS / kp);
  size_t b = (size_t)NST * CH * (kp + 8) * 2 + NST * CH * 2 + NST * CH * 4 +
             (size_t)NMS * CH * 12 + (size_t)spb * (bps + kp) * 4 +
             (MAX_SPB * WARPS + 4 * MAX_SPB) * 4;
  if (smem) b += (size_t)spb * (k * ld + k) * 4;
  return b;
}

constexpr int MAX_DEV = 64;        // devices whose attributes are cached

// The current device and its shared memory a block may opt in to, read
// once per device.
int optin_bytes(int* dev, int* optin) {
  static int cached[MAX_DEV] = {};
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  if (*dev < MAX_DEV && cached[*dev]) {
    *optin = cached[*dev];
    return 0;
  }
  err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               *dev);
  if (err == cudaSuccess && *dev < MAX_DEV) cached[*dev] = *optin;
  return (int)err;
}

template <int KT, bool SMEM>
int launch_as(const Args& a, int dev, cudaStream_t st) {
  // the kernel's dynamic shared memory limit, raised once per device and
  // size
  static size_t set[MAX_DEV] = {};
  const size_t bytes = smem_bytes(a.k, a.spb, SMEM);
  auto kern = cg_bucket_kernel<KT, SMEM>;
  cudaError_t err = cudaSuccess;
  if (dev >= MAX_DEV || set[dev] < bytes) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEV) set[dev] = bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.csize > 1 ? a.R * a.csize
                                            : (a.R + a.spb - 1) / a.spb));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.csize > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int KT>
int launch(Args a, cudaStream_t st) {
  int dev = 0, optin = 0;
  int err = optin_bytes(&dev, &optin);
  if (err) return err;
  a.ld = a.k | 1;
  const bool smem = smem_bytes(a.k, 1, true) <= (size_t)optin;
  // rows of more than 2 CLUSTER_SPAN slots: a cluster of blocks each
  a.csize = 1;
  if (smem)
    while (a.csize < MAX_CLUSTER &&
           (long long)a.csize * CLUSTER_SPAN < (long long)a.L)
      a.csize *= 2;
  if (a.csize > 1 && (long long)a.L < 2LL * CLUSTER_SPAN) a.csize = 1;
  a.spb = a.csize == 1 && a.R >= SPB_ROWS ? MAX_SPB : 1;
  while (a.spb > 1 && smem_bytes(a.k, a.spb, smem) > (size_t)optin) --a.spb;
  if (smem_bytes(a.k, a.spb, smem) > (size_t)optin)
    return (int)cudaErrorInvalidConfiguration;
  if (smem) return launch_as<KT, true>(a, dev, st);
  if (!a.Mscr) return (int)cudaErrorInvalidValue;
  if constexpr (KT > 4) return launch_as<KT, false>(a, dev, st);
  return (int)cudaErrorInvalidConfiguration;
}

}  // namespace

extern "C" {

// 1 where a system's M does not fit in a block's shared memory at this k
// (the caller then passes Mscr, [R, k, k] f32), 0 where it does, or -1 on
// a CUDA error.
int cg_bucket_m_streamed(int k) {
  int dev = 0, optin = 0;
  if (optin_bytes(&dev, &optin)) return -1;
  return smem_bytes(k, 1, true) > (size_t)optin ? 1 : 0;
}

// One bucket: F [n, kF] bf16 (kF a multiple of 8, k <= kF), out [n_upd, k]
// f32 updated in place at rows [R] (int32), HH [k, k] f32, idx [R, L]
// int32, val and mask [R, L] f32, all contiguous; Mscr as
// cg_bucket_m_streamed says; Mout [R, k, k] and bout [R, k] f32 or null.
// Returns a cudaError_t (0 = launched).  The caller checks shapes:
// 1 <= k <= 256, steps >= 0, R >= 1, L >= 1.
int cg_bucket_launch(const void* F, long long n, int kF, float* out,
                     long long n_upd, const float* HH, const int* rows,
                     const int* idx, const float* val, const float* mask,
                     long long R, int L, int k, float c_pos, float alpha,
                     int steps, float* Mscr, float* Mout, float* bout,
                     void* stream) {
  Args a{};
  a.F = static_cast<const __nv_bfloat16*>(F);
  a.out = out;
  a.HH = HH;
  a.rows = rows;
  a.idx = idx;
  a.val = val;
  a.mask = mask;
  a.Mscr = Mscr;
  a.Mout = Mout;
  a.bout = bout;
  a.R = R;
  a.n = n;
  a.n_upd = n_upd;
  a.L = L;
  a.k = k;
  a.kF = kF;
  a.steps = steps;
  a.c_pos = c_pos;
  a.alpha = alpha;
  a.vec4 = (L % 4 == 0) && ((uintptr_t)mask % 16 == 0) &&
           ((uintptr_t)val % 16 == 0) && ((uintptr_t)idx % 16 == 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((k + 31) / 32) {
    case 1: return launch<1>(a, st);
    case 2: return launch<2>(a, st);
    case 3: return launch<3>(a, st);
    case 4: return launch<4>(a, st);
    case 5: return launch<5>(a, st);
    case 6: return launch<6>(a, st);
    case 7: return launch<7>(a, st);
    case 8: return launch<8>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* cg_bucket_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

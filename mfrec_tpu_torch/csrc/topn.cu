// K3 on Hopper: fused top-n retrieval with rated-item exclusion.
//
// Replaces the Pallas TPU kernel mfrec_tpu/ops/pallas_topk.py
// (_topn_kernel, entered through topn_scores_pallas).  For a batch of B
// users it returns the n best items of
//
//     score[u, i] = ((P[u] . Q[i] + mu) + bu[u]) + bi[i]
//
// over all I items, with each user's already-rated items set to NEG, as
// (idx [B, n] int32, scores [B, n] f32) sorted by (score desc, id asc).
//
// Modes: exact (f32 operands, f32 sums) and the two fast opt-ins of the
// TPU kernel, which the caller may set separately:
//   bf16_dot  P and Q rounded to bf16, products summed in f32; Q may
//             arrive already stored as bf16 (half the bytes streamed);
//   packed    every score quantized toward -inf by clearing the low 12
//             bits of its monotone int32 key, as the TPU kernel's
//             id-in-mantissa block top-n does.
//
// Design.  A block owns a tile of UT = 64 users for its whole life and
// walks a contiguous range of IT = 128-item tiles of Q (its split), in
// ascending order, as the TPU kernel walks its sequential grid.
//   - Q reaches the score loop through shared memory: each tile comes in
//     as 128-byte column chunks (64 bf16 or 32 f32 of k), by cp.async
//     16-byte copies into a ring of two chunks (rows padded to 144
//     bytes, so fragment reads hit distinct banks), the tile's item
//     biases with its first chunk.  Q is read from L2
//     B/64 times.  A Q whose rows are no multiple of 16 bytes, or an f32
//     Q in the bf16 mode, is staged by plain loads (converted on the way).
//   - The tile's P rows sit in shared memory for the block's life.
//   - Products on the tensor cores (mma.sync; eight warps each own 32
//     items x 32 users of the 128 x 64 score tile).  bf16 mode: m16n8k16
//     bf16 with f32 accumulators, the operands rounded to nearest even
//     as the TPU kernel's bf16_dot does.  Exact mode: split TF32,
//     m16n8k8 hi*lo + lo*hi + hi*hi, hi and lo the two tf32 parts of each
//     f32 operand (the dropped lo*lo and the parts' rounding leave about
//     2^-21 of each product).  A register-blocked f32 outer product on
//     the CUDA cores, fed from the same shared Q tile, measured 18-23 %
//     slower at the bench shape and was dropped.
//   - Selection (n <= RUN_MAX): each user keeps its running top-n as
//     64-bit keys (monotone score bits << 32 | ~id) in shared memory, and
//     a threshold, its n-th best key.  A score becomes a candidate only
//     if it beats the threshold (a float compare of each user's best of
//     the thread's 4 items, then of each; the key only past it).
//     Candidates go to a per-user buffer in shared memory; after the
//     tile, the warp that owns the user masks its rated ones, inserts
//     them into the list (a ballot of each batch of 32 against the
//     threshold, then one shuffle insertion per survivor) and raises the
//     threshold; warps whose users have none skip the tile.  The
//     block's first tile, every item a candidate, is selected by n rounds
//     of warp max (two 32-bit warp reductions a round) over keys held in
//     registers, four users at a time.
//   - Rated ids: each user's sorted rated row is consumed by a pointer
//     that only moves forward (a 32-probe search at the split's start),
//     through a window of its next 32 ids in shared memory.  The first
//     tile (and every tile of the n > RUN_MAX route) masks from a bitmap;
//     later tiles check only candidates, when their user's are merged.
//   - Each split leaves n keys per user; with more than one split, one
//     small merge launch (a warp per user, the same insertion) joins
//     them.  At most two launches a call.
//   - n > RUN_MAX: a route by shape.  Each tile's keys are sorted in
//     shared memory (bitonic, per user) and the best min(n, IT) written
//     out; one merge launch (a block per user) then sorts them in rounds
//     of up to 8,192 keys, keeping the running best n.  Also two
//     launches.
// Items past I are never read: rows past I are zero-filled and never
// become candidates.
//
// What bounds it on an H100.  At the bench shape (B=1024, I=360,000,
// k=64) one call is 2*B*I*k = 47.2 GFLOP: on the tensor cores in bf16
// ~0.048 ms (989 TFLOP/s), split TF32 3x that at 495 TFLOP/s (0.29 ms),
// on the CUDA cores 0.70 ms (67 TFLOP/s).  Q streams from L2 16 times
// (0.74 GB bf16, 1.5 GB f32).  The epilogue's per-score work (three
// bias adds and a compare over 368M scores) is of the same order as the
// bf16 products.  What holds it now is latency between the per-tile
// phases (starting copies, products, epilogue, insertion), each closed by a
// block barrier, at two blocks of eight warps an SM.  At the serving
// shape (B=256, I=10,677) it is 0.35 GFLOP, and nearly every tile is a
// block's first: the first tile's selection sets the time.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC.  Plain C interface, loaded by ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

typedef unsigned long long u64;

constexpr int NT = 256;            // threads per block, every kernel
constexpr int UT = 64;             // users per block
constexpr int IT = 128;            // items per tile
constexpr int CHB = 128;           // bytes of a Q row per chunk
constexpr int ROWS = CHB + 16;     // padded row stride in shared memory
constexpr int STAGE = IT * ROWS;   // bytes of one ring stage
constexpr int NSTAGE = 2;          // ring stages
constexpr int RUN_MAX = 32;        // longest running list (n <= RUN_MAX)
constexpr int MERGE_KEYS = 8192;   // keys one sort-route merge round sorts
constexpr float NEG = -3.0e38f;
constexpr uint32_t PACK_MASK = 0xFFFu;

// product routes
constexpr int R_BF16 = 0;          // mma.sync bf16 (bf16_dot)
constexpr int R_TF32X3 = 1;        // mma.sync split tf32 (exact)

__device__ __forceinline__ uint32_t f32_to_ord(float s) {
  const uint32_t b = __float_as_uint(s);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float ord_to_f32(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}

__device__ __forceinline__ u64 make_key(uint32_t ord, int id) {
  return (static_cast<u64>(ord) << 32) | static_cast<u64>(~static_cast<uint32_t>(id));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo, both tf32 (hi rounded to nearest, lo the rounded rest)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// Sort `segs` contiguous segments of N keys each (N a power of two)
// into descending order, in shared memory, with the whole block.
__device__ void bitonic_sort_desc(u64* a, int segs, int N) {
  const int pairs = segs * N / 2;
  for (int k = 2; k <= N; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
        const int i = 2 * j * (p / j) + (p % j);
        const int q = i + j;
        const bool desc = ((i & (N - 1)) & k) == 0;
        const u64 x = a[i], y = a[q];
        if (desc ? (x < y) : (x > y)) {
          a[i] = y;
          a[q] = x;
        }
      }
      __syncthreads();
    }
  }
}

// Insert the warp's batch of keys (one per lane, 0 = none) into the
// running list `run` (lane r holds the r-th best, descending over all 32
// lanes; 0 = empty) and refresh `thr`, its n-th key.  Keys that beat
// `thr` go in one shuffle insertion each; one that an earlier insertion
// of the batch pushed below the n-th lands past lane n - 1, where it does
// no harm.  Keys are unique, so no key equals one already in the list.
__device__ __forceinline__ void insert_batch(u64& run, u64& thr, u64 key, int n,
                                             int lane) {
  unsigned m = __ballot_sync(0xffffffffu, key > thr);
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const u64 x = __shfl_sync(0xffffffffu, key, src);
    u64 prev = __shfl_up_sync(0xffffffffu, run, 1);
    if (lane == 0) prev = ~0ull;
    run = run > x ? run : (prev > x ? x : prev);
  }
  thr = __shfl_sync(0xffffffffu, run, n - 1);
}

// The first tile's lists of 4 of the warp's users (OFF..OFF+3), from
// every item's key (a first-tile candidate's slot is its item): n rounds
// of warp max, the 4 users in lockstep, the keys in registers (4 a lane
// and user).  A round is two 32-bit warp reductions, the score bits and
// then, among the lanes that hold them, the id bits; lane r keeps round
// r's key and the lane that held it drops it.
template <int OFF>
__device__ __forceinline__ void fill_lists(u64* run_s, const int* cnt,
                                           const uint32_t* cand_o, int base, int n,
                                           int warp, int lane) {
  u64 k[4][IT / 32], best[4], run[4];
#pragma unroll
  for (int ui = 0; ui < 4; ++ui) {
    const int u = warp * 8 + OFF + ui, cu = cnt[u];
    best[ui] = 0ull;
    run[ui] = 0ull;
#pragma unroll
    for (int q = 0; q < IT / 32; ++q) {
      const int e = q * 32 + lane;
      k[ui][q] = e < cu ? make_key(cand_o[u * IT + e], base + e) : 0ull;
      best[ui] = k[ui][q] > best[ui] ? k[ui][q] : best[ui];
    }
  }
#pragma unroll 1
  for (int r = 0; r < n; ++r) {
#pragma unroll
    for (int ui = 0; ui < 4; ++ui) {
      const uint32_t hb = static_cast<uint32_t>(best[ui] >> 32);
      const uint32_t m = __reduce_max_sync(0xffffffffu, hb);
      const uint32_t ml = __reduce_max_sync(
          0xffffffffu, hb == m ? static_cast<uint32_t>(best[ui]) : 0u);
      const u64 w = (static_cast<u64>(m) << 32) | ml;
      run[ui] = lane == r ? w : run[ui];
      const bool own = best[ui] == w;
      u64 nb = 0ull;
#pragma unroll
      for (int q = 0; q < IT / 32; ++q) {
        k[ui][q] = own && k[ui][q] == w ? 0ull : k[ui][q];
        nb = k[ui][q] > nb ? k[ui][q] : nb;
      }
      best[ui] = nb;
    }
  }
#pragma unroll
  for (int ui = 0; ui < 4; ++ui)
    if (lane < n) run_s[(warp * 8 + OFF + ui) * n + lane] = run[ui];
}

struct Args {
  const float* P;
  const void* Q;
  const float* bu;
  const float* bi;
  const int* ridx;
  const int* rcnt;
  u64* ws;
  int* out_idx;
  float* out_s;
  float mu;
  int L, B, I, k, n, nkc, ntiles, splits, packed, async_q, async_bi;
};

__host__ __device__ constexpr int p_stride(int nkc) { return nkc * CHB + 16; }

// Shared memory of the main kernel, in bytes: the Q ring and its item
// biases, the P tile, the candidates and the running lists (BIGN: the
// tile's keys), the rated bitmaps and the per-user counters.
template <bool BIGN>
__host__ __device__ constexpr size_t main_smem(int nkc, int n) {
  return (size_t)NSTAGE * (STAGE + IT * 4) + (size_t)UT * p_stride(nkc)
         + (BIGN ? (size_t)UT * IT * 8 : (size_t)UT * IT * 5 + (size_t)UT * n * 8)
         + 2 * UT * (IT / 32) * 4       // rated bitmaps, double-buffered
         + UT * (4 + 4 + 8 + 4 + 4 + 4)  // cnt, thr_s, thr_k, rated pointer and count, bu
         + UT * (4 + 32 * 4) + 8;        // rated windows; the users with candidates
  // (the running lists last, 8-byte aligned)
}

template <int ROUTE>
struct RouteCfg {
  static constexpr int ES = ROUTE == R_BF16 ? 2 : 4;   // staged element bytes
  static constexpr int KCE = CHB / ES;                 // k per chunk
};

// Stage chunk `c` of item tile `j` into `dst` (IT rows of ROWS bytes),
// and with chunk 0 the tile's item biases into `bdst`.
template <int ROUTE, bool QBF16>
__device__ __forceinline__ void load_chunk(const Args& a, unsigned char* dst,
                                           float* bdst, int j, int c) {
  constexpr int ES = RouteCfg<ROUTE>::ES;
  constexpr int KCE = RouteCfg<ROUTE>::KCE;
  constexpr int QES = QBF16 ? 2 : 4;
  const int i0 = j * IT;
  if (c == 0) {
    if (a.async_bi) {
      if (threadIdx.x < IT / 4) {
        const int r = threadIdx.x * 4;
        const int have = min(max(a.I - i0 - r, 0), 4);
        cp_async16(bdst + r, have ? a.bi + i0 + r : a.bi, 4 * have);
      }
    } else if (threadIdx.x < IT) {
      const int r = threadIdx.x;
      bdst[r] = i0 + r < a.I ? __ldg(a.bi + i0 + r) : 0.f;
    }
  }
  if (a.async_q) {   // Q rows a multiple of 16 bytes, Q in the staged type
    const long row_b = (long)a.k * QES;
    const long col_b = (long)c * CHB + (threadIdx.x & 7) * 16;
    const unsigned char* base = static_cast<const unsigned char*>(a.Q);
    const unsigned char* src = base + (long)(i0 + (threadIdx.x >> 3)) * row_b + col_b;
    unsigned char* d = dst + (threadIdx.x >> 3) * ROWS + (threadIdx.x & 7) * 16;
    const bool col_ok = col_b < row_b;
#pragma unroll
    for (int e = 0; e < IT * (CHB / 16) / NT; ++e) {
      const int r = (threadIdx.x >> 3) + e * (NT / 8);
      const bool ok = col_ok && (i0 + r < a.I);
      cp_async16(d + e * (NT / 8) * ROWS, ok ? src + e * (NT / 8) * row_b : base,
                 ok ? 16 : 0);
    }
    return;
  }
  for (int e = threadIdx.x; e < IT * KCE; e += NT) {
    const int r = e / KCE, col = e - r * KCE;
    const int item = i0 + r, d = c * KCE + col;
    float v = 0.f;
    if (item < a.I && d < a.k) {
      if (QBF16)
        v = __bfloat162float(static_cast<const __nv_bfloat16*>(a.Q)[(long)item * a.k + d]);
      else
        v = __ldg(static_cast<const float*>(a.Q) + (long)item * a.k + d);
    }
    if (ES == 2)
      reinterpret_cast<__nv_bfloat16*>(dst + r * ROWS)[col] = __float2bfloat16_rn(v);
    else
      reinterpret_cast<float*>(dst + r * ROWS)[col] = v;
  }
}

// acc[mi][ni][h]: item wi*32 + 8*(2*mi + (h >> 1)) + g, user
// wu*32 + ni*8 + 2*t + (h & 1) -- the mma accumulator layout.
template <int ROUTE>
__device__ __forceinline__ void chunk_products(float (&acc)[2][4][4],
                                               const unsigned char* qs,
                                               const unsigned char* ps,
                                               int pst, int c, int wi, int wu,
                                               int lane) {
  const int g = lane >> 2, t = lane & 3;
  if (ROUTE == R_BF16) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t A[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(A[mi], qs + (wi * 32 + mi * 16 + (lane & 15)) * ROWS
                           + (kk * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t Bq[4];
        ldsm_x4(Bq, ps + (wu * 32 + np * 16 + ((lane >> 4) & 1) * 8 + (lane & 7)) * pst
                        + (c * 64 + kk * 16 + ((lane >> 3) & 1) * 8) * 2);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * np], A[mi], Bq[0], Bq[1]);
          mma_bf16(acc[mi][2 * np + 1], A[mi], Bq[2], Bq[3]);
        }
      }
    }
  } else {   // R_TF32X3
    const float* qf = reinterpret_cast<const float*>(qs);
    const float* pf = reinterpret_cast<const float*>(ps);
    const int pstf = pst / 4, rowf = ROWS / 4;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t Ah[2][4], Al[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* q0 = qf + (wi * 32 + mi * 16 + g) * rowf + kk * 8 + t;
        split_tf32(q0[0], Ah[mi][0], Al[mi][0]);
        split_tf32(q0[8 * rowf], Ah[mi][1], Al[mi][1]);
        split_tf32(q0[4], Ah[mi][2], Al[mi][2]);
        split_tf32(q0[8 * rowf + 4], Ah[mi][3], Al[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float* p0 = pf + (wu * 32 + ni * 8 + g) * pstf + c * 32 + kk * 8 + t;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(p0[0], bh0, bl0);
        split_tf32(p0[4], bh1, bl1);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_tf32(acc[mi][ni], Ah[mi], bl0, bl1);
          mma_tf32(acc[mi][ni], Al[mi], bh0, bh1);
          mma_tf32(acc[mi][ni], Ah[mi], bh0, bh1);
        }
      }
    }
  }
}

// The rated bitmap of tile j for the warp's 8 users.  Each user's next
// rated ids wait in a window of 32 in shared memory (row[wbase ..
// wbase + 32)); rptr is the first not yet consumed.  The ids inside the
// tile are set by shared atomics (a few a tile) and consumed; a window
// used up is refilled from the row, which walks forward only.
__device__ __forceinline__ void build_rated(const Args& a, uint32_t* bits,
                                            int* rptr, int* wbase, int* win,
                                            const int* rcn, int u0, int warp,
                                            int lane, int j) {
  const int lo = j * IT, hi = lo + IT;
#pragma unroll
  for (int ui = 0; ui < 8; ++ui)
    if (lane < 4) bits[(warp * 8 + ui) * 4 + lane] = 0u;
  __syncwarp();
  // the common case, the 8 users in lockstep: one look at each window
  int p[8], wb[8];
#pragma unroll
  for (int ui = 0; ui < 8; ++ui) {
    p[ui] = rptr[warp * 8 + ui];
    wb[ui] = wbase[warp * 8 + ui];
  }
#pragma unroll
  for (int ui = 0; ui < 8; ++ui) {
    const int u = warp * 8 + ui;
    if (p[ui] - wb[ui] == 32) continue;   // used up: below
    const int x = win[u * 32 + lane];
    const bool in = lane >= p[ui] - wb[ui] && x < hi;
    if (in) atomicOr(&bits[u * 4 + ((x - lo) >> 5)], 1u << ((x - lo) & 31));
    p[ui] += __popc(__ballot_sync(0xffffffffu, in));
  }
  // a window used up: refill from the row and look again, until past the
  // tile or the row
#pragma unroll
  for (int ui = 0; ui < 8; ++ui) {
    const int u = warp * 8 + ui;
    while (p[ui] - wb[ui] == 32 && p[ui] < rcn[u]) {
      wb[ui] = p[ui];
      win[u * 32 + lane] = wb[ui] + lane < rcn[u]
          ? __ldg(a.ridx + (long)(u0 + u) * a.L + wb[ui] + lane) : 0x7fffffff;
      __syncwarp();
      const int x = win[u * 32 + lane];
      const bool in = x < hi;
      if (in) atomicOr(&bits[u * 4 + ((x - lo) >> 5)], 1u << ((x - lo) & 31));
      p[ui] += __popc(__ballot_sync(0xffffffffu, in));
    }
  }
  __syncwarp();
  if (lane == 0) {
#pragma unroll
    for (int ui = 0; ui < 8; ++ui) {
      rptr[warp * 8 + ui] = p[ui];
      wbase[warp * 8 + ui] = wb[ui];
    }
  }
}

// User u's rated items in the tile at `lo` as a 128-bit mask (the same
// in every lane), for the warp that owns u: its window's ids below
// lo + IT are consumed, those at or past lo set; a window used up is
// refilled.  Tiles come in ascending order, so the row walks forward.
__device__ __forceinline__ void rated_words(const Args& a, int* rptr, int* wbase,
                                            int* win, const int* rcn, int u0, int u,
                                            int lane, int lo, uint32_t (&w)[4]) {
  const int hi = lo + IT;
  int p = rptr[u], wb = wbase[u];
  for (;;) {
    if (p - wb == 32) {   // the window is used up: the next 32
      if (p >= rcn[u]) break;
      wb = p;
      win[u * 32 + lane] = wb + lane < rcn[u]
          ? __ldg(a.ridx + (long)(u0 + u) * a.L + wb + lane) : 0x7fffffff;
      __syncwarp();
    }
    const int x = win[u * 32 + lane];
    const bool in = lane >= p - wb && x < hi;
    const bool mine = in && x >= lo;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      w[q] |= __reduce_or_sync(0xffffffffu,
                               mine && ((x - lo) >> 5) == q ? 1u << ((x - lo) & 31) : 0u);
    p += __popc(__ballot_sync(0xffffffffu, in));
    if (p - wb < 32) break;
  }
  __syncwarp();
  if (lane == 0) {
    rptr[u] = p;
    wbase[u] = wb;
  }
}

template <int ROUTE, bool QBF16, bool BIGN>
__global__ void __launch_bounds__(NT, BIGN ? 1 : 2) topn_main(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pst = p_stride(a.nkc);
  unsigned char* qs = smem;
  float* bis = reinterpret_cast<float*>(qs + NSTAGE * STAGE);   // NSTAGE x IT
  unsigned char* ps = reinterpret_cast<unsigned char*>(bis + NSTAGE * IT);
  unsigned char* cand = ps + UT * pst;   // BIGN: UT*IT keys; else UT*IT ords + locs
  uint32_t* cand_o = reinterpret_cast<uint32_t*>(cand);
  uint8_t* cand_l = cand + UT * IT * 4;
  u64* keys = reinterpret_cast<u64*>(cand);
  uint32_t* bits = reinterpret_cast<uint32_t*>(cand + UT * IT * (BIGN ? 8 : 5));
  int* cnt = reinterpret_cast<int*>(bits + 2 * UT * (IT / 32));
  float* thr_s = reinterpret_cast<float*>(cnt + UT);
  u64* thr_k = reinterpret_cast<u64*>(thr_s + UT);   // 8-byte aligned: UT even
  int* rptr = reinterpret_cast<int*>(thr_k + UT);
  int* rcn = rptr + UT;
  float* bu_s = reinterpret_cast<float*>(rcn + UT);
  int* wbase = reinterpret_cast<int*>(bu_s + UT);    // rated windows' starts
  int* win = wbase + UT;                            // UT x 32 rated ids
  uint32_t* umask = reinterpret_cast<uint32_t*>(win + UT * 32);   // users with candidates
  u64* run_s = reinterpret_cast<u64*>(umask + 2);   // UT x n, lane r the r-th best

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wi = warp & 3, wu = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x, u0 = blockIdx.y * UT;
  // the split's item tiles: an even share of the ntiles
  const int t0 = (int)((long)split * a.ntiles / a.splits);
  const int t1 = (int)((long)(split + 1) * a.ntiles / a.splits);
  const int n = a.n;
  const float ninf = __int_as_float(0xff800000), pinf = __int_as_float(0x7f800000);
  const uint32_t neg_o = f32_to_ord(NEG) & (a.packed ? ~PACK_MASK : ~0u);   // a rated item

  // P tile, rounded to bf16 for the bf16 route, zero past k and B
  {
    constexpr int ES = RouteCfg<ROUTE>::ES;
    const int kp = a.nkc * RouteCfg<ROUTE>::KCE;
    for (int e = tid; e < UT * kp; e += NT) {
      const int u = e / kp, d = e - u * kp;
      const float v = (u0 + u < a.B && d < a.k) ? a.P[(long)(u0 + u) * a.k + d] : 0.f;
      if (ES == 2)
        reinterpret_cast<__nv_bfloat16*>(ps + u * pst)[d] = __float2bfloat16_rn(v);
      else
        reinterpret_cast<float*>(ps + u * pst)[d] = v;
    }
  }
  if (tid < UT) {
    const bool ok = u0 + tid < a.B;
    cnt[tid] = 0;
    thr_s[tid] = ok ? ninf : pinf;   // -inf: the list is not full; +inf: no user
    thr_k[tid] = 0ull;
    rcn[tid] = ok && a.L > 0 ? min(a.rcnt[u0 + tid], a.L) : 0;
    bu_s[tid] = ok ? a.bu[u0 + tid] : 0.f;
  }
  if (!BIGN)
    for (int e = tid; e < UT * n; e += NT) run_s[e] = 0ull;
  if (tid < 2) umask[tid] = 0u;
  __syncthreads();
  if (a.L > 0) {
    // each warp's 8 users: the first rated id at or past the split, by
    // 32 probes a round (the 8 users in lockstep), then each user's
    // window of the next 32 ids
    const int target = t0 * IT;
    int lo[8], hi[8];
#pragma unroll
    for (int ui = 0; ui < 8; ++ui) {
      lo[ui] = 0;
      hi[ui] = rcn[warp * 8 + ui];
    }
    for (bool more = true; more;) {
      more = false;
#pragma unroll
      for (int ui = 0; ui < 8; ++ui) {
        if (lo[ui] >= hi[ui]) continue;
        const int step = (hi[ui] - lo[ui] + 31) / 32;
        const int pos = lo[ui] + lane * step;
        const int v = pos < hi[ui] ? __ldg(a.ridx + (long)(u0 + warp * 8 + ui) * a.L + pos)
                                   : 0x7fffffff;
        const int below = __popc(__ballot_sync(0xffffffffu, v < target));
        if (below == 0) {
          hi[ui] = lo[ui];
        } else {
          const int nlo = lo[ui] + (below - 1) * step + 1;
          hi[ui] = min(hi[ui], lo[ui] + below * step);
          lo[ui] = nlo;
        }
        more |= lo[ui] < hi[ui];
      }
    }
#pragma unroll
    for (int ui = 0; ui < 8; ++ui) {
      const int u = warp * 8 + ui, p = lo[ui];
      win[u * 32 + lane] = p + lane < rcn[u]
          ? __ldg(a.ridx + (long)(u0 + u) * a.L + p + lane) : 0x7fffffff;
      if (lane == 0) rptr[u] = wbase[u] = p;
    }
    __syncwarp();
    build_rated(a, bits + (t0 & 1) * UT * 4, rptr, wbase, win, rcn, u0, warp, lane, t0);
  }

  // the ring: chunk s of the split is tile t0 + s / nkc, chunk s % nkc;
  // a tile's item biases ride with its chunk 0, in slot (tile - t0) % NSTAGE
  const int S = (t1 - t0) * a.nkc;
  {
    int j = t0, c = 0;
    for (int s = 0; s < NSTAGE - 1; ++s) {
      if (s < S)
        load_chunk<ROUTE, QBF16>(a, qs + s * STAGE, bis + ((j - t0) % NSTAGE) * IT, j, c);
      cp_commit();
      if (++c == a.nkc) { c = 0; ++j; }
    }
  }
  int lj = t0 + (NSTAGE - 1) / a.nkc, lc = (NSTAGE - 1) % a.nkc;  // next load
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[mi][ni][h] = 0.f;
  int j = t0, c = 0;
  for (int s = 0; s < S; ++s) {
    cp_wait<NSTAGE - 2>();
    __syncthreads();
    if (s + NSTAGE - 1 < S)
      load_chunk<ROUTE, QBF16>(a, qs + ((s + NSTAGE - 1) % NSTAGE) * STAGE,
                               bis + ((lj - t0) % NSTAGE) * IT, lj, lc);
    cp_commit();
    if (++lc == a.nkc) { lc = 0; ++lj; }
    if (BIGN && c == 0 && a.L > 0 && j + 1 < t1)
      build_rated(a, bits + ((j + 1) & 1) * UT * 4, rptr, wbase, win, rcn, u0, warp, lane,
                  j + 1);
    chunk_products<ROUTE>(acc, qs + (s % NSTAGE) * STAGE, ps, pst, c, wi, wu, lane);
    if (++c < a.nkc) continue;
    c = 0;

    // ---- epilogue of tile j ----
    const int base = j * IT;
    const uint32_t* tb = bits + (j & 1) * UT * 4;
    const float* bt = bis + ((j - t0) % NSTAGE) * IT;
    const bool fill = j == t0;     // the block's first tile: every score a candidate
    const int nvalid = min(IT, a.I - base);
    float bu_r[4][2];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) bu_r[ni][h] = bu_s[wu * 32 + ni * 8 + 2 * t + h];
    float b_i[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int loc = wi * 32 + 8 * (2 * mi + hi) + g;
        b_i[mi][hi] = loc < nvalid ? bt[loc] : ninf;   // no item: never a candidate
      }
    if (BIGN || fill) {
      // every (user, item) of the tile: its key (BIGN: into the tile's
      // key block, 0 where there is no item or user; else a candidate)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int loc = wi * 32 + 8 * (2 * mi + hi) + g;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int ul = wu * 32 + ni * 8 + 2 * t + h;
              const bool ok = loc < nvalid && u0 + ul < a.B;
              float sc = ((acc[mi][ni][2 * hi + h] + a.mu) + bu_r[ni][h]) + b_i[mi][hi];
              // a warp's 32 items share one word of each user's bitmap
              if (a.L > 0 && ((tb[ul * 4 + wi] >> (loc & 31)) & 1u)) sc = NEG;
              uint32_t o = f32_to_ord(sc);
              if (a.packed) o &= ~PACK_MASK;
              if (BIGN)
                keys[ul * IT + loc] = ok ? make_key(o, base + loc) : 0ull;
              else if (ok)
                cand_o[ul * IT + loc] = o;   // the first tile: slot = item
            }
        }
    }
    if (BIGN) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int h = 0; h < 4; ++h) acc[mi][ni][h] = 0.f;   // the next tile's sums
      __syncthreads();
      bitonic_sort_desc(keys, UT, IT);
      const int m = min(n, IT);
      for (int e = tid; e < UT * m; e += NT) {
        const int u = e / m, r = e - u * m;
        if (u0 + u < a.B)
          a.ws[((long)(u0 + u) * a.ntiles + j) * m + r] = keys[u * IT + r];
      }
      ++j;
      continue;
    }
    bool appended = fill;
    if (fill) {
      if (tid < UT) cnt[tid] = u0 + tid < a.B ? nvalid : 0;
    } else {
      // a score against the user's threshold score; past it the key and
      // the exact compare (a rated item is masked when its user's
      // candidates are merged)
      float thr_r[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) thr_r[ni][h] = thr_s[wu * 32 + ni * 8 + 2 * t + h];
      // each user's best of the thread's 4 items against its threshold;
      // past it, each of the 4
      bool any = false;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float m = ninf;
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int hi = 0; hi < 2; ++hi)
              m = fmaxf(m, ((acc[mi][ni][2 * hi + h] + a.mu) + bu_r[ni][h]) + b_i[mi][hi]);
          any |= m >= thr_r[ni][h];
        }
      if (any) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                float sc = ((acc[mi][ni][2 * hi + h] + a.mu) + bu_r[ni][h]) + b_i[mi][hi];
                if (!(sc >= thr_r[ni][h])) continue;
                const int loc = wi * 32 + 8 * (2 * mi + hi) + g;
                const int ul = wu * 32 + ni * 8 + 2 * t + h;
                uint32_t o = f32_to_ord(sc);
                if (a.packed) o &= ~PACK_MASK;
                if (make_key(o, base + loc) <= thr_k[ul]) continue;
                const int pos = atomicAdd(&cnt[ul], 1);
                cand_o[ul * IT + pos] = o;
                cand_l[ul * IT + pos] = (uint8_t)loc;
                if (pos == 0) atomicOr(&umask[ul >> 5], 1u << (ul & 31));
                appended = true;
              }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int h = 0; h < 4; ++h) acc[mi][ni][h] = 0.f;   // the next tile's sums
    if (__syncthreads_or(appended)) {
      // each warp takes its 8 users' candidates into their running lists
      // (in shared memory; lane r holds the r-th best): the first tile's,
      // every item, by rounds of warp max; later tiles' few by insertion
      if (fill) {
        fill_lists<0>(run_s, cnt, cand_o, base, n, warp, lane);
        fill_lists<4>(run_s, cnt, cand_o, base, n, warp, lane);
        __syncwarp();
      }
      // the warp's users with candidates (the first tile: all)
      uint32_t mine = fill ? 0xffu : (umask[warp >> 2] >> ((warp & 3) * 8)) & 0xffu;
      while (mine) {
        const int u = warp * 8 + __ffs(mine) - 1;
        mine &= mine - 1;
        const int cu = cnt[u];
        if (cu == 0) continue;
        u64 run = lane < n ? run_s[u * n + lane] : 0ull;
        u64 thr = __shfl_sync(0xffffffffu, run, n - 1);
        if (!fill) {
          uint32_t rw[4] = {0u, 0u, 0u, 0u};   // the user's rated items of the tile
          if (a.L > 0) rated_words(a, rptr, wbase, win, rcn, u0, u, lane, base, rw);
          for (int b0 = 0; b0 < cu; b0 += 32) {
            const int e = b0 + lane;
            u64 key = 0ull;
            if (e < cu) {
              const int loc = cand_l[u * IT + e];
              const uint32_t word = loc < 64 ? (loc < 32 ? rw[0] : rw[1])
                                             : (loc < 96 ? rw[2] : rw[3]);
              key = make_key((word >> (loc & 31)) & 1u ? neg_o : cand_o[u * IT + e],
                             base + loc);
            }
            insert_batch(run, thr, key, n, lane);
          }
          if (lane < n) run_s[u * n + lane] = run;
        }
        if (lane == 0) {
          cnt[u] = 0;
          thr_k[u] = thr;
          thr_s[u] = thr ? ord_to_f32(static_cast<uint32_t>(thr >> 32)) : ninf;
        }
      }
      if (lane == 0) atomicAnd(&umask[warp >> 2], ~(0xffu << ((warp & 3) * 8)));
    }
    ++j;
  }
  if (BIGN) return;

  // the split's n best of each of its users
  __syncthreads();
  for (int e = tid; e < UT * n; e += NT) {
    const int u = u0 + e / n, r = e - (e / n) * n;
    if (u >= a.B) continue;
    const u64 key = run_s[e];
    if (a.splits == 1) {
      a.out_idx[(long)u * n + r] = static_cast<int>(~static_cast<uint32_t>(key));
      a.out_s[(long)u * n + r] = ord_to_f32(static_cast<uint32_t>(key >> 32));
    } else {
      a.ws[((long)u * a.splits + split) * n + r] = key;
    }
  }
}

// Join the splits' lists (n keys each, 0 = empty) of each user: a warp
// per user, the running list in its lanes.
__global__ void __launch_bounds__(NT) topn_join(const u64* __restrict__ ws,
                                                int B, int splits, int n,
                                                int* __restrict__ out_idx,
                                                float* __restrict__ out_s) {
  const int lane = threadIdx.x & 31;
  const int u = blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  if (u >= B) return;
  const u64* src = ws + (long)u * splits * n;
  const int total = splits * n;
  // the largest split's n-th key bounds the n-th best from below: only
  // keys at or above it are taken
  u64 lim = 0ull;
  for (int sp = lane; sp < splits; sp += 32) {
    const u64 x = src[sp * n + n - 1];
    lim = x > lim ? x : lim;
  }
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    const u64 y = __shfl_xor_sync(0xffffffffu, lim, j);
    lim = y > lim ? y : lim;
  }
  const u64 floor_k = lim ? lim - 1 : 0ull;
  u64 run = 0ull, thr = floor_k;
#pragma unroll 4
  for (int b0 = 0; b0 < total; b0 += 32) {
    const u64 key = b0 + lane < total ? src[b0 + lane] : 0ull;
    insert_batch(run, thr, key, n, lane);
    thr = thr > floor_k ? thr : floor_k;
  }
  if (lane < n) {
    out_idx[(long)u * n + lane] = static_cast<int>(~static_cast<uint32_t>(run));
    out_s[(long)u * n + lane] = ord_to_f32(static_cast<uint32_t>(run >> 32));
  }
}

// n > RUN_MAX: one block per user sorts its tiles' lists (ntiles * m
// keys) in rounds of up to MERGE_KEYS keys, the best np (n rounded up
// to a power of two) kept at the front between rounds.
__global__ void __launch_bounds__(NT) topn_sort_merge(const u64* __restrict__ ws,
                                                      int total, int n,
                                                      int* __restrict__ out_idx,
                                                      float* __restrict__ out_s) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* keys = reinterpret_cast<u64*>(smem);
  const int u = blockIdx.x;
  const u64* src = ws + (long)u * total;
  int np = 1;
  while (np < n) np <<= 1;
  for (int e = threadIdx.x; e < np; e += NT) keys[e] = 0ull;
  for (int pos = 0; pos < total;) {
    const int take = min(total - pos, MERGE_KEYS - np);
    int N = 1;
    while (N < np + take) N <<= 1;
    __syncthreads();
    for (int e = threadIdx.x; e < N - np; e += NT)
      keys[np + e] = e < take ? src[pos + e] : 0ull;
    __syncthreads();
    bitonic_sort_desc(keys, 1, N);
    pos += take;
  }
  for (int r = threadIdx.x; r < n; r += NT) {
    out_idx[(long)u * n + r] = static_cast<int>(~static_cast<uint32_t>(keys[r]));
    out_s[(long)u * n + r] = ord_to_f32(static_cast<uint32_t>(keys[r] >> 32));
  }
}

// Shared memory above 48 KB is set once per kernel and device, not per
// call.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, int* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (done[dev] >= (int)bytes)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = (int)bytes;
  return err;
}

template <int ROUTE, bool QBF16, bool BIGN>
cudaError_t launch_main(const Args& a, cudaStream_t st) {
  static int done[64];
  const size_t smem = main_smem<BIGN>(a.nkc, a.n);
  cudaError_t err = allow_smem(topn_main<ROUTE, QBF16, BIGN>, smem, done);
  if (err != cudaSuccess) return err;
  topn_main<ROUTE, QBF16, BIGN>
      <<<dim3(a.splits, (a.B + UT - 1) / UT), NT, smem, st>>>(a);
  return cudaGetLastError();
}

template <int ROUTE, bool QBF16, bool BIGN>
int occupancy(int nkc, int n) {
  static int done[64];
  const size_t smem = main_smem<BIGN>(nkc, n);
  if (allow_smem(topn_main<ROUTE, QBF16, BIGN>, smem, done) != cudaSuccess) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, topn_main<ROUTE, QBF16, BIGN>, NT, smem) != cudaSuccess)
    return -1;
  return blocks;
}

template <int ROUTE, bool QBF16>
cudaError_t dispatch_big(const Args& a, bool bign, cudaStream_t st) {
  return bign ? launch_main<ROUTE, QBF16, true>(a, st)
              : launch_main<ROUTE, QBF16, false>(a, st);
}

int route_of(int bf16_dot) { return bf16_dot ? R_BF16 : R_TF32X3; }

int chunks(int route, int k) {
  const int kce = route == R_BF16 ? CHB / 2 : CHB / 4;
  return (k + kce - 1) / kce;
}

}  // namespace

extern "C" {

const char* topn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Main-kernel blocks one SM holds for this mode and rank, or -1.
int topn_blocks_per_sm(int q_bf16, int k, int n, int bf16_dot) {
  const int route = route_of(bf16_dot);
  const int nkc = chunks(route, k);
  const bool bign = n > RUN_MAX;
  if (route == R_BF16 && q_bf16)
    return bign ? occupancy<R_BF16, true, true>(nkc, n)
                : occupancy<R_BF16, true, false>(nkc, n);
  if (route == R_BF16)
    return bign ? occupancy<R_BF16, false, true>(nkc, n)
                : occupancy<R_BF16, false, false>(nkc, n);
  return bign ? occupancy<R_TF32X3, false, true>(nkc, n)
              : occupancy<R_TF32X3, false, false>(nkc, n);
}

// Returns 0 or the CUDA error of the first launch that failed.  The
// caller checks shapes (1 <= n <= min(1024, I), k <= 256, B <= 65535,
// each rated row's first rcnt[u] ids ascending and in [0, I)) and plans
// the grid: `splits` item ranges (an even share of the tiles each), and `ws` u64 keys
// of workspace (B * splits * n for n <= RUN_MAX and splits > 1,
// B * ntiles * min(n, IT) for n > RUN_MAX, else none).
int topn_launch(const float* P, const void* Q, int q_bf16, const float* bu,
                const float* bi, float mu, const int* ridx, const int* rcnt,
                int L, int B, int I, int k, int n, int bf16_dot, int packed,
                int splits, u64* ws, int* out_idx,
                float* out_s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int route = route_of(bf16_dot);
  Args a;
  a.P = P; a.Q = Q; a.bu = bu; a.bi = bi; a.ridx = ridx; a.rcnt = rcnt;
  a.ws = ws; a.out_idx = out_idx; a.out_s = out_s; a.mu = mu;
  a.L = L; a.B = B; a.I = I; a.k = k; a.n = n;
  a.nkc = chunks(route, k);
  a.ntiles = (I + IT - 1) / IT;
  a.splits = splits;
  a.packed = packed;
  const int qes = q_bf16 ? 2 : 4;
  const bool same_type = (route == R_BF16) == (q_bf16 != 0);
  a.async_q = same_type && ((long)k * qes) % 16 == 0
              && reinterpret_cast<uintptr_t>(Q) % 16 == 0;
  a.async_bi = reinterpret_cast<uintptr_t>(bi) % 16 == 0;
  const bool bign = n > RUN_MAX;
  cudaError_t err;
  if (route == R_BF16)
    err = q_bf16 ? dispatch_big<R_BF16, true>(a, bign, st)
                 : dispatch_big<R_BF16, false>(a, bign, st);
  else
    err = dispatch_big<R_TF32X3, false>(a, bign, st);
  if (err != cudaSuccess) return (int)err;
  if (bign) {
    static int done[64];
    const size_t smem = (size_t)MERGE_KEYS * sizeof(u64);
    err = allow_smem(topn_sort_merge, smem, done);
    if (err != cudaSuccess) return (int)err;
    topn_sort_merge<<<B, NT, smem, st>>>(ws, a.ntiles * (n < IT ? n : IT), n,
                                         out_idx, out_s);
    return (int)cudaGetLastError();
  }
  if (splits > 1) {
    topn_join<<<(B + NT / 32 - 1) / (NT / 32), NT, 0, st>>>(ws, B, splits, n,
                                                            out_idx, out_s);
    return (int)cudaGetLastError();
  }
  return 0;
}

}  // extern "C"

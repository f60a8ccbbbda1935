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
// Modes: exact (f32 operands, f32 accumulation) and the two fast opt-ins
// of the TPU kernel, which the caller may set separately:
//   bf16_dot  P and Q rounded to bf16, products accumulated in f32; Q may
//             arrive already stored as bf16 (half the bytes streamed);
//   packed    every score quantized toward -inf by clearing the low 12
//             bits of its monotone int32 key, as the TPU kernel's
//             id-in-mantissa block top-n does.
//
// Design.  Two passes, both written here.
//   1. topn_score_chunks: one block per (16-user tile, 512-item chunk).
//      The tile's P rows sit in shared memory; each thread owns 2 items
//      and accumulates their 16 dot products with FMAs on the CUDA cores,
//      reading its Q rows straight from global memory (L2/L1).  The
//      rated ids that fall in the chunk are found by two binary searches
//      per user (rows arrive sorted) and set in a shared-memory bitmap,
//      so masking is one bit test per score.  Each score becomes a 64-bit
//      key (monotone score bits << 32 | ~id), and the chunk's best
//      m = min(n, 512) keys per user go to a workspace in order: for
//      m <= 32 by m rounds of warp extract-max (a warp per user), above
//      that by a bitonic sort of the chunk.
//   2. topn_merge: the sorted per-chunk lists of a user are merged in
//      groups of up to 8192 keys (one bitonic sort in shared memory per
//      group) until one list is left; the last round decodes ids and
//      scores.
// Items past I are never read: a bound check gives them key (NEG, id),
// which sorts after every real item.
//
// What bounds it on an H100.  At the bench shape (B=1024, I=360,000,
// k=64) one call is 2*B*I*k = 47 GFLOP of f32 FMA on the CUDA cores
// (67 TFLOP/s peak, about 0.7 ms) and streams Q from L2 once per user
// tile (B/16 * I*k*4 bytes = 5.9 GB).  At the serving shape (B=256,
// I=10,677) it is 0.35 GFLOP, and launch and host overheads dominate.
// Tensor cores (mma/wgmma), TMA and a cheaper selection than a full sort
// are left for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC.  Plain C interface, loaded by ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

typedef unsigned long long u64;

constexpr int NT = 256;            // threads per block, both kernels
constexpr int TU = 16;             // users per score block
constexpr int CH = 512;            // items per score block
constexpr int IPT = CH / NT;       // items per thread
constexpr int MERGE_KEYS = 8192;   // keys one merge block sorts
constexpr int WARP_SELECT_MAX = 32;  // per-chunk lists this short skip the sort
constexpr float NEG = -3.0e38f;
constexpr uint32_t PACK_MASK = 0xFFFu;

__device__ __forceinline__ uint32_t f32_to_ord(float s) {
  const uint32_t b = __float_as_uint(s);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float ord_to_f32(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}

__device__ __forceinline__ u64 make_key(float s, int id, bool packed) {
  uint32_t u = f32_to_ord(s);
  if (packed) u &= ~PACK_MASK;
  return (static_cast<u64>(u) << 32) | static_cast<u64>(~static_cast<uint32_t>(id));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

template <bool QBF16>
__device__ __forceinline__ float4 load_q4(const void* Q, int item, int k, int d,
                                          bool round) {
  if (QBF16) {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(Q) + (size_t)item * k + d;
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(q));
    __nv_bfloat162 lo, hi;
    memcpy(&lo, &raw.x, 4);
    memcpy(&hi, &raw.y, 4);
    const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
    return make_float4(a.x, a.y, b.x, b.y);
  }
  const float* q = static_cast<const float*>(Q) + (size_t)item * k + d;
  float4 v = __ldg(reinterpret_cast<const float4*>(q));
  if (round) {
    v.x = round_bf16(v.x);
    v.y = round_bf16(v.y);
    v.z = round_bf16(v.z);
    v.w = round_bf16(v.w);
  }
  return v;
}

template <bool QBF16>
__device__ __forceinline__ float load_q1(const void* Q, int item, int k, int d,
                                         bool round) {
  if (QBF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(Q)[(size_t)item * k + d]);
  const float v = __ldg(static_cast<const float*>(Q) + (size_t)item * k + d);
  return round ? round_bf16(v) : v;
}

template <bool QBF16, bool VEC>
__global__ void __launch_bounds__(NT)
topn_score_chunks(const float* __restrict__ P, const void* __restrict__ Q,
                  const float* __restrict__ bu, const float* __restrict__ bi,
                  float mu, const int* __restrict__ ridx,
                  const int* __restrict__ rcnt, int L, int B, int I, int k,
                  int m, int bf16_dot, int packed, int nchunks,
                  u64* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* keys = reinterpret_cast<u64*>(smem);                        // TU*CH
  float* Ps = reinterpret_cast<float*>(keys + TU * CH);            // TU*k
  uint32_t* rated = reinterpret_cast<uint32_t*>(Ps + TU * k);      // TU*CH/32

  const int chunk = blockIdx.x;
  const int u0 = blockIdx.y * TU;
  const int i0 = chunk * CH;
  const int tid = threadIdx.x;

  for (int e = tid; e < TU * k; e += NT) {
    const int u = e / k;
    float v = (u0 + u < B) ? P[(size_t)(u0 + u) * k + (e - u * k)] : 0.f;
    Ps[e] = bf16_dot ? round_bf16(v) : v;
  }
  for (int e = tid; e < TU * CH / 32; e += NT) rated[e] = 0u;
  __syncthreads();

  if (L > 0) {
    // one warp per user: lanes 0 and 1 binary-search the chunk's bounds
    // in the sorted rated row, then the warp sets the bits between them
    const int warp = tid >> 5, lane = tid & 31;
    for (int u = warp; u < TU && u0 + u < B; u += NT / 32) {
      const int* row = ridx + (size_t)(u0 + u) * L;
      const int cnt = min(rcnt[u0 + u], L);
      int pos = 0;
      if (lane < 2) {
        const int target = i0 + lane * CH;
        int lo = 0, hi = cnt;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (row[mid] < target) lo = mid + 1; else hi = mid;
        }
        pos = lo;
      }
      const int first = __shfl_sync(0xffffffffu, pos, 0);
      const int last = __shfl_sync(0xffffffffu, pos, 1);
      for (int p = first + lane; p < last; p += 32) {
        const int loc = row[p] - i0;
        atomicOr(&rated[u * (CH / 32) + (loc >> 5)], 1u << (loc & 31));
      }
    }
  }

  int item[IPT];
  bool ok[IPT];
  float acc[TU][IPT];
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    item[j] = i0 + tid + j * NT;
    ok[j] = item[j] < I;
#pragma unroll
    for (int u = 0; u < TU; ++u) acc[u][j] = 0.f;
  }
  const bool round = bf16_dot != 0;
  if (VEC) {
    for (int d = 0; d < k; d += 4) {
      float4 q[IPT];
#pragma unroll
      for (int j = 0; j < IPT; ++j)
        q[j] = ok[j] ? load_q4<QBF16>(Q, item[j], k, d, round)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < TU; ++u) {
        const float4 p = *reinterpret_cast<const float4*>(Ps + u * k + d);
#pragma unroll
        for (int j = 0; j < IPT; ++j) {
          float a = acc[u][j];
          a = fmaf(p.x, q[j].x, a);
          a = fmaf(p.y, q[j].y, a);
          a = fmaf(p.z, q[j].z, a);
          a = fmaf(p.w, q[j].w, a);
          acc[u][j] = a;
        }
      }
    }
  } else {
    for (int d = 0; d < k; ++d) {
      float q[IPT];
#pragma unroll
      for (int j = 0; j < IPT; ++j)
        q[j] = ok[j] ? load_q1<QBF16>(Q, item[j], k, d, round) : 0.f;
#pragma unroll
      for (int u = 0; u < TU; ++u) {
        const float p = Ps[u * k + d];
#pragma unroll
        for (int j = 0; j < IPT; ++j) acc[u][j] = fmaf(p, q[j], acc[u][j]);
      }
    }
  }
  __syncthreads();   // the bitmap is complete before it is read

#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    const int loc = tid + j * NT;
    const float b_i = ok[j] ? bi[item[j]] : 0.f;
#pragma unroll
    for (int u = 0; u < TU; ++u) {
      float s = NEG;
      if (ok[j] && u0 + u < B) {
        const bool hit = (rated[u * (CH / 32) + (loc >> 5)] >> (loc & 31)) & 1u;
        s = hit ? NEG : ((acc[u][j] + mu) + bu[u0 + u]) + b_i;
      }
      keys[u * CH + loc] = make_key(s, item[j], packed != 0);
    }
  }
  __syncthreads();

  if (m <= WARP_SELECT_MAX) {
    // small n: m rounds of warp extract-max per user, a warp per user,
    // each lane holding CH/32 of the user's keys (keys are unique, so
    // exactly one lane owns each round's winner)
    const int warp = tid >> 5, lane = tid & 31;
    for (int u = warp; u < TU && u0 + u < B; u += NT / 32) {
      u64 k[CH / 32];
      u64 best = 0ull;
#pragma unroll
      for (int s = 0; s < CH / 32; ++s) {
        k[s] = keys[u * CH + s * 32 + lane];
        best = k[s] > best ? k[s] : best;
      }
      u64* dst = out + ((size_t)(u0 + u) * nchunks + chunk) * m;
      for (int t = 0; t < m; ++t) {
        u64 w = best;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const u64 o = __shfl_xor_sync(0xffffffffu, w, off);
          w = o > w ? o : w;
        }
        if (lane == 0) dst[t] = w;
        if (best == w) {
          best = 0ull;
#pragma unroll
          for (int s = 0; s < CH / 32; ++s) {
            if (k[s] == w) k[s] = 0ull;
            best = k[s] > best ? k[s] : best;
          }
        }
      }
    }
    return;
  }
  bitonic_sort_desc(keys, TU, CH);
  for (int e = tid; e < TU * m; e += NT) {
    const int u = e / m;
    if (u0 + u < B)
      out[((size_t)(u0 + u) * nchunks + chunk) * m + (e - u * m)] = keys[u * CH + (e - u * m)];
  }
}

// Merge groups of G sorted lists (m keys each) per user into one sorted
// list of m_out keys; on the last round (out_idx set) decode the top n.
__global__ void __launch_bounds__(NT)
topn_merge(const u64* __restrict__ in, int nlists, int m, int G, int m_out,
           u64* __restrict__ out, int n, int* __restrict__ out_idx,
           float* __restrict__ out_s) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* keys = reinterpret_cast<u64*>(smem);
  const int user = blockIdx.y, group = blockIdx.x;
  const int l0 = group * G;
  const int total = min(G, nlists - l0) * m;
  int N = 1;
  while (N < total) N <<= 1;
  const u64* src = in + ((size_t)user * nlists + l0) * m;
  for (int e = threadIdx.x; e < N; e += NT) keys[e] = e < total ? src[e] : 0ull;
  __syncthreads();
  bitonic_sort_desc(keys, 1, N);
  if (out_idx != nullptr) {
    for (int t = threadIdx.x; t < n; t += NT) {
      const u64 key = keys[t];
      out_idx[(size_t)user * n + t] = static_cast<int>(~static_cast<uint32_t>(key));
      out_s[(size_t)user * n + t] = ord_to_f32(static_cast<uint32_t>(key >> 32));
    }
  } else {
    u64* dst = out + ((size_t)user * gridDim.x + group) * m_out;
    for (int t = threadIdx.x; t < m_out; t += NT) dst[t] = t < N ? keys[t] : 0ull;
  }
}

template <bool QBF16, bool VEC>
cudaError_t launch_scores(dim3 grid, size_t smem, cudaStream_t st,
                          const float* P, const void* Q, const float* bu,
                          const float* bi, float mu, const int* ridx,
                          const int* rcnt, int L, int B, int I, int k, int m,
                          int bf16_dot, int packed, int nchunks, u64* out) {
  cudaError_t err = cudaFuncSetAttribute(
      topn_score_chunks<QBF16, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  topn_score_chunks<QBF16, VEC><<<grid, NT, smem, st>>>(
      P, Q, bu, bi, mu, ridx, rcnt, L, B, I, k, m, bf16_dot, packed, nchunks,
      out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// u64 keys each of the two workspace buffers must hold.
long long topn_workspace(int B, int I, int n) {
  const long long nchunks = (I + CH - 1) / CH;
  const long long m = n < CH ? n : CH;
  return (long long)B * (nchunks * m + MERGE_KEYS);
}

const char* topn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns 0 or the CUDA error of the first launch that failed.  The
// caller checks shapes: 1 <= n <= min(1024, I), k <= 256, B <= 65535,
// each rated row's first rcnt[u] ids ascending and in [0, I).
int topn_launch(const float* P, const void* Q, int q_bf16, const float* bu,
                const float* bi, float mu, const int* ridx, const int* rcnt,
                int L, int B, int I, int k, int n, int bf16_dot, int packed,
                u64* ws_a, u64* ws_b, int* out_idx, float* out_s,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nchunks = (I + CH - 1) / CH;
  const int m0 = n < CH ? n : CH;
  const size_t smem = (size_t)TU * CH * sizeof(u64) + (size_t)TU * k * sizeof(float)
                      + (size_t)TU * (CH / 32) * sizeof(uint32_t);
  const bool vec = (k % 4 == 0)
                   && (reinterpret_cast<uintptr_t>(Q) % (q_bf16 ? 8 : 16) == 0);
  const dim3 grid(nchunks, (B + TU - 1) / TU);
  cudaError_t err;
  if (q_bf16)
    err = vec ? launch_scores<true, true>(grid, smem, st, P, Q, bu, bi, mu, ridx, rcnt, L, B, I, k, m0, bf16_dot, packed, nchunks, ws_a)
              : launch_scores<true, false>(grid, smem, st, P, Q, bu, bi, mu, ridx, rcnt, L, B, I, k, m0, bf16_dot, packed, nchunks, ws_a);
  else
    err = vec ? launch_scores<false, true>(grid, smem, st, P, Q, bu, bi, mu, ridx, rcnt, L, B, I, k, m0, bf16_dot, packed, nchunks, ws_a)
              : launch_scores<false, false>(grid, smem, st, P, Q, bu, bi, mu, ridx, rcnt, L, B, I, k, m0, bf16_dot, packed, nchunks, ws_a);
  if (err != cudaSuccess) return (int)err;

  const size_t smem2 = (size_t)MERGE_KEYS * sizeof(u64);
  err = cudaFuncSetAttribute(topn_merge, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return (int)err;
  const u64* in = ws_a;
  u64* out = ws_b;
  int lists = nchunks, m = m0;
  for (;;) {
    const int G = MERGE_KEYS / m;
    const int groups = (lists + G - 1) / G;
    if (groups == 1) {
      topn_merge<<<dim3(1, B), NT, smem2, st>>>(in, lists, m, G, n, nullptr, n,
                                                out_idx, out_s);
      return (int)cudaGetLastError();
    }
    const int m_out = n < G * m ? n : G * m;
    topn_merge<<<dim3(groups, B), NT, smem2, st>>>(in, lists, m, G, m_out, out,
                                                   n, nullptr, nullptr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    u64* next_out = (in == ws_a) ? ws_a : ws_b;
    in = out;
    out = next_out;
    lists = groups;
    m = m_out;
  }
}

}  // extern "C"

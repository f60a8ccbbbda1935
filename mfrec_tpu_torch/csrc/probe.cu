// P2 on Hopper: the deletion-probe variants of the sorted-window batch
// step, for timing K1's sweep part by part.
//
// Replaces the Pallas TPU kernels of tools/kernel_probe.py (run_one,
// bodies make_kernel and make_kernel_2d).  Each variant is K1's step
// (csrc/half_pass.cu: bf16 window read, row-mean update with the
// regularization identity and the alive mask, count built at t = 0) with
// one part deleted or re-rounded.  The probe's 1D/2D, ohT and ones-matvec
// distinctions are TPU layout matters; on this card the seventeen variant
// names compute eleven functions (V_* below):
//
//   V_F32DOT     full, dot_mxu, all2d_sumk(_ohT)   dot = sum fu*ff (f32)
//   V_B16DOT     dot_mxu_b16, all2d(_ohT)          dot = sum bf16(fu*ff)
//   V_B16CHAIN   bf16_chain, all2d_bf16            ff := bf16(ff); dot as
//                                                  V_B16DOT; operand
//                                                  bf16(bf16(err)*ff)
//   V_NOFU       no_fu                             fu := ff, f32 dot
//   V_NOFU_B16   all2d_no_fu                       fu := ff, bf16 products
//   V_NOELEM     no_elem                           err := r (no dot, no
//                                                  mask, no clip)
//   V_NOELEM_2D  all2d_no_elem                     err := r + 1e-6*dot
//   V_NODOT      all2d_no_dot                      dot := bf16(fu0*ff0)
//   V_NOPROD     all2d_no_prod                     dot := fu0
//   V_NOACC      no_acc                            f32 dot, no aggregation
//   V_NOACC_2D   all2d_no_acc                      bf16 products, no
//                                                  aggregation
//
// and otherwise err = (r - clamp(mu + dot, 1, 5))*m, the aggregated
// operand bf16(err*ff) summed per row in f32, and
// win += lrv*(acc/max(cnt,1) - regv*win*[cnt>0]) with cnt = sum bf16(m).
//
// The no_acc variants delete the per-rating operand and its sum (the
// warps' sums of zeros and the per-sweep barrier stay): the window only
// shrinks by its regularization.  The Pallas bodies add instead a
// 1e-6-scaled term of one entry per chunk, there only so that the
// compiler keeps the dot; at the probe's shape it is ~1e-9 a sweep and
// moves no window entry by more than 2e-7 in ten sweeps, a few f32 steps
// of an entry of 0.3 (tests/test_torch_probe.py).  Here a per-row sum of
// every sweep's errors, written to ``live``, keeps the dot, and the plain
// version's term is left out (ops/probe_kernel.py).
//
// The fixed rows are f32, as the probe passes them, or bf16 (K1's
// storage) for V_F32DOT: "full" with K1's reads, to tell K1's bf16 reads
// from its runtime options.
//
// Design: K1's per-row chain, so that each variant's time differs from
// "full" by a deletion from K1's own code.  One launch runs G independent
// problems (a window of W rows and a batch of B ratings each) for n_rep
// chained calls of T sweeps (the probe's chain: each call's window feeds
// the next).  One block per window row, 8 warps, the row in registers,
// lanes on columns, U = 4 ratings per warp step, a butterfly shuffle dot
// and a fixed-order shared-memory sum over the warps per sweep, as K1.
// The row's entries (any kl order, masked entries included: the no_elem
// variants aggregate them) come from a table the wrapper builds.
//
// What bounds it on an H100: as K1, operations (about 4k FLOP per rating
// and sweep for V_F32DOT); at the probe's shape (128 rows of ~128 ratings)
// 128 blocks on 132 SMs, so a sweep is one block's latency.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC.  Plain C interface, loaded by ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;              // warps per block
constexpr int U = 4;               // ratings a warp takes per step
constexpr int MAX_KJ = 4;          // k <= 128

enum Variant {
  V_F32DOT = 0, V_B16DOT, V_B16CHAIN, V_NOFU, V_NOFU_B16, V_NOELEM,
  V_NOELEM_2D, V_NODOT, V_NOPROD, V_NOACC, V_NOACC_2D, N_VARIANTS
};

struct Params {
  float* out;                      // [G*W, k] f32 windows, in place
  const void* ff;                  // [G*B, k] fixed rows, f32 or bf16
  const float* r;                  // [G*B]
  const float* m;                  // [G*B]
  const int* seg_ptr;              // [G*W + 1] row x's entries are
  const int* ent;                  // ent[seg_ptr[x]:seg_ptr[x+1]]
  const float* lrv;                // [k]
  const float* regv;               // [k]
  float mu;
  int k, T, n_rep;
  float* sse_rows;                 // [G*W]
  float* live;                     // [G*W] the no_acc variants' error sums
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int KJ, int V, bool FF16>
__device__ __forceinline__ void load_ff(const Params& p, int e, int lane,
                                        float (&ff)[KJ]) {
  const size_t base = static_cast<size_t>(e) * p.k;
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    const int c = lane + 32 * j;
    float v = 0.f;
    if (c < p.k) {
      v = FF16 ? __bfloat162float(
                     static_cast<const __nv_bfloat16*>(p.ff)[base + c])
               : static_cast<const float*>(p.ff)[base + c];
    }
    ff[j] = V == V_B16CHAIN ? bf16_round(v) : v;
  }
}

// the prediction's dot of one rating, identical in every lane
template <int KJ, int V>
__device__ __forceinline__ float dot_of(const float (&fu)[KJ],
                                        const float (&ff)[KJ]) {
  if (V == V_NODOT)
    return __shfl_sync(0xffffffffu, bf16_round(__fmul_rn(fu[0], ff[0])), 0);
  if (V == V_NOPROD) return __shfl_sync(0xffffffffu, fu[0], 0);
  float d = 0.f;
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    if (V == V_F32DOT || V == V_NOACC) {
      d += fu[j] * ff[j];
    } else if (V == V_NOFU) {
      d += ff[j] * ff[j];
    } else if (V == V_NOFU_B16) {
      d += bf16_round(__fmul_rn(ff[j], ff[j]));
    } else {             // V_B16DOT, V_B16CHAIN, V_NOELEM_2D, V_NOACC_2D
      d += bf16_round(__fmul_rn(fu[j], ff[j]));
    }
  }
  return warp_sum(d);
}

template <int V>
__device__ __forceinline__ float err_of(const Params& p, float dot, float r,
                                        float m) {
  if (V == V_NOELEM) return r;
  if (V == V_NOELEM_2D) return __fadd_rn(r, __fmul_rn(dot, 1e-6f));
  const float pred = fminf(fmaxf(p.mu + dot, 1.f), 5.f);
  return (r - pred) * m;
}

// one window row: its entries, n_rep calls x T sweeps, in registers
template <int KJ, int V, bool FF16>
__global__ void __launch_bounds__(NW * 32) probe_rows(const Params p) {
  constexpr bool NOACC = V == V_NOACC || V == V_NOACC_2D;
  __shared__ float red[2][NW][KJ * 32];
  __shared__ float red_cnt[2][NW];
  __shared__ float sum_w[2][NW];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x = blockIdx.x;
  float* wrow = p.out + static_cast<size_t>(x) * p.k;
  float win[KJ], lrv[KJ], regv[KJ];
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    const int c = lane + 32 * j;
    const bool on = c < p.k;
    win[j] = on ? wrow[c] : 0.f;
    lrv[j] = on ? p.lrv[c] : 0.f;
    regv[j] = on ? p.regv[c] : 0.f;
  }
  const int e0 = p.seg_ptr[x];
  const int e1 = p.seg_ptr[x + 1];
  float sse = 0.f, live = 0.f, alive = 0.f, den = 1.f;
  int buf = 0;
  for (int rep = 0; rep < p.n_rep; ++rep) {
    for (int t = 0; t < p.T; ++t) {
      float fu[KJ], acc[KJ];
      float cnt = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        fu[j] = bf16_round(win[j]);
        acc[j] = 0.f;
      }
      for (int base = e0 + warp * U; base < e1; base += NW * U) {
        float ff[U][KJ], r[U], m[U], dot[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = base + u;
          const bool ok = i < e1;
          // a slot past the row's end adds exact zeros (r = m = ff = 0)
          const int e = ok ? p.ent[i] : 0;
          r[u] = ok ? p.r[e] : 0.f;
          m[u] = ok ? p.m[e] : 0.f;
          if (ok) {
            load_ff<KJ, V, FF16>(p, e, lane, ff[u]);
          } else {
#pragma unroll
            for (int j = 0; j < KJ; ++j) ff[u][j] = 0.f;
          }
        }
        if (V != V_NOELEM) {
#pragma unroll
          for (int u = 0; u < U; ++u) dot[u] = dot_of<KJ, V>(fu, ff[u]);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float err = err_of<V>(p, V == V_NOELEM ? 0.f : dot[u], r[u],
                                      m[u]);
          if (t == 0) {
            sse += err * err;
            cnt += bf16_round(m[u]);
          }
          if (NOACC) {
            live += err;
          } else {
            const float e16 = V == V_B16CHAIN ? bf16_round(err) : err;
#pragma unroll
            for (int j = 0; j < KJ; ++j)
              acc[j] += bf16_round(__fmul_rn(e16, ff[u][j]));
          }
        }
      }
#pragma unroll
      for (int j = 0; j < KJ; ++j) red[buf][warp][lane + 32 * j] = acc[j];
      if (t == 0 && lane == 0) red_cnt[buf][warp] = cnt;
      __syncthreads();
      if (t == 0) {
        float c = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) c += red_cnt[buf][w];
        alive = c > 0.f ? 1.f : 0.f;
        den = fmaxf(c, 1.f);
      }
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        float tot = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) tot += red[buf][w][lane + 32 * j];
        const float reg = regv[j] * win[j];
        win[j] = win[j] + lrv[j] * (__fdiv_rn(tot, den) - reg * alive);
      }
      buf ^= 1;
    }
  }
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int c = lane + 32 * j;
      if (c < p.k) wrow[c] = win[j];
    }
  }
  if (lane == 0) {
    sum_w[0][warp] = sse;
    sum_w[1][warp] = live;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      s += sum_w[0][w];
      l += sum_w[1][w];
    }
    p.sse_rows[x] = s;
    if (NOACC) p.live[x] = l;
  }
}

template <int KJ, int V>
cudaError_t launch_rows(const Params& p, int n_blocks, cudaStream_t s) {
  probe_rows<KJ, V, false><<<n_blocks, NW * 32, 0, s>>>(p);
  return cudaGetLastError();
}

template <int KJ>
cudaError_t launch(const Params& p, int variant, int ff_bf16, int n_blocks,
                   cudaStream_t s) {
  if (ff_bf16) {
    if (variant != V_F32DOT) return cudaErrorInvalidValue;
    probe_rows<KJ, V_F32DOT, true><<<n_blocks, NW * 32, 0, s>>>(p);
    return cudaGetLastError();
  }
  switch (variant) {
    case V_F32DOT: return launch_rows<KJ, V_F32DOT>(p, n_blocks, s);
    case V_B16DOT: return launch_rows<KJ, V_B16DOT>(p, n_blocks, s);
    case V_B16CHAIN: return launch_rows<KJ, V_B16CHAIN>(p, n_blocks, s);
    case V_NOFU: return launch_rows<KJ, V_NOFU>(p, n_blocks, s);
    case V_NOFU_B16: return launch_rows<KJ, V_NOFU_B16>(p, n_blocks, s);
    case V_NOELEM: return launch_rows<KJ, V_NOELEM>(p, n_blocks, s);
    case V_NOELEM_2D: return launch_rows<KJ, V_NOELEM_2D>(p, n_blocks, s);
    case V_NODOT: return launch_rows<KJ, V_NODOT>(p, n_blocks, s);
    case V_NOPROD: return launch_rows<KJ, V_NOPROD>(p, n_blocks, s);
    case V_NOACC: return launch_rows<KJ, V_NOACC>(p, n_blocks, s);
    case V_NOACC_2D: return launch_rows<KJ, V_NOACC_2D>(p, n_blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// P2 variant ``variant`` (the V_* order above) over ``n_rows`` window rows
// (G problems of W rows): one block per row, n_rep chained calls of T
// sweeps each.  ``ff`` is bf16 when ``ff_bf16`` (V_F32DOT only), else f32;
// ``live`` [n_rows] takes the no_acc variants' error sums.  Returns a
// cudaError_t (0 = launched).  k in 1..128.
int probe_launch(float* out, const void* ff, int ff_bf16, const float* r,
                 const float* m, const int* seg_ptr, const int* ent,
                 const float* lrv, const float* regv, float mu, int k, int T,
                 int n_rep, int n_rows, int variant, float* sse_rows,
                 float* live, void* stream) {
  if (k < 1 || k > 32 * MAX_KJ || T < 1 || n_rep < 0 || n_rows < 0 ||
      variant < 0 || variant >= N_VARIANTS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0 || n_rep == 0) return 0;
  Params p;
  p.out = out;
  p.ff = ff;
  p.r = r;
  p.m = m;
  p.seg_ptr = seg_ptr;
  p.ent = ent;
  p.lrv = lrv;
  p.regv = regv;
  p.mu = mu;
  p.k = k;
  p.T = T;
  p.n_rep = n_rep;
  p.sse_rows = sse_rows;
  p.live = live;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((k + 31) / 32) {
    case 1: err = launch<1>(p, variant, ff_bf16, n_rows, s); break;
    case 2: err = launch<2>(p, variant, ff_bf16, n_rows, s); break;
    case 3: err = launch<3>(p, variant, ff_bf16, n_rows, s); break;
    default: err = launch<4>(p, variant, ff_bf16, n_rows, s); break;
  }
  return static_cast<int>(err);
}

const char* probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

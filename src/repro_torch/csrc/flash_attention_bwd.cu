// K1-bwd: the gradient of K1 (blockwise flash attention), by hand for
// Hopper (sm_90a).
//
// The JAX package has no counterpart: its Pallas K1
// (repro/kernels/flash_attention.py, flash_attention) has no custom_vjp, and
// jax.grad through pallas_call raises, so its training takes gradients on
// the plain path. Here the gradient of K1's function is a kernel of its
// own, reached through a torch.autograd.Function whose forward is K1.
//
// Function: for out = softmax(mask(cap·tanh(Q·Kᵀ·D^-0.5 / cap)))·V with
// grouped-query heads (query head h reads KV head h / (Hq / Hkv)), causal
// or not, a sliding window, a tanh softcap, Sq != Sk, and q_offset 0 with
// no sk_valid (training never sets them), given dO it returns dQ, dK, dV.
// Inputs are float32 or bfloat16; all arithmetic is float32 on the CUDA
// cores (no TF32), and the gradients are written in the inputs' type. A
// query row with no valid key has output 0 in K1 and gradient 0 here.
//
// Three kernels, no atomics, so that the gradients are the same bits from
// run to run:
//   pass 0, one block per (q tile, q head, batch): recompute the row max
//           and row sum of the forward's softmax over the visible key tiles
//           (S = Q·Kᵀ only, no P·V) and keep lse = m + log l (B, Hq, Sq);
//           delta = rowsum(dO ∘ O) (B, Hq, Sq), from the forward's output;
//   pass 1, one block per (k tile, KV head, batch): for each of the group's
//           G query heads and each q tile that can see this k tile (causal
//           and window bounds), recompute P = exp(S − lse), then
//           dV += Pᵀ·dO, dS = P ∘ (dO·Vᵀ − delta) ∘ (1 − tanh²) under a
//           softcap, dK += dSᵀ·Q·D^-0.5; dK and dV are written once per KV
//           head, summed over the group in a fixed order;
//   pass 2, one block per (q tile, q head, batch): the same dS over the
//           visible k tiles, dQ += dS·K·D^-0.5.
// The wrapper allocates lse and delta (float32 scratch). Passes 1 and 2
// form S and dP by the same code in the same order, so they agree on dS.
//
// Tiles are 64 query rows by 64 keys. A block's 256 threads form a 16 x 16
// grid; thread (ty, tx) owns rows ty + 16i and columns tx + 16j of each
// product (i < 4; j < 4 for a 64 x 64 tile, j < D/16 for a 64 x D one), so
// the 16 threads of a half warp share a row and reduce it by shuffles.
// Tiles sit in shared memory as float32 rows padded by one word, so that a
// half warp reading 16 rows at one column hits 16 banks.
//
// Bound on this card: five products of the forward's size (S, dP, dV, dK,
// dQ; the forward has two), 2.5 times its operations, over q, k, v, o, dO
// read and dQ, dK, dV written. In float32 at smollm-360m's training shape
// (B 8, 15 on 5 heads, D 64, S 512, causal) that is about 10 GFLOP against
// 34 MB: operation-bound at the float32 peak.
#include "attention_common.cuh"

#include <math.h>

namespace repro_torch {
namespace bwd {

constexpr int kB = 64;        // query rows and keys of a tile
constexpr int kT = 256;       // threads of a block: 16 x 16
constexpr int kPL = kB + 1;   // padded row of a 64 x 64 tile (P, dS)

template <int D>
__host__ __device__ constexpr int ld() { return D + 1; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Sum and max over the 16 threads of a half warp (one row of a tile).
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

struct Mask {
  int Sq, Sk, causal, window;
  __device__ __forceinline__ bool operator()(int qpos, int kpos) const {
    bool ok = qpos < Sq && kpos < Sk;
    if (causal) ok = ok && kpos <= qpos;
    if (window > 0) ok = ok && qpos - kpos < window;
    return ok;
  }
};

// Rows [0, n) of a (rows, D) slab of T into a [kB][D + 1] float tile, times
// `scale`; rows n .. kB - 1 are zeros. 16-byte loads.
template <typename T, int D>
__device__ void load_rows(float* __restrict__ dst, const T* __restrict__ src,
                          int n, float scale) {
  constexpr int V = vec_len<T>();
  constexpr int CPR = D / V;
  for (int c = threadIdx.x; c < kB * CPR; c += kT) {
    const int r = c / CPR;
    const int d0 = (c % CPR) * V;
    float f[V];
    if (r < n) {
      load16(src + (size_t)r * D + d0, f);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) f[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) dst[r * ld<D>() + d0 + i] = f[i] * scale;
  }
}

// acc[i][j] = sum_d a[ty + 16i][d] · b[tx + 16j][d]  (a·bᵀ, 64 x 64)
template <int D>
__device__ __forceinline__ void mm_abt(const float* __restrict__ a,
                                       const float* __restrict__ b,
                                       float (&acc)[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * ld<D>() + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * ld<D>() + d];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// acc[i][j] += sum_r a[r][ty + 16i] · b[r][tx + 16j]  (aᵀ·b, 64 x D)
template <int D>
__device__ __forceinline__ void mm_atb(const float* __restrict__ a,
                                       const float* __restrict__ b,
                                       float (&acc)[4][D / 16]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int r = 0; r < kB; ++r) {
    float av[4], bv[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[r * kPL + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) bv[j] = b[r * ld<D>() + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// acc[i][j] += sum_c a[ty + 16i][c] · b[c][tx + 16j]  (a·b, 64 x D)
template <int D>
__device__ __forceinline__ void mm_ab(const float* __restrict__ a,
                                      const float* __restrict__ b,
                                      float (&acc)[4][D / 16]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int c = 0; c < kB; ++c) {
    float av[4], bv[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * kPL + c];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) bv[j] = b[c * ld<D>() + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// The softcapped logit of a scaled score, and 1 - tanh² (1 without a cap).
__device__ __forceinline__ float capped(float x, float softcap, float& dcap) {
  if (softcap > 0.f) {
    const float t = tanhf(x / softcap);
    dcap = 1.f - t * t;
    return softcap * t;
  }
  dcap = 1.f;
  return x;
}

// Key tiles a q tile [q0, q0 + rows) sees: [begin, end), begin a tile edge.
__device__ __forceinline__ void key_range(const Mask& m, int q0, int rows,
                                          int& begin, int& end) {
  end = m.Sk;
  if (m.causal) end = min(end, q0 + rows);
  begin = m.window > 0 ? max(0, q0 - m.window + 1) : 0;
  begin = (begin / kB) * kB;
}

// dS of one 64 x 64 tile into `ds` (and P into `p` when given), from the
// scaled Q and dO rows and the K and V tiles in shared memory; ls and dl
// are the rows' lse and delta. Rows and keys outside the mask give 0.
template <int D>
__device__ __forceinline__ void ds_tile(const float* qs, const float* dos,
                                        const float* ks, const float* vs,
                                        const float* ls, const float* dl,
                                        const Mask& mask, int q0, int k0,
                                        float softcap, float* p, float* ds) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float s[4][4], dp[4][4];
  mm_abt<D>(qs, ks, s);
  mm_abt<D>(dos, vs, dp);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      float dcap;
      const float x = capped(s[i][j], softcap, dcap);
      const float pv = mask(q0 + r, k0 + c) ? expf(x - ls[r]) : 0.f;
      if (p != nullptr) p[r * kPL + c] = pv;
      ds[r * kPL + c] = pv * (dp[i][j] - dl[r]) * dcap;
    }
  }
}

// ------------------------------------------------------------- pass 0
template <typename T, int D>
__global__ void __launch_bounds__(kT)
bwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ lse, float* __restrict__ delta, int Hq,
                 int Hkv, Mask mask, float softcap, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + kB * ld<D>();
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;   // heaviest first
  const int hk = h / (Hq / Hkv);
  const int Sq = mask.Sq, Sk = mask.Sk;
  const int rows = min(kB, Sq - q0);
  const size_t qoff = (((size_t)b * Hq + h) * Sq + q0) * D;
  const size_t row0 = ((size_t)b * Hq + h) * Sq + q0;
  load_rows<T, D>(qs, q + qoff, rows, scale);
  // delta: one warp per row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kT / 32) {
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) {
      acc = fmaf(to_f32(o[qoff + (size_t)r * D + d]),
                 to_f32(dout[qoff + (size_t)r * D + d]), acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) delta[row0 + r] = acc;
  }
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  int kb, ke;
  key_range(mask, q0, rows, kb, ke);
  const T* kbase = k + ((size_t)b * Hkv + hk) * Sk * D;
  for (int k0 = kb; k0 < ke; k0 += kB) {
    __syncthreads();   // previous tile read; first pass: Q visible after
    load_rows<T, D>(ks, kbase + (size_t)k0 * D, min(kB, Sk - k0), 1.f);
    __syncthreads();
    float s[4][4];
    mm_abt<D>(qs, ks, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float dcap;
        const float x = capped(s[i][j], softcap, dcap);
        s[i][j] = mask(q0 + r, k0 + tx + 16 * j) ? x : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const bool live = m_new != -INFINITY;   // the same in the whole row
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sum += (live && s[i][j] != -INFINITY) ? expf(s[i][j] - m_new) : 0.f;
      }
      sum = row_sum(sum);
      if (live) {
        l[i] = l[i] * expf(m[i] - m_new) + sum;
        m[i] = m_new;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      // a row with no valid key: lse = +inf, so every P of it is 0
      if (r < rows) lse[row0 + r] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    }
  }
}

// ------------------------------------------------------------- pass 1
template <typename T, int D>
__global__ void __launch_bounds__(kT)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hkv,
                Mask mask, float softcap, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kB * ld<D>();
  float* qs = vs + kB * ld<D>();
  float* dos = qs + kB * ld<D>();
  float* ps = dos + kB * ld<D>();
  float* dss = ps + kB * kPL;
  float* ls = dss + kB * kPL;
  float* dl = ls + kB;
  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * kB;
  const int G = Hq / Hkv;
  const int Sq = mask.Sq, Sk = mask.Sk;
  const int krows = min(kB, Sk - k0);
  const size_t koff = (((size_t)b * Hkv + hk) * Sk + k0) * D;
  load_rows<T, D>(ks, k + koff, krows, 1.f);
  load_rows<T, D>(vs, v + koff, krows, 1.f);
  float acc_dk[4][D / 16], acc_dv[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;
  }
  // q tiles that see a key of [k0, k0 + krows)
  const int qb = mask.causal ? k0 : 0;          // a tile edge: kB | k0
  const int qe = mask.window > 0 ? min(Sq, k0 + krows - 1 + mask.window) : Sq;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int q0 = qb; q0 < qe; q0 += kB) {
      const int rows = min(kB, Sq - q0);
      const size_t row0 = ((size_t)b * Hq + h) * Sq + q0;
      __syncthreads();   // the previous tile's P and dS consumed
      load_rows<T, D>(qs, q + row0 * D, rows, scale);
      load_rows<T, D>(dos, dout + row0 * D, rows, 1.f);
      for (int r = threadIdx.x; r < kB; r += kT) {
        ls[r] = r < rows ? lse[row0 + r] : INFINITY;
        dl[r] = r < rows ? delta[row0 + r] : 0.f;
      }
      __syncthreads();
      ds_tile<D>(qs, dos, ks, vs, ls, dl, mask, q0, k0, softcap, ps, dss);
      __syncthreads();
      mm_atb<D>(ps, dos, acc_dv);     // dV += Pᵀ·dO
      mm_atb<D>(dss, qs, acc_dk);     // dK += dSᵀ·(Q·scale)
    }
  }
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = ty + 16 * i;
    if (c < krows) {
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        const size_t at = koff + (size_t)c * D + tx + 16 * j;
        dk[at] = from_f32<T>(acc_dk[i][j]);
        dv[at] = from_f32<T>(acc_dv[i][j]);
      }
    }
  }
}

// ------------------------------------------------------------- pass 2
template <typename T, int D>
__global__ void __launch_bounds__(kT)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int Hq, int Hkv, Mask mask, float softcap,
              float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kB * ld<D>();
  float* ks = dos + kB * ld<D>();
  float* vs = ks + kB * ld<D>();
  float* dss = vs + kB * ld<D>();
  float* ls = dss + kB * kPL;
  float* dl = ls + kB;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;   // heaviest first
  const int hk = h / (Hq / Hkv);
  const int Sq = mask.Sq, Sk = mask.Sk;
  const int rows = min(kB, Sq - q0);
  const size_t row0 = ((size_t)b * Hq + h) * Sq + q0;
  load_rows<T, D>(qs, q + row0 * D, rows, scale);
  load_rows<T, D>(dos, dout + row0 * D, rows, 1.f);
  for (int r = threadIdx.x; r < kB; r += kT) {
    ls[r] = r < rows ? lse[row0 + r] : INFINITY;
    dl[r] = r < rows ? delta[row0 + r] : 0.f;
  }
  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  }
  int kb, ke;
  key_range(mask, q0, rows, kb, ke);
  const T* kbase = k + ((size_t)b * Hkv + hk) * Sk * D;
  const T* vbase = v + ((size_t)b * Hkv + hk) * Sk * D;
  for (int k0 = kb; k0 < ke; k0 += kB) {
    __syncthreads();   // the previous tile's dS consumed
    load_rows<T, D>(ks, kbase + (size_t)k0 * D, min(kB, Sk - k0), 1.f);
    load_rows<T, D>(vs, vbase + (size_t)k0 * D, min(kB, Sk - k0), 1.f);
    __syncthreads();
    ds_tile<D>(qs, dos, ks, vs, ls, dl, mask, q0, k0, softcap, nullptr, dss);
    __syncthreads();
    mm_ab<D>(dss, ks, acc);           // dQ += dS·K
  }
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r < rows) {
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        dq[(row0 + r) * D + tx + 16 * j] = from_f32<T>(acc[i][j] * scale);
      }
    }
  }
}

template <int D>
constexpr size_t stats_smem() { return sizeof(float) * 2 * kB * ld<D>(); }
template <int D>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (4 * kB * ld<D>() + 2 * kB * kPL + 2 * kB);
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * kB * ld<D>() + kB * kPL + 2 * kB);
}

template <typename T, int D>
static int launch(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, void* dq, void* dk, void* dv, float* lse,
                  float* delta, int B, int Hq, int Hkv, int Sq, int Sk,
                  int causal, int window, float softcap, float scale,
                  cudaStream_t st) {
  static size_t allowed0 = 0, allowed1 = 0, allowed2 = 0;
  auto k0 = bwd_stats_kernel<T, D>;
  auto k1 = bwd_dkdv_kernel<T, D>;
  auto k2 = bwd_dq_kernel<T, D>;
  if (!raise_smem_limit(k0, stats_smem<D>(), allowed0) ||
      !raise_smem_limit(k1, dkdv_smem<D>(), allowed1) ||
      !raise_smem_limit(k2, dq_smem<D>(), allowed2)) {
    return (int)cudaGetLastError();
  }
  const Mask mask{Sq, Sk, causal, window};
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const dim3 qgrid((Sq + kB - 1) / kB, Hq, B);
  const dim3 kgrid((Sk + kB - 1) / kB, Hkv, B);
  k0<<<qgrid, kT, stats_smem<D>(), st>>>(qt, kt, static_cast<const T*>(o),
                                         dot, lse, delta, Hq, Hkv, mask,
                                         softcap, scale);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  k1<<<kgrid, kT, dkdv_smem<D>(), st>>>(qt, kt, vt, dot, lse, delta,
                                        static_cast<T*>(dk),
                                        static_cast<T*>(dv), Hq, Hkv, mask,
                                        softcap, scale);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  k2<<<qgrid, kT, dq_smem<D>(), st>>>(qt, kt, vt, dot, lse, delta,
                                      static_cast<T*>(dq), Hq, Hkv, mask,
                                      softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace bwd
}  // namespace repro_torch

using namespace repro_torch;

// dtype: 0 = float32, 1 = bfloat16; head_dim 64 or 128. window <= 0 and
// softcap <= 0 mean none. lse and delta are float32 (B, Hq, Sq) scratch.
// Returns the cudaError_t of the first failed launch (0 on success).
extern "C" int repro_flash_attention_bwd(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    const void* o, const void* dout, void* dq, void* dk, void* dv, void* lse,
    void* delta, int B, int Hq, int Hkv, int Sq, int Sk, int causal,
    int window, float softcap, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* dl = static_cast<float*>(delta);
#define REPRO_BWD(T, DD)                                                   \
  return bwd::launch<T, DD>(q, k, v, o, dout, dq, dk, dv, l, dl, B, Hq,    \
                            Hkv, Sq, Sk, causal, window, softcap, scale, st)
  if (dtype == 0 && head_dim == 64) REPRO_BWD(float, 64);
  if (dtype == 0 && head_dim == 128) REPRO_BWD(float, 128);
  if (dtype == 1 && head_dim == 64) REPRO_BWD(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) REPRO_BWD(__nv_bfloat16, 128);
#undef REPRO_BWD
  return (int)cudaErrorInvalidValue;
}

// Shared device code of the attention kernels. K1's float32 flash prefill
// (v2) is the one CUDA-core tile kernel left: it alone uses the shared-memory
// tile (Smem, init_rows, load_tile, attend_tile, write_row). K1's bf16
// kernel (v3, wgmma), K2, K3 and K4 (split-KV, decode_attention.cu) and K5
// (the SSD scan) use only its constants and small helpers (conversion,
// 16-byte loads, the shared-memory limit).
//
// Layout in shared memory (all float32, whatever the input type):
//   q   [rows][D]      queries of the block, pre-scaled by D^-0.5
//   acc [rows][D]      running sum of p * V per row
//   m, l [rows4]       running max and running sum of p per row (rows4 is
//                      rows rounded up to 4, so the tiles stay 16-byte aligned)
//   kt  [D][bk + 1]    K tile, transposed and padded so that lane j reading
//                      key j is conflict-free
//   vs  [bk][D]        V tile
//
// Device memory is read in 16-byte vectors, several in flight per thread, so
// a tile load costs a few memory latencies rather than one per element.
//
// A warp owns whole groups of R rows. For each 32-key sub-tile, lane j
// computes the scores of key j for the R rows (one K read serves R rows), the
// warp reduces max and sum with shuffles, and lane i accumulates columns
// i, i+32, ... of p @ V for the R rows (one V read serves R rows). Everything
// is float32 FMA on the CUDA cores.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace repro_torch {

constexpr float kNegInf = -1e30f;     // the reference's NEG_INF
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;         // eight warps per block
constexpr int kInFlight = 4;          // 16-byte loads in flight per thread

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's cast
}

// Elements of T in one 16-byte vector.
template <typename T>
__host__ __device__ constexpr int vec_len() { return 16 / (int)sizeof(T); }

// One 16-byte vector at p (16-byte aligned) as floats.
__device__ __forceinline__ void load16(const float* __restrict__ p,
                                       float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* __restrict__ p,
                                       float (&o)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Allow `kern` `bytes` of dynamic shared memory (above 48 KB it must be
// asked for). `allowed` is the caller's record for this kernel (a static in
// its launcher template, so one per instantiation): the call is made once
// per kernel and size, and a launch inside CUDA graph capture makes none.
// False if the card refuses.
template <typename Kernel>
bool raise_smem_limit(Kernel kern, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return true;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes) != cudaSuccess) {
    return false;
  }
  allowed = bytes;
  return true;
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Floats of shared memory a block needs for `rows` query rows.
template <int D>
__host__ __device__ constexpr size_t smem_floats(int rows, int bk) {
  return (size_t)rows * D * 2 + (size_t)round4(rows) * 2 +
         (size_t)D * (bk + 1) + (size_t)bk * D;
}

template <int D>
struct Smem {
  float* q;
  float* acc;
  float* m;
  float* l;
  float* kt;
  float* vs;
  __device__ Smem(float* base, int rows, int bk) {
    q = base;
    acc = q + (size_t)rows * D;
    m = acc + (size_t)rows * D;
    l = m + round4(rows);
    kt = l + round4(rows);
    vs = kt + (size_t)D * (bk + 1);
  }
};

// Queries of `rows` contiguous rows into shared memory, scaled; acc, m, l
// to their initial values. The caller synchronises before use.
template <typename T, int D>
__device__ void init_rows(const Smem<D>& s, const T* __restrict__ q, int rows,
                          float scale) {
  constexpr int V = vec_len<T>();
  for (int c = threadIdx.x; c < rows * D / V; c += blockDim.x) {
    float f[V];
    load16(q + (size_t)c * V, f);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s.q[c * V + i] = f[i] * scale;
      s.acc[c * V + i] = 0.f;
    }
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    s.m[r] = kNegInf;
    s.l[r] = 0.f;
  }
}

// K/V tile [k0, k0 + bk) into shared memory. `ptr(kpos)` returns the
// element offset of key row kpos in k and v; keys at or past `limit` are
// written as zeros (masked later, never read from device memory). Each
// thread keeps kInFlight 16-byte loads of K and of V in flight before it
// stores any of them.
template <typename T, int D, typename RowPtr>
__device__ void load_tile(const Smem<D>& s, const T* __restrict__ k,
                          const T* __restrict__ v, int k0, int bk, int limit,
                          RowPtr ptr) {
  constexpr int V = vec_len<T>();
  constexpr int CPR = D / V;            // 16-byte chunks per key row
  const int ld = bk + 1;
  const int n = bk * CPR;
  const int step = blockDim.x;
  for (int base = threadIdx.x; base < n; base += kInFlight * step) {
    float kf[kInFlight][V], vf[kInFlight][V];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int c = base + u * step;
      const int kpos = k0 + c / CPR;
      if (c < n && kpos < limit) {
        const size_t off = ptr(kpos) + (size_t)(c % CPR) * V;
        load16(k + off, kf[u]);
        load16(v + off, vf[u]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) kf[u][i] = vf[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int c = base + u * step;
      if (c < n) {
        const int j = c / CPR;
        const int d0 = (c % CPR) * V;
#pragma unroll
        for (int i = 0; i < V; ++i) s.kt[(d0 + i) * ld + j] = kf[u][i];
#pragma unroll
        for (int i = 0; i < V; i += 4) {
          *reinterpret_cast<float4*>(s.vs + (size_t)j * D + d0 + i) =
              make_float4(vf[u][i], vf[u][i + 1], vf[u][i + 2], vf[u][i + 3]);
        }
      }
    }
  }
}

// Online-softmax update of rows r0 .. r0+nr-1 (1 <= nr <= R) against the
// tile in shared memory, by the warp that owns them. `valid(i, kpos)` says
// whether row r0+i sees key kpos; softcap <= 0 means none, and it is applied
// before the mask, as in the reference.
template <int D, int R, typename Valid>
__device__ void attend_tile(const Smem<D>& s, int r0, int nr, int k0, int bk,
                            float softcap, Valid valid) {
  constexpr int NV = D / 32;
  const int lane = threadIdx.x & 31;
  const int ld = bk + 1;
  const float4* q4[R];
  float m[R], l[R], a[R][NV];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = r0 + min(i, nr - 1);   // rows past nr repeat the last one
    q4[i] = reinterpret_cast<const float4*>(s.q + (size_t)r * D);
    m[i] = s.m[r];
    l[i] = s.l[r];
  }
  bool touched = false;
  for (int sub = 0; sub < bk; sub += 32) {
    const int kpos = k0 + sub + lane;
    bool ok[R];
    bool any = false;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      ok[i] = i < nr && valid(i, kpos);
      any = any || ok[i];
    }
    if (!__any_sync(kFull, any)) continue;     // sub-tile dead for the rows
    float sc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) sc[i] = 0.f;
    const float* kc = s.kt + sub + lane;
#pragma unroll 8
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float* kd = kc + (4 * d4) * ld;
      const float k0v = kd[0], k1v = kd[ld], k2v = kd[2 * ld], k3v = kd[3 * ld];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float4 qq = q4[i][d4];
        sc[i] = fmaf(qq.x, k0v, sc[i]);
        sc[i] = fmaf(qq.y, k1v, sc[i]);
        sc[i] = fmaf(qq.z, k2v, sc[i]);
        sc[i] = fmaf(qq.w, k3v, sc[i]);
      }
    }
    float p[R], alpha[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float x = sc[i];
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      x = ok[i] ? x : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(x));
      alpha[i] = expf(m[i] - m_new);
      p[i] = ok[i] ? expf(x - m_new) : 0.f;
      l[i] = l[i] * alpha[i] + warp_sum(p[i]);
      m[i] = m_new;
    }
    if (!touched) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float* acc = s.acc + (size_t)(r0 + min(i, nr - 1)) * D + lane;
#pragma unroll
        for (int c = 0; c < NV; ++c) a[i][c] = acc[32 * c];
      }
      touched = true;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int c = 0; c < NV; ++c) a[i][c] *= alpha[i];
    }
    const float* vrow = s.vs + (size_t)sub * D + lane;
#pragma unroll 4
    for (int jj = 0; jj < 32; ++jj) {
      float vv[NV];
#pragma unroll
      for (int c = 0; c < NV; ++c) vv[c] = vrow[jj * D + 32 * c];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float pj = __shfl_sync(kFull, p[i], jj);
#pragma unroll
        for (int c = 0; c < NV; ++c) a[i][c] = fmaf(pj, vv[c], a[i][c]);
      }
    }
  }
  if (touched) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i < nr) {
        float* acc = s.acc + (size_t)(r0 + i) * D + lane;
#pragma unroll
        for (int c = 0; c < NV; ++c) acc[32 * c] = a[i][c];
        if (lane == 0) {
          s.m[r0 + i] = m[i];
          s.l[r0 + i] = l[i];
        }
      }
    }
  }
}

// acc / l into the output row; a row that saw no valid key (l == 0) is 0.
template <typename T, int D>
__device__ void write_row(const Smem<D>& s, int r, T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const float l = s.l[r];
  const float denom = l == 0.f ? 1.f : l;
#pragma unroll
  for (int i = 0; i < D / 32; ++i) {
    out[lane + 32 * i] =
        from_f32<T>(s.acc[(size_t)r * D + lane + 32 * i] / denom);
  }
}

}  // namespace repro_torch

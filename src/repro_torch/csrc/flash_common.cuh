// Shared-memory tiles and register micro-tiles of K1's float32 kernel (v4,
// flash_attention.cu) and of K1-bwd (flash_attention_bwd.cu), both float32
// FMA on the CUDA cores (no TF32: the float32 gate is 2e-5).
//
// A block works on tiles of `rows` x 64-or-more. Thread (ty, tx) =
// (tid / 16, tid % 16) owns R consecutive rows, ar = ty·R .. +R-1, of every
// product it forms:
//
//   abt  acc[i][j] += Σ_d A[ar + i][d] · B[tx + 16j][d]       (A·Bᵀ)
//        A's R rows are one float4 each per step of 4 along d, read by all
//        16 threads of the row group (a broadcast); B's rows tx + 16j are
//        read with a row stride of D + 4 floats, so the 8 threads of a
//        128-bit access phase land on 8 distinct groups of 4 banks. R·NJ·4
//        FMAs per (R + NJ) 16-byte loads: 8 x 4 gives 128 per 12, 2.7 FMAs
//        per float read (a 4 x 4 micro-tile gives 2).
//   ab   acc[i][4h + e] += Σ_k A[ar + i][k] · B[k][64h + 4tx + e]  (A·B)
//        A's rows again one float4 per step of 4 along k; B's rows k .. k+3
//        one float4 each per 64 columns, 16 threads on 256 contiguous bytes.
//        R·16·NH FMAs per (R + 4·NH) loads: 8 x 4 gives 128 per 12.
//
// A row of an abt result is spread over the 16 threads of a half warp
// (columns tx, tx + 16, ...), so a row's max or sum is four shuffles.
// Both loops are unrolled by two: fully unrolled, the kernels ran slower on
// the card (the code of a kernel's products outgrows the instruction cache).
//
// Tiles are copied from device memory with cp.async (16 bytes a thread,
// rows past the valid count written as zeros), so that a tile loads while
// the block computes on another; bf16 inputs are converted to float32 on the
// way, by plain loads.
#pragma once

#include "attention_common.cuh"

namespace repro_torch {
namespace tile {

constexpr int kTX = 16;   // threads of a row group: a half warp

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from `src` into shared memory at `dst`, asynchronously; zeros
// when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Until at most N of this thread's newest copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, n) of a row-major (rows, D) slab at `src` into a [ROWS][LD]
// float tile at `dst`; rows n .. ROWS-1 are zeros. Float32 goes by cp.async
// (the caller commits and waits); bf16 is converted by plain loads.
template <int ROWS, int D, int LD, int NT>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int n) {
  constexpr int CPR = D / 4;
  for (int c = threadIdx.x; c < ROWS * CPR; c += NT) {
    const int r = c / CPR;
    const int d0 = (c % CPR) * 4;
    const bool ok = r < n;
    cp_async16(dst + r * LD + d0, ok ? src + (size_t)r * D + d0 : src, ok);
  }
}

template <int ROWS, int D, int LD, int NT>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const __nv_bfloat16* __restrict__ src,
                                          int n) {
  constexpr int CPR = D / 8;
  for (int c = threadIdx.x; c < ROWS * CPR; c += NT) {
    const int r = c / CPR;
    const int d0 = (c % CPR) * 8;
    float f[8];
    if (r < n) {
      load16(src + (size_t)r * D + d0, f);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = 0.f;
    }
    float4* o = reinterpret_cast<float4*>(dst + r * LD + d0);
    o[0] = make_float4(f[0], f[1], f[2], f[3]);
    o[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
}

// Four floats to T at p (16-byte aligned for float, 8 for bf16).
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(p);
  h[0] = __floats2bfloat162_rn(a, b);
  h[1] = __floats2bfloat162_rn(c, d);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Component e (0..3, a constant after unrolling) of a float4.
__device__ __forceinline__ float comp(float4 v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// acc[i][j] += Σ_{d < DEPTH} A[i][d] · B[(tx + 16j)·LDB + d]; A points at
// the thread's first row (stride LDA), B at the tile's row 0.
template <int R, int NJ, int DEPTH, int LDA, int LDB>
__device__ __forceinline__ void abt(const float* __restrict__ A,
                                    const float* __restrict__ B,
                                    float (&acc)[R][NJ]) {
  const int tx = threadIdx.x % kTX;
#pragma unroll 2
  for (int d = 0; d < DEPTH; d += 4) {
    float4 b[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = ld4(B + (tx + kTX * j) * LDB + d);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float4 a = ld4(A + i * LDA + d);
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = dot4(a, b[j], acc[i][j]);
    }
  }
}

// acc[i][4h + e] += Σ_{k < DEPTH} A[i][k] · B[k·LDB + 64h + 4tx + e]; A
// points at the thread's first row (stride LDA), B at the tile's row 0.
template <int R, int NH, int DEPTH, int LDA, int LDB>
__device__ __forceinline__ void ab(const float* __restrict__ A,
                                   const float* __restrict__ B,
                                   float (&acc)[R][4 * NH]) {
  const int c0 = 4 * (threadIdx.x % kTX);
#pragma unroll 2
  for (int k = 0; k < DEPTH; k += 4) {
    float4 b[4][NH];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        b[kk][h] = ld4(B + (k + kk) * LDB + 64 * h + c0);
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float4 a = ld4(A + i * LDA + k);
#pragma unroll
      for (int h = 0; h < NH; ++h) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = acc[i][4 * h + e];
          x = fmaf(a.x, comp(b[0][h], e), x);
          x = fmaf(a.y, comp(b[1][h], e), x);
          x = fmaf(a.z, comp(b[2][h], e), x);
          acc[i][4 * h + e] = fmaf(a.w, comp(b[3][h], e), x);
        }
      }
    }
  }
}

// Max and sum over the 16 threads of a half warp (one row of an abt tile).
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

}  // namespace tile
}  // namespace repro_torch

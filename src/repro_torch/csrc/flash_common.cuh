// Shared-memory tiles and register micro-tiles of K1's float32 kernel (v4,
// flash_attention.cu), K1-bwd (flash_attention_bwd.cu), K5's float32 passes
// (v3, ssm_scan.cu) and K5-bwd (v2, ssm_scan_bwd.cu), all float32 FMA on the
// CUDA cores (no TF32: the float32 gate is 2e-5).
//
// A block works on tiles of `rows` x 32-or-more. Thread (ty, tx) =
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
//   abw  ab for a result W columns wide: W a multiple of 64 is ab; W = 32
//        gives each thread columns 2tx and 2tx + 1 (8-byte loads of B).
//   atb  acc[i][c] += Σ_k A[k][ar + i] · B[k][col(c)]         (Aᵀ·B)
//        per step of k one row of each: A's R floats of the thread's rows
//        (R/4 broadcast float4 loads) and B's W/16 columns of abw: 8 rows by
//        128 columns give 64 FMAs per 16 floats read.
//
// Instead of padding its rows, a tile that abt reads as B may be swizzled
// (SW): the 16-byte group g of row r is stored at group g ^ (r % 8), which
// spreads the 8 rows of an access phase over the banks as the padding does,
// at no extra memory (K5-bwd's tiles fill the shared memory of two blocks
// an SM to the byte). abt and ab read such a B with the same XOR.
//
// A row of an abt result is spread over the 16 threads of a half warp
// (columns tx, tx + 16, ...), so a row's max or sum is four shuffles.
// ab's and abt's loops are unrolled by two: fully unrolled, the kernels ran
// slower on the card (the code of a kernel's products outgrows the
// instruction cache).
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

// The XOR that a swizzled tile applies to the float offsets of row r (0
// for a plain tile): the row's 16-byte groups g are stored at g ^ (r % 8).
template <bool SW>
__device__ __forceinline__ int swz(int r) {
  return SW ? (r & 7) << 2 : 0;
}

// acc[i][j] += Σ_{d < DEPTH} A[i][d] · B[(tx + 16j)·LDB + d]; A points at
// the thread's first row (stride LDA), B at the tile's row 0.
// With SW, B is a swizzled tile (rows tx + 16j all have r % 8 = tx % 8).
template <int R, int NJ, int DEPTH, int LDA, int LDB, bool SW = false>
__device__ __forceinline__ void abt(const float* __restrict__ A,
                                    const float* __restrict__ B,
                                    float (&acc)[R][NJ]) {
  const int tx = threadIdx.x % kTX;
  const int sw = swz<SW>(tx);
#pragma unroll 2
  for (int d = 0; d < DEPTH; d += 4) {
    float4 b[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      b[j] = ld4(B + (tx + kTX * j) * LDB + (d ^ sw));
    }
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
// With SW, B is a swizzled tile.
template <int R, int NH, int DEPTH, int LDA, int LDB, bool SW = false>
__device__ __forceinline__ void ab(const float* __restrict__ A,
                                   const float* __restrict__ B,
                                   float (&acc)[R][4 * NH]) {
  const int c0 = 4 * (threadIdx.x % kTX);
#pragma unroll 2
  for (int k = 0; k < DEPTH; k += 4) {
    float4 b[4][NH];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c = c0 ^ swz<SW>(k + kk);
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        b[kk][h] = ld4(B + (k + kk) * LDB + 64 * h + c);
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

// Column c (< W / 16) of a W-wide ab, abw or atb result that thread tx of
// a row group owns: 64(c / 4) + 4tx + c % 4 for W a multiple of 64, else
// (W = 32) 2tx + c.
template <int W>
__device__ __forceinline__ int col(int tx, int c) {
  return W % 64 == 0 ? 64 * (c / 4) + 4 * tx + c % 4 : 2 * tx + c;
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// The thread's W / 16 columns of the row at p (16-byte aligned), the XOR
// x applied to their offsets.
template <int W>
__device__ __forceinline__ void ld_cols(const float* __restrict__ p, int tx,
                                        int x, float (&v)[W / 16]) {
  if constexpr (W % 64 == 0) {
#pragma unroll
    for (int h = 0; h < W / 64; ++h) {
      const float4 f = ld4(p + 64 * h + ((4 * tx) ^ x));
      v[4 * h] = f.x;
      v[4 * h + 1] = f.y;
      v[4 * h + 2] = f.z;
      v[4 * h + 3] = f.w;
    }
  } else {
    static_assert(W == 32, "a result is 32 columns wide or a multiple of 64");
    const float2 f = ld2(p + ((2 * tx) ^ x));
    v[0] = f.x;
    v[1] = f.y;
  }
}

// acc[i][c] += Σ_{k < DEPTH} A[i][k] · B[k·LDB + col<W>(tx, c)]: ab for
// any W (32: two columns a thread, from 8-byte loads of B).
template <int R, int W, int DEPTH, int LDA, int LDB, bool SW = false>
__device__ __forceinline__ void abw(const float* __restrict__ A,
                                    const float* __restrict__ B,
                                    float (&acc)[R][W / 16]) {
  if constexpr (W % 64 == 0) {
    ab<R, W / 64, DEPTH, LDA, LDB, SW>(A, B, acc);
  } else {
    const int tx = threadIdx.x % kTX;
#pragma unroll 2
    for (int k = 0; k < DEPTH; k += 4) {
      float b[4][2];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        ld_cols<W>(B + (k + kk) * LDB, tx, swz<SW>(k + kk), b[kk]);
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float4 a = ld4(A + i * LDA + k);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = acc[i][e];
          x = fmaf(a.x, b[0][e], x);
          x = fmaf(a.y, b[1][e], x);
          x = fmaf(a.z, b[2][e], x);
          acc[i][e] = fmaf(a.w, b[3][e], x);
        }
      }
    }
  }
}

// acc[i][c] += Σ_{k < depth} A[k·LDA + i] · B[k·LDB + col<W>(tx, c)]
// (Aᵀ·B, summed in order of k): A points at row 0's entry of the thread's
// first row of the result (16-byte aligned), B at row 0.
template <int R, int W, int LDA, int LDB>
__device__ __forceinline__ void atb(const float* __restrict__ A,
                                    const float* __restrict__ B, int depth,
                                    float (&acc)[R][W / 16]) {
  static_assert(R % 4 == 0, "R rows as float4s");
  constexpr int C = W / 16;
  const int tx = threadIdx.x % kTX;
#pragma unroll 4
  for (int k = 0; k < depth; ++k) {
    float a[R], b[C];
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4 f = ld4(A + k * LDA + 4 * q);
      a[4 * q] = f.x;
      a[4 * q + 1] = f.y;
      a[4 * q + 2] = f.z;
      a[4 * q + 3] = f.w;
    }
    ld_cols<W>(B + k * LDB, tx, 0, b);
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
    }
  }
}

// Two floats to T at p (8-byte aligned for float, 4 for bf16).
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The thread's W / 16 columns of a result row (col<W>) to the row at p.
template <int W, typename T>
__device__ __forceinline__ void store_cols(T* p, int tx,
                                           const float (&v)[W / 16]) {
  if constexpr (W % 64 == 0) {
#pragma unroll
    for (int h = 0; h < W / 64; ++h) {
      store4(p + 64 * h + 4 * tx, v[4 * h], v[4 * h + 1], v[4 * h + 2],
             v[4 * h + 3]);
    }
  } else {
    store2(p + 2 * tx, v[0], v[1]);
  }
}

// Rows [0, n) of a row-major (rows, D) slab at `src` into a swizzled
// [ROWS][D] float tile; rows n .. ROWS-1 are zeros. Float32 by cp.async
// (the caller commits and waits), bf16 converted by plain loads.
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_tile_sw(float* __restrict__ dst,
                                             const float* __restrict__ src,
                                             int n) {
  constexpr int CPR = D / 4;
  for (int c = threadIdx.x; c < ROWS * CPR; c += NT) {
    const int r = c / CPR;
    const int d0 = (c % CPR) * 4;
    const bool ok = r < n;
    cp_async16(dst + r * D + (d0 ^ swz<true>(r)),
               ok ? src + (size_t)r * D + d0 : src, ok);
  }
}

template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_tile_sw(
    float* __restrict__ dst, const __nv_bfloat16* __restrict__ src, int n) {
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
    float* row = dst + r * D;
    store4(row + (d0 ^ swz<true>(r)), f[0], f[1], f[2], f[3]);
    store4(row + ((d0 + 4) ^ swz<true>(r)), f[4], f[5], f[6], f[7]);
  }
}

// dst[r][d] = src[r][d] · scale[r] for rows r < n, zeros after, as floats:
// a [ROWS][LD] tile from a row-major (rows, D) slab by plain 16-byte loads,
// kInFlight of them in flight per thread.
template <int ROWS, int D, int LD, int NT, typename T>
__device__ __forceinline__ void load_tile_scaled(
    float* __restrict__ dst, const T* __restrict__ src, int n,
    const float* __restrict__ scale) {
  constexpr int V = vec_len<T>();
  constexpr int CPR = D / V;
  constexpr int TOTAL = ROWS * CPR;
  for (int base = threadIdx.x; base < TOTAL; base += kInFlight * NT) {
    float f[kInFlight][V];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int c = base + u * NT;
      const int r = c / CPR;
      if (c < TOTAL && r < n) {
        load16(src + (size_t)r * D + (c % CPR) * V, f[u]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) f[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int c = base + u * NT;
      if (c < TOTAL) {
        const int r = c / CPR;
        const float s = r < n ? scale[r] : 0.f;
        float* o = dst + r * LD + (c % CPR) * V;
#pragma unroll
        for (int q = 0; q < V / 4; ++q) {
          store4(o + 4 * q, f[u][4 * q] * s, f[u][4 * q + 1] * s,
                 f[u][4 * q + 2] * s, f[u][4 * q + 3] * s);
        }
      }
    }
  }
}

// dst [COLS][ROWS] = the transpose of the float32 [ROWS][COLS] array at
// src: 16-byte loads along a row of src (consecutive threads on
// consecutive rows, so the scalar stores of a warp hit 32 banks), kInFlight
// of them in flight per thread.
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void stage_t(float* __restrict__ dst,
                                        const float* __restrict__ src) {
  constexpr int TOTAL = ROWS * COLS / 4;
  for (int base = threadIdx.x; base < TOTAL; base += kInFlight * NT) {
    float4 f[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int c = base + u * NT;
      if (c < TOTAL) {
        f[u] = ld4(src + (size_t)(c % ROWS) * COLS + 4 * (c / ROWS));
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int c = base + u * NT;
      if (c < TOTAL) {
        float* o = dst + 4 * (c / ROWS) * ROWS + c % ROWS;
        o[0] = f[u].x;
        o[ROWS] = f[u].y;
        o[2 * ROWS] = f[u].z;
        o[3 * ROWS] = f[u].w;
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

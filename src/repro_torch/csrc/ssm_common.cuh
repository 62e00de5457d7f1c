// Shared device code of K5 (ssm_scan.cu) and K5-bwd (ssm_scan_bwd.cu):
// the rows of a slab; the within-chunk cumulative decay, summed in float64
// by the same code in every pass of both, so that the backward's decays are
// the forward's; and the chunk's outer-product sum (P, N) = Σ_j (s_j a_j)ᵀ
// b_j of K5's float32 chunk states (a = x, s = w) and K5-bwd's dY·Cᵀ
// (a = dy, s = exp(cum)).
#pragma once

#include "flash_common.cuh"

namespace repro_torch {

// Rows of a slab (and of a tile the slab walks): the chunk when it is
// short, else 64.
__host__ __device__ constexpr int slab_rows(int L) {
  return L < 64 ? L : 64;
}

// dt of the chunk into dts[0, L) (0 past `valid`), then cum[j] = sum_{i<=j}
// dt_i * a in float64 by warp 0: L / 32 consecutive steps per lane, then a
// shuffle scan over the lanes' sums. Ends synchronised.
static __device__ void chunk_cumsum(const float* __restrict__ dtc, float a,
                             float* dts, double* cum, int valid, int L) {
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    dts[j] = j < valid ? dtc[j] : 0.f;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = L / 32;
    double g[4];
    double run = 0.0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < per) {
        run += (double)(dts[lane * per + k] * a);
        g[k] = run;
      }
    }
    double incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    const double base = incl - run;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < per) cum[lane * per + k] = base + g[k];
    }
  }
  __syncthreads();
}

// Let `kern` use the most shared memory an SM has, and `bytes` of it per
// block (the occupancy the kernel's launch bounds promise needs both).
template <typename Kernel>
bool prefer_smem(Kernel kern, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return true;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return false;
  return raise_smem_limit(kern, bytes, allowed);
}

// ------------------------------------------------ the chunk's outer sum
// out (P, N) = Σ_{j < valid} (s_j a_j)ᵀ b_j over a chunk's rows a (L, P) and
// b (L, N), a row-major in T, s [L] float in shared memory. Thread (ty, tx)
// owns rows p = 8ty .. 8ty+7 of the result and N/16 columns (tile::col), and
// sums over j in order on an atb micro-tile (8 x 8 at N = 128: 64 FMAs per
// 16 floats read); a and b sit in shared memory as they lie in device
// memory, so nothing is transposed. P / 8 row groups: 2P threads.
template <int P, int N, int L>
struct Outer {
  static constexpr int NT = P / 8 * tile::kTX;
  // cum [L] float64, dt and s [L], then a·s [L][P] and b [L][N]
  static constexpr size_t BYTES = (size_t)L * 16 + 4 * (size_t)L * (P + N);
};

// Shared memory of the outer sum, carved as its BYTES say.
struct OuterSmem {
  double* cum;
  float* dts;
  float* s;
  float* sa;
  float* sb;
};

template <int P, int N, int L>
__device__ __forceinline__ OuterSmem outer_smem(unsigned char* smem) {
  OuterSmem m;
  m.cum = reinterpret_cast<double*>(smem);
  m.dts = reinterpret_cast<float*>(m.cum + L);
  m.s = m.dts + L;
  m.sa = m.s + L;
  m.sb = m.sa + L * P;
  return m;
}

// The caller has started b's rows into m.sb (tile::load_tile, committed) and
// written s (synchronised); this stages a·s, waits for b and writes out.
template <int P, int N, int L, typename T>
__device__ __forceinline__ void outer_sum(const T* __restrict__ a,
                                          const OuterSmem& m, int valid,
                                          float* __restrict__ out) {
  constexpr int NT = Outer<P, N, L>::NT;
  tile::load_tile_scaled<L, P, P, NT>(m.sa, a, valid, m.s);
  tile::cp_async_wait<0>();
  __syncthreads();
  const int ty = threadIdx.x / tile::kTX, tx = threadIdx.x % tile::kTX;
  float acc[8][N / 16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int c = 0; c < N / 16; ++c) acc[i][c] = 0.f;
  }
  tile::atb<8, N, P, N>(m.sa + 8 * ty, m.sb, valid, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    tile::store_cols<N>(out + (size_t)(8 * ty + i) * N, tx, acc[i]);
  }
}

}  // namespace repro_torch

// Shared device code of K5 (ssm_scan.cu) and K5-bwd (ssm_scan_bwd.cu):
// the rows of a slab, and the within-chunk cumulative decay, summed in
// float64 by the same code in every pass of both, so that the backward's
// decays are the forward's.
#pragma once

#include "attention_common.cuh"

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

}  // namespace repro_torch

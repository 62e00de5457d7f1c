// K5: the Mamba2 SSD chunked scan, by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssm_scan.py (ssd_scan, body
// _ssd_kernel). Per chunk of L steps of one (lane, head): the within-chunk
// cumulative decay cum = cumsum(dt * A), an L x L score matrix
// att[i, j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j for j <= i (0 above the
// diagonal, which never reaches exp: there cum_i - cum_j > 0 and overflows),
// y = att @ x + exp(cum) * (C @ state^T), and the carried (P, N) state
// state <- exp(cum_L) * state + sum_j exp(cum_L - cum_j) dt_j x_j B_j^T.
// x (B, H, S, P) and y in the input type; dt (B, H, S) and A (H,) float32;
// B and C (B, S, N) shared by every head; the final state (B, H, P, N) f32.
// P is 32 or 64 and N 32, 64 or 128 (the reduced and full mamba2-130m and
// zamba2-1.2b), each pair its own instantiation.
//
// The TPU grid (B, H, chunks) walked the chunks in order and kept the state
// in VMEM scratch between grid steps. Blocks on this card run in no order,
// so one block owns one (lane, head) and loops over its chunks; each thread
// keeps its 4 x (4 N / P) share of the float32 state in registers, and a
// transposed copy goes to shared memory once per chunk for the C @ state
// term. A ragged tail is masked in the block, as the TPU wrapper's padding
// did: rows past S load as zeros with dt = 0 (an identity step with zero
// output) and are never stored.
//
// cum is summed in float64 (a warp scan over L values per chunk): every
// decay is exp(cum_i - cum_j), the difference of two sums that reach tens
// in magnitude, and in float32 that cancellation alone costs about 2e-5 on
// y at mamba2-130m's shapes, the whole float32 tolerance. The plain version
// does the same; everything else is float32.
//
// Shared memory, float32 whatever the input type: x [L][P], B and C
// [L][N + 4] (the padding makes lane j's row reads conflict-free), the
// transposed state [N][P], 32 rows of att at a time [32][L + 4] (the full
// L x L would not fit beside the tiles), cum [L] as float64, and dt, the
// carry weights and exp(cum) [L] each: 220,160 bytes at L = 128, P = 64,
// N = 128 (mamba2-130m), under the 227 KB a block may ask for; the limit is
// set per instantiation.
//
// Bound on this card: per (lane, head, chunk) 2L^2 N + 2L^2 P + 4LPN
// operations against x and y once, B and C once per (lane, chunk): about
// 1 GFLOP and 4 MB for one mamba2-130m layer at S = 512, so the card's
// bound is the bytes (~1.3 us). This version is far from it: the products
// are float32 FMA on the CUDA cores, and only B * H blocks run (24 for
// mamba2-130m and 64 for zamba2-1.2b at one lane, on 132 SMs). Splitting the
// chunks over blocks (chunk states in parallel, a short scan over chunks,
// then the outputs) and tensor-core tiles are later work (ROADMAP).
#include "attention_common.cuh"

namespace repro_torch {

constexpr int kSlab = 32;     // rows of att held at a time
constexpr int kPad = 4;       // row padding of the B, C and att tiles

// Floats of shared memory for head dim P, state dim N and chunk L.
template <int P, int N>
__host__ __device__ constexpr size_t ssd_smem_floats(int L) {
  return (size_t)L * P + 2 * (size_t)L * (N + kPad) + (size_t)N * P +
         (size_t)kSlab * (L + kPad) + 5 * (size_t)L;
}

// Rows [0, L) of a row-major (rows, W) tile at src into dst (row stride ld
// floats), as float32; rows at or past `valid` are zeros.
template <typename T>
__device__ void load_rows(float* __restrict__ dst, int ld,
                          const T* __restrict__ src, int W, int valid, int L) {
  constexpr int V = vec_len<T>();
  const int per_row = W / V;
  for (int c = threadIdx.x; c < L * per_row; c += blockDim.x) {
    const int r = c / per_row;
    const int col = (c - r * per_row) * V;
    float f[V];
    if (r < valid) {
      load16(src + (size_t)r * W + col, f);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) f[i] = 0.f;
    }
    float4* d = reinterpret_cast<float4*>(dst + (size_t)r * ld + col);
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      d[i] = make_float4(f[4 * i], f[4 * i + 1], f[4 * i + 2], f[4 * i + 3]);
    }
  }
}

// C consecutive values (C a multiple of 4, p aligned to 4 elements).
template <int C>
__device__ __forceinline__ void store_row(float* p, const float (&v)[C]) {
#pragma unroll
  for (int i = 0; i < C / 4; ++i) {
    reinterpret_cast<float4*>(p)[i] =
        make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
}
template <int C>
__device__ __forceinline__ void store_row(__nv_bfloat16* p,
                                          const float (&v)[C]) {
#pragma unroll
  for (int i = 0; i < C / 4; ++i) {
    uint2 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
    h[0] = __floats2bfloat162_rn(v[4 * i], v[4 * i + 1]);
    h[1] = __floats2bfloat162_rn(v[4 * i + 2], v[4 * i + 3]);
    reinterpret_cast<uint2*>(p)[i] = u;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y,
                float* __restrict__ final_state, int H, int S, int L) {
  constexpr int NB = N + kPad;      // row stride of the B and C tiles
  constexpr int CG = kThreads / (P / 4);  // column groups of the state
  constexpr int NG = N / CG;        // state columns per thread
  constexpr int CP = P / 8;         // output columns per thread
  static_assert(P * N == kThreads * 4 * NG, "state split over the block");
  static_assert(CP % 4 == 0, "output columns in float4s");
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int LB = L + kPad;          // row stride of att
  float* xs = smem;
  float* bs = xs + (size_t)L * P;
  float* cs = bs + (size_t)L * NB;
  float* st = cs + (size_t)L * NB;  // incoming state, transposed [N][P]
  float* att = st + (size_t)N * P;
  double* cum = reinterpret_cast<double*>(att + (size_t)kSlab * LB);
  float* dts = reinterpret_cast<float*>(cum + L);
  float* wts = dts + L;             // exp(cum_L - cum_j) * dt_j
  float* ecum = wts + L;            // exp(cum_i)

  const float a = A[h];
  const size_t bh = (size_t)b * H + h;
  const T* xbh = x + bh * S * P;
  const float* dtbh = dt + bh * S;
  const T* bb = Bm + (size_t)b * S * N;
  const T* cb = Cm + (size_t)b * S * N;
  T* ybh = y + bh * S * P;

  // this thread's share of the state: rows 4pg..4pg+3, columns NG*ng..
  const int pg = tid / CG;
  const int ng = tid % CG;
  float state[4][NG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < NG; ++k) state[i][k] = 0.f;
  }

  const int nc = (S + L - 1) / L;
  for (int c = 0; c < nc; ++c) {
    const int s0 = c * L;
    const int valid = min(L, S - s0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int k = 0; k < NG; ++k) st[(NG * ng + k) * P + 4 * pg + i] = state[i][k];
    }
    load_rows<T>(xs, P, xbh + (size_t)s0 * P, P, valid, L);
    load_rows<T>(bs, NB, bb + (size_t)s0 * N, N, valid, L);
    load_rows<T>(cs, NB, cb + (size_t)s0 * N, N, valid, L);
    for (int i = tid; i < L; i += blockDim.x) dts[i] = i < valid ? dtbh[s0 + i] : 0.f;
    __syncthreads();

    // cum = inclusive cumsum(dt * A) in float64: warp 0, L / 32
    // consecutive steps per lane, then a shuffle scan over the lanes' sums
    if (warp == 0) {
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
      const double total = __shfl_sync(kFull, incl, 31);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k < per) {
          const int j = lane * per + k;
          const double cj = base + g[k];
          cum[j] = cj;
          wts[j] = expf((float)(total - cj)) * dts[j];
          ecum[j] = expf((float)cj);
        }
      }
    }
    __syncthreads();

    // outputs, 32 rows at a time
    for (int s = 0; s * kSlab < valid; ++s) {
      const int i0 = s * kSlab;
      // att rows i0 + 4 warp .. +3 (one warp), columns lane + 32 jj, jj <= s
      // (blocks right of the slab's last row are all masked)
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[r][jj] = 0.f;
      }
      const float* crow = cs + (size_t)(i0 + 4 * warp) * NB;
      for (int n = 0; n < N; n += 4) {
        float4 cv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = ld4(crow + r * NB + n);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          if (jj <= s) {
            const float4 bv = ld4(bs + (size_t)(lane + 32 * jj) * NB + n);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              acc[r][jj] += cv[r].x * bv.x + cv[r].y * bv.y + cv[r].z * bv.z +
                            cv[r].w * bv.w;
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + 4 * warp + r;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          if (jj <= s) {
            const int j = lane + 32 * jj;
            att[(4 * warp + r) * LB + j] =
                j <= i ? acc[r][jj] * expf((float)(cum[i] - cum[j])) * dts[j]
                       : 0.f;
          }
        }
      }
      __syncthreads();

      // row i0 + tid / 8, columns CP (tid % 8) .. +CP-1
      const int r = tid >> 3;
      const int p0 = (tid & 7) * CP;
      const int i = i0 + r;
      float o[CP], q[CP];
#pragma unroll
      for (int k = 0; k < CP; ++k) o[k] = q[k] = 0.f;
      const float* arow = att + (size_t)r * LB;
      for (int j = 0; j < i0 + kSlab; ++j) {       // att is 0 past i
        const float aij = arow[j];
#pragma unroll
        for (int k = 0; k < CP; k += 4) {
          const float4 xv = ld4(xs + (size_t)j * P + p0 + k);
          o[k] += aij * xv.x; o[k + 1] += aij * xv.y;
          o[k + 2] += aij * xv.z; o[k + 3] += aij * xv.w;
        }
      }
      const float* ci = cs + (size_t)i * NB;
      for (int n = 0; n < N; ++n) {
        const float cn = ci[n];
#pragma unroll
        for (int k = 0; k < CP; k += 4) {
          const float4 sv = ld4(st + (size_t)n * P + p0 + k);
          q[k] += cn * sv.x; q[k + 1] += cn * sv.y;
          q[k + 2] += cn * sv.z; q[k + 3] += cn * sv.w;
        }
      }
      if (i < valid) {
        const float e = ecum[i];
#pragma unroll
        for (int k = 0; k < CP; ++k) o[k] += e * q[k];
        store_row<CP>(ybh + (size_t)(s0 + i) * P + p0, o);
      }
      __syncthreads();                             // att is rewritten next
    }

    // carry: state <- exp(cum_L) state + sum_j (w_j x_j) B_j^T
    const float decay = expf((float)cum[L - 1]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int k = 0; k < NG; ++k) state[i][k] *= decay;
    }
    for (int j = 0; j < valid; ++j) {
      const float wj = wts[j];
      const float4 xv = ld4(xs + (size_t)j * P + 4 * pg);
      const float xw[4] = {xv.x * wj, xv.y * wj, xv.z * wj, xv.w * wj};
      float bv[NG];
      const float* brow = bs + (size_t)j * NB + NG * ng;
      if constexpr (NG % 4 == 0) {
#pragma unroll
        for (int k = 0; k < NG; k += 4) {
          const float4 v = ld4(brow + k);
          bv[k] = v.x; bv[k + 1] = v.y; bv[k + 2] = v.z; bv[k + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int k = 0; k < NG; ++k) bv[k] = brow[k];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int k = 0; k < NG; ++k) state[i][k] += xw[i] * bv[k];
      }
    }
    __syncthreads();                               // tiles are reloaded next
  }

  float* fs = final_state + bh * P * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* row = fs + (size_t)(4 * pg + i) * N + NG * ng;
    if constexpr (NG % 4 == 0) {
      store_row<NG>(row, state[i]);
    } else {
#pragma unroll
      for (int k = 0; k < NG; ++k) row[k] = state[i][k];
    }
  }
}

template <typename T, int P, int N>
static int launch_ssd(const void* x, const float* dt, const float* A,
                      const void* Bm, const void* Cm, void* y, float* fs,
                      int B, int H, int S, int L, cudaStream_t stream) {
  const size_t smem = ssd_smem_floats<P, N>(L) * sizeof(float);
  auto kern = ssd_scan_kernel<T, P, N>;
  static size_t allowed = 0;
  if (!raise_smem_limit(kern, smem, allowed)) return (int)cudaGetLastError();
  dim3 grid(H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), fs, H, S, L);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

using namespace repro_torch;

// K5. dtype: 0 = float32, 1 = bfloat16 (x, B, C and y); dt, A and the final
// state are float32. P must be 32 or 64, state_dim 32, 64 or 128, chunk 32
// or 128. Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_ssd_scan(int dtype, int state_dim, const void* x,
                              const float* dt, const float* A, const void* Bm,
                              const void* Cm, void* y, float* final_state,
                              int B, int H, int S, int P, int chunk,
                              void* stream) {
  if (chunk != 32 && chunk != 128) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_SSD(T, PP, NN)                                                 \
  if (P == PP && state_dim == NN)                                            \
  return launch_ssd<T, PP, NN>(x, dt, A, Bm, Cm, y, final_state, B, H, S,    \
                               chunk, st)
#define REPRO_SSD_ALL(T)                                                     \
  REPRO_SSD(T, 32, 32); REPRO_SSD(T, 32, 64); REPRO_SSD(T, 32, 128);         \
  REPRO_SSD(T, 64, 32); REPRO_SSD(T, 64, 64); REPRO_SSD(T, 64, 128)
  if (dtype == 0) { REPRO_SSD_ALL(float); }
  if (dtype == 1) { REPRO_SSD_ALL(__nv_bfloat16); }
#undef REPRO_SSD_ALL
#undef REPRO_SSD
  return (int)cudaErrorInvalidValue;
}

// K5-bwd: the gradient of K5 (the Mamba2 SSD chunked scan), by hand for
// Hopper (sm_90a).
//
// The JAX package has no counterpart: its Pallas K5
// (repro/kernels/ssm_scan.py, ssd_scan, body _ssd_kernel) has no
// custom_vjp, and jax.grad through pallas_call raises, so its training takes
// gradients on the plain path. Here the gradient of K5's function is a
// kernel of its own, reached through a torch.autograd.Function whose forward
// is K5 and keeps K5's workspace: after K5's scan that holds S_in, the state
// entering each chunk, and each chunk's total decay, which this reads rather
// than recomputes.
//
// Function: per (lane, head) the scan y, S_final = SSD(x, dt, A, B, C) of
// ssm_scan.cu; given dY (B, H, S, P) in the input type and the final
// state's gradient (B, H, P, N) float32 or none, it returns dx, d(dt), dA,
// dB and dC. Per chunk of L steps, with cum = cumsum(dt·A) in float64 (the
// forward's code, ssm_common.cuh), E_ij = exp(cum_i − cum_j) for j <= i
// (never evaluated above the diagonal, where it overflows), T = cum_{L−1},
// w_j = exp(T − cum_j)·dt_j, G the gradient of the state leaving the chunk
// and M_ij = (dy_i·x_j)(C_i·B_j) E_ij dt_j:
//   dx_j  = Σ_{i>=j} (C_i·B_j) E_ij dt_j dy_i + w_j G B_j
//   dB_j  = Σ_{i>=j} (dy_i·x_j) E_ij dt_j C_i + w_j Gᵀ x_j
//   dC_i  = Σ_{j<=i} (dy_i·x_j) E_ij dt_j B_j + exp(cum_i) S_inᵀ dy_i
//   d(dt)_j = Σ_{i>=j} (dy_i·x_j)(C_i·B_j) E_ij + exp(T − cum_j) r_j
//             + dg_j A,  r_j = x_jᵀ G B_j
//   d(cum)_i = Σ_{j<=i} M_ij − Σ_{k>=i} M_ki + exp(cum_i) dy_i·(S_in C_i)
//             − w_i r_i, and at i = L − 1 also dT = exp(T)⟨G, S_in⟩ + Σ w r
//   dg = the reverse cumsum of d(cum) in float64; dA_h = Σ dg·dt.
// The chunk carry runs in reverse: G of the last chunk is the final state's
// gradient, and G_{c−1} = exp(T_c) G_c + Σ_i exp(cum_i) dy_i C_iᵀ.
//
// The TPU grid walked the chunks in order; here, as in the forward, the
// carry is split out so that every chunk runs at once. A call is six device
// kernels on one stream, with no atomics, so the gradients are the same
// bits from run to run:
//   A. ssd_bwd_dstate_kernel, per (chunk, head, lane): the chunk's
//      Σ_i exp(cum_i) dy_i C_iᵀ (P × N) into a float32 workspace;
//   B. ssd_bwd_state_scan_kernel, over (state slice, head, lane): the
//      reverse scan above, in place, each chunk left holding its G;
//   C1. ssd_bwd_keys_kernel, per (key slab, chunk, head, lane): dx, the
//      head's share of dB, the column sums of M, w·r and the direct d(dt)
//      of the slab's keys, over tiles of the rows i >= j;
//   C2. ssd_bwd_rows_kernel, per (row slab, chunk, head, lane): the head's
//      share of dC and the row sums of M plus exp(cum)·dy·(S_in C) of the
//      slab's rows, over tiles of the keys j <= i;
//   C3. ssd_bwd_finish_kernel, per (chunk, head, lane): ⟨G, S_in⟩, d(cum),
//      its reverse cumsum in float64, d(dt) and the (lane, chunk) share of
//      dA;
//   R. ssd_bwd_reduce_kernel: dB and dC summed over the heads (B and C are
//      shared by every head) and dA over lanes and chunks (A by every lane
//      and chunk), each in a fixed order.
// The wrapper allocates the float32 scratch: the state gradients (B, H,
// chunks, P, N), the heads' shares of dB and dC (B, H, S, N) each, four
// per-step terms (4, B, H, S) and the dA shares (B, H, chunks).
//
// Slabs and tiles are R = min(L, 64) rows: a whole L = 128 chunk of x, dy,
// B, C, S_in and G in float32 is 256 KB, over the 227 KB a block may have,
// so C1 keeps its key slab's x and B and walks tiles of dy and C rows, C2
// keeps its row slab's dy and C and walks tiles of x and B keys, and G (C1)
// or S_in (C2) takes the tiles' place once they are done. A block's 256
// threads form a 16 × 16 grid; thread (ty, tx) owns rows ty + 16a and
// columns tx + 16b of each product, so the 16 threads of a half warp share
// a row and reduce it by shuffles. Tiles sit in shared memory as float32
// rows padded by one word, so that a half warp reading 16 rows at one
// column hits 16 banks. Inputs are float32 or bfloat16 (loaded and
// converted); all arithmetic is float32 FMA on the CUDA cores (TF32 would
// miss the float32 gate), and the gradients are written in the inputs'
// types (d(dt) and dA float32). Rows past S load as zeros with dt = 0 and
// their gradients are never stored.
//
// Bound on this card: per (lane, head, chunk) five products over the
// causal pairs (C·Bᵀ, dY·Xᵀ, dx, dB and dC: 2·pairs·(3N + 2P)) and five
// of the state's size (the chunk's dY·Cᵀ, G B, Gᵀ x, S_in C and S_inᵀ dY:
// 10 L P N), against x, dy, dx, the workspace's S_in (each B·H·S·P) and B,
// C, dB, dC once: at mamba2-130m's training shape (B 8, S 512, H 24,
// P 64, N 128, L 128) ≈ 14.5 GFLOP against ≈ 0.11 GB a layer, so the
// float32 operations bound it (≈ 0.22 ms at 67 TFLOP/s). This first design
// recomputes C·Bᵀ and dY·Xᵀ in C1 and C2 and feeds FMA from shared memory
// (two loads per FMA pair), so it sits well above that bound.
#include "ssm_common.cuh"

namespace repro_torch {
namespace ssd_bwd {

constexpr int kT = 256;       // threads of a block: 16 x 16
constexpr int kScan = 256;    // threads of the reverse scan's block

template <int RA, int CB>
__device__ __forceinline__ void zero(float (&acc)[RA][CB]) {
#pragma unroll
  for (int a = 0; a < RA; ++a) {
#pragma unroll
    for (int b = 0; b < CB; ++b) acc[a][b] = 0.f;
  }
}

// Sum over the 16 threads of a half warp (one row of a product).
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// dst[r][0, W) (row stride W + 1, float) <- row r0 + r of the row-major
// (., W) array at src, times scale[r0 + r] when scale is given, for
// r < rows; rows at or past `valid` are zeros. 16-byte loads.
template <typename T, int W>
__device__ void load_tile(float* __restrict__ dst, const T* __restrict__ src,
                          int r0, int valid, int rows,
                          const float* __restrict__ scale) {
  constexpr int V = vec_len<T>();
  constexpr int CPR = W / V;
  for (int c = threadIdx.x; c < rows * CPR; c += blockDim.x) {
    const int r = c / CPR;
    const int d0 = (c - r * CPR) * V;
    float f[V];
    if (r0 + r < valid) {
      load16(src + (size_t)(r0 + r) * W + d0, f);
      if (scale != nullptr) {
        const float s = scale[r0 + r];
#pragma unroll
        for (int i = 0; i < V; ++i) f[i] *= s;
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) f[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) dst[r * (W + 1) + d0 + i] = f[i];
  }
}

// acc[a][b] += Σ_k A[ty + 16a][k] · B[tx + 16b][k]   (A·Bᵀ)
template <int RA, int CB, int K>
__device__ __forceinline__ void mm_abt(const float* __restrict__ A, int lda,
                                       const float* __restrict__ B, int ldb,
                                       float (&acc)[RA][CB]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[RA], bv[CB];
#pragma unroll
    for (int a = 0; a < RA; ++a) av[a] = A[(ty + 16 * a) * lda + k];
#pragma unroll
    for (int b = 0; b < CB; ++b) bv[b] = B[(tx + 16 * b) * ldb + k];
#pragma unroll
    for (int a = 0; a < RA; ++a) {
#pragma unroll
      for (int b = 0; b < CB; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
  }
}

// acc[a][b] += Σ_k A[ty + 16a][k] · B[k][tx + 16b]   (A·B)
template <int RA, int CB, int K>
__device__ __forceinline__ void mm_ab(const float* __restrict__ A, int lda,
                                      const float* __restrict__ B, int ldb,
                                      float (&acc)[RA][CB]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[RA], bv[CB];
#pragma unroll
    for (int a = 0; a < RA; ++a) av[a] = A[(ty + 16 * a) * lda + k];
#pragma unroll
    for (int b = 0; b < CB; ++b) bv[b] = B[k * ldb + tx + 16 * b];
#pragma unroll
    for (int a = 0; a < RA; ++a) {
#pragma unroll
      for (int b = 0; b < CB; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
  }
}

// acc[a][b] += Σ_k A[k][ty + 16a] · B[k][tx + 16b]   (Aᵀ·B)
template <int RA, int CB, int K>
__device__ __forceinline__ void mm_atb(const float* __restrict__ A, int lda,
                                       const float* __restrict__ B, int ldb,
                                       float (&acc)[RA][CB]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[RA], bv[CB];
#pragma unroll
    for (int a = 0; a < RA; ++a) av[a] = A[k * lda + ty + 16 * a];
#pragma unroll
    for (int b = 0; b < CB; ++b) bv[b] = B[k * ldb + tx + 16 * b];
#pragma unroll
    for (int a = 0; a < RA; ++a) {
#pragma unroll
      for (int b = 0; b < CB; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
  }
}

// ------------------------------------------------ A: each chunk's dY·Cᵀ
template <int P, int N, int L>
__host__ __device__ constexpr size_t dstate_smem() {
  return (size_t)L * 16 +
         4 * (size_t)slab_rows(L) * ((P + 1) + (N + 1));
}

// Thread (ty, tx) owns state rows p = ty + 16a and columns n = tx + 16b.
template <typename T, int P, int N, int L>
__global__ void __launch_bounds__(kT)
ssd_bwd_dstate_kernel(const T* __restrict__ dy, const float* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Cm,
                      float* __restrict__ dstates, int H, int S) {
  constexpr int TI = slab_rows(L);
  constexpr int LP = P + 1, LN = N + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int s0 = c * L;
  const int valid = min(L, S - s0);
  double* cum = reinterpret_cast<double*>(smem);
  float* dts = reinterpret_cast<float*>(cum + L);
  float* ecum = dts + L;
  float* dys = ecum + L;            // [TI][LP], rows scaled by exp(cum)
  float* cs = dys + TI * LP;        // [TI][LN]
  const size_t bh = (size_t)b * H + h;
  chunk_cumsum(dt + bh * S + s0, A[h], dts, cum, valid, L);
  for (int i = threadIdx.x; i < L; i += kT) ecum[i] = expf((float)cum[i]);
  float acc[P / 16][N / 16];
  zero(acc);
  const T* dyc = dy + (bh * S + s0) * P;
  const T* cc = Cm + ((size_t)b * S + s0) * N;
  for (int i0 = 0; i0 < valid; i0 += TI) {
    __syncthreads();   // ecum written; the previous tile consumed
    load_tile<T, P>(dys, dyc, i0, valid, TI, ecum);
    load_tile<T, N>(cs, cc, i0, valid, TI, nullptr);
    __syncthreads();
    mm_atb<P / 16, N / 16, TI>(dys, LP, cs, LN, acc);
  }
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float* o = dstates + (bh * nc + c) * (size_t)(P * N);
#pragma unroll
  for (int a = 0; a < P / 16; ++a) {
#pragma unroll
    for (int bb = 0; bb < N / 16; ++bb) {
      o[(size_t)(ty + 16 * a) * N + tx + 16 * bb] = acc[a][bb];
    }
  }
}

// ------------------------------------------------ B: the reverse scan
// Each thread owns 4 consecutive state elements of one (lane, head) and
// walks the chunks from the last: the chunk's dY·Cᵀ it reads is replaced by
// G, the gradient of the state leaving the chunk, and
// G_{c−1} = exp(T_c) G_c + (dY·Cᵀ)_c.
__global__ void __launch_bounds__(kScan)
ssd_bwd_state_scan_kernel(float* __restrict__ dstates,
                          const float* __restrict__ totals,
                          const float* __restrict__ dfinal, int nc, int PN) {
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (e >= PN) return;
  float* st = dstates + bh * nc * PN + e;
  const float* tot = totals + bh * nc;
  float4 g = dfinal != nullptr
                 ? *reinterpret_cast<const float4*>(dfinal + bh * PN + e)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = nc - 1; c >= 0; --c) {
    float4* p = reinterpret_cast<float4*>(st + (size_t)c * PN);
    const float4 loc = *p;
    *p = g;
    const float d = expf(tot[c]);
    g = make_float4(g.x * d + loc.x, g.y * d + loc.y, g.z * d + loc.z,
                    g.w * d + loc.w);
  }
}

// ------------------------------------------------ C1, C2: slabs
// Shared memory of C1 and C2: cum [L] float64 and dt [L], then float32
// tiles: the slab's two operands (R rows of P and of N), one (C2) or two
// (C1) R × R score tiles, and the walked tiles (R rows of P and of N) or,
// once they are done, the (P, N) state over them.
template <int P, int N, int L, int SCORE_TILES>
__host__ __device__ constexpr size_t slab_smem() {
  constexpr size_t R = slab_rows(L);
  constexpr size_t tiles = R * ((P + 1) + (N + 1));
  constexpr size_t state = (size_t)P * (N + 1);
  return (size_t)L * 12 +
         4 * (tiles + SCORE_TILES * R * (R + 1) +
              (tiles > state ? tiles : state));
}

// Per-step terms of the scratch `steps` (4, B, H, S).
enum Step { kColPart = 0, kWr = 1, kDirect = 2, kRowPart = 3 };

// C1. Thread (ty, tx) owns keys j = j0 + ty + 16a of the slab and, in each
// score tile, rows i = i0 + tx + 16b; scores are kept as [j][i].
template <typename T, int P, int N, int L>
__global__ void __launch_bounds__(kT, 1)
ssd_bwd_keys_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const T* __restrict__ dy,
                    const float* __restrict__ dstates, T* __restrict__ dx,
                    float* __restrict__ dB_part, float* __restrict__ steps,
                    int H, int S) {
  constexpr int R = slab_rows(L);
  constexpr int RA = R / 16, RB = R / 16;
  constexpr int LP = P + 1, LN = N + 1, LR = R + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int slabs = L / R;
  const int c = blockIdx.x / slabs;
  const int j0 = (blockIdx.x % slabs) * R;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x / slabs;
  const int s0 = c * L;
  const int valid = min(L, S - s0);
  if (j0 >= valid) return;          // a slab wholly past S keeps nothing
  double* cum = reinterpret_cast<double*>(smem);
  float* dts = reinterpret_cast<float*>(cum + L);
  float* xs = dts + L;              // [R][LP] the slab's x
  float* bs = xs + R * LP;          // [R][LN] the slab's B
  float* atts = bs + R * LN;        // [R][LR] att, [j][i]
  float* dss = atts + R * LR;       // [R][LR] (dy·x) E dt, [j][i]
  float* dys = dss + R * LR;        // [R][LP] a tile of dy rows
  float* cs = dys + R * LP;         // [R][LN] a tile of C rows
  float* gs = dys;                  // [P][LN] G, once the tiles are done
  const size_t bh = (size_t)b * H + h;
  const size_t xrow0 = bh * S + s0;            // x, dy, dB_part, steps
  const size_t brow0 = (size_t)b * S + s0;     // B, C
  chunk_cumsum(dt + bh * S + s0, A[h], dts, cum, valid, L);
  load_tile<T, P>(xs, x + xrow0 * P, j0, valid, R, nullptr);
  load_tile<T, N>(bs, Bm + brow0 * N, j0, valid, R, nullptr);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc_dx[RA][P / 16], acc_db[RA][N / 16];
  zero(acc_dx);
  zero(acc_db);
  float colm[RA], direct[RA];
#pragma unroll
  for (int a = 0; a < RA; ++a) colm[a] = direct[a] = 0.f;
  for (int i0 = j0; i0 < valid; i0 += R) {
    __syncthreads();   // the slab visible; the previous tile consumed
    load_tile<T, P>(dys, dy + xrow0 * P, i0, valid, R, nullptr);
    load_tile<T, N>(cs, Cm + brow0 * N, i0, valid, R, nullptr);
    __syncthreads();
    float cb[RA][RB], dyx[RA][RB];
    zero(cb);
    zero(dyx);
    mm_abt<RA, RB, N>(bs, LN, cs, LN, cb);      // B_j · C_i
    mm_abt<RA, RB, P>(xs, LP, dys, LP, dyx);    // x_j · dy_i
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const int jl = ty + 16 * a;
      const double cj = cum[j0 + jl];
      const float dtj = dts[j0 + jl];
#pragma unroll
      for (int bb = 0; bb < RB; ++bb) {
        const int il = tx + 16 * bb;
        float att = 0.f, dv = 0.f;
        if (j0 + jl <= i0 + il) {
          const float e = expf((float)(cum[i0 + il] - cj));
          const float ce = cb[a][bb] * e;
          att = ce * dtj;
          dv = dyx[a][bb] * e * dtj;
          colm[a] = fmaf(dyx[a][bb], att, colm[a]);
          direct[a] = fmaf(dyx[a][bb], ce, direct[a]);
        }
        atts[jl * LR + il] = att;
        dss[jl * LR + il] = dv;
      }
    }
    __syncthreads();
    mm_ab<RA, P / 16, R>(atts, LR, dys, LP, acc_dx);   // Σ_i att_ij dy_i
    mm_ab<RA, N / 16, R>(dss, LR, cs, LN, acc_db);     // Σ_i D_ij C_i
  }
  __syncthreads();     // the last tile consumed: G goes over it
  load_tile<float, N>(gs, dstates + (bh * nc + c) * (size_t)(P * N), 0, P, P,
                      nullptr);
  __syncthreads();
  const double T_ = cum[L - 1];
  float wj[RA], r[RA];
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int j = j0 + ty + 16 * a;
    wj[a] = expf((float)(T_ - cum[j])) * dts[j];
    r[a] = 0.f;
  }
  {
    float gb[RA][P / 16];                   // (G B_j)_p
    zero(gb);
    mm_abt<RA, P / 16, N>(bs, LN, gs, LN, gb);
#pragma unroll
    for (int a = 0; a < RA; ++a) {
#pragma unroll
      for (int bb = 0; bb < P / 16; ++bb) {
        r[a] = fmaf(xs[(ty + 16 * a) * LP + tx + 16 * bb], gb[a][bb], r[a]);
        acc_dx[a][bb] = fmaf(wj[a], gb[a][bb], acc_dx[a][bb]);
      }
    }
  }
  {
    float gx[RA][N / 16];                   // (Gᵀ x_j)_n
    zero(gx);
    mm_ab<RA, N / 16, P>(xs, LP, gs, LN, gx);
#pragma unroll
    for (int a = 0; a < RA; ++a) {
#pragma unroll
      for (int bb = 0; bb < N / 16; ++bb) {
        acc_db[a][bb] = fmaf(wj[a], gx[a][bb], acc_db[a][bb]);
      }
    }
  }
  const size_t bhs = (size_t)gridDim.z * H * S;
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const float cm = row_sum(colm[a]);
    const float dr = row_sum(direct[a]);
    const float rr = row_sum(r[a]);
    const int j = j0 + ty + 16 * a;
    if (j < valid) {
      const size_t at = xrow0 + j;
#pragma unroll
      for (int bb = 0; bb < P / 16; ++bb) {
        dx[at * P + tx + 16 * bb] = from_f32<T>(acc_dx[a][bb]);
      }
#pragma unroll
      for (int bb = 0; bb < N / 16; ++bb) {
        dB_part[at * N + tx + 16 * bb] = acc_db[a][bb];
      }
      if (tx == 0) {
        const float wr = wj[a] * rr;
        steps[kColPart * bhs + at] = -cm - wr;
        steps[kWr * bhs + at] = wr;
        steps[kDirect * bhs + at] = dr + expf((float)(T_ - cum[j])) * rr;
      }
    }
  }
}

// C2. Thread (ty, tx) owns rows i = i0 + ty + 16a of the slab and, in each
// score tile, keys j = j0 + tx + 16b; scores are kept as [i][j].
template <typename T, int P, int N, int L>
__global__ void __launch_bounds__(kT, 1)
ssd_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const T* __restrict__ dy,
                    const float* __restrict__ states,
                    float* __restrict__ dC_part, float* __restrict__ steps,
                    int H, int S) {
  constexpr int R = slab_rows(L);
  constexpr int RA = R / 16, RB = R / 16;
  constexpr int LP = P + 1, LN = N + 1, LR = R + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int slabs = L / R;
  const int c = blockIdx.x / slabs;
  const int i0 = (blockIdx.x % slabs) * R;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x / slabs;
  const int s0 = c * L;
  const int valid = min(L, S - s0);
  if (i0 >= valid) return;          // a slab wholly past S keeps nothing
  double* cum = reinterpret_cast<double*>(smem);
  float* dts = reinterpret_cast<float*>(cum + L);
  float* dys = dts + L;             // [R][LP] the slab's dy
  float* cs = dys + R * LP;         // [R][LN] the slab's C
  float* dss = cs + R * LN;         // [R][LR] (dy·x) E dt, [i][j]
  float* xs = dss + R * LR;         // [R][LP] a tile of x keys
  float* bs = xs + R * LP;          // [R][LN] a tile of B keys
  float* s_in = xs;                 // [P][LN] S_in, once the tiles are done
  const size_t bh = (size_t)b * H + h;
  const size_t xrow0 = bh * S + s0;
  const size_t brow0 = (size_t)b * S + s0;
  chunk_cumsum(dt + bh * S + s0, A[h], dts, cum, valid, L);
  load_tile<T, P>(dys, dy + xrow0 * P, i0, valid, R, nullptr);
  load_tile<T, N>(cs, Cm + brow0 * N, i0, valid, R, nullptr);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc_dc[RA][N / 16];
  zero(acc_dc);
  float rowm[RA], ein[RA];
#pragma unroll
  for (int a = 0; a < RA; ++a) rowm[a] = ein[a] = 0.f;
  for (int j0 = 0; j0 <= i0; j0 += R) {
    __syncthreads();   // the slab visible; the previous tile consumed
    load_tile<T, P>(xs, x + xrow0 * P, j0, valid, R, nullptr);
    load_tile<T, N>(bs, Bm + brow0 * N, j0, valid, R, nullptr);
    __syncthreads();
    float dyx[RA][RB], cb[RA][RB];
    zero(dyx);
    zero(cb);
    mm_abt<RA, RB, P>(dys, LP, xs, LP, dyx);    // dy_i · x_j
    mm_abt<RA, RB, N>(cs, LN, bs, LN, cb);      // C_i · B_j
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const int il = ty + 16 * a;
      const double ci = cum[i0 + il];
#pragma unroll
      for (int bb = 0; bb < RB; ++bb) {
        const int jl = tx + 16 * bb;
        float dv = 0.f;
        if (j0 + jl <= i0 + il) {
          const float e = expf((float)(ci - cum[j0 + jl]));
          dv = dyx[a][bb] * e * dts[j0 + jl];
          rowm[a] = fmaf(dv, cb[a][bb], rowm[a]);
        }
        dss[il * LR + jl] = dv;
      }
    }
    __syncthreads();
    mm_ab<RA, N / 16, R>(dss, LR, bs, LN, acc_dc);     // Σ_j D_ij B_j
  }
  if (c > 0) {                      // S_in of chunk 0 is 0
    __syncthreads();   // the last tile consumed: S_in goes over it
    load_tile<float, N>(s_in, states + (bh * nc + c) * (size_t)(P * N), 0, P,
                        P, nullptr);
    __syncthreads();
    float ec[RA];
#pragma unroll
    for (int a = 0; a < RA; ++a) ec[a] = expf((float)cum[i0 + ty + 16 * a]);
    {
      float sc[RA][P / 16];                 // (S_in C_i)_p
      zero(sc);
      mm_abt<RA, P / 16, N>(cs, LN, s_in, LN, sc);
#pragma unroll
      for (int a = 0; a < RA; ++a) {
#pragma unroll
        for (int bb = 0; bb < P / 16; ++bb) {
          ein[a] = fmaf(dys[(ty + 16 * a) * LP + tx + 16 * bb], sc[a][bb],
                        ein[a]);
        }
      }
    }
    {
      float sd[RA][N / 16];                 // (S_inᵀ dy_i)_n
      zero(sd);
      mm_ab<RA, N / 16, P>(dys, LP, s_in, LN, sd);
#pragma unroll
      for (int a = 0; a < RA; ++a) {
#pragma unroll
        for (int bb = 0; bb < N / 16; ++bb) {
          acc_dc[a][bb] = fmaf(ec[a], sd[a][bb], acc_dc[a][bb]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < RA; ++a) ein[a] = ec[a] * row_sum(ein[a]);
  }
  const size_t bhs = (size_t)gridDim.z * H * S;
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const float rm = row_sum(rowm[a]);
    const int i = i0 + ty + 16 * a;
    if (i < valid) {
      const size_t at = xrow0 + i;
#pragma unroll
      for (int bb = 0; bb < N / 16; ++bb) {
        dC_part[at * N + tx + 16 * bb] = acc_dc[a][bb];
      }
      if (tx == 0) steps[kRowPart * bhs + at] = rm + ein[a];
    }
  }
}

// ------------------------------------------------ C3: d(cum), d(dt), dA
// Warp 0 reverse-sums d(cum) in float64 from dT at the chunk's last step:
// L / 32 consecutive steps per lane, then a shuffle scan over the lanes.
template <int L>
__global__ void __launch_bounds__(kT)
ssd_bwd_finish_kernel(const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ states,
                      const float* __restrict__ totals,
                      const float* __restrict__ dstates,
                      const float* __restrict__ steps,
                      float* __restrict__ ddt, float* __restrict__ dA_part,
                      int H, int S, int PN) {
  __shared__ double cum[L];
  __shared__ float dts[L];
  __shared__ float warp_dot[kT / 32];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int s0 = c * L;
  const int valid = min(L, S - s0);
  const size_t bh = (size_t)b * H + h;
  const size_t bhs = (size_t)gridDim.z * H * S;
  chunk_cumsum(dt + bh * S + s0, A[h], dts, cum, valid, L);
  // ⟨G, S_in⟩ (S_in of chunk 0 is 0), in a fixed order
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float dot = 0.f;
  if (c > 0) {
    const float4* g = reinterpret_cast<const float4*>(
        dstates + (bh * nc + c) * (size_t)PN);
    const float4* s = reinterpret_cast<const float4*>(
        states + (bh * nc + c) * (size_t)PN);
    for (int e = threadIdx.x; e < PN / 4; e += kT) {
      const float4 gv = g[e], sv = s[e];
      dot = fmaf(gv.x, sv.x, dot);
      dot = fmaf(gv.y, sv.y, dot);
      dot = fmaf(gv.z, sv.z, dot);
      dot = fmaf(gv.w, sv.w, dot);
    }
  }
  dot = warp_sum(dot);
  if (lane == 0) warp_dot[warp] = dot;
  __syncthreads();
  if (warp != 0) return;
  double gsin = 0.0;
  for (int w = 0; w < kT / 32; ++w) gsin += warp_dot[w];
  const size_t at0 = bh * S + s0;
  const float* colp = steps + kColPart * bhs + at0;
  const float* wrp = steps + kWr * bhs + at0;
  const float* dirp = steps + kDirect * bhs + at0;
  const float* rowp = steps + kRowPart * bhs + at0;
  constexpr int per = L / 32;
  double dc[per], wr = 0.0, run = 0.0;
#pragma unroll
  for (int k = 0; k < per; ++k) {
    const int j = lane * per + k;
    dc[k] = j < valid ? (double)rowp[j] + (double)colp[j] : 0.0;
    wr += j < valid ? (double)wrp[j] : 0.0;
  }
  wr = warp_sum_d(wr);
  const double dT =
      (double)(expf(totals[bh * nc + c]) * (float)gsin) + wr;
  // suffix sums within the lane, then over the lanes after it
#pragma unroll
  for (int k = per - 1; k >= 0; --k) {
    run += dc[k];
    dc[k] = run;
  }
  double incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_down_sync(kFull, incl, o);
    if (lane + o < 32) incl += v;
  }
  const double after = incl - run;
  const float a = A[h];
  double part = 0.0;
#pragma unroll
  for (int k = 0; k < per; ++k) {
    const int j = lane * per + k;
    if (j < valid) {
      const float dg = (float)(dT + after + dc[k]);
      ddt[at0 + j] = dirp[j] + dg * a;
      part += (double)(dg * dts[j]);
    }
  }
  part = warp_sum_d(part);
  if (lane == 0) dA_part[bh * nc + c] = (float)part;
}

// ------------------------------------------------ R: sums over heads
// Thread t sums 4 consecutive (s, n) of one lane over the heads, in order;
// threads t < H also sum dA_h over lanes and chunks.
template <typename T>
__global__ void __launch_bounds__(kT)
ssd_bwd_reduce_kernel(const float* __restrict__ dB_part,
                      const float* __restrict__ dC_part,
                      const float* __restrict__ dA_part, T* __restrict__ dB,
                      T* __restrict__ dC, float* __restrict__ dA, int B, int H,
                      int S, int N, int nc) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t sn = (size_t)S * N;
  if (t < (size_t)B * sn / 4) {
    const size_t e = t * 4;
    const size_t b = e / sn, rest = e - b * sn;
    float sb[4] = {0.f, 0.f, 0.f, 0.f}, sc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int h = 0; h < H; ++h) {
      const size_t at = (b * H + h) * sn + rest;
      const float4 vb = *reinterpret_cast<const float4*>(dB_part + at);
      const float4 vc = *reinterpret_cast<const float4*>(dC_part + at);
      sb[0] += vb.x; sb[1] += vb.y; sb[2] += vb.z; sb[3] += vb.w;
      sc[0] += vc.x; sc[1] += vc.y; sc[2] += vc.z; sc[3] += vc.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dB[e + i] = from_f32<T>(sb[i]);
      dC[e + i] = from_f32<T>(sc[i]);
    }
  }
  if (t < (size_t)H) {
    double s = 0.0;
    for (int b = 0; b < B; ++b) {
      for (int c = 0; c < nc; ++c) s += dA_part[((size_t)b * H + t) * nc + c];
    }
    dA[t] = (float)s;
  }
}

// ------------------------------------------------ launch
template <typename T, int P, int N, int L>
static int launch(const void* x, const float* dt, const float* A,
                  const void* Bm, const void* Cm, const void* dy,
                  const float* dfinal, const float* states,
                  const float* totals, float* dstates, float* dB_part,
                  float* dC_part, float* steps, float* dA_part, void* dx,
                  float* ddt, float* dA, void* dB, void* dC, int B, int H,
                  int S, cudaStream_t st) {
  constexpr int R = slab_rows(L);
  const int nc = (S + L - 1) / L;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);
  const T* dyt = static_cast<const T*>(dy);
  // one record per kernel instantiation (each launcher is one)
  static size_t allowed_a = 0, allowed_k = 0, allowed_r = 0;
  auto ka = ssd_bwd_dstate_kernel<T, P, N, L>;
  auto kk = ssd_bwd_keys_kernel<T, P, N, L>;
  auto kr = ssd_bwd_rows_kernel<T, P, N, L>;
  constexpr size_t smem_a = dstate_smem<P, N, L>();
  constexpr size_t smem_k = slab_smem<P, N, L, 2>();
  constexpr size_t smem_r = slab_smem<P, N, L, 1>();
  if (!raise_smem_limit(ka, smem_a, allowed_a) ||
      !raise_smem_limit(kk, smem_k, allowed_k) ||
      !raise_smem_limit(kr, smem_r, allowed_r)) {
    return (int)cudaGetLastError();
  }
  const dim3 chunks(nc, H, B), slabs(nc * (L / R), H, B);
  ka<<<chunks, kT, smem_a, st>>>(dyt, dt, A, ct, dstates, H, S);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int per_block = kScan * 4;
  ssd_bwd_state_scan_kernel<<<dim3((P * N + per_block - 1) / per_block, H,
                                   B),
                              kScan, 0, st>>>(dstates, totals, dfinal, nc,
                                              P * N);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  kk<<<slabs, kT, smem_k, st>>>(xt, dt, A, bt, ct, dyt, dstates,
                                static_cast<T*>(dx), dB_part, steps, H, S);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  kr<<<slabs, kT, smem_r, st>>>(xt, dt, A, bt, ct, dyt, states, dC_part,
                                steps, H, S);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  ssd_bwd_finish_kernel<L><<<chunks, kT, 0, st>>>(
      dt, A, states, totals, dstates, steps, ddt, dA_part, H, S, P * N);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const size_t work = (size_t)B * S * N / 4 > (size_t)H
                          ? (size_t)B * S * N / 4
                          : (size_t)H;
  ssd_bwd_reduce_kernel<T><<<(unsigned)((work + kT - 1) / kT), kT, 0, st>>>(
      dB_part, dC_part, dA_part, static_cast<T*>(dB), static_cast<T*>(dC),
      dA, B, H, S, N, nc);
  return (int)cudaGetLastError();
}

}  // namespace ssd_bwd
}  // namespace repro_torch

using namespace repro_torch;

// K5-bwd. dtype: 0 = float32, 1 = bfloat16 (x, B, C, dy and dx, dB, dC);
// dt, A, the final state's gradient, d(dt) and dA are float32. P 32 or 64,
// state_dim 32, 64 or 128, chunk 32 or 128, as K5. dfinal may be null (the
// final state unused). states and totals: the workspace a K5 call on the
// same inputs filled (the state entering each chunk, each chunk's total
// decay). Scratch, float32: dstates (B, H, ceil(S / chunk), P, state_dim),
// dB_part and dC_part (B, H, S, state_dim), steps (4, B, H, S), dA_part
// (B, H, ceil(S / chunk)). Returns the cudaError_t of the first failed
// launch (0 on success).
extern "C" int repro_ssd_scan_bwd(
    int dtype, int state_dim, const void* x, const float* dt, const float* A,
    const void* Bm, const void* Cm, const void* dy, const float* dfinal,
    const float* states, const float* totals, float* dstates, float* dB_part,
    float* dC_part, float* steps, float* dA_part, void* dx, float* ddt,
    float* dA, void* dB, void* dC, int B, int H, int S, int P, int chunk,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_SSD_BWD(T, PP, NN, LL)                                         \
  if (P == PP && state_dim == NN && chunk == LL)                             \
  return ssd_bwd::launch<T, PP, NN, LL>(x, dt, A, Bm, Cm, dy, dfinal, states, \
                                        totals, dstates, dB_part, dC_part,   \
                                        steps, dA_part, dx, ddt, dA, dB, dC, \
                                        B, H, S, st)
#define REPRO_SSD_BWD_N(T, PP, LL)                                           \
  REPRO_SSD_BWD(T, PP, 32, LL); REPRO_SSD_BWD(T, PP, 64, LL);                \
  REPRO_SSD_BWD(T, PP, 128, LL)
#define REPRO_SSD_BWD_ALL(T)                                                 \
  REPRO_SSD_BWD_N(T, 32, 32); REPRO_SSD_BWD_N(T, 64, 32);                    \
  REPRO_SSD_BWD_N(T, 32, 128); REPRO_SSD_BWD_N(T, 64, 128)
  if (dtype == 0) { REPRO_SSD_BWD_ALL(float); }
  if (dtype == 1) { REPRO_SSD_BWD_ALL(__nv_bfloat16); }
#undef REPRO_SSD_BWD_ALL
#undef REPRO_SSD_BWD_N
#undef REPRO_SSD_BWD
  return (int)cudaErrorInvalidValue;
}

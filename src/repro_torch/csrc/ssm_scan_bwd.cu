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
// keeps its row slab's dy and C and walks tiles of x and B keys, and G and
// Gᵀ (C1) or S_in and S_inᵀ (C2) take the tiles' place once they are done.
// v2 runs every product on the register micro-tiles of flash_common.cuh
// that K1-bwd uses: a block of 2R threads, thread (ty, tx) owning slab rows
// 8ty .. 8ty+7 and, in each R x R score tile, the columns tx + 16q, so the
// 16 threads of a half warp share a row and reduce it by shuffles after
// the products. Scores come from abt (8 x R/16 a thread), the sums over a
// tile from abw (8 x P/16 or N/16), the state's products from abw on the
// state or its transpose, and A from the outer sum of ssm_common.cuh, all
// from 16-byte shared loads; the walked tiles arrive by cp.async, each
// refilled as soon as its last product has read it. At P 64 / N 128 /
// L 128, C1 and C2 hold 115,712 bytes: two blocks (8 warps) to an SM.
// Inputs are float32 or bfloat16 (converted to float32 on the way in);
// all arithmetic is float32 FMA on the CUDA cores (TF32 would miss the
// float32 gate), and the gradients are written in the inputs' types (d(dt)
// and dA float32). Rows past S load as zeros with dt = 0 and their
// gradients are never stored.
//
// Bound on this card: per (lane, head, chunk) five products over the
// causal pairs (C·Bᵀ, dY·Xᵀ, dx, dB and dC: 2·pairs·(3N + 2P)) and five
// of the state's size (the chunk's dY·Cᵀ, G B, Gᵀ x, S_in C and S_inᵀ dY:
// 10 L P N), against x, dy, dx, the workspace's S_in (each B·H·S·P) and B,
// C, dB, dC once: at mamba2-130m's training shape (B 8, S 512, H 24,
// P 64, N 128, L 128) ≈ 14.5 GFLOP against ≈ 0.11 GB a layer, so the
// float32 operations bound it (≈ 0.22 ms at 67 TFLOP/s). C1 forms C·Bᵀ and
// dY·Xᵀ and C2 dY·Xᵀ again (six products over the pairs where the bound
// counts five), over whole R x R tiles on the diagonal. M's sums need no
// product of their own: its row sum is C_i · Σ_j D_ij B_j (C2's dC term
// before S_in's), its column sum dt_j times B_j · Σ_i u_ji C_i (C1's dB
// term before dt_j and G's).
#include "ssm_common.cuh"

namespace repro_torch {
namespace ssd_bwd {

constexpr int kT = 256;       // threads of C3's and R's blocks
constexpr int kScan = 256;    // threads of the reverse scan's block

template <int RA, int CB>
__device__ __forceinline__ void zero(float (&acc)[RA][CB]) {
#pragma unroll
  for (int a = 0; a < RA; ++a) {
#pragma unroll
    for (int b = 0; b < CB; ++b) acc[a][b] = 0.f;
  }
}

__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// ------------------------------------------------ A: each chunk's dY·Cᵀ
// Σ_i exp(cum_i) dy_i C_iᵀ on the outer sum of ssm_common.cuh (K5's float32
// chunk-state pass with dy for x and exp(cum) for w).
template <typename T, int P, int N, int L>
__global__ void __launch_bounds__(Outer<P, N, L>::NT, 2)
ssd_bwd_dstate_kernel(const T* __restrict__ dy, const float* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Cm,
                      float* __restrict__ dstates, int H, int S) {
  constexpr int NT = Outer<P, N, L>::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  const OuterSmem m = outer_smem<P, N, L>(smem);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int s0 = c * L;
  const int valid = min(L, S - s0);
  const size_t bh = (size_t)b * H + h;
  tile::load_tile<L, N, N, NT>(m.sb, Cm + ((size_t)b * S + s0) * N, valid);
  tile::cp_async_commit();
  chunk_cumsum(dt + bh * S + s0, A[h], m.dts, m.cum, valid, L);
  for (int i = threadIdx.x; i < L; i += NT) m.s[i] = expf((float)m.cum[i]);
  __syncthreads();
  outer_sum<P, N, L>(dy + (bh * S + s0) * P, m, valid,
                     dstates + (bh * nc + c) * (size_t)(P * N));
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
// Thread (ty, tx) owns slab rows 8ty .. 8ty+7 (keys in C1, rows in C2) of
// every product, and in each score tile the columns tx + 16q (abt); 2R
// threads. The slab's two operands sit in shared memory as they lie in
// device memory (abt and abw read them as A); the walked tiles are
// swizzled (abt and abw read them as B); the score tile is [R][R]. Once the
// walk is done the state (G or S_in) and its transpose take the walked
// tiles' place. At P 64 / N 128 / L 128 that is 115,712 bytes, two blocks
// to an SM to the byte, which is why the walked tiles are swizzled rather
// than padded and dt is read where it is needed rather than kept.
template <int P, int N, int L>
struct Slab {
  static constexpr int R = slab_rows(L);
  static constexpr int NT = R / 8 * tile::kTX;
  static constexpr int NJ = R / tile::kTX;     // score columns a thread
  static constexpr size_t WALK = (size_t)R * (P + N + R);
  static constexpr size_t POST = 2 * (size_t)P * N;
  static constexpr size_t REGION = WALK > POST ? WALK : POST;
  // cum [L] float64, the slab's operands [R][P] and [R][N], the region
  static constexpr size_t BYTES =
      (size_t)L * 8 + 4 * ((size_t)R * (P + N) + REGION);
};

// Per-step terms of the scratch `steps` (4, B, H, S).
enum Step { kColPart = 0, kWr = 1, kDirect = 2, kRowPart = 3 };

// C1: the key slab j0 .. j0+R-1 against the tiles of rows i0 >= j0; scores
// are kept as [j][i]. Per tile, u = (x_j·dy_i) E_ij goes through the score
// tile into Σ_i u_ji C_i and then v = (B_j·C_i) E_ij into Σ_i v_ji dy_i, so
// only one score tile is ever live in registers; dt_j scales both sums
// once the walk is done, and the direct term of d(dt), Σ_i (dy_i·x_j)
// (C_i·B_j) E_ij, is B_j · Σ_i u_ji C_i: no third pass over the scores.
template <typename T, int P, int N, int L>
__global__ void __launch_bounds__(Slab<P, N, L>::NT, 2)
ssd_bwd_keys_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const T* __restrict__ dy,
                    const float* __restrict__ dstates, T* __restrict__ dx,
                    float* __restrict__ dB_part, float* __restrict__ steps,
                    int H, int S) {
  using Sl = Slab<P, N, L>;
  constexpr int R = Sl::R, NT = Sl::NT, NJ = Sl::NJ;
  constexpr int CP = P / 16, CN = N / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int slabs = L / R;
  const int c = blockIdx.x / slabs;
  const int j0 = (blockIdx.x % slabs) * R;   // slab 0 walks the most: first
  const int h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x / slabs;
  const int s0 = c * L;
  const int valid = min(L, S - s0);
  if (j0 >= valid) return;          // a slab wholly past S keeps nothing
  double* cum = reinterpret_cast<double*>(smem);
  float* xs = reinterpret_cast<float*>(cum + L);   // [R][P] the slab's x
  float* bs = xs + R * P;           // [R][N] the slab's B
  float* dys = bs + R * N;          // [R][P] swizzled: a tile of dy rows
  float* cs = dys + R * P;          // [R][N] swizzled: a tile of C rows
  float* ss = cs + R * N;           // [R][R] u, then v
  float* gs = dys;                  // [P][N] G, once the walk is done
  float* gts = gs + P * N;          // [N][P] Gᵀ
  const size_t bh = (size_t)b * H + h;
  const size_t xrow0 = bh * S + s0;            // x, dy, dB_part, steps
  const size_t brow0 = (size_t)b * S + s0;     // B, C
  const float* dtc = dt + bh * S + s0;
  const int ty = threadIdx.x / tile::kTX, tx = threadIdx.x % tile::kTX;
  const int jr = 8 * ty;            // the thread's first key in the slab
  tile::load_tile<R, P, P, NT>(xs, x + (xrow0 + j0) * P, valid - j0);
  tile::load_tile<R, N, N, NT>(bs, Bm + (brow0 + j0) * N, valid - j0);
  tile::load_tile_sw<R, P, NT>(dys, dy + (xrow0 + j0) * P, valid - j0);
  tile::cp_async_commit();
  tile::load_tile_sw<R, N, NT>(cs, Cm + (brow0 + j0) * N, valid - j0);
  tile::cp_async_commit();
  chunk_cumsum(dtc, A[h], ss, cum, valid, L);   // dt's scratch: the score tile

  // Σ_i v_ji dy_i and Σ_i u_ji C_i, dt_j not yet applied
  float acc_dx[8][CP], acc_db[8][CN];
  zero(acc_dx);
  zero(acc_db);
  const int n_tiles = (valid - j0 + R - 1) / R;
  for (int t = 0; t < n_tiles; ++t) {
    const int i0 = j0 + t * R;
    const bool more = t + 1 < n_tiles;
    if (t == 0) {
      tile::cp_async_wait<1>();     // the slab and this dy tile
    } else {
      tile::cp_async_wait<0>();     // this dy tile (and C's, loaded before)
    }
    __syncthreads();
    float sc[8][NJ];
    zero(sc);
    tile::abt<8, NJ, P, P, P, true>(xs + jr * P, dys, sc);    // x_j · dy_i
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int jl = jr + a;
      const double cj = cum[j0 + jl];
#pragma unroll
      for (int q = 0; q < NJ; ++q) {
        const int il = tx + tile::kTX * q;
        ss[jl * R + il] = j0 + jl <= i0 + il
            ? sc[a][q] * expf((float)(cum[i0 + il] - cj)) : 0.f;   // u
      }
    }
    tile::cp_async_wait<0>();       // this C tile
    __syncthreads();                // u visible
    tile::abw<8, N, R, R, N, true>(ss + jr * R, cs, acc_db);   // Σ u_ji C_i
    __syncthreads();                // every thread has read u
    zero(sc);
    tile::abt<8, NJ, N, N, N, true>(bs + jr * N, cs, sc);     // B_j · C_i
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int jl = jr + a;
      const double cj = cum[j0 + jl];
#pragma unroll
      for (int q = 0; q < NJ; ++q) {
        const int il = tx + tile::kTX * q;
        ss[jl * R + il] = j0 + jl <= i0 + il
            ? sc[a][q] * expf((float)(cum[i0 + il] - cj)) : 0.f;   // v
      }
    }
    __syncthreads();                // v visible; every thread has read C
    if (more) {
      tile::load_tile_sw<R, N, NT>(cs, Cm + (brow0 + i0 + R) * N,
                                   valid - i0 - R);
      tile::cp_async_commit();
    }
    tile::abw<8, P, R, R, P, true>(ss + jr * R, dys, acc_dx);  // Σ v_ji dy_i
    __syncthreads();                // every thread has read v and dy
    if (more) {
      tile::load_tile_sw<R, P, NT>(dys, dy + (xrow0 + i0 + R) * P,
                                   valid - i0 - R);
      tile::cp_async_commit();
    }
  }
  // G and Gᵀ over the walked tiles (the walk ended on a barrier)
  const float* gc = dstates + (bh * nc + c) * (size_t)(P * N);
  tile::load_tile<P, N, N, NT>(gs, gc, P);
  tile::cp_async_commit();
  tile::stage_t<P, N, NT>(gts, gc);
  const double T_ = cum[L - 1];
  float dtj[8], wj[8], direct[8], r[8];
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int j = j0 + jr + a;
    dtj[a] = j < valid ? dtc[j] : 0.f;
    wj[a] = expf((float)(T_ - cum[j])) * dtj[a];
    direct[a] = r[a] = 0.f;
#pragma unroll
    for (int q = 0; q < CN; ++q) {  // B_j · Σ_i u_ji C_i, then dt_j
      direct[a] = fmaf(bs[(jr + a) * N + tile::col<N>(tx, q)], acc_db[a][q],
                       direct[a]);
      acc_db[a][q] *= dtj[a];
    }
#pragma unroll
    for (int q = 0; q < CP; ++q) acc_dx[a][q] *= dtj[a];
  }
  tile::cp_async_wait<0>();
  __syncthreads();
  {
    float gb[8][CP];                // (G B_j)_p
    zero(gb);
    tile::abw<8, P, N, N, P>(bs + jr * N, gts, gb);
#pragma unroll
    for (int a = 0; a < 8; ++a) {
#pragma unroll
      for (int q = 0; q < CP; ++q) {
        r[a] = fmaf(xs[(jr + a) * P + tile::col<P>(tx, q)], gb[a][q], r[a]);
        acc_dx[a][q] = fmaf(wj[a], gb[a][q], acc_dx[a][q]);
      }
    }
  }
  __syncthreads();                  // every thread has read x for r
  // x_j ← w_j x_j in place (each element by the thread that owns its
  // column), then dB_j += Gᵀ (w_j x_j) into the same accumulators
#pragma unroll
  for (int a = 0; a < 8; ++a) {
#pragma unroll
    for (int q = 0; q < CP; ++q) {
      xs[(jr + a) * P + tile::col<P>(tx, q)] *= wj[a];
    }
  }
  __syncthreads();
  tile::abw<8, N, P, P, N>(xs + jr * P, gs, acc_db);
  const size_t bhs = (size_t)gridDim.z * H * S;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const float dr = tile::row_sum16(direct[a]);
    const float rr = tile::row_sum16(r[a]);
    const int j = j0 + jr + a;
    if (j < valid) {
      const size_t at = xrow0 + j;
      tile::store_cols<P>(dx + at * P, tx, acc_dx[a]);
      tile::store_cols<N>(dB_part + at * N, tx, acc_db[a]);
      if (tx == 0) {
        const float wr = wj[a] * rr;
        steps[kColPart * bhs + at] = -dtj[a] * dr - wr;
        steps[kWr * bhs + at] = wr;
        steps[kDirect * bhs + at] = dr + expf((float)(T_ - cum[j])) * rr;
      }
    }
  }
}

// C2: the row slab i0 .. i0+R-1 against the tiles of keys j0 <= i0;
// scores are kept as [i][j]. D = (dy_i·x_j) E_ij dt_j goes through the
// score tile into Σ_j D_ij B_j; the row sum of M, Σ_j D_ij (C_i·B_j), is
// C_i · Σ_j D_ij B_j, so C2 forms no C·Bᵀ.
template <typename T, int P, int N, int L>
__global__ void __launch_bounds__(Slab<P, N, L>::NT, 2)
ssd_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const T* __restrict__ dy,
                    const float* __restrict__ states,
                    float* __restrict__ dC_part, float* __restrict__ steps,
                    int H, int S) {
  using Sl = Slab<P, N, L>;
  constexpr int R = Sl::R, NT = Sl::NT, NJ = Sl::NJ;
  constexpr int CP = P / 16, CN = N / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int slabs = L / R;
  const int c = blockIdx.x / slabs;
  const int slab = slabs - 1 - (int)blockIdx.x % slabs;   // longest first
  const int i0 = slab * R;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x / slabs;
  const int s0 = c * L;
  const int valid = min(L, S - s0);
  if (i0 >= valid) return;          // a slab wholly past S keeps nothing
  double* cum = reinterpret_cast<double*>(smem);
  float* dys = reinterpret_cast<float*>(cum + L);  // [R][P] the slab's dy
  float* cs = dys + R * P;          // [R][N] the slab's C
  float* xs = cs + R * N;           // [R][P] swizzled: a tile of x keys
  float* bs = xs + R * P;           // [R][N] swizzled: a tile of B keys
  float* ss = bs + R * N;           // [R][R] D
  float* sin_ = xs;                 // [P][N] S_in, once the walk is done
  float* sint = sin_ + P * N;       // [N][P] S_inᵀ
  const size_t bh = (size_t)b * H + h;
  const size_t xrow0 = bh * S + s0;
  const size_t brow0 = (size_t)b * S + s0;
  const float* dtc = dt + bh * S + s0;
  const int ty = threadIdx.x / tile::kTX, tx = threadIdx.x % tile::kTX;
  const int ir = 8 * ty;            // the thread's first row in the slab
  tile::load_tile<R, P, P, NT>(dys, dy + (xrow0 + i0) * P, valid - i0);
  tile::load_tile<R, N, N, NT>(cs, Cm + (brow0 + i0) * N, valid - i0);
  tile::load_tile_sw<R, P, NT>(xs, x + xrow0 * P, valid);
  tile::cp_async_commit();
  tile::load_tile_sw<R, N, NT>(bs, Bm + brow0 * N, valid);
  tile::cp_async_commit();
  chunk_cumsum(dtc, A[h], ss, cum, valid, L);   // dt's scratch: the score tile

  float acc_dc[8][CN];
  zero(acc_dc);
  for (int t = 0; t <= slab; ++t) { // key tiles 0 .. slab
    const int j0 = t * R;
    const bool more = t < slab;
    float dtk[NJ];                  // dt of the thread's keys, 0 past S
#pragma unroll
    for (int q = 0; q < NJ; ++q) {
      const int j = j0 + tx + tile::kTX * q;
      dtk[q] = j < valid ? dtc[j] : 0.f;
    }
    tile::cp_async_wait<1>();       // the slab and this x tile
    __syncthreads();
    float sc[8][NJ];
    zero(sc);
    tile::abt<8, NJ, P, P, P, true>(dys + ir * P, xs, sc);    // dy_i · x_j
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int il = ir + a;
      const double ci = cum[i0 + il];
#pragma unroll
      for (int q = 0; q < NJ; ++q) {
        const int jl = tx + tile::kTX * q;
        ss[il * R + jl] = j0 + jl <= i0 + il
            ? sc[a][q] * expf((float)(ci - cum[j0 + jl])) * dtk[q] : 0.f;
      }
    }
    tile::cp_async_wait<0>();       // this B tile
    __syncthreads();                // D visible; every thread has read x
    if (more) {
      tile::load_tile_sw<R, P, NT>(xs, x + (xrow0 + j0 + R) * P,
                                   valid - j0 - R);
      tile::cp_async_commit();
    }
    tile::abw<8, N, R, R, N, true>(ss + ir * R, bs, acc_dc);   // Σ D_ij B_j
    __syncthreads();                // every thread has read D and B
    if (more) {
      tile::load_tile_sw<R, N, NT>(bs, Bm + (brow0 + j0 + R) * N,
                                   valid - j0 - R);
      tile::cp_async_commit();
    }
  }
  float rowm[8], ein[8];            // C_i · Σ_j D_ij B_j; the S_in term
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    rowm[a] = ein[a] = 0.f;
#pragma unroll
    for (int q = 0; q < CN; ++q) {
      rowm[a] = fmaf(cs[(ir + a) * N + tile::col<N>(tx, q)], acc_dc[a][q],
                     rowm[a]);
    }
  }
  if (c > 0) {                      // S_in of chunk 0 is 0
    // S_in and S_inᵀ over the walked tiles (the walk ended on a barrier)
    const float* sc0 = states + (bh * nc + c) * (size_t)(P * N);
    tile::load_tile<P, N, N, NT>(sin_, sc0, P);
    tile::cp_async_commit();
    tile::stage_t<P, N, NT>(sint, sc0);
    tile::cp_async_wait<0>();
    __syncthreads();
    float ec[8];
#pragma unroll
    for (int a = 0; a < 8; ++a) ec[a] = expf((float)cum[i0 + ir + a]);
    {
      float sc[8][CP];              // (S_in C_i)_p
      zero(sc);
      tile::abw<8, P, N, N, P>(cs + ir * N, sint, sc);
#pragma unroll
      for (int a = 0; a < 8; ++a) {
#pragma unroll
        for (int q = 0; q < CP; ++q) {
          ein[a] = fmaf(dys[(ir + a) * P + tile::col<P>(tx, q)], sc[a][q],
                        ein[a]);
        }
      }
    }
    {
      float sd[8][CN];              // (S_inᵀ dy_i)_n
      zero(sd);
      tile::abw<8, N, P, P, N>(dys + ir * P, sin_, sd);
#pragma unroll
      for (int a = 0; a < 8; ++a) {
#pragma unroll
        for (int q = 0; q < CN; ++q) {
          acc_dc[a][q] = fmaf(ec[a], sd[a][q], acc_dc[a][q]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) ein[a] = ec[a] * tile::row_sum16(ein[a]);
  }
  const size_t bhs = (size_t)gridDim.z * H * S;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const float rm = tile::row_sum16(rowm[a]);
    const int i = i0 + ir + a;
    if (i < valid) {
      const size_t at = xrow0 + i;
      tile::store_cols<N>(dC_part + at * N, tx, acc_dc[a]);
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
  using Sl = Slab<P, N, L>;
  using Ou = Outer<P, N, L>;
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
  if (!prefer_smem(ka, Ou::BYTES, allowed_a) ||
      !prefer_smem(kk, Sl::BYTES, allowed_k) ||
      !prefer_smem(kr, Sl::BYTES, allowed_r)) {
    return (int)cudaGetLastError();
  }
  const dim3 chunks(nc, H, B), slabs(nc * (L / Sl::R), H, B);
  ka<<<chunks, Ou::NT, Ou::BYTES, st>>>(dyt, dt, A, ct, dstates, H, S);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int per_block = kScan * 4;
  ssd_bwd_state_scan_kernel<<<dim3((P * N + per_block - 1) / per_block, H,
                                   B),
                              kScan, 0, st>>>(dstates, totals, dfinal, nc,
                                              P * N);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  kk<<<slabs, Sl::NT, Sl::BYTES, st>>>(xt, dt, A, bt, ct, dyt, dstates,
                                       static_cast<T*>(dx), dB_part, steps,
                                       H, S);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  kr<<<slabs, Sl::NT, Sl::BYTES, st>>>(xt, dt, A, bt, ct, dyt, states,
                                       dC_part, steps, H, S);
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

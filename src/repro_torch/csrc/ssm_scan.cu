// K5: the Mamba2 SSD chunked scan, by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssm_scan.py (ssd_scan, body
// _ssd_kernel). Per chunk of L steps of one (lane, head): the within-chunk
// cumulative decay cum = cumsum(dt * A), the scores
// att[i, j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j for j <= i (0 above the
// diagonal, which never reaches exp: there cum_i - cum_j > 0 and overflows),
// y = att @ x + exp(cum) * (C @ S_in^T) with S_in the state entering the
// chunk, and the carried (P, N) state
// S_out = exp(cum_L) * S_in + sum_j exp(cum_L - cum_j) dt_j x_j B_j^T.
// x (B, H, S, P) and y in the input type; dt (B, H, S) and A (H,) float32;
// B and C (B, S, N) shared by every head; the final state (B, H, P, N) f32.
// P is 32 or 64, N 32, 64 or 128 and L 32 or 128 (the reduced and full
// mamba2-130m and zamba2-1.2b), each triple its own instantiation.
//
// The TPU grid (B, H, chunks) walked the chunks in order and carried the
// state in VMEM scratch. Blocks on this card run in no order, and one block
// per (lane, head) walking its chunks left most of the 132 SMs idle (24
// blocks for mamba2-130m at one lane). Here the carry is split out, as in
// the chunked plain version, and a call is three device kernels on one
// stream:
//   1. ssd_chunk_state_kernel (float32: ssd_chunk_state_f32), one block per
//      (chunk, head, lane): cum, the chunk's total decay and its local
//      state (x * w)^T @ B with w_j = exp(cum_L - cum_j) dt_j, written to a
//      float32 workspace (B, H, chunks, P, N) beside the totals (B, H,
//      chunks);
//   2. ssd_state_scan_kernel, over (state slice, head, lane): the scan
//      S_c = exp(total_c) S_{c-1} + local_c, elementwise in float32, which
//      overwrites each chunk's local state with the state entering it and
//      writes the final state;
//   3. ssd_output_kernel (float32: ssd_output_f32), one block per (row
//      slab, chunk, head, lane), R = 64 rows (32 at L = 32): y for the
//      slab's rows from C @ B^T, att @ x and C @ S_in^T.
// So every chunk runs at once: 96 + 24 * 8 + 192 blocks (mamba2-130m) and
// 256 + 256 + 512 (zamba2-1.2b) at one lane of 512 steps.
//
// bf16 (v2): the products run as warp tiles of m16n8k16: C @ B^T, att @ x
// and C @ S_in^T in pass 3 and (x * w)^T @ B in pass 1, `mma.sync` on the
// tensor cores with float32 accumulation; C @ B^T comes out as accumulator
// fragments that become att in registers (the mask and decay applied per
// element) and then the A operand of att @ x, so att never touches shared
// memory. Three operands of the bf16 products are computed values, not
// inputs: att (before att @ x), x * w (before the chunk-state product) and
// S_in (before C @ S_in^T). Rounding each to bf16 once came within 0.9 of
// the 5e-2 gate on the CPU mirror and missed it on the card (1 element in
// 460,800), so each is carried as a hi + lo pair of bf16 values, hi =
// bf16(v) and lo = bf16(v - hi), and its product is two MMAs; what is left
// is the rounding of y to bf16 (the CPU tests mirror both). Everything else
// (C @ B^T, the decays, the scan, the final state) is float32. C @ B^T is
// computed by every head's pass 3, from B and C in shared memory, rather
// than once per (lane, chunk) into device memory: a shared copy would be
// read back at the same bytes that staging B costs.
//
// float32 (v3, namespace f32): tensor cores would mean TF32, which misses
// the 2e-5 gate, so passes 1 and 3 are float32 FMA on the CUDA cores, on
// the register micro-tiles of flash_common.cuh that K1 v4 and K1-bwd use
// (no shuffles: multiplying the bf16 fragments by FMA would fetch each
// operand a lane lacks by shuffle, at a quarter of the FMA rate). Pass 1
// is the chunk's outer sum
// (ssm_common.cuh): x·w and B rows in shared memory as they lie in device
// memory, each thread 8 state rows by N/16 columns, summed over the keys in
// order. Pass 3 is K1 v4's loop without the softmax: a block of 2R threads
// owns R = min(L, 64) rows of C and walks the key tiles of B and x up to
// its diagonal (cp.async, the next tile loading under this one's
// products), att = C·Bᵀ on 8 x R/16 register tiles, masked and decayed in
// registers, through shared memory into y += att·x on 8 x P/16 tiles; then
// S_in, staged transposed as [N][P] over the walked tiles, gives
// exp(cum)·(C·S_inᵀ) by one more product. At P 64 / N 128 / L 128 pass 3
// holds 98.5 KB and pass 1 98 KB: two blocks (8 warps) to an SM.
//
// Staging (v2): rows of x, B and C are copied into shared memory as they
// lie in device memory, by cp.async (every copy of a block in flight at once, no
// registers); operands that the products read across rows (x in att @ x,
// x * w and B in the chunk-state product) are loaded with ldmatrix .trans,
// so nothing is transposed on the way in. Tiles that are converted on the
// way (x * w, and S_in from the float32 workspace) keep four 16-byte loads
// in flight per thread. A block's copies overlap its float64 cumsum.
//
// cum is summed in float64 (a warp scan over L values per chunk, the same
// code in passes 1 and 3): every decay is exp(cum_i - cum_j), the difference
// of two sums that reach tens in magnitude, and in float32 that cancellation
// alone costs about 2e-5 on y at mamba2-130m's shapes, the whole float32
// tolerance. The plain version does the same.
//
// A ragged tail is masked in the blocks, as the TPU wrapper's padding did:
// rows past S load as zeros with dt = 0 (an identity step with zero output)
// and are never stored.
//
// Bound on this card: per (lane, head, chunk) 2L^2 N + 2L^2 P + 4LPN
// operations against x and y once and B and C once per (lane, chunk): about
// 1 GFLOP and 4 MB for one mamba2-130m layer at S = 512, so in bf16 the
// bound is the bytes (~1.3 us). In float32, without the tensor cores, the
// operations bound it (5.7 GFLOP at mamba2-130m's training shape, B 8,
// ~0.08 ms at 67 TFLOP/s). The workspace (1 MB per (lane, head) of 4 chunks
// at P = 64, N = 128) stays in the 50 MB L2 between the passes.
#include <type_traits>

#include "ssm_common.cuh"

namespace repro_torch {

constexpr int kPadE = 8;          // row padding (elements) of operand tiles
constexpr int kScanThreads = 256;
constexpr int kTileThreads = 128;   // pass 1's block, pass 3's largest

// ------------------------------------------------ one warp's 16x8x16 product
// Fragments as mma.m16n8k16 lays them out, lane = 4 g + t: the A operand
// (16 x 16, row-major) holds rows g and g + 8 at columns 2t, 2t + 1, 2t + 8,
// 2t + 9; the B operand (16 x 8) holds column g at rows 2t, 2t + 1, 2t + 8,
// 2t + 9; the accumulator (16 x 8, float32) rows g and g + 8 at columns 2t
// and 2t + 1. Both operands are read from shared tiles whose rows run along
// the reduced dimension: A as [m][k], B as [n][k].
template <typename E> struct Mma;

// ldmatrix .trans: lane l gives the address of row l % 8 of 8 x 8 matrix
// l / 8 (16 bytes of b16); register i receives rows 2t and 2t + 1 of column
// g of matrix i, that is the operand of a tile kept across its rows.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              const void* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}

// 16 bytes from device to shared memory without registers; src_bytes 0
// writes zeros (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(d), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float bf16_residual(float v) {
  return v - __bfloat162float(__float2bfloat16(v));
}

template <> struct Mma<__nv_bfloat16> {
  using E = __nv_bfloat16;
  static constexpr bool kSplit = true;   // rounded values as hi + lo
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };

  static __device__ __forceinline__ A load_a(const E* s, int ld, int m0,
                                             int k0) {
    const int lane = threadIdx.x & 31;
    const E* p = s + (size_t)(m0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
    return A{{ld32(p), ld32(p + 8 * ld), ld32(p + 8), ld32(p + 8 * ld + 8)}};
  }
  static __device__ __forceinline__ B load_b(const E* s, int ld, int n0,
                                             int k0) {
    const int lane = threadIdx.x & 31;
    const E* p = s + (size_t)(n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
    return B{{ld32(p), ld32(p + 8)}};
  }
  // The same operands from tiles kept across their rows: A as [k][m], B as
  // [k][n] (ldmatrix .trans; matrices (k0, m0), (k0, m0 + 8), (k0 + 8, m0),
  // (k0 + 8, m0 + 8) for A, (k0, n0), (k0 + 8, n0) for B).
  static __device__ __forceinline__ A load_a_t(const E* s, int ld, int m0,
                                               int k0) {
    const int lane = threadIdx.x & 31;
    const int mat = lane >> 3;
    A f;
    ldsm_x4_trans(f.r, s + (size_t)(k0 + (lane & 7) + 8 * (mat >> 1)) * ld +
                           m0 + 8 * (mat & 1));
    return f;
  }
  static __device__ __forceinline__ B load_b_t(const E* s, int ld, int n0,
                                               int k0) {
    const int lane = threadIdx.x & 31;
    B f;
    ldsm_x2_trans(f.r, s + (size_t)(k0 + (lane & 15)) * ld + n0);
    return f;
  }
  // The A operand of columns [k0, k0 + 16) from the accumulators of columns
  // [k0, k0 + 8) (c0) and [k0 + 8, k0 + 16) (c1), rounded to bf16.
  static __device__ __forceinline__ A from_acc(const float (&c0)[4],
                                               const float (&c1)[4]) {
    return A{{pack_bf16(c0[0], c0[1]), pack_bf16(c0[2], c0[3]),
              pack_bf16(c1[0], c1[1]), pack_bf16(c1[2], c1[3])}};
  }
  // What from_acc's rounding left out, rounded to bf16 (the lo half).
  static __device__ __forceinline__ A from_acc_lo(const float (&c0)[4],
                                                  const float (&c1)[4]) {
    return A{{pack_bf16(bf16_residual(c0[0]), bf16_residual(c0[1])),
              pack_bf16(bf16_residual(c0[2]), bf16_residual(c0[3])),
              pack_bf16(bf16_residual(c1[0]), bf16_residual(c1[1])),
              pack_bf16(bf16_residual(c1[2]), bf16_residual(c1[3]))}};
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a,
                                             const B& b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %11, %12, %13};\n"
        : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]),
          "r"(b.r[1]), "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
  }
};

// Two consecutive values into p (2-element aligned).
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
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

// ------------------------------------------------ staging
// dst row r (row stride ld) <- src row r0 + r of the rows of W values at
// src, `lds` apart (0: W, a row-major (., W) tile), by cp.async; rows at or
// past `valid` are zeros. src row 0 exists. The caller waits
// (cp_async_wait_all) and synchronises.
template <typename T>
__device__ void stage_rows(T* dst, int ld, const T* __restrict__ src, int r0,
                           int W, int valid, int rows, int lds = 0) {
  constexpr int V = vec_len<T>();
  const int per_row = W / V;
  const size_t stride = lds ? lds : W;
  for (int c = threadIdx.x; c < rows * per_row; c += blockDim.x) {
    const int r = c / per_row;
    const int col = (c - r * per_row) * V;
    const bool ok = r0 + r < valid;
    cp_async16(dst + (size_t)r * ld + col,
               ok ? src + (size_t)(r0 + r) * stride + col : src, ok ? 16 : 0);
  }
}

// Row s0 of lane b's B or C for head h: (B, S, G, N), head h reading group
// h / (H / G); at G = 1 the (B, S, N) layout. Rows lie G·N apart.
template <typename T, int N>
__device__ __forceinline__ const T* bc_rows(const T* __restrict__ m, int b,
                                            int S, int s0, int G, int h,
                                            int H) {
  return m + (((size_t)b * S + s0) * G + h / (H / G)) * N;
}

// dst row r <- src row r, times w[r] when w is given, rounded to T; rows at
// or past `valid` are zeros. With lo (bf16 only), lo row r <- what the
// rounding left out, rounded too, so that hi + lo carries about 16 bits.
// kInFlight 16-byte loads in flight per thread.
template <typename T, typename S>
__device__ void stage_convert(T* dst, T* lo, int ld, const S* __restrict__ src,
                              int W, int valid, int rows, const float* w) {
  constexpr int V = vec_len<S>();
  const int per_row = W / V;
  const int n = rows * per_row;
  for (int base = threadIdx.x; base < n; base += kInFlight * blockDim.x) {
    float f[kInFlight][V];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int c = base + u * blockDim.x;
      const int r = c / per_row;
      if (c < n && r < valid) {
        load16(src + (size_t)r * W + (c - r * per_row) * V, f[u]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) f[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int c = base + u * blockDim.x;
      if (c < n) {
        const int r = c / per_row;
        if (w != nullptr && r < valid) {
          const float wr = w[r];
#pragma unroll
          for (int i = 0; i < V; ++i) f[u][i] *= wr;
        }
        const size_t off = (size_t)r * ld + (c - r * per_row) * V;
        store_row<V>(dst + off, f[u]);
        if (lo != nullptr) {
#pragma unroll
          for (int i = 0; i < V; ++i) f[u][i] = bf16_residual(f[u][i]);
          store_row<V>(lo + off, f[u]);
        }
      }
    }
  }
}

// ------------------------------------------------ pass 1: chunk states
constexpr int kMaxChunk = 128;

// Shared memory: cum [L] float64, dt and w [L] float32 each, then in T the
// chunk's rows of x * w [L][P + pad] (and its lo half in bf16) and of B
// [L][N + pad].
template <typename T, int P, int N>
__host__ __device__ constexpr size_t state_smem_bytes(int L) {
  return (size_t)L * 16 +
         (size_t)L * ((Mma<T>::kSplit ? 2 : 1) * (P + kPadE) + (N + kPadE)) *
             sizeof(T);
}

// Warp w owns 16 rows of the (P, N) state, m0 = 16 (w % (P / 16)), and NTW
// column tiles of 8 from (w / (P / 16)) NTW: one A operand per k step
// serves NTW independent products.
template <typename T, int P, int N>
__global__ void __launch_bounds__(kTileThreads)
ssd_chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const T* __restrict__ Bm,
                       float* __restrict__ states, float* __restrict__ totals,
                       int H, int S, int L, int G) {
  using M = Mma<T>;
  constexpr int LP = P + kPadE;   // row stride of the x * w tile
  constexpr int LN = N + kPadE;   // row stride of the B tile
  constexpr int MT = P / 16;
  constexpr int NTW = (N / 8) * MT / (kTileThreads / 32);
  static_assert(NTW * (kTileThreads / 32) == (N / 8) * MT, "tiles per warp");
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nc = gridDim.x;
  const int s0 = c * L;
  const int valid = min(L, S - s0);
  double* cum = reinterpret_cast<double*>(smem);
  float* dts = reinterpret_cast<float*>(cum + L);
  float* wts = dts + L;
  T* xw = reinterpret_cast<T*>(wts + L);   // [L][LP]
  T* bs = xw + (size_t)L * LP;             // [L][LN]
  T* xw_lo = M::kSplit ? bs + (size_t)L * LN : nullptr;   // [L][LP]

  const size_t bh = (size_t)b * H + h;
  stage_rows<T>(bs, LN, bc_rows<T, N>(Bm, b, S, s0, G, h, H), 0, N, valid, L,
                G * N);
  chunk_cumsum(dt + bh * S + s0, A[h], dts, cum, valid, L);
  const double total = cum[L - 1];
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    wts[j] = expf((float)(total - cum[j])) * dts[j];
  }
  if (threadIdx.x == 0) totals[bh * nc + c] = (float)total;
  __syncthreads();
  stage_convert<T, T>(xw, xw_lo, LP, x + (bh * S + s0) * P, P, valid, L,
                      wts);
  cp_async_wait_all();
  __syncthreads();

  // local state (P, N) = (x w)^T @ B, both operands read across their rows
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp % MT) * 16;
  const int n0 = (warp / MT) * NTW * 8;
  float acc[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  for (int k0 = 0; k0 < valid; k0 += 16) {     // rows past valid are zeros
    const typename M::A a = M::load_a_t(xw, LP, m0, k0);
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const typename M::B bj = M::load_b_t(bs, LN, n0 + 8 * j, k0);
      M::mma(acc[j], a, bj);
      if constexpr (M::kSplit) {
        M::mma(acc[j], M::load_a_t(xw_lo, LP, m0, k0), bj);
      }
    }
  }
  float* o = states + (bh * nc + c) * P * N + (size_t)(m0 + (lane >> 2)) * N +
             n0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    store2(o + 8 * j, acc[j][0], acc[j][1]);
    store2(o + 8 * j + 8 * N, acc[j][2], acc[j][3]);
  }
}

// ------------------------------------------------ pass 2: the scan
// Each thread owns 4 consecutive state elements of one (lane, head) and
// walks the chunks: the local state it reads is replaced by the state
// entering the chunk, and the state after the last chunk is the final one.
__global__ void __launch_bounds__(kScanThreads)
ssd_state_scan_kernel(float* __restrict__ states,
                      const float* __restrict__ totals,
                      float* __restrict__ final_state, int nc, int PN) {
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (e >= PN) return;
  float* st = states + bh * nc * PN + e;
  const float* tot = totals + bh * nc;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int c = 0; c < nc; ++c) {
    float4* p = reinterpret_cast<float4*>(st + (size_t)c * PN);
    const float4 loc = *p;
    *p = s;
    const float d = expf(tot[c]);
    s = make_float4(s.x * d + loc.x, s.y * d + loc.y, s.z * d + loc.z,
                    s.w * d + loc.w);
  }
  *reinterpret_cast<float4*>(final_state + bh * PN + e) = s;
}

// ------------------------------------------------ pass 3: outputs
// Shared memory: cum [L] float64, dt [L] float32, then in T: C of the slab
// [R][N + pad], B and x of keys 0..L [L][N + pad] and [L][P + pad], and the
// incoming state [P][N + pad] (and its lo half in bf16).
template <typename T, int P, int N, int L>
__host__ __device__ constexpr size_t output_smem_bytes() {
  return (size_t)L * 12 +
         ((size_t)(slab_rows(L) + L + (Mma<T>::kSplit ? 2 : 1) * P) *
              (N + kPadE) +
          (size_t)L * (P + kPadE)) * sizeof(T);
}

// Warp w owns rows i0 = r0 + 16 w .. i0 + 15 of the chunk, whose keys are
// j < i0 + 16: L / 8 accumulator tiles of 8 keys at most. A block is 2R
// threads; the bound names 128 threads and one block per SM whatever R is,
// so that ptxas sizes the 64-thread blocks' registers as the 128-thread
// ones' (a bound of 64 threads spilled).
template <typename T, int P, int N, int L>
__global__ void __launch_bounds__(kTileThreads, 1)
ssd_output_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, const float* __restrict__ states,
                  T* __restrict__ y, int H, int S, int G) {
  using M = Mma<T>;
  constexpr int R = slab_rows(L);
  constexpr int NA = N + kPadE;   // row stride of the C, B and state tiles
  constexpr int LP = P + kPadE;   // row stride of the x tile
  constexpr int JT = L / 8;       // key tiles of the chunk
  constexpr int PT = P / 8;       // output column tiles
  extern __shared__ __align__(16) unsigned char smem[];
  const int slabs = L / R;
  const int c = blockIdx.x / slabs;
  const int r0 = (blockIdx.x % slabs) * R;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nc = gridDim.x / slabs;
  const int J = r0 + R;           // keys that reach the slab
  const int s0 = c * L;
  const int valid = min(L, S - s0);
  double* cum = reinterpret_cast<double*>(smem);
  float* dts = reinterpret_cast<float*>(cum + L);
  T* cs = reinterpret_cast<T*>(dts + L);   // [R][NA]
  T* bs = cs + (size_t)R * NA;             // [L][NA], rows < J used
  T* xs = bs + (size_t)L * NA;             // [L][LP], rows < J used
  T* ss = xs + (size_t)L * LP;             // [P][NA]
  T* ss_lo = M::kSplit ? ss + (size_t)P * NA : nullptr;   // [P][NA]

  const size_t bh = (size_t)b * H + h;
  const size_t row0 = (size_t)b * S + s0;
  stage_rows<T>(cs, NA, bc_rows<T, N>(Cm, b, S, s0, G, h, H), r0, N, valid,
                R, G * N);
  stage_rows<T>(bs, NA, bc_rows<T, N>(Bm, b, S, s0, G, h, H), 0, N, valid, J,
                G * N);
  stage_rows<T>(xs, LP, x + (bh * S + s0) * P, 0, P, valid, J);
  if (c > 0) {                    // S_in of chunk 0 is 0
    stage_convert<T, float>(ss, ss_lo, NA, states + (bh * nc + c) * P * N,
                            N, P, P, nullptr);
  }
  chunk_cumsum(dt + bh * S + s0, A[h], dts, cum, valid, L);
  cp_async_wait_all();
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m0 = 16 * warp;       // the warp's first row in the slab
  const int i0 = r0 + m0;         // ... and in the chunk
  const int kend = i0 + 16;       // keys j < kend

  // C @ B^T for the warp's rows and keys j < kend
  float att[JT][4];
#pragma unroll
  for (int nt = 0; nt < JT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) att[nt][e] = 0.f;
  }
#pragma unroll 2
  for (int k0 = 0; k0 < N; k0 += 16) {
    const typename M::A a = M::load_a(cs, NA, m0, k0);
#pragma unroll
    for (int nt = 0; nt < JT; ++nt) {
      if (nt * 8 < kend) M::mma(att[nt], a, M::load_b(bs, NA, nt * 8, k0));
    }
  }
  // att = (C . B_j) * exp(cum_i - cum_j) * dt_j for j <= i, else 0
  const int ia = i0 + (lane >> 2);
  const int ib = ia + 8;
  const double ca = cum[ia];
  const double cb = cum[ib];
#pragma unroll
  for (int nt = 0; nt < JT; ++nt) {
    if (nt * 8 < kend) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? ia : ib;
        const int j = nt * 8 + 2 * (lane & 3) + (e & 1);
        att[nt][e] = j <= i ? att[nt][e] *
                                  expf((float)((e < 2 ? ca : cb) - cum[j])) *
                                  dts[j]
                            : 0.f;
      }
    }
  }

  // y = att @ x (keys in steps of 16) + exp(cum_i) * (C @ S_in^T)
  float yo[PT][4];
#pragma unroll
  for (int pt = 0; pt < PT; ++pt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) yo[pt][e] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < JT / 2; ++kk) {
    if (kk * 16 < kend) {
      const typename M::A a = M::from_acc(att[2 * kk], att[2 * kk + 1]);
#pragma unroll
      for (int pt = 0; pt < PT; ++pt) {
        const typename M::B bx = M::load_b_t(xs, LP, pt * 8, kk * 16);
        M::mma(yo[pt], a, bx);
        if constexpr (M::kSplit) {
          M::mma(yo[pt], M::from_acc_lo(att[2 * kk], att[2 * kk + 1]), bx);
        }
      }
    }
  }
  if (c > 0) {
    float q[PT][4];
#pragma unroll
    for (int pt = 0; pt < PT; ++pt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) q[pt][e] = 0.f;
    }
#pragma unroll 2
    for (int k0 = 0; k0 < N; k0 += 16) {
      const typename M::A a = M::load_a(cs, NA, m0, k0);
#pragma unroll
      for (int pt = 0; pt < PT; ++pt) {
        M::mma(q[pt], a, M::load_b(ss, NA, pt * 8, k0));
        if constexpr (M::kSplit) {
          M::mma(q[pt], a, M::load_b(ss_lo, NA, pt * 8, k0));
        }
      }
    }
    const float ea = expf((float)ca);
    const float eb = expf((float)cb);
#pragma unroll
    for (int pt = 0; pt < PT; ++pt) {
      yo[pt][0] += ea * q[pt][0];
      yo[pt][1] += ea * q[pt][1];
      yo[pt][2] += eb * q[pt][2];
      yo[pt][3] += eb * q[pt][3];
    }
  }
  T* yc = y + (bh * S + s0) * P + 2 * (lane & 3);
#pragma unroll
  for (int pt = 0; pt < PT; ++pt) {
    if (ia < valid) store2(yc + (size_t)ia * P + pt * 8, yo[pt][0], yo[pt][1]);
    if (ib < valid) store2(yc + (size_t)ib * P + pt * 8, yo[pt][2], yo[pt][3]);
  }
}

// ------------------------------------------------ v3: float32
// The float32 passes 1 and 3, float32 FMA on the register micro-tiles of
// flash_common.cuh (no TF32: the float32 gate is 2e-5). Pass 2 is shared.
namespace f32 {

// Pass 1: the chunk's local state (x·w)ᵀ B on the outer sum of
// ssm_common.cuh, one block per (chunk, head, lane).
template <int P, int N, int L>
__global__ void __launch_bounds__(Outer<P, N, L>::NT, 2)
ssd_chunk_state_f32(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    float* __restrict__ states, float* __restrict__ totals,
                    int H, int S) {
  constexpr int NT = Outer<P, N, L>::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  const OuterSmem m = outer_smem<P, N, L>(smem);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int s0 = c * L;
  const int valid = min(L, S - s0);
  const size_t bh = (size_t)b * H + h;
  tile::load_tile<L, N, N, NT>(m.sb, Bm + ((size_t)b * S + s0) * N, valid);
  tile::cp_async_commit();
  chunk_cumsum(dt + bh * S + s0, A[h], m.dts, m.cum, valid, L);
  const double total = m.cum[L - 1];
  for (int j = threadIdx.x; j < L; j += NT) {
    m.s[j] = expf((float)(total - m.cum[j])) * m.dts[j];   // w_j
  }
  if (threadIdx.x == 0) totals[bh * nc + c] = (float)total;
  __syncthreads();
  outer_sum<P, N, L>(x + (bh * S + s0) * P, m, valid,
                     states + (bh * nc + c) * (size_t)(P * N));
}

// Pass 3: a block owns a slab of R = min(L, 64) rows of the chunk and
// walks the key tiles of R keys j <= its last row, K1 v4's loop without the
// softmax: att = C·Bᵀ on an abt micro-tile (8 rows by R/16 keys a thread),
// times exp(cum_i − cum_j)·dt_j for j <= i and 0 above the diagonal (never
// reaching exp), through shared memory into y += att·x (abw, 8 rows by P/16
// columns). The state term exp(cum_i)·C_i·S_inᵀ is one more abw from S_in
// staged as [N][P] once the walk is done, into accumulators of its own (as
// in v2, y = att·x + exp(cum)·(C·S_inᵀ)). Thread (ty, tx) owns slab rows
// 8ty .. 8ty+7; 2R threads.
template <int P, int N, int L>
struct OutLayout {
  static constexpr int R = slab_rows(L);
  static constexpr int NT = R / 8 * tile::kTX;
  static constexpr int LDB = N + 4;     // B tile rows, read by abt as B
  // cum [L] float64 and dt [L]; the slab's C [R][N]; then the B tile
  // [R][LDB], the x tile [R][P] and att [R][R], and over them, once the
  // walk is done, S_inᵀ [N][P]
  static constexpr size_t WALK = (size_t)R * (LDB + P + R);
  static constexpr size_t REGION =
      WALK > (size_t)N * P ? WALK : (size_t)N * P;
  static constexpr size_t BYTES =
      (size_t)L * 12 + 4 * ((size_t)R * N + REGION);
};

template <int P, int N, int L>
__global__ void __launch_bounds__(OutLayout<P, N, L>::NT, 2)
ssd_output_f32(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm,
               const float* __restrict__ states, float* __restrict__ y,
               int H, int S) {
  using Ly = OutLayout<P, N, L>;
  constexpr int R = Ly::R, NT = Ly::NT, LDB = Ly::LDB;
  constexpr int NJ = R / tile::kTX, CP = P / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int slabs = L / R;
  const int c = blockIdx.x / slabs;
  const int slab = slabs - 1 - (int)blockIdx.x % slabs;   // heaviest first
  const int r0 = slab * R;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x / slabs;
  const int s0 = c * L;
  const int valid = min(L, S - s0);
  if (r0 >= valid) return;          // a slab wholly past S stores nothing
  double* cum = reinterpret_cast<double*>(smem);
  float* dts = reinterpret_cast<float*>(cum + L);
  float* sC = dts + L;              // [R][N] the slab's C
  float* sB = sC + R * N;           // [R][LDB] a tile of B keys
  float* sX = sB + R * LDB;         // [R][P] a tile of x keys
  float* sS = sX + R * P;           // [R][R] att
  float* sT = sB;                   // [N][P] S_inᵀ, once the walk is done
  const size_t bh = (size_t)b * H + h;
  const size_t row0 = (size_t)b * S + s0;
  const float* xc = x + (bh * S + s0) * P;
  const int ty = threadIdx.x / tile::kTX, tx = threadIdx.x % tile::kTX;
  const int i0 = 8 * ty;            // the thread's first row in the slab

  tile::load_tile<R, N, N, NT>(sC, Cm + (row0 + r0) * N, valid - r0);
  tile::load_tile<R, N, LDB, NT>(sB, Bm + row0 * N, valid);
  tile::cp_async_commit();
  tile::load_tile<R, P, P, NT>(sX, xc, valid);
  tile::cp_async_commit();
  chunk_cumsum(dt + bh * S + s0, A[h], dts, cum, valid, L);

  float yacc[8][CP];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int q = 0; q < CP; ++q) yacc[i][q] = 0.f;
  }
  for (int t = 0; t <= slab; ++t) { // key tiles 0 .. slab
    const int k0 = t * R;
    const bool more = t < slab;
    tile::cp_async_wait<1>();       // C and this B tile (x may be in flight)
    __syncthreads();
    float s[8][NJ];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
    }
    tile::abt<8, NJ, N, N, LDB>(sC + i0 * N, sB, s);      // C_i · B_j
    __syncthreads();                // every thread has read this B tile
    if (more) {
      tile::load_tile<R, N, LDB, NT>(sB, Bm + (row0 + k0 + R) * N,
                                     valid - k0 - R);
      tile::cp_async_commit();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int ri = r0 + i0 + i;
      const double ci = cum[ri];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int kj = k0 + tx + tile::kTX * j;
        sS[(i0 + i) * R + tx + tile::kTX * j] =
            kj <= ri ? s[i][j] * expf((float)(ci - cum[kj])) * dts[kj] : 0.f;
      }
    }
    if (more) {
      tile::cp_async_wait<1>();     // this x tile (the next B may be loading)
    } else {
      tile::cp_async_wait<0>();
    }
    __syncthreads();                // att and this x tile visible
    tile::abw<8, P, R, R, P>(sS + i0 * R, sX, yacc);      // y += att · x
    __syncthreads();                // every thread has read att and x
    if (more) {
      tile::load_tile<R, P, P, NT>(sX, xc + (size_t)(k0 + R) * P,
                                   valid - k0 - R);
      tile::cp_async_commit();
    }
  }
  if (c > 0) {                      // S_in of chunk 0 is 0
    tile::stage_t<P, N, NT>(sT, states + (bh * nc + c) * (size_t)(P * N));
    __syncthreads();
    float q[8][CP];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int k = 0; k < CP; ++k) q[i][k] = 0.f;
    }
    tile::abw<8, P, N, N, P>(sC + i0 * N, sT, q);          // C_i · S_inᵀ
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float e = expf((float)cum[r0 + i0 + i]);
#pragma unroll
      for (int k = 0; k < CP; ++k) yacc[i][k] += e * q[i][k];
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ri = r0 + i0 + i;
    if (ri < valid) tile::store_cols<P>(y + (bh * S + s0 + ri) * P, tx,
                                        yacc[i]);
  }
}

}  // namespace f32

// ------------------------------------------------ launch
// The chunk-state kernel serves both chunk sizes, so its shared-memory limit
// is raised once, to the larger chunk's need, and recorded per kernel (a
// record per launcher would let one chunk size lower the limit under the
// other's record).
template <typename T, int P, int N>
static bool raise_state_smem_limit() {
  static size_t allowed = 0;
  return raise_smem_limit(ssd_chunk_state_kernel<T, P, N>,
                          state_smem_bytes<T, P, N>(kMaxChunk), allowed);
}

// passes: bit 0 chunk states, bit 1 scan, bit 2 outputs (7 for a call; a
// single bit only for timing one pass). bf16 runs v2's kernels, float32
// v3's.
template <typename T, int P, int N, int L>
static int launch_ssd(const void* x, const float* dt, const float* A,
                      const void* Bm, const void* Cm, void* y, float* fs,
                      float* states, float* totals, int B, int H, int S,
                      int passes, int G, cudaStream_t stream) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  if (G < 1 || H % G || (kF32 && G != 1)) return (int)cudaErrorInvalidValue;
  const int nc = (S + L - 1) / L;
  const T* xt = static_cast<const T*>(x);
  if (nc > 0 && (passes & 1)) {
    if constexpr (kF32) {
      constexpr size_t smem = Outer<P, N, L>::BYTES;
      auto kern = f32::ssd_chunk_state_f32<P, N, L>;
      static size_t allowed = 0;
      if (!prefer_smem(kern, smem, allowed)) return (int)cudaGetLastError();
      kern<<<dim3(nc, H, B), Outer<P, N, L>::NT, smem, stream>>>(
          xt, dt, A, static_cast<const T*>(Bm), states, totals, H, S);
    } else {
      const size_t smem = state_smem_bytes<T, P, N>(L);
      auto kern = ssd_chunk_state_kernel<T, P, N>;
      if (!raise_state_smem_limit<T, P, N>()) return (int)cudaGetLastError();
      kern<<<dim3(nc, H, B), kTileThreads, smem, stream>>>(
          xt, dt, A, static_cast<const T*>(Bm), states, totals, H, S, L, G);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (passes & 2) {
    const int per_block = kScanThreads * 4;
    auto kern = ssd_state_scan_kernel;
    kern<<<dim3((P * N + per_block - 1) / per_block, H, B), kScanThreads, 0,
           stream>>>(states, totals, fs, nc, P * N);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (nc > 0 && (passes & 4)) {
    if constexpr (kF32) {
      using Ly = f32::OutLayout<P, N, L>;
      auto kern = f32::ssd_output_f32<P, N, L>;
      static size_t allowed = 0;
      if (!prefer_smem(kern, Ly::BYTES, allowed)) {
        return (int)cudaGetLastError();
      }
      kern<<<dim3(nc * (L / Ly::R), H, B), Ly::NT, Ly::BYTES, stream>>>(
          xt, dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
          states, static_cast<T*>(y), H, S);
    } else {
      const size_t smem = output_smem_bytes<T, P, N, L>();
      auto kern = ssd_output_kernel<T, P, N, L>;
      static size_t allowed = 0;
      if (!raise_smem_limit(kern, smem, allowed)) {
        return (int)cudaGetLastError();
      }
      kern<<<dim3(nc * (L / slab_rows(L)), H, B), 2 * slab_rows(L), smem,
             stream>>>(xt, dt, A, static_cast<const T*>(Bm),
                       static_cast<const T*>(Cm), states,
                       static_cast<T*>(y), H, S, G);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

using namespace repro_torch;

// K5. dtype: 0 = float32, 1 = bfloat16 (x, B, C and y); dt, A and the final
// state are float32. P must be 32 or 64, state_dim 32, 64 or 128, chunk 32
// or 128. B and C are (B, S, groups, state_dim): head h reads group
// h / (H / groups), groups dividing H (bfloat16 only when groups > 1;
// groups 1 is the (B, S, state_dim) layout). Workspace, float32: states
// (B, H, ceil(S / chunk), P, state_dim) and totals (B, H, ceil(S / chunk)).
// passes: 7 for a call (see launch_ssd). Returns the cudaError_t of the
// launches (0 on success).
extern "C" int repro_ssd_scan(int dtype, int state_dim, const void* x,
                              const float* dt, const float* A, const void* Bm,
                              const void* Cm, void* y, float* final_state,
                              float* states, float* totals, int B, int H,
                              int S, int P, int chunk, int passes, int groups,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_SSD(T, PP, NN, LL)                                             \
  if (P == PP && state_dim == NN && chunk == LL)                             \
  return launch_ssd<T, PP, NN, LL>(x, dt, A, Bm, Cm, y, final_state, states, \
                                   totals, B, H, S, passes, groups, st)
#define REPRO_SSD_N(T, PP, LL)                                               \
  REPRO_SSD(T, PP, 32, LL); REPRO_SSD(T, PP, 64, LL); REPRO_SSD(T, PP, 128, LL)
#define REPRO_SSD_ALL(T)                                                     \
  REPRO_SSD_N(T, 32, 32); REPRO_SSD_N(T, 64, 32);                            \
  REPRO_SSD_N(T, 32, 128); REPRO_SSD_N(T, 64, 128)
  if (dtype == 0) { REPRO_SSD_ALL(float); }
  if (dtype == 1) { REPRO_SSD_ALL(__nv_bfloat16); }
#undef REPRO_SSD_ALL
#undef REPRO_SSD_N
#undef REPRO_SSD
  return (int)cudaErrorInvalidValue;
}

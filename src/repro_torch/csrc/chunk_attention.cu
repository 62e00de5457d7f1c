// K6: one lane's prefill chunk attending over its paged KV cache, by hand
// for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package runs chunked prefill's
// attention on its plain path (gather the lane's whole block table, then
// dense masked attention in float32), and so did this port until that path
// bounded chat's device time. A 256-row chunk against mistral-7b's
// 6,144-row table is 12.9 GFLOP of float32 products per layer on the CUDA
// cores and a 201 MB logits tensor, of which ~0.1% is useful at chat's
// ~38-token prompts. This kernel reads the lane's K/V through its block
// table, from the first row the window allows to the last valid key, and
// never gathers the table.
//
// Function: q (1, Hq, C, D), the chunk's queries at absolute positions
// q_offset + i; pools (num_blocks, Hkv, bs, D); the lane's table
// (max_blocks,) int32; kv_len (1,) int32, the valid keys including the
// chunk's own. Row i is valid iff q_offset + i < kv_len (the first
// n_valid = kv_len - q_offset rows) and attends to keys
// [qpos - window + 1, qpos] with K1's scale, softcap (before the mask) and
// online softmax. Rows past n_valid are written as zeros: nothing reads
// them (their K/V writes already went to the null block, and only the last
// valid row's logits are used).
//
// Device-side lengths: q_offset, kv_len and the table are read from device
// memory, so one CUDA graph captured per chunk shape serves every lane and
// every valid count. The grid is fixed at launch, (ceil(C·G / 64), Hkv):
// a block whose rows all lie past n_valid writes its zeros and exits, and
// the others loop on the device from the window's first key tile to
// min(kv_len, q_offset + their last valid row + 1).
//
// GQA: a block's 64 query rows are packed as (position, group head), row
// r = position·G + g of KV head blockIdx.y, so the G query heads of a KV
// head share every K/V tile it loads.
//
// Bound on this card: at chat's chunks (~38 valid rows, no prior context)
// a layer's work is ~12 MFLOP and ~0.8 MB of q, o and K/V rows, a fraction
// of a microsecond at the card's rates: one launch's fixed cost and one
// key tile's load latency set its time. With 1,024 rows of prior context
// and 256 valid rows it does ~4.8 GFLOP on ~9 MB (mistral-7b), operations
// over bytes ~500 > 295, so the tensor cores bound it.
//
// Two kernels sit behind one entry point, as in K1:
//
// bfloat16 (paged_chunk_wgmma): K1 v3's consumer warpgroup and numerics.
// One warpgroup of 128 threads per block owns the 64 rows; per 64-key
// tile, S = Q·Kᵀ by wgmma m64n64k16 from shared memory, the online softmax
// on the float32 accumulator fragment (m and l in float32), P rounded to
// bf16 in registers as the A operand of O += P·V (V MN-major), O in float32
// registers. The new part is the loader: a 64-key tile spans 64 / bs table
// entries, so the block's threads copy its rows by cp.async, 16 bytes each,
// looking each row's block up in the table, into the 128-byte swizzled
// panels that TMA writes for K1 (the same descriptors read them). Two
// stages: tile i + 1 loads while tile i is multiplied. cp.async writes in
// the generic proxy, so a fence.proxy.async orders them before wgmma reads.
//
// float32 (paged_chunk_f32): K1 v4's CUDA-core FMA micro-tiles
// (flash_common.cuh; TF32 would miss the float32 tolerance), 128 threads
// of 8 rows each, the same loader with rows padded instead of swizzled.
#include "attention_common.cuh"
#include "flash_common.cuh"
#include "wgmma.cuh"

namespace repro_torch {
namespace chunk {

constexpr int kBQ = 64;           // packed query rows a block
constexpr int kBK = 64;           // keys a tile
constexpr int kNT = 128;          // threads: one warpgroup; f32: 8 rows each
constexpr float kLog2e = 1.4426950408889634f;

// What one block reads of the lengths: its packed rows r0 .. r0 + 63, the
// valid positions, and the key tiles its valid rows reach.
struct Span {
  int q_offset, n_valid, r0, k_begin, k_end, n_tiles;
};

__device__ __forceinline__ Span block_span(const int* q_offset,
                                           const int* kv_len, int C, int G,
                                           int window) {
  Span w;
  w.q_offset = *q_offset;
  w.n_valid = min(C, *kv_len - w.q_offset);
  w.r0 = blockIdx.x * kBQ;
  const int p_first = w.r0 / G;
  const int p_last = min((w.r0 + kBQ - 1) / G, w.n_valid - 1);
  w.k_end = w.q_offset + p_last + 1;          // <= kv_len
  int k_begin = 0;
  if (window > 0) k_begin = max(0, w.q_offset + p_first - window + 1);
  w.k_begin = k_begin / kBK * kBK;
  w.n_tiles = p_first < w.n_valid
                  ? (w.k_end - w.k_begin + kBK - 1) / kBK : 0;
  return w;
}

// The output row of packed row pr: head hk·G + g at position pr / G.
__device__ __forceinline__ size_t out_row(int pr, int G, int hk, int C) {
  const int pos = pr / G;
  return ((size_t)(hk * G + pr - pos * G) * C + pos);
}

// Zeros into the block's rows that exist (a block with no valid row).
template <int D, typename T>
__device__ void zero_rows(T* __restrict__ o, int r0, int C, int G, int hk) {
  constexpr int CPR = D * (int)sizeof(T) / 16;   // 16-byte pieces a row
  for (int i = threadIdx.x; i < kBQ * CPR; i += kNT) {
    const int pr = r0 + i / CPR;
    if (pr >= C * G) break;
    uint4* dst = reinterpret_cast<uint4*>(o + out_row(pr, G, hk, C) * D) +
                 i % CPR;
    *dst = make_uint4(0u, 0u, 0u, 0u);
  }
}

// 16 bytes from `src` into shared memory at address `dst`; zeros when !ok
// (src is then not read).
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// Element offset of key row kpos's piece e (16-byte pieces) in a pool,
// found through the lane's table (a row past the table reads its last
// entry, as the model's writes clamp).
template <int EPP>   // elements a piece
__device__ __forceinline__ size_t pool_off(const int* __restrict__ table,
                                           int kpos, int e, int hk, int Hkv,
                                           int bs, int max_blocks, int D) {
  const int blk = table[min(kpos / bs, max_blocks - 1)];
  return (((size_t)blk * Hkv + hk) * bs + kpos % bs) * D + EPP * e;
}

// ------------------------------------------------ bfloat16: wgmma tiles
// Piece c (16 bytes: 8 columns) of row r of a ROWS-row tile held as D / 64
// panels of [ROWS][128 B], 128-byte swizzled: the layout TMA writes for K1
// v3 and its wgmma descriptors read (the tile's base 1024-byte aligned).
template <int ROWS>
__device__ __forceinline__ uint32_t swz128(uint32_t base, int r, int c) {
  return base + (c >> 3) * ROWS * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

template <int D>
__host__ __device__ constexpr size_t wgmma_smem() {
  return 1024 + (size_t)kBQ * D * 2 + 4 * (size_t)kBK * D * 2;
}

template <int D>
__device__ __forceinline__ void load_kv_bf16(
    uint32_t sk, uint32_t sv, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vp, const int* __restrict__ table,
    int k0, int k_end, int hk, int Hkv, int bs, int max_blocks) {
  constexpr int CPR = D / 8;
  for (int i = threadIdx.x; i < kBK * CPR; i += kNT) {
    const int r = i / CPR, c = i % CPR;
    const int kpos = k0 + r;
    const bool ok = kpos < k_end;
    const size_t off =
        ok ? pool_off<8>(table, kpos, c, hk, Hkv, bs, max_blocks, D) : 0;
    cp16(swz128<kBK>(sk, r, c), kp + off, ok);
    cp16(swz128<kBK>(sv, r, c), vp + off, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kNT)
paged_chunk_wgmma(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ kp,
                  const __nv_bfloat16* __restrict__ vp,
                  const int* __restrict__ table,
                  const int* __restrict__ kv_len,
                  const int* __restrict__ q_offset,
                  __nv_bfloat16* __restrict__ o, int G, int Hkv, int C,
                  int bs, int max_blocks, int window, float softcap,
                  float scale) {
  constexpr int CPR = D / 8;
  constexpr uint32_t kQ = kBQ * D * 2;       // bytes of the Q tile
  constexpr uint32_t kTile = kBK * D * 2;    // bytes of one K or V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = wg::smem_u32(reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023)));
  // stage s: K at sq + kQ + 2s·kTile, V right after it

  const int hk = blockIdx.y;
  const Span w = block_span(q_offset, kv_len, C, G, window);
  if (w.n_tiles == 0) {
    zero_rows<D>(o, w.r0, C, G, hk);
    return;
  }

  for (int i = threadIdx.x; i < kBQ * CPR; i += kNT) {
    const int r = i / CPR, c = i % CPR;
    const int pr = w.r0 + r;
    const bool ok = pr / G < w.n_valid;
    const __nv_bfloat16* src = q + out_row(pr, G, hk, C) * D + 8 * c;
    cp16(swz128<kBQ>(sq, r, c), ok ? src : q, ok);
  }
  load_kv_bf16<D>(sq + kQ, sq + kQ + kTile, kp, vp, table, w.k_begin,
                  w.k_end, hk, Hkv, bs, max_blocks);
  tile::cp_async_commit();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // the thread's two rows of the accumulator fragment, 16w + lane/4 and
  // + 8, at their positions; a row past n_valid at -1, which the causal
  // mask gives no key
  int qpos[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int pos = (w.r0 + 16 * warp + lane / 4 + 8 * hh) / G;
    qpos[hh] = pos < w.n_valid ? w.q_offset + pos : -1;
  }

  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int it = 0; it < w.n_tiles; ++it) {
    const int s = it & 1;
    const int k0 = w.k_begin + it * kBK;
    if (it + 1 < w.n_tiles) {
      const uint32_t nk = sq + kQ + 2 * (s ^ 1) * kTile;
      load_kv_bf16<D>(nk, nk + kTile, kp, vp, table, k0 + kBK, w.k_end, hk,
                      Hkv, bs, max_blocks);
    }
    tile::cp_async_commit();
    tile::cp_async_wait<1>();   // Q and this tile (the next in flight)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint32_t kaddr = sq + kQ + 2 * s * kTile;
    const uint32_t vaddr = kaddr + kTile;

    // S = Q·Kᵀ
    float sacc[kBK / 2];
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) sacc[j] = 0.f;
    wg::fence_regs(sacc);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;   // k16 step in a panel
      wg::wgmma_ss(sacc, wg::smem_desc(sq + (kk / 4) * kBQ * 128 + off, 16),
                   wg::smem_desc(kaddr + (kk / 4) * kBK * 128 + off, 16));
    }
    wg::wgmma_commit();
    wg::wgmma_wait_all();
    wg::fence_regs(sacc);

    // online softmax on the fragment, K1's (wgmma.cuh), every tile masked
    float alpha[2];
    wg::softmax_tile<kBK, true>(sacc, m, l, alpha, k0, qpos[0], qpos[1],
                                lane, 1, window, w.k_end, scale, softcap);

    // O = O·alpha + P·V, P rounded to bf16 (l keeps the unrounded sum)
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = wg::pack_bf16(sacc[8 * kk + 2 * r],
                                  sacc[8 * kk + 2 * r + 1]);
      }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      oacc[4 * j] *= alpha[0];
      oacc[4 * j + 1] *= alpha[0];
      oacc[4 * j + 2] *= alpha[1];
      oacc[4 * j + 3] *= alpha[1];
    }
    wg::fence_regs(oacc);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wg::wgmma_rs(oacc, pa[kk],
                   wg::smem_desc(vaddr + kk * 16 * 128, kBK * 128));
    }
    wg::wgmma_commit();
    wg::wgmma_wait_all();
    wg::fence_regs(oacc);
    __syncthreads();   // every warp has read stage s before it is refilled
  }

  // O / l; rows past n_valid are 0
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float sum = l[hh];
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    const float inv = sum > 0.f ? 1.f / sum : 0.f;   // 0: past n_valid
    const int pr = w.r0 + 16 * warp + lane / 4 + 8 * hh;
    if (pr < C * G) {
      __nv_bfloat16* orow = o + out_row(pr, G, hk, C) * D + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(oacc[4 * j + 2 * hh] * inv,
                                  oacc[4 * j + 2 * hh + 1] * inv);
      }
    }
  }
}

// ------------------------------------------ float32: FMA micro-tiles
template <int D>
struct F32 {
  static constexpr int R = 8;                     // rows a thread
  static constexpr int LDQ = D, LDK = D + 4, LDV = D, LDP = kBK + 4;
  static constexpr int OFF_K = kBQ * LDQ;
  static constexpr int OFF_V = OFF_K + kBK * LDK;
  static constexpr int OFF_P = OFF_V + kBK * LDV;
  static constexpr size_t BYTES = sizeof(float) * (OFF_P + kBQ * LDP);
};

// Key rows k0 .. k0 + 63 of one pool into a [64][LD] float tile; rows at
// or past k_end are zeros.
template <int D, int LD>
__device__ __forceinline__ void load_kv_f32(
    float* __restrict__ dst, const float* __restrict__ pool,
    const int* __restrict__ table, int k0, int k_end, int hk, int Hkv,
    int bs, int max_blocks) {
  constexpr int CPR = D / 4;
  for (int i = threadIdx.x; i < kBK * CPR; i += kNT) {
    const int r = i / CPR, c = i % CPR;
    const int kpos = k0 + r;
    const bool ok = kpos < k_end;
    const size_t off =
        ok ? pool_off<4>(table, kpos, c, hk, Hkv, bs, max_blocks, D) : 0;
    tile::cp_async16(dst + r * LD + 4 * c, pool + off, ok);
  }
}

// Blocks an SM holds: three at D 64 (67.6 KB of shared memory each), one at
// D 128 (116.7 KB), so ptxas may give a D 128 thread all 255 registers.
template <int D>
__global__ void __launch_bounds__(kNT, D == 64 ? 3 : 1)
paged_chunk_f32(const float* __restrict__ q, const float* __restrict__ kp,
                const float* __restrict__ vp, const int* __restrict__ table,
                const int* __restrict__ kv_len,
                const int* __restrict__ q_offset, float* __restrict__ o,
                int G, int Hkv, int C, int bs, int max_blocks, int window,
                float softcap, float scale) {
  using L = F32<D>;
  constexpr int R = L::R, NJ = kBK / tile::kTX, NH = D / 64, CPR = D / 4;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = smem + L::OFF_K;
  float* sV = smem + L::OFF_V;
  float* sP = smem + L::OFF_P;

  const int hk = blockIdx.y;
  const Span w = block_span(q_offset, kv_len, C, G, window);
  if (w.n_tiles == 0) {
    zero_rows<D>(o, w.r0, C, G, hk);
    return;
  }
  const int ty = threadIdx.x / tile::kTX, tx = threadIdx.x % tile::kTX;
  const int row0 = ty * R;                          // first row of the thread

  for (int i = threadIdx.x; i < kBQ * CPR; i += kNT) {
    const int r = i / CPR, c = i % CPR;
    const int pr = w.r0 + r;
    const bool ok = pr / G < w.n_valid;
    tile::cp_async16(sQ + r * L::LDQ + 4 * c,
                     ok ? q + out_row(pr, G, hk, C) * D + 4 * c : q, ok);
  }
  load_kv_f32<D, L::LDK>(sK, kp, table, w.k_begin, w.k_end, hk, Hkv, bs,
                         max_blocks);
  tile::cp_async_commit();
  load_kv_f32<D, L::LDV>(sV, vp, table, w.k_begin, w.k_end, hk, Hkv, bs,
                         max_blocks);
  tile::cp_async_commit();

  float oacc[R][4 * NH];
  float m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NH; ++c) oacc[i][c] = 0.f;
  }

  for (int it = 0; it < w.n_tiles; ++it) {
    const int k0 = w.k_begin + it * kBK;
    const bool more = it + 1 < w.n_tiles;
    tile::cp_async_wait<1>();   // Q and this K tile (V may be in flight)
    __syncthreads();
    float s[R][NJ];
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
    }
    tile::abt<R, NJ, D, L::LDQ, L::LDK>(sQ + row0 * L::LDQ, sK, s);
    __syncthreads();            // every thread has read this K tile
    if (more) {
      load_kv_f32<D, L::LDK>(sK, kp, table, k0 + kBK, w.k_end, hk, Hkv, bs,
                             max_blocks);
      tile::cp_async_commit();
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      // the row's position (recomputed: registers are the f32 tile's)
      const int pos = (w.r0 + row0 + i) / G;
      const bool live = pos < w.n_valid;
      const int qpos = w.q_offset + pos;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const int kpos = k0 + tx + tile::kTX * j;
        bool ok = live && kpos <= qpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        x = ok ? x : -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = tile::row_max16(mx);
      const float base = mx == -INFINITY ? 0.f : mx;   // no valid key yet
      const float alpha = exp2f((m[i] - base) * kLog2e);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float p = exp2f((s[i][j] - base) * kLog2e);
        sP[(row0 + i) * L::LDP + tx + tile::kTX * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + sum;
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < 4 * NH; ++c) oacc[i][c] *= alpha;
    }
    if (more) {
      tile::cp_async_wait<1>();   // this V tile (the next K may be in flight)
    } else {
      tile::cp_async_wait<0>();
    }
    __syncthreads();              // P and this V tile visible
    tile::ab<R, NH, kBK, L::LDP, L::LDV>(sP + row0 * L::LDP, sV, oacc);
    __syncthreads();              // every thread has read P and this V tile
    if (more) {
      load_kv_f32<D, L::LDV>(sV, vp, table, k0 + kBK, w.k_end, hk, Hkv, bs,
                             max_blocks);
      tile::cp_async_commit();
    }
  }

  // O / l; rows past n_valid are 0
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float sum = tile::row_sum16(l[i]);
    const int pr = w.r0 + row0 + i;
    if (pr < C * G) {
      const float inv = pr / G < w.n_valid && sum > 0.f ? 1.f / sum : 0.f;
      float* orow = o + out_row(pr, G, hk, C) * D + 4 * tx;
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) {
        tile::store4(orow + 64 * hh, oacc[i][4 * hh] * inv,
                     oacc[i][4 * hh + 1] * inv, oacc[i][4 * hh + 2] * inv,
                     oacc[i][4 * hh + 3] * inv);
      }
    }
  }
}

template <int D>
static int launch(int dtype, const void* q, const void* kp, const void* vp,
                  const int* table, const int* kv_len, const int* q_offset,
                  void* o, int G, int Hkv, int C, int bs, int max_blocks,
                  int window, float softcap, float scale,
                  cudaStream_t stream) {
  const dim3 grid((C * G + kBQ - 1) / kBQ, Hkv);
  if (dtype == 1) {
    auto kern = paged_chunk_wgmma<D>;
    static size_t allowed = 0;
    if (!raise_smem_limit(kern, wgmma_smem<D>(), allowed)) {
      return (int)cudaGetLastError();
    }
    kern<<<grid, kNT, wgmma_smem<D>(), stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(kp),
        static_cast<const __nv_bfloat16*>(vp), table, kv_len, q_offset,
        static_cast<__nv_bfloat16*>(o), G, Hkv, C, bs, max_blocks, window,
        softcap, scale);
  } else {
    auto kern = paged_chunk_f32<D>;
    static size_t allowed = 0;
    if (!raise_smem_limit(kern, F32<D>::BYTES, allowed)) {
      return (int)cudaGetLastError();
    }
    kern<<<grid, kNT, F32<D>::BYTES, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(kp),
        static_cast<const float*>(vp), table, kv_len, q_offset,
        static_cast<float*>(o), G, Hkv, C, bs, max_blocks, window, softcap,
        scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace chunk
}  // namespace repro_torch

using namespace repro_torch;

// dtype: 0 = float32, 1 = bfloat16. q (1, Hq, C, D); pools (num_blocks,
// Hkv, block_size, D); table (max_blocks,) int32; kv_len (1,) and q_offset
// (0-d) int32, both read on the device; o (1, Hq, C, D). window <= 0 and
// softcap <= 0 mean none. Returns the cudaError_t of the launch.
extern "C" int repro_paged_chunk_attention(
    int dtype, int head_dim, const void* q, const void* k_pool,
    const void* v_pool, const void* table, const void* kv_len,
    const void* q_offset, void* o, int Hq, int Hkv, int C, int block_size,
    int max_blocks, int window, float softcap, float scale, void* stream) {
  if ((dtype != 0 && dtype != 1) || Hkv <= 0 || Hq % Hkv) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tab = static_cast<const int*>(table);
  const int* kl = static_cast<const int*>(kv_len);
  const int* qo = static_cast<const int*>(q_offset);
#define REPRO_K6(DD)                                                         \
  return chunk::launch<DD>(dtype, q, k_pool, v_pool, tab, kl, qo, o,         \
                           Hq / Hkv, Hkv, C, block_size, max_blocks, window, \
                           softcap, scale, st)
  if (head_dim == 64) REPRO_K6(64);
  if (head_dim == 128) REPRO_K6(128);
#undef REPRO_K6
  return (int)cudaErrorInvalidValue;
}

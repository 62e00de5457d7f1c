// K7: the routed experts of a dropless MoE layer, grouped by expert, by
// hand for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package runs its MoE FFN as one dense
// product over an (experts, capacity) buffer (`repro/models/moe.py`), and
// the port's capacity path does the same. Dropless serving with that
// buffer computes a slot of every expert for every token: E x T rows for
// the T x k that were routed (21x at a 64-lane decode of 128 experts,
// top-6), and streams every expert's weights whatever the load. This
// kernel computes the routed (token, expert) rows only and reads each
// touched expert's weights once.
//
// Function: rows sorted by expert (the caller's stable sort on the
// device); offsets (E + 1,) the first sorted row of each expert, offsets[E]
// the routed rows; token[r] the token of sorted row r, slot[r] its place
// t·k + j in the output, gate (T·k,) the weight of each (token, choice).
// For each expert e and its rows: h = relu(x W_up[e]ᵀ)² (W_up (E, f, d),
// rows the output channels), then y[slot] = gate[slot] · h W_down[e]ᵀ
// (W_down (E, d, f)), float32. Rows that routed nowhere (a dead lane's)
// are not in the list: the caller's zeros stay in their slots.
//
// Device-side lengths: offsets and the tile table are read from device
// memory, so one CUDA graph captured per shape serves every routing. The
// grid is fixed at launch: (N / 64, tiles), tiles = min(R, R / 64 + E)
// bounds sum_e ceil(n_e / 64); block y = t finds its expert in tile_start
// (E + 1,) by binary search and exits past tile_start[E].
//
// Two kernels a call (one count): the up product with relu² into h (R, f)
// bf16, then the down product from h into y. Each block owns a 64-row,
// 64-column output tile of one expert: one warpgroup of 128 threads, wgmma
// m64n64k16 from shared memory (K1 v3's and K6's products), A and B tiles
// copied by cp.async into 128-byte swizzled panels (K6's loader: x rows
// gathered through token[], weight rows contiguous), four stages in flight
// so that loads overlap the products.
//
// Bound on this card: the weights dominate the bytes, 2·d·f·2 B an expert
// touched (19.95 MB at Nemotron-3-Nano's widths), and rows are few (6 a
// token), so it is bound by memory: with 8 live lanes ~41 of 128 experts
// are touched, 0.24 ms at 3.35 TB/s per layer. Even a 2,048-token prefill
// (12,288 rows, 4·rows·d·f = 245 GFLOP) reads every expert, 2.75 GB: 89
// operations a byte, below the card's 295, so the bytes bound it (0.82
// ms) and the design streams each expert's weights once, 64 rows of them
// a block, rather than reusing a tile across many row tiles.
#include "attention_common.cuh"
#include "flash_common.cuh"
#include "wgmma.cuh"

namespace repro_torch {
namespace moe {

constexpr int kBM = 64;           // rows a tile
constexpr int kBN = 64;           // output columns a tile
constexpr int kBK = 64;           // depth a stage (one 128-byte panel)
constexpr int kNT = 128;          // threads: one warpgroup
constexpr int kStages = 4;
constexpr uint32_t kPanel = kBM * kBK * 2;   // bytes of one A or B tile
constexpr size_t kSmem = 1024 + (size_t)kStages * 2 * kPanel;
// the 16-byte pieces a thread copies per tile: rows tid / 8 + 16 i
constexpr int kPieces = kBM * kBK / 8 / kNT;

// 16 bytes from `src` into shared memory at address `dst`; zeros when !ok
// (src is then not read). As K6's.
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// Piece c of row r of a 64-row [64][128 B] panel, 128-byte swizzled.
__device__ __forceinline__ uint32_t swz(uint32_t base, int r, int c) {
  return base + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// The expert that tile t belongs to: the last e < E with tile_start[e] <= t.
__device__ __forceinline__ int find_expert(const int* __restrict__ ts, int E,
                                           int t) {
  int lo = 0, hi = E;              // ts[lo] <= t < ts[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (ts[mid] <= t) lo = mid; else hi = mid;
  }
  return lo;
}

// UP: a = x (T, K) rows through token[], w = W_up, out h (R, N) bf16 of
// relu(acc)². DOWN: a = h (R, K), w = W_down, out y (T·k, N) float32 at
// slot[r], times gate[slot[r]].
template <bool UP>
__global__ void __launch_bounds__(kNT)
moe_gemm(const __nv_bfloat16* __restrict__ a,
         const __nv_bfloat16* __restrict__ w, const int* __restrict__ token,
         const int* __restrict__ slot, const float* __restrict__ gate,
         const int* __restrict__ offsets, const int* __restrict__ tile_start,
         __nv_bfloat16* __restrict__ h, float* __restrict__ y, int E, int K,
         int N) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = wg::smem_u32(reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023)));
  // stage s: the A tile at base + 2s·kPanel, the B tile right after it

  const int t = blockIdx.y;
  if (t >= tile_start[E]) return;
  const int e = find_expert(tile_start, E, t);
  const int r0 = offsets[e] + (t - tile_start[e]) * kBM;
  const int r1 = min(offsets[e + 1], r0 + kBM);
  const int n0 = blockIdx.x * kBN;

  // the thread's rows and piece, and where they start in memory
  const int c = threadIdx.x % 8;
  const __nv_bfloat16* asrc[kPieces];
  const __nv_bfloat16* wsrc[kPieces];
  bool aok[kPieces];
#pragma unroll
  for (int i = 0; i < kPieces; ++i) {
    const int r = threadIdx.x / 8 + 16 * i;
    const int row = r0 + r;
    aok[i] = row < r1;
    const size_t arow = !aok[i] ? 0 : UP ? (size_t)token[row] : (size_t)row;
    asrc[i] = a + arow * K + 8 * c;
    wsrc[i] = w + ((size_t)e * N + n0 + r) * K + 8 * c;
  }
  auto load = [&](int stage, int k0) {
    const uint32_t sa = base + 2 * stage * kPanel;
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      const int r = threadIdx.x / 8 + 16 * i;
      cp16(swz(sa, r, c), asrc[i] + k0, aok[i]);
      cp16(swz(sa + kPanel, r, c), wsrc[i] + k0, true);
    }
  };

  const int nk = K / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s * kBK);
    tile::cp_async_commit();
  }

  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;

  for (int it = 0; it < nk; ++it) {
    const int pre = it + kStages - 1;
    if (pre < nk) load(pre % kStages, pre * kBK);
    tile::cp_async_commit();
    tile::cp_async_wait<kStages - 1>();     // stage `it` has landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint32_t sa = base + 2 * (it % kStages) * kPanel;
    wg::fence_regs(acc);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wg::wgmma_ss(acc, wg::smem_desc(sa + kk * 32, 16),
                   wg::smem_desc(sa + kPanel + kk * 32, 16));
    }
    wg::wgmma_commit();
    wg::wgmma_wait_all();
    wg::fence_regs(acc);
    __syncthreads();   // every warp has read the stage before it is refilled
  }

  // the fragment: rows 16·warp + lane/4 (+ 8), columns 8j + 2(lane % 4)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + 16 * warp + lane / 4 + 8 * hh;
    if (row >= r1) continue;
    const int col = n0 + 2 * (lane % 4);
    if (UP) {
      __nv_bfloat16* out = h + (size_t)row * N + col;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const float v0 = fmaxf(acc[4 * j + 2 * hh], 0.f);
        const float v1 = fmaxf(acc[4 * j + 2 * hh + 1], 0.f);
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
            __floats2bfloat162_rn(v0 * v0, v1 * v1);
      }
    } else {
      const int s = slot[row];
      const float g = gate[s];
      float* out = y + (size_t)s * N + col;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        *reinterpret_cast<float2*>(out + 8 * j) =
            make_float2(acc[4 * j + 2 * hh] * g, acc[4 * j + 2 * hh + 1] * g);
      }
    }
  }
}

}  // namespace moe
}  // namespace repro_torch

using namespace repro_torch;

// K7, bfloat16 x and weights. x (T, d); w_up (E, f, d); w_down (E, d, f);
// token, slot (R,) int32; gate (T·k = R,) float32; offsets, tile_start
// (E + 1,) int32; h (R, f) bf16 scratch; y (R, d) float32, zeroed by the
// caller. d and f multiples of 64. tiles: the grid's bound on tiles.
// passes: bit 0 the up product, bit 1 the down product (3 for a call).
// Returns the cudaError_t of the launches (0 on success).
extern "C" int repro_moe_experts(const void* x, const void* w_up,
                                 const void* w_down, const int* token,
                                 const int* slot, const float* gate,
                                 const int* offsets, const int* tile_start,
                                 void* h, float* y, int E, int d, int f,
                                 int tiles, int passes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % moe::kBN || f % moe::kBN || tiles <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* hb = static_cast<__nv_bfloat16*>(h);
  if (passes & 1) {
    auto kern = moe::moe_gemm<true>;
    static size_t allowed = 0;
    if (!raise_smem_limit(kern, moe::kSmem, allowed)) {
      return (int)cudaGetLastError();
    }
    kern<<<dim3(f / moe::kBN, tiles), moe::kNT, moe::kSmem, st>>>(
        xb, static_cast<const __nv_bfloat16*>(w_up), token, slot, gate,
        offsets, tile_start, hb, nullptr, E, d, f);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (passes & 2) {
    auto kern = moe::moe_gemm<false>;
    static size_t allowed = 0;
    if (!raise_smem_limit(kern, moe::kSmem, allowed)) {
      return (int)cudaGetLastError();
    }
    kern<<<dim3(d / moe::kBN, tiles), moe::kNT, moe::kSmem, st>>>(
        hb, static_cast<const __nv_bfloat16*>(w_down), token, slot, gate,
        offsets, tile_start, nullptr, y, E, f, d);
  }
  return (int)cudaGetLastError();
}

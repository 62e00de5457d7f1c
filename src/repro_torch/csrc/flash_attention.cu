// K1: blockwise (flash) attention for prefill, by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention, body _flash_kernel). Same function: grouped-query
// attention with an online softmax in float32, causal or not, optional
// sliding window, tanh softcap (before the mask), a static q_offset (which
// may be negative) and sk_valid masking; key tiles with no live key are
// skipped and a row with no valid key returns 0, as Pallas gives.
//
// The TPU grid runs its K axis in order and carries (m, l, acc) in VMEM
// scratch from one grid step to the next. Here blocks run in parallel, so
// that carry is a loop inside one block. The KV head is h / (Hq / Hkv).
//
// Bound on this card: causal work of about 2·Sq·Sk·D operations per query
// head over (2·Hq·Sq + 2·Hkv·Sk)·D elements read and written, about 0.4·S
// operations per bf16 byte at mistral-7b's heads (Sq = Sk = S): below the
// card's 295 at the serving S = 512, so its least time there is set by
// bytes, and above it from S ≈ 740. Either way the kernel's time goes to
// the products and their softmax, which is why they run on tensor cores.
//
// Two kernels sit behind one entry point:
//
// v3, bfloat16 (flash_fwd_wgmma): the products run on the tensor cores.
// One block per (q tile, q head, batch), the heaviest causal q tiles issued
// first. Warpgroup 0 is the producer: one thread keeps a ring of kStages
// K/V tiles in flight by TMA (one mbarrier per stage for "full" and one for
// "empty"), after loading the block's Q once. Each consumer warpgroup owns 64
// query rows (block_q 64 or 128: one or two consumers) and, per K/V tile:
//   S = Q·Kᵀ     wgmma m64n{block_k}k16, Q and K (K-major) from shared
//                memory, float32 accumulators in registers;
//   softmax      on the accumulator fragment: thread t of warp w holds rows
//                16w + t/4 and 16w + t/4 + 8, columns 8j + 2(t%4) + {0, 1};
//                S·D^-0.5 in float32 (Q is not pre-scaled in bf16), then
//                softcap, then the masks; row max and sum across the quad
//                by two shuffles; m and l in float32 registers;
//   O += P·V     P rounded to bf16 in registers (its fragment is the A
//                operand of a k16 slice as it stands), V from shared memory
//                as an MN-major B (transpose flag), O in float32 registers,
//                rescaled by alpha per tile.
// The tiles are 128-byte swizzled panels of 64 columns (a D = 128 row is two
// panels), the layout TMA writes and wgmma's descriptors read. With two
// consumers, setmaxnreg moves registers from the producer to them (24 and
// 240 per thread of the 168 the block launches with). TMA's zero fill
// covers the ragged Sq/Sk edge; the masks still decide validity.
// Precision: the Pallas kernel computes in float32. v3 forms Q·Kᵀ from the
// same bf16 values with float32 accumulation; its one new rounding is P to
// bf16 before P·V, a relative error of at most 2^-9 per term, far inside
// the bf16 tolerance of 2e-2. The row sums l use the unrounded P.
//
// v4, float32 (flash_fwd_f32): tensor cores would mean TF32, which misses
// the float32 tolerance of 2e-5, so float32 stays on the CUDA cores, where
// the bound is the FMA rate (67e12 FLOP/s) and the risk is the shared
// memory that feeds it (flash_common.cuh). One block of 2·block_q threads
// per (q tile, q head, batch), heaviest causal q tiles first. Thread
// (ty, tx) owns query rows 8ty .. 8ty+7 and, per K/V tile, keys tx, tx+16,
// ...: S = Q·Kᵀ on an 8 x (block_k/16) register tile (8 x 4 at the default
// 64 x 64), the online softmax on it (row max and sum over the half warp by
// shuffles; each thread keeps its own share of l), P to shared memory, then
// O += P·V on an 8 x (D/16) register tile of the same rows, so m, l and O
// of a row never leave the threads that own it. Q, K and V tiles are
// copied by cp.async, K rows padded to D + 4 floats. K and V have one
// buffer each and are refilled as soon as they are read: the next K tile
// loads during this tile's softmax and P·V, the next V tile during the next
// tile's Q·Kᵀ. At 64 x 64 and D 64 a block holds 67.5 KB, so three blocks
// (12 warps) share an SM.
//
// Both kernels can write each row's logsumexp, lse = m + log l in the units
// of the scaled, softcapped logits (+inf for a row with no valid key): K1's
// autograd Function hands it to K1-bwd, which then recomputes no row
// statistics. A null lse pointer writes nothing (the serving path).
#include <cuda.h>

#include "flash_common.cuh"
#include "wgmma.cuh"

namespace repro_torch {

// ------------------------------------------ v4: float32, FMA micro-tiles
namespace v4 {

constexpr size_t kSmemLimit = 232448;     // dynamic shared memory of a block
constexpr float kLog2e = 1.4426950408889634f;

template <int D, int BQ, int BK>
struct Layout {
  static constexpr int R = 8;                     // query rows a thread
  static constexpr int NT = BQ / R * tile::kTX;   // threads of a block
  static constexpr int LDQ = D, LDK = D + 4, LDV = D, LDP = BK + 4;
  static constexpr int OFF_K = BQ * LDQ;
  static constexpr int OFF_V = OFF_K + BK * LDK;
  static constexpr int OFF_P = OFF_V + BK * LDV;
  static constexpr size_t BYTES = sizeof(float) * (OFF_P + BQ * LDP);
  // blocks an SM should hold, for the register budget: three 128-thread
  // blocks at D 64 where their shared memory fits (64 x 64 and 64 x 32),
  // else one
  static constexpr int MIN_BLOCKS =
      D == 64 && NT == 128 && 3 * BYTES <= kSmemLimit ? 3 : 1;
};

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(Layout<D, BQ, BK>::NT,
                                  Layout<D, BQ, BK>::MIN_BLOCKS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk,
              int causal, int window, float softcap, float scale,
              int q_offset, int sk_valid) {
  using L = Layout<D, BQ, BK>;
  constexpr int R = L::R, NT = L::NT, NJ = BK / tile::kTX, NH = D / 64;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = smem + L::OFF_K;
  float* sV = smem + L::OFF_V;
  float* sP = smem + L::OFF_P;

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int qt = n_qt - 1 - (int)blockIdx.x / Hq;   // heaviest tiles first
  const int h = (int)blockIdx.x % Hq;
  const int b = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int rows = min(BQ, Sq - q0);
  const int ty = threadIdx.x / tile::kTX, tx = threadIdx.x % tile::kTX;
  const int row0 = ty * R;                          // first row of the thread

  // live key range of the whole q tile: the structural block skip
  const int q_first = q0 + q_offset;
  const int q_last = q0 + rows - 1 + q_offset;
  int k_end = sk_valid;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_first - window + 1);
  k_begin = (k_begin / BK) * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  const size_t qoff = (((size_t)b * Hq + h) * Sq + q0) * D;
  const float* kb = k + ((size_t)b * Hkv + hk) * Sk * D;
  const float* vb = v + ((size_t)b * Hkv + hk) * Sk * D;
  if (n_tiles > 0) {
    tile::load_tile<BQ, D, L::LDQ, NT>(sQ, q + qoff, rows);
    tile::load_tile<BK, D, L::LDK, NT>(sK, kb + (size_t)k_begin * D,
                                       sk_valid - k_begin);
    tile::cp_async_commit();
    tile::load_tile<BK, D, L::LDV, NT>(sV, vb + (size_t)k_begin * D,
                                       sk_valid - k_begin);
    tile::cp_async_commit();
  }

  float oacc[R][4 * NH];
  float m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NH; ++c) oacc[i][c] = 0.f;
  }
  const int qpos0 = q0 + row0 + q_offset;
  // a warp's 2R rows, for the test that skips the masks
  const int w_first = q0 + (int)(threadIdx.x / 32) * 2 * R + q_offset;
  const int w_last = w_first + 2 * R - 1;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * BK;
    const bool more = it + 1 < n_tiles;
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
      tile::load_tile<BK, D, L::LDK, NT>(sK, kb + (size_t)(k0 + BK) * D,
                                         sk_valid - k0 - BK);
      tile::cp_async_commit();
    }

    // online softmax on the register tile; a tile whose every key is valid
    // for every row of this warp skips the masks
    const bool interior = k0 + BK <= sk_valid &&
                          (!causal || k0 + BK - 1 <= w_first) &&
                          (window <= 0 || w_last - k0 < window);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qpos = qpos0 + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        if (!interior) {
          const int kpos = k0 + tx + tile::kTX * j;
          bool ok = kpos < sk_valid;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && (qpos - kpos) < window;
          x = ok ? x : -INFINITY;
        }
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
    tile::ab<R, NH, BK, L::LDP, L::LDV>(sP + row0 * L::LDP, sV, oacc);
    __syncthreads();              // every thread has read P and this V tile
    if (more) {
      tile::load_tile<BK, D, L::LDV, NT>(sV, vb + (size_t)(k0 + BK) * D,
                                         sk_valid - k0 - BK);
      tile::cp_async_commit();
    }
  }

  // O / l and lse; a row that saw no valid key (l == 0) is 0, lse +inf
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float sum = tile::row_sum16(l[i]);
    const int r = row0 + i;
    if (r < rows) {
      const float inv = sum == 0.f ? 0.f : 1.f / sum;
      float* orow = o + qoff + (size_t)r * D + 4 * tx;
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) {
        tile::store4(orow + 64 * hh, oacc[i][4 * hh] * inv,
                     oacc[i][4 * hh + 1] * inv, oacc[i][4 * hh + 2] * inv,
                     oacc[i][4 * hh + 3] * inv);
      }
      if (lse != nullptr && tx == 0) {
        lse[((size_t)b * Hq + h) * Sq + q0 + r] =
            sum > 0.f ? m[i] + logf(sum) : INFINITY;
      }
    }
  }
}

template <int D, int BQ, int BK>
static int launch(const void* q, const void* k, const void* v, void* o,
                  float* lse, int B, int Hq, int Hkv, int Sq, int Sk,
                  int causal, int window, float softcap, float scale,
                  int q_offset, int sk_valid, cudaStream_t stream) {
  using L = Layout<D, BQ, BK>;
  auto kern = flash_fwd_f32<D, BQ, BK>;
  static size_t allowed = 0;
  if (!raise_smem_limit(kern, L::BYTES, allowed)) {
    return (int)cudaGetLastError();
  }
  const int n_qt = (Sq + BQ - 1) / BQ;
  dim3 grid(n_qt * Hq, B);
  kern<<<grid, L::NT, L::BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Hq, Hkv, Sq,
      Sk, causal, window, softcap, scale, q_offset, sk_valid);
  return (int)cudaGetLastError();
}

template <int D>
static int dispatch(const void* q, const void* k, const void* v, void* o,
                    float* lse, int B, int Hq, int Hkv, int Sq, int Sk,
                    int causal, int window, float softcap, float scale,
                    int q_offset, int sk_valid, int bq, int bk,
                    cudaStream_t st) {
#define REPRO_V4(BQ, BK)                                                    \
  if (bq == BQ && bk == BK)                                                 \
  return launch<D, BQ, BK>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, causal,     \
                           window, softcap, scale, q_offset, sk_valid, st)
  REPRO_V4(64, 32);
  REPRO_V4(64, 64);
  REPRO_V4(64, 128);
  REPRO_V4(128, 32);
  REPRO_V4(128, 64);
  if constexpr (Layout<D, 128, 128>::BYTES <= kSmemLimit) {
    REPRO_V4(128, 128);   // D 64 only: 260 KB at D 128
  }
#undef REPRO_V4
  return (int)cudaErrorInvalidValue;
}

}  // namespace v4

// ------------------------------------------- v3: bfloat16, wgmma and TMA
namespace v3 {

constexpr int kStages = 2;        // K/V tiles in flight
constexpr int kWG = 128;          // threads of a warpgroup
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

using namespace wg;

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to wait for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Until the phase of parity `parity` has completed. A wait that outlasts
// ~2^34 cycles (seconds: a pipeline fault, never a slow load) traps, so a
// fault ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

// One box of a 3-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

template <int D, int BK, int NC>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + (size_t)64 * NC * D * 2 + (size_t)kStages * 2 * BK * D * 2 +
         (2 * kStages + 1) * sizeof(uint64_t);
}

template <int D, int BK, int NC>
__global__ void __launch_bounds__((NC + 1) * kWG, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                int Hq, int Hkv, int Sq, int causal, int window,
                float softcap, float scale, int q_offset, int sk_valid) {
  constexpr int BQ = 64 * NC;
  constexpr int P = D / 64;                  // 128-byte panels per row
  constexpr uint32_t kTile = BK * D * 2;     // bytes of one K or V tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sk = sq + BQ * D * 2;             // [kStages][P][BK][128 B]
  uint8_t* sv = sk + kStages * kTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(sv + kStages * kTile);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int qt = n_qt - 1 - (int)blockIdx.x / Hq;   // heaviest tiles first
  const int h = (int)blockIdx.x % Hq;
  const int b = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int rows = min(BQ, Sq - q0);

  // live key range of the whole q tile: the structural block skip
  const int q_first = q0 + q_offset;
  const int q_last = q0 + rows - 1 + q_offset;
  int k_end = sk_valid;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_first - window + 1);
  k_begin = (k_begin / BK) * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC * kWG);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWG;
  if (wg == 0) {
    // ------------------------------------------------ producer warpgroup
    if constexpr (NC == 2) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          kProducerRegs));
    }
    if (threadIdx.x == 0 && n_tiles > 0) {
      const int nq = (rows + 63) / 64;       // consumers that own rows
      mbar_expect_tx(qbar, nq * 64 * D * 2);
      for (int c = 0; c < nq; ++c) {
        for (int p = 0; p < P; ++p) {
          tma_load(sq + p * BQ * 128 + c * 64 * 128, &tq, qbar, 64 * p,
                   q0 + 64 * c, b * Hq + h);
        }
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * kTile);
        const int k0 = k_begin + i * BK;
        for (int p = 0; p < P; ++p) {
          tma_load(sk + s * kTile + p * BK * 128, &tk, &full[s], 64 * p, k0,
                   b * Hkv + hk);
          tma_load(sv + s * kTile + p * BK * 128, &tv, &full[s], 64 * p, k0,
                   b * Hkv + hk);
        }
      }
    }
  } else {
    // ------------------------------------------------ consumer warpgroups
    if constexpr (NC == 2) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
          kConsumerRegs));
    }
    const int c = wg - 1;
    const int tid = threadIdx.x % kWG;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int row0 = 64 * c + 16 * warp + lane / 4;   // and row0 + 8
    const int qpos0 = q0 + row0 + q_offset;
    const int my_rows = min(64, rows - 64 * c);       // <= 0: none
    const int wg_first = q0 + 64 * c + q_offset;
    const int wg_last = wg_first + my_rows - 1;
    const uint32_t qaddr = smem_u32(sq) + c * 64 * 128;

    float oacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};

    if (n_tiles > 0) mbar_wait(qbar, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const int k0 = k_begin + i * BK;
      mbar_wait(&full[s], (i / kStages) & 1);
      const bool dead = my_rows <= 0 || k0 >= sk_valid ||
                        (causal && k0 > wg_last) ||
                        (window > 0 && wg_first - (k0 + BK - 1) >= window);
      if (!dead) {
        // S = Q·Kᵀ
        float sacc[BK / 2];
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) sacc[j] = 0.f;
        fence_regs(sacc);
        wgmma_fence();
        const uint32_t kaddr = smem_u32(sk + s * kTile);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;   // k16 step in a panel
          wgmma_ss(sacc, smem_desc(qaddr + (kk / 4) * BQ * 128 + off, 16),
                   smem_desc(kaddr + (kk / 4) * BK * 128 + off, 16));
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sacc);

        // online softmax on the fragment; a tile whose every key is valid
        // for every row of this warpgroup skips the masks
        float alpha[2];
        const bool interior =
            k0 + BK <= sk_valid && (!causal || k0 + BK - 1 <= wg_first) &&
            (window <= 0 || wg_last - k0 < window);
        if (interior) {
          softmax_tile<BK, false>(sacc, m, l, alpha, k0, qpos0, qpos0 + 8,
                                  lane, causal, window, sk_valid, scale,
                                  softcap);
        } else {
          softmax_tile<BK, true>(sacc, m, l, alpha, k0, qpos0, qpos0 + 8,
                                 lane, causal, window, sk_valid, scale,
                                 softcap);
        }

        // O = O·alpha + P·V
        uint32_t pa[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pa[kk][r] = pack_bf16(sacc[8 * kk + 2 * r],
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
        fence_regs(oacc);
        wgmma_fence();
        const uint32_t vaddr = smem_u32(sv + s * kTile);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wgmma_rs(oacc, pa[kk], smem_desc(vaddr + kk * 16 * 128, BK * 128));
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(oacc);
      }
      mbar_arrive(&empty[s]);
    }

    // O / l and lse; a row that saw no valid key (l == 0) is 0, lse +inf
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float sum = l[hh];
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      const float inv = sum == 0.f ? 0.f : 1.f / sum;
      const int r = row0 + 8 * hh;
      if (r < rows) {
        if (lse != nullptr && lane % 4 == 0) {
          lse[((size_t)b * Hq + h) * Sq + q0 + r] =
              sum > 0.f ? m[hh] + logf(sum) : INFINITY;
        }
        __nv_bfloat16* orow =
            o + (((size_t)b * Hq + h) * Sq + q0 + r) * D + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
              __floats2bfloat162_rn(oacc[4 * j + 2 * hh] * inv,
                                    oacc[4 * j + 2 * hh + 1] * inv);
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime so the
// library needs no -lcuda.
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found =
        cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A (BH, S, D) bf16 tensor read in boxes of 64 columns x `rows` rows of one
// (batch, head), 128-byte swizzled; rows past S read as zeros.
static bool make_map(CUtensorMap* map, const void* ptr, int D, int S, int BH,
                     int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int BK, int NC>
static int launch(const void* q, const void* k, const void* v, void* o,
                  float* lse, int B, int Hq, int Hkv, int Sq, int Sk,
                  int causal, int window, float softcap, float scale,
                  int q_offset, int sk_valid, cudaStream_t stream) {
  constexpr int threads = (NC + 1) * kWG;
  const size_t smem = smem_bytes<D, BK, NC>();
  auto kern = flash_fwd_wgmma<D, BK, NC>;
  static size_t allowed = 0;
  if (!raise_smem_limit(kern, smem, allowed)) return (int)cudaGetLastError();
  // setmaxnreg.inc waits until the block's register pool can serve it: a
  // kernel compiled to fewer registers than the producer gives back would
  // hang, so refuse it instead.
  static int regs = -1;
  if (regs < 0) {
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, kern) != cudaSuccess) {
      return (int)cudaGetLastError();
    }
    regs = attr.numRegs;
  }
  if (NC == 2 && regs * threads < kWG * (kProducerRegs + NC * kConsumerRegs)) {
    return (int)cudaErrorInvalidConfiguration;
  }
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, D, Sq, B * Hq, 64) ||
      !make_map(&tk, k, D, Sk, B * Hkv, BK) ||
      !make_map(&tv, v, D, Sk, B * Hkv, BK)) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_qt = (Sq + 64 * NC - 1) / (64 * NC);
  dim3 grid(n_qt * Hq, B);
  kern<<<grid, threads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, Hq, Hkv, Sq, causal,
      window, softcap, scale, q_offset, sk_valid);
  return (int)cudaGetLastError();
}

template <int D>
static int dispatch(const void* q, const void* k, const void* v, void* o,
                    float* lse, int B, int Hq, int Hkv, int Sq, int Sk,
                    int causal, int window, float softcap, float scale,
                    int q_offset, int sk_valid, int bq, int bk,
                    cudaStream_t st) {
#define REPRO_V3(BK, NC)                                                     \
  if (bk == BK && bq == 64 * NC)                                             \
  return launch<D, BK, NC>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, causal,      \
                           window, softcap, scale, q_offset, sk_valid, st)
  REPRO_V3(32, 1);
  REPRO_V3(64, 1);
  REPRO_V3(128, 1);
  REPRO_V3(32, 2);
  REPRO_V3(64, 2);
  REPRO_V3(128, 2);
#undef REPRO_V3
  return (int)cudaErrorInvalidValue;
}

}  // namespace v3
}  // namespace repro_torch

using namespace repro_torch;

// dtype: 0 = float32 (v4), 1 = bfloat16 (v3). window <= 0 and softcap <= 0
// mean none. lse: float32 (B, Hq, Sq), or null for none. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int repro_flash_attention(int dtype, int head_dim, const void* q,
                                     const void* k, const void* v, void* o,
                                     void* lse, int B, int Hq, int Hkv,
                                     int Sq, int Sk, int causal, int window,
                                     float softcap, float scale, int q_offset,
                                     int sk_valid, int block_q, int block_k,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define REPRO_K1(NS, DD)                                                    \
  return NS::dispatch<DD>(q, k, v, o, l, B, Hq, Hkv, Sq, Sk, causal, window, \
                          softcap, scale, q_offset, sk_valid, block_q,       \
                          block_k, st)
  if (dtype == 0 && head_dim == 64) REPRO_K1(v4, 64);
  if (dtype == 0 && head_dim == 128) REPRO_K1(v4, 128);
  if (dtype == 1 && head_dim == 64) REPRO_K1(v3, 64);
  if (dtype == 1 && head_dim == 128) REPRO_K1(v3, 128);
#undef REPRO_K1
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K1-bwd: the gradient of K1 (blockwise flash attention), by hand for
// Hopper (sm_90a).
//
// The JAX package has no counterpart: its Pallas K1
// (repro/kernels/flash_attention.py, flash_attention) has no custom_vjp, and
// jax.grad through pallas_call raises, so its training takes gradients on
// the plain path. Here the gradient of K1's function is a kernel of its
// own, reached through a torch.autograd.Function whose forward is K1.
//
// Function: for out = softmax(mask(cap·tanh(Q·Kᵀ·D^-0.5 / cap)))·V with
// grouped-query heads (query head h reads KV head h / (Hq / Hkv)), causal
// or not, a sliding window, a tanh softcap, Sq != Sk, and q_offset 0 with
// no sk_valid (training never sets them), given dO it returns dQ, dK, dV.
// Inputs are float32 or bfloat16; all arithmetic is float32 on the CUDA
// cores (no TF32), and the gradients are written in the inputs' type. A
// query row with no valid key has output 0 in K1 and gradient 0 here.
//
// The row statistics come from the forward: K1 writes each row's lse =
// m + log l of the scaled, softcapped logits (+inf for a row with no valid
// key), so P = exp(S − lse) is recomputed tile by tile without a pass over
// the keys first. Then, with no atomics, so that the gradients are the same
// bits from run to run:
//   delta   one half warp per row: delta = rowsum(dO ∘ O) (B, Hq, Sq);
//   dK, dV  one block per (k tile, query head, batch), k tile 0 first (under
//           the causal mask it sees every q tile, the last sees one): over
//           the q tiles that can see the k tile (causal and window bounds),
//           dPᵀ = V·dOᵀ, Sᵀ = K·Qᵀ, P = exp(S·D^-0.5 capped − lse),
//           dS = P ∘ (dP − delta) ∘ (1 − tanh²) under a softcap,
//           dV += Pᵀ·dO, dK += dSᵀ·Q; with one query head per KV head it
//           writes dK·D^-0.5 and dV, else its head's float32 share;
//   dQ      one block per (q tile, query head, batch), heaviest causal q
//           tiles first: over the visible k tiles, dP = dO·Vᵀ, S = Q·Kᵀ,
//           the same dS, dQ += dS·K; writes dQ·D^-0.5 (S and dP are
//           formed again rather than stored by the dK/dV pass: the two
//           passes form them by the same code in the same order);
//   sum     with G > 1 query heads per KV head, dK and dV are the group's
//           shares summed in head order.
// The wrapper allocates delta and the shares (float32 scratch).
//
// Tiles are 64 query rows by 64 keys, in shared memory as float32 rows
// padded to D + 4 (flash_common.cuh): every product is a register
// micro-tile of R rows (R = 8 at D 64, 128 threads; R = 4 at D 128, 256
// threads, for registers) by 4 columns, or by D/16 columns, read by 16-byte
// loads. Float32 tiles arrive by cp.async, each buffer refilled as soon as
// its last product has read it, so a load runs under the next product.
//
// Bound on this card: five products of the forward's size (S, dP, dV, dK,
// dQ; the forward has two), 2.5 times its operations, over q, k, v, o, dO
// read and dQ, dK, dV written. In float32 at smollm-360m's training shape
// (B 8, 15 on 5 heads, D 64, S 512, causal) that is about 10 GFLOP against
// 34 MB: operation-bound at the float32 peak. This design forms seven (S
// and dP twice).
#include "flash_common.cuh"

#include <math.h>

namespace repro_torch {
namespace bwd {

constexpr int kB = 64;        // query rows and keys of a tile
constexpr int kLDP = kB + 4;  // padded row of a 64 x 64 tile (P, dS)

template <int D>
struct Cfg {
  // R rows (keys in the dK/dV pass, queries in the dQ pass) a thread
  static constexpr int R = D == 64 ? 8 : 4;
  static constexpr int NT = kB / R * tile::kTX;       // threads of a block
  // blocks an SM holds (shared memory allows two at D 64): registers are
  // budgeted for that many, so that none spill
  static constexpr int MIN_BLOCKS = D == 64 ? 2 : 1;
  static constexpr int LD = D + 4;
  static constexpr int NH = D / 64;
  static constexpr int NJ = kB / tile::kTX;           // 4 columns
  static constexpr size_t TILE = (size_t)kB * LD;     // floats of a tile
  // K, V, Q, dO tiles and P, dS
  static constexpr size_t DKDV_BYTES =
      sizeof(float) * (4 * TILE + 2 * (size_t)kB * kLDP);
  // Q, dO, K, V tiles and dS
  static constexpr size_t DQ_BYTES =
      sizeof(float) * (4 * TILE + (size_t)kB * kLDP);
};

struct Mask {
  int Sq, Sk, causal, window;
  __device__ __forceinline__ bool operator()(int qpos, int kpos) const {
    bool ok = qpos < Sq && kpos < Sk;
    if (causal) ok = ok && kpos <= qpos;
    if (window > 0) ok = ok && qpos - kpos < window;
    return ok;
  }
};

// dS and P of one score: x the scaled score, dp the dO·V entry, lse and
// delta the row's; 0 outside the mask. Under a softcap the (1 − tanh²)
// factor is the forward's capped logit's.
__device__ __forceinline__ float ds_of(float x, float dp, float lse,
                                       float delta, float softcap, bool ok,
                                       float& p) {
  float dcap = 1.f;
  if (softcap > 0.f) {
    const float t = tanhf(x / softcap);
    dcap = 1.f - t * t;
    x = softcap * t;
  }
  p = ok ? expf(x - lse) : 0.f;
  return p * (dp - delta) * dcap;
}

template <int R, int NC>
__device__ __forceinline__ void zero(float (&a)[R][NC]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < NC; ++j) a[i][j] = 0.f;
  }
}

// ---------------------------------------------------------------- delta
template <typename T, int D>
__global__ void __launch_bounds__(256)
bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, int n_rows) {
  constexpr int V = vec_len<T>();
  const int row = blockIdx.x * 16 + threadIdx.x / tile::kTX;
  const int tx = threadIdx.x % tile::kTX;
  float acc = 0.f;
  if (row < n_rows) {
    for (int c = tx; c < D / V; c += tile::kTX) {
      float a[V], g[V];
      load16(o + (size_t)row * D + c * V, a);
      load16(dout + (size_t)row * D + c * V, g);
#pragma unroll
      for (int i = 0; i < V; ++i) acc = fmaf(a[i], g[i], acc);
    }
  }
  acc = tile::row_sum16(acc);
  if (row < n_rows && tx == 0) delta[row] = acc;
}

// ------------------------------------------------------------- dK, dV
template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D>::NT, Cfg<D>::MIN_BLOCKS)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dk, T* __restrict__ dv,
                float* __restrict__ dk_share, float* __restrict__ dv_share,
                int Hq, int Hkv, Mask mask, float softcap, float scale) {
  using C = Cfg<D>;
  constexpr int R = C::R, NT = C::NT, LD = C::LD, NH = C::NH, NJ = C::NJ;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + C::TILE;
  float* sQ = sV + C::TILE;
  float* sDO = sQ + C::TILE;
  float* sP = sDO + C::TILE;
  float* sDS = sP + kB * kLDP;
  const int kt = (int)blockIdx.x / Hq;            // k tile 0 first
  const int h = (int)blockIdx.x % Hq;
  const int b = blockIdx.y;
  const int G = Hq / Hkv;
  const int hk = h / G;
  const int Sq = mask.Sq, Sk = mask.Sk;
  const int k0 = kt * kB;
  const int krows = min(kB, Sk - k0);
  const int ty = threadIdx.x / tile::kTX, tx = threadIdx.x % tile::kTX;
  const int kr0 = ty * R;                          // the thread's first key
  const size_t koff = (((size_t)b * Hkv + hk) * Sk + k0) * D;
  const size_t hrow = ((size_t)b * Hq + h) * Sq;   // row 0 of this head

  // q tiles that see a key of [k0, k0 + krows)
  const int qb = mask.causal ? k0 : 0;             // a tile edge: kB | k0
  const int qe = mask.window > 0
                     ? min(Sq, k0 + krows - 1 + mask.window) : Sq;
  const int n_steps = qe > qb ? (qe - qb + kB - 1) / kB : 0;

  float acc_dk[R][4 * NH], acc_dv[R][4 * NH];
  zero(acc_dk);
  zero(acc_dv);
  if (n_steps > 0) {
    tile::load_tile<kB, D, LD, NT>(sK, k + koff, krows);
    tile::load_tile<kB, D, LD, NT>(sV, v + koff, krows);
    tile::load_tile<kB, D, LD, NT>(sDO, dout + (hrow + qb) * D,
                                   min(kB, Sq - qb));
    tile::cp_async_commit();
    tile::load_tile<kB, D, LD, NT>(sQ, q + (hrow + qb) * D,
                                   min(kB, Sq - qb));
    tile::cp_async_commit();
  }
  for (int it = 0; it < n_steps; ++it) {
    const int q0 = qb + it * kB;
    const bool more = it + 1 < n_steps;
    float ls[NJ], dl[NJ];                // rows q0 + tx + 16j
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int r = q0 + tx + tile::kTX * j;
      ls[j] = r < Sq ? lse[hrow + r] : INFINITY;
      dl[j] = r < Sq ? delta[hrow + r] : 0.f;
    }
    tile::cp_async_wait<1>();            // K, V and this dO tile
    __syncthreads();
    float dp[R][NJ], s[R][NJ];
    zero(dp);
    tile::abt<R, NJ, D, LD, LD>(sV + kr0 * LD, sDO, dp);     // dPᵀ = V·dOᵀ
    tile::cp_async_wait<0>();            // this Q tile
    __syncthreads();
    zero(s);
    tile::abt<R, NJ, D, LD, LD>(sK + kr0 * LD, sQ, s);       // Sᵀ = K·Qᵀ
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + tile::kTX * j;
        float p;
        const float ds = ds_of(s[i][j] * scale, dp[i][j], ls[j], dl[j],
                               softcap, mask(q0 + c, k0 + kr0 + i), p);
        sP[(kr0 + i) * kLDP + c] = p;
        sDS[(kr0 + i) * kLDP + c] = ds;
      }
    }
    __syncthreads();                     // P and dS visible
    tile::ab<R, NH, kB, kLDP, LD>(sP + kr0 * kLDP, sDO, acc_dv);  // Pᵀ·dO
    __syncthreads();                     // every thread has read dO
    if (more) {
      tile::load_tile<kB, D, LD, NT>(sDO, dout + (hrow + q0 + kB) * D,
                                     min(kB, Sq - q0 - kB));
      tile::cp_async_commit();
    }
    tile::ab<R, NH, kB, kLDP, LD>(sDS + kr0 * kLDP, sQ, acc_dk);  // dSᵀ·Q
    __syncthreads();                     // every thread has read Q, P, dS
    if (more) {
      tile::load_tile<kB, D, LD, NT>(sQ, q + (hrow + q0 + kB) * D,
                                     min(kB, Sq - q0 - kB));
      tile::cp_async_commit();
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int c = kr0 + i;
    if (c >= krows) continue;
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      const int d = 64 * hh + 4 * tx;
      const float k0v = acc_dk[i][4 * hh] * scale;
      const float k1v = acc_dk[i][4 * hh + 1] * scale;
      const float k2v = acc_dk[i][4 * hh + 2] * scale;
      const float k3v = acc_dk[i][4 * hh + 3] * scale;
      const float v0 = acc_dv[i][4 * hh], v1 = acc_dv[i][4 * hh + 1];
      const float v2 = acc_dv[i][4 * hh + 2], v3 = acc_dv[i][4 * hh + 3];
      if (dk_share == nullptr) {           // one query head per KV head
        const size_t at = koff + (size_t)c * D + d;
        tile::store4(dk + at, k0v, k1v, k2v, k3v);
        tile::store4(dv + at, v0, v1, v2, v3);
      } else {
        const size_t at = (((size_t)b * Hq + h) * Sk + k0 + c) * D + d;
        tile::store4(dk_share + at, k0v, k1v, k2v, k3v);
        tile::store4(dv_share + at, v0, v1, v2, v3);
      }
    }
  }
}

// ----------------------------------------------------------------- dQ
template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D>::NT, Cfg<D>::MIN_BLOCKS)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int Hq, int Hkv, Mask mask, float softcap,
              float scale) {
  using C = Cfg<D>;
  constexpr int R = C::R, NT = C::NT, LD = C::LD, NH = C::NH, NJ = C::NJ;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sDO = sQ + C::TILE;
  float* sK = sDO + C::TILE;
  float* sV = sK + C::TILE;
  float* sDS = sV + C::TILE;
  const int Sq = mask.Sq, Sk = mask.Sk;
  const int n_qt = (Sq + kB - 1) / kB;
  const int qt = n_qt - 1 - (int)blockIdx.x / Hq;   // heaviest first
  const int h = (int)blockIdx.x % Hq;
  const int b = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kB;
  const int rows = min(kB, Sq - q0);
  const int ty = threadIdx.x / tile::kTX, tx = threadIdx.x % tile::kTX;
  const int r0 = ty * R;                            // the thread's first row
  const size_t row0 = ((size_t)b * Hq + h) * Sq + q0;
  const T* kbase = k + ((size_t)b * Hkv + hk) * Sk * D;
  const T* vbase = v + ((size_t)b * Hkv + hk) * Sk * D;

  // key tiles the q tile sees: [kb, ke), kb a tile edge
  const int ke = mask.causal ? min(Sk, q0 + rows) : Sk;
  int kb = mask.window > 0 ? max(0, q0 - mask.window + 1) : 0;
  kb = (kb / kB) * kB;
  const int n_steps = ke > kb ? (ke - kb + kB - 1) / kB : 0;

  float ls[R], dl[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = r0 + i;
    ls[i] = r < rows ? lse[row0 + r] : INFINITY;
    dl[i] = r < rows ? delta[row0 + r] : 0.f;
  }
  float acc[R][4 * NH];
  zero(acc);
  if (n_steps > 0) {
    tile::load_tile<kB, D, LD, NT>(sQ, q + row0 * D, rows);
    tile::load_tile<kB, D, LD, NT>(sDO, dout + row0 * D, rows);
    tile::load_tile<kB, D, LD, NT>(sV, vbase + (size_t)kb * D,
                                   min(kB, Sk - kb));
    tile::cp_async_commit();
    tile::load_tile<kB, D, LD, NT>(sK, kbase + (size_t)kb * D,
                                   min(kB, Sk - kb));
    tile::cp_async_commit();
  }
  for (int it = 0; it < n_steps; ++it) {
    const int k0 = kb + it * kB;
    const bool more = it + 1 < n_steps;
    tile::cp_async_wait<1>();            // Q, dO and this V tile
    __syncthreads();
    float dp[R][NJ], s[R][NJ];
    zero(dp);
    tile::abt<R, NJ, D, LD, LD>(sDO + r0 * LD, sV, dp);      // dP = dO·Vᵀ
    __syncthreads();                     // every thread has read V
    if (more) {
      tile::load_tile<kB, D, LD, NT>(sV, vbase + (size_t)(k0 + kB) * D,
                                     min(kB, Sk - k0 - kB));
      tile::cp_async_commit();
      tile::cp_async_wait<1>();          // this K tile
    } else {
      tile::cp_async_wait<0>();
    }
    __syncthreads();
    zero(s);
    tile::abt<R, NJ, D, LD, LD>(sQ + r0 * LD, sK, s);        // S = Q·Kᵀ
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + tile::kTX * j;
        float p;
        sDS[(r0 + i) * kLDP + c] =
            ds_of(s[i][j] * scale, dp[i][j], ls[i], dl[i], softcap,
                  mask(q0 + r0 + i, k0 + c), p);
      }
    }
    __syncthreads();                     // dS visible
    tile::ab<R, NH, kB, kLDP, LD>(sDS + r0 * kLDP, sK, acc);  // dQ += dS·K
    __syncthreads();                     // every thread has read K and dS
    if (more) {
      tile::load_tile<kB, D, LD, NT>(sK, kbase + (size_t)(k0 + kB) * D,
                                     min(kB, Sk - k0 - kB));
      tile::cp_async_commit();
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = r0 + i;
    if (r >= rows) continue;
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      tile::store4(dq + (row0 + r) * D + 64 * hh + 4 * tx,
                   acc[i][4 * hh] * scale, acc[i][4 * hh + 1] * scale,
                   acc[i][4 * hh + 2] * scale, acc[i][4 * hh + 3] * scale);
    }
  }
}

// ---------------------------------------------------------------- sum
// out[b, hk] = Σ_g share[b, hk·G + g] in head order, for dK and dV, four
// floats a thread; n4 = B·Hkv·Sk·D / 4, per = Sk·D.
template <typename T>
__global__ void __launch_bounds__(256)
bwd_group_sum_kernel(const float* __restrict__ dk_share,
                     const float* __restrict__ dv_share, T* __restrict__ dk,
                     T* __restrict__ dv, size_t n4, int per, int G) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const size_t e = 4 * i;
  const size_t bh = e / per;                 // b·Hkv + hk
  const size_t base = bh * G * per + e % per;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int g = 0; g < G; ++g) {
    const float4 a = tile::ld4(dk_share + base + (size_t)g * per);
    const float4 c = tile::ld4(dv_share + base + (size_t)g * per);
    sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
    sv.x += c.x; sv.y += c.y; sv.z += c.z; sv.w += c.w;
  }
  tile::store4(dk + e, sk.x, sk.y, sk.z, sk.w);
  tile::store4(dv + e, sv.x, sv.y, sv.z, sv.w);
}

template <typename T, int D>
static int launch(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const float* lse, void* dq, void* dk,
                  void* dv, float* delta, float* dk_share, float* dv_share,
                  int B, int Hq, int Hkv, int Sq, int Sk, int causal,
                  int window, float softcap, float scale, cudaStream_t st) {
  using C = Cfg<D>;
  static size_t allowed1 = 0, allowed2 = 0;
  auto k1 = bwd_dkdv_kernel<T, D>;
  auto k2 = bwd_dq_kernel<T, D>;
  if (!raise_smem_limit(k1, C::DKDV_BYTES, allowed1) ||
      !raise_smem_limit(k2, C::DQ_BYTES, allowed2)) {
    return (int)cudaGetLastError();
  }
  const Mask mask{Sq, Sk, causal, window};
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const int n_rows = B * Hq * Sq;
  bwd_delta_kernel<T, D><<<(n_rows + 15) / 16, 256, 0, st>>>(
      static_cast<const T*>(o), dot, delta, n_rows);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int G = Hq / Hkv;
  const dim3 kgrid((Sk + kB - 1) / kB * Hq, B);
  k1<<<kgrid, C::NT, C::DKDV_BYTES, st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      G > 1 ? dk_share : nullptr, G > 1 ? dv_share : nullptr, Hq, Hkv, mask,
      softcap, scale);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const dim3 qgrid((Sq + kB - 1) / kB * Hq, B);
  k2<<<qgrid, C::NT, C::DQ_BYTES, st>>>(qt, kt, vt, dot, lse, delta,
                                        static_cast<T*>(dq), Hq, Hkv, mask,
                                        softcap, scale);
  err = (int)cudaGetLastError();
  if (err != 0 || G == 1) return err;
  const size_t n4 = (size_t)B * Hkv * Sk * D / 4;
  bwd_group_sum_kernel<T><<<(unsigned)((n4 + 255) / 256), 256, 0, st>>>(
      dk_share, dv_share, static_cast<T*>(dk), static_cast<T*>(dv), n4,
      Sk * D, G);
  return (int)cudaGetLastError();
}

}  // namespace bwd
}  // namespace repro_torch

using namespace repro_torch;

// dtype: 0 = float32, 1 = bfloat16; head_dim 64 or 128. window <= 0 and
// softcap <= 0 mean none. lse: the forward's float32 (B, Hq, Sq). delta:
// float32 (B, Hq, Sq) scratch; dk_share and dv_share: float32 (B, Hq, Sk, D)
// scratch, read only when Hq > Hkv. Returns the cudaError_t of the first
// failed launch (0 on success).
extern "C" int repro_flash_attention_bwd(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    const void* o, const void* dout, const void* lse, void* dq, void* dk,
    void* dv, void* delta, void* dk_share, void* dv_share, int B, int Hq,
    int Hkv, int Sq, int Sk, int causal, int window, float softcap,
    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* sk = static_cast<float*>(dk_share);
  float* sv = static_cast<float*>(dv_share);
#define REPRO_BWD(T, DD)                                                    \
  return bwd::launch<T, DD>(q, k, v, o, dout, l, dq, dk, dv, dl, sk, sv, B, \
                            Hq, Hkv, Sq, Sk, causal, window, softcap, scale, \
                            st)
  if (dtype == 0 && head_dim == 64) REPRO_BWD(float, 64);
  if (dtype == 0 && head_dim == 128) REPRO_BWD(float, 128);
  if (dtype == 1 && head_dim == 64) REPRO_BWD(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) REPRO_BWD(__nv_bfloat16, 128);
#undef REPRO_BWD
  return (int)cudaErrorInvalidValue;
}

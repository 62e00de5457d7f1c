// K1: blockwise (flash) attention for prefill, by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention, body _flash_kernel). Same function: grouped-query
// attention with an online softmax in float32, causal or not, optional
// sliding window, tanh softcap, a static q_offset and sk_valid masking; key
// tiles with no live key are skipped and a row with no valid key returns 0.
//
// The TPU grid runs its K axis in order and carries (m, l, acc) in VMEM
// scratch from one grid step to the next. Here blocks run in parallel, so
// that carry is a loop inside one block: one block per (64-row q tile,
// q head, batch), looping over K/V tiles staged in shared memory; each warp
// carries groups of four query rows. The KV head is h / (Hq / Hkv).
//
// Bound on this card: at prefill lengths the work is 4·Sq·Sk·D/2 operations
// over (B·Hq·Sq + 2·B·Hkv·Sk)·D elements, so it is bound by operations. This
// first version runs them as float32 FMA on the CUDA cores, far from the
// tensor-core rate; wgmma tiles fed by TMA are later work (ROADMAP).
#include "attention_common.cuh"

namespace repro_torch {

constexpr int kRows = 4;   // query rows a warp carries through one K/V read

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
                 int Sq, int Sk, int causal, int window, float softcap,
                 float scale, int q_offset, int sk_valid, int bq, int bk) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * bq;
  const int hk = h / (Hq / Hkv);
  const int rows = min(bq, Sq - q0);
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  Smem<D> s(smem, bq, bk);

  const size_t qoff = (((size_t)b * Hq + h) * Sq + q0) * D;
  init_rows<T, D>(s, q + qoff, rows, scale);

  // live key range of the whole q tile: the structural block skip
  const int q_first = q0 + q_offset;
  const int q_last = q0 + rows - 1 + q_offset;
  int k_end = sk_valid;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_first - window + 1);
  k_begin = (k_begin / bk) * bk;

  const size_t kvoff = ((size_t)b * Hkv + hk) * Sk * D;
  const T* kb = k + kvoff;
  const T* vb = v + kvoff;
  auto row_ptr = [](int kpos) { return (size_t)kpos * D; };

  const int groups = (rows + kRows - 1) / kRows;
  for (int k0 = k_begin; k0 < k_end; k0 += bk) {
    __syncthreads();   // previous tile consumed; first pass: init visible
    load_tile<T, D>(s, kb, vb, k0, bk, sk_valid, row_ptr);
    __syncthreads();
    for (int g = warp; g < groups; g += nwarps) {
      const int r0 = g * kRows;
      const int nr = min(kRows, rows - r0);
      const int qpos0 = q0 + r0 + q_offset;             // first row of group
      if (causal && k0 > qpos0 + nr - 1) continue;       // right of diagonal
      if (window > 0 && qpos0 - (k0 + bk - 1) >= window) continue;
      auto valid = [=](int i, int kpos) {
        const int qpos = qpos0 + i;
        bool ok = kpos < sk_valid;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && (qpos - kpos) < window;
        return ok;
      };
      attend_tile<D, kRows>(s, r0, nr, k0, bk, softcap, valid);
    }
  }
  __syncthreads();
  for (int r = warp; r < rows; r += nwarps) {
    write_row<T, D>(s, r, o + qoff + (size_t)r * D);
  }
}

template <typename T, int D>
static int launch_flash(const void* q, const void* k, const void* v, void* o,
                        int B, int Hq, int Hkv, int Sq, int Sk, int causal,
                        int window, float softcap, float scale, int q_offset,
                        int sk_valid, int bq, int bk, cudaStream_t stream) {
  const size_t smem = smem_floats<D>(bq, bk) * sizeof(float);
  auto kern = flash_fwd_kernel<T, D>;
  static size_t allowed = 0;
  if (!raise_smem_limit(kern, smem, allowed)) return (int)cudaGetLastError();
  dim3 grid((Sq + bq - 1) / bq, Hq, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Sk, causal,
      window, softcap, scale, q_offset, sk_valid, bq, bk);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

using namespace repro_torch;

// dtype: 0 = float32, 1 = bfloat16. window <= 0 and softcap <= 0 mean none.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_flash_attention(int dtype, int head_dim, const void* q,
                                     const void* k, const void* v, void* o,
                                     int B, int Hq, int Hkv, int Sq, int Sk,
                                     int causal, int window, float softcap,
                                     float scale, int q_offset, int sk_valid,
                                     int block_q, int block_k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH(T, D)                                                    \
  return launch_flash<T, D>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window,  \
                            softcap, scale, q_offset, sk_valid, block_q,     \
                            block_k, st)
  if (dtype == 0 && head_dim == 64) REPRO_FLASH(float, 64);
  if (dtype == 0 && head_dim == 128) REPRO_FLASH(float, 128);
  if (dtype == 1 && head_dim == 64) REPRO_FLASH(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) REPRO_FLASH(__nv_bfloat16, 128);
#undef REPRO_FLASH
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

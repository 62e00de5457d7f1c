// K2 and K3: one query token against a KV cache, by hand for Hopper (sm_90a).
//
// K2 replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention, body _decode_kernel): a dense cache (B, Hkv, Smax, D)
// masked by a per-lane kv_len and an optional sliding window.
// K3 replaces paged_decode_attention (body _paged_decode_kernel): the same
// function read through block tables; pool block j of lane b is
// block_tables[b, j], and dead entries point at the null block 0, which
// kv_len masks.
//
// The G = Hq / Hkv query heads that share one KV head are the rows of one
// block, as the TPU kernel packs them into the rows of one matmul. One block
// per (KV head, lane) loops over its K/V tiles up to kv_len; the online
// softmax carry that the TPU kept in VMEM across sequential grid steps is
// that loop's state. Tiles left of the window are never loaded. A block
// reads its own kv_len and, for K3, its own table entries (there is no
// scalar prefetch on this card).
//
// Bound on this card: G·2·kv_len·D multiply-adds against kv_len·2·D
// elements read, about G/2 operations per byte in bf16, so both kernels are
// bound by bytes. This version launches only B·Hkv blocks, which leaves
// most of the 132 SMs idle at serving batch sizes; splitting the KV axis
// across blocks with a combine pass, and tensor-core tiles with G padded to
// 16 rows, are later work (ROADMAP).
#include "attention_common.cuh"

namespace repro_torch {

template <typename T, int D, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ tables,
              const int* __restrict__ kv_len, T* __restrict__ o, int Hq,
              int Hkv, int span, int max_blocks, int window, float softcap,
              float scale, int bk) {
  extern __shared__ __align__(16) float smem[];
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int G = Hq / Hkv;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  Smem<D> s(smem, G, bk);

  const size_t qoff = ((size_t)b * Hq + (size_t)hk * G) * D;
  init_rows<T, D>(s, q + qoff, G, scale);

  // span: Smax for the dense cache, block_size for the pools
  const int limit = PAGED ? span * max_blocks : span;
  const int kvl = kv_len[b];
  const int k_end = min(kvl, limit);
  int k_begin = window > 0 ? max(0, kvl - window) : 0;
  k_begin = (k_begin / bk) * bk;

  const int* table = PAGED ? tables + (size_t)b * max_blocks : nullptr;
  auto row_ptr = [=](int kpos) -> size_t {
    if constexpr (PAGED) {
      const int blk = table[kpos / span];
      return (((size_t)blk * Hkv + hk) * span + kpos % span) * D;
    } else {
      return (((size_t)b * Hkv + hk) * span + kpos) * D;
    }
  };
  auto valid = [=](int, int kpos) {
    bool ok = kpos < k_end;
    if (window > 0) ok = ok && kpos >= kvl - window;
    return ok;
  };

  for (int k0 = k_begin; k0 < k_end; k0 += bk) {
    __syncthreads();
    load_tile<T, D>(s, k, v, k0, bk, k_end, row_ptr);
    __syncthreads();
    for (int r = warp; r < G; r += nwarps) {   // one row per warp
      attend_tile<D, 1>(s, r, 1, k0, bk, softcap, valid);
    }
  }
  __syncthreads();
  for (int r = warp; r < G; r += nwarps) {
    write_row<T, D>(s, r, o + qoff + (size_t)r * D);
  }
}

template <typename T, int D, bool PAGED>
static int launch_decode(const void* q, const void* k, const void* v,
                         const int* tables, const int* kv_len, void* o, int B,
                         int Hq, int Hkv, int span, int max_blocks, int window,
                         float softcap, float scale, int bk,
                         cudaStream_t stream) {
  const size_t smem = smem_floats<D>(Hq / Hkv, bk) * sizeof(float);
  auto kern = decode_kernel<T, D, PAGED>;
  static size_t allowed = 0;
  if (!raise_smem_limit(kern, smem, allowed)) return (int)cudaGetLastError();
  dim3 grid(Hkv, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), tables, kv_len, static_cast<T*>(o), Hq, Hkv,
      span, max_blocks, window, softcap, scale, bk);
  return (int)cudaGetLastError();
}

template <bool PAGED>
static int dispatch_decode(int dtype, int head_dim, const void* q,
                           const void* k, const void* v, const int* tables,
                           const int* kv_len, void* o, int B, int Hq, int Hkv,
                           int span, int max_blocks, int window,
                           float softcap, float scale, int bk,
                           cudaStream_t st) {
#define REPRO_DECODE(T, D)                                                  \
  return launch_decode<T, D, PAGED>(q, k, v, tables, kv_len, o, B, Hq, Hkv, \
                                    span, max_blocks, window, softcap,      \
                                    scale, bk, st)
  if (dtype == 0 && head_dim == 64) REPRO_DECODE(float, 64);
  if (dtype == 0 && head_dim == 128) REPRO_DECODE(float, 128);
  if (dtype == 1 && head_dim == 64) REPRO_DECODE(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) REPRO_DECODE(__nv_bfloat16, 128);
#undef REPRO_DECODE
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro_torch

using namespace repro_torch;

// K2. q (B, Hq, 1, D); caches (B, Hkv, Smax, D); kv_len (B,) int32.
extern "C" int repro_decode_attention(int dtype, int head_dim, const void* q,
                                      const void* k_cache,
                                      const void* v_cache, const int* kv_len,
                                      void* o, int B, int Hq, int Hkv,
                                      int Smax, int window, float softcap,
                                      float scale, int block_k,
                                      void* stream) {
  return dispatch_decode<false>(dtype, head_dim, q, k_cache, v_cache, nullptr,
                                kv_len, o, B, Hq, Hkv, Smax, 1, window,
                                softcap, scale, block_k,
                                static_cast<cudaStream_t>(stream));
}

// K3. pools (num_blocks, Hkv, block_size, D); block_tables (B, max_blocks)
// int32, every entry a valid pool index; kv_len (B,) int32.
extern "C" int repro_paged_decode_attention(
    int dtype, int head_dim, const void* q, const void* k_pool,
    const void* v_pool, const int* block_tables, const int* kv_len, void* o,
    int B, int Hq, int Hkv, int block_size, int max_blocks, int window,
    float softcap, float scale, int block_k, void* stream) {
  return dispatch_decode<true>(dtype, head_dim, q, k_pool, v_pool,
                               block_tables, kv_len, o, B, Hq, Hkv,
                               block_size, max_blocks, window, softcap, scale,
                               block_k, static_cast<cudaStream_t>(stream));
}

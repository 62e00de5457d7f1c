// K2, K3 and K4: one query token against a KV cache, by hand for Hopper
// (sm_90a).
//
// K2 replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention, body _decode_kernel): a dense cache (B, Hkv, Smax, D)
// masked by a per-lane kv_len and an optional sliding window.
// K3 replaces paged_decode_attention (body _paged_decode_kernel): the same
// function read through block tables; pool block j of lane b is
// block_tables[b, j], and dead entries point at the null block 0, which
// kv_len masks.
// K4 replaces paged_decode_attention_int8 (body _paged_decode_int8_kernel):
// K3 over int8 pools with one float32 scale per key row in scale pools
// (num_blocks, Hkv, block_size, 1); out = softmax(q.(k*ks)).(v*vs). Its
// tile loader (load_tile_int8) reads 16 int8 values per 16-byte load and
// writes int8 * scale as float32 into the shared tile that the float path
// fills, so the dequantized pool never exists in device memory.
//
// The G = Hq / Hkv query heads that share one KV head are the rows of one
// block, as the TPU kernel packs them into the rows of one matmul. One block
// per (KV head, lane) loops over its K/V tiles up to kv_len; the online
// softmax carry that the TPU kept in VMEM across sequential grid steps is
// that loop's state. Tiles left of the window are never loaded. A block
// reads its own kv_len and, for K3 and K4, its own table entries (there is
// no scalar prefetch on this card).
//
// Bound on this card: G·2·kv_len·D multiply-adds against kv_len·2·D
// elements read, about G/2 operations per byte in bf16, so all three are
// bound by bytes; K4 reads D + 4 bytes per key row and head (int8 values
// and a float32 scale) where K3 reads 2·D in bf16, about half. This version
// launches only B·Hkv blocks, which leaves most of the 132 SMs idle at
// serving batch sizes (K4 as K3); splitting the KV axis across blocks with a
// combine pass, and tensor-core tiles with G padded to 16 rows, are later
// work (ROADMAP).
#include <type_traits>

#include "attention_common.cuh"

namespace repro_torch {

// KV is the pools' element type: T (K2, K3) or int8_t (K4, paged only,
// with scale pools ks and vs).
template <typename T, typename KV, int D, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const KV* __restrict__ k,
              const KV* __restrict__ v, const float* __restrict__ ks,
              const float* __restrict__ vs, const int* __restrict__ tables,
              const int* __restrict__ kv_len, T* __restrict__ o, int Hq,
              int Hkv, int span, int max_blocks, int window, float softcap,
              float scale, int bk) {
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  static_assert(!QUANT || PAGED, "the int8 read is paged only");
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
    if constexpr (QUANT) {
      load_tile_int8<D>(s, k, v, ks, vs, k0, bk, k_end, row_ptr);
    } else {
      load_tile<T, D>(s, k, v, k0, bk, k_end, row_ptr);
    }
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

template <typename T, typename KV, int D, bool PAGED>
static int launch_decode(const void* q, const void* k, const void* v,
                         const float* ks, const float* vs, const int* tables,
                         const int* kv_len, void* o, int B, int Hq, int Hkv,
                         int span, int max_blocks, int window, float softcap,
                         float scale, int bk, cudaStream_t stream) {
  const size_t smem = smem_floats<D>(Hq / Hkv, bk) * sizeof(float);
  auto kern = decode_kernel<T, KV, D, PAGED>;
  static size_t allowed = 0;
  if (!raise_smem_limit(kern, smem, allowed)) return (int)cudaGetLastError();
  dim3 grid(Hkv, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), ks, vs, tables, kv_len, static_cast<T*>(o),
      Hq, Hkv, span, max_blocks, window, softcap, scale, bk);
  return (int)cudaGetLastError();
}

// q/out dtype 0 = float32, 1 = bfloat16; head dim 64 or 128. QUANT: int8
// pools with float32 scale pools, else pools of q's type.
template <bool PAGED, bool QUANT>
static int dispatch_decode(int dtype, int head_dim, const void* q,
                           const void* k, const void* v, const float* ks,
                           const float* vs, const int* tables,
                           const int* kv_len, void* o, int B, int Hq, int Hkv,
                           int span, int max_blocks, int window,
                           float softcap, float scale, int bk,
                           cudaStream_t st) {
#define REPRO_DECODE(T, D)                                                  \
  return launch_decode<T, typename std::conditional<QUANT, int8_t, T>::type, \
                       D, PAGED>(q, k, v, ks, vs, tables, kv_len, o, B, Hq, \
                                 Hkv, span, max_blocks, window, softcap,    \
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
  return dispatch_decode<false, false>(dtype, head_dim, q, k_cache, v_cache,
                                       nullptr, nullptr, nullptr, kv_len, o,
                                       B, Hq, Hkv, Smax, 1, window, softcap,
                                       scale, block_k,
                                       static_cast<cudaStream_t>(stream));
}

// K3. pools (num_blocks, Hkv, block_size, D); block_tables (B, max_blocks)
// int32, every entry a valid pool index; kv_len (B,) int32.
extern "C" int repro_paged_decode_attention(
    int dtype, int head_dim, const void* q, const void* k_pool,
    const void* v_pool, const int* block_tables, const int* kv_len, void* o,
    int B, int Hq, int Hkv, int block_size, int max_blocks, int window,
    float softcap, float scale, int block_k, void* stream) {
  return dispatch_decode<true, false>(dtype, head_dim, q, k_pool, v_pool,
                                      nullptr, nullptr, block_tables, kv_len,
                                      o, B, Hq, Hkv, block_size, max_blocks,
                                      window, softcap, scale, block_k,
                                      static_cast<cudaStream_t>(stream));
}

// K4. k/v pools (num_blocks, Hkv, block_size, D) int8; k/v scale pools
// (num_blocks, Hkv, block_size, 1) float32; block_tables (B, max_blocks)
// int32, every entry a valid pool index; kv_len (B,) int32; q and out of
// `dtype`.
extern "C" int repro_paged_decode_attention_int8(
    int dtype, int head_dim, const void* q, const void* k_pool,
    const void* v_pool, const float* k_scale_pool, const float* v_scale_pool,
    const int* block_tables, const int* kv_len, void* o, int B, int Hq,
    int Hkv, int block_size, int max_blocks, int window, float softcap,
    float scale, int block_k, void* stream) {
  return dispatch_decode<true, true>(dtype, head_dim, q, k_pool, v_pool,
                                     k_scale_pool, v_scale_pool, block_tables,
                                     kv_len, o, B, Hq, Hkv, block_size,
                                     max_blocks, window, softcap, scale,
                                     block_k,
                                     static_cast<cudaStream_t>(stream));
}

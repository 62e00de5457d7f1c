// Shared device code of the attention and SSD kernels: constants and small
// helpers (conversion, 16-byte loads, warp reductions, the shared-memory
// limit). K1's float32 kernel (v4) and K1-bwd add their tiles and register
// micro-tiles in flash_common.cuh; K1's bf16 kernel (v3, wgmma), K2, K3
// and K4 (split-KV, decode_attention.cu) and K5 (the SSD scan) use only
// what is here.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace repro_torch {

constexpr float kNegInf = -1e30f;     // the reference's NEG_INF
constexpr unsigned kFull = 0xffffffffu;
constexpr int kInFlight = 4;          // 16-byte loads in flight per thread

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's cast
}

// Elements of T in one 16-byte vector.
template <typename T>
__host__ __device__ constexpr int vec_len() { return 16 / (int)sizeof(T); }

// One 16-byte vector at p (16-byte aligned) as floats.
__device__ __forceinline__ void load16(const float* __restrict__ p,
                                       float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* __restrict__ p,
                                       float (&o)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Allow `kern` `bytes` of dynamic shared memory (above 48 KB it must be
// asked for). `allowed` is the caller's record for this kernel (a static in
// its launcher template, so one per instantiation): the call is made once
// per kernel and size, and a launch inside CUDA graph capture makes none.
// False if the card refuses.
template <typename Kernel>
bool raise_smem_limit(Kernel kern, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return true;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes) != cudaSuccess) {
    return false;
  }
  allowed = bytes;
  return true;
}

}  // namespace repro_torch

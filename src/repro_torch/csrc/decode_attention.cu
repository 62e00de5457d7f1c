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
// (num_blocks, Hkv, block_size, 1); out = softmax(q.(k*ks)).(v*vs).
//
// Bound on this card: G·2·kv_len·D multiply-adds against kv_len·2·D
// elements read, about G/2 operations per byte in bf16, so all three are
// bound by bytes; K4 reads D + 4 bytes per key row and head (int8 values
// and a float32 scale) where K3 reads 2·D in bf16, about half. A byte-bound
// kernel reaches the card's memory rate only when most of the 132 SMs issue
// loads at once.
//
// Split-KV, for all three: the TPU kernels walk the cache in order,
// carrying the online softmax (m, l, acc) in VMEM across grid steps. Here the
// KV axis is split across blocks instead: grid (splits, Hkv, B), splits =
// ceil(limit / block_k) fixed on the host from the cache's extent (Smax, or
// block_size * max_blocks for a paged cache), never from kv_len (no host
// sync, so the launch captures into a CUDA graph), each block owning block_k
// keys of one (lane, KV head) and all G = Hq / Hkv query heads that share it,
// as the TPU kernels pack them into the rows of one matmul. One kernel,
// decode_split_kernel, serves the three caches. They differ in where key
// row kpos lives: row kpos of the lane's (B, Hkv, Smax, D) slab, or row
// kpos % span of pool block block_tables[b, kpos / span] (span = the pools'
// block_size; a block reads its own table entries, as there is no scalar
// prefetch on this card, and dead entries point at the null block 0, which
// kv_len masks); and in what a row holds: float or bf16 values, or int8
// values with the row's float32 scale at row index row(kpos) / D of the
// scale pools. A block reads its own kv_len; one whose keys lie wholly past
// kv_len or left of the window writes l = 0 and returns. Inside a block the
// warps split the keys: each lane reads its slice of a key's K and V rows
// once, with one vector load each (16 bytes of float or bf16, 8 bytes of
// int8, so an int8 lane holds as many values as a bf16 one), several keys in
// flight, and converts them to float32 in registers; an int8 row's two
// scales are 4-byte loads that the row's lanes share (a broadcast) and are
// folded as in the plain version: s = (q.k8)·ks after the lanes' reduction,
// then the softcap and the mask, and V accumulates p·vs·v8, so no
// dequantized row is ever stored. Each warp scores its keys against the
// query rows (float32, one row at a time when G = 1, else four) and keeps
// its own (m, l, acc); there is no shared K/V tile and no __syncthreads in
// the key loop. The warps' partials merge in shared memory into one float32
// partial (acc[D], m, l) per query head and split, written to a workspace
// (B, Hq, splits, D + 2) that the wrapper allocates. A second launch on the
// same stream (the combine, one block per (lane, query head)) merges the
// live splits with the usual max-rescale and writes the output in q's dtype:
// one call is two device kernels. Every dtype runs on the CUDA cores in
// float32 (tensor cores buy nothing for a byte-bound kernel); the split
// changes only the order of summation.
#include "attention_common.cuh"

namespace repro_torch {

constexpr int kSplitSteps = 4;  // warp steps whose loads are in flight

// One lane's slice of a key row: the raw bytes of one load and the V
// values they hold. Float and bf16 rows: 16 bytes (4 or 8 values); int8
// rows: 8 bytes (8 values), so that an int8 lane keeps as many values in
// registers as a bf16 one.
template <typename KT>
struct RowSlice {
  using Raw = uint4;
  static constexpr int V = vec_len<KT>();
};
template <>
struct RowSlice<int8_t> {
  using Raw = uint2;
  static constexpr int V = 8;
};

// A slice's raw bytes as floats.
__device__ __forceinline__ void unpack(const uint4& r, float (&o)[4]) {
  o[0] = __uint_as_float(r.x);
  o[1] = __uint_as_float(r.y);
  o[2] = __uint_as_float(r.z);
  o[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&o)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(const uint2& r, float (&o)[8]) {
  // byte i of a word, sign-extended (little-endian: byte 0 is column 0)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[i] = (float)((int)(r.x << (24 - 8 * i)) >> 24);
    o[4 + i] = (float)((int)(r.y << (24 - 8 * i)) >> 24);
  }
}

// V consecutive values of q at p (16-byte aligned) as floats.
template <typename T, int V>
__device__ __forceinline__ void load_q(const T* __restrict__ p,
                                       float (&o)[V]) {
  constexpr int W = vec_len<T>();
  static_assert(V % W == 0, "a slice is whole 16-byte vectors of q");
#pragma unroll
  for (int c = 0; c < V / W; ++c) {
    float f[W];
    load16(p + c * W, f);
#pragma unroll
    for (int e = 0; e < W; ++e) o[c * W + e] = f[e];
  }
}

// T: q's and the output's type. KT: a key row's type, T or int8_t; int8
// rows come with float32 scale pools ks and vs (one scale per row, at
// row(kpos) / D), which are unused otherwise.
// R: query rows a warp scores per pass over its keys (1 when G = 1, else
// 4; G > R takes several passes, the later ones reading K/V from cache).
// PAGED: k and v are pools (num_blocks, Hkv, span, D) read through
// tables (B, max_blocks) and limit = span * max_blocks; else caches
// (B, Hkv, limit, D) and tables is unused.
template <typename T, typename KT, int D, int R, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const KT* __restrict__ k,
                    const KT* __restrict__ v, const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ tables,
                    const int* __restrict__ kv_len, float* __restrict__ ws,
                    int Hq, int Hkv, int limit, int span, int max_blocks,
                    int window, float softcap, float scale, int bk) {
  using Raw = typename RowSlice<KT>::Raw;
  constexpr bool Q8 = sizeof(KT) == 1;  // int8 rows with a scale each
  constexpr int V = RowSlice<KT>::V;    // values of one lane's load
  constexpr int LPR = D / V;            // lanes that read one key row
  constexpr int KPS = 32 / LPR;         // keys of one warp step
  // steps in flight: fewer when a step is one key per warp (float32,
  // D = 128), where four would spill
  constexpr int NB = KPS == 1 ? kSplitSteps / 2 : kSplitSteps;
  constexpr int PL = D + 2;             // a partial: acc[D], m, l
  constexpr int NW = kThreads / 32;
  __shared__ __align__(16) float wp[NW][R][PL];   // the warps' partials
  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int splits = gridDim.x;
  const int G = Hq / Hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // the live keys of this split: [s0, s1), every one of them valid
  const int kvl = kv_len[b];
  const int k_end = min(kvl, limit);
  const int k_lo = window > 0 ? max(0, kvl - window) : 0;
  const int s0 = max(split * bk, k_lo);
  const int s1 = min(split * bk + bk, k_end);
  // query head hk * G + g of lane b: its partial of this split
  float* part = ws + (((size_t)b * Hq + (size_t)hk * G) * splits + split) * PL;
  const size_t head_stride = (size_t)splits * PL;
  if (s0 >= s1) {
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      part[g * head_stride + D] = kNegInf;
      part[g * head_stride + D + 1] = 0.f;
    }
    return;
  }

  // element offset of key row kpos in k and v
  const size_t kv_base = PAGED ? 0 : ((size_t)b * Hkv + hk) * limit * D;
  const int* table = PAGED ? tables + (size_t)b * max_blocks : nullptr;
  auto row = [=](int kpos) -> size_t {
    if constexpr (PAGED) {
      return (((size_t)table[kpos / span] * Hkv + hk) * span + kpos % span) *
             D;
    } else {
      return kv_base + (size_t)kpos * D;
    }
  };
  const T* qb = q + ((size_t)b * Hq + (size_t)hk * G) * D;
  const int sub = lane / LPR;           // which key of a step
  const int col = (lane % LPR) * V;     // first column this lane reads
  const int steps = (s1 - s0 + KPS - 1) / KPS;

  for (int g0 = 0; g0 < G; g0 += R) {
    const int nr = min(R, G - g0);
    float qf[R][V];                     // this lane's columns, pre-scaled
#pragma unroll
    for (int i = 0; i < R; ++i) {
      load_q<T, V>(qb + (size_t)(g0 + min(i, nr - 1)) * D + col, qf[i]);
#pragma unroll
      for (int e = 0; e < V; ++e) qf[i][e] *= scale;
    }
    float m[R], l[R], acc[R][V];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int e = 0; e < V; ++e) acc[i][e] = 0.f;
    }
    for (int st0 = warp; st0 < steps; st0 += NB * NW) {
      Raw kr[NB], vr[NB];
      float ksc[NB], vsc[NB];           // int8 rows' scales
      bool ok[NB];
#pragma unroll
      for (int u = 0; u < NB; ++u) {
        const int kpos = s0 + (st0 + u * NW) * KPS + sub;
        ok[u] = kpos < s1;
        if (ok[u]) {
          const size_t r = row(kpos);
          kr[u] = *reinterpret_cast<const Raw*>(k + r + col);
          vr[u] = *reinterpret_cast<const Raw*>(v + r + col);
          if constexpr (Q8) {
            ksc[u] = ks[r / D];
            vsc[u] = vs[r / D];
          }
        } else {
          kr[u] = vr[u] = Raw{};
          if constexpr (Q8) ksc[u] = vsc[u] = 0.f;
        }
      }
      float sc[NB][R];
#pragma unroll
      for (int u = 0; u < NB; ++u) {
        float kf[V];
        unpack(kr[u], kf);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          float x = 0.f;
#pragma unroll
          for (int e = 0; e < V; ++e) x = fmaf(qf[i][e], kf[e], x);
#pragma unroll
          for (int off = LPR / 2; off > 0; off >>= 1) {
            x += __shfl_xor_sync(kFull, x, off);
          }
          if constexpr (Q8) x *= ksc[u];
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          sc[u][i] = ok[u] ? x : kNegInf;
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float mx = m[i];
#pragma unroll
        for (int u = 0; u < NB; ++u) mx = fmaxf(mx, sc[u][i]);
        const float alpha = expf(m[i] - mx);
        l[i] *= alpha;
#pragma unroll
        for (int e = 0; e < V; ++e) acc[i][e] *= alpha;
        m[i] = mx;
      }
      // each V slice converted once, then accumulated into every row
#pragma unroll
      for (int u = 0; u < NB; ++u) {
        float vf[V];
        unpack(vr[u], vf);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float p = ok[u] ? expf(sc[u][i] - m[i]) : 0.f;
          l[i] += p;
          float pv = p;
          if constexpr (Q8) pv *= vsc[u];
#pragma unroll
          for (int e = 0; e < V; ++e) acc[i][e] = fmaf(pv, vf[e], acc[i][e]);
        }
      }
    }
    // merge the warp's KPS key streams (lanes LPR apart) into lanes < LPR
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float mo = __shfl_xor_sync(kFull, m[i], off);
        const float lo = __shfl_xor_sync(kFull, l[i], off);
        const float mx = fmaxf(m[i], mo);
        const float a = expf(m[i] - mx);
        const float c = expf(mo - mx);
        l[i] = l[i] * a + lo * c;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float ao = __shfl_xor_sync(kFull, acc[i][e], off);
          acc[i][e] = acc[i][e] * a + ao * c;
        }
        m[i] = mx;
      }
    }
    if (sub == 0) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int e = 0; e < V; ++e) wp[warp][i][col + e] = acc[i][e];
        if (lane == 0) {
          wp[warp][i][D] = m[i];
          wp[warp][i][D + 1] = l[i];
        }
      }
    }
    __syncthreads();
    // merge the warps into this split's partial of each row
    for (int x = threadIdx.x; x < nr * D; x += blockDim.x) {
      const int i = x / D;
      const int d = x % D;
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < NW; ++w) mx = fmaxf(mx, wp[w][i][D]);
      float a = 0.f, sum = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float c = expf(wp[w][i][D] - mx);
        a = fmaf(c, wp[w][i][d], a);
        sum = fmaf(c, wp[w][i][D + 1], sum);
      }
      float* out = part + (size_t)(g0 + i) * head_stride;
      out[d] = a;
      if (d == 0) {
        out[D] = mx;
        out[D + 1] = sum;
      }
    }
    __syncthreads();   // before the next rows reuse wp
  }
}

// One block per (query head, lane): the live splits' partials merged by
// max-rescale; no live split (l = 0 everywhere) gives 0.
template <typename T, int D>
__global__ void __launch_bounds__(D)
decode_combine_kernel(const float* __restrict__ ws, T* __restrict__ o,
                      int splits) {
  constexpr int PL = D + 2;
  const size_t row = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const float* p = ws + row * splits * PL;
  float mx = kNegInf;
  for (int s = 0; s < splits; ++s) {
    if (p[s * PL + D + 1] > 0.f) mx = fmaxf(mx, p[s * PL + D]);
  }
  const int d = threadIdx.x;
  float a = 0.f, sum = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float ls = p[s * PL + D + 1];
    if (ls > 0.f) {
      const float c = expf(p[s * PL + D] - mx);
      sum = fmaf(c, ls, sum);
      a = fmaf(c, p[s * PL + d], a);
    }
  }
  o[row * D + d] = from_f32<T>(sum > 0.f ? a / sum : 0.f);
}

// The split kernel then the combine, on one stream. Dense: k, v caches
// (B, Hkv, limit, D), tables null; paged: pools and tables, limit =
// span * max_blocks. KT int8_t: int8 pools with scale pools ks, vs.
template <typename T, typename KT, int D, bool PAGED>
static int launch_split(const void* q, const void* k, const void* v,
                        const float* ks, const float* vs, const int* tables,
                        const int* kv_len, float* ws, void* o, int B, int Hq,
                        int Hkv, int limit, int span, int max_blocks,
                        int window, float softcap, float scale, int bk,
                        cudaStream_t stream) {
  const int splits = limit > bk ? (limit + bk - 1) / bk : 1;
  const dim3 grid(splits, Hkv, B);
  auto kern = Hq == Hkv ? decode_split_kernel<T, KT, D, 1, PAGED>
                        : decode_split_kernel<T, KT, D, 4, PAGED>;
  kern<<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), ks, vs, tables, kv_len, ws, Hq, Hkv, limit,
      span, max_blocks, window, softcap, scale, bk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto combine = decode_combine_kernel<T, D>;
  combine<<<dim3(Hq, B), D, 0, stream>>>(ws, static_cast<T*>(o), splits);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

using namespace repro_torch;

// K2. q (B, Hq, 1, D); caches (B, Hkv, Smax, D); kv_len (B,) int32;
// workspace (B, Hq, max(1, ceil(Smax / block_k)), D + 2) float32.
extern "C" int repro_decode_attention(int dtype, int head_dim, const void* q,
                                      const void* k_cache,
                                      const void* v_cache, const int* kv_len,
                                      float* workspace, void* o, int B,
                                      int Hq, int Hkv, int Smax, int window,
                                      float softcap, float scale, int block_k,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_DENSE(T, D)                                                   \
  return launch_split<T, T, D, false>(q, k_cache, v_cache, nullptr,         \
                                      nullptr, nullptr, kv_len, workspace,  \
                                      o, B, Hq, Hkv, Smax, 0, 0, window,    \
                                      softcap, scale, block_k, st)
  if (dtype == 0 && head_dim == 64) REPRO_DENSE(float, 64);
  if (dtype == 0 && head_dim == 128) REPRO_DENSE(float, 128);
  if (dtype == 1 && head_dim == 64) REPRO_DENSE(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) REPRO_DENSE(__nv_bfloat16, 128);
#undef REPRO_DENSE
  return (int)cudaErrorInvalidValue;
}

// K3. pools (num_blocks, Hkv, block_size, D); block_tables (B, max_blocks)
// int32, every entry a valid pool index; kv_len (B,) int32; workspace
// (B, Hq, max(1, ceil(block_size * max_blocks / block_k)), D + 2) float32.
extern "C" int repro_paged_decode_attention(
    int dtype, int head_dim, const void* q, const void* k_pool,
    const void* v_pool, const int* block_tables, const int* kv_len,
    float* workspace, void* o, int B, int Hq, int Hkv, int block_size,
    int max_blocks, int window, float softcap, float scale, int block_k,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_PAGED(T, D)                                                   \
  return launch_split<T, T, D, true>(q, k_pool, v_pool, nullptr, nullptr,   \
                                     block_tables, kv_len, workspace, o, B, \
                                     Hq, Hkv, block_size * max_blocks,      \
                                     block_size, max_blocks, window,        \
                                     softcap, scale, block_k, st)
  if (dtype == 0 && head_dim == 64) REPRO_PAGED(float, 64);
  if (dtype == 0 && head_dim == 128) REPRO_PAGED(float, 128);
  if (dtype == 1 && head_dim == 64) REPRO_PAGED(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) REPRO_PAGED(__nv_bfloat16, 128);
#undef REPRO_PAGED
  return (int)cudaErrorInvalidValue;
}

// K4. k/v pools (num_blocks, Hkv, block_size, D) int8; k/v scale pools
// (num_blocks, Hkv, block_size, 1) float32; block_tables (B, max_blocks)
// int32, every entry a valid pool index; kv_len (B,) int32; workspace as
// K3's; q and out of `dtype`.
extern "C" int repro_paged_decode_attention_int8(
    int dtype, int head_dim, const void* q, const void* k_pool,
    const void* v_pool, const float* k_scale_pool, const float* v_scale_pool,
    const int* block_tables, const int* kv_len, float* workspace, void* o,
    int B, int Hq, int Hkv, int block_size, int max_blocks, int window,
    float softcap, float scale, int block_k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_INT8(T, D)                                                    \
  return launch_split<T, int8_t, D, true>(                                  \
      q, k_pool, v_pool, k_scale_pool, v_scale_pool, block_tables, kv_len,  \
      workspace, o, B, Hq, Hkv, block_size * max_blocks, block_size,        \
      max_blocks, window, softcap, scale, block_k, st)
  if (dtype == 0 && head_dim == 64) REPRO_INT8(float, 64);
  if (dtype == 0 && head_dim == 128) REPRO_INT8(float, 128);
  if (dtype == 1 && head_dim == 64) REPRO_INT8(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) REPRO_INT8(__nv_bfloat16, 128);
#undef REPRO_INT8
  return (int)cudaErrorInvalidValue;
}

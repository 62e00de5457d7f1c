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
// KV axis is cut into splits of block_k keys, split s holding the lane's
// logical positions [s·block_k, (s + 1)·block_k), and a work item is one
// (lane, KV head, live split): block_k keys of one (lane, KV head) and all G
// = Hq / Hkv query heads that share it, as the TPU kernels pack them into the
// rows of one matmul. The work list is built on the device, from kv_len, in
// every block (K2 v4, K3 v3, K4 v3): lane b's live splits are those that
// hold a key of [k_lo, k_end) (k_end = min(kv_len, extent), k_lo = kv_len -
// window or 0), Hkv of them a split, and an exclusive prefix over the lanes
// numbers the items. The grid is fixed on the host from the card's SM count
// and the kernel's occupancy (the blocks resident at once), capped at the
// most items the shapes allow, never from kv_len (no host sync, so the
// launch captures into a CUDA graph and a replay follows the replay's
// kv_len); block i walks items i, i + grid, ..., finding an item's lane by
// binary search on the prefix. So a call costs its live keys, not the
// cache's extent times every lane slot. Dead lane slots (kv_len 1 at a
// freed lane) are one one-key item a KV head: the kernel serves kv_len as
// given. A lane whose live keys fit one warp step lists its items apart,
// and one warp alone takes each of them, writing what the block would.
// Split edges are multiples of block_k in the lane's positions, so an
// item's partial, and the output, do not depend on the grid or the walk.
// A block is four warps, and three blocks fit an SM (at most 168 registers
// a thread at four query rows): an item costs a block a few microseconds
// of instruction latency whatever its keys, so past a few items a block
// that, not bytes, bounds the kernel, and three items in flight an SM hide
// part of it.
// One kernel, decode_split_kernel, serves the three caches. They differ in
// where key row kpos lives: row kpos of the lane's (B, Hkv, Smax, D) slab,
// or row kpos % span of pool block block_tables[b, kpos / span] (span = the
// pools' block_size; a block reads its own table entries, as there is no
// scalar prefetch on this card, and dead entries point at the null block 0,
// which kv_len masks); and in what a row holds: float or bf16 values, or
// int8 values with the row's float32 scale at row index row(kpos) / D of
// the scale pools. Inside a block the warps split an item's keys: each lane
// reads its slice of a key's K and V rows once, with one vector load each
// (16 bytes of float or bf16, 8 bytes of int8, so an int8 lane holds as many
// values as a bf16 one), several keys in flight, and converts them to
// float32 in registers; an int8 row's two scales are 4-byte loads that the
// row's lanes share (a broadcast) and are folded as in the plain version:
// s = (q.k8)·ks after the lanes' reduction, then the softcap and the mask,
// and V accumulates p·vs·v8, so no dequantized row is ever stored. Each warp
// scores its keys against the query rows (float32, one row at a time when
// G = 1, else four) and keeps its own (m, l, acc); there is no shared K/V
// tile and no __syncthreads in the key loop. The warps' partials merge in
// shared memory into one float32 partial (acc[D], m, l) per query head and
// split, written to a workspace (B, Hq, splits, D + 2) that the wrapper
// allocates; a dead split's entry is never written. A second launch on the
// same stream (the combine, one block per (lane, query head)) merges the
// lane's live splits, found from kv_len as the split kernel finds them, in
// order, with the usual max-rescale and writes the output in q's dtype: one
// call is two device kernels. Every dtype runs on the CUDA cores in float32
// (tensor cores buy nothing for a byte-bound kernel); the split changes only
// the order of summation.
#include "attention_common.cuh"

namespace repro_torch {

constexpr int kSplitSteps = 4;  // warp steps whose loads are in flight
// the split kernel's block: four warps, so that three blocks (at most 168
// registers a thread) are resident on an SM and walk three items at once
constexpr int kSplitThreads = 128;
constexpr int kSplitBlocksPerSM = 3;
constexpr int kListLanes = kSplitThreads;  // lanes a block lists at a time
constexpr int kMaxDevices = 64;       // cards whose resident blocks are kept

// Lane b's live keys [k_lo, k_end): before kv_len, inside the window and
// inside the cache's extent `limit`; its live splits [lo, lo + n), those
// holding one of them (n = 0 when there is none: kv_len 0). Returns the
// number of live keys.
__device__ __forceinline__ int live_splits(int kvl, int limit, int window,
                                           int bk, int& lo, int& n) {
  const int k_end = min(kvl, limit);
  const int k_lo = window > 0 ? max(0, kvl - window) : 0;
  lo = k_lo / bk;
  n = k_lo < k_end ? (k_end + bk - 1) / bk - lo : 0;
  return max(0, k_end - k_lo);
}

// The last j < nl with first[j] <= it (first[0] = 0 <= it): the lane of a
// list that owns item it.
__device__ __forceinline__ int owner(const int* first, int nl, int it) {
  int j = 0;
  for (int hi = nl - 1; j < hi;) {
    const int mid = (j + hi + 1) >> 1;
    if (first[mid] <= it) j = mid; else hi = mid - 1;
  }
  return j;
}

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
// (B, Hkv, limit, D) and tables is unused. splits: the workspace's,
// ceil(limit / bk).
//
// One work item: split `split` of KV head hk of lane b (kv_len kvl), whose
// keys are live; its partial of each of the G query heads goes to the
// workspace at (b, hk·G + g, split). wp: the block's shared scratch.
// solo: the calling warp alone runs an item of one warp step (at most KPS
// keys), as the block's warp 0, and writes the partial that the merge of the
// block's warps makes of it: the other warps hold no key, so their weights
// are expf(kNegInf - m) = 0 exactly and warp 0's is expf(0) = 1: acc + 0,
// m and l, bit for bit.
template <typename T, typename KT, int D, int R, bool PAGED>
__device__ __forceinline__ void split_item(
    const T* __restrict__ q, const KT* __restrict__ k,
    const KT* __restrict__ v, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ tables,
    float* __restrict__ ws, int Hq, int Hkv, int splits, int limit, int span,
    int max_blocks, int window, float softcap, float scale, int bk, int b,
    int hk, int split, int kvl, bool solo,
    float (&wp)[kSplitThreads / 32][R][D + 2]) {
  using Raw = typename RowSlice<KT>::Raw;
  constexpr bool Q8 = sizeof(KT) == 1;  // int8 rows with a scale each
  constexpr int V = RowSlice<KT>::V;    // values of one lane's load
  constexpr int LPR = D / V;            // lanes that read one key row
  constexpr int KPS = 32 / LPR;         // keys of one warp step
  // steps in flight: fewer when a step is one key per warp (float32,
  // D = 128), where four would spill
  constexpr int NB = KPS == 1 ? kSplitSteps / 2 : kSplitSteps;
  constexpr int PL = D + 2;             // a partial: acc[D], m, l
  constexpr int NW = kSplitThreads / 32;
  const int G = Hq / Hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int role = solo ? 0 : warp;     // the block warp whose keys it reads

  // the live keys of this split: [s0, s1), not empty, every one valid
  const int k_end = min(kvl, limit);
  const int k_lo = window > 0 ? max(0, kvl - window) : 0;
  const int s0 = max(split * bk, k_lo);
  const int s1 = min(split * bk + bk, k_end);
  // query head hk * G + g of lane b: its partial of this split
  float* part = ws + (((size_t)b * Hq + (size_t)hk * G) * splits + split) * PL;
  const size_t head_stride = (size_t)splits * PL;

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
    for (int st0 = role; st0 < steps; st0 += NB * NW) {
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
    if (solo) {
      if (sub == 0) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          if (i >= nr) break;
          float* out = part + (size_t)(g0 + i) * head_stride;
#pragma unroll
          for (int e = 0; e < V; ++e) out[col + e] = __fadd_rn(acc[i][e], 0.f);
          if (lane == 0) {
            out[D] = m[i];
            out[D + 1] = l[i];
          }
        }
      }
      continue;
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

// Keys of one warp step of decode_split_kernel<T, KT, D, ...>.
template <typename KT, int D>
__host__ __device__ constexpr int keys_per_step() {
  return 32 / (D / RowSlice<KT>::V);
}

// The split kernel: a 1-D grid of any size walks the work list. A lane
// whose live keys fit one warp step (a dead slot's one key) lists its
// items apart, and each of them goes to one warp alone; the others' to the
// whole block.
template <typename T, typename KT, int D, int R, bool PAGED>
__global__ void __launch_bounds__(kSplitThreads, kSplitBlocksPerSM)
decode_split_kernel(const T* __restrict__ q, const KT* __restrict__ k,
                    const KT* __restrict__ v, const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ tables,
                    const int* __restrict__ kv_len, float* __restrict__ ws,
                    int B, int Hq, int Hkv, int splits, int limit, int span,
                    int max_blocks, int window, float softcap, float scale,
                    int bk) {
  constexpr int KPS = keys_per_step<KT, D>();
  constexpr int NW = kSplitThreads / 32;
  __shared__ __align__(16) float wp[NW][R][D + 2];  // the warps' partials
  __shared__ int kvs[kListLanes];       // the listed lanes' kv_len
  __shared__ int first[kListLanes + 1]; // their first block items
  __shared__ int sfirst[kListLanes + 1];  // and first one-warp items
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // The work list, kListLanes lanes at a time: lane b0 + j owns Hkv · n
  // items (KV head, then split), [first[j], first[j + 1]) of the block
  // items or [sfirst[j], sfirst[j + 1]) of the one-warp items; each kind
  // is numbered across lists. Block i takes block items i, i + gridDim.x,
  // ...; warp w of block i takes one-warp items i·NW + w, then every
  // gridDim.x·NW-th.
  int next = blockIdx.x, base = 0;      // the next block item; lists before
  int snext = blockIdx.x * NW + warp, sbase = 0;   // one-warp items
  for (int b0 = 0; b0 < B; b0 += kListLanes) {
    const int nl = min(kListLanes, B - b0);
    if (b0 > 0) __syncthreads();        // the last list is walked
    if (threadIdx.x < nl) kvs[threadIdx.x] = kv_len[b0 + threadIdx.x];
    __syncthreads();
    if (warp == 0) {                    // exclusive prefixes of Hkv · n
      int carry = 0, scarry = 0;
      for (int j0 = 0; j0 < nl; j0 += 32) {
        const int j = j0 + lane;
        int lo = 0, n = 0, keys = 0;
        if (j < nl) keys = live_splits(kvs[j], limit, window, bk, lo, n);
        int x = keys > KPS ? Hkv * n : 0;
        int y = keys > KPS ? 0 : Hkv * n;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int xo = __shfl_up_sync(kFull, x, off);
          const int yo = __shfl_up_sync(kFull, y, off);
          if (lane >= off) {
            x += xo;
            y += yo;
          }
        }
        if (j < nl) {
          first[j + 1] = carry + x;
          sfirst[j + 1] = scarry + y;
        }
        carry += __shfl_sync(kFull, x, 31);
        scarry += __shfl_sync(kFull, y, 31);
      }
      if (lane == 0) first[0] = sfirst[0] = 0;
    }
    __syncthreads();
    const int items = first[nl], solos = sfirst[nl];
    for (; next - base < items; next += gridDim.x) {
      const int it = next - base;
      const int j = owner(first, nl, it);
      int lo, n;
      live_splits(kvs[j], limit, window, bk, lo, n);
      const int r = it - first[j];
      split_item<T, KT, D, R, PAGED>(q, k, v, ks, vs, tables, ws, Hq, Hkv,
                                     splits, limit, span, max_blocks, window,
                                     softcap, scale, bk, b0 + j, r / n,
                                     lo + r % n, kvs[j], false, wp);
    }
    for (; snext - sbase < solos; snext += gridDim.x * NW) {
      const int it = snext - sbase;
      const int j = owner(sfirst, nl, it);
      int lo, n;
      live_splits(kvs[j], limit, window, bk, lo, n);
      const int r = it - sfirst[j];
      split_item<T, KT, D, R, PAGED>(q, k, v, ks, vs, tables, ws, Hq, Hkv,
                                     splits, limit, span, max_blocks, window,
                                     softcap, scale, bk, b0 + j, r / n,
                                     lo + r % n, kvs[j], true, wp);
    }
    base += items;
    sbase += solos;
  }
}

// One block per (query head, lane): the lane's live splits, found from
// kv_len as the split kernel finds them, merged by max-rescale in split
// order; a lane with none (kv_len 0) gives 0. The threads find the largest
// m together (a max is exact in any order), then take the splits D at a
// time: thread t weighs split c0 + t once into shared memory, and every
// thread sums the chunk's weighted partials in split order, its loads
// independent of the sums, so they are in flight together.
template <typename T, int D>
__global__ void __launch_bounds__(D)
decode_combine_kernel(const float* __restrict__ ws,
                      const int* __restrict__ kv_len, T* __restrict__ o,
                      int splits, int limit, int window, int bk) {
  constexpr int PL = D + 2;
  __shared__ float wm[D / 32];          // the warps' largest m
  __shared__ float cs[D], ls[D];        // a chunk's weights and sums l
  const size_t row = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const float* p = ws + row * splits * PL;
  const int t = threadIdx.x;
  int lo, n;
  live_splits(kv_len[blockIdx.y], limit, window, bk, lo, n);
  float mx = kNegInf;
  for (int s = lo + t; s < lo + n; s += D) {
    if (p[s * PL + D + 1] > 0.f) mx = fmaxf(mx, p[s * PL + D]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
  }
  if ((t & 31) == 0) wm[t >> 5] = mx;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < D / 32; ++w) mx = fmaxf(mx, wm[w]);
  float a = 0.f, sum = 0.f;
  for (int c0 = lo; c0 < lo + n; c0 += D) {
    const int cn = min(D, lo + n - c0);
    if (c0 > lo) __syncthreads();       // the last chunk is summed
    if (t < cn) {
      const float l = p[(c0 + t) * PL + D + 1];
      cs[t] = l > 0.f ? expf(p[(c0 + t) * PL + D] - mx) : 0.f;
      ls[t] = l;
    }
    __syncthreads();
#pragma unroll 8
    for (int i = 0; i < cn; ++i) {
      const float x = p[(c0 + i) * PL + t];
      if (ls[i] > 0.f) {
        sum = fmaf(cs[i], ls[i], sum);
        a = fmaf(cs[i], x, a);
      }
    }
  }
  o[row * D + t] = from_f32<T>(sum > 0.f ? a / sum : 0.f);
}

// The split kernel's grid: the blocks the card keeps resident at once (its
// SMs times the kernel's occupancy, asked once per device), at most
// `items`, the most the shapes allow. Shapes alone fix it.
template <typename T, typename KT, int D, int R, bool PAGED>
static cudaError_t split_grid(long long items, int& grid) {
  static int resident[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, decode_split_kernel<T, KT, D, R, PAGED>, kSplitThreads,
          0);
    }
    if (err != cudaSuccess) return err;
    resident[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long most = items < resident[dev] ? items : resident[dev];
  grid = most > 1 ? (int)most : 1;
  return cudaSuccess;
}

// The split kernel then the combine, on one stream. Dense: k, v caches
// (B, Hkv, limit, D), tables null; paged: pools and tables, limit =
// span * max_blocks. KT int8_t: int8 pools with scale pools ks, vs.
template <typename T, typename KT, int D, int R, bool PAGED>
static int launch_rows(const void* q, const void* k, const void* v,
                       const float* ks, const float* vs, const int* tables,
                       const int* kv_len, float* ws, void* o, int B, int Hq,
                       int Hkv, int limit, int span, int max_blocks,
                       int window, float softcap, float scale, int bk,
                       cudaStream_t stream) {
  const int splits = limit > bk ? (limit + bk - 1) / bk : 1;
  int grid = 0;
  cudaError_t err = split_grid<T, KT, D, R, PAGED>(
      (long long)Hkv * B * splits, grid);
  if (err != cudaSuccess) return (int)err;
  decode_split_kernel<T, KT, D, R, PAGED><<<grid, kSplitThreads, 0,
                                            stream>>>(
      static_cast<const T*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), ks, vs, tables, kv_len, ws, B, Hq, Hkv,
      splits, limit, span, max_blocks, window, softcap, scale, bk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<T, D><<<dim3(Hq, B), D, 0, stream>>>(
      ws, kv_len, static_cast<T*>(o), splits, limit, window, bk);
  return (int)cudaGetLastError();
}

// One query row a warp pass when G = 1, else four.
template <typename T, typename KT, int D, bool PAGED>
static int launch_split(const void* q, const void* k, const void* v,
                        const float* ks, const float* vs, const int* tables,
                        const int* kv_len, float* ws, void* o, int B, int Hq,
                        int Hkv, int limit, int span, int max_blocks,
                        int window, float softcap, float scale, int bk,
                        cudaStream_t stream) {
  auto launch = Hq == Hkv ? launch_rows<T, KT, D, 1, PAGED>
                          : launch_rows<T, KT, D, 4, PAGED>;
  return launch(q, k, v, ks, vs, tables, kv_len, ws, o, B, Hq, Hkv, limit,
                span, max_blocks, window, softcap, scale, bk, stream);
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

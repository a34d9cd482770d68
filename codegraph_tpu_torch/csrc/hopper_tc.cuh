// The Hopper pieces of the port's tensor-core scan kernels: int8_topk.cu's
// int8_tc_pass1 (K6, K7) and flat_topk_tc.cu's bf16_tc_pass1 (K2tc), which
// share one block design (a producer warp that brings boxes by TMA behind
// mbarrier full/empty pairs, and two consumer warpgroups, each a 64-row
// half of the query tile against 128 corpus rows a wgmma, with per-row
// candidate buffers in device memory), and flat_topk_k1tc.cu's
// bf16_k1_pass1 (K1 over bf16 rows), which takes the same producer and
// ring with the corpus as the 64-row operand. Here: the block's shape, its
// shared-memory layout and per-row states, the mbarrier, TMA and wgmma
// helpers, the flush of a sorted candidate buffer into a list in device
// memory, and the host-side encoding of the TMA tensor maps (through the
// runtime: no -lcuda).
//
// Each including source gets its own copy (everything is in an anonymous
// namespace); the files share the design, not a symbol.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "topk_merge.cuh"

namespace {

constexpr int kTcConsumers = 2;                      // consumer warpgroups
constexpr int kTcThreads = 128 * kTcConsumers + 32;  // and one producer warp
constexpr int kBoxBytes = 128;  // depth of a TMA box and of a ring stage, bytes (the swizzle span)
constexpr int kWgM = 64;     // query rows of a consumer's wgmma
constexpr int kWgN = 128;    // corpus rows of a consumer's wgmma and of a ring stage
constexpr int kTcSlots = kTcConsumers * kWgM;  // per-row states of a block
// A row's candidate buffer (device memory) holds what one tile can add to
// a buffer that is not full (kCap): it is flushed after a tile, never
// during one, so the epilogue needs no capacity check.
constexpr int kBufCap = kCap + kWgN;
constexpr int kHalfWarps = 2 * 4 * kTcConsumers;  // consumer half-warps (flush staging areas)
// A tile's corpus metadata (its bias, and int8's scales) arrives by TMA in
// a ring of its own (kMetaSlots slots), freed after the tile's epilogue.
constexpr int kMetaSlots = 4;

// Shared memory of a block for a query tile of qt rows in `pieces` parts
// (an f32 query as three bf16 pieces: flat_topk_tc.cu), boxes of BoxD
// elements of depth (kBoxBytes) and MetaSlotBytes a meta slot (ops/topk.py
// `tc_smem` mirrors it), from a 1024-byte aligned base: the ring (each
// stage a corpus box of 128 rows x 128 bytes and, when the query tile
// streams, its pieces' boxes of qt x 128 bytes each), the resident query
// tile (one box of qt x 128 bytes per piece and BoxD of depth), the ring
// of tiles' metadata, a staging area for each consumer half-warp's flush
// (kBufCap entries), the per-row states and the barriers. Every box starts
// on a multiple of 1024 bytes, as the 128-byte swizzle needs.
template <int BoxD, int MetaSlotBytes>
struct TcLayoutOf {
  int chunks, corpus_bytes, stage_bytes, ring_bytes, query_bytes;
  size_t meta_off, flush_off, state_off, bar_off, smem;
  TcLayoutOf() = default;
  __host__ __device__ TcLayoutOf(int qt, int resident, int stages, int D, int pieces = 1) {
    chunks = (D + BoxD - 1) / BoxD;
    corpus_bytes = kWgN * kBoxBytes;
    stage_bytes = corpus_bytes + (resident ? 0 : pieces * qt * kBoxBytes);
    ring_bytes = stages * stage_bytes;
    query_bytes = resident ? pieces * chunks * qt * kBoxBytes : 0;
    meta_off = (size_t)ring_bytes + query_bytes;
    flush_off = meta_off + (size_t)kMetaSlots * MetaSlotBytes;
    state_off = flush_off + (size_t)kHalfWarps * kBufCap * (sizeof(float) + sizeof(int));
    bar_off = state_off + (size_t)kTcSlots * 5 * sizeof(int);
    smem = 1024 + bar_off + (size_t)(2 * stages + 1 + 2 * kMetaSlots) * sizeof(uint64_t);
  }
};

// The per-row states, at state_off of the aligned base: one pointer, so
// that they take two registers, not ten.
struct TcState {
  float* p;
  __device__ float* thr_s() const { return p; }  // the row's list's k-th entry
  __device__ int* thr_i() const { return reinterpret_cast<int*>(p + kTcSlots); }
  __device__ int* cnt() const { return reinterpret_cast<int*>(p + 2 * kTcSlots); }  // buffered
  __device__ int* len() const { return reinterpret_cast<int*>(p + 3 * kTcSlots); }  // listed
  __device__ float* bnd() const { return p + 4 * kTcSlots; }  // the bound the splits share
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// until the phase of parity `parity` of the barrier has completed; a wait
// that lasts ~2^34 cycles (about 10 s) traps, so that a fault in the
// schedule ends the launch with an error instead of holding the card
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}
// a box of the tensor map at (element c0 of depth, row c1) into shared
// memory at dst; its bytes complete on the barrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
// a box of a 1-D tensor map at element c0
__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}
// wgmma descriptor of a K-major tile in shared memory with the 128-byte
// swizzle: rows of 128 bytes, 8-row atoms 1024 bytes apart (SBO); a wgmma's
// step of depth within the atom (32 bytes: k16 of bf16, k32 of int8) adds
// 32 bytes to the start address
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accesses of the sums across a wgmma fence
// or wait (int8's int32 sums, bf16's f32 ones)
__device__ __forceinline__ void fence_operands(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The flush of a candidate buffer in shared memory into a list in device
// memory (sort_buffer, merge_sorted), which flat_topk_tc.cu's K2tc and
// flat_topk_k1tc.cu's K1 over bf16 rows share: a second implementation
// beside topk_merge.cuh's flush_row_inline, which K6/K7 (int8_topk.cu)
// still use, until K6 has been timed on it; then one of the two goes.
//
// Sort a half-warp's n buffered candidates (bs, bi, in shared memory) by the
// shared order. Each lane ranks its entries l16, l16 + 16, ... (E of them)
// in one pass over the buffer, each entry read once for all of them, then
// writes each to its rank. flush_row_inline's own ranking walks the buffer
// once per entry, a dependent shared-memory load a step: ~30 cycles a
// compare, up to 8 x 128 steps on a list's first tile.
template <int E>
__device__ __forceinline__ void sort_buffer_e(float* bs, int* bi, int n, unsigned hmask, int l16) {
  __syncwarp(hmask);
  float es[E];
  int ei[E], rk[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int idx = l16 + 16 * e;
    es[e] = idx < n ? bs[idx] : kNegInf;
    ei[e] = idx < n ? bi[idx] : -1;
    rk[e] = 0;
  }
#pragma unroll 4
  for (int f = 0; f < n; ++f) {
    const float s = bs[f];
    const int i = bi[f];
#pragma unroll
    for (int e = 0; e < E; ++e) rk[e] += beats(s, i, es[e], ei[e]);
  }
  __syncwarp(hmask);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (l16 + 16 * e < n) {
      bs[rk[e]] = es[e];
      bi[rk[e]] = ei[e];
    }
  }
}
// the usual flush (33 to 48 entries) ranks 3 entries a lane, a first
// tile's up to kBufCap
__device__ __forceinline__ void sort_buffer(float* bs, int* bi, int n, unsigned hmask, int l16) {
  if (n <= 48) {
    sort_buffer_e<3>(bs, bi, n, hmask, l16);
  } else {
    sort_buffer_e<(kBufCap + 15) / 16>(bs, bi, n, hmask, l16);
  }
}

// Merge a half-warp's n sorted candidates (bs, bi in shared memory; each
// beats the list's k-th entry) into its row's sorted list (ls, li) of k
// entries in device memory, and move the list's k-th entry to (*ts, *ti).
// The walk of topk_merge.cuh flush_row_inline: from the list's live end
// (*len + n, at most k) down in rounds of 64 positions, an entry at p moves
// to p + c(p), c(p) the buffer entries that beat it, the buffer entries
// ranked [c(p - 1), c(p)) land at rank + p, and the walk stops below the
// first position no buffer entry beats. Two changes cut a round's latency
// (a walk of k = 300 takes 5 rounds): the next round's entries are loaded
// during this one (a round writes only at or above its first position),
// and a lane's five counts (its four entries and, lane 0, the entry below
// the round) are branch-free binary searches run in step.
__device__ __forceinline__ void merge_sorted(const float* bs, const int* bi, int n, float* ls,
                                             int* li, int k, int* len, float* ts, int* ti,
                                             unsigned hmask, int l16) {
  const int top = min(k, *len + n);
  __syncwarp(hmask);
  if (l16 == 0) *len = top;
  // [0, 4): this lane's entries lo + l16 + 16u of a round; [4]: entry lo - 1 (lane 0)
  float cs[5] = {0.f, 0.f, 0.f, 0.f, 0.f}, ns[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  int ci[5] = {0, 0, 0, 0, 0}, ni[5] = {0, 0, 0, 0, 0};
  auto load = [&](int lo, int hi, float (&s)[5], int (&i)[5]) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = lo + l16 + 16 * u;
      if (p < hi) {
        s[u] = __ldcg(ls + p);
        i[u] = __ldcg(li + p);
      }
    }
    if (l16 == 0 && lo > 0) {
      s[4] = __ldcg(ls + lo - 1);
      i[4] = __ldcg(li + lo - 1);
    }
  };
  int hi = top, lo = max(0, top - 64);
  load(lo, hi, cs, ci);
  while (hi > 0) {
    const int nlo = max(0, lo - 64);
    if (lo > 0) load(nlo, lo, ns, ni);  // the next round's entries, in flight during this one
    int b[5] = {0, 0, 0, 0, 0};
    for (int m = n; m > 1;) {
      const int h = m >> 1;
#pragma unroll
      for (int j = 0; j < 5; ++j) b[j] += beats(bs[b[j] + h], bi[b[j] + h], cs[j], ci[j]) ? h : 0;
      m -= h;
    }
    int cp[4], cq[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      cp[u] = lo + l16 + 16 * u < hi ? b[u] + beats(bs[b[u]], bi[b[u]], cs[u], ci[u]) : n;
    }
    int below = l16 == 0 && lo > 0 ? b[4] + beats(bs[b[4]], bi[b[4]], cs[4], ci[4]) : 0;  // c(lo - 1)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int up = __shfl_up_sync(hmask, cp[u], 1, 16);
      const int last = __shfl_sync(hmask, cp[u > 0 ? u - 1 : 0], 15, 16);
      cq[u] = l16 > 0 ? up : (u > 0 ? last : below);
    }
    below = __shfl_sync(hmask, below, 0, 16);
    __syncwarp(hmask);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = lo + l16 + 16 * u;
      if (p >= hi) continue;
      const int c = cp[u];
      if (c > 0 && p + c < k) {
        __stcg(ls + p + c, cs[u]);
        __stcg(li + p + c, ci[u]);
        if (p + c == k - 1) {
          *ts = cs[u];
          *ti = ci[u];
        }
      }
      for (int t = cq[u]; t < c && t + p < k; ++t) {
        __stcg(ls + t + p, bs[t]);
        __stcg(li + t + p, bi[t]);
        if (t + p == k - 1) {
          *ts = bs[t];
          *ti = bi[t];
        }
      }
    }
    __syncwarp(hmask);
    if (below == 0) break;
    hi = lo;
    lo = nlo;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      cs[j] = ns[j];
      ci[j] = ni[j];
    }
  }
}

// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// rows x D elements of `type`, `elt` bytes each (row stride D * elt bytes,
// a multiple of 16; 16-byte aligned), as a TMA map of boxes of 128 bytes of
// depth x box_rows rows, 128-byte swizzle, zeros outside the matrix
bool encode_rows(CUtensorMap* map, CUtensorMapDataType type, int elt, const void* ptr, int rows,
                 int D, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * elt};
  const cuuint32_t box[2] = {(cuuint32_t)(kBoxBytes / elt), (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// n f32 (16-byte aligned) as a 1-D TMA map of boxes of `box` entries,
// zeros past n
bool encode_vector(CUtensorMap* map, const float* ptr, int n, int box) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)n * sizeof(float)};  // not read at rank 1
  const cuuint32_t boxes[1] = {(cuuint32_t)box};
  const cuuint32_t elem[1] = {1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(ptr), dims, strides, boxes,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

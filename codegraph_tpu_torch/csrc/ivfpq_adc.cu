// IVF-PQ asymmetric-distance scan with an exact top-k: for query b and every
// live slot c of its probed cells,
//     score = (probe_s[b, p] + sum_j table[b, j, code[cell, j, c]]) + bias[cell, c]
// with the sum taken over j = 0 .. m-1 in order, in f32, then the k best
// (score, row id) per query, sorted descending, with the slot's global row id
// from id_lists.
//
// Replaces the Pallas kernel K8 of codegraph_tpu/index/ivfpq.py:
//   ivfpq_search_pallas / _adc_cell_kernel (pallas_call at line 273)
// The coarse product q . c, the top-nprobe and the ADC table einsum stay
// outside the kernel, as in the reference; they are PyTorch calls in
// index/ivfpq.py (ivfpq_search_cuda).
//
// What bounds it on the H100:
//   * Bytes: the codes, ids and biases of the probed cells' live slots, read
//     once, (m + 8) bytes a slot: at 10M x 768 rows, nlist 4096, nprobe 64,
//     m 96, about 16 MB for one query (5 us at 3.35 TB/s) and the whole 1 GB
//     code store for a batch of 1024.
//   * Lookups: m table reads and f32 adds per probed live slot and query
//     (15.4 G at B = 1024). Shared memory serves 32 banks a cycle, so the
//     floor is 32 lookups per SM and clock (about 2 ms at B = 1024) when the
//     32 lanes of a warp hit 32 banks, and ~3.5x that when they look up 32
//     random codes of one table row.
// What the design does about it:
//   * Grid (query, split); the block stages its query's [m, ksub] table in
//     shared memory (device memory when it does not fit) and scans a range
//     of the concatenation of its probed cells' live extents (fill rounded
//     up to 8), not of their whole capacity. Each thread owns 8 adjacent
//     slots: one 8-byte load per subspace brings its 8 codes. Each
//     half-warp keeps its own list in device memory ([B, splits * 16, k]),
//     fed from a 32-entry candidate buffer in shared memory by flush_row
//     (topk_merge.cuh), so the warps never wait on each other: no block
//     barrier after set-up. A list's k-th score, once it holds k entries,
//     bounds the query's k-th from below; the lists of a query publish it to
//     one word with atomicMax and prune with the largest published. Shared
//     memory does not depend on k, so two blocks fit on an SM at every k.
//   * Each query still reads its probed cells from device memory: a batch
//     whose queries probe the same cells reads them once a query (measured:
//     a route that reads each probed cell once a batch wins only from about
//     512 queries at 10M rows, nlist 4096, nprobe 64; PERF.md).
//   * Pass 2 merges a query's lists (topk_merge.cuh's merge_splits; above
//     its shared memory, k > kMergeMaxK, a pairwise merge in device memory).
//   * The order and sentinels are the other kernels': a higher score wins,
//     the lower row id wins a tie, lists start as (NEG_INF, -1), so dead and
//     pad slots (bias NEG_INF, scores of exactly NEG_INF) never enter. A
//     score is summed in one order: acc over j from 0 in f32, then
//     (probe_s + acc) + bias, each rounded to f32, so that it does not
//     depend on the split or the batch.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "topk_merge.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kHalves = kThreads / 16;   // lists a block (one a half-warp)
constexpr int kCols = 8;                 // adjacent slots a thread
constexpr int kTile = kThreads * kCols;  // slots a block step
constexpr size_t kSmemLimit = 232448;    // shared memory a block may use (227 KB)
constexpr int kMergeMaxK = (int)(kSmemLimit / (kMergeWarps * 3 * 8));

// The bound a query's lists share: a list's k-th score is a lower bound of
// the query's k-th, so the largest one published is too. Scores map to
// unsigned words in the same order; 0 (below every score) means none yet.
__device__ __forceinline__ unsigned f2o(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float o2f(unsigned u) {
  if (u == 0u) return kNegInf;
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}
__device__ __forceinline__ float read_bound(const unsigned* p) {
  return o2f(*reinterpret_cast<const volatile unsigned*>(p));
}
// Publish ts (a full list's k-th) and return the bound after it.
__device__ __forceinline__ float publish_bound(unsigned* p, float ts) {
  const unsigned o = f2o(ts);
  return o2f(max(atomicMax(p, o), o));
}

// ---------------------------------------------------------------------------
// Pass 1
// ---------------------------------------------------------------------------

// Shared memory: the table when staged, the probes' prefix of rounded
// extents and cells, the half-warps' candidate buffers and list states.
size_t qmajor_smem(int m, int ksub, int nprobe, int table_in_smem) {
  return (table_in_smem ? (size_t)m * ksub * sizeof(float) : 0) +
         (size_t)(2 * nprobe + 1) * sizeof(int) +
         (size_t)kHalves * kCap * (sizeof(float) + sizeof(int)) + (size_t)kHalves * 3 * 4;
}

// Grid (B, splits). The query's slots are the concatenation, in probe order,
// of its probed cells' live extents rounded up to 8; split s scans the s-th
// of `splits` equal ranges of it (in groups of 8). Half-warp h of split s
// keeps list s * 16 + h of the query in lists [B, splits * 16, k].
__global__ void __launch_bounds__(kThreads, 2)
    adc_qmajor(const float* __restrict__ table, const int* __restrict__ probe_ids,
               const float* __restrict__ probe_s, const uint8_t* __restrict__ codes,
               const int* __restrict__ ids, const float* __restrict__ bias,
               const int* __restrict__ ext, int nprobe, int m, int ksub, int cap, int k,
               int table_in_smem, float* __restrict__ lists_s, int* __restrict__ lists_i,
               unsigned* __restrict__ bound) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int split = blockIdx.y, S = gridDim.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, half = lane >> 4, l16 = lane & 15, hw = tid >> 4;
  const unsigned hmask = 0xFFFFu << (16 * half);

  const size_t tab_n = (size_t)m * ksub;
  float* tab_s = reinterpret_cast<float*>(smem);
  int* pre = reinterpret_cast<int*>(tab_s + (table_in_smem ? tab_n : 0));  // [nprobe + 1]
  int* pcell = pre + nprobe + 1;                                            // [nprobe]
  float* buf_s = reinterpret_cast<float*>(pcell + nprobe);                  // [16][kCap]
  int* buf_i = reinterpret_cast<int*>(buf_s + kHalves * kCap);
  float* thr_s = reinterpret_cast<float*>(buf_i + kHalves * kCap);
  int* thr_i = reinterpret_cast<int*>(thr_s + kHalves);
  int* len = thr_i + kHalves;

  const float* qtab = table + (size_t)b * tab_n;
  if (table_in_smem) {
    if ((tab_n & 3) == 0) {
      const float4* src = reinterpret_cast<const float4*>(qtab);
      float4* dst = reinterpret_cast<float4*>(tab_s);
      for (size_t p = tid; p < tab_n / 4; p += kThreads) dst[p] = src[p];
    } else {
      for (size_t p = tid; p < tab_n; p += kThreads) tab_s[p] = qtab[p];
    }
  }
  const int* pids = probe_ids + (size_t)b * nprobe;
  for (int p = tid; p < nprobe; p += kThreads) {
    const int cell = pids[p];
    pcell[p] = cell;
    pre[p + 1] = (max(0, min(ext[cell], cap)) + 7) & ~7;
  }
  const int n_lists = S * kHalves;
  const size_t lbase = ((size_t)b * n_lists + (size_t)split * kHalves + hw) * k;
  for (int p = l16; p < k; p += 16) {
    __stcg(lists_s + lbase + p, kNegInf);
    __stcg(lists_i + lbase + p, -1);
  }
  if (l16 == 0) {
    thr_s[hw] = kNegInf;
    thr_i[hw] = -1;
    len[hw] = 0;
  }
  __syncthreads();
  if (tid < 32) {  // pre[p] = the rounded extents of probes 0 .. p-1
    int carry = 0;
    for (int p0 = 0; p0 < nprobe; p0 += 32) {
      const int p = p0 + lane;
      int v = p < nprobe ? pre[p + 1] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int n = __shfl_up_sync(kFull, v, off);
        if (lane >= off) v += n;
      }
      if (p < nprobe) pre[p + 1] = carry + v;
      carry += __shfl_sync(kFull, v, 31);
    }
    if (lane == 0) pre[0] = 0;
  }
  __syncthreads();

  const int total = pre[nprobe];
  const int per = ((total >> 3) + S - 1) / S * 8;
  const int u_begin = min(total, split * per);
  const int u_end = min(total, u_begin + per);
  const float* tab = table_in_smem ? tab_s : qtab;
  const float* pss = probe_s + (size_t)b * nprobe;
  const unsigned kmask = (unsigned)ksub - 1u;  // ksub is a power of two
  unsigned* bnd = bound + b;
  float* hb_s = buf_s + hw * kCap;
  int* hb_i = buf_i + hw * kCap;
  float lb = kNegInf, ts = kNegInf;
  int ti = -1, c = 0;

  for (int t0 = u_begin; t0 < u_end; t0 += kTile) {
    lb = fmaxf(lb, read_bound(bnd));
    const int u = t0 + tid * kCols;
    float sc[kCols];
    int iv[kCols];
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      sc[e] = kNegInf;
      iv[e] = -1;
    }
    if (u < u_end) {
      int lo = 0, hi = nprobe;  // the probe whose range holds u
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (pre[mid] <= u) {
          lo = mid;
        } else {
          hi = mid;
        }
      }
      const int p = lo;
      const int cell = pcell[p];
      const int col = u - pre[p];
      const size_t slot = (size_t)cell * cap + col;
      const float4 b0 = *reinterpret_cast<const float4*>(bias + slot);
      const float4 b1 = *reinterpret_cast<const float4*>(bias + slot + 4);
      const float bv[kCols] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      bool live = false;
#pragma unroll
      for (int e = 0; e < kCols; ++e) live |= bv[e] > 0.5f * kNegInf;
      if (live) {
        const int4 i0 = *reinterpret_cast<const int4*>(ids + slot);
        const int4 i1 = *reinterpret_cast<const int4*>(ids + slot + 4);
        iv[0] = i0.x; iv[1] = i0.y; iv[2] = i0.z; iv[3] = i0.w;
        iv[4] = i1.x; iv[5] = i1.y; iv[6] = i1.z; iv[7] = i1.w;
        float acc[kCols];
#pragma unroll
        for (int e = 0; e < kCols; ++e) acc[e] = 0.f;
        const uint8_t* cp = codes + (size_t)cell * m * cap + col;
#pragma unroll 4
        for (int j = 0; j < m; ++j) {
          const uint2 w = *reinterpret_cast<const uint2*>(cp + (size_t)j * cap);
          const float* tj = tab + (size_t)j * ksub;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[e] += tj[(w.x >> (8 * e)) & kmask];
            acc[4 + e] += tj[(w.y >> (8 * e)) & kmask];
          }
        }
        const float ps = pss[p];
#pragma unroll
        for (int e = 0; e < kCols; ++e) sc[e] = __fadd_rn(__fadd_rn(ps, acc[e]), bv[e]);
      }
    }
    // the half-warp offers its 16 x 8 scores to its buffer, in a fixed order
#pragma unroll 1
    for (int e = 0; e < kCols; ++e) {
      const float s = sc[e];
      const int id = iv[e];
      bool v = s >= lb && beats(s, id, ts, ti);
      unsigned hb = (__ballot_sync(kFull, v) >> (16 * half)) & 0xFFFFu;
      if (c + __popc(hb) > kCap) {  // the half-warp's buffer is full
        flush_row(hb_s, hb_i, c, lists_s + lbase, lists_i + lbase, k, len + hw, thr_s + hw,
                  thr_i + hw, hmask, l16);
        ts = thr_s[hw];
        ti = thr_i[hw];
        if (len[hw] == k) {
          float nb = 0.f;
          if (l16 == 0) nb = publish_bound(bnd, ts);
          lb = fmaxf(lb, __shfl_sync(hmask, nb, 0, 16));
        }
        c = 0;
        v = v && s >= lb && beats(s, id, ts, ti);
        hb = (__ballot_sync(hmask, v) >> (16 * half)) & 0xFFFFu;
      }
      if (v) {
        const int pos = c + __popc(hb & ((1u << l16) - 1u));
        hb_s[pos] = s;
        hb_i[pos] = id;
      }
      c += __popc(hb);
    }
  }
  if (c > 0) {
    flush_row(hb_s, hb_i, c, lists_s + lbase, lists_i + lbase, k, len + hw, thr_s + hw,
              thr_i + hw, hmask, l16);
    if (len[hw] == k && l16 == 0) publish_bound(bnd, thr_s[hw]);
  }
}

// ---------------------------------------------------------------------------
// Pass 2
// ---------------------------------------------------------------------------

// One level of a pairwise merge in device memory, for k above what
// topk_merge's shared memory holds: [B, S_in, k] -> [B, ceil(S_in / 2), k].
__global__ void __launch_bounds__(kMergeWarps * 32)
    merge_pairs_global(const float* __restrict__ in_s, const int* __restrict__ in_i, int B,
                       int S_in, int k, float* __restrict__ out_s, int* __restrict__ out_i) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int S_out = (S_in + 1) / 2;
  const long long w = (long long)blockIdx.x * kMergeWarps + warp;
  if (w >= (long long)B * S_out) return;
  const int b = (int)(w / S_out), g = (int)(w % S_out);
  const size_t a = ((size_t)b * S_in + 2 * g) * k;
  const size_t dst = ((size_t)b * S_out + g) * k;
  if (2 * g + 1 < S_in) {
    merge_two(in_s + a, in_i + a, in_s + a + k, in_i + a + k, out_s + dst, out_i + dst, k, lane);
  } else {
    for (int p = lane; p < k; p += 32) {
      out_s[dst + p] = in_s[a + p];
      out_i[dst + p] = in_i[a + p];
    }
  }
}

long long lists_work_entries(int B, int k, int lists, int group) {
  return merge_work_entries(B, k, lists, k <= kMergeMaxK ? group : 2);
}

// Merge the [B, lists, k] lists at the start of work_s / work_i into out.
cudaError_t merge_lists(int B, int k, int lists, int group, float* out_s, int* out_i,
                        float* work_s, int* work_i, cudaStream_t st) {
  if (lists <= 1) return cudaSuccess;  // pass 1 wrote the output
  if (k <= kMergeMaxK) return merge_splits(B, k, lists, group, out_s, out_i, work_s, work_i, st);
  float* src_s = work_s;
  int* src_i = work_i;
  float* alt_s = work_s + (size_t)B * k * lists;
  int* alt_i = work_i + (size_t)B * k * lists;
  int S = lists;
  while (S > 1) {
    const int S_out = (S + 1) / 2;
    float* dst_s = S_out == 1 ? out_s : alt_s;
    int* dst_i = S_out == 1 ? out_i : alt_i;
    const long long warps = (long long)B * S_out;
    const unsigned blocks = (unsigned)((warps + kMergeWarps - 1) / kMergeWarps);
    merge_pairs_global<<<blocks, kMergeWarps * 32, 0, st>>>(src_s, src_i, B, S, k, dst_s, dst_i);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    alt_s = src_s;
    alt_i = src_i;
    src_s = dst_s;
    src_i = dst_i;
    S = S_out;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Shared memory (bytes) of a query-major block.
long long ivfpq_qmajor_smem(int m, int ksub, int nprobe, int table_in_smem) {
  return (long long)qmajor_smem(m, ksub, nprobe, table_in_smem);
}

// Scratch entries (per scores and per ids) for `lists` lists a query:
// the lists [B, lists, k] and room for the first merge level.
long long ivfpq_adc_work_entries(int B, int k, int lists, int group) {
  return lists_work_entries(B, k, lists, group);
}

// The largest k that pass 2 merges in shared memory.
int ivfpq_merge_max_k() { return kMergeMaxK; }

// Common inputs, all contiguous on the device of `stream`: table [B, m, ksub]
// f32, probe_s [B, nprobe] f32, codes [nlist, m, cap] u8, ids / bias
// [nlist, cap] i32 / f32, ext [nlist] i32 (live slots of each cell, a
// prefix; clipped to [0, cap]), with cap % 8 == 0 and ksub a power of two <=
// 256. Writes out_s [B, k] f32 and out_i [B, k] i32; work_s / work_i hold
// ivfpq_adc_work_entries(B, k, lists, group) entries each and bound B
// words. Returns the CUDA error code of its launches (0 = success).

// probe_ids [B, nprobe] i32; `splits` blocks a query, so lists = 16 * splits.
int ivfpq_adc_qmajor(const float* table, const int* probe_ids, const float* probe_s,
                     const uint8_t* codes, const int* ids, const float* bias, const int* ext,
                     int B, int nprobe, int m, int ksub, int cap, int k, int splits,
                     int table_in_smem, int group, float* out_s, int* out_i, float* work_s,
                     int* work_i, unsigned* bound, void* stream) {
  if (B < 1 || nprobe < 1 || m < 1 || ksub < 1 || ksub > 256 || (ksub & (ksub - 1)) != 0 ||
      cap < 8 || cap % 8 != 0 || (long long)nprobe * cap >= (1ll << 31) || k < 1 ||
      splits < 1 || splits > 65535 || group < 2) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = qmajor_smem(m, ksub, nprobe, table_in_smem);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(bound, 0, (size_t)B * sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(adc_qmajor, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  adc_qmajor<<<dim3(B, splits), kThreads, smem, st>>>(table, probe_ids, probe_s, codes, ids, bias,
                                                       ext, nprobe, m, ksub, cap, k, table_in_smem,
                                                       work_s, work_i, bound);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)merge_lists(B, k, splits * kHalves, group, out_s, out_i, work_s, work_i, st);
}

}  // extern "C"

// IVF-PQ asymmetric-distance scan with an exact top-k: for query b and every
// slot c of its probed cells,
//     score = (probe_s[b, p] + sum_j table[b, j, code[cell, j, c]]) + bias[cell, c]
// then the k best (score, row id) per query, sorted descending, with the
// slot's global row id from id_lists.
//
// Replaces the Pallas kernel K8 of codegraph_tpu/index/ivfpq.py:
//   ivfpq_search_pallas / _adc_cell_kernel (pallas_call at line 273)
// The coarse product q . c, the top-nprobe and the ADC table einsum stay
// outside the kernel, as in the reference; they are PyTorch calls in
// index/ivfpq.py (ivfpq_search_cuda).
//
// What bounds it on the H100:
//   * Bytes: each query reads the codes, ids and biases of its probed cells,
//     (m + 8) bytes per live slot: at 10M x 768 rows, nlist 4096, nprobe 64,
//     m 96, about 16 MB per query (5 us at 3.35 TB/s). At large batches the
//     union of the probed cells is the whole 1 GB code store.
//   * Lookups: m table reads and f32 adds per live slot and query (15.6 G
//     at B = 1024). The adds are 0.23 ms at the f32 rate; the table reads
//     come from shared memory, whose 32 banks serve one random lookup per
//     bank and cycle, so the lookups, not the memory, set the pace at large
//     batches.
// What the design does about it:
//   * Grid (query, split). A split is a range of the query's probed slots
//     (probe-major: probe p covers slots [p * cap, (p + 1) * cap)), a whole
//     number of 2048-slot tiles, so that a single query still fills the 132
//     SMs; pass 2 merges the splits' lists (topk_merge.cuh).
//   * The block stages its query's [m, ksub] table in shared memory (96 KB at
//     m = 96, ksub = 256; no lo/hi 128-lane split, which is a TPU workaround).
//     A table too large for shared memory is read from device memory instead.
//   * Each thread owns 8 adjacent slots of one cell. The codes are subspace-
//     major ([nlist, m, cap]), so one 8-byte load per subspace gives the
//     thread its 8 codes and a warp reads 256 contiguous bytes. A thread whose
//     8 slots are all dead or padding (bias NEG_INF: about half of a cell at
//     capacity factor 2) reads no codes at all.
//   * Scores that beat the list's k-th entry go to a queue in shared memory;
//     warp 0 offers the queue to the block's one sorted list with the ballot
//     insert of topk_merge.cuh. After the first tiles almost nothing passes.
//   * Any k: the list lives in shared memory when it fits beside the table and
//     the queue, else in device memory (its final place in the output); pass 2
//     runs only for k up to what its shared memory holds, and larger k are
//     served by one split per query.
//   * The order and sentinels are the other kernels': a higher score wins, the
//     lower row id wins a tie, lists start as (NEG_INF, -1), so dead and pad
//     slots (bias NEG_INF, scores of exactly NEG_INF) never enter.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "topk_merge.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 8;                  // adjacent slots per thread
constexpr int kTile = kThreads * kCols;   // slots per tile
constexpr size_t kSmemLimit = 232448;     // shared memory a block may use (227 KB)

// Shared memory: queue (kTile scores + ids), its count (16 bytes), the table
// when staged, the list when it lives there.
size_t pass1_smem(int m, int ksub, int k, int table_in_smem, int list_in_smem) {
  return (size_t)kTile * (sizeof(float) + sizeof(int)) + 16 +
         (table_in_smem ? (size_t)m * ksub * sizeof(float) : 0) +
         (list_in_smem ? (size_t)k * (sizeof(float) + sizeof(int)) : 0);
}

__global__ void __launch_bounds__(kThreads)
    adc_pass1(const float* __restrict__ table, const int* __restrict__ probe_ids,
              const float* __restrict__ probe_s, const uint8_t* __restrict__ codes,
              const int* __restrict__ ids, const float* __restrict__ bias, int nprobe, int m,
              int ksub, int cap, int k, long long slots_per_split, int table_in_smem,
              int list_in_smem, float* __restrict__ part_s, int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long total = (long long)nprobe * cap;
  const long long u_begin = (long long)split * slots_per_split;
  const long long u_end = min(total, u_begin + slots_per_split);

  float* q_s = reinterpret_cast<float*>(smem);
  int* q_i = reinterpret_cast<int*>(q_s + kTile);
  int* q_n = q_i + kTile;
  float* tab_s = reinterpret_cast<float*>(q_n + 4);
  const size_t tab_n = (size_t)m * ksub;
  float* ls_s = tab_s + (table_in_smem ? tab_n : 0);
  int* li_s = reinterpret_cast<int*>(ls_s + (list_in_smem ? k : 0));

  const size_t out_row = ((size_t)b * gridDim.y + split) * k;
  float* ls = list_in_smem ? ls_s : part_s + out_row;
  int* li = list_in_smem ? li_s : part_i + out_row;
  const float* qtab = table + (size_t)b * tab_n;
  const float* tab = table_in_smem ? tab_s : qtab;
  const int* pids = probe_ids + (size_t)b * nprobe;
  const float* pss = probe_s + (size_t)b * nprobe;
  const unsigned kmask = (unsigned)ksub - 1u;  // ksub is a power of two

  for (int p = tid; p < k; p += kThreads) {
    ls[p] = kNegInf;
    li[p] = -1;
  }
  if (table_in_smem) {
    for (size_t p = tid; p < tab_n; p += kThreads) tab_s[p] = qtab[p];
  }
  if (tid == 0) *q_n = 0;
  __syncthreads();

  for (long long t0 = u_begin; t0 < u_end; t0 += kTile) {
    const float ts = ls[k - 1];
    const int ti = li[k - 1];
    const long long u = t0 + (long long)tid * kCols;
    if (u < u_end) {
      const int p = (int)(u / cap);
      const int c = (int)(u - (long long)p * cap);
      const int cell = pids[p];
      const size_t slot = (size_t)cell * cap + c;
      const float4 b0 = *reinterpret_cast<const float4*>(bias + slot);
      const float4 b1 = *reinterpret_cast<const float4*>(bias + slot + 4);
      const float bv[kCols] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      bool live = false;
#pragma unroll
      for (int e = 0; e < kCols; ++e) live |= bv[e] > 0.5f * kNegInf;
      if (live) {
        const int4 i0 = *reinterpret_cast<const int4*>(ids + slot);
        const int4 i1 = *reinterpret_cast<const int4*>(ids + slot + 4);
        const int iv[kCols] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y, i1.z, i1.w};
        float acc[kCols];
#pragma unroll
        for (int e = 0; e < kCols; ++e) acc[e] = 0.f;
        const uint8_t* cp = codes + (size_t)cell * m * cap + c;
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
        for (int e = 0; e < kCols; ++e) {
          const float s = __fadd_rn(__fadd_rn(ps, acc[e]), bv[e]);
          if (beats(s, iv[e], ts, ti)) {
            const int at = atomicAdd(q_n, 1);
            q_s[at] = s;
            q_i[at] = iv[e];
          }
        }
      }
    }
    __syncthreads();
    if (tid < 32) {  // warp 0 offers the queue to the list
      const int n = *q_n;
      float ws = ls[k - 1];
      int wi = li[k - 1];
      for (int base = 0; base < n; base += 32) {
        const int at = base + lane;
        const bool valid = at < n;
        warp_offer(valid ? q_s[at] : kNegInf, valid ? q_i[at] : -1, valid, ls, li, k, ws, wi, lane);
      }
      if (lane == 0) *q_n = 0;
    }
    __syncthreads();
  }
  if (list_in_smem) {
    for (int p = tid; p < k; p += kThreads) {
      part_s[out_row + p] = ls[p];
      part_i[out_row + p] = li[p];
    }
  }
}

}  // namespace

extern "C" {

// Shared memory (bytes) of pass 1 for a table of m x ksub floats and a list
// of k entries, each staged or not.
long long ivfpq_adc_smem(int m, int ksub, int k, int table_in_smem, int list_in_smem) {
  return (long long)pass1_smem(m, ksub, k, table_in_smem, list_in_smem);
}

// Scratch entries (per scores and per ids) that ivfpq_adc needs.
long long ivfpq_adc_work_entries(int B, int k, int splits, int group) {
  return merge_work_entries(B, k, splits, group);
}

// table [B, m, ksub] f32, probe_ids / probe_s [B, nprobe] i32 / f32, codes
// [nlist, m, cap] u8, ids / bias [nlist, cap] i32 / f32, all contiguous on the
// device of `stream`, with cap % 8 == 0 and ksub a power of two <= 256.
// Writes out_s [B, k] f32 and out_i [B, k] i32. Pass 1 covers each query's
// nprobe * cap slots in `splits` ranges of `slots_per_split` (a multiple of
// 2048); work_s / work_i hold ivfpq_adc_work_entries(B, k, splits, group)
// entries each. Returns the CUDA error code of the launches (0 = success).
int ivfpq_adc(const float* table, const int* probe_ids, const float* probe_s, const uint8_t* codes,
              const int* ids, const float* bias, int B, int nprobe, int m, int ksub, int cap, int k,
              int splits, long long slots_per_split, int table_in_smem, int list_in_smem, int group,
              float* out_s, int* out_i, float* work_s, int* work_i, void* stream) {
  const long long total = (long long)nprobe * cap;
  if (B < 1 || nprobe < 1 || m < 1 || ksub < 1 || ksub > 256 || (ksub & (ksub - 1)) != 0 ||
      cap < 8 || cap % 8 != 0 || k < 1 || splits < 1 || splits > 65535 || group < 2 ||
      slots_per_split < kTile || slots_per_split % kTile != 0 ||
      (long long)splits * slots_per_split < total ||
      (long long)(splits - 1) * slots_per_split >= total) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = pass1_smem(m, ksub, k, table_in_smem, list_in_smem);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaFuncSetAttribute(adc_pass1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  float* part_s = splits == 1 ? out_s : work_s;
  int* part_i = splits == 1 ? out_i : work_i;
  adc_pass1<<<dim3(B, splits), kThreads, smem, st>>>(table, probe_ids, probe_s, codes, ids, bias,
                                                      nprobe, m, ksub, cap, k, slots_per_split,
                                                      table_in_smem, list_in_smem, part_s, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (splits == 1) return 0;
  return (int)merge_splits(B, k, splits, group, out_s, out_i, work_s, work_i, st);
}

}  // extern "C"

// Exact streaming top-k over a device-resident corpus: scores = q . x^T + bias,
// then the k best rows per query, sorted descending.
//
// Replaces the two Pallas kernels on the flat index's search path
// (codegraph_tpu/ops/topk.py):
//   K1  streaming_topk_pallas        / _flat_topk_kernel         (batches < 32)
//   K2  streaming_topk_pallas_qmajor / _flat_topk_qmajor_kernel  (batches >= 32)
// Both are this one kernel with a different warp layout and query tile:
// up to 8 query rows for K1, up to 64 for K2 (the tile shrinks as k grows,
// so the per-row top-k lists fit in shared memory beside the operand tiles).
//
// What bounds it on the H100:
//   * K1 (B <= 8 live rows per tile) reads the whole corpus once per call
//     and does 2*BT flops per corpus element: memory bound. 1M x 768 f32 is
//     3.07 GB, 0.92 ms at 3.35 TB/s.
//   * K2 (B = 1024) does 2*B*N*D flops in true f32 FMA (no TF32, no tensor
//     cores): compute bound. 1.61 TFLOP at 1M x 768, about 24 ms at 67 TFLOP/s.
// What the design does about it:
//   * Pass 1 splits the corpus rows across blocks, grid (query tiles, splits),
//     so that even one query tile fills all 132 SMs. Each block walks its
//     rows in corpus tiles, DK=32 columns per step. A step's query and corpus
//     slices are loaded from device memory into registers (16-byte loads) one
//     step ahead, while the block computes on the previous step's slices in
//     shared memory, so the load latency hides behind the FMAs. Each thread
//     keeps a TM x TNN micro tile of scores in registers; a bf16 corpus is
//     widened with __bfloat162float.
//   * Two warp layouts. K2 ("row warps"): the 8 warps own 8 groups of TM
//     query rows over a 128-row corpus tile, so one corpus element read from
//     shared memory feeds TM FMAs per thread (TM up to 16: at B = 1024 the
//     shared-memory reads, not the FMAs, set the pace below that) and a warp
//     owns whole rows of scores.
//     K1 ("column warps"): the 8 warps share the TM = BT <= 8 query rows and
//     split a 256-row corpus tile between them, so a single query does no
//     work for padding rows.
//   * A row's scores are offered to the row's sorted top-k list in shared
//     memory by the warp that owns the row (K2: straight from registers; K1:
//     through a score tile in shared memory). A score enters only if it beats
//     the list's current k-th entry: the threshold idea of
//     _threshold_merge_impl, so after the first tiles almost nothing is
//     inserted and the merge costs a ballot per 32 scores.
//   * Pass 2 merges the per-split lists [B, S, k] in levels of G lists per
//     warp (merge path of two sorted lists), until one list per query is left.
//   * No atomics: every list is built in a fixed order, so the output is
//     deterministic.
//
// Order: a candidate (s1, i1) beats (s2, i2) when s1 > s2, or s1 == s2 and
// i1 < i2 (the lower row id wins a tie). Lists start as (NEG_INF, -1), so a
// row whose score is NEG_INF or below (a tombstone) never enters, and rows
// past the live count come out as (NEG_INF, -1), like the TPU kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDK = 32;   // depth staged per step
constexpr int kMergeWarps = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool beats(float s1, int i1, float s2, int i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

// Insert (cs, ci) into a warp-owned sorted list of length k. The caller has
// checked that the candidate beats ls[k-1]. The entries that beat the
// candidate form a prefix; its length is found in two ballots (32 samples,
// then the one segment), then the tail shifts down one slot, high to low.
__device__ void warp_insert(float* ls, int* li, int k, float cs, int ci, int lane) {
  const int seg = (k + 31) / 32;
  const int e = min(k - 1, (lane + 1) * seg - 1);
  const int c1 = __popc(__ballot_sync(kFull, beats(ls[e], li[e], cs, ci)));
  const int base = c1 * seg;
  const int p2 = base + lane;
  const bool in2 = lane < seg && p2 < k && beats(ls[p2], li[p2], cs, ci);
  const int pos = base + __popc(__ballot_sync(kFull, in2));
  for (int hi = k - 2; hi >= pos; hi -= 32) {
    const int p = hi - lane;
    const bool act = p >= pos;
    float v = 0.f;
    int vi = 0;
    if (act) {
      v = ls[p];
      vi = li[p];
    }
    __syncwarp();
    if (act) {
      ls[p + 1] = v;
      li[p + 1] = vi;
    }
    __syncwarp();
  }
  if (lane == 0) {
    ls[pos] = cs;
    li[pos] = ci;
  }
  __syncwarp();
}

// Offer one candidate per lane to the warp's list; (ts, ti) is the list's
// k-th entry, kept current.
__device__ __forceinline__ void warp_offer(float s, int id, bool valid, float* ls, int* li,
                                           int k, float& ts, int& ti, int lane) {
  unsigned m = __ballot_sync(kFull, valid && beats(s, id, ts, ti));
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float cs = __shfl_sync(kFull, s, src);
    const int ci = __shfl_sync(kFull, id, src);
    if (beats(cs, ci, ts, ti)) {  // the threshold may have risen meanwhile
      warp_insert(ls, li, k, cs, ci, lane);
      ts = ls[k - 1];
      ti = li[k - 1];
    }
  }
}

// Pass 1 layouts: warps as WR row groups x (8 / WR) column groups, each
// thread a TM x TNN micro tile. Row warps (K2): WR = 8, TNN = 4, corpus tile
// 128. Column warps (K1): WR = 1, TNN = 1, corpus tile 256.
template <int WR, int TM, int TNN>
struct Layout {
  static constexpr int WC = kWarps / WR;
  static constexpr int BT = WR * TM;          // query rows per block
  static constexpr int TN = WC * 32 * TNN;    // corpus rows per tile
  static constexpr int QLD = BT + 4;          // qs row stride ([DK][QLD])
  static constexpr int XLD = TN + 1;          // xs row stride ([DK][XLD])
  static constexpr bool kRowMerge = WC == 1;  // a warp holds whole score rows
  static size_t smem(int k) {
    return sizeof(float) * ((size_t)kDK * (QLD + XLD) + (kRowMerge ? 0 : (size_t)BT * TN)) +
           (size_t)BT * k * (sizeof(float) + sizeof(int));
  }
};

__device__ __forceinline__ void unpack(const uint4& v, float* out, float) {
  out[0] = __uint_as_float(v.x);
  out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z);
  out[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ void unpack(const uint4& v, float* out, __nv_bfloat16) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

size_t merge_smem(int k) { return (size_t)kMergeWarps * 3 * k * (sizeof(float) + sizeof(int)); }

// Pass 1: block (query tile, split) -> top-k of the split's rows per query.
// Requires D % (16 / sizeof(XT)) == 0 and a 16-byte aligned x.
template <typename XT, int WR, int TM, int TNN>
__global__ void __launch_bounds__(kThreads)
    topk_pass1(const float* __restrict__ q, const XT* __restrict__ x, const float* __restrict__ bias,
               int B, int N, int D, int k, int rows_per_split, float* __restrict__ part_s,
               int* __restrict__ part_i) {
  using L = Layout<WR, TM, TNN>;
  constexpr int BT = L::BT, TN = L::TN, QLD = L::QLD, XLD = L::XLD, WC = L::WC;
  constexpr int EPV = 16 / sizeof(XT);                      // elements per 16-byte load
  constexpr int VPR = kDK / EPV;                            // loads per row per step
  constexpr int XV = TN * VPR / kThreads;                   // corpus loads per thread
  constexpr int QE = (BT * kDK + kThreads - 1) / kThreads;  // query loads per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [DK][QLD]
  float* xs = qs + kDK * QLD;                  // [DK][XLD]
  float* ss = xs + kDK * XLD;                  // [BT][TN], column warps only
  float* ls = ss + (L::kRowMerge ? 0 : BT * TN);  // [BT][k]
  int* li = reinterpret_cast<int*>(ls + BT * k);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wr = warp / WC, wc = warp % WC;
  const int b0 = blockIdx.x * BT;
  const int split = blockIdx.y;
  const int n_begin = split * rows_per_split;
  const int n_end = min(N, n_begin + rows_per_split);
  const int n_chunks = (D + kDK - 1) / kDK;
  const int steps = (n_end - n_begin + TN - 1) / TN * n_chunks;

  for (int p = tid; p < BT * k; p += kThreads) {
    ls[p] = kNegInf;
    li[p] = -1;
  }

  uint4 xr[XV];
  float qr[QE];
  auto load = [&](int step) {
    const int n0 = n_begin + (step / n_chunks) * TN;
    const int d0 = (step % n_chunks) * kDK;
#pragma unroll
    for (int v = 0; v < XV; ++v) {
      const int vi = tid + v * kThreads, r = vi / VPR, d = d0 + (vi % VPR) * EPV;
      xr[v] = (n0 + r < n_end && d < D)
                  ? *reinterpret_cast<const uint4*>(x + (size_t)(n0 + r) * D + d)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int e = 0; e < QE; ++e) {
      const int p = tid + e * kThreads, r = p / kDK, d = d0 + p % kDK;
      qr[e] = (p < BT * kDK && b0 + r < B && d < D) ? q[(size_t)(b0 + r) * D + d] : 0.f;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int v = 0; v < XV; ++v) {
      const int vi = tid + v * kThreads, r = vi / VPR, c = (vi % VPR) * EPV;
      float f[EPV];
      unpack(xr[v], f, XT());
#pragma unroll
      for (int e = 0; e < EPV; ++e) xs[(c + e) * XLD + r] = f[e];
    }
#pragma unroll
    for (int e = 0; e < QE; ++e) {
      const int p = tid + e * kThreads;
      if (p < BT * kDK) qs[(p % kDK) * QLD + p / kDK] = qr[e];
    }
  };

  float acc[TM][TNN];
  if (steps > 0) load(0);
  for (int step = 0; step < steps; ++step) {
    const int chunk = step % n_chunks;
    if (chunk == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TNN; ++j) acc[i][j] = 0.f;
    }
    store();
    __syncthreads();
    if (step + 1 < steps) load(step + 1);  // in flight during the FMAs below
#pragma unroll 4
    for (int c = 0; c < kDK; ++c) {
      float qv[TM];
      float xv[TNN];
      const float* qrow = qs + c * QLD + wr * TM;
      if constexpr (TM % 4 == 0) {
#pragma unroll
        for (int i = 0; i < TM; i += 4) {
          const float4 v = *reinterpret_cast<const float4*>(qrow + i);
          qv[i] = v.x;
          qv[i + 1] = v.y;
          qv[i + 2] = v.z;
          qv[i + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) qv[i] = qrow[i];
      }
#pragma unroll
      for (int j = 0; j < TNN; ++j) xv[j] = xs[c * XLD + wc * 32 * TNN + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TNN; ++j) acc[i][j] = fmaf(qv[i], xv[j], acc[i][j]);
    }
    __syncthreads();
    if (chunk != n_chunks - 1) continue;

    // The tile's scores are complete: offer them to the rows' lists.
    const int n0 = n_begin + (step / n_chunks) * TN;
    if constexpr (L::kRowMerge) {
      // lane holds columns lane + 32*j of this warp's TM rows
      float bj[TNN];
#pragma unroll
      for (int j = 0; j < TNN; ++j) {
        const int n = n0 + lane + 32 * j;
        bj[j] = n < n_end ? bias[n] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = wr * TM + i;
        if (b0 + r < B) {
          float* lsr = ls + r * k;
          int* lir = li + r * k;
          float ts = lsr[k - 1];
          int ti = lir[k - 1];
#pragma unroll
          for (int j = 0; j < TNN; ++j) {
            const int n = n0 + lane + 32 * j;
            warp_offer(acc[i][j] + bj[j], n, n < n_end, lsr, lir, k, ts, ti, lane);
          }
        }
      }
    } else {
      // the row's columns are spread over the warps: gather them in ss
#pragma unroll
      for (int j = 0; j < TNN; ++j) {
        const int col = wc * 32 * TNN + lane + 32 * j;
        const float bc = n0 + col < n_end ? bias[n0 + col] : 0.f;
#pragma unroll
        for (int i = 0; i < TM; ++i) ss[(wr * TM + i) * TN + col] = acc[i][j] + bc;
      }
      __syncthreads();
      for (int r = warp; r < BT; r += kWarps) {
        if (b0 + r >= B) break;
        float* lsr = ls + r * k;
        int* lir = li + r * k;
        float ts = lsr[k - 1];
        int ti = lir[k - 1];
        for (int col = lane; col < TN; col += 32) {
          warp_offer(ss[r * TN + col], n0 + col, n0 + col < n_end, lsr, lir, k, ts, ti, lane);
        }
      }
      // the next write of ss comes after at least one more __syncthreads
    }
  }
  __syncthreads();  // lists were written by their owner warps

  const int S = gridDim.y;
  for (int r = warp; r < BT; r += kWarps) {
    const int b = b0 + r;
    if (b >= B) break;
    const size_t base = ((size_t)b * S + split) * k;
    for (int p = lane; p < k; p += 32) {
      part_s[base + p] = ls[r * k + p];
      part_i[base + p] = li[r * k + p];
    }
  }
}

// Top-k of two sorted lists of length k (merge path; a tie keeps a's entry
// first). Lane l writes outputs [l*per, (l+1)*per).
__device__ void merge_two(const float* as, const int* ai, const float* bs, const int* bi,
                          float* cs, int* ci, int k, int lane) {
  const int per = (k + 31) / 32;
  const int p0 = lane * per;
  if (p0 >= k) return;
  int lo = 0, hi = p0;
  while (lo < hi) {  // smallest i whose (i+1)-th a does not precede b[p0-i-1]
    const int mid = (lo + hi) >> 1;
    const int j = p0 - mid - 1;
    if (!beats(bs[j], bi[j], as[mid], ai[mid])) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int i = lo, j = p0 - lo;
  const int p1 = min(k, p0 + per);
  for (int p = p0; p < p1; ++p) {
    if (!beats(bs[j], bi[j], as[i], ai[i])) {
      cs[p] = as[i];
      ci[p] = ai[i];
      ++i;
    } else {
      cs[p] = bs[j];
      ci[p] = bi[j];
      ++j;
    }
  }
}

// Pass 2, one level: [B, S_in, k] -> [B, ceil(S_in / G), k]; one warp
// folds G consecutive lists of one query row.
__global__ void __launch_bounds__(kMergeWarps * 32)
    topk_merge(const float* __restrict__ in_s, const int* __restrict__ in_i, int B, int S_in,
               int G, int k, float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int S_out = (S_in + G - 1) / G;
  const long long w = (long long)blockIdx.x * kMergeWarps + warp;
  if (w >= (long long)B * S_out) return;  // whole warp; no block barrier below
  const int b = (int)(w / S_out);
  const int g = (int)(w % S_out);
  float* fbuf = reinterpret_cast<float*>(smem) + (size_t)warp * 3 * k;
  int* ibuf = reinterpret_cast<int*>(reinterpret_cast<float*>(smem) + (size_t)kMergeWarps * 3 * k) +
              (size_t)warp * 3 * k;
  float* cur_s = fbuf;
  int* cur_i = ibuf;
  float* new_s = fbuf + k;
  int* new_i = ibuf + k;
  float* l_s = fbuf + 2 * k;
  int* l_i = ibuf + 2 * k;

  const int first = g * G;
  const int last = min(S_in, first + G);
  const size_t row = (size_t)b * S_in;
  for (int p = lane; p < k; p += 32) {
    cur_s[p] = in_s[(row + first) * k + p];
    cur_i[p] = in_i[(row + first) * k + p];
  }
  __syncwarp();
  for (int l = first + 1; l < last; ++l) {
    const float* src_s = in_s + (row + l) * k;
    const int* src_i = in_i + (row + l) * k;
    if (!beats(src_s[0], src_i[0], cur_s[k - 1], cur_i[k - 1])) continue;  // warp-uniform
    for (int p = lane; p < k; p += 32) {
      l_s[p] = src_s[p];
      l_i[p] = src_i[p];
    }
    __syncwarp();
    merge_two(cur_s, cur_i, l_s, l_i, new_s, new_i, k, lane);
    __syncwarp();
    float* ts = cur_s;
    cur_s = new_s;
    new_s = ts;
    int* ti = cur_i;
    cur_i = new_i;
    new_i = ti;
  }
  const size_t dst = ((size_t)b * S_out + g) * k;
  for (int p = lane; p < k; p += 32) {
    out_s[dst + p] = cur_s[p];
    out_i[dst + p] = cur_i[p];
  }
}

template <typename XT, int WR, int TM, int TNN>
cudaError_t launch_pass1(const float* q, const void* x, const float* bias, int B, int N, int D, int k,
                         int rows_per_split, int splits, float* part_s, int* part_i, cudaStream_t st) {
  using L = Layout<WR, TM, TNN>;
  if (rows_per_split % L::TN != 0) return cudaErrorInvalidValue;
  const size_t smem = L::smem(k);
  cudaError_t err = cudaFuncSetAttribute(topk_pass1<XT, WR, TM, TNN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + L::BT - 1) / L::BT, splits);
  topk_pass1<XT, WR, TM, TNN><<<grid, kThreads, smem, st>>>(
      q, static_cast<const XT*>(x), bias, B, N, D, k, rows_per_split, part_s, part_i);
  return cudaGetLastError();
}

// layout 0: column warps (K1), tm in {1, 2, 4, 8};
// layout 1: row warps (K2), tm in {1, 2, 4, 8, 16}
template <typename XT>
cudaError_t dispatch_pass1(int layout, int tm, const float* q, const void* x, const float* bias, int B,
                           int N, int D, int k, int rows_per_split, int splits, float* part_s,
                           int* part_i, cudaStream_t st) {
#define CG_PASS1(WR, TM, TNN) \
  launch_pass1<XT, WR, TM, TNN>(q, x, bias, B, N, D, k, rows_per_split, splits, part_s, part_i, st)
  if (layout == 0) {
    switch (tm) {
      case 1: return CG_PASS1(1, 1, 1);
      case 2: return CG_PASS1(1, 2, 1);
      case 4: return CG_PASS1(1, 4, 1);
      case 8: return CG_PASS1(1, 8, 1);
    }
  } else if (layout == 1) {
    switch (tm) {
      case 1: return CG_PASS1(8, 1, 4);
      case 2: return CG_PASS1(8, 2, 4);
      case 4: return CG_PASS1(8, 4, 4);
      case 8: return CG_PASS1(8, 8, 4);
      case 16: return CG_PASS1(8, 16, 4);
    }
  }
#undef CG_PASS1
  return cudaErrorInvalidValue;
}

size_t pass1_smem(int layout, int tm, int k) {
  switch (layout * 32 + tm) {
    case 1: return Layout<1, 1, 1>::smem(k);
    case 2: return Layout<1, 2, 1>::smem(k);
    case 4: return Layout<1, 4, 1>::smem(k);
    case 8: return Layout<1, 8, 1>::smem(k);
    case 33: return Layout<8, 1, 4>::smem(k);
    case 34: return Layout<8, 2, 4>::smem(k);
    case 36: return Layout<8, 4, 4>::smem(k);
    case 40: return Layout<8, 8, 4>::smem(k);
    case 48: return Layout<8, 16, 4>::smem(k);
  }
  return 0;
}

}  // namespace

extern "C" {

// Shared memory (bytes) that pass 1 needs for a layout (0 column warps,
// 1 row warps), micro-tile rows tm and k; 0 for an unknown layout.
long long flat_topk_pass1_smem(int layout, int tm, int k) { return (long long)pass1_smem(layout, tm, k); }

// Scratch entries (per scores and per ids) that flat_topk needs.
long long flat_topk_work_entries(int B, int k, int splits, int group) {
  if (splits <= 1) return 0;
  return (long long)B * k * (splits + (splits + group - 1) / group);
}

// q [B, D] f32, x [N, D] f32 (x_bf16 = 0) or bf16 (x_bf16 = 1), bias [N] f32,
// all contiguous on the device of `stream`, x 16-byte aligned with
// D % 8 == 0. Writes out_s [B, k] f32 and out_i [B, k] i32. Pass 1 runs
// `layout` (0 column warps, 1 row warps) with micro-tile rows `tm`, over
// `splits` ranges of `rows_per_split` corpus rows (a multiple of the
// layout's corpus tile); work_s / work_i hold
// flat_topk_work_entries(B, k, splits, group) entries each. Returns the
// CUDA error code of the launches (0 = success).
int flat_topk(const float* q, const void* x, int x_bf16, const float* bias, int B, int N, int D, int k,
              int layout, int tm, int splits, int rows_per_split, int group, float* out_s, int* out_i,
              float* work_s, int* work_i, void* stream) {
  if (B < 1 || N < 1 || D < 1 || D % 8 != 0 || k < 1 || k > 1024 || splits < 1 || group < 2 ||
      rows_per_split < 1 || (long long)splits * rows_per_split < N ||
      (long long)(splits - 1) * rows_per_split >= N || (reinterpret_cast<size_t>(x) & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part_s = splits == 1 ? out_s : work_s;
  int* part_i = splits == 1 ? out_i : work_i;
  cudaError_t err =
      x_bf16 ? dispatch_pass1<__nv_bfloat16>(layout, tm, q, x, bias, B, N, D, k, rows_per_split, splits,
                                             part_s, part_i, st)
             : dispatch_pass1<float>(layout, tm, q, x, bias, B, N, D, k, rows_per_split, splits, part_s,
                                     part_i, st);
  if (err != cudaSuccess) return (int)err;
  if (splits == 1) return 0;
  const size_t msmem = merge_smem(k);
  err = cudaFuncSetAttribute(topk_merge, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)msmem);
  if (err != cudaSuccess) return (int)err;
  // levels ping-pong between the two halves of the scratch buffers
  float* src_s = work_s;
  int* src_i = work_i;
  float* alt_s = work_s + (size_t)B * k * splits;
  int* alt_i = work_i + (size_t)B * k * splits;
  int S = splits;
  while (S > 1) {
    const int S_out = (S + group - 1) / group;
    float* dst_s = S_out == 1 ? out_s : alt_s;
    int* dst_i = S_out == 1 ? out_i : alt_i;
    const long long warps = (long long)B * S_out;
    const unsigned blocks = (unsigned)((warps + kMergeWarps - 1) / kMergeWarps);
    topk_merge<<<blocks, kMergeWarps * 32, msmem, st>>>(src_s, src_i, B, S, group, k, dst_s, dst_i);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    alt_s = src_s;
    alt_i = src_i;
    src_s = dst_s;
    src_i = dst_i;
    S = S_out;
  }
  return 0;
}

}  // extern "C"

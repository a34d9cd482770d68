// Exact streaming top-k over a device-resident corpus: scores = q . x^T + bias,
// then the k best rows per query, sorted descending.
//
// Replaces four Pallas kernels of codegraph_tpu/ops/topk.py:
//   K1  streaming_topk_pallas           / _flat_topk_kernel            (batches < 32)
//   K2  streaming_topk_pallas_qmajor    / _flat_topk_qmajor_kernel     (batches >= 32)
//   K3  streaming_topk_pallas_qres      / _flat_topk_qres_kernel       (query-resident)
//   K4  streaming_topk_pallas_qmajor_xt / _flat_topk_qmajor_xt_kernel  (corpus as xt [D, N])
// K4 is K2's schedule over a pre-transposed corpus: it stages the same
// [DK][TN] corpus slices, read along N (one element a thread, a warp reading
// 32 consecutive rows of one depth), so it takes any N and D with no
// alignment, and its results equal K2's on xt.T.
// All four are this one kernel with a different warp layout and query tile:
// up to 8 query rows for K1, up to 128 for K2 and K3 (the tile shrinks as k
// grows, so the per-row top-k lists fit in shared memory beside the operand
// tiles). K3 keeps its block's whole query tile resident in shared memory
// for the block's whole corpus split, so that the only operand it streams is
// the corpus (the TPU kernel pins the whole batch in VMEM; 227 KB of shared
// memory per block holds a tile of it, not all of it).
//
// What bounds it on the H100:
//   * K1 (B <= 8 live rows per tile) reads the whole corpus once per call
//     and does 2*BT flops per corpus element: memory bound. 1M x 768 f32 is
//     3.07 GB, 0.92 ms at 3.35 TB/s.
//   * K2 and K3 (B = 1024) do 2*B*N*D flops in true f32 FMA (no TF32, no
//     tensor cores): compute bound. 1.61 TFLOP at 1M x 768, about 24 ms at
//     67 TFLOP/s.
// What the design does about it:
//   * Pass 1 splits the corpus rows across blocks, grid (query tiles, splits),
//     so that even one query tile fills all 132 SMs. Each block walks its
//     rows in corpus tiles, DK=32 columns per step. A step's query and corpus
//     slices are loaded from device memory into registers (16-byte loads) one
//     step ahead, while the block computes on the previous step's slices in
//     shared memory, so the load latency hides behind the FMAs. Each thread
//     keeps a TM x TNN micro tile of scores in registers; a bf16 corpus is
//     widened with __bfloat162float. K3 loads its query tile once, before
//     the first step, and stages only corpus slices.
//   * Two warp layouts. K2/K3 ("row warps"): the 8 warps own 8 groups of TM
//     query rows over a 128-row corpus tile, so one corpus element read from
//     shared memory feeds TM FMAs per thread (TM up to 16: at B = 1024 the
//     shared-memory reads, not the FMAs, set the pace below that) and a warp
//     owns whole rows of scores.
//     K1 ("column warps"): the 8 warps share the TM = BT <= 8 query rows and
//     split a 256-row corpus tile between them, so a single query does no
//     work for padding rows.
//   * A row's scores are offered to the row's sorted top-k list in shared
//     memory by the warp that owns the row (K2/K3: straight from registers;
//     K1: through a score tile in shared memory). A score enters only if it
//     beats the list's current k-th entry: the threshold idea of
//     _threshold_merge_impl, so after the first tiles almost nothing is
//     inserted and the merge costs a ballot per 32 scores (topk_merge.cuh).
//   * Pass 2 merges the per-split lists [B, S, k] in levels of G lists per
//     warp (merge path of two sorted lists), until one list per query is left.
//   * No atomics: every list is built in a fixed order, so the output is
//     deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "topk_merge.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDK = 32;   // depth staged per step

// Pass 1 layouts: warps as WR row groups x (8 / WR) column groups, each
// thread a TM x TNN micro tile. Row warps (K2, K3): WR = 8, TNN = 4, corpus
// tile 128. Column warps (K1): WR = 1, TNN = 1, corpus tile 256. RES keeps
// the query tile resident ([Dpad][QLD] instead of one [DK][QLD] step).
template <int WR, int TM, int TNN, bool RES>
struct Layout {
  static constexpr int WC = kWarps / WR;
  static constexpr int BT = WR * TM;          // query rows per block
  static constexpr int TN = WC * 32 * TNN;    // corpus rows per tile
  static constexpr int QLD = BT + 4;          // qs row stride ([DK][QLD])
  static constexpr int XLD = TN + 1;          // xs row stride ([DK][XLD])
  static constexpr bool kRowMerge = WC == 1;  // a warp holds whole score rows
  static size_t q_depth(int D) { return RES ? (size_t)(D + kDK - 1) / kDK * kDK : kDK; }
  static size_t smem(int k, int D) {
    return sizeof(float) * (q_depth(D) * QLD + (size_t)kDK * XLD +
                            (kRowMerge ? 0 : (size_t)BT * TN)) +
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

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// Pass 1: block (query tile, split) -> top-k of the split's rows per query.
// x is [N, D] and then needs D % (16 / sizeof(XT)) == 0 and 16-byte
// alignment, or (TRANS) xt [D, N] with neither.
template <typename XT, int WR, int TM, int TNN, bool RES, bool TRANS>
__global__ void __launch_bounds__(kThreads)
    topk_pass1(const float* __restrict__ q, const XT* __restrict__ x, const float* __restrict__ bias,
               int B, int N, int D, int k, int rows_per_split, float* __restrict__ part_s,
               int* __restrict__ part_i) {
  using L = Layout<WR, TM, TNN, RES>;
  constexpr int BT = L::BT, TN = L::TN, QLD = L::QLD, XLD = L::XLD, WC = L::WC;
  constexpr int EPV = 16 / sizeof(XT);                      // elements per 16-byte load
  constexpr int VPR = kDK / EPV;                            // loads per row per step
  constexpr int XV = TN * VPR / kThreads;                   // corpus loads per thread
  constexpr int XS = TN * kDK / kThreads;                   // TRANS: element loads per thread
  constexpr int QE = RES ? 1 : (BT * kDK + kThreads - 1) / kThreads;  // query loads per thread
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_chunks = (D + kDK - 1) / kDK;
  const int q_depth = RES ? n_chunks * kDK : kDK;
  float* qs = reinterpret_cast<float*>(smem);  // [q_depth][QLD]
  float* xs = qs + q_depth * QLD;              // [DK][XLD]
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
  const int steps = (n_end - n_begin + TN - 1) / TN * n_chunks;

  for (int p = tid; p < BT * k; p += kThreads) {
    ls[p] = kNegInf;
    li[p] = -1;
  }
  if constexpr (RES) {  // the query tile, once, depth-major; zero past D and B
    for (int p = tid; p < BT * q_depth; p += kThreads) {
      const int r = p / q_depth, d = p % q_depth;
      qs[d * QLD + r] = (b0 + r < B && d < D) ? q[(size_t)(b0 + r) * D + d] : 0.f;
    }
  }

  uint4 xr[XV];
  float xe[XS];
  float qr[QE];
  auto load = [&](int step) {
    const int n0 = n_begin + (step / n_chunks) * TN;
    const int d0 = (step % n_chunks) * kDK;
    if constexpr (TRANS) {
#pragma unroll
      for (int v = 0; v < XS; ++v) {
        const int vi = tid + v * kThreads, c = vi / TN, r = vi % TN;
        xe[v] = (n0 + r < n_end && d0 + c < D) ? to_f(x[(size_t)(d0 + c) * N + n0 + r]) : 0.f;
      }
    } else {
#pragma unroll
      for (int v = 0; v < XV; ++v) {
        const int vi = tid + v * kThreads, r = vi / VPR, d = d0 + (vi % VPR) * EPV;
        xr[v] = (n0 + r < n_end && d < D)
                    ? *reinterpret_cast<const uint4*>(x + (size_t)(n0 + r) * D + d)
                    : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    if constexpr (!RES) {
#pragma unroll
      for (int e = 0; e < QE; ++e) {
        const int p = tid + e * kThreads, r = p / kDK, d = d0 + p % kDK;
        qr[e] = (p < BT * kDK && b0 + r < B && d < D) ? q[(size_t)(b0 + r) * D + d] : 0.f;
      }
    }
  };
  auto store = [&]() {
    if constexpr (TRANS) {
#pragma unroll
      for (int v = 0; v < XS; ++v) {
        const int vi = tid + v * kThreads;
        xs[(vi / TN) * XLD + vi % TN] = xe[v];
      }
    } else {
#pragma unroll
      for (int v = 0; v < XV; ++v) {
        const int vi = tid + v * kThreads, r = vi / VPR, c = (vi % VPR) * EPV;
        float f[EPV];
        unpack(xr[v], f, XT());
#pragma unroll
        for (int e = 0; e < EPV; ++e) xs[(c + e) * XLD + r] = f[e];
      }
    }
    if constexpr (!RES) {
#pragma unroll
      for (int e = 0; e < QE; ++e) {
        const int p = tid + e * kThreads;
        if (p < BT * kDK) qs[(p % kDK) * QLD + p / kDK] = qr[e];
      }
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
    const float* qstep = qs + (RES ? chunk * kDK * QLD : 0);
#pragma unroll 4
    for (int c = 0; c < kDK; ++c) {
      float qv[TM];
      float xv[TNN];
      const float* qrow = qstep + c * QLD + wr * TM;
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

template <typename XT, int WR, int TM, int TNN, bool RES, bool TRANS>
cudaError_t launch_pass1(const float* q, const void* x, const float* bias, int B, int N, int D, int k,
                         int rows_per_split, int splits, float* part_s, int* part_i, cudaStream_t st) {
  using L = Layout<WR, TM, TNN, RES>;
  if (rows_per_split % L::TN != 0) return cudaErrorInvalidValue;
  const size_t smem = L::smem(k, D);
  cudaError_t err = cudaFuncSetAttribute(topk_pass1<XT, WR, TM, TNN, RES, TRANS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + L::BT - 1) / L::BT, splits);
  topk_pass1<XT, WR, TM, TNN, RES, TRANS><<<grid, kThreads, smem, st>>>(
      q, static_cast<const XT*>(x), bias, B, N, D, k, rows_per_split, part_s, part_i);
  return cudaGetLastError();
}

// layout 0: column warps (K1), tm in {1, 2, 4, 8};
// layout 1: row warps (K2), tm in {1, 2, 4, 8, 16};
// layout 2: row warps with the query tile resident (K3), tm as layout 1;
// layout 3: row warps over xt [D, N] (K4), tm as layout 1
template <typename XT>
cudaError_t dispatch_pass1(int layout, int tm, const float* q, const void* x, const float* bias, int B,
                           int N, int D, int k, int rows_per_split, int splits, float* part_s,
                           int* part_i, cudaStream_t st) {
#define CG_PASS1(WR, TM, TNN, RES, TRANS)                                                          \
  launch_pass1<XT, WR, TM, TNN, RES, TRANS>(q, x, bias, B, N, D, k, rows_per_split, splits, part_s, \
                                            part_i, st)
  if (layout == 0) {
    switch (tm) {
      case 1: return CG_PASS1(1, 1, 1, false, false);
      case 2: return CG_PASS1(1, 2, 1, false, false);
      case 4: return CG_PASS1(1, 4, 1, false, false);
      case 8: return CG_PASS1(1, 8, 1, false, false);
    }
  } else if (layout == 1 || layout == 3) {
    const bool t = layout == 3;
    switch (tm) {
      case 1: return t ? CG_PASS1(8, 1, 4, false, true) : CG_PASS1(8, 1, 4, false, false);
      case 2: return t ? CG_PASS1(8, 2, 4, false, true) : CG_PASS1(8, 2, 4, false, false);
      case 4: return t ? CG_PASS1(8, 4, 4, false, true) : CG_PASS1(8, 4, 4, false, false);
      case 8: return t ? CG_PASS1(8, 8, 4, false, true) : CG_PASS1(8, 8, 4, false, false);
      case 16: return t ? CG_PASS1(8, 16, 4, false, true) : CG_PASS1(8, 16, 4, false, false);
    }
  } else if (layout == 2) {
    switch (tm) {
      case 1: return CG_PASS1(8, 1, 4, true, false);
      case 2: return CG_PASS1(8, 2, 4, true, false);
      case 4: return CG_PASS1(8, 4, 4, true, false);
      case 8: return CG_PASS1(8, 8, 4, true, false);
      case 16: return CG_PASS1(8, 16, 4, true, false);
    }
  }
#undef CG_PASS1
  return cudaErrorInvalidValue;
}

size_t pass1_smem(int layout, int tm, int k, int D) {
  switch (layout * 32 + tm) {
    case 1: return Layout<1, 1, 1, false>::smem(k, D);
    case 2: return Layout<1, 2, 1, false>::smem(k, D);
    case 4: return Layout<1, 4, 1, false>::smem(k, D);
    case 8: return Layout<1, 8, 1, false>::smem(k, D);
    case 33: return Layout<8, 1, 4, false>::smem(k, D);
    case 34: return Layout<8, 2, 4, false>::smem(k, D);
    case 36: return Layout<8, 4, 4, false>::smem(k, D);
    case 40: return Layout<8, 8, 4, false>::smem(k, D);
    case 48: return Layout<8, 16, 4, false>::smem(k, D);
    case 65: return Layout<8, 1, 4, true>::smem(k, D);
    case 66: return Layout<8, 2, 4, true>::smem(k, D);
    case 68: return Layout<8, 4, 4, true>::smem(k, D);
    case 72: return Layout<8, 8, 4, true>::smem(k, D);
    case 80: return Layout<8, 16, 4, true>::smem(k, D);
    case 97: return Layout<8, 1, 4, false>::smem(k, D);
    case 98: return Layout<8, 2, 4, false>::smem(k, D);
    case 100: return Layout<8, 4, 4, false>::smem(k, D);
    case 104: return Layout<8, 8, 4, false>::smem(k, D);
    case 112: return Layout<8, 16, 4, false>::smem(k, D);
  }
  return 0;
}

}  // namespace

extern "C" {

// Shared memory (bytes) that pass 1 needs for a layout (0 column warps,
// 1 row warps, 2 row warps with the query tile resident, 3 row warps over
// xt [D, N]), micro-tile rows tm, k and depth D; 0 for an unknown layout.
long long flat_topk_pass1_smem(int layout, int tm, int k, int D) {
  return (long long)pass1_smem(layout, tm, k, D);
}

// Scratch entries (per scores and per ids) that flat_topk needs.
long long flat_topk_work_entries(int B, int k, int splits, int group) {
  return merge_work_entries(B, k, splits, group);
}

// q [B, D] f32, x [N, D] f32 (x_bf16 = 0) or bf16 (x_bf16 = 1), bias [N] f32,
// all contiguous on the device of `stream`, x 16-byte aligned with
// D % 8 == 0; for layout 3, x is xt [D, N], with no alignment or D
// condition. Writes out_s [B, k] f32 and out_i [B, k] i32. Pass 1 runs
// `layout` (0 column warps, 1 row warps, 2 row warps with the query tile
// resident, 3 row warps over xt) with micro-tile rows `tm`, over `splits` ranges of
// `rows_per_split` corpus rows (a multiple of the layout's corpus tile);
// work_s / work_i hold flat_topk_work_entries(B, k, splits, group) entries
// each. Returns the CUDA error code of the launches (0 = success).
int flat_topk(const float* q, const void* x, int x_bf16, const float* bias, int B, int N, int D, int k,
              int layout, int tm, int splits, int rows_per_split, int group, float* out_s, int* out_i,
              float* work_s, int* work_i, void* stream) {
  const bool rows_in_16 = layout != 3;  // x read in 16-byte pieces along D
  if (B < 1 || N < 1 || D < 1 || k < 1 || k > 1024 || splits < 1 || group < 2 ||
      rows_per_split < 1 || (long long)splits * rows_per_split < N ||
      (long long)(splits - 1) * rows_per_split >= N ||
      (rows_in_16 && (D % 8 != 0 || (reinterpret_cast<size_t>(x) & 15) != 0))) {
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
  return (int)merge_splits(B, k, splits, group, out_s, out_i, work_s, work_i, st);
}

}  // extern "C"

// Exact streaming top-k over a device-resident corpus: scores = q . x^T + bias,
// then the k best rows per query, sorted descending.
//
// Replaces four Pallas kernels of codegraph_tpu/ops/topk.py:
//   K1  streaming_topk_pallas           / _flat_topk_kernel            (batches < 32)
//   K2  streaming_topk_pallas_qmajor    / _flat_topk_qmajor_kernel     (batches >= 32)
//   K3  streaming_topk_pallas_qres      / _flat_topk_qres_kernel       (query-resident)
//   K4  streaming_topk_pallas_qmajor_xt / _flat_topk_qmajor_xt_kernel  (corpus as xt [D, N])
// over f32 rows, and K4 over bf16 xt. Over bf16 rows K1 runs on the tensor
// cores in flat_topk_k1tc.cu, K2 and K3 in flat_topk_tc.cu.
//
// Two pass-1 kernels, one pass 2:
//   * topk_pass1 (K1 over f32 rows, "column warps"): up to 8 query rows per block; the 8
//     warps split a 256-row corpus tile, so a single query does no work for
//     padding rows. Each row's sorted top-k list lives in shared memory and
//     takes a score only if it beats the list's k-th entry (the threshold
//     idea of _threshold_merge_impl; topk_merge.cuh).
//   * rows_pass1 (K2, K3, K4, "row tiles"): a 128-query x 128-row block
//     tile for every k <= 1024, 256 threads, each an 8 x 8 micro tile of
//     scores in registers; a batch that fits one 32- or 64-row query tile
//     takes a 32 x 128 or 64 x 128 tile (2 or 4 x 8 a thread), so that no
//     half of the FMAs is spent on padding rows. K4 is the same schedule over xt [D, N]. K3 runs
//     K2's schedule: the query tiles of a corpus split read each corpus
//     slice from L2 within microseconds of each other, which is what K3's
//     resident batch was for (a thread block cluster sharing each slice
//     ran about twice as slow on the H100: PERF.md).
//   * Pass 2 merges the per-split lists [B, S, k] in levels of G lists per
//     warp (merge path of two sorted lists), until one list per query is left.
//
// What bounds it on the H100:
//   * K1 (B <= 8 live rows per tile) reads the whole corpus once per call
//     and does 2*BT flops per corpus element: memory bound. 1M x 768 f32 is
//     3.07 GB, 0.92 ms at 3.35 TB/s.
//   * K2-K4 (B = 1024) do 2*B*N*D flops in true f32 FMA (no TF32, no
//     tensor cores): compute bound. 1.61 TFLOP at 1M x 768, about 24 ms at
//     67 TFLOP/s.
// What rows_pass1 does about it:
//   * The FMA pipe is fed from registers: each thread reads its 8 query rows
//     and 8 corpus rows as float4 along the depth from padded, bank-conflict
//     free [rows][DK + pad] tiles (K4: float4 along N of [DK][TN] tiles),
//     one 16-byte shared-memory load per 16 FMAs. __launch_bounds__(256, 2)
//     holds it to 128 registers, so two blocks share an SM.
//   * Operands reach shared memory through a ring of kStages slices filled
//     by 16-byte cp.async (zero-filled past B, N and D), with no round trip
//     through registers and one barrier per slice.
//   * The top-k lists do not take shared memory: each row has a threshold
//     (its list's k-th entry) and a 32-entry candidate buffer in shared
//     memory, which only scores beating the threshold enter. A full buffer
//     is sorted and merged by the row's half-warp into the row's sorted list,
//     kept in the [B, S, k] split scratch that pass 2 reads, and the
//     threshold rises. So the tile, and the FMAs per shared-memory read, are
//     the same at k = 30 and at k = 1024. The corpus splits of a query row
//     also share a lower bound of its global k-th score (share_bound), so
//     that after the first tiles few scores enter any buffer.
//   * No atomics: every list is built in a fixed order, so the output is
//     deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "topk_merge.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// ---------------------------------------------------------------------------
// K1: column warps
// ---------------------------------------------------------------------------

constexpr int kDK = 32;  // depth staged per step

// K1's layout: warps as WR row groups x (8 / WR) column groups, each thread
// a TM x TNN micro tile; K1 runs column warps: WR = 1, TNN = 1, a corpus
// tile of 256.
template <int WR, int TM, int TNN>
struct Layout {
  static constexpr int WC = kWarps / WR;
  static constexpr int BT = WR * TM;          // query rows per block
  static constexpr int TN = WC * 32 * TNN;    // corpus rows per tile
  static constexpr int QLD = BT + 4;          // qs row stride ([DK][QLD])
  static constexpr int XLD = TN + 1;          // xs row stride ([DK][XLD])
  static size_t smem(int k) {
    return sizeof(float) * ((size_t)kDK * QLD + (size_t)kDK * XLD +
                            (size_t)BT * TN) +
           (size_t)BT * k * (sizeof(float) + sizeof(int));
  }
};

__device__ __forceinline__ void unpack(const uint4& v, float* out, float) {
  out[0] = __uint_as_float(v.x);
  out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z);
  out[3] = __uint_as_float(v.w);
}

// K1 pass 1: block (query tile, split) -> top-k of the split's rows per
// query. x is [N, D] with D % (16 / sizeof(XT)) == 0 and 16-byte alignment.
// A step's query and corpus slices are loaded into registers one step
// ahead, while the block computes on the previous step's slices in shared
// memory.
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
  const int n_chunks = (D + kDK - 1) / kDK;
  float* qs = reinterpret_cast<float*>(smem);  // [DK][QLD]
  float* xs = qs + kDK * QLD;                  // [DK][XLD]
  float* ss = xs + kDK * XLD;                  // [BT][TN]
  float* ls = ss + BT * TN;                    // [BT][k]
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
    const float* qstep = qs;
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

// K1 with tm query rows per block, tm in {1, 2, 4, 8}
template <typename XT>
cudaError_t dispatch_col(int tm, const float* q, const void* x, const float* bias, int B, int N, int D,
                         int k, int rows_per_split, int splits, float* part_s, int* part_i,
                         cudaStream_t st) {
  switch (tm) {
#define CG_COL(TM) \
  launch_pass1<XT, 1, TM, 1>(q, x, bias, B, N, D, k, rows_per_split, splits, part_s, part_i, st)
    case 1: return CG_COL(1);
    case 2: return CG_COL(2);
    case 4: return CG_COL(4);
    case 8: return CG_COL(8);
#undef CG_COL
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// K2, K3, K4: row tiles
// ---------------------------------------------------------------------------

constexpr int kTN = 128;        // corpus rows per tile
constexpr int kRDK = 16;        // depth of one ring slice (a multiple of 8)
constexpr int kStages = 3;      // ring slices
constexpr int kQLD = kRDK + 4;  // query slice row stride ([QT][QLD] f32)

// Shared memory of rows_pass1 with QT query rows a block: the ring (query
// slice + corpus slice per stage), per-row threshold, buffer count, list
// length and shared bound, and the candidate buffers. ops/topk.py
// `row_smem` mirrors it.
template <typename XT, bool TRANS, int QT>
struct RowLayout {
  // [TN][DK + pad] along the depth (pad keeps 16 rows' float4 / 8-byte
  // reads conflict free), or [DK][TN] for xt
  static constexpr int XLD = TRANS ? kTN : kRDK + 4;
  static constexpr int XROWS = TRANS ? kRDK : kTN;
  static constexpr size_t kQBytes = (size_t)QT * kQLD * sizeof(float);
  static constexpr size_t kStageBytes = kQBytes + (size_t)XROWS * XLD * sizeof(XT);
  static constexpr size_t kSmem = kStages * kStageBytes + (size_t)QT * 5 * sizeof(int) +
                                  (size_t)QT * kCap * (sizeof(float) + sizeof(int));
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; bytes = 0 zero-fills
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// xf[d][jj] = corpus column tile_col(j0 + jj) at depth c + d, widened to f32
template <typename XT, bool TRANS, int XLD, int J>
__device__ __forceinline__ void load_xfrag(const XT* xs, int c, int tx, int j0, float (&xf)[4][J]) {
  if constexpr (!TRANS && sizeof(XT) == 4) {
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      const float4 v = *reinterpret_cast<const float4*>(xs + (tx + 16 * (j0 + jj)) * XLD + c);
      xf[0][jj] = v.x;
      xf[1][jj] = v.y;
      xf[2][jj] = v.z;
      xf[3][jj] = v.w;
    }
  } else {
    static_assert(TRANS, "bf16 rows along the depth run on the tensor cores (flat_topk_tc.cu)");
#pragma unroll
    for (int d = 0; d < 4; ++d)
#pragma unroll
      for (int h = 0; h < J / 4; ++h) {
        const XT* src = xs + (c + d) * XLD + tx * 4 + 64 * (j0 / 4 + h);
        if constexpr (sizeof(XT) == 4) {
          const float4 v = *reinterpret_cast<const float4*>(src);
          xf[d][4 * h] = v.x;
          xf[d][4 * h + 1] = v.y;
          xf[d][4 * h + 2] = v.z;
          xf[d][4 * h + 3] = v.w;
        } else {
          const uint2 u = *reinterpret_cast<const uint2*>(src);
          const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
          const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
          xf[d][4 * h] = a.x;
          xf[d][4 * h + 1] = a.y;
          xf[d][4 * h + 2] = b.x;
          xf[d][4 * h + 3] = b.y;
        }
      }
  }
}

// The corpus column (0..TN-1) of a thread's micro-tile column j
template <bool TRANS>
__device__ __forceinline__ int tile_col(int tx, int j) {
  return TRANS ? tx * 4 + 64 * (j >> 2) + (j & 3) : tx + 16 * j;
}

// Pass 1 of K2/K3/K4: block (query tile of QT rows, corpus split) -> the
// top-k of the split's rows for each query, in part_s/part_i [B, S, k].
// Thread (ty, tx) = (tid / 16, tid % 16) holds the scores of query rows
// ty + 16 i and corpus columns tile_col(tx, j), i < MI = QT / 16, j < 8, so
// the 16 lanes of a half-warp hold the whole tile row of their MI query
// rows, and own those rows' buffers and lists. q is [B, ldq] f32 (ldq % 4
// == 0, 16-byte aligned; columns D..ldq zero). x is [N, D] (D % 8 == 0,
// 16-byte aligned) or, TRANS, xt [D, N], read in 16-byte pieces when vec
// (N a multiple of 16 / sizeof(XT), 16-byte aligned), else an element a
// thread. bound [B, S] holds NEG_INF at launch (share_bound).
template <typename XT, bool TRANS, int QT>
__global__ void __launch_bounds__(kThreads, 2)
    rows_pass1(const float* __restrict__ q, int ldq, const XT* __restrict__ x,
               const float* __restrict__ bias, int B, int N, int D, int k, int rows_per_split,
               int vec, float* __restrict__ part_s, int* __restrict__ part_i,
               float* __restrict__ bound) {
  using L = RowLayout<XT, TRANS, QT>;
  constexpr int XLD = L::XLD;
  constexpr int MI = QT / 16;  // query rows a thread
  // corpus columns per register fragment: 4 (x [N, D]) or 8 (xt), the
  // faster of the two for each on the H100 (PERF.md)
  constexpr int kFragJ = TRANS ? 8 : 4;
  using Raw = typename std::conditional<sizeof(XT) == 4, unsigned, unsigned short>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  float* thr_s = reinterpret_cast<float*>(smem + kStages * L::kStageBytes);
  int* thr_i = reinterpret_cast<int*>(thr_s + QT);
  int* cnt = thr_i + QT;
  int* len = cnt + QT;  // live entries of the row's list
  float* bnd = reinterpret_cast<float*>(len + QT);
  float* buf_s = bnd + QT;  // [QT][Cap]
  int* buf_i = reinterpret_cast<int*>(buf_s + QT * kCap);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tx = tid & 15, ty = tid >> 4;
  const int half = lane >> 4, l16 = lane & 15;
  const unsigned hmask = 0xFFFFu << (16 * half);
  const int b0 = blockIdx.x * QT;
  const int split = blockIdx.y, S = gridDim.y;
  const int n_begin = split * rows_per_split;
  const int n_end = min(N, n_begin + rows_per_split);

#pragma unroll 1
  for (int i = 0; i < MI; ++i) {
    const int r = ty + 16 * i;
    if (l16 == 0) {
      thr_s[r] = kNegInf;
      thr_i[r] = -1;
      cnt[r] = 0;
      len[r] = 0;
      bnd[r] = kNegInf;
    }
    if (b0 + r < B) {
      const size_t base = ((size_t)(b0 + r) * S + split) * k;
      for (int p = l16; p < k; p += 16) {
        __stcg(part_s + base + p, kNegInf);
        __stcg(part_i + base + p, -1);
      }
    }
  }
  __syncwarp();

  // A slice of q (and of x [N, D]) is QT (kTN) rows x kRDK / 4 pieces of 4
  // elements; a thread takes pieces tid, tid + 256, ...
  constexpr int PPR = kRDK / 4;
  constexpr int QP = QT * PPR;  // query pieces of a slice
  constexpr int QPT = (QP + kThreads - 1) / kThreads;
  constexpr int XPT = kTN * PPR / kThreads;
  auto issue = [&](int slot, int n0, int d0) {
    float* qs = reinterpret_cast<float*>(smem + slot * L::kStageBytes);
    XT* xs = reinterpret_cast<XT*>(smem + slot * L::kStageBytes + L::kQBytes);
#pragma unroll
    for (int v = 0; v < QPT; ++v) {
      const int p = tid + v * kThreads, r = p / PPR, c = (p % PPR) * 4;
      if (QP % kThreads != 0 && p >= QP) break;
      const bool ok = b0 + r < B && d0 + c < ldq;
      cp_async16(qs + r * kQLD + c, ok ? q + (size_t)(b0 + r) * ldq + d0 + c : q, ok ? 16 : 0);
    }
    if constexpr (!TRANS) {
#pragma unroll
      for (int v = 0; v < XPT; ++v) {
        const int p = tid + v * kThreads, r = p / PPR, c = (p % PPR) * 4;
        const bool ok = n0 + r < n_end && d0 + c < D;
        cp_async16(xs + r * XLD + c, ok ? x + (size_t)(n0 + r) * D + d0 + c : x, ok ? 16 : 0);
      }
    } else if (vec) {
      constexpr int EPC = 16 / sizeof(XT);  // elements per piece
      constexpr int CPR = kTN / EPC;        // pieces per depth row
#pragma unroll
      for (int v = 0; v < (kRDK * CPR + kThreads - 1) / kThreads; ++v) {
        const int p = tid + v * kThreads, dr = p / CPR, c = (p % CPR) * EPC;
        if (p >= kRDK * CPR) break;
        const bool ok = d0 + dr < D && n0 + c < n_end;
        cp_async16(xs + dr * XLD + c, ok ? x + (size_t)(d0 + dr) * N + n0 + c : x, ok ? 16 : 0);
      }
    } else {
      const Raw* xr = reinterpret_cast<const Raw*>(x);
      Raw* xw = reinterpret_cast<Raw*>(xs);
#pragma unroll
      for (int v = 0; v < kRDK * kTN / kThreads; ++v) {
        const int p = tid + v * kThreads, dr = p / kTN, c = p % kTN;
        xw[dr * XLD + c] = (d0 + dr < D && n0 + c < n_end) ? xr[(size_t)(d0 + dr) * N + n0 + c] : Raw(0);
      }
    }
  };
  // the ring: slices are issued kStages - 1 ahead of the one computed
  int is_n0 = n_begin, is_d0 = 0, is_slot = 0;
  auto issue_next = [&]() {
    if (is_n0 < n_end) issue(is_slot, is_n0, is_d0);
    cp_commit();
    is_d0 += kRDK;
    if (is_d0 >= D) {
      is_d0 = 0;
      is_n0 += kTN;
    }
    is_slot = is_slot == kStages - 1 ? 0 : is_slot + 1;
  };
#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) issue_next();

  int slot = 0;
#pragma unroll 1
  for (int n0 = n_begin; n0 < n_end; n0 += kTN) {
    float acc[MI][8];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 1
    for (int d0 = 0; d0 < D; d0 += kRDK) {
      cp_wait<kStages - 2>();
      __syncthreads();
      issue_next();  // into the slot computed last step, now free
      const float* qs = reinterpret_cast<const float*>(smem + slot * L::kStageBytes);
      const XT* xs = reinterpret_cast<const XT*>(smem + slot * L::kStageBytes + L::kQBytes);
#pragma unroll
      for (int c = 0; c < kRDK; c += 4) {
#pragma unroll
        for (int j0 = 0; j0 < 8; j0 += kFragJ) {
          float xf[4][kFragJ];
          load_xfrag<XT, TRANS, XLD, kFragJ>(xs, c, tx, j0, xf);
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            const float4 qv = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * kQLD + c);
#pragma unroll
            for (int jj = 0; jj < kFragJ; ++jj) {
              float& a = acc[i][j0 + jj];
              a = fmaf(qv.x, xf[0][jj], a);
              a = fmaf(qv.y, xf[1][jj], a);
              a = fmaf(qv.z, xf[2][jj], a);
              a = fmaf(qv.w, xf[3][jj], a);
            }
          }
        }
      }
      slot = slot == kStages - 1 ? 0 : slot + 1;
    }

    // The tile's scores are complete: each half-warp offers its rows' scores
    // that beat the row's threshold and shared bound to the row's buffer,
    // in a fixed order. The scores go to a local array first, so that the
    // loops below (and their one flush site) are not unrolled.
    float sc[MI][8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tile_col<TRANS>(tx, j);
      const float bj = n < n_end ? bias[n] : 0.f;
#pragma unroll
      for (int i = 0; i < MI; ++i) sc[i][j] = acc[i][j] + bj;
    }
#pragma unroll 1
    for (int i = 0; i < MI; ++i) {
      const int r = ty + 16 * i;
      const bool live = b0 + r < B;
      const size_t base = ((size_t)(b0 + r) * S + split) * k;
      float ts = thr_s[r], lb = bnd[r];
      int ti = thr_i[r];
      int c = cnt[r];
#pragma unroll 1
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + tile_col<TRANS>(tx, j);
        const float s = sc[i][j];
        bool v = live && n < n_end && s >= lb && beats(s, n, ts, ti);
        unsigned hb = (__ballot_sync(kFull, v) >> (16 * half)) & 0xFFFFu;
        if (c + __popc(hb) > kCap) {  // the half-warp's row buffer is full
          flush_row(buf_s + r * kCap, buf_i + r * kCap, c, part_s + base, part_i + base, k,
                    len + r, thr_s + r, thr_i + r, hmask, l16);
          share_bound(part_s + base, k, bound + (size_t)(b0 + r) * S, split, S, bnd + r, hmask,
                      l16);
          ts = thr_s[r];
          ti = thr_i[r];
          lb = bnd[r];
          c = 0;
          v = v && s >= lb && beats(s, n, ts, ti);
          hb = (__ballot_sync(hmask, v) >> (16 * half)) & 0xFFFFu;
        }
        if (v) {
          const int pos = c + __popc(hb & ((1u << l16) - 1u));
          buf_s[r * kCap + pos] = s;
          buf_i[r * kCap + pos] = n;
        }
        c += __popc(hb);
      }
      if (l16 == 0) cnt[r] = c;
    }
  }

  __syncwarp();
#pragma unroll 1
  for (int i = 0; i < MI; ++i) {
    const int r = ty + 16 * i;
    const int c = cnt[r];
    if (b0 + r < B && c > 0) {
      const size_t base = ((size_t)(b0 + r) * S + split) * k;
      flush_row(buf_s + r * kCap, buf_i + r * kCap, c, part_s + base, part_i + base, k, len + r,
                thr_s + r, thr_i + r, hmask, l16);
    }
  }
}

template <typename XT, bool TRANS, int QT>
cudaError_t launch_rows(const float* q, int ldq, const void* x, const float* bias, int B, int N,
                        int D, int k, int rows_per_split, int splits, int grid_x, int vec,
                        long long smem, float* part_s, int* part_i, float* bound, cudaStream_t st) {
  using L = RowLayout<XT, TRANS, QT>;
  if (smem != (long long)L::kSmem || rows_per_split % kTN != 0 || (long long)grid_x * QT < B ||
      (long long)(grid_x - 1) * QT >= B || ldq % 4 != 0 || ldq < D) {
    return cudaErrorInvalidValue;
  }
  auto kern = rows_pass1<XT, TRANS, QT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(grid_x, splits), kThreads, (size_t)smem, st>>>(
      q, ldq, static_cast<const XT*>(x), bias, B, N, D, k, rows_per_split, vec, part_s, part_i,
      bound);
  return cudaGetLastError();
}

// layout 1: K2 over x [N, D]; 2: K3, which runs K2's schedule; 3: K4 over
// xt [D, N]; query tiles of query_tile (32, 64 or 128) rows. bf16 rows
// take only layout 3: K2 and K3 over bf16 rows run on the tensor cores
// (flat_topk_tc.cu).
template <typename XT>
cudaError_t dispatch_rows(int layout, int query_tile, const float* q, int ldq, const void* x,
                          const float* bias, int B, int N, int D, int k, int rows_per_split,
                          int splits, int grid_x, int vec, long long smem, float* part_s,
                          int* part_i, float* bound, cudaStream_t st) {
#define CG_ROWS(TRANS, QT)                                                                    \
  launch_rows<XT, TRANS, QT>(q, ldq, x, bias, B, N, D, k, rows_per_split, splits, grid_x, vec, \
                             smem, part_s, part_i, bound, st)
  if (layout == 3) {
    switch (query_tile) {
      case 32: return CG_ROWS(true, 32);
      case 64: return CG_ROWS(true, 64);
      case 128: return CG_ROWS(true, 128);
    }
  } else if constexpr (sizeof(XT) == 4) {
    if (layout == 1 || layout == 2) {
      switch (query_tile) {
        case 32: return CG_ROWS(false, 32);
        case 64: return CG_ROWS(false, 64);
        case 128: return CG_ROWS(false, 128);
      }
    }
  }
  return cudaErrorInvalidValue;
#undef CG_ROWS
}

template <typename XT, int QT>
long long rows_smem_t(bool trans) {
  return trans ? (long long)RowLayout<XT, true, QT>::kSmem
               : (long long)RowLayout<XT, false, QT>::kSmem;
}

long long rows_smem(int layout, int x_bf16, int query_tile) {
  const bool trans = layout == 3;
  if (layout < 1 || layout > 3 || (x_bf16 && !trans)) return 0;
  switch (query_tile) {
    case 32: return x_bf16 ? rows_smem_t<__nv_bfloat16, 32>(trans) : rows_smem_t<float, 32>(trans);
    case 64: return x_bf16 ? rows_smem_t<__nv_bfloat16, 64>(trans) : rows_smem_t<float, 64>(trans);
    case 128:
      return x_bf16 ? rows_smem_t<__nv_bfloat16, 128>(trans) : rows_smem_t<float, 128>(trans);
  }
  return 0;
}

}  // namespace

extern "C" {

// Shared memory (bytes) of the row-tile pass 1 for layout 1 (K2), 2 (K3)
// or 3 (K4), the corpus type and the query tile (32, 64 or 128); 0 for an
// unknown layout or tile, and for bf16 rows in layout 1 or 2.
long long flat_topk_rows_smem(int layout, int x_bf16, int query_tile) {
  return rows_smem(layout, x_bf16, query_tile);
}

// Scratch entries (per scores and per ids) that flat_topk needs.
long long flat_topk_work_entries(int B, int k, int splits, int group) {
  return merge_work_entries(B, k, splits, group);
}

// Inputs shared by both entries: q [B, ldq] f32, x [N, D] f32, or for
// layout 3 xt [D, N] f32 (x_bf16 = 0) or bf16 (x_bf16 = 1), bias [N] f32, all
// contiguous on the device of `stream`. Pass 1 runs over `splits` ranges
// of `rows_per_split` corpus rows (a multiple of the layout's corpus
// tile); work_s / work_i hold flat_topk_work_entries(B, k, splits, group)
// entries each; out_s [B, k] f32 and out_i [B, k] i32. Each returns the
// CUDA error code of its launches (0 = success).

// K1 over f32 rows: column warps with tm query rows per block; ldq == D,
// D % 8 == 0 and x 16-byte aligned.
int flat_topk(const float* q, const float* x, const float* bias, int B, int N, int D, int k, int tm,
              int splits, int rows_per_split, int group, float* out_s, int* out_i, float* work_s,
              int* work_i, void* stream) {
  if (B < 1 || N < 1 || D < 1 || k < 1 || k > 1024 || splits < 1 || group < 2 ||
      rows_per_split < 1 || (long long)splits * rows_per_split < N ||
      (long long)(splits - 1) * rows_per_split >= N || D % 8 != 0 ||
      (reinterpret_cast<size_t>(x) & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part_s = splits == 1 ? out_s : work_s;
  int* part_i = splits == 1 ? out_i : work_i;
  cudaError_t err =
      dispatch_col<float>(tm, q, x, bias, B, N, D, k, rows_per_split, splits, part_s, part_i, st);
  if (err != cudaSuccess) return (int)err;
  if (splits == 1) return 0;
  return (int)merge_splits(B, k, splits, group, out_s, out_i, work_s, work_i, st);
}

// K2/K3/K4: row tiles (layout 1, 2 or 3) over grid_x = ceil(B / query_tile)
// query tiles of query_tile (32, 64 or 128) rows; q is [B, ldq] (ldq % 4 == 0,
// 16-byte aligned, zero past D); for layouts 1 and 2, f32 rows, D % 8 == 0
// and x 16-byte aligned; for layout 3, vec = 1 reads xt in 16-byte pieces (N %
// (16 / element size) == 0, 16-byte aligned), else an element at a time.
// smem must equal flat_topk_rows_smem(layout, x_bf16, query_tile); bound
// holds B * splits f32 set to NEG_INF (-1e30).
int flat_topk_rows(const float* q, int ldq, const void* x, int x_bf16, const float* bias, int B, int N,
                   int D, int k, int layout, int splits, int rows_per_split, int grid_x,
                   int query_tile, int vec, long long smem, int group, float* out_s, int* out_i,
                   float* work_s, int* work_i, float* bound, void* stream) {
  const size_t elt = x_bf16 ? 2 : 4;
  const bool x_ok = layout == 3
                        ? !vec || ((size_t)N % (16 / elt) == 0 && (reinterpret_cast<size_t>(x) & 15) == 0)
                        : D % 8 == 0 && (reinterpret_cast<size_t>(x) & 15) == 0;
  if (B < 1 || N < 1 || D < 1 || k < 1 || k > 1024 || splits < 1 || group < 2 ||
      rows_per_split < 1 || (long long)splits * rows_per_split < N ||
      (long long)(splits - 1) * rows_per_split >= N || !x_ok ||
      (reinterpret_cast<size_t>(q) & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part_s = splits == 1 ? out_s : work_s;
  int* part_i = splits == 1 ? out_i : work_i;
  cudaError_t err =
      x_bf16 ? dispatch_rows<__nv_bfloat16>(layout, query_tile, q, ldq, x, bias, B, N, D, k,
                                            rows_per_split, splits, grid_x, vec, smem, part_s,
                                            part_i, bound, st)
             : dispatch_rows<float>(layout, query_tile, q, ldq, x, bias, B, N, D, k,
                                    rows_per_split, splits, grid_x, vec, smem, part_s, part_i,
                                    bound, st);
  if (err != cudaSuccess) return (int)err;
  if (splits == 1) return 0;
  return (int)merge_splits(B, k, splits, group, out_s, out_i, work_s, work_i, st);
}

}  // extern "C"

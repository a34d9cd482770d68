// Exact streaming top-k over a device-resident int8 corpus with per-row
// scales: score[b, n] = ((float)(qv[b] . xv[n]) * qs[b]) * xs[n] + bias[n],
// the dot product exact in int32, then the k best rows per query, sorted
// descending.
//
// Replaces the three Pallas kernels of codegraph_tpu/ops/quantize.py:
//   K5  streaming_topk_int8_pallas / _int8_topk_kernel         (batches < 32)
//   K6  streaming_topk_int8_qmajor / _int8_topk_qmajor_kernel  (batches >= 32)
//   K7  streaming_topk_int8_qres   / _int8_topk_qres_kernel    (query-resident)
// K5 is a __dp4a kernel with the column warps of flat_topk.cu (up to 8 query
// rows). K6 and K7 are one tensor-core kernel (mma.sync m16n8k32 s8) over
// query tiles of 16 to 128 rows; K7 keeps its block's query tile resident in
// shared memory for its whole corpus split (the TPU kernel pins the whole
// batch in VMEM; a block's 227 KB holds a tile of it).
//
// What bounds it on the H100:
//   * K5 (B <= 8 live rows per tile) reads the corpus once per call:
//     N*D + 8N bytes (rows, scales, bias), memory bound. 10M x 768 is
//     7.76 GB, 2.32 ms at 3.35 TB/s.
//   * K6 and K7 at B = 1024 do 2*B*N*D int8 operations: 15.7 TOP at
//     10M x 768, 7.9 ms at the data sheet's 1,979 TOP/s for int8 tensor
//     cores. mma.sync reaches part of that rate (wgmma, fed by TMA, is the
//     way to all of it), and the shared-memory reads that feed it and the
//     merge take their share.
// What the design does about it:
//   * The dot products are exact: int8 x int8 summed in int32 (|acc| <=
//     127^2 * D fits for D < 133,000), by __dp4a (K5) or the tensor cores
//     (K6, K7). D must be a multiple of 4; rows are read as 32-bit words, a
//     warp reading 128 contiguous bytes of a row (K6/K7: 16-byte pieces when
//     D % 16 == 0 and the rows are 16-byte aligned).
//   * The epilogue rounds as the reference does, one operation at a time
//     (__fmul_rn / __fadd_rn, so nvcc cannot contract them into an FMA that
//     rounds once): (float)acc * qs[b], then * xs[n], then + bias[n]. The
//     kernel and the plain PyTorch version agree bit for bit.
//   * Pass 1 splits the corpus rows across blocks, grid (query tiles,
//     splits). Each block walks its rows in corpus tiles, 32 words (128
//     int8) of depth per step, loading the next step into registers while
//     it computes on the current one in shared memory. K7 loads its query
//     tile once and stages only the corpus. K5 runs two blocks per SM (its
//     bytes in flight set its pace); K6/K7 one block with the largest query
//     tile that fits 227 KB (fewer corpus re-reads per query).
//   * Tensor cores: a step's 32 words of depth are 4 k-steps of m16n8k32.
//     The lane with threadID_in_group t takes words 8t .. 8t+7 of each row
//     it touches (words 8t+2j and 8t+2j+1 fill its two k slots in k-step
//     j), the same words for query and corpus rows, so the sum over all
//     k-steps and lanes is the whole dot product. Rows are row-major in
//     shared memory with a stride of 36 words, so those 8 words are two
//     conflict-free 16-byte loads.
//   * The scores of a complete tile go through a score tile in shared
//     memory to the merge of topk_merge.cuh (the one flat_topk.cu uses, with
//     the same order and sentinels): per-row sorted lists in shared memory
//     fed by a threshold ballot, then a merge of the splits in levels. A row
//     none of whose scores beats its list's k-th entry is not offered at
//     all, which after the first tiles is most rows.

#include <cuda_runtime.h>

#include <cstddef>

#include "topk_merge.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDKW = 32;          // depth staged per step, in words of 4 int8
constexpr int kRowLd = kDKW + 4;  // row stride (words) of a staged row-major tile

__device__ __forceinline__ float int8_score(int acc, float qscale, float xscale, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), qscale), xscale), b);
}

// Offer the flagged rows of a complete score tile ss [BT][ld] (corpus rows
// n0 .. n0 + TN) to their lists, one warp per query row, and clear the
// flags. Once a list has warmed up, most rows of a tile are not flagged.
template <int BT, int TN>
__device__ __forceinline__ void offer_tile(const float* ss, int ld, int* rflag, float* ls, int* li,
                                           int k, int B, int b0, int n0, int n_end, int warp,
                                           int lane) {
  for (int r = warp; r < BT; r += kWarps) {
    if (b0 + r >= B) break;
    if (!rflag[r]) continue;  // warp-uniform
    float* lsr = ls + r * k;
    int* lir = li + r * k;
    float ts = lsr[k - 1];
    int ti = lir[k - 1];
    for (int col = lane; col < TN; col += 32) {
      warp_offer(ss[r * ld + col], n0 + col, n0 + col < n_end, lsr, lir, k, ts, ti, lane);
    }
    __syncwarp();
    if (lane == 0) rflag[r] = 0;
  }
}

// Write a block's lists to its split's slot of part [B, S, k].
template <int BT>
__device__ __forceinline__ void write_lists(const float* ls, const int* li, int k, int B, int b0,
                                            int split, float* part_s, int* part_i, int warp,
                                            int lane) {
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

// ---------------------------------------------------------------------------
// K5: __dp4a, column warps (as K1 in flat_topk.cu). The 8 warps share the
// TM <= 8 query rows and split a 256-row corpus tile; each thread keeps TM
// int32 sums of one corpus row.
// ---------------------------------------------------------------------------

template <int TM>
struct Dp4aLayout {
  static constexpr int TN = kThreads;  // corpus rows per tile
  static constexpr int QLD = TM + 4;   // qs row stride ([DKW][QLD] words)
  static constexpr int XLD = TN + 1;   // xs row stride ([DKW][XLD] words)
  static size_t smem(int k) {
    return sizeof(int) * ((size_t)kDKW * (QLD + XLD) + (size_t)TM * TN + TM) +
           (size_t)TM * k * (sizeof(float) + sizeof(int));
  }
};

// qw [B, D/4] and xw [N, D/4] are the int8 rows read as words. At most 128
// registers, so that two blocks share an SM: K5 is memory bound, and one
// block per SM (the compiler's choice without the bound, ~165 registers)
// keeps too few bytes in flight (PERF.md, design 3).
template <int TM>
__global__ void __launch_bounds__(kThreads, 2)
    int8_dp4a_pass1(const int* __restrict__ qw, const float* __restrict__ qsc,
                    const int* __restrict__ xw, const float* __restrict__ xsc,
                    const float* __restrict__ bias, int B, int N, int D, int k, int rows_per_split,
                    int /*vec: word loads only*/, float* __restrict__ part_s,
                    int* __restrict__ part_i) {
  using L = Dp4aLayout<TM>;
  constexpr int TN = L::TN, QLD = L::QLD, XLD = L::XLD;
  constexpr int XW = TN * kDKW / kThreads;                     // corpus words per thread
  constexpr int QW = (TM * kDKW + kThreads - 1) / kThreads;    // query words per thread
  extern __shared__ __align__(16) unsigned char smem[];
  const int D4 = D / 4;
  const int n_chunks = (D4 + kDKW - 1) / kDKW;
  int* qs = reinterpret_cast<int*>(smem);                 // [DKW][QLD]
  int* xs = qs + kDKW * QLD;                              // [DKW][XLD]
  float* ss = reinterpret_cast<float*>(xs + kDKW * XLD);  // [TM][TN]
  float* ls = ss + TM * TN;                               // [TM][k]
  int* li = reinterpret_cast<int*>(ls + TM * k);
  int* rflag = li + TM * k;                               // [TM]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b0 = blockIdx.x * TM;
  const int split = blockIdx.y;
  const int n_begin = split * rows_per_split;
  const int n_end = min(N, n_begin + rows_per_split);
  const int steps = (n_end - n_begin + TN - 1) / TN * n_chunks;

  for (int p = tid; p < TM * k; p += kThreads) {
    ls[p] = kNegInf;
    li[p] = -1;
  }
  if (tid < TM) rflag[tid] = 0;

  int xr[XW];
  int qr[QW];
  auto load = [&](int step) {
    const int n0 = n_begin + (step / n_chunks) * TN;
    const int d0 = (step % n_chunks) * kDKW;
#pragma unroll
    for (int w = 0; w < XW; ++w) {
      const int wi = tid + w * kThreads, r = wi / kDKW, d = d0 + wi % kDKW;
      xr[w] = (n0 + r < n_end && d < D4) ? xw[(size_t)(n0 + r) * D4 + d] : 0;
    }
#pragma unroll
    for (int e = 0; e < QW; ++e) {
      const int p = tid + e * kThreads, r = p / kDKW, d = d0 + p % kDKW;
      qr[e] = (p < TM * kDKW && b0 + r < B && d < D4) ? qw[(size_t)(b0 + r) * D4 + d] : 0;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int w = 0; w < XW; ++w) {
      const int wi = tid + w * kThreads;
      xs[(wi % kDKW) * XLD + wi / kDKW] = xr[w];
    }
#pragma unroll
    for (int e = 0; e < QW; ++e) {
      const int p = tid + e * kThreads;
      if (p < TM * kDKW) qs[(p % kDKW) * QLD + p / kDKW] = qr[e];
    }
  };

  int acc[TM];
  if (steps > 0) load(0);
  for (int step = 0; step < steps; ++step) {
    const int chunk = step % n_chunks;
    if (chunk == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i) acc[i] = 0;
    }
    store();
    __syncthreads();
    if (step + 1 < steps) load(step + 1);  // in flight during the dot products below
#pragma unroll 4
    for (int c = 0; c < kDKW; ++c) {
      int qv[TM];
      const int* qrow = qs + c * QLD;
      if constexpr (TM % 4 == 0) {
#pragma unroll
        for (int i = 0; i < TM; i += 4) {
          const int4 v = *reinterpret_cast<const int4*>(qrow + i);
          qv[i] = v.x;
          qv[i + 1] = v.y;
          qv[i + 2] = v.z;
          qv[i + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) qv[i] = qrow[i];
      }
      const int xv = xs[c * XLD + tid];
#pragma unroll
      for (int i = 0; i < TM; ++i) acc[i] = __dp4a(qv[i], xv, acc[i]);
    }
    __syncthreads();
    if (chunk != n_chunks - 1) continue;

    // The tile's sums are complete: scale them into ss, then offer the rows.
    const int n0 = n_begin + (step / n_chunks) * TN;
    const bool ok = n0 + tid < n_end;
    const float xc = ok ? xsc[n0 + tid] : 0.f;
    const float bc = ok ? bias[n0 + tid] : 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float qi = b0 + i < B ? qsc[b0 + i] : 0.f;
      const float sc = int8_score(acc[i], qi, xc, bc);
      ss[i * TN + tid] = sc;
      // flag the row if this score would enter its list as it stood before the tile
      if (ok && b0 + i < B && beats(sc, n0 + tid, ls[i * k + k - 1], li[i * k + k - 1])) rflag[i] = 1;
    }
    __syncthreads();
    offer_tile<TM, TN>(ss, TN, rflag, ls, li, k, B, b0, n0, n_end, warp, lane);
    // the next write of ss comes after at least one more __syncthreads
  }
  __syncthreads();  // lists were written by their owner warps
  write_lists<TM>(ls, li, k, B, b0, split, part_s, part_i, warp, lane);
}

// ---------------------------------------------------------------------------
// K6, K7: tensor cores. The block's BT = WM * MT * 16 query rows x 128 corpus
// rows; the 8 warps as WM (query rows) x 8/WM (corpus rows), each warp MT
// m-tiles of 16 rows x NT n-tiles of 8 corpus rows. RES keeps the query
// tile resident ([BT][Dpad + 4] words instead of one [BT][36] step).
// ---------------------------------------------------------------------------

template <int WM, int MT, bool RES>
struct MmaLayout {
  static constexpr int WN = kWarps / WM;
  static constexpr int BT = WM * MT * 16;  // query rows per block
  static constexpr int TN = 128;           // corpus rows per tile
  static constexpr int NT = TN / 8 / WN;   // n-tiles per warp
  static constexpr int SSLD = TN + 8;      // ss row stride (floats)
  static size_t q_ld(int D) { return RES ? (size_t)(D / 4 + kDKW - 1) / kDKW * kDKW + 4 : kRowLd; }
  static size_t smem(int k, int D) {
    return sizeof(int) * ((size_t)BT * q_ld(D) + (size_t)TN * kRowLd + (size_t)BT * SSLD + BT) +
           (size_t)BT * k * (sizeof(float) + sizeof(int));
  }
};

// c += a (16x32 s8, row) * b (32x8 s8, col), int32
__device__ __forceinline__ void mma_s8(int* c, int a0, int a1, int a2, int a3, int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int WM, int MT, bool RES>
__global__ void __launch_bounds__(kThreads)
    int8_mma_pass1(const int* __restrict__ qw, const float* __restrict__ qsc,
                   const int* __restrict__ xw, const float* __restrict__ xsc,
                   const float* __restrict__ bias, int B, int N, int D, int k, int rows_per_split,
                   int vec, float* __restrict__ part_s, int* __restrict__ part_i) {
  using L = MmaLayout<WM, MT, RES>;
  constexpr int BT = L::BT, TN = L::TN, NT = L::NT, WN = L::WN, SSLD = L::SSLD;
  constexpr int XW = TN * kDKW / kThreads;  // corpus words per thread
  constexpr int QW = BT * kDKW / kThreads;  // query words per thread (not RES)
  constexpr int QP = BT * kDKW / 4;         // 16-byte pieces of a query step
  constexpr int QR = RES ? 1 : (QW > 4 ? QW : 4);
  extern __shared__ __align__(16) unsigned char smem[];
  const int D4 = D / 4;
  const int n_chunks = (D4 + kDKW - 1) / kDKW;
  const int q_depth = RES ? n_chunks * kDKW : kDKW;
  const int QLD = RES ? q_depth + 4 : kRowLd;
  int* qs = reinterpret_cast<int*>(smem);                    // [BT][QLD]
  int* xs = qs + BT * QLD;                                   // [TN][kRowLd]
  float* ss = reinterpret_cast<float*>(xs + TN * kRowLd);    // [BT][SSLD]
  float* ls = ss + BT * SSLD;                                // [BT][k]
  int* li = reinterpret_cast<int*>(ls + BT * k);
  int* rflag = li + BT * k;                                  // [BT]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // groupID, threadID_in_group
  const int row0 = (warp / WN) * MT * 16;  // the warp's first query row
  const int col0 = (warp % WN) * NT * 8;   // the warp's first corpus row
  const int b0 = blockIdx.x * BT;
  const int split = blockIdx.y;
  const int n_begin = split * rows_per_split;
  const int n_end = min(N, n_begin + rows_per_split);
  const int steps = (n_end - n_begin + TN - 1) / TN * n_chunks;

  for (int p = tid; p < BT * k; p += kThreads) {
    ls[p] = kNegInf;
    li[p] = -1;
  }
  if (tid < BT) rflag[tid] = 0;
  if constexpr (RES) {  // the query tile, once; zero past D and B
    for (int p = tid; p < BT * q_depth; p += kThreads) {
      const int r = p / q_depth, d = p % q_depth;
      qs[r * QLD + d] = (b0 + r < B && d < D4) ? qw[(size_t)(b0 + r) * D4 + d] : 0;
    }
  }

  // Staging: 32-bit words, or 16-byte pieces of 4 words when `vec` (D % 16
  // == 0 and 16-byte aligned rows); a piece lies wholly inside or outside D.
  int xr[XW];
  int qr[QR];
  auto load = [&](int step) {
    const int n0 = n_begin + (step / n_chunks) * TN;
    const int d0 = (step % n_chunks) * kDKW;
    if (vec) {
#pragma unroll
      for (int v = 0; v < XW / 4; ++v) {
        const int pi = tid + v * kThreads, r = pi / (kDKW / 4), d = d0 + pi % (kDKW / 4) * 4;
        *reinterpret_cast<int4*>(&xr[4 * v]) =
            (n0 + r < n_end && d < D4) ? *reinterpret_cast<const int4*>(xw + (size_t)(n0 + r) * D4 + d)
                                       : make_int4(0, 0, 0, 0);
      }
      if constexpr (!RES) {
#pragma unroll
        for (int e = 0; e < QR / 4; ++e) {
          const int pi = tid + e * kThreads, r = pi / (kDKW / 4), d = d0 + pi % (kDKW / 4) * 4;
          *reinterpret_cast<int4*>(&qr[4 * e]) =
              (pi < QP && b0 + r < B && d < D4)
                  ? *reinterpret_cast<const int4*>(qw + (size_t)(b0 + r) * D4 + d)
                  : make_int4(0, 0, 0, 0);
        }
      }
      return;
    }
#pragma unroll
    for (int w = 0; w < XW; ++w) {
      const int wi = tid + w * kThreads, r = wi / kDKW, d = d0 + wi % kDKW;
      xr[w] = (n0 + r < n_end && d < D4) ? xw[(size_t)(n0 + r) * D4 + d] : 0;
    }
    if constexpr (!RES) {
#pragma unroll
      for (int e = 0; e < QW; ++e) {
        const int p = tid + e * kThreads, r = p / kDKW, d = d0 + p % kDKW;
        qr[e] = (b0 + r < B && d < D4) ? qw[(size_t)(b0 + r) * D4 + d] : 0;
      }
    }
  };
  auto store = [&]() {
    if (vec) {
#pragma unroll
      for (int v = 0; v < XW / 4; ++v) {
        const int pi = tid + v * kThreads;
        *reinterpret_cast<int4*>(&xs[(pi / (kDKW / 4)) * kRowLd + pi % (kDKW / 4) * 4]) =
            *reinterpret_cast<const int4*>(&xr[4 * v]);
      }
      if constexpr (!RES) {
#pragma unroll
        for (int e = 0; e < QR / 4; ++e) {
          const int pi = tid + e * kThreads;
          if (pi < QP) {
            *reinterpret_cast<int4*>(&qs[(pi / (kDKW / 4)) * kRowLd + pi % (kDKW / 4) * 4]) =
                *reinterpret_cast<const int4*>(&qr[4 * e]);
          }
        }
      }
      return;
    }
#pragma unroll
    for (int w = 0; w < XW; ++w) {
      const int wi = tid + w * kThreads;
      xs[(wi / kDKW) * kRowLd + wi % kDKW] = xr[w];
    }
    if constexpr (!RES) {
#pragma unroll
      for (int e = 0; e < QW; ++e) {
        const int p = tid + e * kThreads;
        qs[(p / kDKW) * kRowLd + p % kDKW] = qr[e];
      }
    }
  };

  int acc[MT][NT][4];
  if (steps > 0) load(0);
  for (int step = 0; step < steps; ++step) {
    const int chunk = step % n_chunks;
    if (chunk == 0) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
    }
    store();
    __syncthreads();
    if (step + 1 < steps) load(step + 1);  // in flight during the products below

    // this lane's 8 words of each of its query rows (g and g + 8 of each
    // m-tile) and, per n-tile, of its corpus row g
    int qa[MT][2][8];
    const int* qstep = qs + (RES ? chunk * kDKW : 0) + t * 8;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int* p = qstep + (row0 + i * 16 + h * 8 + g) * QLD;
        *reinterpret_cast<int4*>(&qa[i][h][0]) = *reinterpret_cast<const int4*>(p);
        *reinterpret_cast<int4*>(&qa[i][h][4]) = *reinterpret_cast<const int4*>(p + 4);
      }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      int xb[8];
      const int* p = xs + (col0 + j * 8 + g) * kRowLd + t * 8;
      *reinterpret_cast<int4*>(&xb[0]) = *reinterpret_cast<const int4*>(p);
      *reinterpret_cast<int4*>(&xb[4]) = *reinterpret_cast<const int4*>(p + 4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < MT; ++i)
          mma_s8(acc[i][j], qa[i][0][2 * kk], qa[i][1][2 * kk], qa[i][0][2 * kk + 1],
                 qa[i][1][2 * kk + 1], xb[2 * kk], xb[2 * kk + 1]);
    }
    __syncthreads();
    if (chunk != n_chunks - 1) continue;

    // The tile's sums are complete: scale them into ss, then offer the rows.
    // acc[i][j] holds rows (g, g + 8) x corpus rows (2t, 2t + 1) of its tile.
    const int n0 = n_begin + (step / n_chunks) * TN;
    float xj[NT][2], bj[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + col0 + j * 8 + 2 * t + e;
        xj[j][e] = n < n_end ? xsc[n] : 0.f;
        bj[j][e] = n < n_end ? bias[n] : 0.f;
      }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + i * 16 + h * 8 + g;
        const bool live_row = b0 + r < B;
        const float qi = live_row ? qsc[b0 + r] : 0.f;
        const float ts = ls[r * k + k - 1];  // the row's k-th entry before this tile
        const int ti = li[r * k + k - 1];
        bool cand = false;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = col0 + j * 8 + 2 * t;
          const float s0 = int8_score(acc[i][j][2 * h], qi, xj[j][0], bj[j][0]);
          const float s1 = int8_score(acc[i][j][2 * h + 1], qi, xj[j][1], bj[j][1]);
          *reinterpret_cast<float2*>(ss + r * SSLD + c) = make_float2(s0, s1);
          cand |= (n0 + c < n_end && beats(s0, n0 + c, ts, ti)) ||
                  (n0 + c + 1 < n_end && beats(s1, n0 + c + 1, ts, ti));
        }
        if (cand && live_row) rflag[r] = 1;
      }
    __syncthreads();
    offer_tile<BT, TN>(ss, SSLD, rflag, ls, li, k, B, b0, n0, n_end, warp, lane);
    // the next write of ss and rflag comes after at least one more __syncthreads
  }
  __syncthreads();  // lists were written by their owner warps
  write_lists<BT>(ls, li, k, B, b0, split, part_s, part_i, warp, lane);
}

// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, int bt, const int* qw, const float* qsc,
                   const int* xw, const float* xsc, const float* bias, int B, int N, int D, int k,
                   int rows_per_split, int splits, int vec, float* part_s, int* part_i,
                   cudaStream_t st) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + bt - 1) / bt, splits);
  kernel<<<grid, kThreads, smem, st>>>(qw, qsc, xw, xsc, bias, B, N, D, k, rows_per_split, vec,
                                       part_s, part_i);
  return cudaGetLastError();
}

// layout 0: __dp4a column warps (K5), tm (query rows) in {1, 2, 4, 8}, corpus tile 256;
// layout 1: tensor cores (K6), tm in {2, 4, 8, 16} = query tile / 8, corpus tile 128;
// layout 2: tensor cores with the query tile resident (K7), tm as layout 1.
// smem_only: return the shared memory the launch needs (bytes) in *smem and
// launch nothing. vec: stage 16-byte pieces (layouts 1 and 2; needs D % 16
// == 0 and 16-byte aligned qw, xw).
cudaError_t dispatch(int layout, int tm, bool smem_only, size_t* smem, const int* qw,
                     const float* qsc, const int* xw, const float* xsc, const float* bias, int B,
                     int N, int D, int k, int rows_per_split, int splits, int vec, float* part_s,
                     int* part_i, cudaStream_t st) {
#define CG_DP4A(TM)                                                                          \
  {                                                                                          \
    *smem = Dp4aLayout<TM>::smem(k);                                                         \
    if (smem_only) return cudaSuccess;                                                       \
    if (rows_per_split % Dp4aLayout<TM>::TN != 0) return cudaErrorInvalidValue;              \
    return launch(int8_dp4a_pass1<TM>, *smem, TM, qw, qsc, xw, xsc, bias, B, N, D, k,        \
                  rows_per_split, splits, vec, part_s, part_i, st);                          \
  }
#define CG_MMA(WM, MT, RES)                                                                  \
  {                                                                                          \
    using L = MmaLayout<WM, MT, RES>;                                                        \
    *smem = L::smem(k, D);                                                                   \
    if (smem_only) return cudaSuccess;                                                       \
    if (rows_per_split % L::TN != 0) return cudaErrorInvalidValue;                           \
    return launch(int8_mma_pass1<WM, MT, RES>, *smem, L::BT, qw, qsc, xw, xsc, bias, B, N, D, \
                  k, rows_per_split, splits, vec, part_s, part_i, st);                       \
  }
  if (layout == 0) {
    switch (tm) {
      case 1: CG_DP4A(1)
      case 2: CG_DP4A(2)
      case 4: CG_DP4A(4)
      case 8: CG_DP4A(8)
    }
  } else if (layout == 1) {
    switch (tm) {
      case 2: CG_MMA(1, 1, false)
      case 4: CG_MMA(1, 2, false)
      case 8: CG_MMA(2, 2, false)
      case 16: CG_MMA(4, 2, false)
    }
  } else if (layout == 2) {
    switch (tm) {
      case 2: CG_MMA(1, 1, true)
      case 4: CG_MMA(1, 2, true)
      case 8: CG_MMA(2, 2, true)
      case 16: CG_MMA(4, 2, true)
    }
  }
#undef CG_DP4A
#undef CG_MMA
  *smem = 0;
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared memory (bytes) that pass 1 needs for a layout (0 __dp4a column
// warps, 1 tensor cores, 2 tensor cores with the query tile resident),
// tm, k and depth D; 0 for an unknown layout or tm.
long long int8_topk_pass1_smem(int layout, int tm, int k, int D) {
  size_t smem = 0;
  dispatch(layout, tm, true, &smem, nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0, D, k, 0,
           0, 0, nullptr, nullptr, nullptr);
  return (long long)smem;
}

// Scratch entries (per scores and per ids) that int8_topk needs.
long long int8_topk_work_entries(int B, int k, int splits, int group) {
  return merge_work_entries(B, k, splits, group);
}

// qv [B, D] int8, qs [B] f32, xv [N, D] int8, xs [N] f32, bias [N] f32, all
// contiguous on the device of `stream`, qv and xv 4-byte aligned with
// D % 4 == 0. Writes out_s [B, k] f32 and out_i [B, k] i32. Pass 1 runs
// `layout` with tile size `tm` over `splits` ranges of `rows_per_split`
// corpus rows (a multiple of the layout's corpus tile); vec = 1 stages
// 16-byte pieces (D % 16 == 0, qv and xv 16-byte aligned); work_s / work_i
// hold int8_topk_work_entries(B, k, splits, group) entries each. Returns
// the CUDA error code of the launches (0 = success).
int int8_topk(const void* qv, const float* qs, const void* xv, const float* xs, const float* bias,
              int B, int N, int D, int k, int layout, int tm, int vec, int splits,
              int rows_per_split, int group, float* out_s, int* out_i, float* work_s, int* work_i,
              void* stream) {
  const size_t align = vec ? 15 : 3;
  if (B < 1 || N < 1 || D < 4 || D % (vec ? 16 : 4) != 0 || k < 1 || k > 1024 || splits < 1 ||
      group < 2 || rows_per_split < 1 || (long long)splits * rows_per_split < N ||
      (long long)(splits - 1) * rows_per_split >= N || (reinterpret_cast<size_t>(qv) & align) != 0 ||
      (reinterpret_cast<size_t>(xv) & align) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part_s = splits == 1 ? out_s : work_s;
  int* part_i = splits == 1 ? out_i : work_i;
  size_t smem = 0;
  cudaError_t err = dispatch(layout, tm, false, &smem, static_cast<const int*>(qv), qs,
                             static_cast<const int*>(xv), xs, bias, B, N, D, k, rows_per_split,
                             splits, vec, part_s, part_i, st);
  if (err != cudaSuccess) return (int)err;
  if (splits == 1) return 0;
  return (int)merge_splits(B, k, splits, group, out_s, out_i, work_s, work_i, st);
}

}  // extern "C"

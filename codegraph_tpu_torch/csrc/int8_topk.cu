// Exact streaming top-k over a device-resident int8 corpus with per-row
// scales: score[b, n] = ((float)(qv[b] . xv[n]) * qs[b]) * xs[n] + bias[n],
// the dot product exact in int32, then the k best rows per query, sorted
// descending (a tie goes to the lower row id; (NEG_INF, -1) for rows past
// the live count).
//
// Replaces the three Pallas kernels of codegraph_tpu/ops/quantize.py:
//   K5  streaming_topk_int8_pallas / _int8_topk_kernel         (batches < 32)
//   K6  streaming_topk_int8_qmajor / _int8_topk_qmajor_kernel  (batches >= 32)
//   K7  streaming_topk_int8_qres   / _int8_topk_qres_kernel    (query-resident)
// The JAX kernels take any width D (their blocks span the whole row); so
// do these. Two pass-1 kernels, each in two instances, one pass 2
// (topk_merge.cuh):
//   * int8_dp4a_pass1 (K5): __dp4a with the column warps of flat_topk.cu,
//     up to 8 query rows a block, lists in shared memory. Rows are read as
//     4-byte words; int8_dp4a_ragged_pass1 ("K5r") is the same kernel for
//     rows that are not 4-byte aligned (D % 4 != 0, or a base one byte in):
//     it stages the aligned words that hold each row, one load a word and
//     one more a row and step, and realigns them as it reads them back
//     (one funnel shift a word; the queries' zero columns past D cancel
//     the bytes beyond the row).
//   * int8_tc_pass1 (K6 and K7, one schedule): wgmma s8 on the tensor
//     cores, operands brought by TMA, lists in device memory. K7's idea, a
//     query tile resident for a whole corpus split, is this kernel's
//     design, so K7 runs it too. int8_tc_ragged_pass1 ("K6r") is the same
//     kernel for the corpora TMA cannot read (D % 16 != 0, or rows, scales
//     or bias not 16-byte aligned): the corpus boxes and the tiles' scales
//     and bias come from the ragged-row producer of hopper_tc.cuh, which
//     lays each stage out as TMA would; the queries, padded by the wrapper
//     to a multiple of 16 bytes, still come by TMA.
//
// What bounds them on the H100:
//   * K5 reads the corpus once per call: N*D + 8N bytes (rows, scales,
//     bias), memory bound. 10M x 768 is 7.76 GB, 2.32 ms at 3.35 TB/s.
//   * K6/K7 do 2*B*N*D int8 operations: 15.7 TOP at 10M x 768, B = 1024,
//     7.9 ms at the data sheet's 1,979 TOP/s for int8 tensor cores; at
//     B <= 256 the corpus bytes (2.32 ms) bound them. Beside the products,
//     each of the B*N scores costs ~6 FP32-pipe instructions in the
//     epilogue, and each score that may enter a top-k list costs an offer
//     and, every 32 of a row, a merge into the list in device memory.
// What int8_tc_pass1 does about it:
//   * wgmma.mma_async m64n128k32 s32.s8.s8 reads both operands from shared
//     memory (K-major, 128-byte swizzle: qv [B, D] and xv [N, D] are already
//     K-major) and keeps the int32 sums in registers.
//   * One producer warp keeps a ring of corpus boxes (128 rows x 128 bytes
//     of depth, up to 6 stages) in flight by TMA (cp.async.bulk.tensor,
//     zero-filled past N and D) behind mbarrier full/empty pairs, and the
//     tiles' scales and bias in a ring of their own; no block-wide barrier
//     after set-up. The block's query tile (128 rows x D bytes, 96 KB at D
//     = 768) is loaded once by TMA and stays resident, so only the corpus
//     streams; where it does not fit (D above 1,152), it streams with it.
//     K6r fills the same ring with the producer warp's own copies
//     (hopper_tc.cuh's ragged-row producer), so that a width TMA cannot
//     read still runs on the tensor cores: its cost is the producer's
//     instructions (at most 4,096 four-byte copies a 16 KB stage), not the
//     consumers'.
//   * Two consumer warpgroups take the two 64-row halves of the query tile
//     against each stage (a batch of <= 64: one warpgroup, a 64-row tile).
//     Each waits on the full barriers on its own and releases a stage
//     after its last wgmma on it, so one's epilogue overlaps the other's
//     products, as far as the ring lets them drift apart.
//   * The accumulator is mma.sync's fragment repeated: a thread holds query
//     rows g and g + 8 of its warp's 16, corpus rows 8j + 2t, +1. The
//     epilogue scores them as the reference rounds, one operation at a time
//     (__fmul_rn / __fadd_rn, no FMA contraction): (float)acc * qs[b], then
//     * xs[n], then + bias[n], bit for bit the plain PyTorch version. A
//     compare against the row's threshold (its list's k-th entry and the
//     splits' shared bound) and one warp vote skip the offer for most tiles.
//   * The top-k lists live in the [B, S, k] split scratch. A score that may
//     enter goes to the row's candidate buffer in device memory, which
//     holds a whole tile beyond kCap entries, so the offer needs no capacity
//     check; after the tile, a row past kCap entries is merged into its list
//     out of line (topk_merge.cuh flush_row), which raises its threshold,
//     and the corpus splits of a row share a lower bound of its k-th score
//     (share_bound), as in K2. Shared memory is the same for every k.
//   * Grid (query tiles, corpus splits), query tiles fastest, at most one
//     block per SM: the query tiles of a split read its corpus from L2
//     within microseconds of each other, and every split of a row runs at
//     once, so the shared bound holds from the first tiles.

#include "hopper_tc.cuh"

namespace {

constexpr int kThreads = 256;  // K5
constexpr int kWarps = kThreads / 32;
constexpr int kDKW = 32;          // depth staged per step, in words of 4 int8

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

template <int TM, bool RAGGED = false>
struct Dp4aLayout {
  static constexpr int TN = kThreads;  // corpus rows per tile
  static constexpr int QLD = TM + 4;   // qs row stride ([DKW][QLD] words)
  static constexpr int XLD = TN + 1;   // xs row stride ([XROWS][XLD] words)
  static constexpr int XROWS = kDKW + (RAGGED ? 1 : 0);  // K5r: a row's 33rd aligned word too
  static size_t smem(int k) {
    return sizeof(int) * ((size_t)kDKW * QLD + (size_t)XROWS * XLD + (size_t)TM * TN + TM) +
           (size_t)TM * k * (sizeof(float) + sizeof(int));
  }
};

// qw [B, D4] and xw [N, D4] are the int8 rows read as words (D4 = D / 4;
// RAGGED: D4 = ceil(D / 4), qw padded with zeros to D4 words, and xw the
// rows' bytes, D a row, at any byte address). At most 128 registers, so
// that two blocks share an SM: K5 is memory bound, and one block per SM
// (the compiler's choice without the bound, ~165 registers) keeps too few
// bytes in flight (PERF.md, design 3).
//
// RAGGED reads a step's 32 words of a row as the 33 aligned words that
// hold them: warp w's lane l loads aligned word l of rows w + 8v (v < 32)
// through one pointer stepped 8 rows a load, and each thread loads word 32
// of the row it scores, into a 33rd row of xs; the dot products read word
// c as bytes lead .. lead + 3 of aligned words c and c + 1 (a funnel
// shift). A row's lead, its base & 3, is the same at every step (a tile
// starts at a multiple of 256 rows, a step 128 bytes on), so it is
// computed once. A word that holds no byte of its row is not read (zero);
// the bytes of the next row that the last word of a row takes in meet the
// queries' zero columns past D, so the sums are exact.
template <int TM, bool RAGGED>
__device__ __forceinline__ void int8_dp4a_body(const int* __restrict__ qw,
                                               const float* __restrict__ qsc,
                                               const int* __restrict__ xw,
                                               const float* __restrict__ xsc,
                                               const float* __restrict__ bias, int B, int N, int D,
                                               int k, int rows_per_split,
                                               float* __restrict__ part_s,
                                               int* __restrict__ part_i) {
  using L = Dp4aLayout<TM, RAGGED>;
  constexpr int TN = L::TN, QLD = L::QLD, XLD = L::XLD;
  constexpr int XW = TN * kDKW / kThreads;                     // corpus words per thread
  constexpr int QW = (TM * kDKW + kThreads - 1) / kThreads;    // query words per thread
  extern __shared__ __align__(16) unsigned char smem[];
  const int D4 = RAGGED ? (D + 3) / 4 : D / 4;
  const int n_chunks = (D4 + kDKW - 1) / kDKW;
  int* qs = reinterpret_cast<int*>(smem);                 // [DKW][QLD]
  int* xs = qs + kDKW * QLD;                              // [XROWS][XLD]
  float* ss = reinterpret_cast<float*>(xs + L::XROWS * XLD);  // [TM][TN]
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
  // RAGGED: the lead of the rows this warp loads and of the row this thread
  // scores, and that row's aligned word 32 of a step (loaded and stored with it)
  const size_t xa = reinterpret_cast<size_t>(xw);
  [[maybe_unused]] const int lead_w = RAGGED ? (int)((xa + (size_t)warp * D) & 3) : 0;
  [[maybe_unused]] const int lead_t = RAGGED ? (int)((xa + (size_t)tid * D) & 3) : 0;
  [[maybe_unused]] int x_ext = 0;
  auto load = [&](int step) {
    const int n0 = n_begin + (step / n_chunks) * TN;
    const int d0 = (step % n_chunks) * kDKW;
    if constexpr (RAGGED) {  // aligned words d0 + lane of rows warp + 8w, one row pointer
      const int rows_left = n_end - n0 - warp;  // its rows warp + 8w below n_end
      const bool col_ok = 4 * (d0 + lane) - lead_w < D;  // the word holds a byte of the row
      const uint32_t* src =
          reinterpret_cast<const uint32_t*>(xa + (size_t)(n0 + warp) * D - lead_w) + d0 + lane;
      const size_t stride = 2 * (size_t)D;  // 8 rows, in words
#pragma unroll
      for (int w = 0; w < XW; ++w) {
        xr[w] = col_ok && 8 * w < rows_left ? (int)__ldg(src) : 0;
        src += stride;
      }
      const int ext = 4 * (d0 + kDKW) - lead_t;  // aligned word 32 of the thread's row
      x_ext = lead_t != 0 && ext < D && n0 + tid < n_end
                  ? (int)__ldg(reinterpret_cast<const uint32_t*>(xa + (size_t)(n0 + tid) * D + ext))
                  : 0;
    } else {
#pragma unroll
      for (int w = 0; w < XW; ++w) {
        const int wi = tid + w * kThreads, r = wi / kDKW, d = d0 + wi % kDKW;
        xr[w] = (n0 + r < n_end && d < D4) ? xw[(size_t)(n0 + r) * D4 + d] : 0;
      }
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
    if constexpr (RAGGED) xs[kDKW * XLD + tid] = x_ext;
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
    [[maybe_unused]] int x_lo = RAGGED ? xs[tid] : 0;
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
      int xv;
      if constexpr (RAGGED) {  // bytes lead_t .. lead_t + 3 of aligned words c and c + 1
        const int x_hi = xs[(c + 1) * XLD + tid];
        xv = (int)__funnelshift_r((uint32_t)x_lo, (uint32_t)x_hi, 8 * lead_t);
        x_lo = x_hi;
      } else {
        xv = xs[c * XLD + tid];
      }
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

template <int TM>
__global__ void __launch_bounds__(kThreads, 2)
    int8_dp4a_pass1(const int* __restrict__ qw, const float* __restrict__ qsc,
                    const int* __restrict__ xw, const float* __restrict__ xsc,
                    const float* __restrict__ bias, int B, int N, int D, int k, int rows_per_split,
                    float* __restrict__ part_s, int* __restrict__ part_i) {
  int8_dp4a_body<TM, false>(qw, qsc, xw, xsc, bias, B, N, D, k, rows_per_split, part_s, part_i);
}

template <int TM>
__global__ void __launch_bounds__(kThreads, 2)
    int8_dp4a_ragged_pass1(const int* __restrict__ qw, const float* __restrict__ qsc,
                           const int* __restrict__ xw, const float* __restrict__ xsc,
                           const float* __restrict__ bias, int B, int N, int D, int k,
                           int rows_per_split, float* __restrict__ part_s,
                           int* __restrict__ part_i) {
  int8_dp4a_body<TM, true>(qw, qsc, xw, xsc, bias, B, N, D, k, rows_per_split, part_s, part_i);
}

// ---------------------------------------------------------------------------
// K6, K7: wgmma s8 fed by TMA, warp specialised (int8_tc_pass1).
// ---------------------------------------------------------------------------

constexpr int kBoxD = kBoxBytes;  // depth of a box in int8 elements: its bytes
constexpr int kMetaSlotBytes = 2 * kWgN * sizeof(float);  // a tile's corpus scales and bias
// the block's shared memory (ops/topk.py `tc_smem` mirrors it)
using TcLayout = TcLayoutOf<kBoxD, kMetaSlotBytes>;

struct TcArgs {
  TcLayout L;  // read from the parameters: no registers
  const float* qsc;
  float* part_s;  // [B, splits, k]
  int* part_i;
  float* bound;   // [B, S], NEG_INF at launch
  float* cand_s;  // [blocks][kTcSlots][kBufCap], the candidate buffers
  int* cand_i;
  int B, N, k, rows_per_split;
  int qt, resident, stages;
  // K6r: the corpus rows and their scales and bias, read by the producer
  // warp (not read by the TMA instance)
  RaggedRows rows;
  const float* xs;
  const float* bias;
};

// d[64] += A (64 x 32 s8, K-major, descriptor da) * B (128 x 32 s8, K-major,
// descriptor db)^T in int32; scale_d = 0 overwrites d instead.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// This lane's sums of round r = 2j + e (query rows g and g + 8, corpus row
// 8j + 2t + e). A switch on the warp-uniform r: an array in registers takes
// only compile-time indices, and this keeps the sums there.
__device__ __forceinline__ void round_sums(const int (&acc)[64], int r, int& s0, int& s1) {
  switch (r) {
#define CG_R(R)                                \
  case R:                                      \
    s0 = acc[4 * ((R) >> 1) + ((R) & 1)];      \
    s1 = acc[4 * ((R) >> 1) + 2 + ((R) & 1)];  \
    break;
    CG_R(0) CG_R(1) CG_R(2) CG_R(3) CG_R(4) CG_R(5) CG_R(6) CG_R(7)
    CG_R(8) CG_R(9) CG_R(10) CG_R(11) CG_R(12) CG_R(13) CG_R(14) CG_R(15)
    CG_R(16) CG_R(17) CG_R(18) CG_R(19) CG_R(20) CG_R(21) CG_R(22) CG_R(23)
    CG_R(24) CG_R(25) CG_R(26) CG_R(27) CG_R(28) CG_R(29) CG_R(30) CG_R(31)
#undef CG_R
  }
}

// Flush the rows of a warp whose bits are set in full0 (rows g of its quads)
// and full1 (rows g + 8) from their candidate buffers into their lists, two
// at a time (one a half-warp), through the half-warp's staging area in
// shared memory; each flush raises the row's threshold and shares its
// bound. Run by the whole warp, out of line: it is called after a tile's
// epilogue, when the sums are no longer live.
__device__ __noinline__ void tc_flush_rows(unsigned full0, unsigned full1, TcState st,
                                           const float* cand_s, const int* cand_i,
                                           unsigned char* stage, int wrow, int wb, float* part_s,
                                           int* part_i, float* bound, int k, int S, int lslot) {
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4, l16 = lane & 15;
  const unsigned hmask = 0xFFFFu << (16 * half);
  const int area = (threadIdx.x >> 5) * 2 + half;  // this half-warp's staging area
  float* const stage_s = reinterpret_cast<float*>(stage) + area * kBufCap;
  int* const stage_i = reinterpret_cast<int*>(stage) + kHalfWarps * kBufCap + area * kBufCap;
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    unsigned full = h ? full1 : full0;
#pragma unroll 1
    while (full) {
      const int q0 = __ffs(full) - 1;
      full &= full - 1;
      int q1 = -1;
      if (full) {
        q1 = __ffs(full) - 1;
        full &= full - 1;
      }
      const int mine = half ? q1 : q0;  // the quad whose row this half-warp flushes
      if (mine >= 0) {
        const int fr = wrow + (mine >> 2) + 8 * h;
        const int fb = wb + (mine >> 2) + 8 * h;
        const int n = st.cnt()[fr];
        for (int p = l16; p < n; p += 16) {
          stage_s[p] = __ldcg(cand_s + (size_t)fr * kBufCap + p);
          stage_i[p] = __ldcg(cand_i + (size_t)fr * kBufCap + p);
        }
        const size_t base = ((size_t)fb * S + lslot) * k;
        flush_row_inline<kBufCap>(stage_s, stage_i, n, part_s + base, part_i + base, k,
                                  st.len() + fr, st.thr_s() + fr, st.thr_i() + fr, hmask, l16);
        share_bound_inline(part_s + base, k, bound + (size_t)fb * S, lslot, S, st.bnd() + fr, hmask,
                           l16);
        if (l16 == 0) st.cnt()[fr] = 0;
      }
      __syncwarp();
    }
  }
}

// Pass 1 of K6/K7 (RAGGED: K6r): block (query tile of qt = 64 or 128 rows, corpus split)
// -> the top-k of the split's rows for each query, in part_s/part_i
// [B, S, k]. Warps 0-7 are the consumer warpgroups, warp 8 the producer
// (one thread issues the copies). Every thread has 168 registers: with a
// producer warpgroup and setmaxnreg raising the consumers to 232, ptxas
// still allocated their code within 168 and spilled (SASS: R0-R165), so
// the code is written for 168. Consumer w computes query rows 64w .. 64w +
// 63 of the tile against each 128-row corpus stage; a 64-row tile has one
// consumer. qmap / xmap: qv [B, D] and xv [N, D] as boxes of 128 bytes x
// qt / 128 rows; smap / bmap: xs [N] and bias [N] as boxes of 128. RAGGED:
// xmap, smap and bmap are not read; the producer warp brings the corpus
// boxes and the tiles' scales and bias from a.rows, a.xs and a.bias.
template <bool RAGGED>
__device__ __forceinline__ void int8_tc_body(const CUtensorMap& qmap, const CUtensorMap& xmap,
                                             const CUtensorMap& smap, const CUtensorMap& bmap,
                                             const TcArgs& a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const TcLayout& L = a.L;
  unsigned char* sp = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_addr(sp);
  const uint32_t qtile = ring + L.ring_bytes;
  const uint32_t full_bar = smem_addr(sp + L.bar_off);  // [stages]
  const uint32_t empty_bar = full_bar + 8 * a.stages;    // [stages]
  const uint32_t q_bar = empty_bar + 8 * a.stages;
  const uint32_t meta_full = q_bar + 8;                // [kMetaSlots]
  const uint32_t meta_empty = meta_full + 8 * kMetaSlots;  // [kMetaSlots]
  const uint32_t meta = smem_addr(sp + L.meta_off);
  const int consumers = a.qt / kWgM;  // 1 or 2

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int b0 = blockIdx.x * a.qt;
  const int n_begin = blockIdx.y * a.rows_per_split;
  const int n_end = min(a.N, n_begin + a.rows_per_split);

  constexpr int kFill = RAGGED ? kRaggedLanes : 1;  // arrivals that fill a stage or meta slot
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full_bar + 8 * s, kFill);
      mbar_init(empty_bar + 8 * s, 4 * consumers);  // lane 0 of each consumer warp
    }
    mbar_init(q_bar, 1);
    for (int s = 0; s < kMetaSlots; ++s) {
      mbar_init(meta_full + 8 * s, kFill);
      mbar_init(meta_empty + 8 * s, 4 * consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kTcConsumers && RAGGED) {
    // ---- ragged producer: the query tile by TMA, the ring by the warps ----
    const int lane = tid - kTcConsumers * 128;
    if (a.resident && lane == 0) {
      mbar_expect_tx(q_bar, L.query_bytes);
      for (int c = 0; c < L.chunks; ++c) tma_load(qtile + c * a.qt * kBoxD, &qmap, q_bar, c * kBoxD, b0);
    }
    ragged_produce<kWgN>(
        a.rows, n_begin, n_end, L.chunks, a.stages, ring, L.stage_bytes, full_bar, empty_bar,
        meta_full, meta_empty, lane,
        [&](uint32_t st, uint32_t full, int c) {  // a streamed query box
          if (a.resident) return;
          mbar_expect_tx_only(full, a.qt * kBoxD);
          tma_load(st + L.corpus_bytes, &qmap, full, c * kBoxD, b0);
        },
        [&](int m, int n0) {  // the tile's scales and bias
          ragged_meta<kWgN>(meta + m * kMetaSlotBytes, a.xs, n0, a.N, lane);
          ragged_meta<kWgN>(meta + m * kMetaSlotBytes + kMetaSlotBytes / 2, a.bias, n0, a.N, lane);
        });
  } else if (wg == kTcConsumers) {
    // ---- producer: the query tile once (if resident), then the ring ----
    if (tid == kTcConsumers * 128) {
      if (a.resident) {
        mbar_expect_tx(q_bar, L.query_bytes);
        for (int c = 0; c < L.chunks; ++c) tma_load(qtile + c * a.qt * kBoxD, &qmap, q_bar, c * kBoxD, b0);
      }
      int slot = 0;
      uint32_t phase = 0;
      for (int n0 = n_begin, tile = 0; n0 < n_end; n0 += kWgN, ++tile) {
        const int m = tile % kMetaSlots;  // the tile's scales and bias
        mbar_wait(meta_empty + 8 * m, ((tile / kMetaSlots) & 1) ^ 1);
        mbar_expect_tx(meta_full + 8 * m, kMetaSlotBytes);
        tma_load_1d(meta + m * kMetaSlotBytes, &smap, meta_full + 8 * m, n0);
        tma_load_1d(meta + m * kMetaSlotBytes + kMetaSlotBytes / 2, &bmap, meta_full + 8 * m, n0);
        for (int c = 0; c < L.chunks; ++c) {
          mbar_wait(empty_bar + 8 * slot, phase ^ 1);
          mbar_expect_tx(full_bar + 8 * slot, L.stage_bytes);
          const uint32_t st = ring + slot * L.stage_bytes;
          tma_load(st, &xmap, full_bar + 8 * slot, c * kBoxD, n0);
          if (!a.resident) tma_load(st + L.corpus_bytes, &qmap, full_bar + 8 * slot, c * kBoxD, b0);
          if (++slot == a.stages) {
            slot = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else if (wg < consumers) {
    // ---- consumer warpgroup wg ----
    const TcState st{reinterpret_cast<float*>(sp + L.state_off)};
    const int warp = (tid & 127) >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int S = gridDim.y;  // lists per query row, one a split
    const int lslot = blockIdx.y;
    const int wrow = wg * kWgM + 16 * warp;  // the warp's first state slot and row of the tile
    const int wb = b0 + wrow;                // the warp's first query row
    const int k = a.k;
    const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    float* const cand_s = a.cand_s + blk * kTcSlots * kBufCap;  // the block's buffers
    int* const cand_i = a.cand_i + blk * kTcSlots * kBufCap;
    unsigned char* const stage = sp + L.flush_off;  // the flush staging areas

    for (int i = 0; i < 16; ++i) {  // the warp's rows: states and empty lists
      if (lane == 0) {
        st.thr_s()[wrow + i] = kNegInf;
        st.thr_i()[wrow + i] = -1;
        st.cnt()[wrow + i] = 0;
        st.len()[wrow + i] = 0;
        st.bnd()[wrow + i] = kNegInf;
      }
      if (wb + i < a.B) {
        const size_t base = ((size_t)(wb + i) * S + lslot) * k;
        for (int p = lane; p < k; p += 32) {
          __stcg(a.part_s + base + p, kNegInf);
          __stcg(a.part_i + base + p, -1);
        }
      }
    }
    __syncwarp();
    float qi[2];
    unsigned live = 0;  // bit h: query row g + 8h of the warp exists
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = wb + g + 8 * h;
      qi[h] = b < a.B ? __ldg(a.qsc + b) : 0.f;
      live |= (b < a.B ? 1u : 0u) << h;
    }
    const float above_neg_inf = __int_as_float(__float_as_int(kNegInf) - 1);

    if (a.resident) mbar_wait(q_bar, 0);
    int acc[64];
    int slot = 0;
    uint32_t phase = 0;
#pragma unroll 1
    for (int n0 = n_begin, tile = 0; n0 < n_end; n0 += kWgN, ++tile) {
      // the products: 4 k32 steps per stage, one stage's group in flight
      // while the next stage is awaited
      int prev = -1;
      fence_operands(acc);
#pragma unroll 1
      for (int c = 0; c < L.chunks; ++c) {
        mbar_wait(full_bar + 8 * slot, phase);
        const uint32_t stage = ring + slot * L.stage_bytes;
        const uint32_t qa = (a.resident ? qtile + c * a.qt * kBoxD : stage + L.corpus_bytes) +
                            wg * kWgM * kBoxD;
        const uint64_t da = smem_desc(qa), db = smem_desc(stage);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBoxD / 32; ++kk) {
          wgmma_m64n128k32_s8(acc, da + 2 * kk, db + 2 * kk, (c | kk) != 0);
        }
        wgmma_commit();
        if (prev >= 0) {
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty_bar + 8 * prev);
        }
        prev = slot;
        if (++slot == a.stages) {
          slot = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_operands(acc);
      if (lane == 0) mbar_arrive(empty_bar + 8 * prev);
      // the tile's corpus scales and bias (zero past N), as pairs: n-tile j
      // holds corpus rows 8j + 2t, +1
      const int m = tile % kMetaSlots;
      mbar_wait(meta_full + 8 * m, (tile / kMetaSlots) & 1);
      const float* xs_t = reinterpret_cast<const float*>(sp + L.meta_off + m * kMetaSlotBytes);
      const float* bs_t = xs_t + kWgN;
      const int room = n_end - (n0 + 2 * t);  // corpus rows c + 2t, c < room, are in the split

      // The epilogue. acc[4j + 2h + e] is query row g + 8h, corpus row
      // 8j + 2t + e. A score that reaches neither its row's threshold nor
      // the shared bound cannot enter: one compare each, then one vote.
      float thr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int sr = wrow + g + 8 * h;
        thr[h] = (live >> h) & 1u ? fmaxf(fmaxf(st.thr_s()[sr], st.bnd()[sr]), above_neg_inf) : 3.0e38f;
      }
      unsigned hit = 0;  // bit 2j + e: a score of round (j, e) may enter
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 xp = reinterpret_cast<const float2*>(xs_t)[4 * j + t];
        const float2 bp = reinterpret_cast<const float2*>(bs_t)[4 * j + t];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = e ? xp.y : xp.x;
          const float b = e ? bp.y : bp.x;
          const float s0 = int8_score(acc[4 * j + e], qi[0], x, b);
          const float s1 = int8_score(acc[4 * j + 2 + e], qi[1], x, b);
          hit |= (8 * j + e < room && (s0 >= thr[0] || s1 >= thr[1]) ? 1u : 0u) << (2 * j + e);
        }
      }
      const unsigned rounds = __reduce_or_sync(kFull, hit);
      if (rounds) {
        // The rare case: the rounds with a candidate, in order. A score
        // enters its row's buffer if it reaches the bound and beats the
        // list's k-th entry as they stood before the tile; the buffer
        // takes a whole tile, and rows past kCap entries are flushed after
        // the tile, out of line. The states live in registers,
        // quad-uniform.
        float ts[2], lb[2];
        int ti[2], cnt[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int sr = wrow + g + 8 * h;
          ts[h] = st.thr_s()[sr];
          ti[h] = st.thr_i()[sr];
          lb[h] = st.bnd()[sr];
          cnt[h] = st.cnt()[sr];
        }
        unsigned m = rounds;
#pragma unroll 1
        while (m) {  // warp-uniform
          const int r = __ffs(m) - 1;
          m &= m - 1;
          const int n = n0 + 8 * (r >> 1) + 2 * t + (r & 1);
          const bool mine = (hit >> r) & 1u;
          int s0 = 0, s1 = 0;
          round_sums(acc, r, s0, s1);
          const float x = xs_t[8 * (r >> 1) + 2 * t + (r & 1)];
          const float b = bs_t[8 * (r >> 1) + 2 * t + (r & 1)];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float s = int8_score(h ? s1 : s0, qi[h], x, b);
            const bool v = mine && ((live >> h) & 1u) && s >= lb[h] && beats(s, n, ts[h], ti[h]);
            const unsigned qb = (__ballot_sync(kFull, v) >> (4 * g)) & 0xFu;
            if (v) {
              const size_t pos = (size_t)(wrow + g + 8 * h) * kBufCap + cnt[h] +
                                 __popc(qb & ((1u << t) - 1u));
              __stcg(cand_s + pos, s);
              __stcg(cand_i + pos, n);
            }
            cnt[h] += __popc(qb);
          }
        }
        if (t == 0) {
          st.cnt()[wrow + g] = cnt[0];
          st.cnt()[wrow + g + 8] = cnt[1];
        }
        const unsigned full0 = __ballot_sync(kFull, t == 0 && cnt[0] > kCap);
        const unsigned full1 = __ballot_sync(kFull, t == 0 && cnt[1] > kCap);
        __syncwarp();
        if (full0 | full1) {
          tc_flush_rows(full0, full1, st, cand_s, cand_i, stage, wrow, wb, a.part_s,
                        a.part_i, a.bound, k, S, lslot);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(meta_empty + 8 * m);
    }

    // what is left in the buffers goes into the lists
    __syncwarp();
    const unsigned left0 = __ballot_sync(kFull, (lane & 3) == 0 && st.cnt()[wrow + g] > 0);
    const unsigned left1 = __ballot_sync(kFull, (lane & 3) == 0 && st.cnt()[wrow + g + 8] > 0);
    if (left0 | left1) {
      tc_flush_rows(left0, left1, st, cand_s, cand_i, stage, wrow, wb, a.part_s,
                    a.part_i, a.bound, k, S, lslot);
    }
  }
}

__global__ void __launch_bounds__(kTcThreads, 1)
    int8_tc_pass1(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap smap, const __grid_constant__ CUtensorMap bmap,
                  const TcArgs a) {
  int8_tc_body<false>(qmap, xmap, smap, bmap, a);
}

__global__ void __launch_bounds__(kRaggedThreads, 1)
    int8_tc_ragged_pass1(const __grid_constant__ CUtensorMap qmap, const TcArgs a) {
  int8_tc_body<true>(qmap, qmap, qmap, qmap, a);
}

// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, int bt, const int* qw, const float* qsc,
                   const int* xw, const float* xsc, const float* bias, int B, int N, int D, int k,
                   int rows_per_split, int splits, float* part_s, int* part_i, cudaStream_t st) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + bt - 1) / bt, splits);
  kernel<<<grid, kThreads, smem, st>>>(qw, qsc, xw, xsc, bias, B, N, D, k, rows_per_split, part_s,
                                       part_i);
  return cudaGetLastError();
}

// K5: __dp4a column warps, tm (query rows) in {1, 2, 4, 8}, corpus tile
// 256; ragged: the instance that realigns rows that are not 4-byte aligned.
cudaError_t dispatch_dp4a(int tm, bool ragged, const int* qw, const float* qsc, const int* xw,
                          const float* xsc, const float* bias, int B, int N, int D, int k,
                          int rows_per_split, int splits, float* part_s, int* part_i,
                          cudaStream_t st) {
#define CG_DP4A(TM)                                                                           \
  {                                                                                           \
    const size_t smem = ragged ? Dp4aLayout<TM, true>::smem(k) : Dp4aLayout<TM>::smem(k);     \
    if (rows_per_split % Dp4aLayout<TM>::TN != 0) return cudaErrorInvalidValue;               \
    return launch(ragged ? int8_dp4a_ragged_pass1<TM> : int8_dp4a_pass1<TM>, smem, TM, qw, qsc, \
                  xw, xsc, bias, B, N, D, k, rows_per_split, splits, part_s, part_i, st);     \
  }
  switch (tm) {
    case 1: CG_DP4A(1)
    case 2: CG_DP4A(2)
    case 4: CG_DP4A(4)
    case 8: CG_DP4A(8)
  }
#undef CG_DP4A
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Scratch entries (per scores and per ids) that int8_topk or int8_topk_tc
// needs for `lists` list slots per query row (int8_topk: the splits).
long long int8_topk_work_entries(int B, int k, int lists, int group) {
  return merge_work_entries(B, k, lists, group);
}

// Candidate buffer entries (per scores and per ids) of int8_topk_tc: a
// kBufCap-entry buffer for each of a block's kTcSlots rows.
long long int8_topk_tc_cand_entries(int B, int query_tile, int splits) {
  if (query_tile < 1) return 0;
  return (long long)((B + query_tile - 1) / query_tile) * splits * kTcSlots * kBufCap;
}

// Shared memory (bytes) of int8_tc_pass1 for a query tile of query_tile
// (64 or 128) rows, a resident or streamed query tile, `stages` ring
// stages and depth D; 0 for a tile it does not take.
long long int8_topk_tc_smem(int query_tile, int resident, int stages, int D) {
  if ((query_tile != kWgM && query_tile != 2 * kWgM) || stages < 1 || D < 1) return 0;
  return (long long)TcLayout(query_tile, resident, stages, D).smem;
}

// K5: qv [B, D4 * 4] int8 (D4 = ceil(D / 4), columns past D zero, 4-byte
// aligned), qs [B] f32, xv [N, D] int8 at any byte address, xs [N] f32,
// bias [N] f32, all contiguous on the device of `stream`. piece 4:
// int8_dp4a_pass1 reads rows as words (D % 4 == 0, xv 4-byte aligned);
// piece 1: int8_dp4a_ragged_pass1 realigns them (any D and address; qv's
// zero columns cancel the bytes it reads past a row). Writes out_s [B, k]
// f32 and out_i [B, k] i32. Pass 1 runs with tile size tm over `splits` ranges of
// `rows_per_split` corpus rows (a multiple of 256); work_s / work_i hold
// int8_topk_work_entries(B, k, splits, group) entries each. Returns the
// CUDA error code of the launches (0 = success).
int int8_topk(const void* qv, const float* qs, const void* xv, const float* xs, const float* bias,
              int B, int N, int D, int k, int tm, int splits, int rows_per_split, int group,
              int piece, float* out_s, int* out_i, float* work_s, int* work_i, void* stream) {
  const bool words = D % 4 == 0 && (reinterpret_cast<size_t>(xv) & 3) == 0;
  if (B < 1 || N < 1 || D < 1 || k < 1 || k > 1024 || splits < 1 || group < 2 ||
      rows_per_split < 1 || (long long)splits * rows_per_split < N ||
      (long long)(splits - 1) * rows_per_split >= N || (reinterpret_cast<size_t>(qv) & 3) != 0 ||
      !(piece == 1 || (piece == 4 && words))) {
    return (int)cudaErrorInvalidValue;
  }
  const bool ragged = piece == 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part_s = splits == 1 ? out_s : work_s;
  int* part_i = splits == 1 ? out_i : work_i;
  cudaError_t err = dispatch_dp4a(tm, ragged, static_cast<const int*>(qv), qs,
                                  static_cast<const int*>(xv), xs, bias, B, N, D, k,
                                  rows_per_split, splits, part_s, part_i, st);
  if (err != cudaSuccess) return (int)err;
  if (splits == 1) return 0;
  return (int)merge_splits(B, k, splits, group, out_s, out_i, work_s, work_i, st);
}

// K6/K7: int8_tc_pass1 (piece = 0) or, for a corpus TMA cannot read,
// int8_tc_ragged_pass1 ("K6r", piece = 16, 8, 4 or 1: the ragged-row
// producer's copies, see hopper_tc.cuh) over grid (ceil(B / query_tile),
// splits), then pass 2. qv [B, Dq] int8 (Dq = D for piece 0, else D
// rounded up to a multiple of 16 with zero columns), 16-byte aligned; qs
// [B] f32; xv [N, D] int8, xs [N] f32 and bias [N] f32, all contiguous on
// the device of `stream`. piece 0: D % 16 == 0 and xv, xs and bias 16-byte
// aligned (TMA's strides and addresses); piece p > 1: D % p == 0 and xv
// p-byte aligned; piece 1: any D and address; the ragged instance takes at
// least 3 stages. query_tile: 64 or 128; the query tile is resident
// (resident = 1) or streams with the corpus through the ring of `stages`;
// rows_per_split a multiple of 128; smem must equal int8_topk_tc_smem(...).
// work_s / work_i hold int8_topk_work_entries(B, k, splits, group) entries
// each and bound B * splits, set to NEG_INF (-1e30); cand_s / cand_i hold
// int8_topk_tc_cand_entries(B, query_tile, splits) entries each (the
// candidate buffers, no initial value). Returns the CUDA error code of the
// launches (0 = success).
int int8_topk_tc(const void* qv, const float* qs, const void* xv, const float* xs,
                 const float* bias, int B, int N, int D, int k, int query_tile, int resident,
                 int stages, int splits, int rows_per_split, long long smem, int group, int piece,
                 float* out_s, int* out_i, float* work_s, int* work_i, float* bound, float* cand_s,
                 int* cand_i, void* stream) {
  const size_t xa = reinterpret_cast<size_t>(xv);
  const bool shape_ok =
      piece == 0 ? D % 16 == 0 && (xa & 15) == 0 && (reinterpret_cast<size_t>(xs) & 15) == 0 &&
                       (reinterpret_cast<size_t>(bias) & 15) == 0
      : piece == 1 ? stages >= 3
      : (piece == 4 || piece == 8 || piece == 16) && D % piece == 0 && xa % piece == 0 &&
            stages >= 3;
  if (B < 1 || N < 1 || D < 1 || k < 1 || k > 1024 || splits < 1 || group < 2 || !shape_ok ||
      stages < 2 || rows_per_split < 1 || rows_per_split % kWgN != 0 ||
      (long long)splits * rows_per_split < N || (long long)(splits - 1) * rows_per_split >= N ||
      (reinterpret_cast<size_t>(qv) & 15) != 0 ||
      smem != int8_topk_tc_smem(query_tile, resident, stages, D) || smem > 232448) {
    return (int)cudaErrorInvalidValue;
  }
  const int Dq = piece == 0 ? D : (D + 15) / 16 * 16;
  CUtensorMap qmap, xmap, smap, bmap;
  if (!encode_rows(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, qv, B, Dq, query_tile) ||
      (piece == 0 && (!encode_rows(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, xv, N, D, kWgN) ||
                      !encode_vector(&smap, xs, N, kWgN) || !encode_vector(&bmap, bias, N, kWgN)))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  TcArgs a;
  a.L = TcLayout(query_tile, resident, stages, D);
  a.qsc = qs;
  a.part_s = splits == 1 ? out_s : work_s;
  a.part_i = splits == 1 ? out_i : work_i;
  a.bound = bound;
  a.cand_s = cand_s;
  a.cand_i = cand_i;
  a.B = B;
  a.N = N;
  a.k = k;
  a.rows_per_split = rows_per_split;
  a.qt = query_tile;
  a.resident = resident;
  a.stages = stages;
  a.rows = RaggedRows{static_cast<const unsigned char*>(xv), (long long)D, N, piece};
  a.xs = xs;
  a.bias = bias;
  const dim3 grid((B + query_tile - 1) / query_tile, splits);
  cudaError_t err;
  if (piece == 0) {
    err = cudaFuncSetAttribute(int8_tc_pass1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int8_tc_pass1<<<grid, kTcThreads, (size_t)smem, st>>>(qmap, xmap, smap, bmap, a);
  } else {
    err = cudaFuncSetAttribute(int8_tc_ragged_pass1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    int8_tc_ragged_pass1<<<grid, kRaggedThreads, (size_t)smem, st>>>(qmap, a);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (splits == 1) return 0;
  return (int)merge_splits(B, k, splits, group, out_s, out_i, work_s, work_i, st);
}

}  // extern "C"

// Exact streaming top-k for small query batches over a device-resident
// bf16 corpus on Hopper's tensor cores: scores = q . x^T + bias, then the k
// best rows per query, sorted descending (a tie goes to the lower row id;
// (NEG_INF, -1) for rows past the live count). bf16 queries multiply the
// rows as they are; an f32 query multiplies them as its three bf16 pieces
// hi + mid + lo == q (ops/bf16_split.py `split_bf16`), three products into
// one f32 accumulator, so its scores are those of the f32 query (a piece
// times a bf16 value is exact in f32).
//
// Replaces, over bf16 rows, the Pallas kernel K1 of
// codegraph_tpu/ops/topk.py, streaming_topk_pallas / _flat_topk_kernel
// (:347), which computes dot_general(q, x_bf16, preferred_element_type=f32)
// + bias for batches under 32 and keeps a running top-k a query row. f32
// rows stay on flat_topk.cu's topk_pass1. Rows TMA cannot read (D % 8 !=
// 0, or a base not 16-byte aligned) run bf16_k1_pass1<QN, PIECES, true>
// ("K1tcr"): the same kernel with its corpus boxes and bias brought by
// hopper_tc.cuh's ragged-row producer, laid out as TMA would (the queries,
// padded by the wrapper to a multiple of 8, still come by TMA). One
// pass-1 kernel, bf16_k1_pass1<QN, PIECES, RAGGED>, and the pass 2 of
// topk_merge.cuh.
//
// What bounds it on the H100: the corpus bytes, read once a call, N*D*2 +
// 4N: 1.54 GB at 1M x 768, 0.46 ms at 3.35 TB/s. Its products, 2*B*N*D a
// piece (at most 32 queries a block), take under 0.1 ms at 989 TFLOP/s.
// What bf16_k1_pass1 does about it:
//   * No copy goes through registers. One producer warp keeps a ring of
//     corpus boxes (128 rows x 64 bf16 of depth, 16 KB, up to 8 stages) in
//     flight by TMA (zero-filled past N and D) behind mbarrier full/empty
//     pairs, with the tiles' bias in a ring of its own, as in K2tc
//     (flat_topk_tc.cu); the block's query tile (QN = 8, 16, 24 or 32 rows,
//     each piece) is loaded once and stays resident where it fits beside 3
//     stages, else its boxes stream with each corpus box.
//   * The products run on the tensor cores straight from the bf16 rows:
//     wgmma m64nQNk16, the swizzled corpus box as the 64-row operand (each
//     of the two consumer warpgroups takes 64 rows of a stage), the queries
//     as the QN-column operand; nothing is widened in shared memory. The f32
//     sums stay in registers (QN / 2 a thread), and the epilogue adds the
//     bias with one __fadd_rn, as the plain version adds it.
//   * Selection does not grow with k after the first tiles. A query's
//     threshold is the larger of its list's k-th entry and the bound that
//     the corpus splits share (share_bound_inline), so after the first
//     tiles almost no score passes; one vote a warp skips the offer. A
//     score that passes goes, through one shared-memory atomic per query
//     and warp, to the query's candidate buffer in shared memory (room for
//     a whole tile beyond kCap entries); every warp offers its own rows, at
//     B = 1 as at B = 32. One consumer barrier a tile (a reduction that
//     says whether any buffer passed kCap) ends the tile's offers; the full
//     buffers are then sorted and merged into their lists in device memory
//     (sort_buffer, merge_sorted: hopper_tc.cuh), each by the half-warp
//     that owns the query, while the producer's copies go on.
//   * Grid (query tiles, corpus splits), one block per SM and one wave, so
//     that every split of a query runs at once and the shared bound holds
//     from the first tiles; pass 2 merges the splits' lists.

#include <type_traits>

#include "hopper_tc.cuh"

namespace {

constexpr int kK1BoxD = kBoxBytes / 2;  // depth of a box in bf16 elements
constexpr int kK1Rows = kWgN;           // corpus rows of a ring stage: 64 a consumer warpgroup
constexpr int kK1MetaBytes = kK1Rows * sizeof(float);  // a tile's bias
constexpr int kK1ConsumerThreads = 128 * kTcConsumers;

// The block's shared memory for a query tile of qn rows in `pieces` parts,
// resident or streamed, `stages` ring stages and depth D (ops/topk.py
// `k1tc_smem` mirrors it), from a 1024-byte aligned base: the ring (each
// stage a corpus box of 128 rows x 128 bytes and, when the query tile
// streams, its pieces' boxes of qn x 128 bytes), the resident query tile
// (a box of qn x 128 bytes per piece and 64 of depth), the bias slots, the
// candidate buffers (kBufCap entries a query), five 4-byte states a query
// and the barriers.
struct K1Layout {
  int chunks, stage_bytes, ring_bytes, query_bytes;
  size_t meta_off, buf_off, state_off, bar_off, smem;
  K1Layout() = default;
  __host__ __device__ K1Layout(int qn, int pieces, int resident, int stages, int D) {
    chunks = (D + kK1BoxD - 1) / kK1BoxD;
    stage_bytes = kK1Rows * kBoxBytes + (resident ? 0 : pieces * qn * kBoxBytes);
    ring_bytes = stages * stage_bytes;
    query_bytes = resident ? pieces * chunks * qn * kBoxBytes : 0;
    meta_off = (size_t)ring_bytes + query_bytes;
    buf_off = meta_off + (size_t)kMetaSlots * kK1MetaBytes;
    state_off = buf_off + (size_t)qn * kBufCap * (sizeof(float) + sizeof(int));
    bar_off = state_off + (size_t)qn * 5 * sizeof(int);
    smem = 1024 + bar_off + (size_t)(2 * stages + 1 + 2 * kMetaSlots) * sizeof(uint64_t);
  }
};

struct K1Args {
  K1Layout L;     // read from the parameters: no registers
  float* part_s;  // [B, splits, k]
  int* part_i;
  float* bound;   // [B, S], NEG_INF at launch
  int B, N, k, rows_per_split, resident, stages;
};
// K1tcr's arguments: K1's, and the corpus rows and bias that its producer
// warps read (the TMA instance keeps K1Args as it was)
struct K1RaggedArgs : K1Args {
  RaggedRows rows;
  const float* bias;
};
template <bool RAGGED>
using K1ArgsOf = typename std::conditional<RAGGED, K1RaggedArgs, K1Args>::type;

// d[N / 2] += A (64 x 16 bf16, K-major, descriptor da) * B (N x 16 bf16,
// K-major, descriptor db)^T in f32; scale_d = 0 overwrites d instead.
template <int N>
struct WgmmaK1;
template <>
struct WgmmaK1<8> {
  static __device__ __forceinline__ void run(float (&d)[4], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};
template <>
struct WgmmaK1<16> {
  static __device__ __forceinline__ void run(float (&d)[8], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};
template <>
struct WgmmaK1<24> {
  static __device__ __forceinline__ void run(float (&d)[12], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, %12, %13, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};
template <>
struct WgmmaK1<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <int M>
__device__ __forceinline__ void fence_sums(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The consumer warpgroups' barrier (named barrier 1; the producer warp
// never joins it), plain and as an OR of one predicate over its threads.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kK1ConsumerThreads) : "memory");
}
__device__ __forceinline__ bool consumer_sync_or(bool v) {
  int out;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.b32 q, %1, 0;\n"
      "bar.red.or.pred p, 1, %2, q;\nselp.s32 %0, 1, 0, p;\n}\n"
      : "=r"(out)
      : "r"((int)v), "n"(kK1ConsumerThreads)
      : "memory");
  return out != 0;
}

// Merge query qi's n buffered candidates into its list and share its
// bound; run by the half-warp that owns the query.
__device__ __noinline__ void k1_flush_query(int qi, int n, float* buf_s, int* buf_i, float* st,
                                            int qn, float* list_s, int* list_i, float* bound,
                                            int k, int S, int lslot, unsigned hmask, int l16) {
  float* bs = buf_s + qi * kBufCap;
  int* bi = buf_i + qi * kBufCap;
  sort_buffer(bs, bi, n, hmask, l16);
  merge_sorted(bs, bi, n, list_s, list_i, k, reinterpret_cast<int*>(st + 3 * qn) + qi, st + qi,
               reinterpret_cast<int*>(st + qn) + qi, hmask, l16);
  share_bound_inline(list_s, k, bound, lslot, S, st + 4 * qn + qi, hmask, l16);
  if (l16 == 0) reinterpret_cast<int*>(st + 2 * qn)[qi] = 0;
  __syncwarp(hmask);
}

// Pass 1 of K1 over bf16 rows: block (query tile of QN rows, corpus split)
// -> the top-k of the split's rows for each query, in part_s/part_i [B, S,
// k]. Warps 0-7 are the two consumer warpgroups, warp 8 the producer (one
// thread issues the copies). Consumer w computes corpus rows 64w .. 64w +
// 63 of each 128-row stage against the QN queries: acc[4j + 2h + e] is
// corpus row 64w + 16 * warp + g + 8h and query 8j + 2t + e. Half-warp h
// of the consumers (0..15) owns queries h and h + 16: their states, lists
// and flushes. qmap0..2: the query pieces [B, D] bf16 (hi, mid, lo; PIECES
// of them) as boxes of 64 depths x QN rows; xmap: x [N, D] bf16 as boxes of
// 64 depths x 128 rows; bmap: bias [N] as boxes of 128. RAGGED: xmap and
// bmap are not read; the producer warp brings the corpus boxes and the
// tiles' bias from a.rows and a.bias.
template <int QN, int PIECES, bool RAGGED>
__global__ void __launch_bounds__(RAGGED ? kRaggedThreads : kTcThreads, 1)
    bf16_k1_pass1(const __grid_constant__ CUtensorMap qmap0, const __grid_constant__ CUtensorMap qmap1,
                  const __grid_constant__ CUtensorMap qmap2, const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap bmap, const K1ArgsOf<RAGGED> a) {
  static_assert(QN % 8 == 0 && QN <= 32, "query tiles of 8, 16, 24 or 32 rows");
  constexpr int kQBox = QN * kBoxBytes;  // a query box: QN rows x 128 bytes
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const K1Layout& L = a.L;
  unsigned char* sp = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_addr(sp);
  const uint32_t qtile = ring + L.ring_bytes;
  const uint32_t full_bar = smem_addr(sp + L.bar_off);  // [stages]
  const uint32_t empty_bar = full_bar + 8 * a.stages;    // [stages]
  const uint32_t q_bar = empty_bar + 8 * a.stages;
  const uint32_t meta_full = q_bar + 8;                    // [kMetaSlots]
  const uint32_t meta_empty = meta_full + 8 * kMetaSlots;  // [kMetaSlots]
  const uint32_t meta = smem_addr(sp + L.meta_off);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int b0 = blockIdx.x * QN;
  const int n_begin = blockIdx.y * a.rows_per_split;
  const int n_end = min(a.N, n_begin + a.rows_per_split);

  constexpr int kFill = RAGGED ? kRaggedLanes : 1;  // arrivals that fill a stage or meta slot
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full_bar + 8 * s, kFill);
      mbar_init(empty_bar + 8 * s, 4 * kTcConsumers);  // lane 0 of each consumer warp
    }
    mbar_init(q_bar, 1);
    for (int s = 0; s < kMetaSlots; ++s) {
      mbar_init(meta_full + 8 * s, kFill);
      mbar_init(meta_empty + 8 * s, 4 * kTcConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if constexpr (RAGGED) {
    if (wg == kTcConsumers) {
      // ---- ragged producer: the query tile by TMA, the ring by the warps ----
      const int lane = tid - kTcConsumers * 128;
      const CUtensorMap* const qmaps[3] = {&qmap0, &qmap1, &qmap2};
      if (a.resident && lane == 0) {
        mbar_expect_tx(q_bar, L.query_bytes);
        for (int p = 0; p < PIECES; ++p) {
          for (int c = 0; c < L.chunks; ++c) {
            tma_load(qtile + (p * L.chunks + c) * kQBox, qmaps[p], q_bar, c * kK1BoxD, b0);
          }
        }
      }
      ragged_produce<kK1Rows>(
          a.rows, n_begin, n_end, L.chunks, a.stages, ring, L.stage_bytes, full_bar, empty_bar,
          meta_full, meta_empty, lane,
          [&](uint32_t box, uint32_t full, int c) {  // a streamed query box a piece
            if (a.resident) return;
            mbar_expect_tx_only(full, PIECES * kQBox);
            for (int p = 0; p < PIECES; ++p) {
              tma_load(box + kK1Rows * kBoxBytes + p * kQBox, qmaps[p], full, c * kK1BoxD, b0);
            }
          },
          [&](int m, int n0) {  // the tile's bias
            ragged_meta<kK1Rows>(meta + m * kK1MetaBytes, a.bias, n0, a.N, lane);
          });
      return;
    }
  }
  if (wg == kTcConsumers) {
    // ---- producer: the query tile once (if resident), then the ring ----
    if (tid == kTcConsumers * 128) {
      const CUtensorMap* const qmaps[3] = {&qmap0, &qmap1, &qmap2};
      if (a.resident) {
        mbar_expect_tx(q_bar, L.query_bytes);
        for (int p = 0; p < PIECES; ++p) {
          for (int c = 0; c < L.chunks; ++c) {
            tma_load(qtile + (p * L.chunks + c) * kQBox, qmaps[p], q_bar, c * kK1BoxD, b0);
          }
        }
      }
      int slot = 0;
      uint32_t phase = 0;
      for (int n0 = n_begin, tile = 0; n0 < n_end; n0 += kK1Rows, ++tile) {
        const int m = tile % kMetaSlots;  // the tile's bias
        mbar_wait(meta_empty + 8 * m, ((tile / kMetaSlots) & 1) ^ 1);
        mbar_expect_tx(meta_full + 8 * m, kK1MetaBytes);
        tma_load_1d(meta + m * kK1MetaBytes, &bmap, meta_full + 8 * m, n0);
        for (int c = 0; c < L.chunks; ++c) {
          mbar_wait(empty_bar + 8 * slot, phase ^ 1);
          mbar_expect_tx(full_bar + 8 * slot, L.stage_bytes);
          const uint32_t box = ring + slot * L.stage_bytes;
          tma_load(box, &xmap, full_bar + 8 * slot, c * kK1BoxD, n0);
          if (!a.resident) {
            for (int p = 0; p < PIECES; ++p) {
              tma_load(box + kK1Rows * kBoxBytes + p * kQBox, qmaps[p], full_bar + 8 * slot,
                       c * kK1BoxD, b0);
            }
          }
          if (++slot == a.stages) {
            slot = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  float* const st = reinterpret_cast<float*>(sp + L.state_off);  // [5][QN]: see k1_flush_query
  float* const thr_s = st;  // the query's list's k-th entry
  const int* const thr_i = reinterpret_cast<const int*>(st + QN);
  int* const cnt = reinterpret_cast<int*>(st + 2 * QN);  // buffered candidates
  const float* const bnd = st + 4 * QN;                  // the bound the splits share
  float* const buf_s = reinterpret_cast<float*>(sp + L.buf_off);  // [QN][kBufCap]
  int* const buf_i = reinterpret_cast<int*>(buf_s + QN * kBufCap);
  const int warp = (tid & 127) >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int hw = tid >> 4, l16 = lane & 15;  // the consumer half-warp
  const unsigned hmask = 0xFFFFu << (16 * ((lane >> 4) & 1));
  const int S = gridDim.y;  // lists per query row, one a split
  const int lslot = blockIdx.y;
  const int k = a.k;

  for (int qi = hw; qi < QN; qi += 16) {  // the half-warp's queries: states and empty lists
    if (l16 == 0) {
      st[qi] = kNegInf;
      reinterpret_cast<int*>(st + QN)[qi] = -1;
      cnt[qi] = 0;
      reinterpret_cast<int*>(st + 3 * QN)[qi] = 0;
      st[4 * QN + qi] = kNegInf;
    }
    if (b0 + qi < a.B) {
      const size_t base = ((size_t)(b0 + qi) * S + lslot) * k;
      for (int p = l16; p < k; p += 16) {
        __stcg(a.part_s + base + p, kNegInf);
        __stcg(a.part_i + base + p, -1);
      }
    }
  }
  consumer_sync();
  const float above_neg_inf = __int_as_float(__float_as_int(kNegInf) - 1);
  const int row0 = wg * 64 + 16 * warp + g;  // this lane's corpus rows of a tile: row0, row0 + 8
  auto flush = [&](int least) {  // each half-warp flushes its queries with more than `least`
    for (int qi = hw; qi < QN; qi += 16) {
      const int n = cnt[qi];
      if (n > least) {
        const size_t base = ((size_t)(b0 + qi) * S + lslot) * k;
        k1_flush_query(qi, n, buf_s, buf_i, st, QN, a.part_s + base, a.part_i + base,
                       a.bound + (size_t)(b0 + qi) * S, k, S, lslot, hmask, l16);
      }
    }
  };

  if (a.resident) mbar_wait(q_bar, 0);
  float acc[QN / 2];
  int slot = 0;
  uint32_t phase = 0;
#pragma unroll 1
  for (int n0 = n_begin, tile = 0; n0 < n_end; n0 += kK1Rows, ++tile) {
    // the products: 4 k16 steps a stage and piece, one stage's group in
    // flight while the next stage is awaited
    int prev = -1;
    fence_sums(acc);
#pragma unroll 1
    for (int c = 0; c < L.chunks; ++c) {
      mbar_wait(full_bar + 8 * slot, phase);
      const uint32_t box = ring + slot * L.stage_bytes;
      const uint64_t da = smem_desc(box + wg * 64 * kBoxBytes);
      const uint64_t db = smem_desc(a.resident ? qtile + c * kQBox : box + kK1Rows * kBoxBytes);
      // a piece's boxes follow the one before: chunks boxes further on when
      // resident, one box when streamed
      const uint64_t dp = (uint64_t)(a.resident ? L.chunks * kQBox : kQBox) >> 4;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBoxBytes / 32; ++kk) {
#pragma unroll
        for (int p = PIECES - 1; p >= 0; --p) {  // the smallest piece first
          WgmmaK1<QN>::run(acc, da + 2 * kk, db + p * dp + 2 * kk,
                           (c | kk) != 0 || p != PIECES - 1);
        }
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
    fence_sums(acc);
    if (lane == 0) mbar_arrive(empty_bar + 8 * prev);

    // The epilogue: score + bias against the query's threshold, one vote.
    const int m = tile % kMetaSlots;
    mbar_wait(meta_full + 8 * m, (tile / kMetaSlots) & 1);
    const float* bs_t = reinterpret_cast<const float*>(sp + L.meta_off + m * kK1MetaBytes);
    float bias[2];
    bool in[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bias[h] = bs_t[row0 + 8 * h];
      in[h] = n0 + row0 + 8 * h < n_end;
    }
    float thr[QN / 4];  // query 8j + 2t + e at 2j + e
#pragma unroll
    for (int i = 0; i < QN / 4; ++i) {
      const int qi = 8 * (i >> 1) + 2 * t + (i & 1);
      thr[i] = b0 + qi < a.B ? fmaxf(fmaxf(thr_s[qi], bnd[qi]), above_neg_inf) : 3.0e38f;
    }
    bool hit = false;
#pragma unroll
    for (int j = 0; j < QN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          hit |= in[h] && __fadd_rn(acc[4 * j + 2 * h + e], bias[h]) >= thr[2 * j + e];
        }
    bool over = false;  // this lane pushed a query's buffer past kCap
    if (__any_sync(kFull, hit)) {
      // The rare case. A score enters its query's buffer if it reaches the
      // bound and beats the list's k-th entry as they stood before the
      // tile; the lanes of one query (t fixed) take their slots with one
      // atomic.
#pragma unroll
      for (int i = 0; i < QN / 4; ++i) {
        const int j = i >> 1, e = i & 1;
        const int qi = 8 * j + 2 * t + e;
        const bool qlive = b0 + qi < a.B;
        const float ts = thr_s[qi], lb = bnd[qi];
        const int ti = thr_i[qi];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = n0 + row0 + 8 * h;
          const float s = __fadd_rn(acc[4 * j + 2 * h + e], bias[h]);
          const bool v = qlive && in[h] && s >= lb && beats(s, n, ts, ti);
          const unsigned grp = __ballot_sync(kFull, v) & (0x11111111u << t);
          const int leader = grp ? __ffs(grp) - 1 : lane;
          int pos = 0;
          if (grp && lane == leader) {
            pos = atomicAdd(cnt + qi, __popc(grp));
            over |= pos + __popc(grp) > kCap;
          }
          pos = __shfl_sync(kFull, pos, leader);
          if (v) {
            pos += __popc(grp & ((1u << lane) - 1u));
            buf_s[qi * kBufCap + pos] = s;
            buf_i[qi * kBufCap + pos] = n;
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(meta_empty + 8 * m);
    if (consumer_sync_or(over)) {  // every offer of the tile is in
      flush(kCap);
      consumer_sync();
    }
  }
  flush(0);  // what is left in the buffers goes into the lists
}

template <int QN, int PIECES>
cudaError_t launch_k1(const CUtensorMap (&qmaps)[3], const CUtensorMap& xmap,
                      const CUtensorMap& bmap, const K1RaggedArgs& a, int grid_x, int splits,
                      long long smem, bool ragged, cudaStream_t st) {
  const dim3 grid(grid_x, splits);
  if (ragged) {  // it reads neither xmap nor bmap (not encoded for it)
    auto kern = bf16_k1_pass1<QN, PIECES, true>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, kRaggedThreads, (size_t)smem, st>>>(qmaps[0], qmaps[1], qmaps[2], qmaps[0],
                                                     qmaps[0], a);
    return cudaGetLastError();
  }
  auto kern = bf16_k1_pass1<QN, PIECES, false>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kTcThreads, (size_t)smem, st>>>(qmaps[0], qmaps[1], qmaps[2], xmap, bmap,
                                               static_cast<const K1Args&>(a));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch entries (per scores and per ids) of the per-split lists and the
// first merge level for `splits` corpus splits.
long long flat_topk_k1tc_work_entries(int B, int k, int splits, int group) {
  return merge_work_entries(B, k, splits, group);
}

// Shared memory (bytes) of bf16_k1_pass1 for a query tile of query_tile
// (8, 16, 24 or 32) rows in `pieces` (1: bf16 queries; 3: f32 queries as
// bf16 pieces) parts, resident or streamed, `stages` ring stages and
// depth D; 0 for a tile it does not take.
long long flat_topk_k1tc_smem(int query_tile, int pieces, int resident, int stages, int D) {
  if (query_tile < 8 || query_tile > 32 || query_tile % 8 != 0 || (pieces != 1 && pieces != 3) ||
      stages < 1 || D < 1) {
    return 0;
  }
  return (long long)K1Layout(query_tile, pieces, resident, stages, D).smem;
}

// K1 over bf16 rows: bf16_k1_pass1 (piece = 0) or, over rows TMA cannot
// read, bf16_k1_pass1<QN, PIECES, true> (piece = 16, 8, 4 or 1: the ragged-row producer's
// copies, see hopper_tc.cuh) over grid (ceil(B / query_tile), splits), then
// pass 2. q [pieces, B, Dq] bf16 (pieces = 1: bf16 queries; 3: an f32
// query's split_bf16 pieces hi, mid, lo), 16-byte aligned, Dq = D rounded
// up to a multiple of 8 (zero columns past D); x [N, D] bf16, bias [N] f32,
// all contiguous on the device of `stream`. piece 0: x and bias 16-byte
// aligned, D % 8 == 0 (TMA's strides and addresses); piece p > 1: 2D % p ==
// 0 and x p-byte aligned; piece 1: any D and address; the ragged instance
// takes at least 3 stages. rows_per_split a multiple of 128; smem must
// equal flat_topk_k1tc_smem(...). out_s [B, k] f32 and out_i [B, k]
// i32; work_s / work_i hold flat_topk_k1tc_work_entries(B, k, splits,
// group) entries each and bound B * splits, set to NEG_INF (-1e30).
// Returns the CUDA error code of the launches (0 = success).
int flat_topk_k1tc(const void* q, int pieces, const void* x, const float* bias, int B, int N, int D,
                   int k, int query_tile, int resident, int stages, int splits, int rows_per_split,
                   long long smem, int group, int piece, float* out_s, int* out_i,
                   float* work_s, int* work_i, float* bound, void* stream) {
  const size_t xa = reinterpret_cast<size_t>(x);
  const bool shape_ok =
      piece == 0 ? D % 8 == 0 && (xa & 15) == 0 && (reinterpret_cast<size_t>(bias) & 15) == 0
      : piece == 1 ? stages >= 3
      : (piece == 4 || piece == 8 || piece == 16) && (2 * D) % piece == 0 && xa % piece == 0 && stages >= 3;
  if (B < 1 || N < 1 || D < 1 || k < 1 || k > 1024 || splits < 1 || group < 2 || !shape_ok ||
      stages < 2 || rows_per_split < 1 || rows_per_split % kK1Rows != 0 ||
      (long long)splits * rows_per_split < N || (long long)(splits - 1) * rows_per_split >= N ||
      (reinterpret_cast<size_t>(q) & 15) != 0 ||
      smem != flat_topk_k1tc_smem(query_tile, pieces, resident, stages, D) || smem > 232448) {
    return (int)cudaErrorInvalidValue;
  }
  // one map a piece, each B rows (zeros past B), piece p at p * B * Dq
  const int Dq = (D + 7) / 8 * 8;
  CUtensorMap qmaps[3], xmap, bmap;
  for (int p = 0; p < pieces; ++p) {
    const void* qp = static_cast<const unsigned short*>(q) + (size_t)p * B * Dq;
    if (!encode_rows(&qmaps[p], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, qp, B, Dq, query_tile)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  for (int p = pieces; p < 3; ++p) qmaps[p] = qmaps[0];  // not read
  if (piece == 0 && (!encode_rows(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, N, D, kK1Rows) ||
                     !encode_vector(&bmap, bias, N, kK1Rows))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  K1RaggedArgs a;
  a.L = K1Layout(query_tile, pieces, resident, stages, D);
  a.part_s = splits == 1 ? out_s : work_s;
  a.part_i = splits == 1 ? out_i : work_i;
  a.bound = bound;
  a.B = B;
  a.N = N;
  a.k = k;
  a.rows_per_split = rows_per_split;
  a.resident = resident;
  a.stages = stages;
  a.rows = RaggedRows{static_cast<const unsigned char*>(x), 2ll * D, N, piece};
  a.bias = bias;
  const int grid_x = (B + query_tile - 1) / query_tile;
  cudaError_t err;
  switch (query_tile * 4 + pieces) {
#define CG_K1(QN, P)  \
  case QN * 4 + P: \
    err = launch_k1<QN, P>(qmaps, xmap, bmap, a, grid_x, splits, smem, piece != 0, st); \
    break;
    CG_K1(8, 1) CG_K1(16, 1) CG_K1(24, 1) CG_K1(32, 1)
    CG_K1(8, 3) CG_K1(16, 3) CG_K1(24, 3) CG_K1(32, 3)
#undef CG_K1
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  if (splits == 1) return 0;
  return (int)merge_splits(B, k, splits, group, out_s, out_i, work_s, work_i, st);
}

}  // extern "C"

// Exact streaming top-k over a device-resident bf16 corpus on Hopper's
// tensor cores: scores = q . x^T + bias, then the k best rows per query,
// sorted descending (a tie goes to the lower row id; (NEG_INF, -1) for rows
// past the live count). bf16 queries multiply the rows as they are (one
// piece: a product of bf16 values is exact in f32, summed in f32); an f32
// query multiplies them as its three bf16 pieces hi + mid + lo == q
// (ops/bf16_split.py `split_bf16`), three products into one f32
// accumulator, so its scores are those of the f32 query.
//
// Replaces, over bf16 rows, two Pallas kernels of codegraph_tpu/ops/topk.py:
//   K2  streaming_topk_pallas_qmajor / _flat_topk_qmajor_kernel  (:456)
//   K3  streaming_topk_pallas_qres   / _flat_topk_qres_kernel    (:561)
// Both compute dot_general(q, x_bf16, preferred_element_type=f32) + bias;
// K3 runs K2's schedule here, as it does in flat_topk.cu. f32 rows and K4
// (xt [D, N]) stay on flat_topk.cu's rows_pass1. One pass-1 kernel,
// bf16_tc_pass1<PIECES>, and the pass 2 of topk_merge.cuh.
//
// What bounds it on the H100:
//   * 2*B*N*D bf16 operations a piece: 1.57 TFLOP at B = 1024 over 1M x
//     768, 1.59 ms at the data sheet's 989 TFLOP/s for dense bf16 tensor
//     cores, 4.77 ms for an f32 query's three pieces;
//   * or the corpus bytes, read once a call: N*D*2 + 4N, 1.54 GB at 1M x
//     768, 0.46 ms at 3.35 TB/s, which bound it at B <= ~295 (one piece)
//     or ~98 (three).
//   Beside the products, each of the B*N scores costs one add and one
//   compare in the epilogue, and each score that may enter a top-k list
//   an offer and, every 32 of a row, a merge into the list in device
//   memory.
// What bf16_tc_pass1 does about it (int8_topk.cu's int8_tc_pass1, with a
// bf16 product and an f32 epilogue):
//   * wgmma.mma_async m64n128k16 f32.bf16.bf16 reads both operands from
//     shared memory (K-major, 128-byte swizzle: q [B, D] and x [N, D] are
//     already K-major) and keeps the f32 sums in registers.
//   * One producer warp keeps a ring of corpus boxes (128 rows x 64 bf16 of
//     depth, 16 KB, up to 6 stages) in flight by TMA (cp.async.bulk.tensor,
//     zero-filled past N and D) behind mbarrier full/empty pairs, and the
//     tiles' bias in a ring of its own; no block-wide barrier after set-up.
//   * Shared memory is what the bf16 tile changes: a 128-row query tile
//     is 192 KB at D = 768, which leaves no room for a ring. So the query
//     tile stays resident only where it fits beside at least 3 stages (a
//     64-row tile up to D = 1,216, a 128-row tile up to D = 576; three
//     pieces to a third of those depths), and otherwise its box streams
//     with each corpus box through the ring (32 KB a stage at 128 rows, 6
//     stages; 64 KB with three pieces, 3 stages); the query boxes of a
//     split's blocks are read from L2.
//   * Two consumer warpgroups take the two 64-row halves of the query tile
//     against each stage (a batch of <= 64: one warpgroup, a 64-row tile).
//     Each waits on the full barriers on its own and releases a stage
//     after its last wgmma on it, so one's epilogue overlaps the other's
//     products, as far as the ring lets them drift apart.
//   * The accumulator is mma.sync's fragment repeated: a thread holds query
//     rows g and g + 8 of its warp's 16, corpus rows 8j + 2t, +1. The
//     epilogue adds the bias as one __fadd_rn, as the plain version adds
//     it after the product, and compares each score against the row's
//     threshold (its list's k-th entry and the splits' shared bound); one
//     warp vote skips the offer for most tiles.
//   * The top-k lists live in the [B, S, k] split scratch. A score that may
//     enter goes to the row's candidate buffer in device memory, which
//     holds a whole tile beyond kCap entries, so the offer needs no capacity
//     check; after the tile, a row past kCap entries is merged into its list
//     out of line (sort_buffer, merge_sorted: topk_merge.cuh's merge with
//     the buffer ranked in one pass and the list's walk pipelined), which
//     raises its threshold, and the corpus splits of a row share a lower
//     bound of its k-th score (share_bound_inline). Shared memory is the
//     same for every k.
//   * Grid (query tiles, corpus splits), query tiles fastest, at most one
//     block per SM and one wave: the query tiles of a split read its corpus
//     from L2 within microseconds of each other, so the corpus comes from
//     HBM about once a call, and every split of a row runs at once, so the
//     shared bound holds from the first tiles.

#include "hopper_tc.cuh"

namespace {

constexpr int kBoxD = kBoxBytes / 2;  // depth of a box in bf16 elements
constexpr int kMetaSlotBytes = kWgN * sizeof(float);  // a tile's bias
// the block's shared memory (ops/topk.py `tc_smem` mirrors it)
using TcLayout = TcLayoutOf<kBoxD, kMetaSlotBytes>;

struct TcArgs {
  TcLayout L;  // read from the parameters: no registers
  float* part_s;  // [B, splits, k]
  int* part_i;
  float* bound;   // [B, S], NEG_INF at launch
  float* cand_s;  // [blocks][kTcSlots][kBufCap], the candidate buffers
  int* cand_i;
  int B, N, k, rows_per_split;
  int qt, resident, stages;
};

// d[64] += A (64 x 16 bf16, K-major, descriptor da) * B (128 x 16 bf16,
// K-major, descriptor db)^T in f32; scale_d = 0 overwrites d instead.
// Neither operand is negated (scale-a = scale-b = 1) or transposed.
__device__ __forceinline__ void wgmma_m64n128k16_bf16(float (&d)[64], uint64_t da, uint64_t db,
                                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// This lane's sums of round r = 2j + e (query rows g and g + 8, corpus row
// 8j + 2t + e). A switch on the warp-uniform r: an array in registers takes
// only compile-time indices, and this keeps the sums there.
__device__ __forceinline__ void round_sums(const float (&acc)[64], int r, float& s0, float& s1) {
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
        sort_buffer(stage_s, stage_i, n, hmask, l16);
        const size_t base = ((size_t)fb * S + lslot) * k;
        merge_sorted(stage_s, stage_i, n, part_s + base, part_i + base, k, st.len() + fr,
                     st.thr_s() + fr, st.thr_i() + fr, hmask, l16);
        share_bound_inline(part_s + base, k, bound + (size_t)fb * S, lslot, S, st.bnd() + fr, hmask,
                           l16);
        if (l16 == 0) st.cnt()[fr] = 0;
      }
      __syncwarp();
    }
  }
}

// Pass 1 of K2/K3 over bf16 rows: block (query tile of qt = 64 or 128
// rows, corpus split) -> the top-k of the split's rows for each query, in
// part_s/part_i [B, S, k]. Warps 0-7 are the consumer warpgroups, warp 8
// the producer (one thread issues the copies); 168 registers a thread, as
// int8_tc_pass1. Consumer w computes query rows 64w .. 64w + 63 of the tile
// against each 128-row corpus stage; a 64-row tile has one consumer.
// qmap / xmap: q [B, D] and x [N, D] bf16 as boxes of 64 depths x qt / 128
// rows; bmap: bias [N] as boxes of 128. PIECES = 3: an f32 query as its
// bf16 pieces hi (qmap), mid (qmap_mid) and lo (qmap_lo), hi + mid + lo ==
// q exactly; each corpus box meets the three query boxes of its depth, three
// wgmma chains into the one f32 accumulator, so the sums are those of the
// f32 query's products (each piece times a bf16 value is exact in f32).
template <int PIECES>
__global__ void __launch_bounds__(kTcThreads, 1)
    bf16_tc_pass1(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap bmap, const TcArgs a,
                  const __grid_constant__ CUtensorMap qmap_mid,
                  const __grid_constant__ CUtensorMap qmap_lo) {
  static_assert(PIECES == 1 || PIECES == 3, "a bf16 query, or an f32 query's three pieces");
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

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 4 * consumers);  // lane 0 of each consumer warp
    }
    mbar_init(q_bar, 1);
    for (int s = 0; s < kMetaSlots; ++s) {
      mbar_init(meta_full + 8 * s, 1);
      mbar_init(meta_empty + 8 * s, 4 * consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kTcConsumers) {
    // ---- producer: the query tile once (if resident), then the ring ----
    if (tid == kTcConsumers * 128) {
      if (a.resident) {
        mbar_expect_tx(q_bar, L.query_bytes);
        for (int c = 0; c < L.chunks; ++c) {
          tma_load(qtile + c * a.qt * kBoxBytes, &qmap, q_bar, c * kBoxD, b0);
          if constexpr (PIECES == 3) {  // each piece's boxes chunks boxes after the last's
            tma_load(qtile + (L.chunks + c) * a.qt * kBoxBytes, &qmap_mid, q_bar, c * kBoxD, b0);
            tma_load(qtile + (2 * L.chunks + c) * a.qt * kBoxBytes, &qmap_lo, q_bar, c * kBoxD, b0);
          }
        }
      }
      int slot = 0;
      uint32_t phase = 0;
      for (int n0 = n_begin, tile = 0; n0 < n_end; n0 += kWgN, ++tile) {
        const int m = tile % kMetaSlots;  // the tile's bias
        mbar_wait(meta_empty + 8 * m, ((tile / kMetaSlots) & 1) ^ 1);
        mbar_expect_tx(meta_full + 8 * m, kMetaSlotBytes);
        tma_load_1d(meta + m * kMetaSlotBytes, &bmap, meta_full + 8 * m, n0);
        for (int c = 0; c < L.chunks; ++c) {
          mbar_wait(empty_bar + 8 * slot, phase ^ 1);
          mbar_expect_tx(full_bar + 8 * slot, L.stage_bytes);
          const uint32_t st = ring + slot * L.stage_bytes;
          tma_load(st, &xmap, full_bar + 8 * slot, c * kBoxD, n0);
          if (!a.resident) {
            tma_load(st + L.corpus_bytes, &qmap, full_bar + 8 * slot, c * kBoxD, b0);
            if constexpr (PIECES == 3) {  // each piece's box one box after the last's
              tma_load(st + L.corpus_bytes + a.qt * kBoxBytes, &qmap_mid, full_bar + 8 * slot,
                       c * kBoxD, b0);
              tma_load(st + L.corpus_bytes + 2 * a.qt * kBoxBytes, &qmap_lo, full_bar + 8 * slot,
                       c * kBoxD, b0);
            }
          }
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
    unsigned live = 0;  // bit h: query row g + 8h of the warp exists
#pragma unroll
    for (int h = 0; h < 2; ++h) live |= (wb + g + 8 * h < a.B ? 1u : 0u) << h;
    const float above_neg_inf = __int_as_float(__float_as_int(kNegInf) - 1);

    if (a.resident) mbar_wait(q_bar, 0);
    float acc[64];
    int slot = 0;
    uint32_t phase = 0;
#pragma unroll 1
    for (int n0 = n_begin, tile = 0; n0 < n_end; n0 += kWgN, ++tile) {
      // the products: 4 k16 steps per stage, one stage's group in flight
      // while the next stage is awaited
      int prev = -1;
      fence_operands(acc);
#pragma unroll 1
      for (int c = 0; c < L.chunks; ++c) {
        mbar_wait(full_bar + 8 * slot, phase);
        const uint32_t stage = ring + slot * L.stage_bytes;
        const uint32_t qa = (a.resident ? qtile + c * a.qt * kBoxBytes : stage + L.corpus_bytes) +
                            wg * kWgM * kBoxBytes;
        const uint64_t da = smem_desc(qa), db = smem_desc(stage);
        wgmma_fence();
        if constexpr (PIECES == 1) {
#pragma unroll
          for (int kk = 0; kk < kBoxBytes / 32; ++kk) {
            wgmma_m64n128k16_bf16(acc, da + 2 * kk, db + 2 * kk, (c | kk) != 0);
          }
        } else {
          // a piece's boxes follow the one before: chunks boxes further on
          // when resident, one box when streamed
          const uint64_t dp = (a.resident ? L.chunks * a.qt * kBoxBytes : a.qt * kBoxBytes) >> 4;
#pragma unroll
          for (int kk = 0; kk < kBoxBytes / 32; ++kk) {
#pragma unroll
            for (int p = PIECES - 1; p >= 0; --p) {  // the smallest piece first
              wgmma_m64n128k16_bf16(acc, da + p * dp + 2 * kk, db + 2 * kk,
                                    (c | kk) != 0 || p != PIECES - 1);
            }
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
      fence_operands(acc);
      if (lane == 0) mbar_arrive(empty_bar + 8 * prev);
      // the tile's bias (zero past N), as pairs: n-tile j holds corpus
      // rows 8j + 2t, +1
      const int m = tile % kMetaSlots;
      mbar_wait(meta_full + 8 * m, (tile / kMetaSlots) & 1);
      const float* bs_t = reinterpret_cast<const float*>(sp + L.meta_off + m * kMetaSlotBytes);
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
        const float2 bp = reinterpret_cast<const float2*>(bs_t)[4 * j + t];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float b = e ? bp.y : bp.x;
          const float s0 = __fadd_rn(acc[4 * j + e], b);
          const float s1 = __fadd_rn(acc[4 * j + 2 + e], b);
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
        unsigned rm = rounds;
#pragma unroll 1
        while (rm) {  // warp-uniform
          const int r = __ffs(rm) - 1;
          rm &= rm - 1;
          const int n = n0 + 8 * (r >> 1) + 2 * t + (r & 1);
          const bool mine = (hit >> r) & 1u;
          float s0 = 0.f, s1 = 0.f;
          round_sums(acc, r, s0, s1);
          const float b = bs_t[8 * (r >> 1) + 2 * t + (r & 1)];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float s = __fadd_rn(h ? s1 : s0, b);
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

}  // namespace

extern "C" {

// Scratch entries (per scores and per ids) of the per-split lists and the
// first merge level for `splits` corpus splits.
long long flat_topk_tc_work_entries(int B, int k, int splits, int group) {
  return merge_work_entries(B, k, splits, group);
}

// Candidate buffer entries (per scores and per ids): a kBufCap-entry
// buffer for each of a block's kTcSlots rows.
long long flat_topk_tc_cand_entries(int B, int query_tile, int splits) {
  if (query_tile < 1) return 0;
  return (long long)((B + query_tile - 1) / query_tile) * splits * kTcSlots * kBufCap;
}

// Shared memory (bytes) of bf16_tc_pass1 for a query tile of query_tile
// (64 or 128) rows in `pieces` (1: bf16 queries; 3: f32 queries as bf16
// pieces) parts, a resident or streamed query tile, `stages` ring stages
// and depth D; 0 for a tile it does not take.
long long flat_topk_tc_smem(int query_tile, int resident, int stages, int D, int pieces) {
  if ((query_tile != kWgM && query_tile != 2 * kWgM) || stages < 1 || D < 1 ||
      (pieces != 1 && pieces != 3)) {
    return 0;
  }
  return (long long)TcLayout(query_tile, resident, stages, D, pieces).smem;
}

// K2/K3 over bf16 rows: bf16_tc_pass1 over grid (ceil(B / query_tile),
// splits), then pass 2. q [pieces, B, D] bf16 (pieces = 1: bf16 queries;
// 3: an f32 query's split_bf16 pieces hi, mid, lo), x [N, D] bf16, bias
// [N] f32, all
// contiguous on the device of `stream` and 16-byte aligned, D % 8 == 0
// (TMA's strides and addresses). query_tile: 64 or 128; the query tile is
// resident (resident = 1) or streams with the corpus through the ring of
// `stages`; rows_per_split a multiple of 128; smem must equal
// flat_topk_tc_smem(..., pieces). out_s [B, k] f32 and out_i [B, k] i32; work_s /
// work_i hold flat_topk_tc_work_entries(B, k, splits, group) entries each
// and bound B * splits, set to NEG_INF (-1e30); cand_s / cand_i hold
// flat_topk_tc_cand_entries(B, query_tile, splits) entries each (no
// initial value). Returns the CUDA error code of the launches (0 =
// success).
int flat_topk_tc(const void* q, int pieces, const void* x, const float* bias, int B, int N, int D,
                 int k, int query_tile, int resident, int stages, int splits, int rows_per_split,
                 long long smem, int group, float* out_s, int* out_i, float* work_s, int* work_i,
                 float* bound, float* cand_s, int* cand_i, void* stream) {
  if (B < 1 || N < 1 || D < 8 || D % 8 != 0 || k < 1 || k > 1024 || splits < 1 || group < 2 ||
      stages < 2 || rows_per_split < 1 || rows_per_split % kWgN != 0 ||
      (long long)splits * rows_per_split < N || (long long)(splits - 1) * rows_per_split >= N ||
      (reinterpret_cast<size_t>(q) & 15) != 0 || (reinterpret_cast<size_t>(x) & 15) != 0 ||
      (reinterpret_cast<size_t>(bias) & 15) != 0 ||
      smem != flat_topk_tc_smem(query_tile, resident, stages, D, pieces) || smem > 232448) {
    return (int)cudaErrorInvalidValue;
  }
  // one map a piece, each B rows (zeros past B), piece p at p * B * D
  CUtensorMap qmaps[3], xmap, bmap;
  for (int p = 0; p < pieces; ++p) {
    const void* qp = static_cast<const unsigned short*>(q) + (size_t)p * B * D;
    if (!encode_rows(&qmaps[p], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, qp, B, D, query_tile)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  for (int p = pieces; p < 3; ++p) qmaps[p] = qmaps[0];  // not read
  if (!encode_rows(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, N, D, kWgN) ||
      !encode_vector(&bmap, bias, N, kWgN)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  TcArgs a;
  a.L = TcLayout(query_tile, resident, stages, D, pieces);
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
  auto kern = pieces == 1 ? bf16_tc_pass1<1> : bf16_tc_pass1<3>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((B + query_tile - 1) / query_tile, splits), kTcThreads, (size_t)smem, st>>>(
      qmaps[0], xmap, bmap, a, qmaps[1], qmaps[2]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (splits == 1) return 0;
  return (int)merge_splits(B, k, splits, group, out_s, out_i, work_s, work_i, st);
}

}  // extern "C"

// The exact top-k merge shared by the port's scan kernels (flat_topk.cu,
// int8_topk.cu): per-row sorted lists in shared memory fed by a warp ballot
// against the row's k-th entry (K1, K5); per-row lists in device memory fed
// from candidate buffers, with a bound shared by the corpus splits (K2-K4,
// K6, K7); and a second pass that merges the per-split lists of a query row
// in levels.
//
// Order: a candidate (s1, i1) beats (s2, i2) when s1 > s2, or s1 == s2 and
// i1 < i2 (the lower row id wins a tie). Lists start as (NEG_INF, -1), so a
// row whose score is NEG_INF or below (a tombstone) never enters, and rows
// past the live count come out as (NEG_INF, -1), like the TPU kernels.
//
// Each including source gets its own copy (everything is in an anonymous
// namespace); the files share the algorithm, not a symbol.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMergeWarps = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool beats(float s1, int i1, float s2, int i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

// Insert (cs, ci) into a warp-owned sorted list of length k. The caller has
// checked that the candidate beats ls[k-1]. The entries that beat the
// candidate form a prefix; for k <= 1024 its length is found in two ballots
// (32 samples, then the one segment of at most 32), for larger k by a
// binary search that every lane runs on the same entries. Then the tail
// shifts down one slot, high to low.
__device__ void warp_insert(float* ls, int* li, int k, float cs, int ci, int lane) {
  int pos;
  if (k <= 32 * 32) {
    const int seg = (k + 31) / 32;
    const int e = min(k - 1, (lane + 1) * seg - 1);
    const int c1 = __popc(__ballot_sync(kFull, beats(ls[e], li[e], cs, ci)));
    const int base = c1 * seg;
    const int p2 = base + lane;
    const bool in2 = lane < seg && p2 < k && beats(ls[p2], li[p2], cs, ci);
    pos = base + __popc(__ballot_sync(kFull, in2));
  } else {
    int lo = 0, hi = k;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (beats(ls[mid], li[mid], cs, ci)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    pos = lo;
  }
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

// Scratch entries (per scores and per ids) that a scan over `splits` corpus
// splits needs: the per-split lists [B, splits, k] and room for the first
// merge level.
long long merge_work_entries(int B, int k, int splits, int group) {
  if (splits <= 1) return 0;
  return (long long)B * k * (splits + (splits + group - 1) / group);
}

// Pass 2: merge the per-split lists [B, splits, k] that pass 1 wrote at the
// start of work_s / work_i into out_s / out_i [B, k], in levels of `group`
// lists per warp that ping-pong between the two halves of the scratch.
cudaError_t merge_splits(int B, int k, int splits, int group, float* out_s, int* out_i,
                         float* work_s, int* work_i, cudaStream_t st) {
  const size_t msmem = (size_t)kMergeWarps * 3 * k * (sizeof(float) + sizeof(int));
  cudaError_t err =
      cudaFuncSetAttribute(topk_merge, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)msmem);
  if (err != cudaSuccess) return err;
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
    if (err != cudaSuccess) return err;
    alt_s = src_s;
    alt_i = src_i;
    src_s = dst_s;
    src_i = dst_i;
    S = S_out;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// The lists in device memory (K2-K4 rows_pass1, K6/K7 int8_tc_pass1): a query
// row's list is its split's slot of the [B, S, k] scratch, fed from a
// kCap-entry candidate buffer in shared memory by flush_row, and the splits
// of a row share a lower bound of its k-th score (share_bound).
// ---------------------------------------------------------------------------

constexpr int kCap = 32;  // candidate buffer entries per query row

// Entries of the sorted buffer (bs, bi)[0, n) that beat (s, id)
__device__ __forceinline__ int count_beating(const float* bs, const int* bi, int n, float s, int id) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (beats(bs[mid], bi[mid], s, id)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Merge a query row's n <= Cap buffered candidates (bs, bi; each beats the
// list's k-th entry) into its sorted list (ls, li) of k entries in device
// memory, run by the 16 lanes of the row's half-warp (hmask). The buffer is
// sorted by rank; then the list is walked from its end in rounds of 64
// positions: an entry at p moves to p + (buffer entries that beat it), the
// buffer entries ranked [c(p-1), c(p)) land at rank + p, and the walk stops
// below the first position no buffer entry beats. It starts at the list's
// live length *len plus n: the positions past it stay (NEG_INF, -1). The
// new k-th entry goes to (*ts, *ti).
template <int Cap>
__device__ __forceinline__ void flush_row_inline(float* bs, int* bi, int n, float* ls, int* li,
                                                int k, int* len, float* ts, int* ti,
                                                unsigned hmask, int l16) {
  __syncwarp(hmask);
  constexpr int E = (Cap + 15) / 16;  // buffer entries a lane ranks
  float es[E];
  int ei[E], rk[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int idx = l16 + 16 * e;
    rk[e] = -1;
    if (idx < n) {
      es[e] = bs[idx];
      ei[e] = bi[idx];
      int r = 0;
      for (int f = 0; f < n; ++f) r += beats(bs[f], bi[f], es[e], ei[e]);
      rk[e] = r;
    }
  }
  __syncwarp(hmask);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (rk[e] >= 0) {
      bs[rk[e]] = es[e];
      bi[rk[e]] = ei[e];
    }
  }
  __syncwarp(hmask);

  // positions past len + n hold (NEG_INF, -1) before and after
  const int top = min(k, *len + n);
  __syncwarp(hmask);
  if (l16 == 0) *len = top;
  for (int hi = top; hi > 0;) {
    const int lo = max(0, hi - 64);
    float ps[4];
    int pi[4], cp[4], cq[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = lo + l16 + 16 * u;
      cp[u] = n;
      if (p < hi) {
        ps[u] = __ldcg(ls + p);
        pi[u] = __ldcg(li + p);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (lo + l16 + 16 * u < hi) cp[u] = count_beating(bs, bi, n, ps[u], pi[u]);
    }
    int below = 0;  // c(lo - 1)
    if (l16 == 0 && lo > 0) below = count_beating(bs, bi, n, __ldcg(ls + lo - 1), __ldcg(li + lo - 1));
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int up = __shfl_up_sync(hmask, cp[u], 1, 16);
      const int last = __shfl_sync(hmask, cp[u > 0 ? u - 1 : 0], 15, 16);
      cq[u] = l16 > 0 ? up : (u > 0 ? last : below);
    }
    below = __shfl_sync(hmask, below, 0, 16);
    __syncwarp(hmask);  // every read of this round is done
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = lo + l16 + 16 * u;
      if (p >= hi) continue;
      const int c = cp[u];
      if (c > 0 && p + c < k) {
        __stcg(ls + p + c, ps[u]);
        __stcg(li + p + c, pi[u]);
        if (p + c == k - 1) {
          *ts = ps[u];
          *ti = pi[u];
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
  }
}

// The bound that corpus splits share for one query row (a half-warp's
// row): each split publishes the j-th score of its list, j = ceil(k / S),
// in bound[split]; the smallest published score t has at least j * S >= k
// rows scoring t or more, so the row's global k-th score is at least t and
// a score below t can be in no list that pass 2 keeps. A published score
// only rises and a 4-byte store is read whole, so a stale read is a lower
// bound too: the splits need neither atomics nor order. The bounds are
// read and written relaxed at GPU scope, since other blocks write them
// while this one runs. The new bound goes to *lb.
__device__ __forceinline__ void st_relaxed(float* p, float v) {
  asm volatile("st.relaxed.gpu.f32 [%0], %1;\n" ::"l"(p), "f"(v) : "memory");
}
__device__ __forceinline__ float ld_relaxed(const float* p) {
  float v;
  asm volatile("ld.relaxed.gpu.f32 %0, [%1];\n" : "=f"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void share_bound_inline(const float* ls, int k, float* bound, int split,
                                                  int S, float* lb, unsigned hmask, int l16) {
  const int j = (k + S - 1) / S;
  if (l16 == 0) st_relaxed(bound + split, __ldcg(ls + j - 1));
  float m = 3.0e38f;
  for (int s = l16; s < S; s += 64) {  // four loads in flight a lane
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = s + 16 * u < S ? ld_relaxed(bound + s + 16 * u) : 3.0e38f;
#pragma unroll
    for (int u = 0; u < 4; ++u) m = fminf(m, v[u]);
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) m = fminf(m, __shfl_xor_sync(hmask, m, off, 16));
  if (l16 == 0) *lb = m;
  __syncwarp(hmask);
}

// The out-of-line copies, for call sites where few registers are live (an
// inline copy, where a kernel holds its sums in registers across a flush).
__device__ __noinline__ void flush_row(float* bs, int* bi, int n, float* ls, int* li, int k,
                                       int* len, float* ts, int* ti, unsigned hmask, int l16) {
  flush_row_inline<kCap>(bs, bi, n, ls, li, k, len, ts, ti, hmask, l16);
}
__device__ __noinline__ void share_bound(const float* ls, int k, float* bound, int split, int S,
                                         float* lb, unsigned hmask, int l16) {
  share_bound_inline(ls, k, bound, split, S, lb, hmask, l16);
}

}  // namespace

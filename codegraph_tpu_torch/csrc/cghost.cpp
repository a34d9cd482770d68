// Host library of the PyTorch port: a copy of native/cghost.cpp's
// cg_abi_version, cg_padded_adjacency, cg_trigram_preselect and
// cg_bm25_score, with the same semantics (ties, truncation at max_deg, f32
// scores; the one change, `empty` below, keeps them), so that the port runs
// the same compiled host loops as the JAX package beside the card:
// padded-adjacency construction for the graph boost, trigram-jaccard symbol
// preselection for edge resolution (indexer.rs:2673-2900) and batched BM25
// scoring.
//
// Left out: cg_chunk_boundaries, which no caller of either package uses,
// and cg_ivf_spill_fill, whose port is csrc/ivf_spill.cu.
//
// Built with g++ at first use into codegraph_tpu_torch/_build/
// (ops/cuda_build.py build_host); bound in codegraph_tpu_torch/native.py.
// Each function's plain version is the Python loop beside its caller.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <unordered_set>
#include <vector>

// Empty a hash container in O(its size). clear() also zeroes every bucket,
// O(bucket_count), and a container keeps the buckets of the largest row it
// ever held, so in native/cghost.cpp every row after a hub of degree d pays
// O(d) (minutes at a million nodes). Erasing element by element leaves the
// same state as clear() -- the same bucket count, every bucket empty -- so
// later rows iterate, and order their ties, exactly as native/cghost.cpp's.
template <class C>
static void empty(C& c) {
  for (auto it = c.begin(); it != c.end();) it = c.erase(it);
}

extern "C" {

// Bumped whenever an exported signature changes (native/cghost.cpp's
// number, which the port's bindings check).
int64_t cg_abi_version() { return 2; }

// ---------------------------------------------------------------------------
// Padded adjacency: forward+reverse CSR -> [n, max_deg] neighbor/weight
// table for the device boost kernel (graph/csr.py padded_adjacency).
// Union of out- and in-edges filtered by etype membership; dedup keeps the
// max-weight copy; neighbors kept highest-weight-first.
// ---------------------------------------------------------------------------
// out_et / out_dir carry the edge evidence the reference's schema joins
// onto every search hit (schema/codegraph.surql:481-536): edge type code
// and direction (0 = outgoing, 1 = incoming; outgoing wins on a tie so a
// mutual edge reads "calls" rather than "called by").
struct AdjBest { float w; int16_t et; int8_t dir; };

void cg_padded_adjacency(
    int64_t n_nodes,
    const int64_t* indptr, const int32_t* indices,
    const int16_t* etype, const float* weight,
    const int64_t* r_indptr, const int32_t* r_indices,
    const int16_t* r_etype, const float* r_weight,
    const int16_t* keep_etypes, int64_t n_keep,
    int64_t max_deg,
    int32_t* out_nbr,   // [n_nodes * max_deg], pre-filled with -1
    float* out_wgt,     // [n_nodes * max_deg], pre-filled with 0
    int16_t* out_et,    // [n_nodes * max_deg], pre-filled with -1
    int8_t* out_dir)    // [n_nodes * max_deg], pre-filled with 0
{
  std::unordered_set<int16_t> keep(keep_etypes, keep_etypes + n_keep);
  std::vector<std::pair<float, int32_t>> cand;
  std::unordered_map<int32_t, AdjBest> best;
  for (int64_t row = 0; row < n_nodes; ++row) {
    empty(best);
    for (int64_t j = indptr[row]; j < indptr[row + 1]; ++j) {
      if (!keep.count(etype[j])) continue;
      auto it = best.find(indices[j]);
      if (it == best.end() || weight[j] > it->second.w)
        best[indices[j]] = {weight[j], etype[j], 0};
    }
    for (int64_t j = r_indptr[row]; j < r_indptr[row + 1]; ++j) {
      if (!keep.count(r_etype[j])) continue;
      auto it = best.find(r_indices[j]);
      if (it == best.end() || r_weight[j] > it->second.w)
        best[r_indices[j]] = {r_weight[j], r_etype[j], 1};
    }
    if (best.empty()) continue;
    cand.clear();
    cand.reserve(best.size());
    for (auto& kv : best) cand.emplace_back(kv.second.w, kv.first);
    int64_t m = std::min<int64_t>((int64_t)cand.size(), max_deg);
    std::partial_sort(cand.begin(), cand.begin() + m, cand.end(),
                      [](auto& a, auto& b) { return a.first > b.first; });
    for (int64_t k = 0; k < m; ++k) {
      const AdjBest& ab = best[cand[k].second];
      out_nbr[row * max_deg + k] = cand[k].second;
      out_wgt[row * max_deg + k] = cand[k].first;
      out_et[row * max_deg + k] = ab.et;
      out_dir[row * max_deg + k] = ab.dir;
    }
  }
}

// ---------------------------------------------------------------------------
// Trigram-jaccard preselection (indexer.rs:2673 trigram preselect).
// Strings are packed: one UTF-8 buffer + offsets [n+1]. For each target,
// emit the top-j symbol indices with jaccard >= threshold (or -1 padding).
// Trigrams are the 32-bit FNV-1a hashes of each 3-byte window (a string of
// at most 2 bytes is one "trigram", its own hash), case kept.
// ---------------------------------------------------------------------------
static void collect_trigrams(const char* s, int64_t len,
                             std::unordered_set<uint32_t>& out) {
  if (len <= 2) {
    uint32_t h = 2166136261u;
    for (int64_t i = 0; i < len; ++i) h = (h ^ (uint8_t)s[i]) * 16777619u;
    out.insert(h);
    return;
  }
  for (int64_t i = 0; i + 2 < len; ++i) {
    uint32_t h = 2166136261u;
    for (int64_t k = 0; k < 3; ++k) h = (h ^ (uint8_t)s[i + k]) * 16777619u;
    out.insert(h);
  }
}

void cg_trigram_preselect(
    const char* target_buf, const int64_t* target_off, int64_t n_targets,
    const char* symbol_buf, const int64_t* symbol_off, int64_t n_symbols,
    double threshold, int64_t top_j,
    int32_t* out_idx,    // [n_targets * top_j], pre-filled with -1
    float* out_score)    // [n_targets * top_j], pre-filled with 0
{
  std::vector<std::unordered_set<uint32_t>> sym_tris(n_symbols);
  for (int64_t s = 0; s < n_symbols; ++s)
    collect_trigrams(symbol_buf + symbol_off[s],
                     symbol_off[s + 1] - symbol_off[s], sym_tris[s]);

  // inverted index trigram -> symbols for sub-linear candidate lookup
  std::unordered_map<uint32_t, std::vector<int32_t>> inv;
  for (int64_t s = 0; s < n_symbols; ++s)
    for (uint32_t t : sym_tris[s]) inv[t].push_back((int32_t)s);

  std::unordered_set<uint32_t> tgt;
  std::unordered_map<int32_t, int32_t> overlap;
  std::vector<std::pair<float, int32_t>> scored;
  for (int64_t i = 0; i < n_targets; ++i) {
    empty(tgt);
    collect_trigrams(target_buf + target_off[i],
                     target_off[i + 1] - target_off[i], tgt);
    empty(overlap);
    for (uint32_t t : tgt) {
      auto it = inv.find(t);
      if (it == inv.end()) continue;
      for (int32_t s : it->second) overlap[s]++;
    }
    scored.clear();
    for (auto& kv : overlap) {
      int64_t uni = (int64_t)tgt.size() + (int64_t)sym_tris[kv.first].size()
                    - kv.second;
      float j = uni > 0 ? (float)kv.second / (float)uni : 0.0f;
      if (j >= threshold) scored.emplace_back(j, kv.first);
    }
    int64_t m = std::min<int64_t>((int64_t)scored.size(), top_j);
    std::partial_sort(scored.begin(), scored.begin() + m, scored.end(),
                      [](auto& a, auto& b) { return a.first > b.first; });
    for (int64_t k = 0; k < m; ++k) {
      out_idx[i * top_j + k] = scored[k].second;
      out_score[i * top_j + k] = scored[k].first;
    }
  }
}

// ---------------------------------------------------------------------------
// BM25 batch scoring over packed postings (search/bm25.py search()).
// Postings packed as CSR over query terms: for each query term t
// (t in [0, n_terms)), docs[post_off[t]:post_off[t+1]] with tfs aligned.
// doc_len maps doc id -> length. Standard Okapi k1/b.
// Emits the top_n (doc, score) pairs, score-descending.
// ---------------------------------------------------------------------------
int64_t cg_bm25_score(
    const int64_t* post_off, const int32_t* post_doc, const int32_t* post_tf,
    int64_t n_terms,
    const int32_t* doc_len, int64_t n_docs, double avg_len,
    double k1, double b, int64_t top_n,
    int32_t* out_doc, float* out_score)  // [top_n]
{
  std::unordered_map<int32_t, double> scores;
  for (int64_t t = 0; t < n_terms; ++t) {
    int64_t df = post_off[t + 1] - post_off[t];
    if (df == 0) continue;
    double idf = std::log(1.0 + ((double)n_docs - df + 0.5) / (df + 0.5));
    for (int64_t j = post_off[t]; j < post_off[t + 1]; ++j) {
      int32_t d = post_doc[j];
      double tf = post_tf[j];
      double denom = tf + k1 * (1.0 - b + b * doc_len[d] / avg_len);
      scores[d] += idf * tf * (k1 + 1.0) / denom;
    }
  }
  std::vector<std::pair<float, int32_t>> ranked;
  ranked.reserve(scores.size());
  for (auto& kv : scores) ranked.emplace_back((float)kv.second, kv.first);
  int64_t m = std::min<int64_t>((int64_t)ranked.size(), top_n);
  std::partial_sort(ranked.begin(), ranked.begin() + m, ranked.end(),
                    [](auto& a, auto& b2) { return a.first > b2.first; });
  for (int64_t k = 0; k < m; ++k) {
    out_doc[k] = ranked[k].second;
    out_score[k] = ranked[k].first;
  }
  return m;
}

}  // extern "C"

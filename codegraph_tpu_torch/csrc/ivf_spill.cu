// Capacity-bounded IVF cell placement, compiled: the host loop of
// codegraph_tpu/index/ivf.py IVFIndex.add (lines 304-323; the JAX package
// runs it in its g++ library, native/cghost.cpp, where one is built).
//
// Not a device kernel: the placement is sequential in the fill state, so it
// stays on the host. In Python the loop costs tens of microseconds a row
// (minutes at 10M rows); compiled it costs nanoseconds. The Python loop
// (spill_assign in index/ivf.py) is its plain version; chip_smoke.py holds
// the two equal on a corpus whose cells overflow.

#include <cstdint>

extern "C" {

// top2 [n, 2] int32 (first and second choice per row), fill [nfill] int64
// updated in place. Row j goes to its first choice if that cell holds fewer
// than cap rows, else to its second choice if that one does, else to the
// least-filled cell (the lowest index among equals). Writes cell and position
// per row. Returns 0, or -1 if a choice lies outside [0, nfill).
int ivf_spill_fill(const int32_t* top2, long long n, int64_t* fill, long long nfill, long long cap,
                   int64_t* cell_out, int64_t* pos_out) {
  for (long long j = 0; j < n; ++j) {
    long long c = top2[2 * j];
    if (c < 0 || c >= nfill) return -1;
    if (fill[c] >= cap) {
      const long long c2 = top2[2 * j + 1];
      if (c2 < 0 || c2 >= nfill) return -1;
      if (fill[c2] < cap) {
        c = c2;
      } else {
        long long best = 0;
        for (long long i = 1; i < nfill; ++i) {
          if (fill[i] < fill[best]) best = i;
        }
        c = best;
      }
    }
    cell_out[j] = c;
    pos_out[j] = fill[c];
    fill[c] += 1;
  }
  return 0;
}

}  // extern "C"

// The decoder's symbol search for Hopper: the exact bisection, its probe
// replay and the warp row count.  Shared by the full-stream decode
// (rans_decode_lanes.cu, B3/B4) and the decode step (rans_decode_step.cu,
// B2); header-only, device code.
//
// The normative search (repro_torch/core/search.py) tries the candidates
// (one probe each while unresolved), verifies the predictor's window (one
// probe while unresolved), then bisects with the cdf[mid] == slot early
// commit, one probe per active iteration.  When the CDF is strictly
// increasing (every frequency >= 1, as every SPC table has) and the symbol
// x with cdf[x] <= slot < cdf[x+1] exists, each of those tests is a pure
// integer function of x and of at_start = (slot == cdf[x]):
//   a candidate c hits iff clip(c, 0, K-1) == x;
//   the window hits iff lo_w <= x < hi_w;
//   a bisection step goes right iff mid <= x, and commits iff mid == x and
//   at_start.
// So the search leaves the state's dependent chain: the symbol comes from a
// slot table or a warp-wide row test, and the probes are replayed from x.
// The bisection is translation invariant ((lo + hi) >> 1 == lo + (w >> 1)
// for w = hi - lo), so its probe count depends on (w, x - lo, at_start)
// alone.  A table with a zero frequency breaks the identity, so callers
// check the row and run exact_search() on it instead.

#pragma once

#include <cstdint>

namespace decode_search {

constexpr unsigned kFullMask = 0xffffffffu;

// A CDF row in device memory, read through the read-only cache.
struct GlobalCdf {
  const uint32_t* cd;
  __device__ __forceinline__ uint32_t operator()(int i) const {
    return __ldg(cd + i);
  }
};

// Active bisection iterations from [lo, lo + w) down to lo + off.
__device__ __forceinline__ int bisect_probes(int w, int off, bool at_start) {
  int p = 0;
  while (w > 1) {
    const int mid = w >> 1;
    ++p;
    if (off >= mid) {
      off -= mid;
      w = (at_start && off == 0) ? 1 : w - mid;
    } else {
      w = mid;
    }
  }
  return p;
}

// The loop form of the depth function replay_probes() takes.
struct LoopDepth {
  __device__ __forceinline__ int operator()(int w, int off, bool at) const {
    return bisect_probes(w, off, at);
  }
};

// Probes of the normative search for symbol x, given the candidate probes
// already charged (cand_probes, found = a candidate hit) and the window
// [lo_w, hi_w) when a predictor runs.  `depth(w, off, at_start)` is
// bisect_probes or a table of it.  Written without branches so that the
// caller's scheduler can interleave it with the state's chain.
template <typename Depth>
__device__ __forceinline__ int replay_probes(int x, bool at_start,
                                             int cand_probes, bool found,
                                             bool window, int lo_w, int hi_w,
                                             int k, const Depth& depth) {
  const bool hit = window && lo_w <= x && x < hi_w;
  const int lo = hit ? lo_w : 0;
  const int w = hit ? hi_w - lo_w : k;
  const int bis = depth(w, x - lo, at_start);
  return found ? cand_probes : cand_probes + (window ? 1 : 0) + bis;
}

// Candidate probes of one thread: the first candidate (clipped) equal to x
// resolves the search; every candidate tried before costs one probe.
__device__ __forceinline__ int thread_cand_probes(const int32_t* row,
                                                  int topk, int k, int x,
                                                  bool& found) {
  found = false;
  for (int j = 0; j < topk; ++j) {
    if (min(max(row[j], 0), k - 1) == x) {
      found = true;
      return j + 1;
    }
  }
  return topk;
}

// Candidate probes of a warp that owns one cell: lane j holds candidate
// `base + j` of the row for each group of 32 (cands_row must be readable
// for j < topk).  Every lane returns the same count.
__device__ __forceinline__ int warp_cand_probes(const int32_t* row, int topk,
                                                int k, int x, int first,
                                                bool& found) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < topk; base += 32) {
    const int j = base + lane;
    const int c = base == 0 ? first : (j < topk ? row[j] : -1);
    const unsigned hit = __ballot_sync(
        kFullMask, j < topk && min(max(c, 0), k - 1) == x);
    if (hit) {
      found = true;
      return base + __ffs(hit);
    }
  }
  found = false;
  return topk;
}

// The exact search of core/search.py on any CDF: candidates, window, then
// the masked bisection of n_iter iterations with the early commit.
// `cdf(i)` reads entry i.  Returns x and adds its probes.
template <typename Cdf>
__device__ __forceinline__ int exact_search(const Cdf& cdf, uint32_t slot,
                                            int k, int n_iter,
                                            const int32_t* cands, int topk,
                                            bool window, int lo_w, int hi_w,
                                            int& probes) {
  bool found = false;
  int x_spec = 0;
  for (int j = 0; j < topk; ++j) {
    const int cand = min(max(cands[j], 0), k - 1);
    const bool ok = cdf(cand) <= slot && slot < cdf(cand + 1);
    if (!found) {
      ++probes;
      if (ok) x_spec = cand;
    }
    found = found || ok;
  }
  int lo = 0;
  int hi = k;
  if (window && !found) {
    ++probes;
    if (cdf(lo_w) <= slot && slot < cdf(hi_w)) {
      lo = lo_w;
      hi = hi_w;
    }
  }
  if (found) {
    lo = x_spec;
    hi = x_spec + 1;
  }
  for (int it = 0; it < n_iter; ++it) {
    if (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      const uint32_t c_mid = cdf(mid);
      if (c_mid <= slot) {
        lo = mid;
        if (c_mid == slot) hi = mid + 1;
      } else {
        hi = mid;
      }
      ++probes;
    }
  }
  return lo;
}

// Warp row search: one warp owns a cell and tests a row of K entries, 32
// lanes at a time.  For the entries e = base + 32 m + lane (m < kSegs,
// e < K) it counts those with cdf[e] <= slot (one ballot each) and checks
// cdf[e] < cdf[e + 1].  On a strictly increasing row the symbol is then
// count - 1, read back with no search at all.  `cdf(e)` reads entry e.
constexpr int kSegs = 8;
constexpr int kPassEntries = 32 * kSegs;

template <typename Cdf>
__device__ __forceinline__ void warp_count_pass(const Cdf& cdf, int k,
                                                int base, uint32_t slot,
                                                int& count, bool& strict) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < kSegs; ++m) {
    const int e = base + 32 * m + lane;
    const bool in = e < k;
    const uint32_t c0 = in ? cdf(e) : 0u;
    const uint32_t c1 = in ? cdf(e + 1) : 1u;
    strict = strict && c0 < c1;
    count += __popc(__ballot_sync(kFullMask, in && c0 <= slot));
  }
}

}  // namespace decode_search

// One rANS symbol pop per lane for Hopper (sm_90a): kernel B2.
//
// Replaces the TPU kernel repro/kernels/rans_decode.py::rans_decode_step
// (body _decode_step_kernel): per lane, slot = s & (2**n - 1), the symbol
// x with cdf[x] <= slot < cdf[x+1] and the normative probe count of
// repro/core/search.py (candidates clipped to [0, K-1], one probe each
// while unresolved, then the masked bisection with the cdf[mid] == slot
// early commit), s = f * (s >> n) + slot - cdf[x] (mod 2**32) and a 2-step
// masked refill where a read outside [0, cap) injects 0 and counts toward
// `under` when the refill is active.  Tables are this step's rows, shared
// (K,) / (K+1,) (lane strides 0) or per-lane (lanes, K) / (lanes, K+1);
// candidates (lanes, topk); streams lane-major (lanes, cap) rows.
//
// One warp per lane.  Rows of K <= kRegK (380) are held in registers, and
// the chain of dependent loads is two levels deep:
//   level 1: the state s and cursor ptr, the whole cdf row (K + 1 entries)
//            and the whole freq row (K entries), 16 bytes a thread each, up
//            to kRegChunks chunks of each, and the first 32 candidates, all
//            independent;
//   level 2: the two refill bytes at ptr and ptr + 1 (a byte outside
//            [0, cap) reads 0);
// then, with no further load, one warp count of cdf[e] <= slot and a vote
// on strict increase (decode_search.cuh); on a strictly increasing row
// x = count - 1, and cdf[x], cdf[x+1] and freq[x] come from the owning
// lanes by shuffle (f is read from the freq row on every path, as the
// reference reads it, whatever the cdf says); the probes are replayed from
// x (ds::warp_cand_probes, ds::replay_probes); the update and both refills
// are selects.  A row with a zero frequency (not strictly increasing) runs
// the exact bisection, ds::exact_search (kWarpRows or kWarpBisect).
// Longer rows run the reference's own search, exact on any row (zero
// frequencies and a freq that is not the cdf's differences included), with
// the warp reading the bisection ahead (kTreeBisect): the mids of the next
// kTreeLevels levels below a bracket depend on the bracket alone, so lane j
// loads the cdf at heap node j + 1 of that subtree, all 31 loads
// independent, and the warp walks the levels by shuffle, one probe per
// active iteration with the cdf[mid] == slot early commit.  The first
// round (from [0, K)) goes out with the state and the candidates, whose
// cdf[c], cdf[c + 1] pairs are one load level (a ballot takes the first
// hit); a 16-level bisection (K <= 65,536) then takes three more rounds
// and freq[x] one more load.  Each lane's row in `out` records the path it
// ran (rans_decode.BRANCH_BITS).
//
// What bounds it on this card: the launch and the chain of L2 loads.  One
// call moves about 1.1 KB per lane (the row, the state, the bytes, the
// outputs), 0.04 us at the memory rate for 128 lanes.  On an H100 (700 W)
// an empty kernel launched the same way (rans_decode_step_floor_launch)
// takes 0.0010-0.0011 ms as a CUDA graph node and the register row
// 0.0021 ms; the rest is the two load levels' latency (L2 hits: the SPC
// has just written the rows), the count and the shuffles.  The wide rows
// add about five dependent L2 loads (their times in PERF.md), where the
// row count they replace walked 197 passes at K = 50,280.  Fewer launches
// (a captured or fused scan), not a faster step, is what would cut it
// further.

#include <cstdint>
#include <cuda_runtime.h>

#include "decode_search.cuh"

namespace {

namespace ds = decode_search;

constexpr uint32_t kRansL = 1u << 23;
constexpr int kWarps = 4;             // lanes per block: one warp each
constexpr int kRegChunks = 3;         // 16-byte chunks a thread holds a row
// the register row covers K + 1 entries plus up to 3 of alignment shift
constexpr int kRegK = 4 * 32 * kRegChunks - 4;   // 380
static_assert(kRegChunks == 3, "row_word picks among three chunks");
constexpr int kTreeLevels = 5;        // bisection levels a warp reads ahead

enum Branch : int {                   // rans_decode_lanes.cu's bits, then
  kWarpRows = 4,                      // the wide rows' read-ahead search
  kWarpBisect = 8,
  kTreeBisect = 16,
};

__device__ __forceinline__ uint32_t word_of(const uint4& c, int q) {
  return q == 0 ? c.x : (q == 1 ? c.y : (q == 2 ? c.z : c.w));
}

// Load a row's 16-byte blocks from the aligned word below it: entry e sits
// at word position sh + e, held by lane (sh + e) / 4 % 32 in chunk
// (sh + e) / 128.  Blocks past n_words read as zeros.
__device__ __forceinline__ int load_row(const uint32_t* row, int n_words,
                                        int lane, uint4 (&c)[kRegChunks]) {
  const int sh = static_cast<int>((reinterpret_cast<uintptr_t>(row) >> 2) & 3u);
  const uint4* base = reinterpret_cast<const uint4*>(row - sh);
  const int n_chunks = (sh + n_words + 3) >> 2;
#pragma unroll
  for (int r = 0; r < kRegChunks; ++r) {
    const int i = lane + 32 * r;
    c[r] = i < n_chunks ? __ldg(base + i) : make_uint4(0u, 0u, 0u, 0u);
  }
  return sh;
}

// The word at position p of a row loaded by load_row, taken from the lane
// that holds it (p is the same on every lane).
__device__ __forceinline__ uint32_t row_word(const uint4 (&c)[kRegChunks],
                                             int p) {
  const int r = p >> 7;
  const uint4 ch = r == 0 ? c[0] : (r == 1 ? c[1] : c[kRegChunks - 1]);
  return __shfl_sync(ds::kFullMask, word_of(ch, p & 3), (p >> 2) & 31);
}

// The cdf entries at the mids of the kTreeLevels bisection levels below the
// bracket [lo, hi): lane j < 31 takes heap node j + 1 (its path from the
// root in the bits below the top one) and loads the cdf at its mid, or
// nothing where its bracket holds one entry (the walk never probes it).
__device__ __forceinline__ uint32_t tree_load(const uint32_t* cd, int lo,
                                              int hi, int lane) {
  const int node = lane + 1;
  for (int d = 30 - __clz(node); d >= 0; --d) {
    const int mid = (lo + hi) >> 1;
    if ((node >> d) & 1) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lane < 31 && hi - lo > 1 ? __ldg(cd + ((lo + hi) >> 1)) : 0u;
}

// core/search.py's find_symbol on a row in device memory, one warp a cell:
// the candidates (one probe each while unresolved; lane j checks candidate
// j of each group of 32, `first` being the first group's id), then the
// masked bisection of n_iter iterations from [0, K) with the early commit,
// kTreeLevels levels a round.  `ahead` is the first round's tree_load from
// [0, K) and c0 = cdf[0].  Returns x; c_x = cdf[x] and `probes` as charged.
__device__ __forceinline__ int tree_search(const uint32_t* cd, uint32_t slot,
                                           int k, int n_iter,
                                           const int32_t* cands, int topk,
                                           int first, uint32_t ahead,
                                           uint32_t c0, uint32_t& c_x,
                                           int& probes) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < topk; base += 32) {
    const int j = base + lane;
    const int c = min(max(base == 0 ? first : (j < topk ? __ldg(cands + j)
                                                        : 0), 0), k - 1);
    const uint32_t a = j < topk ? __ldg(cd + c) : 0u;
    const uint32_t b = j < topk ? __ldg(cd + c + 1) : 0u;
    const unsigned hit =
        __ballot_sync(ds::kFullMask, j < topk && a <= slot && slot < b);
    if (hit) {
      const int src = __ffs(hit) - 1;
      probes = base + src + 1;
      c_x = __shfl_sync(ds::kFullMask, a, src);
      return __shfl_sync(ds::kFullMask, c, src);
    }
  }
  probes = topk;
  int lo = 0, hi = k, it = 0;
  uint32_t c_lo = c0, v = ahead;
  while (true) {
    int node = 1;
    for (int l = 0; l < kTreeLevels; ++l) {
      if (it == n_iter || hi - lo <= 1) break;    // warp-uniform
      const int mid = (lo + hi) >> 1;
      const uint32_t c = __shfl_sync(ds::kFullMask, v, node - 1);
      ++probes;
      ++it;
      if (c <= slot) {
        lo = mid;
        c_lo = c;
        if (c == slot) hi = mid + 1;
        node = 2 * node + 1;
      } else {
        hi = mid;
        node = 2 * node;
      }
    }
    if (it == n_iter || hi - lo <= 1) break;
    v = tree_load(cd, lo, hi, lane);
  }
  c_x = c_lo;
  return lo;
}

__global__ void __launch_bounds__(32 * kWarps) rans_decode_step_kernel(
    const uint8_t* __restrict__ buf, int cap,
    const uint32_t* __restrict__ s_in, const int32_t* __restrict__ ptr_in,
    const uint32_t* __restrict__ freq, const uint32_t* __restrict__ cdf,
    long long freq_lane_stride, long long cdf_lane_stride, int k,
    const int32_t* __restrict__ cands, int topk, int lanes, int prob_bits,
    int n_iter, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int cell = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (cell >= lanes) return;          // warp-uniform
  const uint32_t* cd = cdf + cell * cdf_lane_stride;
  const uint32_t* fr = freq + cell * freq_lane_stride;
  const int32_t* crow = topk ? cands + static_cast<long long>(cell) * topk
                             : nullptr;
  const uint8_t* row = buf + static_cast<long long>(cell) * cap;

  // level 1
  const uint32_t s = __ldg(s_in + cell);
  const int ptr = __ldg(ptr_in + cell);
  const int first = lane < topk ? __ldg(crow + lane) : -1;
  const bool in_regs = k <= kRegK;
  uint4 c[kRegChunks], fc[kRegChunks];
  int sh = 0, shf = 0;
  uint32_t ahead = 0, c0 = 0;
  if (in_regs) {
    sh = load_row(cd, k + 1, lane, c);      // cdf entries 0 .. K
    shf = load_row(fr, k, lane, fc);        // freq entries 0 .. K - 1
  } else {
    ahead = tree_load(cd, 0, k, lane);      // the bisection's first round
    c0 = __ldg(cd);
  }
  // level 2
  const bool in0 = static_cast<unsigned>(ptr) < static_cast<unsigned>(cap);
  const bool in1 =
      static_cast<unsigned>(ptr + 1) < static_cast<unsigned>(cap);
  const uint32_t b0 = in0 ? __ldg(row + ptr) : 0u;
  const uint32_t b1 = in1 ? __ldg(row + ptr + 1) : 0u;

  const uint32_t slot = s & ((1u << prob_bits) - 1u);
  int x, probes;
  uint32_t f, start;
  int32_t branch;
  if (in_regs) {
    int count = 0;
    bool strict = true;
    int n = 0;
#pragma unroll
    for (int r = 0; r < kRegChunks; ++r) {
      // entry after a chunk's last word: the next lane's first word, or
      // for lane 31 lane 0's first word of the next chunk
      const uint32_t down = __shfl_down_sync(ds::kFullMask, c[r].x, 1);
      const uint32_t wrap = __shfl_sync(
          ds::kFullMask, c[r + 1 < kRegChunks ? r + 1 : r].x, 0);
      const uint32_t after = lane == 31 ? wrap : down;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = 4 * (lane + 32 * r) + q - sh;
        const bool in = e >= 0 && e < k;
        const uint32_t v = word_of(c[r], q);
        const uint32_t vn = q < 3 ? word_of(c[r], q + 1) : after;
        n += in && v <= slot;
        strict = strict && (!in || v < vn);
      }
    }
    count = static_cast<int>(
        __reduce_add_sync(ds::kFullMask, static_cast<unsigned>(n)));
    // cdf[x], cdf[x + 1] and freq[x] from the lanes that hold them
    const int xr = count > 0 ? count - 1 : 0;
    const uint32_t c_lo = row_word(c, sh + xr);
    const uint32_t c_hi = row_word(c, sh + xr + 1);
    const uint32_t f_x = row_word(fc, shf + xr);
    if (__all_sync(ds::kFullMask, strict) && count > 0 && slot < c_hi) {
      x = count - 1;
      bool found = false;
      int cp = 0;
      if (topk) cp = ds::warp_cand_probes(crow, topk, k, x, first, found);
      probes = ds::replay_probes(x, slot == c_lo, cp, found, false, 0, 0, k,
                                 ds::LoopDepth{});
      f = f_x;
      start = c_lo;
      branch = kWarpRows;
    } else {
      probes = 0;
      x = ds::exact_search(ds::GlobalCdf{cd}, slot, k, n_iter, crow, topk,
                           false, 0, 0, probes);
      f = __ldg(fr + x);
      start = __ldg(cd + x);
      branch = kWarpBisect;
    }
  } else {
    x = tree_search(cd, slot, k, n_iter, crow, topk, first, ahead, c0, start,
                    probes);
    f = __ldg(fr + x);
    branch = kTreeBisect;
  }

  uint32_t s2 = f * (s >> prob_bits) + slot - start;
  const bool r1 = s2 < kRansL;
  s2 = r1 ? (s2 << 8) | b0 : s2;
  const bool r2 = r1 && s2 < kRansL;
  s2 = r2 ? (s2 << 8) | b1 : s2;
  if (lane == 0) {
    out[cell] = static_cast<int32_t>(s2);
    out[lanes + cell] = ptr + r1 + r2;
    out[2 * lanes + cell] = x;
    out[3 * lanes + cell] = probes;
    out[4 * lanes + cell] = (r1 && !in0) + (r2 && !in1);
    out[5 * lanes + cell] = branch;
  }
}

// An empty kernel with B2's arguments and geometry: the launch floor that
// B2's time is held against (chip_smoke.py).
__global__ void __launch_bounds__(32 * kWarps) empty_step_kernel(
    const uint8_t*, int, const uint32_t*, const int32_t*, const uint32_t*,
    const uint32_t*, long long, long long, int, const int32_t*, int, int,
    int, int, int32_t*) {}

template <typename Kernel>
int launch(Kernel kernel, const void* buf, int cap, const void* s_in,
           const void* ptr_in, const void* freq, const void* cdf,
           long long freq_lane_stride, long long cdf_lane_stride, int k,
           const void* cands, int topk, int lanes, int prob_bits, int n_iter,
           void* out, void* stream) {
  const int grid = (lanes + kWarps - 1) / kWarps;
  kernel<<<grid, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), cap,
      static_cast<const uint32_t*>(s_in), static_cast<const int32_t*>(ptr_in),
      static_cast<const uint32_t*>(freq), static_cast<const uint32_t*>(cdf),
      freq_lane_stride, cdf_lane_stride, k,
      static_cast<const int32_t*>(cands), topk, lanes, prob_bits, n_iter,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out: (6, lanes) int32 rows s', ptr', symbol, probes, under, branch.
extern "C" int rans_decode_step_launch(
    const void* buf, int cap, const void* s_in, const void* ptr_in,
    const void* freq, const void* cdf, long long freq_lane_stride,
    long long cdf_lane_stride, int k, const void* cands, int topk, int lanes,
    int prob_bits, int n_iter, void* out, void* stream) {
  return launch(rans_decode_step_kernel, buf, cap, s_in, ptr_in, freq, cdf,
                freq_lane_stride, cdf_lane_stride, k, cands, topk, lanes,
                prob_bits, n_iter, out, stream);
}

// The empty kernel, launched as rans_decode_step_launch launches B2.
extern "C" int rans_decode_step_floor_launch(
    const void* buf, int cap, const void* s_in, const void* ptr_in,
    const void* freq, const void* cdf, long long freq_lane_stride,
    long long cdf_lane_stride, int k, const void* cands, int topk, int lanes,
    int prob_bits, int n_iter, void* out, void* stream) {
  return launch(empty_step_kernel, buf, cap, s_in, ptr_in, freq, cdf,
                freq_lane_stride, cdf_lane_stride, k, cands, topk, lanes,
                prob_bits, n_iter, out, stream);
}

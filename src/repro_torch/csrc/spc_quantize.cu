// SPC quantization for Hopper (sm_90a): kernel B6.
//
// Replaces the TPU kernel repro/kernels/spc_quantize.py::spc_quantize (body
// _spc_quantize_kernel): BF16 probabilities -> fixed-point frequencies that
// sum to 2**n exactly, every f >= 1, and optionally the (K+1)-entry CDF
// row in the same launch.  Per row (B rows, K symbols):
//   1. p = bf16(p) (round to nearest even, subnormals kept; bfloat16 input
//      is taken as it is); p = 0 where it is not finite or <= 0;
//   2. scaled = p * 2**n in float32 (exact: the factor is a power of two);
//   3. f0 = max(1, rint(scaled)) (half to even, as jnp.round / torch.round);
//   4. delta = 2**n - sum f0, a group reduction in 64-bit integers;
//   5. resid = scaled - f0, mapped to an order-preserving uint32 key
//      (-0.0 first made +0.0: the reference's stable sort ties them);
//   6. delta >= 0: every entry gets delta / K, and the r = delta % K
//      entries first in (resid descending, index ascending) order get one
//      more.  A radix select over the key bits (one group count per bit)
//      finds the r-th largest key v; keys above v get +1, and of the keys
//      equal to v the first r - #(key > v) by index (a group prefix count);
//   7. delta < 0 (the waterfill, smallest residual first, never below 1):
//      with weights cap = f0 - 1 and need = -delta, a weighted radix select
//      finds the least key v with sum(cap over key <= v) >= need (it
//      exists: sum cap - need = 2**n - K >= 0).  Keys below v give up their
//      whole cap, keys above v nothing, and the keys equal to v, in index
//      order, min(cap, max(0, need - sum cap before them)) (a group prefix
//      sum in 64-bit integers);
//   8. cdf (when asked): an exclusive group scan of f, cdf[K] = 2**n.
// The result equals the sort-based repro_torch.core.spc.quantize_probs
// (and freq_cdf_from_probs) on every row, ties included.
//
// Layout: a row of K <= 1024 is owned by one warp, four rows a block, each
// lane holding E = K/32 (rounded up to a power of two) consecutive entries
// in registers, loaded and stored 16 bytes at a time where the row allows.
// Rows of K <= 16,384 (kRegMaxK) are owned by a block of 512 threads with
// 32 entries each; the group reductions then go through shared memory.
// Rows of 16,384 < K <= 65,536 (kMaxK, the SPC's ceiling at prob_bits 16;
// mamba2-130m's K = 50,280) are split over a thread-block cluster of
// C = ceil(K / 8,192) blocks of 512 threads (kWideSeg; C <= kMaxCluster),
// block c owning the c-th contiguous segment, kWideE consecutive entries a
// thread, whose keys and f0 are derived once into 64 KB of shared memory
// (three blocks an SM).  The blocks exchange the row's totals through
// distributed shared memory after cluster barriers: the mass with the
// least and largest key (the keys' common prefix is the boundary key's)
// and the first kDigitBits-bit digit's bins (counts and caps, built while
// the keys are derived); then, for each later digit below the common
// prefix, every block's bins of the keys that match the boundary so far,
// summed over the cluster by two warps of each block, so every block
// takes the same digit; last, each segment's f0 sum, its keys above (or
// caps below) the boundary and its tie weight, from which each block takes
// its tie prefix and its CDF offset.  The frequencies and the CDF go out
// through shared memory, coalesced.  The wide rows take prob_bits <= 16,
// so a row's caps sum below 2**32.
//
// What bounds it on this card: instructions and barriers.  The selection
// of the narrow layouts is 32 group counts per row (one per key bit), each
// E compares and adds per lane and one warp reduction, against a byte
// bound of 6-8 B per entry (the O(K**2) pairwise ranking it replaces was
// 65,536 compares per row at K = 256).  On an H100 (700 W) 128,000 BF16
// rows of 256 take 0.31 ms against a byte bound of 0.059 ms (PERF.md).
// The cluster layout runs a chain of up to six cluster barriers and a
// dozen block barriers a row, with serial warp steps between them: at 16
// rows that chain, not the few dozen instructions an entry, sets the time
// (11-14x the byte bound); on the batches, three blocks an SM overlap it
// (5-8x; times, bounds and each phase's share in PERF.md, the phases from
// tools/spc_wide_phases.py).  Only the branch a row needs runs.

#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 65536;        // MAX_K in kernels/spc_quantize.py
constexpr int kRegMaxK = 16384;     // the register layouts' largest K
constexpr int kRowWarps = 4;        // warp-per-row blocks: four rows a block
constexpr int kBlockWarps = 16;     // block-per-row: 512 threads ...
constexpr int kBlockE = 32;         // ... of 32 entries (16,384 / 512)
constexpr int kWideWarps = 16;      // wide rows: blocks of 512 threads ...
constexpr int kWideThreads = 32 * kWideWarps;
constexpr int kWideE = 16;          // ... with 16 entries each, so
constexpr int kWideSeg = kWideThreads * kWideE;  // 8,192 entries a block
constexpr int kMaxCluster = 8;      // blocks a row: a portable cluster
constexpr int kDigitBits = 8;       // the radix select's digit ...
constexpr int kBins = 1 << kDigitBits;
constexpr int kPasses = 32 / kDigitBits;   // ... in at most four passes
constexpr int kWideBlocksPerSm = 3; // keys and f0 in 64 KB of shared memory
constexpr int kWideSmem = 2 * kWideSeg * 4;
static_assert(kMaxCluster * kWideSeg >= kMaxK, "a cluster holds a row");
constexpr int kSelWarps = 2;        // warps that sum a pass's bins
constexpr int kBinWords = (2 + kPasses - 1) * kBins;
static_assert(kSelWarps * 32 * 4 == kBins, "four bins a selecting lane");

// Input element types, read as 32-bit words: float32 (rounded to bf16
// here) or bfloat16 bit patterns (two a word).
struct F32In {
  static constexpr int kPerWord = 1;
  using T = float;
  __device__ __forceinline__ static float word(uint32_t w, int) {
    return __uint_as_float(round_bf16(w));
  }
  __device__ __forceinline__ static float one(const T* p) {
    return __uint_as_float(round_bf16(__float_as_uint(*p)));
  }
  __device__ __forceinline__ static uint16_t bits16(const T* p) {
    return static_cast<uint16_t>(round_bf16(__float_as_uint(__ldg(p))) >>
                                 16);
  }
  // float32 -> bf16 (round to nearest even; NaN stays NaN) -> float32 bits
  __device__ __forceinline__ static uint32_t round_bf16(uint32_t u) {
    if ((u & 0x7fffffffu) > 0x7f800000u) return u | 0x00400000u;
    return (u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u;
  }
};

struct BF16In {
  static constexpr int kPerWord = 2;
  using T = uint16_t;
  __device__ __forceinline__ static float word(uint32_t w, int h) {
    return __uint_as_float(h ? (w & 0xffff0000u) : (w << 16));
  }
  __device__ __forceinline__ static float one(const T* p) {
    return __uint_as_float(static_cast<uint32_t>(*p) << 16);
  }
  __device__ __forceinline__ static uint16_t bits16(const T* p) {
    return __ldg(p);
  }
};

// resid -> a key whose unsigned order is the float order; -0.0 == +0.0
__device__ __forceinline__ uint32_t order_key(float r) {
  uint32_t u = __float_as_uint(r);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Reductions and scans over the threads that own one row: a warp (W = 1)
// or a block of W warps (through `scratch`, W words of shared memory).
template <int W>
struct Group {
  unsigned long long* scratch;

  __device__ __forceinline__ int rank() const {
    return W == 1 ? static_cast<int>(threadIdx.x & 31)
                  : static_cast<int>(threadIdx.x);
  }

  __device__ __forceinline__ unsigned long long across(
      unsigned long long v) const {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) scratch[warp] = v;
    __syncthreads();
    unsigned long long t = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) t += scratch[w];
    __syncthreads();
    return t;
  }

  __device__ __forceinline__ unsigned sum(unsigned v) const {
    v = __reduce_add_sync(kFull, v);
    if constexpr (W == 1) {
      return v;
    } else {
      return static_cast<unsigned>(across(v));
    }
  }

  __device__ __forceinline__ unsigned long long sum(
      unsigned long long v) const {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    if constexpr (W == 1) {
      return v;
    } else {
      return across(v);
    }
  }

  // Exclusive prefix of v over the group's threads in rank order.
  template <typename U>
  __device__ __forceinline__ U excl(U v) const {
    const int lane = threadIdx.x & 31;
    U inc = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const U u = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += u;
    }
    if constexpr (W == 1) {
      return inc - v;
    } else {
      const int warp = threadIdx.x >> 5;
      if (lane == 31) scratch[warp] = inc;
      __syncthreads();
      U before = 0;
      for (int w = 0; w < warp; ++w) before += static_cast<U>(scratch[w]);
      __syncthreads();
      return before + inc - v;
    }
  }
};

// This thread's E probabilities p[i0 .. i0 + E) of a row, 0 past K.
template <int E, typename In>
__device__ __forceinline__ void load_probs(const typename In::T* src, int i0,
                                           int k, float (&pv)[E]) {
  constexpr int kBytes = E * static_cast<int>(sizeof(typename In::T));
  const typename In::T* p = src + i0;
  if constexpr (kBytes % 16 == 0) {
    if (i0 + E <= k && (reinterpret_cast<uintptr_t>(p) & 15u) == 0) {
      const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
      for (int q = 0; q < kBytes / 16; ++q) {
        const uint4 c = __ldg(v + q);
        const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int i = 0; i < 4 * In::kPerWord; ++i) {
          pv[q * 4 * In::kPerWord + i] =
              In::word(w[i / In::kPerWord], i % In::kPerWord);
        }
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < E; ++j) pv[j] = i0 + j < k ? In::one(p + j) : 0.0f;
}

// The least key v with sum(cap over key <= v) >= need (the waterfill's
// boundary), one group sum of the caps per key bit; U is the sums' type.
template <typename U, int W, int E>
__device__ __forceinline__ uint32_t weighted_select(const uint32_t (&key)[E],
                                                    const int (&f)[E],
                                                    U need,
                                                    const Group<W>& g) {
  uint32_t v = 0;
  for (int b = 31; b >= 0; --b) {
    const uint32_t x = v | ((1u << b) - 1u);
    U w = 0;
#pragma unroll
    for (int j = 0; j < E; ++j) w += key[j] <= x ? static_cast<U>(f[j] - 1) : 0;
    if (g.sum(w) < need) v |= 1u << b;
  }
  return v;
}

template <int W, int E, typename In>
__device__ __forceinline__ void quantize_row(
    const typename In::T* __restrict__ src, int k, int prob_bits,
    int32_t* __restrict__ frow, int32_t* __restrict__ crow,
    const Group<W>& g) {
  const int i0 = g.rank() * E;
  float pv[E];
  load_probs<E, In>(src, i0, k, pv);
  const int total = 1 << prob_bits;
  const float scale = static_cast<float>(total);
  // An entry past K is a sentinel: key 0 (below every real key, since
  // order_key(-1.0) > 0 and resid >= -1) and f = 1 (cap 0), left out of the
  // mass sum, so the selections below need no bounds test.
  int f[E];
  uint32_t key[E];
  long long local = 0;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const bool in = i0 + j < k;
    const float p = (isfinite(pv[j]) && pv[j] > 0.0f) ? pv[j] : 0.0f;
    const float scaled = p * scale;
    const int f0 = max(1, __float2int_rn(scaled));
    f[j] = in ? f0 : 1;
    key[j] = in ? order_key(scaled - static_cast<float>(f0)) : 0u;
    local += in ? f0 : 0;
  }
  const long long delta =
      total - static_cast<long long>(g.sum(static_cast<unsigned long long>(
                  local)));

  if (delta >= 0) {
    // every f0 >= 1, so delta <= 2**n - K fits an int
    const int base = static_cast<int>(delta / k);
    const int r = static_cast<int>(delta % k);
    if (r > 0) {
      uint32_t v = 0;               // the r-th largest key
      for (int b = 31; b >= 0; --b) {
        const uint32_t c = v | (1u << b);
        unsigned n = 0;
#pragma unroll
        for (int j = 0; j < E; ++j) n += key[j] >= c;
        if (g.sum(n) >= static_cast<unsigned>(r)) v = c;
      }
      unsigned gt = 0, tie = 0;
#pragma unroll
      for (int j = 0; j < E; ++j) {
        gt += key[j] > v;
        tie += key[j] == v;
      }
      const int m = r - static_cast<int>(g.sum(gt));
      int before = static_cast<int>(g.excl(tie));
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const bool at = key[j] == v;
        f[j] += key[j] > v || (at && before < m);
        before += at;
      }
    }
#pragma unroll
    for (int j = 0; j < E; ++j) f[j] += base;
  } else {
    const long long need = -delta;
    unsigned long long caps = 0;
#pragma unroll
    for (int j = 0; j < E; ++j) caps += f[j] - 1;
    // 32-bit group sums when the row's whole cap fits them
    const uint32_t v =
        g.sum(caps) < (1ull << 32)
            ? weighted_select<unsigned>(key, f, static_cast<unsigned>(need), g)
            : weighted_select<unsigned long long>(
                  key, f, static_cast<unsigned long long>(need), g);
    unsigned long long lt = 0, tie = 0;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      lt += key[j] < v ? f[j] - 1 : 0;
      tie += key[j] == v ? f[j] - 1 : 0;
    }
    const long long rem = need - static_cast<long long>(g.sum(lt));
    long long before = static_cast<long long>(g.excl(tie));
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const long long cap = f[j] - 1;
      const bool at = key[j] == v;
      const long long take =
          key[j] < v ? cap : (at ? min(max(rem - before, 0ll), cap) : 0ll);
      before += at ? cap : 0;
      f[j] -= static_cast<int>(take);
    }
  }

  int32_t* out = frow + i0;
  bool stored = false;
  if constexpr (E % 4 == 0) {
    if (i0 + E <= k && (reinterpret_cast<uintptr_t>(out) & 15u) == 0) {
#pragma unroll
      for (int q = 0; q < E / 4; ++q) {
        reinterpret_cast<int4*>(out)[q] =
            make_int4(f[4 * q], f[4 * q + 1], f[4 * q + 2], f[4 * q + 3]);
      }
      stored = true;
    }
  }
  if (!stored) {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if (i0 + j < k) out[j] = f[j];
    }
  }
  if (crow != nullptr) {
    unsigned run = 0;
#pragma unroll
    for (int j = 0; j < E; ++j) run += i0 + j < k ? f[j] : 0;
    run = g.excl(run);              // the prefix ends at exactly 2**n
    if (g.rank() == 0) crow[0] = 0;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      run += i0 + j < k ? f[j] : 0;
      if (i0 + j < k) crow[i0 + j + 1] = static_cast<int32_t>(run);
    }
  }
}

// ---- wide rows (16,384 < K <= 65,536): a row over a thread-block cluster --

// Inclusive prefix over the warp's lanes.
template <typename U>
__device__ __forceinline__ U warp_incl(U v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const U u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

template <typename U>
__device__ __forceinline__ U warp_sum(U v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The cluster barrier in two halves: arrive once this block has read its
// last remote word, wait before it leaves (no block may leave while
// another can still read its shared memory).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Entry e of a block's segment in a staging row of shared memory: a word
// swizzle (the column xor the row's low four bits) under which both the
// owners' writes (lane l, entry 16 l + j) and the coalesced reads (lane l,
// entry 32 q + l) hit 32 distinct banks.
__device__ __forceinline__ int swz(int e) {
  return (e & ~31) | ((e & 31) ^ ((e >> 5) & 15));
}

struct alignas(16) WideShared {
  // each pass's bins: pass 0's counts and caps, built before the row's
  // mass says which one it needs, and later passes' counts or caps (at
  // prob_bits <= 16 every cap is below 2**16: a block's caps sum below
  // 2**29 and a row's below 2**32)
  unsigned bins0[2][kBins];
  unsigned bins[kPasses - 1][kBins];
  unsigned long long warp3[kWideWarps][3];  // a warp's three totals
  unsigned long long row[3];                // published: mass, kmin, kmax
  unsigned long long seg[3];                // published: f0 sum, gt or lt, tie
  unsigned pick[kSelWarps];                 // the selecting warps' totals
  unsigned chosen[2];                       // a pass's digit and its rank
};

// Warp 0 folds the block's warp totals (`warp3`: a sum and, with
// `minmax`, a min and a max, or three sums) into `out`.
__device__ __forceinline__ void fold_warps(const WideShared& sh,
                                           unsigned long long* out,
                                           bool minmax) {
  const int lane = threadIdx.x & 31;
  const bool in = lane < kWideWarps;
  unsigned long long a = in ? sh.warp3[lane][0] : 0ull;
  unsigned long long b = in ? sh.warp3[lane][1] : (minmax ? ~0ull : 0ull);
  unsigned long long c = in ? sh.warp3[lane][2] : 0ull;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(kFull, a, o);
    const unsigned long long b2 = __shfl_xor_sync(kFull, b, o);
    const unsigned long long c2 = __shfl_xor_sync(kFull, c, o);
    b = minmax ? min(b, b2) : b + b2;
    c = minmax ? max(c, c2) : c + c2;
  }
  if (lane == 0) {
    out[0] = a;
    out[1] = b;
    out[2] = c;
  }
}

// A cluster of C blocks owns a row: block c the segment [c * seg, c * seg +
// seg) of it, thread t of a block the kWideE consecutive entries from
// 16 t, their keys and f0 derived once into shared memory (entry j of
// thread t at j * kWideThreads + t: no bank conflicts).  Every row total
// goes through the blocks' shared memory (distributed shared memory), read
// after a cluster barrier by every block alike, so all of them take the
// same decisions.
template <typename In>
__global__ void __launch_bounds__(kWideThreads, kWideBlocksPerSm)
    spc_cluster_kernel(const typename In::T* __restrict__ probs, int k,
                       int seg, int prob_bits, int32_t* __restrict__ freq,
                       int32_t* __restrict__ cdf) {
  __shared__ WideShared sh;
  extern __shared__ uint32_t wide_smem[];
  uint32_t* key_s = wide_smem;                        // [kWideE][threads]
  int* f_s = reinterpret_cast<int*>(wide_smem + kWideSeg);
  cg::cluster_group cluster = cg::this_cluster();
  const int nblk = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row = blockIdx.x / nblk;
  const int s_lo = rank * seg, s_hi = min(k, s_lo + seg);
  const int n_seg = max(s_hi - s_lo, 0);
  const int i0 = s_lo + tid * kWideE;
  const int n_in = min(max(s_hi - i0, 0), kWideE);   // this thread's entries
  const int total = 1 << prob_bits;

  for (int q = tid; q < kBinWords; q += kWideThreads) {
    (&sh.bins0[0][0])[q] = 0u;              // bins0 and bins, contiguous
  }
  __syncthreads();
  // Steps 1-5, once, and pass 0's bins (the top kDigitBits of the keys,
  // counts and caps alike: no key prefix to match yet).
  unsigned mass = 0;
  uint32_t kmin = ~0u, kmax = 0u;
  {
    float pv[kWideE];
    load_probs<kWideE, In>(probs + row * k, i0, s_hi, pv);
    const float scale = static_cast<float>(total);
#pragma unroll
    for (int j = 0; j < kWideE; ++j) {
      const float p = (isfinite(pv[j]) && pv[j] > 0.0f) ? pv[j] : 0.0f;
      const float scaled = p * scale;
      const int f0 = max(1, __float2int_rn(scaled));
      const uint32_t key = order_key(scaled - static_cast<float>(f0));
      key_s[j * kWideThreads + tid] = key;
      f_s[j * kWideThreads + tid] = f0;
      if (j < n_in) {
        const unsigned d = key >> (32 - kDigitBits);
        const unsigned cap = static_cast<unsigned>(f0 - 1);
        atomicAdd(&sh.bins0[0][d], 1u);
        if (cap) atomicAdd(&sh.bins0[1][d], cap);
        mass += f0;
        kmin = min(kmin, key);
        kmax = max(kmax, key);
      }
    }
  }
  const unsigned warp_mass = warp_sum(mass);
  kmin = __reduce_min_sync(kFull, kmin);
  kmax = __reduce_max_sync(kFull, kmax);
  if (lane == 0) {
    sh.warp3[warp][0] = warp_mass;
    sh.warp3[warp][1] = kmin;
    sh.warp3[warp][2] = kmax;
  }
  __syncthreads();
  if (warp == 0) fold_warps(sh, sh.row, true);
  cluster.sync();
  // the row's mass, least and largest key: lane c reads block c
  unsigned long long rmass = 0, rmin = ~0ull, rmax = 0;
  if (lane < nblk) {
    const unsigned long long* r = cluster.map_shared_rank(sh.row, lane);
    rmass = r[0];
    rmin = r[1];
    rmax = r[2];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    rmass += __shfl_xor_sync(kFull, rmass, o);
    rmin = min(rmin, __shfl_xor_sync(kFull, rmin, o));
    rmax = max(rmax, __shfl_xor_sync(kFull, rmax, o));
  }
  const long long delta = total - static_cast<long long>(rmass);

  // Step 6 or 7's selection: the boundary key v, and m, the top-up's count
  // of keys equal to v that get one more or the waterfill's need left at
  // v.  The keys share the bits above the highest one where the least and
  // largest differ, so v does too; each pass of kDigitBits below them
  // takes the bin where the running total of the keys matching v so far
  // (counts from the top down, or caps from the bottom up) reaches the
  // rank or the need, from the cluster's sum of every block's bins.
  const bool topup = delta >= 0;
  const int base = topup ? static_cast<int>(delta / k) : 0;
  const int r = topup ? static_cast<int>(delta % k) : 0;
  const bool select = !topup || r > 0;      // row-uniform
  const unsigned want =
      topup ? static_cast<unsigned>(r) : static_cast<unsigned>(-delta);
  const uint32_t lo_key = static_cast<uint32_t>(rmin);
  const int nb = lo_key == static_cast<uint32_t>(rmax)
                     ? 0
                     : 32 - __clz(lo_key ^ static_cast<uint32_t>(rmax));
  uint32_t v = nb == 32 ? 0u : lo_key & ~((1u << nb) - 1u);
  unsigned acc = 0;               // #keys above v's prefix, or their caps
  for (int pass = 0; select && pass < kPasses; ++pass) {
    const int shift = 32 - kDigitBits * (pass + 1);
    if (shift >= nb) continue;              // bits every key shares
    const unsigned* bins;
    if (pass == 0) {
      bins = topup ? sh.bins0[0] : sh.bins0[1];
    } else {
      unsigned* h = sh.bins[pass - 1];
      const int above = shift + kDigitBits;
#pragma unroll 4
      for (int j = 0; j < kWideE; ++j) {
        const uint32_t key = key_s[j * kWideThreads + tid];
        if (j < n_in && (key >> above) == (v >> above)) {
          const unsigned d = (key >> shift) & (kBins - 1);
          const unsigned w =
              topup ? 1u
                    : static_cast<unsigned>(f_s[j * kWideThreads + tid] - 1);
          if (w) atomicAdd(&h[d], w);
        }
      }
      bins = h;
      cluster.sync();
    }
    // kSelWarps warps sum the cluster's bins, four a lane, 16-byte loads
    unsigned t[4] = {0, 0, 0, 0}, own = 0, inc = 0;
    const int b0 = 4 * (32 * warp + lane);
    if (warp < kSelWarps) {
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c) {
        if (c < nblk) {
          const uint4 a = *reinterpret_cast<const uint4*>(
              cluster.map_shared_rank(bins, c) + b0);
          t[0] += a.x;
          t[1] += a.y;
          t[2] += a.z;
          t[3] += a.w;
        }
      }
      own = t[0] + t[1] + t[2] + t[3];
      inc = warp_incl(own);
      if (lane == 31) sh.pick[warp] = inc;
    }
    __syncthreads();
    if (warp < kSelWarps) {
      unsigned below = inc - own, all = 0;
#pragma unroll
      for (int w = 0; w < kSelWarps; ++w) {
        below += w < warp ? sh.pick[w] : 0u;
        all += sh.pick[w];
      }
      // the one bin where the running total first reaches `want`
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned before = topup ? all - below - t[j] : below;
        if (acc + before < want && want <= acc + before + t[j]) {
          sh.chosen[0] = static_cast<unsigned>(b0 + j);
          sh.chosen[1] = acc + before;
        }
        below += t[j];
      }
    }
    __syncthreads();
    v |= sh.chosen[0] << shift;
    acc = sh.chosen[1];
  }
  const long long m = static_cast<long long>(want - acc);

  // The tie weights (1 a tie on the top-up, the cap on the waterfill) in
  // index order: the earlier segments', the earlier warps', then the
  // earlier lanes'.
  unsigned tie = 0, gl = 0;
#pragma unroll 4
  for (int j = 0; j < kWideE; ++j) {
    if (j < n_in) {
      const uint32_t key = key_s[j * kWideThreads + tid];
      const unsigned w =
          topup ? 1u : static_cast<unsigned>(f_s[j * kWideThreads + tid] - 1);
      tie += key == v ? w : 0u;
      gl += (topup ? key > v : key < v) ? w : 0u;
    }
  }
  const unsigned tie_inc = warp_incl(tie);
  const unsigned gl_w = warp_sum(gl);
  if (lane == 31) {
    sh.warp3[warp][0] = warp_mass;
    sh.warp3[warp][1] = gl_w;
    sh.warp3[warp][2] = tie_inc;
  }
  __syncthreads();
  if (warp == 0) fold_warps(sh, sh.seg, false);
  cluster.sync();
  // A segment's or a warp's final sum from its totals and the tie weights
  // before it: the top-up gives min(max(m - before, 0), ties) more, the
  // waterfill takes as much.
  const auto final_sum = [&](unsigned long long s_f0, unsigned long long s_gl,
                             unsigned long long s_tie, long long n,
                             long long before) -> long long {
    const long long at_v =
        min(max(m - before, 0ll), static_cast<long long>(s_tie));
    return topup ? static_cast<long long>(s_f0) + base * n +
                       (r > 0 ? static_cast<long long>(s_gl) + at_v : 0)
                 : static_cast<long long>(s_f0) -
                       static_cast<long long>(s_gl) - at_v;
  };
  // lane c takes segment c, then lane w warp w of this block: the tie
  // weights and the final sums before each, prefixes over the lanes
  unsigned long long a0 = 0, a1 = 0, a2 = 0;
  if (lane < nblk) {
    const unsigned long long* q = cluster.map_shared_rank(sh.seg, lane);
    a0 = q[0];
    a1 = q[1];
    a2 = q[2];
  }
  cluster_arrive();                         // the last remote read is done
  long long tb = static_cast<long long>(warp_incl(a2) - a2);
  long long n_l =
      lane < nblk ? max(0, min(k, (lane + 1) * seg) - lane * seg) : 0;
  long long fs = lane < nblk ? final_sum(a0, a1, a2, n_l, tb) : 0;
  const long long seg_tie = __shfl_sync(kFull, tb, rank);
  const long long seg_off = __shfl_sync(kFull, warp_incl(fs) - fs, rank);
  const bool wl = lane < kWideWarps;
  a0 = wl ? sh.warp3[lane][0] : 0ull;
  a1 = wl ? sh.warp3[lane][1] : 0ull;
  a2 = wl ? sh.warp3[lane][2] : 0ull;
  tb = seg_tie + static_cast<long long>(warp_incl(a2) - a2);
  n_l = wl ? min(max(n_seg - 32 * kWideE * lane, 0), 32 * kWideE) : 0;
  fs = wl ? final_sum(a0, a1, a2, n_l, tb) : 0;
  long long excl = __shfl_sync(kFull, tb, warp) +
                   static_cast<long long>(tie_inc - tie);
  const long long warp_off =
      seg_off + __shfl_sync(kFull, warp_incl(fs) - fs, warp);

  // the final frequencies, in index order
  int f[kWideE];
  unsigned run = 0;
#pragma unroll
  for (int j = 0; j < kWideE; ++j) {
    const bool in = j < n_in;
    const uint32_t key = key_s[j * kWideThreads + tid];
    const int f0 = f_s[j * kWideThreads + tid];
    const bool at = in && key == v;
    if (topup) {
      f[j] = f0 + base + (r > 0 && in && (key > v || (at && excl < m)));
      excl += at;
    } else {
      const long long cap = f0 - 1;
      const long long take =
          !in ? 0ll
              : (key < v ? cap : (at ? min(max(m - excl, 0ll), cap) : 0ll));
      excl += at ? cap : 0;
      f[j] = f0 - static_cast<int>(take);
    }
    run += in ? f[j] : 0;
  }
  // staged through shared memory (the keys are read), stored coalesced:
  // the frequencies over key_s, step 8's CDF over f_s
  unsigned c = static_cast<unsigned>(warp_off) + warp_incl(run) - run;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kWideE; ++j) {
    const int e = kWideE * tid + j;
    c += f[j];
    key_s[swz(e)] = static_cast<uint32_t>(f[j]);
    reinterpret_cast<uint32_t*>(f_s)[swz(e)] = c;
  }
  __syncthreads();
  int32_t* frow = freq + row * k + s_lo;
  int32_t* crow = cdf ? cdf + row * (k + 1) + s_lo + 1 : nullptr;
  for (int e = tid; e < n_seg; e += kWideThreads) {
    frow[e] = static_cast<int32_t>(key_s[swz(e)]);
    if (crow) crow[e] = static_cast<int32_t>(
        reinterpret_cast<uint32_t*>(f_s)[swz(e)]);
  }
  if (crow && rank == 0 && tid == 0) crow[-1] = 0;
  cluster_wait();
}

template <int E, typename In>
__global__ void __launch_bounds__(32 * kRowWarps) spc_warp_kernel(
    const typename In::T* __restrict__ probs, int b, int k, int prob_bits,
    int32_t* __restrict__ freq, int32_t* __restrict__ cdf) {
  const long long row = static_cast<long long>(blockIdx.x) * kRowWarps +
                        (threadIdx.x >> 5);
  if (row >= b) return;             // warp-uniform
  quantize_row<1, E, In>(probs + row * k, k, prob_bits, freq + row * k,
                         cdf ? cdf + row * (k + 1) : nullptr,
                         Group<1>{nullptr});
}

template <typename In>
__global__ void __launch_bounds__(32 * kBlockWarps) spc_block_kernel(
    const typename In::T* __restrict__ probs, int k, int prob_bits,
    int32_t* __restrict__ freq, int32_t* __restrict__ cdf) {
  __shared__ unsigned long long scratch[kBlockWarps];
  const long long row = blockIdx.x;
  quantize_row<kBlockWarps, kBlockE, In>(
      probs + row * k, k, prob_bits, freq + row * k,
      cdf ? cdf + row * (k + 1) : nullptr, Group<kBlockWarps>{scratch});
}

template <int E, typename In>
void launch_warp(const void* probs, int b, int k, int prob_bits, void* freq,
                 void* cdf, cudaStream_t stream) {
  const int grid = (b + kRowWarps - 1) / kRowWarps;
  spc_warp_kernel<E, In><<<grid, 32 * kRowWarps, 0, stream>>>(
      static_cast<const typename In::T*>(probs), b, k, prob_bits,
      static_cast<int32_t*>(freq), static_cast<int32_t*>(cdf));
}

// Above 48 KB of dynamic shared memory a kernel runs only after opting in.
// The attribute holds per device, so it is set once on each (devices past
// 63 set it on every launch).
template <typename In>
cudaError_t allow_cluster_smem() {
  static std::atomic<unsigned long long> set_on{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit & set_on.load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(spc_cluster_kernel<In>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kWideSmem);
  if (err == cudaSuccess) set_on.fetch_or(bit, std::memory_order_release);
  return err;
}

// The wide layout: C blocks a row, each a cluster (cluster dims along x,
// so the blocks of row i are C * i .. C * i + C - 1).  A launch the card
// refuses returns its error.
template <typename In>
cudaError_t launch_cluster(const void* probs, int b, int k, int prob_bits,
                           void* freq, void* cdf, cudaStream_t stream) {
  const cudaError_t err = allow_cluster_smem<In>();
  if (err != cudaSuccess) return err;
  const int c = (k + kWideSeg - 1) / kWideSeg;
  const int seg = ((k + c - 1) / c + 15) / 16 * 16;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(b) * static_cast<unsigned>(c));
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = kWideSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(c);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, spc_cluster_kernel<In>,
                            static_cast<const typename In::T*>(probs), k,
                            seg, prob_bits, static_cast<int32_t*>(freq),
                            static_cast<int32_t*>(cdf));
}

template <typename In>
cudaError_t launch(const void* probs, int b, int k, int prob_bits,
                   void* freq, void* cdf, cudaStream_t stream) {
  if (k <= 32) {
    launch_warp<1, In>(probs, b, k, prob_bits, freq, cdf, stream);
  } else if (k <= 64) {
    launch_warp<2, In>(probs, b, k, prob_bits, freq, cdf, stream);
  } else if (k <= 128) {
    launch_warp<4, In>(probs, b, k, prob_bits, freq, cdf, stream);
  } else if (k <= 256) {
    launch_warp<8, In>(probs, b, k, prob_bits, freq, cdf, stream);
  } else if (k <= 512) {
    launch_warp<16, In>(probs, b, k, prob_bits, freq, cdf, stream);
  } else if (k <= 1024) {
    launch_warp<32, In>(probs, b, k, prob_bits, freq, cdf, stream);
  } else if (k <= kRegMaxK) {
    spc_block_kernel<In><<<b, 32 * kBlockWarps, 0, stream>>>(
        static_cast<const typename In::T*>(probs), k, prob_bits,
        static_cast<int32_t*>(freq), static_cast<int32_t*>(cdf));
  } else {
    return launch_cluster<In>(probs, b, k, prob_bits, freq, cdf, stream);
  }
  return cudaSuccess;
}

}  // namespace

// probs (B, K) float32 (bf16 = 0) or bfloat16 (bf16 = 1); freq (B, K)
// int32; cdf (B, K + 1) int32 or null.  Rows above 16,384 entries take
// prob_bits <= 16 (the SPC's range; such a K needs 15 or 16).
extern "C" int spc_quantize_launch(const void* probs, int bf16, int b, int k,
                                   int prob_bits, void* freq, void* cdf,
                                   void* stream) {
  if (b < 1 || k < 1 || k > kMaxK || prob_bits < 1 || prob_bits > 30 ||
      k > (1 << prob_bits) || b > 0x7fffffff / kMaxCluster ||
      (k > kRegMaxK && prob_bits > 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch<BF16In>(probs, b, k, prob_bits, freq, cdf, st)
           : launch<F32In>(probs, b, k, prob_bits, freq, cdf, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

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
// mamba2-130m's K = 50,280) fit neither: 65,536 keys are 64 registers a
// thread at 1,024 threads, and 256 KB of keys exceed a block's 227 KB of
// shared memory.  There a block of 1,024 threads owns the row and keeps
// only its BF16 bit patterns in shared memory (2 B an entry, <= 128 KB):
// every radix pass re-derives each entry's f0 and key from them (steps
// 1-5 are a few instructions), the counting passes read entries strided
// over the block, and the last pass, which needs index order for the tie
// ranks and the CDF, gives each warp a contiguous segment that its lanes
// walk 32 entries at a time (warp scans, one cross-warp prefix), so every
// load and store stays coalesced.
//
// What bounds it on this card: instructions.  The selection is 32 group
// counts per row (one per key bit), each E compares and adds per lane and
// one warp reduction, against a byte bound of 6-8 B per entry (the O(K**2)
// pairwise ranking it replaces was 65,536 compares per row at K = 256).  On an H100 (700 W) 128,000 BF16 rows of 256
// take 0.31 ms against a byte bound of 0.059 ms (PERF.md).  The wide
// layout re-derives K keys from shared memory on each of its 32 passes
// (operations again; its times at the mamba2 slice's shapes are in
// PERF.md).  Only the branch a row needs runs.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 65536;        // MAX_K in kernels/spc_quantize.py
constexpr int kRegMaxK = 16384;     // the register layouts' largest K
constexpr int kRowWarps = 4;        // warp-per-row blocks: four rows a block
constexpr int kBlockWarps = 16;     // block-per-row: 512 threads ...
constexpr int kBlockE = 32;         // ... of 32 entries (16,384 / 512)
constexpr int kWideWarps = 32;      // wide rows: a block of 1,024 threads
constexpr int kWideThreads = 32 * kWideWarps;

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

// ---- wide rows (16,384 < K <= 65,536) ------------------------------------

struct WideEntry {
  int f0;
  uint32_t key;
};

// Steps 1-5 of one entry from its BF16 bit pattern (quantize_row's).
__device__ __forceinline__ WideEntry wide_entry(uint16_t b, float scale) {
  const float v = __uint_as_float(static_cast<uint32_t>(b) << 16);
  const float p = (isfinite(v) && v > 0.0f) ? v : 0.0f;
  const float scaled = p * scale;
  const int f0 = max(1, __float2int_rn(scaled));
  return {f0, order_key(scaled - static_cast<float>(f0))};
}

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

// The sum of a warp-uniform `total` over the warps before this one.
__device__ __forceinline__ unsigned long long warps_excl(
    unsigned long long total, unsigned long long* scratch) {
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) scratch[warp] = total;
  __syncthreads();
  unsigned long long before = 0;
  for (int w = 0; w < warp; ++w) before += scratch[w];
  __syncthreads();
  return before;
}

template <typename In>
__global__ void __launch_bounds__(kWideThreads) spc_wide_kernel(
    const typename In::T* __restrict__ probs, int k, int prob_bits,
    int32_t* __restrict__ freq, int32_t* __restrict__ cdf) {
  extern __shared__ uint16_t row_bits[];    // the row's BF16 bit patterns
  __shared__ unsigned long long scratch[kWideWarps];
  const Group<kWideWarps> g{scratch};
  const long long row = blockIdx.x;
  const typename In::T* src = probs + row * k;
  int32_t* frow = freq + row * k;
  int32_t* crow = cdf ? cdf + row * (k + 1) : nullptr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int total = 1 << prob_bits;
  const float scale = static_cast<float>(total);

  unsigned long long mass = 0;
  for (int i = tid; i < k; i += kWideThreads) {
    const uint16_t b = In::bits16(src + i);
    row_bits[i] = b;
    mass += wide_entry(b, scale).f0;
  }
  // (the group sum's barrier also publishes row_bits to the block)
  const long long delta = total - static_cast<long long>(g.sum(mass));

  // Step 6 or 7's selection, counting passes strided over the block: the
  // boundary key v and m, the top-up's count of keys equal to v that get
  // one more, or the waterfill's need left at v.
  const bool topup = delta >= 0;
  const int base = topup ? static_cast<int>(delta / k) : 0;
  const int r = topup ? static_cast<int>(delta % k) : 0;
  uint32_t v = 0;
  long long m = 0;
  if (topup && r > 0) {
    for (int b = 31; b >= 0; --b) {
      const uint32_t c = v | (1u << b);
      unsigned n = 0;
      for (int i = tid; i < k; i += kWideThreads) {
        n += wide_entry(row_bits[i], scale).key >= c;
      }
      if (g.sum(n) >= static_cast<unsigned>(r)) v = c;
    }
    unsigned gt = 0;
    for (int i = tid; i < k; i += kWideThreads) {
      gt += wide_entry(row_bits[i], scale).key > v;
    }
    m = r - static_cast<long long>(g.sum(gt));
  } else if (!topup) {
    const unsigned long long need = static_cast<unsigned long long>(-delta);
    for (int b = 31; b >= 0; --b) {
      const uint32_t x = v | ((1u << b) - 1u);
      unsigned long long w = 0;
      for (int i = tid; i < k; i += kWideThreads) {
        const WideEntry e = wide_entry(row_bits[i], scale);
        w += e.key <= x ? static_cast<unsigned long long>(e.f0 - 1) : 0ull;
      }
      if (g.sum(w) < need) v |= 1u << b;
    }
    unsigned long long lt = 0;
    for (int i = tid; i < k; i += kWideThreads) {
      const WideEntry e = wide_entry(row_bits[i], scale);
      lt += e.key < v ? static_cast<unsigned long long>(e.f0 - 1) : 0ull;
    }
    m = static_cast<long long>(need - g.sum(lt));
  }

  // The last pass in index order: warp w owns entries [w * seg, (w + 1) *
  // seg), its lanes taking 32 consecutive entries a round.  The tie
  // weights (1 a tie on the top-up, the cap on the waterfill) before each
  // entry are the earlier warps' totals plus a running warp scan.
  const bool ties = !topup || r > 0;        // block-uniform
  const int seg = (k + kWideThreads - 1) / kWideThreads * 32;
  const int lo = warp * seg, hi = min(k, lo + seg);
  long long before = 0;
  if (ties) {
    unsigned long long mine = 0;
    for (int i = lo + lane; i < hi; i += 32) {
      const WideEntry e = wide_entry(row_bits[i], scale);
      mine += e.key == v ? (topup ? 1ull : static_cast<unsigned long long>(
                                               e.f0 - 1))
                         : 0ull;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mine += __shfl_xor_sync(kFull, mine, o);
    before = static_cast<long long>(warps_excl(mine, scratch));
  }
  unsigned fsum = 0;
  for (int j = 0; j < seg; j += 32) {
    const int i = lo + j + lane;
    const bool in = i < hi;
    const WideEntry e = in ? wide_entry(row_bits[i], scale) : WideEntry{1, 0u};
    const bool at = in && e.key == v;
    const long long t = at ? (topup ? 1ll : e.f0 - 1ll) : 0ll;
    long long excl = 0;
    if (ties) {
      const long long inc = warp_incl(t);
      excl = before + inc - t;
      before += __shfl_sync(kFull, inc, 31);
    }
    int f;
    if (topup) {
      f = e.f0 + base + (r > 0 && (e.key > v || (at && excl < m)));
    } else {
      const long long cap = e.f0 - 1;
      const long long take =
          e.key < v ? cap : (at ? min(max(m - excl, 0ll), cap) : 0ll);
      f = e.f0 - static_cast<int>(take);
    }
    if (in) {
      frow[i] = f;
      fsum += f;
    }
  }

  if (crow != nullptr) {                    // step 8, the same walk
    unsigned run = static_cast<unsigned>(
        warps_excl(__reduce_add_sync(kFull, fsum), scratch));
    if (tid == 0) crow[0] = 0;
    for (int j = 0; j < seg; j += 32) {
      const int i = lo + j + lane;
      const unsigned f = i < hi ? static_cast<unsigned>(frow[i]) : 0u;
      const unsigned inc = warp_incl(f);
      if (i < hi) crow[i + 1] = static_cast<int32_t>(run + inc);
      run += __shfl_sync(kFull, inc, 31);
    }
  }
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
cudaError_t allow_wide_smem() {
  static std::atomic<unsigned long long> set_on{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit & set_on.load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(
      spc_wide_kernel<In>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxK * sizeof(uint16_t)));
  if (err == cudaSuccess) set_on.fetch_or(bit, std::memory_order_release);
  return err;
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
    const cudaError_t err = allow_wide_smem<In>();
    if (err != cudaSuccess) return err;
    spc_wide_kernel<In>
        <<<b, kWideThreads, static_cast<size_t>(k) * sizeof(uint16_t),
           stream>>>(static_cast<const typename In::T*>(probs), k,
                     prob_bits, static_cast<int32_t*>(freq),
                     static_cast<int32_t*>(cdf));
  }
  return cudaSuccess;
}

}  // namespace

// probs (B, K) float32 (bf16 = 0) or bfloat16 (bf16 = 1); freq (B, K)
// int32; cdf (B, K + 1) int32 or null.
extern "C" int spc_quantize_launch(const void* probs, int bf16, int b, int k,
                                   int prob_bits, void* freq, void* cdf,
                                   void* stream) {
  if (b < 1 || k < 1 || k > kMaxK || prob_bits < 1 || prob_bits > 30 ||
      k > (1 << prob_bits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch<BF16In>(probs, b, k, prob_bits, freq, cdf, st)
           : launch<F32In>(probs, b, k, prob_bits, freq, cdf, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

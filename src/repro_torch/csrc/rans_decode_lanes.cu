// Full-stream multi-lane rANS decode for Hopper (sm_90a): kernels B3 and B4.
//
// Replaces the TPU kernels repro/kernels/rans_decode.py::rans_decode_lanes
// (B3) and ::rans_decode_slab (B4), one Pallas body (_decode_kernel) entered
// two ways.  One launch decodes a whole stream; each (chunk, lane) cell is
// a standalone stream whose rows it walks in order, writing
// sym[lane, c * chunk + t] directly.  Per cell:
//   the 4-byte big-endian state header at start;
//   per row: slot = s & (2**n - 1); the symbol x with cdf[x] <= slot <
//   cdf[x+1] and the normative probe count of core/search.py (candidates,
//   the predictor's window verify, the bisection with its early commit);
//   s = f * (s >> n) + slot - cdf[x] (mod 2**32) and the 2-step masked
//   refill.
// The predictor context resets per chunk: NeighborAverage (mean of the
// valid entries of the last `window` symbols, a -1 fill at the chunk's
// start, 0 with none valid), LastValue (0 at the start), ZeroPredictor.
//
// Byte sources.  B3 reads the dense right-aligned (n_chunks, lanes, cap)
// streams: column p of a cell reads buf[cell, p] for 0 <= p < cap and 0
// elsewhere; the read limit is cap.  B4 reads the packed (S,) container
// payload through per-cell windows of cap bytes at `base` (host-clipped to
// [0, S - cap]): column p reads slab[base + p] only when 0 <= p < cap and
// wstart <= p < wstart + wlen, and 0 otherwise; the read limit is
// wstart + wlen.  A hostile index therefore reads zeros inside the slab,
// exactly as the reference's clamped VMEM windows do.  A cell reads the
// consecutive columns start, start + 1, ...; `under` counts those at or
// past the limit or before 0, so it follows from the first and the last
// column read and is computed once per cell.
//
// What bounds it on this card, and the design.  Each cell is a serial
// chain of dependent steps and the stream format fixes the number of cells
// (64 to 512 on this repository's paths), so a step's latency, and the
// instructions one warp issues per step, are the kernel's time, far above
// its byte or operation bound.  The design takes the search, the predictor
// and the probe counter off the state's chain (decode_search.cuh):
//  * Static (K,) tables (K <= kSlotTableMax, the image path and Fig. 4):
//    one thread per cell, blocks of one warp, so 256 cells take 8 SMs.
//    Each block builds in shared memory the (freq, cdf) pairs, a 2**n
//    slot -> symbol table (uint8 for K <= 256, else uint16; up to 128 KB at
//    n = 16, with the dynamic shared memory opt-in) and tables of the
//    bisection's probe counts, after checking with a block vote that the
//    CDF is strictly increasing from 0 and covers every slot.  The chain is
//    then slot -> lut[slot] -> one 64-bit (f, c) load -> the update -> a
//    refill from the stream bytes that cp.async brought into a shared ring
//    a period ahead.  The probes are replayed from x with one table load,
//    the NeighborAverage mean is a running sum times a reciprocal, and the
//    step has no branch, so they fill the chain's load latencies.
//  * Per-position (T, K) and per-lane (T, lanes, K) rows, and static tables
//    above the slot path's limits: one warp per cell, four per block.  Row
//    t + 3 is copied (cp.async, 16 bytes a lane) into a shared ring while
//    row t decodes; each lane tests its entries and one ballot per 32
//    entries counts those at or below the slot, so the symbol is the count
//    less one, read back with its (f, c) from the ring; the probes are
//    replayed; every lane carries the state and a register window of the
//    next stream bytes (a warp crosses words in step, so no lane waits on
//    another's load).
//  * A table that breaks the identity (a zero frequency) runs the exact
//    bisection: the whole launch on a static table, the row on the warp
//    path.  The launch ORs which branches ran into `branch` (kSlotTable,
//    kSharedBisect, kWarpRows, kWarpBisect).

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "decode_search.cuh"

namespace {

namespace ds = decode_search;

constexpr uint32_t kRansL = 1u << 23;
constexpr int kMaxWindow = 16;
constexpr int kSlotTableMax = 4096;   // largest static K of the slot path
constexpr int kMaxSlotBits = 16;      // largest prob_bits of the slot path
constexpr int kSlotBlock = 32;        // one warp: one cell per thread
constexpr int kWarpBlock = 128;       // four warps: one cell per warp
constexpr int kWinTab = 64;           // window widths replayed by table
constexpr size_t kMaxSmem = 232448;   // 227 KB a block may use

enum Predictor : int {
  kNone = 0,
  kNeighborAverage = 1,
  kLastValue = 2,
  kZero = 3,
};

enum Branch : int {
  kSlotTable = 1,
  kSharedBisect = 2,
  kWarpRows = 4,
  kWarpBisect = 8,
};

struct Args {
  const uint8_t* src;
  const int32_t* start;
  const int32_t* base;   // B4 only
  const int32_t* wlen;   // B4 only
  int cap;
  const uint32_t* freq;
  const uint32_t* cdf;
  long long f_st, f_sl, c_st, c_sl;
  int k;
  const int32_t* cands;
  int topk, lanes, t_len, chunk, n_chunks, prob_bits, n_iter, window, delta;
  int32_t* sym;
  int32_t* probes;
  int32_t* under;
  int32_t* branch;
};

// One cell's geometry and byte source: row[p] is readable for lo <= p <
// hi; reads before 0 or at or past `limit` count as underflow.
struct Cell {
  int c, lane, t0, n;
  const uint8_t* row;
  long long ws, lo, hi, limit;

  __device__ __forceinline__ uint32_t byte(long long p) const {
    return (p >= lo && p < hi) ? static_cast<uint32_t>(row[p]) : 0u;
  }
};

__device__ __forceinline__ Cell make_cell(const Args& a, int cell) {
  Cell cl;
  cl.c = cell / a.lanes;
  cl.lane = cell - cl.c * a.lanes;
  cl.t0 = cl.c * a.chunk;
  cl.n = min(a.chunk, a.t_len - cl.t0);
  cl.ws = a.start[cell];
  if (a.base != nullptr) {
    cl.row = a.src + a.base[cell];
    cl.limit = cl.ws + a.wlen[cell];
    cl.lo = cl.ws > 0 ? cl.ws : 0;
    cl.hi = cl.limit < a.cap ? cl.limit : a.cap;
  } else {
    cl.row = a.src + static_cast<long long>(cell) * a.cap;
    cl.lo = 0;
    cl.hi = a.cap;
    cl.limit = a.cap;
  }
  return cl;
}

// A cell's byte source.  Both forms read column ws + j (j counts the
// columns consumed, header included) as 0 outside [lo, hi), and both load
// ahead of need, since the columns' addresses are known before the state.
//
// StreamRing (thread path): a 64-byte ring per thread in shared memory,
// four 16-byte chunks at 16-byte aligned addresses, filled by cp.async.
// Every kRefillSteps steps (at most 16 columns) the thread requests chunks
// up to three past the one holding column j and waits for the group issued
// a period earlier, so the chunks it reads have landed; no register waits
// on a load.  (A per-thread register window would: the warp shares one
// scoreboard per register, and threads cross words at different steps.)
// ByteWindow (warp path): the 8-byte aligned word holding the column and
// the next one in registers; every lane of the warp crosses words together.

constexpr int kRefillSteps = 8;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

struct StreamRing {
  static constexpr int kUnroll = kRefillSteps;
  unsigned char* col;     // this thread's 16 bytes of each chunk slot
  const uint8_t* row;
  long long lo, hi, ws, ph, fill_q;
  int jlo, jn;            // readable j: jlo <= j < jlo + jn
  uint32_t u0;            // ws + ph (mod 2**32)

  __device__ __forceinline__ void request(long long q) {
    const long long p0 = 16 * q - ph;
    if (p0 + 16 > lo && p0 < hi) {
      cp_async16(col + (q & 3) * (16 * kSlotBlock), row + p0);
    }
  }
  __device__ __forceinline__ void top_up(int j) {
    const long long qc = (ws + j + ph) >> 4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (fill_q < qc + 4) {
        request(fill_q);
        ++fill_q;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  __device__ __forceinline__ void init(const Cell& cl) {
    row = cl.row;
    lo = cl.lo;
    hi = cl.hi;
    ws = cl.ws;
    ph = static_cast<long long>(reinterpret_cast<uintptr_t>(cl.row) & 15u);
    const long long jl = lo - ws;
    const long long jh = hi - ws;
    const long long cap = 1ll << 30;
    jlo = static_cast<int>(jl < 0 ? 0 : (jl > cap ? cap : jl));
    const int jhi = static_cast<int>(jh < 0 ? 0 : (jh > cap ? cap : jh));
    jn = jhi > jlo ? jhi - jlo : 0;
    u0 = static_cast<uint32_t>(ws + ph);
    fill_q = (ws + ph) >> 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      request(fill_q);
      ++fill_q;
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
  }
  __device__ __forceinline__ void refill(int j) {
    top_up(j);
    asm volatile("cp.async.wait_group 1;\n" ::);
  }
  __device__ __forceinline__ uint32_t byte(int j) const {
    const uint32_t u = u0 + static_cast<uint32_t>(j);
    const uint32_t v = col[((u >> 4) & 3u) * (16 * kSlotBlock) + (u & 15u)];
    return static_cast<unsigned>(j - jlo) < static_cast<unsigned>(jn) ? v
                                                                       : 0u;
  }
  __device__ __forceinline__ uint32_t header() const {
    return byte(0) << 24 | byte(1) << 16 | byte(2) << 8 | byte(3);
  }
  __device__ __forceinline__ uint32_t two(int j) const {
    return byte(j) << 8 | byte(j + 1);
  }
  __device__ __forceinline__ void consume(int) {}
};

struct ByteWindow {
  static constexpr int kUnroll = 1;
  Cell cl;
  long long wpos;               // column of cur's first byte
  unsigned long long cur, nxt;
  int o;                        // column ptr - wpos, in [0, 8)

  __device__ __forceinline__ unsigned long long word(long long p0) const {
    if (p0 + 8 <= cl.lo || p0 >= cl.hi) return 0ull;
    unsigned long long v =
        __ldg(reinterpret_cast<const unsigned long long*>(cl.row + p0));
    const long long a = cl.lo - p0;
    const long long b = cl.hi - p0;
    if (a > 0) v &= ~0ull << (8 * a);
    if (b < 8) v &= (1ull << (8 * b)) - 1ull;
    return v;
  }
  __device__ __forceinline__ void init(const Cell& c) {
    cl = c;
    const long long ptr = cl.ws + 4;
    const long long ph = static_cast<long long>(
        reinterpret_cast<uintptr_t>(cl.row) & 7u);
    wpos = ((ptr + ph) & ~7ll) - ph;
    o = static_cast<int>(ptr - wpos);
    cur = word(wpos);
    nxt = word(wpos + 8);
  }
  __device__ __forceinline__ uint32_t header() const {
    uint32_t s = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) s = (s << 8) | cl.byte(cl.ws + i);
    return s;
  }
  __device__ __forceinline__ void refill(int) {}
  // The bytes at the next two columns as b0 << 8 | b1.
  __device__ __forceinline__ uint32_t two(int) const {
    const unsigned long long v =
        o ? (cur >> (8 * o)) | (nxt << (64 - 8 * o)) : cur;
    return (static_cast<uint32_t>(v) & 0xffu) << 8 |
           (static_cast<uint32_t>(v) >> 8 & 0xffu);
  }
  __device__ __forceinline__ void consume(int r) {
    o += r;
    if (o >= 8) {
      o -= 8;
      wpos += 8;
      cur = nxt;
      nxt = word(wpos + 8);
    }
  }
};

// The predictor window's ring of the last `window` symbols: one thread's
// column of a shared array (thread path) or one entry per lane (warp path).
struct SmemRing {
  int32_t* col;
  __device__ __forceinline__ int32_t get(int h) const {
    return col[h * kSlotBlock];
  }
  __device__ __forceinline__ void put(int h, int32_t x) {
    col[h * kSlotBlock] = x;
  }
};

struct LaneRing {
  int32_t v;
  __device__ __forceinline__ int32_t get(int h) const {
    return __shfl_sync(ds::kFullMask, v, h);
  }
  __device__ __forceinline__ void put(int h, int32_t x) {
    if ((threadIdx.x & 31) == h) v = x;
  }
};

// The in-kernel predictors with a running sum: mu is the mean of the valid
// entries (n_valid = min(steps so far, window)) in 32 bits, sum // n as
// umulhi(sum, ceil(2**32 / n)): exact while sum * (n * rcp[n] - 2**32) <
// 2**32, i.e. for sums below 2**28 (16 * K with K < 2**24).
__host__ __device__ constexpr uint32_t mean_rcp(int n) {
  return n > 1 ? 0xffffffffu / static_cast<uint32_t>(n) + 1u : 0u;
}

__constant__ uint32_t kMeanRcp[kMaxWindow + 1] = {
    mean_rcp(0),  mean_rcp(1),  mean_rcp(2),  mean_rcp(3),  mean_rcp(4),
    mean_rcp(5),  mean_rcp(6),  mean_rcp(7),  mean_rcp(8),  mean_rcp(9),
    mean_rcp(10), mean_rcp(11), mean_rcp(12), mean_rcp(13), mean_rcp(14),
    mean_rcp(15), mean_rcp(16)};

template <int kPred, typename Ring>
struct PredState {
  Ring ring;
  uint32_t sum;
  int cnt, head, last;

  __device__ __forceinline__ void reset() {
    sum = 0;
    cnt = 0;
    head = 0;
    last = 0;
  }

  __device__ __forceinline__ void bounds(int k, int delta, int& lo_w,
                                         int& hi_w) const {
    if (kPred == kNone) return;
    int mu = 0;
    if (kPred == kNeighborAverage) {
      mu = static_cast<int>(cnt > 1 ? __umulhi(sum, kMeanRcp[cnt]) : sum);
    } else if (kPred == kLastValue) {
      mu = last;
    }
    // delta arrives clamped to [-(K+1), K+1], which leaves every window
    // as it was and keeps this in 32 bits
    lo_w = min(max(mu - delta, 0), k - 1);
    hi_w = min(max(mu + delta + 1, 1), k);
  }

  __device__ __forceinline__ void push(int x, int window) {
    if (kPred == kNeighborAverage) {
      const bool full = cnt == window;
      const uint32_t old = static_cast<uint32_t>(ring.get(head));
      sum = sum + static_cast<uint32_t>(x) - (full ? old : 0u);
      cnt += full ? 0 : 1;
      ring.put(head, x);
      head = head + 1 == window ? 0 : head + 1;
    } else if (kPred == kLastValue) {
      last = x;
    }
  }
};

struct Found {
  int x;
  uint32_t f, c;
};

// Decode one cell; `step(t, slot, lo_w, hi_w, probes)` finds the symbol
// and its (f, c) and adds the step's probes.  Only `writer` threads store.
// The loop runs Bytes::kUnroll steps between refills.
template <int kPred, typename Ring, typename Bytes, typename Step>
__device__ __forceinline__ void decode_cell(const Args& a, const Cell& cl,
                                            Ring ring, Bytes& bytes,
                                            Step& step, bool writer) {
  bytes.init(cl);
  uint32_t s = bytes.header();
  PredState<kPred, Ring> pred;
  pred.ring = ring;
  pred.reset();

  const int n_bits = a.prob_bits;
  const uint32_t mask = (1u << n_bits) - 1u;
  int32_t* sym_row = a.sym + static_cast<long long>(cl.lane) * a.t_len + cl.t0;
  int probes = 0;
  int j = 4;                       // columns read: the header, the refills
  auto one = [&](int t) {
    const uint32_t slot = s & mask;
    int lo_w = 0;
    int hi_w = 0;
    pred.bounds(a.k, a.delta, lo_w, hi_w);
    const Found fx = step(t, slot, lo_w, hi_w, probes);
    const uint32_t two = bytes.two(j);          // b0 << 8 | b1
    const uint32_t s1 = fx.f * (s >> n_bits) + slot - fx.c;
    const int r = (s1 < kRansL) + (s1 < (1u << 15));
    // r refills: s1 << 8r | the first r of b0, b1 (no branch)
    s = (s1 << (8 * r)) | (two >> (16 - 8 * r));
    bytes.consume(r);
    j += r;
    if (writer) sym_row[t] = fx.x;
    pred.push(fx.x, a.window);
  };
  int t = 0;
  for (; t + Bytes::kUnroll <= cl.n; t += Bytes::kUnroll) {
    bytes.refill(j);
#pragma unroll
    for (int u = 0; u < Bytes::kUnroll; ++u) one(t + u);
  }
  if (t < cl.n) {
    bytes.refill(j);
    for (; t < cl.n; ++t) one(t);
  }
  if (writer) {
    // columns ws .. ws + j - 1 were read; count those outside [0, limit)
    const int cell = cl.c * a.lanes + cl.lane;
    const long long end = cl.ws + j;
    const long long in_lo = cl.ws > 0 ? cl.ws : 0;
    const long long in_hi = end < cl.limit ? end : cl.limit;
    const long long inside = in_hi > in_lo ? in_hi - in_lo : 0;
    a.probes[cell] = probes;
    a.under[cell] = static_cast<int32_t>(j - inside);
  }
}

// ---------------------------------------------------------------------------
// Static tables in shared memory: the slot-table path and its bisection
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t align16(size_t v) {
  return (v + 15) & ~static_cast<size_t>(15);
}

// Shared-memory layout of the static path: (K+1) (f, c) pairs, K full-range
// probe counts, kWinTab x kWinTab window probe counts, the predictor ring,
// the byte rings, then the 2**n slot table.
struct SlotLayout {
  size_t full, win, ring, bytes, lut, total;
};

__host__ __device__ inline SlotLayout slot_layout(int k, int prob_bits,
                                                  int lut_bytes) {
  SlotLayout l;
  l.full = align16(static_cast<size_t>(k + 1) * 8);
  l.win = align16(l.full + static_cast<size_t>(k) * 2);
  l.ring = align16(l.win + kWinTab * kWinTab * 2);
  l.bytes = align16(l.ring + kMaxWindow * kSlotBlock * 4);
  l.lut = l.bytes + 4 * 16 * kSlotBlock;
  l.total = align16(l.lut + (static_cast<size_t>(lut_bytes) << prob_bits));
  return l;
}

// Probe counts of the bisection, packed as at_start = 0 | at_start = 1
// << 8: full[x] for [0, K), win[w * kWinTab + off] for windows of width
// w < K (the launcher routes windows wider than the table to the warp
// path), so the lookup is one shared load with no branch.
struct TableDepth {
  const uint16_t* full;
  const uint16_t* win;
  int k;
  __device__ __forceinline__ int operator()(int w, int off, bool at) const {
    const int v = w == k ? full[off] : win[w * kWinTab + off];
    return at ? v >> 8 : v & 0xff;
  }
};

template <typename Lut, bool kCands>
struct SlotStep {
  const Lut* lut;
  const uint2* pair;
  TableDepth depth;
  const int32_t* cands;   // this cell's first candidate row
  long long cand_stride;
  int topk, k;
  bool window;

  __device__ __forceinline__ Found operator()(int t, uint32_t slot, int lo_w,
                                              int hi_w, int& probes) const {
    const int x = lut[slot];
    const uint2 fc = pair[x];
    bool found = false;
    int cp = 0;
    if (kCands) {
      cp = ds::thread_cand_probes(cands + t * cand_stride, topk, k, x, found);
    }
    probes += ds::replay_probes(x, slot == fc.y, cp, found, window, lo_w,
                                hi_w, k, depth);
    return {x, fc.x, fc.y};
  }
};

struct SharedCdf {
  const uint2* pair;
  __device__ __forceinline__ uint32_t operator()(int i) const {
    return pair[i].y;
  }
};

struct SharedBisectStep {
  const uint2* pair;
  const int32_t* cands;
  long long cand_stride;
  int topk, k, n_iter;
  bool window;

  __device__ __forceinline__ Found operator()(int t, uint32_t slot, int lo_w,
                                              int hi_w, int& probes) const {
    const int x = ds::exact_search(SharedCdf{pair}, slot, k, n_iter,
                                   cands + t * cand_stride, topk, window,
                                   lo_w, hi_w, probes);
    return {x, pair[x].x, pair[x].y};
  }
};

template <int kPred, typename Lut, bool kCands>
__global__ void __launch_bounds__(kSlotBlock) slot_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = a.k;
  const int n_slots = 1 << a.prob_bits;
  const SlotLayout l = slot_layout(k, a.prob_bits, sizeof(Lut));
  uint2* pair = reinterpret_cast<uint2*>(smem);
  uint16_t* full = reinterpret_cast<uint16_t*>(smem + l.full);
  uint16_t* win = reinterpret_cast<uint16_t*>(smem + l.win);
  int32_t* ring = reinterpret_cast<int32_t*>(smem + l.ring);
  Lut* lut = reinterpret_cast<Lut*>(smem + l.lut);
  const int tid = threadIdx.x;

  for (int i = tid; i < k; i += blockDim.x) {
    pair[i] = make_uint2(a.freq[i], a.cdf[i]);
  }
  if (tid == 0) pair[k] = make_uint2(0u, a.cdf[k]);
  __syncthreads();
  // The identity needs a strictly increasing CDF from 0 that covers every
  // slot (for an SPC table, cdf = cumsum(freq): every frequency >= 1).
  int ok = tid == 0 ? (pair[0].y == 0u &&
                       pair[k].y >= static_cast<uint32_t>(n_slots))
                    : 1;
  for (int i = tid; i < k; i += blockDim.x) {
    ok = ok && pair[i].y < pair[i + 1].y;
  }
  ok = __syncthreads_and(ok);
  if (ok) {
    // lut: groups of 16 slots, the first by bisection, the rest by walking
    for (int g = tid; g * 16 < n_slots; g += blockDim.x) {
      const uint32_t s0 = static_cast<uint32_t>(g) * 16u;
      int lo = 0;
      int hi = k;
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (pair[mid].y <= s0) lo = mid; else hi = mid;
      }
      for (int i = 0; i < 16 && s0 + i < static_cast<uint32_t>(n_slots); ++i) {
        while (pair[lo + 1].y <= s0 + i) ++lo;
        lut[s0 + i] = static_cast<Lut>(lo);
      }
    }
    for (int x = tid; x < k; x += blockDim.x) {
      full[x] = static_cast<uint16_t>(ds::bisect_probes(k, x, false) |
                                      ds::bisect_probes(k, x, true) << 8);
    }
    if (kPred != kNone) {
      for (int i = tid; i < kWinTab * kWinTab; i += blockDim.x) {
        const int w = i / kWinTab;
        const int off = i - w * kWinTab;
        win[i] = off < w ? static_cast<uint16_t>(
                               ds::bisect_probes(w, off, false) |
                               ds::bisect_probes(w, off, true) << 8)
                         : 0;
      }
    }
  }
  __syncthreads();
  if (tid == 0) atomicOr(a.branch, ok ? kSlotTable : kSharedBisect);

  const int cell = blockIdx.x * blockDim.x + tid;
  if (cell >= a.n_chunks * a.lanes) return;
  const Cell cl = make_cell(a, cell);
  const long long stride = static_cast<long long>(a.lanes) * a.topk;
  const int32_t* cands =
      a.topk ? a.cands + (static_cast<long long>(cl.t0) * a.lanes + cl.lane) *
                             a.topk
             : nullptr;
  const SmemRing r{ring + tid};
  StreamRing bytes;
  bytes.col = smem + l.bytes + tid * 16;
  if (ok) {
    SlotStep<Lut, kCands> step{lut, pair, TableDepth{full, win, k}, cands,
                               stride, a.topk, k, kPred != kNone};
    decode_cell<kPred>(a, cl, r, bytes, step, true);
  } else {
    SharedBisectStep step{pair, cands, stride, a.topk, k, a.n_iter,
                          kPred != kNone};
    decode_cell<kPred>(a, cl, r, bytes, step, true);
  }
}

// ---------------------------------------------------------------------------
// Rows in device memory: one warp per cell
// ---------------------------------------------------------------------------

// A warp's rows in flight: row t's first pass (cdf entries 0 .. 256, freq
// entries 0 .. 255) and its first 32 candidates, in slot t % kRowRing of
// this warp's ring, requested kRowRing - 1 steps ahead as 16-byte cp.async
// chunks from the 16-byte aligned word at or below each segment's start
// (entry e then sits `shift` words in).  After its wait_group, a
// __syncwarp makes the whole row visible to the warp.
constexpr int kRowRing = 4;
constexpr int kCdfWords = 260;       // 257 entries + 3 of shift, 16 B multiple
constexpr int kFreqWords = 260;      // 256 + 3
constexpr int kCandWords = 36;       // 32 + 3
constexpr int kRowWords = kCdfWords + kFreqWords + kCandWords;
constexpr int kWarps = kWarpBlock / 32;

__device__ __forceinline__ int word_shift(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3u);
}

// Copy entries 0 .. n - 1 of `src` (n >= 1) into `dst` shifted by
// word_shift(src), 16 bytes a lane at a time (at most kMaxChunks); the
// chunks read stay inside the 16-byte blocks that hold the entries.
template <int kMaxChunks>
__device__ __forceinline__ void copy_words(uint32_t* dst, const void* src,
                                           int n) {
  const int lane = threadIdx.x & 31;
  const int sh = word_shift(src);
  const uint32_t* base = static_cast<const uint32_t*>(src) - sh;
  const int chunks = (sh + n + 3) >> 2;
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
#pragma unroll
  for (int j = 0; j < (kMaxChunks + 31) / 32; ++j) {
    const int i = lane + 32 * j;
    if (i < chunks) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       d + 16 * i),
                   "l"(base + 4 * i));
    }
  }
}

// Shared-memory layout of the warp path: the warps' row rings, then (with
// a TableDepth) the K full-range and kWinTab x kWinTab window probe counts.
struct WarpLayout {
  size_t full, win, total;
};

__host__ __device__ inline WarpLayout warp_layout(int k, bool tables) {
  WarpLayout l;
  l.full = static_cast<size_t>(kWarps) * kRowRing * kRowWords * 4;
  l.win = align16(l.full + (tables ? static_cast<size_t>(k) * 2 : 0));
  l.total = l.win + (tables ? kWinTab * kWinTab * 2 : 0);
  return l;
}

struct SmemRowCdf {
  const uint32_t* row;
  __device__ __forceinline__ uint32_t operator()(int e) const {
    return row[e];
  }
};

// One warp's cell: row t of its tables at cd0 + t * c_st and fr0 + t *
// f_st, its candidates at cand0 + t * cand_st.
template <typename Depth>
struct WarpStep {
  const uint32_t* cd0;
  const uint32_t* fr0;
  const int32_t* cand0;
  long long c_st, f_st, cand_st;
  int k, n, n_pass, topk, n_iter;
  bool has_window;
  Depth depth;
  uint32_t* ring;          // this warp's kRowRing x kRowWords
  int req_t;               // the next row to request
  int flags;

  __device__ __forceinline__ const uint32_t* cd(int t) const {
    return cd0 + t * c_st;
  }
  __device__ __forceinline__ const uint32_t* fr(int t) const {
    return fr0 + t * f_st;
  }
  __device__ __forceinline__ const int32_t* cands(int t) const {
    return topk ? cand0 + t * cand_st : nullptr;
  }

  // Request row req_t; one commit group per call, empty past the chunk.
  __device__ __forceinline__ void request() {
    const int t = req_t++;
    if (t < n) {
      uint32_t* slot = ring + (t % kRowRing) * kRowWords;
      copy_words<kCdfWords / 4>(slot, cd(t), min(k, ds::kPassEntries) + 1);
      copy_words<kFreqWords / 4>(slot + kCdfWords, fr(t),
                                 min(k, ds::kPassEntries));
      if (topk) {
        copy_words<kCandWords / 4>(slot + kCdfWords + kFreqWords, cands(t),
                                   min(topk, 32));
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }

  __device__ __forceinline__ Found operator()(int t, uint32_t slot, int lo_w,
                                              int hi_w, int& probes) {
    __syncwarp();              // every lane is done with row t - 1's slot
    request();
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kRowRing - 1));
    __syncwarp();
    const int lane = threadIdx.x & 31;
    const uint32_t* slot_row = ring + (t % kRowRing) * kRowWords;
    const uint32_t* row = slot_row + word_shift(cd(t));
    const uint32_t* frow = slot_row + kCdfWords + word_shift(fr(t));
    int count = 0;
    bool strict = true;
    ds::warp_count_pass(SmemRowCdf{row}, k, 0, slot, count, strict);
    for (int pass = 1; pass < n_pass; ++pass) {
      ds::warp_count_pass(ds::GlobalCdf{cd(t)}, k, pass * ds::kPassEntries,
                          slot, count, strict);
    }
    const int x = count - 1;
    const bool near = x < ds::kPassEntries;   // x + 1 is in the ring too
    const int xr = near && x >= 0 ? x : 0;    // (reads issued together)
    uint32_t c = row[xr];
    uint32_t c1 = row[xr + 1];
    uint32_t f = frow[xr];
    const int first = lane < topk
        ? static_cast<int>(slot_row[kCdfWords + kFreqWords +
                                    word_shift(cands(t)) + lane])
        : -1;
    if (!near && x >= 0) {
      c = __ldg(cd(t) + x);
      c1 = __ldg(cd(t) + x + 1);
      f = __ldg(fr(t) + x);
    }
    if (__all_sync(ds::kFullMask, strict) && count > 0 && slot < c1) {
      bool found = false;
      int cp = 0;
      if (topk) cp = ds::warp_cand_probes(cands(t), topk, k, x, first, found);
      probes += ds::replay_probes(x, slot == c, cp, found, has_window, lo_w,
                                  hi_w, k, depth);
      flags |= kWarpRows;
      return {x, f, c};
    }
    int p = 0;
    const int xe = ds::exact_search(ds::GlobalCdf{cd(t)}, slot, k, n_iter,
                                    cands(t), topk, has_window, lo_w, hi_w,
                                    p);
    probes += p;
    flags |= kWarpBisect;
    return {xe, __ldg(fr(t) + xe), __ldg(cd(t) + xe)};
  }
};

template <int kPred, bool kTables>
__global__ void __launch_bounds__(kWarpBlock) warp_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WarpLayout l = warp_layout(a.k, kTables);
  uint16_t* full = reinterpret_cast<uint16_t*>(smem + l.full);
  uint16_t* win = reinterpret_cast<uint16_t*>(smem + l.win);
  if (kTables) {
    for (int x = threadIdx.x; x < a.k; x += blockDim.x) {
      full[x] = static_cast<uint16_t>(ds::bisect_probes(a.k, x, false) |
                                      ds::bisect_probes(a.k, x, true) << 8);
    }
    if (kPred != kNone) {
      for (int i = threadIdx.x; i < kWinTab * kWinTab; i += blockDim.x) {
        const int w = i / kWinTab;
        const int off = i - w * kWinTab;
        win[i] = off < w ? static_cast<uint16_t>(
                               ds::bisect_probes(w, off, false) |
                               ds::bisect_probes(w, off, true) << 8)
                         : 0;
      }
    }
    __syncthreads();
  }
  const int warp = threadIdx.x >> 5;
  const int cell = blockIdx.x * kWarps + warp;
  if (cell >= a.n_chunks * a.lanes) return;
  const Cell cl = make_cell(a, cell);
  using Depth =
      typename std::conditional<kTables, TableDepth, ds::LoopDepth>::type;
  WarpStep<Depth> step;
  step.cd0 = a.cdf + cl.t0 * a.c_st + cl.lane * a.c_sl;
  step.fr0 = a.freq + cl.t0 * a.f_st + cl.lane * a.f_sl;
  step.cand_st = static_cast<long long>(a.lanes) * a.topk;
  step.cand0 = a.topk ? a.cands + (static_cast<long long>(cl.t0) * a.lanes +
                                   cl.lane) * a.topk
                      : nullptr;
  step.c_st = a.c_st;
  step.f_st = a.f_st;
  step.k = a.k;
  step.n = cl.n;
  step.n_pass = (a.k + ds::kPassEntries - 1) / ds::kPassEntries;
  step.topk = a.topk;
  step.n_iter = a.n_iter;
  step.has_window = kPred != kNone;
  if constexpr (kTables) {
    step.depth = TableDepth{full, win, a.k};
  }
  step.ring = reinterpret_cast<uint32_t*>(smem) + warp * kRowRing * kRowWords;
  step.req_t = 0;
  step.flags = 0;
  for (int t = 0; t < kRowRing - 1; ++t) step.request();
  const bool lane0 = (threadIdx.x & 31) == 0;
  ByteWindow bytes;
  decode_cell<kPred>(a, cl, LaneRing{0}, bytes, step, lane0);
  if (lane0) atomicOr(a.branch, step.flags);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <int kPred, typename Lut, bool kCands>
cudaError_t launch_slot(const Args& a, int grid, size_t smem,
                        cudaStream_t stream) {
  // above 48 KB a block's dynamic shared memory needs an opt-in, once
  static const cudaError_t err = cudaFuncSetAttribute(
      slot_kernel<kPred, Lut, kCands>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kMaxSmem));
  if (err == cudaSuccess) {
    slot_kernel<kPred, Lut, kCands><<<grid, kSlotBlock, smem, stream>>>(a);
  }
  return err;
}

template <int kPred, bool kTables>
cudaError_t launch_warp(const Args& a, int grid, size_t smem,
                        cudaStream_t stream) {
  static const cudaError_t err = cudaFuncSetAttribute(
      warp_kernel<kPred, kTables>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kMaxSmem));
  if (err == cudaSuccess) {
    warp_kernel<kPred, kTables><<<grid, kWarpBlock, smem, stream>>>(a);
  }
  return err;
}

template <int kPred>
int launch_pred(const Args& a, bool slot_path, bool tables, int lut_bytes,
                size_t smem, cudaStream_t stream) {
  const int cells = a.n_chunks * a.lanes;
  cudaError_t err;
  if (slot_path) {
    const int grid = (cells + kSlotBlock - 1) / kSlotBlock;
    const bool c = a.topk > 0;
    err = lut_bytes == 1
              ? (c ? launch_slot<kPred, uint8_t, true>(a, grid, smem, stream)
                   : launch_slot<kPred, uint8_t, false>(a, grid, smem, stream))
              : (c ? launch_slot<kPred, uint16_t, true>(a, grid, smem, stream)
                   : launch_slot<kPred, uint16_t, false>(a, grid, smem,
                                                         stream));
  } else {
    const int grid = (cells + kWarps - 1) / kWarps;
    err = tables ? launch_warp<kPred, true>(a, grid, smem, stream)
                 : launch_warp<kPred, false>(a, grid, smem, stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* src, const void* start, const void* base,
           const void* wlen, int cap, const void* freq, const void* cdf,
           long long f_st, long long f_sl, long long c_st, long long c_sl,
           int k, const void* cands, int topk, int lanes, int t_len,
           int chunk, int n_chunks, int prob_bits, int n_iter, int pred,
           int window, int delta, void* sym, void* probes, void* under,
           void* branch, void* stream) {
  if (window < 0 || window > kMaxWindow || pred < kNone || pred > kZero) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // clip(mu -/+ delta) over mu in [0, K) is the same for any |delta| >= K + 1
  const long long dmax = static_cast<long long>(k) + 1;
  const int delta_c = static_cast<int>(
      delta > dmax ? dmax : (delta < -dmax ? -dmax : delta));
  const Args a{static_cast<const uint8_t*>(src),
               static_cast<const int32_t*>(start),
               static_cast<const int32_t*>(base),
               static_cast<const int32_t*>(wlen),
               cap,
               static_cast<const uint32_t*>(freq),
               static_cast<const uint32_t*>(cdf),
               f_st, f_sl, c_st, c_sl, k,
               static_cast<const int32_t*>(cands),
               topk, lanes, t_len, chunk, n_chunks, prob_bits, n_iter,
               window, delta_c,
               static_cast<int32_t*>(sym),
               static_cast<int32_t*>(probes),
               static_cast<int32_t*>(under),
               static_cast<int32_t*>(branch)};
  const bool is_static = f_st == 0 && f_sl == 0 && c_st == 0 && c_sl == 0;
  const int lut_bytes = k <= 256 ? 1 : 2;
  // Both paths replay window probes from a table of widths below kWinTab
  // when a window of 2 * delta + 1 symbols fits it or covers K, and K fits
  // the tables; the slot path needs them, the warp path falls back to the
  // loop.
  const long long widest = 2ll * delta + 1 < k - 1 ? 2ll * delta + 1 : k - 1;
  const bool tables = k <= kSlotTableMax && (pred == kNone || widest < kWinTab);
  bool slot_path = is_static && tables && prob_bits >= 1 &&
                   prob_bits <= kMaxSlotBits;
  size_t smem = 0;
  if (slot_path) {
    smem = slot_layout(k, prob_bits, lut_bytes).total;
    slot_path = smem <= kMaxSmem;
  }
  if (!slot_path) smem = warp_layout(k, tables).total;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pred) {
    case kNeighborAverage:
      return launch_pred<kNeighborAverage>(a, slot_path, tables, lut_bytes,
                                           smem, st);
    case kLastValue:
      return launch_pred<kLastValue>(a, slot_path, tables, lut_bytes, smem, st);
    case kZero:
      return launch_pred<kZero>(a, slot_path, tables, lut_bytes, smem, st);
    default:
      return launch_pred<kNone>(a, slot_path, tables, lut_bytes, smem, st);
  }
}

}  // namespace

// B3: dense right-aligned streams buf (n_chunks, lanes, cap), start
// (n_chunks, lanes).  `branch` (one int32, zeroed by the caller) receives
// the OR of the Branch bits that ran.
extern "C" int rans_decode_lanes_launch(
    const void* buf, const void* start, int cap, const void* freq,
    const void* cdf, long long f_st, long long f_sl, long long c_st,
    long long c_sl, int k, const void* cands, int topk, int lanes, int t_len,
    int chunk, int n_chunks, int prob_bits, int n_iter, int pred, int window,
    int delta, void* sym, void* probes, void* under, void* branch,
    void* stream) {
  return launch(buf, start, nullptr, nullptr, cap, freq, cdf, f_st, f_sl,
                c_st, c_sl, k, cands, topk, lanes, t_len, chunk, n_chunks,
                prob_bits, n_iter, pred, window, delta, sym, probes, under,
                branch, stream);
}

// B4: the packed (S,) payload slab read through per-cell windows of cap
// bytes at base (n_chunks, lanes), span [wstart, wstart + wlen).
extern "C" int rans_decode_slab_launch(
    const void* slab, const void* base, const void* wstart, const void* wlen,
    int cap, const void* freq, const void* cdf, long long f_st,
    long long f_sl, long long c_st, long long c_sl, int k, const void* cands,
    int topk, int lanes, int t_len, int chunk, int n_chunks, int prob_bits,
    int n_iter, int pred, int window, int delta, void* sym, void* probes,
    void* under, void* branch, void* stream) {
  return launch(slab, wstart, base, wlen, cap, freq, cdf, f_st, f_sl, c_st,
                c_sl, k, cands, topk, lanes, t_len, chunk, n_chunks,
                prob_bits, n_iter, pred, window, delta, sym, probes, under,
                branch, stream);
}

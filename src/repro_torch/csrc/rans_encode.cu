// Multi-lane chunked rANS encode for Hopper (sm_90a): kernels B1 and B5.
//
// B1 replaces the TPU kernel repro/kernels/rans_encode.py::rans_encode_lanes
// (body _encode_fused_kernel); B5 replaces ::rans_encode_records (body
// _encode_kernel), the records reference datapath.  Each (chunk, lane) cell
// is a standalone stream whose rows are pushed backward (rANS is LIFO),
// from the ragged-aware chunk end down to row 0, through one shared step
// (push): the fixed 2-step masked renorm, then the Barrett two-path update
// s + bias + q * cmpl with q = __umulhi(s, rcp) >> rshift, all mod 2**32.
// The five encoder planes are gathered at [t, lane, x]; a symbol outside
// [0, K) gathers zero from all five, as the reference's one-hot gather
// does.  The two kernels differ only in what they do with the renorm
// records (the Out type of run_cell):
//
// B1 (fused compaction): an emitted byte lands at --ptr in the cell's own
//   (cap,) row; a cursor past the head still decrements but its writes drop
//   (truncated-but-flagged, never wrapped).  The 4-byte state header is
//   flushed low byte first through the same cursor, then the cell zeroes
//   its row's head [0, max(ptr, 0)), so the caller allocates buf without
//   clearing it and every byte outside a cell's span is 0.
// B5 (records): every record is written, bytes[c, t, r, lane] = the state's
//   low byte whatever the mask, mask[c, t, r, lane] = emitted?; rows
//   [n, padded_chunk) of a chunk are written as zeros; the cell's final
//   state goes to states[c, lane].  The writing threads 0-3 hold
//   neighbouring lanes, so each record write is one run of 4 bytes.
//
// Table layouts via element strides (K contiguous): static (K,) has
// stride_t = stride_l = 0, per-position (T, K) stride_l = 0, per-lane
// (T, lanes, K) stride_t = lanes * K, stride_l = K.
//
// What bounds them on this card, and the design.  The state is a serial
// chain of chunk-length steps per cell and the container fixes the cells
// (n_chunks * lanes: 512 on the ras-pimc slice, 256 on the image path), so
// the time is the chain's latency, far above the byte bound (~24 B
// gathered per step; <= 2 B written by B1, 4 B of record planes by B5).
// The chain itself is about eight dependent integer operations a step
// (tools/b1_chain_floor.py: ~23 ns a step on an H100); the design keeps
// every load, and most other work, off it:
//  * One warp a block owns kCells = 4 consecutive lanes of one chunk, so
//    the slice's 512 cells span 128 SMs and the image's 256 span 64.  Every
//    thread of the warp runs the chain of lane t % 4 (the copies are free
//    and keep the warp converged).  Spreading the cells is what feeds the
//    per-lane tables' gathers: a warp of 32 cells on 16 SMs ran 0.54 us a
//    step, bound by the loads one SM keeps in flight.
//  * A batch is kBatch = 8 steps x 4 cells = 32 (step, cell) pairs, one a
//    thread.  kAhead batches ahead of the chain, each thread looks up its
//    pair's five plane entries into a per-warp ring in shared memory: from
//    device memory by cp.async (per-position and per-lane rows, and static
//    tables above kSmemTableMax), where a copy of size 0 zero-fills the
//    slot, which is how a symbol outside [0, K) and a step past the chunk
//    read zero; or from a static table that the block staged in shared
//    memory with a zero entry at index K.  The chain reads a batch's
//    entries from the ring into registers one batch before it uses them,
//    after a wait on a group issued (kAhead - 1) * kBatch = 40 steps
//    earlier.  So no step of the chain waits on a load.
//  * Symbols are staged in tiles of 32 steps x 4 lanes (cp.async, 4 bytes
//    a copy, so no alignment of T, the chunk or the rows is needed; each
//    copy instruction reads 32 consecutive words of one lane's row), three
//    tiles (96 steps) ahead of the lookups that read them.
//  * The step has no branch and no store: the renorm is two selects on
//    shifts computed in parallel, B1's cursor moves by arithmetic, and
//    thread t keeps (two or three selects) the state, x_max and cursor
//    before step t / 4 of the batch; after the batch it recomputes that
//    step's records and stores them, predicated in PTX (a store under an
//    `if` compiled to a divergent branch per step).
//  * The main loop runs four full batches an iteration with no test of the
//    chunk's end, so the compiler sees one basic block and interleaves the
//    next batch's shared-memory reads and lookups with the chain (with a
//    branch per batch, B1 took 0.096 ms instead of 0.081 at Fig. 4(a)).
//  * B1's planes of start, length and overflow (a bool tensor written as
//    0/1 bytes) come out of the same launch, and its row heads are zeroed
//    by the warp 16 bytes a thread, so a call is one launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kRansL = 1u << 23;
constexpr int kPlanes = 5;            // rcp, rshift, bias, cmpl, x_max
constexpr int kSmemTableMax = 2048;   // 5 planes x 2049 x 4 B = 40 KB
constexpr int kCells = 4;             // lanes a warp owns
constexpr int kBatch = 8;             // steps a batch: kBatch * kCells = 32
constexpr int kAhead = 6;             // batches the lookups run ahead
constexpr int kTile = 32;             // steps of a symbol tile
constexpr int kTiles = 4;             // tile buffers: 3 ahead + 1 in use
constexpr int kTileWords = kTile * kCells;             // [step][cell]
constexpr int kCellWords = kBatch * kPlanes;           // [step][plane]
constexpr int kSlotWords = kCells * kCellWords;        // [cell][step][plane]
constexpr int kRingWords = kAhead * kSlotWords;
constexpr unsigned kFullMask = 0xffffffffu;
static_assert(kBatch * kCells == 32, "a batch is one (step, cell) a thread");
static_assert(kTile == 4 * kBatch, "a tile is four batches");
static_assert(kAhead < 4 * (kTiles - 1) - 1,
              "a tile lands before the lookups read it");

struct Args {
  const int32_t* __restrict__ sym;                // (lanes, T)
  const uint32_t* __restrict__ planes[kPlanes];   // rcp .. x_max
  long long stride_t, stride_l;
  int k, lanes, t_len, chunk;
};

struct Entry {
  uint32_t rcp, rshift, bias, cmpl, xmax;
};

// A byte store predicated in PTX, so that the compiler cannot make a
// divergent branch of it.
__device__ __forceinline__ void store_byte_if(uint8_t* p, uint32_t v,
                                              bool pred) {
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\t"
      "@q st.global.u8 [%0], %1;\n\t}\n" ::"l"(p),
      "r"(v), "r"(static_cast<uint32_t>(pred)));
}

// A 4-byte cp.async; `ok` false copies nothing and zero-fills the word.
__device__ __forceinline__ void cp_async4(uint32_t* dst, const void* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The warp's cells: kCells consecutive lanes of chunk c.  A thread's lane
// is lane0 + t % kCells; lanes past the stream's are idle (their threads
// copy and wait with the warp and write nothing).
struct Cell {
  int c, n, lane0, lane, t_last;
  bool active;   // the lane exists
  bool writer;   // the lane exists and this thread stores its outputs
};

__device__ __forceinline__ Cell cell_of(const Args& a) {
  Cell cl;
  const int warps_per_chunk = (a.lanes + kCells - 1) / kCells;
  cl.c = static_cast<int>(blockIdx.x) / warps_per_chunk;
  cl.lane0 = (static_cast<int>(blockIdx.x) - cl.c * warps_per_chunk) * kCells;
  cl.lane = cl.lane0 + static_cast<int>(threadIdx.x) % kCells;
  cl.active = cl.lane < a.lanes;
  cl.writer = cl.active && threadIdx.x < kCells;
  const int t0 = cl.c * a.chunk;
  cl.n = min(a.chunk, a.t_len - t0);
  cl.t_last = t0 + cl.n - 1;            // t of backward step 0
  return cl;
}

// Symbol tile j: backward steps [32 j, 32 j + 32) of the warp's lanes,
// tile[i * kCells + m] = sym[lane0 + m, t_last - 32 j - i].  Thread i
// copies step i of every lane, so each copy instruction reads 32
// consecutive words of one lane's row.
__device__ __forceinline__ void copy_tile(uint32_t* tiles, const Args& a,
                                          const Cell& cl, int j) {
  uint32_t* tile = tiles + (j % kTiles) * kTileWords;
  const int i = static_cast<int>(threadIdx.x);
  const int r = kTile * j + i;
  const bool step_ok = r < cl.n;
  const int32_t* src = a.sym + static_cast<long long>(cl.lane0) * a.t_len +
                       (step_ok ? cl.t_last - r : 0);
#pragma unroll
  for (int m = 0; m < kCells; ++m) {
    const bool ok = step_ok && cl.lane0 + m < a.lanes;
    cp_async4(tile + i * kCells + m, ok ? src : a.sym, ok);
    src += a.t_len;
  }
}

// The renorm records of a push from state s against x_max: (byte,
// emitted?) of both steps in emission order, and the state they leave.
__device__ __forceinline__ uint32_t renorm(uint32_t s, uint32_t xmax,
                                           uint32_t& b0, uint32_t& b1,
                                           bool& c1, bool& c2) {
  const uint32_t s8 = s >> 8;
  c1 = s >= xmax;
  c2 = c1 && s8 >= xmax;
  b0 = s & 0xFFu;
  const uint32_t s1 = c1 ? s8 : s;
  b1 = s1 & 0xFFu;
  return c2 ? s >> 16 : s1;
}

// One symbol push: the renorm, then the Barrett update.
__device__ __forceinline__ uint32_t push(uint32_t s, const Entry& e,
                                         bool& c1, bool& c2) {
  uint32_t b0, b1;
  const uint32_t sr = renorm(s, e.xmax, b0, b1, c1, c2);
  const uint32_t q = __umulhi(sr, e.rcp) >> e.rshift;
  return sr + e.bias + q * e.cmpl;
}

// The symbol of thread t's lookup in batch bb: step t / 4 of the batch,
// lane lane0 + t % 4.
__device__ __forceinline__ int tile_symbol(const uint32_t* tiles, int bb) {
  return static_cast<int>(
      tiles[((bb / 4) % kTiles) * kTileWords + (bb % 4) * 32 + threadIdx.x]);
}

// The lookups of batch bb: thread t looks up step j = t / 4 of batch bb
// for lane lane0 + g, g = t % 4, whose symbol is x, into the ring slot of
// bb at words g * 40 + j * 5 + p (plane p; conflict-free across the warp,
// and a cell's 40 words are contiguous for 16-byte reads): from the static
// table staged in shared memory (kStatic: kPlanes rows of K + 1 words,
// entry K zero), or from device memory by cp.async.  A step past the chunk
// looks up zeros.  At every fourth batch (bb % 4 == 0, which the caller
// passes as `copy`) the thread also starts the copy of the symbol tile
// three tiles ahead.
template <bool kStatic>
__device__ __forceinline__ void lookup(const Args& a, const Cell& cl,
                                       uint32_t* tiles, uint32_t* ring,
                                       const uint32_t* table, long long row0,
                                       int bb, int x, bool copy) {
  if (copy) {
    __syncwarp();                       // tile bb / 4 - 1's last readers
    copy_tile(tiles, a, cl, bb / 4 + kTiles - 1);
  }
  const int t = static_cast<int>(threadIdx.x);
  const int g = bb * kBatch + t / kCells;
  const bool ok = cl.active && g < cl.n &&
                  static_cast<unsigned>(x) < static_cast<unsigned>(a.k);
  uint32_t* slot = ring + (bb % kAhead) * kSlotWords +
                   (t % kCells) * kCellWords + (t / kCells) * kPlanes;
  if (kStatic) {
    const int w = a.k + 1;
    const int i = ok ? x : a.k;
    uint32_t v[kPlanes];                // all five loads before any store
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) v[p] = table[p * w + i];
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) slot[p] = v[p];
  } else {
    const long long off = ok ? row0 - g * a.stride_t + x : 0;
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      cp_async4(slot + p, a.planes[p] + off, ok);
    }
  }
}

// The entries of batch b for this thread's lane, from the ring: the
// cell's 40 contiguous words, 16 bytes a read.
__device__ __forceinline__ void load(const uint32_t* ring, int b,
                                     Entry (&e)[kBatch]) {
  const uint4* v = reinterpret_cast<const uint4*>(
      ring + (b % kAhead) * kSlotWords + (threadIdx.x % kCells) * kCellWords);
  uint32_t w[kCellWords];
#pragma unroll
  for (int q = 0; q < kCellWords / 4; ++q) {
    const uint4 u = v[q];
    w[4 * q] = u.x;
    w[4 * q + 1] = u.y;
    w[4 * q + 2] = u.z;
    w[4 * q + 3] = u.w;
  }
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    e[j] = Entry{w[5 * j], w[5 * j + 1], w[5 * j + 2], w[5 * j + 3],
                 w[5 * j + 4]};
  }
}

// The chain over batch b's entries; kFull: every step lies in the chunk.
// Thread t keeps the state and x_max before its own step t / 4 of the
// batch (two selects a step); after the batch it recomputes that step's
// records and stores them, so the 32 threads store the batch's 8 x 4
// records once, with no store inside the chain.
template <bool kFull, class Out>
__device__ __forceinline__ uint32_t chain(uint32_t s, const Entry (&e)[kBatch],
                                          const Cell& cl, int b, Out& out) {
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    if (kFull || b * kBatch + j < cl.n) {
      out.keep(j, s, e[j].xmax);
      bool c1, c2;
      s = push(s, e[j], c1, c2);
      out.step(c1, c2);
    }
  }
  out.flush(cl, b);
  return s;
}

// Batch b: wait until batch b + 1's group (committed kAhead - 1 batches
// earlier) has landed in every thread, read this thread's symbol for the
// lookups of batch b + kAhead and batch b + 1's entries into `nxt`; run
// the chain over `cur`, batch b's entries loaded one batch earlier; then
// look up batch b + kAhead and commit (one group per batch).  The shared
// memory reads are issued before the chain and used after it.  kMain:
// batch b and the three after it are full batches of the main loop, so
// the batch is one basic block (no test of the chunk's end) that the
// compiler interleaves with its neighbours; `copy` is bb % 4 == 0.
template <bool kStatic, bool kMain, class Out>
__device__ __forceinline__ uint32_t batch(uint32_t s, const Args& a,
                                          const Cell& cl, uint32_t* tiles,
                                          uint32_t* ring,
                                          const uint32_t* table,
                                          long long row0, int b,
                                          int n_batches, bool copy,
                                          const Entry (&cur)[kBatch],
                                          Entry (&nxt)[kBatch], Out& out) {
  wait_groups<kAhead - 2>();
  __syncwarp();       // lookups landed; batch b's slots and old tiles read
  const int x = tile_symbol(tiles, b + kAhead);
  if (kMain || b + 1 < n_batches) load(ring, b + 1, nxt);
  s = kMain || (b + 1) * kBatch <= cl.n ? chain<true>(s, cur, cl, b, out)
                                        : chain<false>(s, cur, cl, b, out);
  if (kMain || (b + kAhead) * kBatch < cl.n) {
    lookup<kStatic>(a, cl, tiles, ring, table, row0, b + kAhead, x, copy);
  }
  commit_group();
  return s;
}

// Push the cell's rows backward; returns the final state.  The prologue
// stages tiles 0 .. kTiles - 2 (and a static table with its zero entry),
// then looks up batches 0 .. kAhead - 1 (one group each) and loads batch
// 0's entries.  The main loop runs four full batches an iteration, which
// alternate two entry arrays (so none is copied) and know at compile time
// which of them starts a tile copy; the last batches (at most four, the
// last one maybe partial) run the same steps with their tests.
template <bool kStatic, class Out>
__device__ __forceinline__ uint32_t run_cell(const Args& a, const Cell& cl,
                                             uint32_t* tiles, uint32_t* ring,
                                             uint32_t* table, Out& out) {
  for (int j = 0; j < kTiles - 1; ++j) copy_tile(tiles, a, cl, j);
  if (kStatic) {
    const int w = a.k + 1;
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      for (int i = threadIdx.x; i < a.k; i += 32) {
        cp_async4(table + p * w + i, a.planes[p] + i, true);
      }
    }
    if (threadIdx.x < kPlanes) table[threadIdx.x * w + a.k] = 0u;
  }
  commit_group();
  wait_groups<0>();
  __syncwarp();
  const long long row0 =
      cl.t_last * a.stride_t + static_cast<long long>(cl.lane) * a.stride_l;
  const int n_batches = (cl.n + kBatch - 1) / kBatch;
  for (int bb = 0; bb < kAhead; ++bb) {
    if (bb * kBatch < cl.n) {
      lookup<kStatic>(a, cl, tiles, ring, table, row0, bb,
                      tile_symbol(tiles, bb), bb % 4 == 0);
    }
    commit_group();
  }
  wait_groups<kAhead - 1>();
  __syncwarp();
  Entry e0[kBatch], e1[kBatch];
  load(ring, 0, e0);
  uint32_t s = kRansL;
  constexpr int kCopy = (4 - kAhead % 4) % 4;   // phase whose bb % 4 == 0
  int b = 0;
  for (; (b + 4) * kBatch <= cl.n; b += 4) {
    s = batch<kStatic, true>(s, a, cl, tiles, ring, table, row0, b,
                             n_batches, kCopy == 0, e0, e1, out);
    s = batch<kStatic, true>(s, a, cl, tiles, ring, table, row0, b + 1,
                             n_batches, kCopy == 1, e1, e0, out);
    s = batch<kStatic, true>(s, a, cl, tiles, ring, table, row0, b + 2,
                             n_batches, kCopy == 2, e0, e1, out);
    s = batch<kStatic, true>(s, a, cl, tiles, ring, table, row0, b + 3,
                             n_batches, kCopy == 3, e1, e0, out);
  }
  for (; b < n_batches; b += 2) {
    s = batch<kStatic, false>(s, a, cl, tiles, ring, table, row0, b,
                              n_batches, (b + kAhead) % 4 == 0, e0, e1, out);
    if (b + 1 < n_batches) {
      s = batch<kStatic, false>(s, a, cl, tiles, ring, table, row0, b + 1,
                                n_batches, (b + 1 + kAhead) % 4 == 0, e1, e0,
                                out);
    }
  }
  return s;
}

// Shared memory of a block: the symbol tiles, the ring, then a static
// table when the launch stages one.
struct Smem {
  uint32_t* tiles;
  uint32_t* ring;
  uint32_t* table;
};

template <bool kStatic>
__device__ __forceinline__ Smem smem_of(uint32_t* smem) {
  static_assert(kTiles * kTileWords % 4 == 0 && kSlotWords % 4 == 0 &&
                    kCellWords % 4 == 0,
                "ring cells are 16-byte aligned");
  return Smem{smem, smem + kTiles * kTileWords,
              kStatic ? smem + kTiles * kTileWords + kRingWords : nullptr};
}

// B1's records: the emitted bytes through the cell's cursor.  Every
// thread moves its cell's cursor; thread t keeps the state, x_max and
// cursor before its own step t / 4 and, after the batch, stores that
// step's (at most two) bytes.
struct ByteRow {
  uint8_t* row;
  int ptr;
  int my_j;
  bool active;
  uint32_t ks, kx;
  int kp;
  __device__ __forceinline__ void keep(int j, uint32_t s, uint32_t xmax) {
    const bool mine = j == my_j;
    ks = mine ? s : ks;
    kx = mine ? xmax : kx;
    kp = mine ? ptr : kp;
  }
  __device__ __forceinline__ void step(bool c1, bool c2) {
    ptr -= (c1 ? 1 : 0) + (c2 ? 1 : 0);
  }
  __device__ __forceinline__ void flush(const Cell& cl, int b) const {
    const bool ok = active && b * kBatch + my_j < cl.n;
    uint32_t b0, b1;
    bool c1, c2;
    renorm(ks, kx, b0, b1, c1, c2);
    const int p1 = kp - (c1 ? 1 : 0);
    const int p2 = p1 - (c2 ? 1 : 0);
    store_byte_if(row + p1, b0, ok && c1 && p1 >= 0);
    store_byte_if(row + p2, b1, ok && c2 && p2 >= 0);
  }
};

// Zero bytes [0, head) of the warp's rows, one row at a time: the aligned
// 16-byte blocks a thread each, the ragged edges a byte a thread.  `head`
// is read from thread m for row m (0 for an idle lane).
__device__ __forceinline__ void zero_heads(uint8_t* row, int head) {
  const unsigned l = threadIdx.x;
  for (int m = 0; m < kCells; ++m) {
    const unsigned long long b = __shfl_sync(
        kFullMask, static_cast<unsigned long long>(
                       reinterpret_cast<uintptr_t>(row)), m);
    const int h = __shfl_sync(kFullMask, head, m);
    if (h <= 0) continue;                              // warp-uniform
    const unsigned long long e = b + static_cast<unsigned long long>(h);
    const unsigned long long a0 = (b + 15) & ~15ull;
    const unsigned long long a1 = e & ~15ull;
    if (b + l < min(a0, e)) reinterpret_cast<uint8_t*>(b)[l] = 0;
    const unsigned long long post = max(a0, a1);
    if (post + l < e) reinterpret_cast<uint8_t*>(post)[l] = 0;
    for (unsigned long long q = a0 + 16ull * l; q + 16 <= a1; q += 512) {
      *reinterpret_cast<uint4*>(q) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

template <bool kStatic>
__global__ void __launch_bounds__(32) rans_encode_kernel(
    Args a, int cap,
    uint8_t* __restrict__ buf,          // (n_chunks, lanes, cap)
    int32_t* __restrict__ start, int32_t* __restrict__ length,
    uint8_t* __restrict__ overflow) {   // (n_chunks, lanes) bool
  extern __shared__ __align__(16) uint32_t smem[];
  const Smem sm = smem_of<kStatic>(smem);
  const Cell cl = cell_of(a);
  const long long cell = static_cast<long long>(cl.c) * a.lanes + cl.lane;
  ByteRow out{buf + cell * cap, cap,
              static_cast<int>(threadIdx.x) / kCells, cl.active};
  const uint32_t s =
      run_cell<kStatic>(a, cl, sm.tiles, sm.ring, sm.table, out);
  int ptr = out.ptr;
#pragma unroll
  for (int shift = 0; shift < 32; shift += 8) {
    --ptr;
    if (cl.writer && ptr >= 0) out.row[ptr] = static_cast<uint8_t>(s >> shift);
  }
  zero_heads(out.row, cl.writer ? max(ptr, 0) : 0);
  if (cl.writer) {
    start[cell] = max(ptr, 0);
    length[cell] = cap - ptr;
    overflow[cell] = ptr < 0 ? 1 : 0;
  }
}

// B5's records: both renorm records of a step.  Thread t keeps the state
// and x_max before its own step t / 4 and, after the batch, stores that
// step's records at row n - 1 - (8 b + t / 4) of the chunk.
struct RecordRows {
  uint8_t* bytes;
  uint8_t* mask;
  long long base;        // offset of (chunk row 0, record 0, lane)
  long long row_elems;   // one (i, :, :) row: 2 * lanes
  int lanes;
  int my_j;
  bool active;
  uint32_t ks, kx;
  __device__ __forceinline__ void keep(int j, uint32_t s, uint32_t xmax) {
    const bool mine = j == my_j;
    ks = mine ? s : ks;
    kx = mine ? xmax : kx;
  }
  __device__ __forceinline__ void step(bool, bool) {}
  __device__ __forceinline__ void flush(const Cell& cl, int b) const {
    const int r = b * kBatch + my_j;
    const bool ok = active && r < cl.n;
    uint32_t b0, b1;
    bool c1, c2;
    renorm(ks, kx, b0, b1, c1, c2);
    uint8_t* at = bytes + (ok ? base + (cl.n - 1 - r) * row_elems : 0);
    uint8_t* am = mask + (at - bytes);
    store_byte_if(at, b0, ok);
    store_byte_if(at + lanes, b1, ok);
    store_byte_if(am, c1 ? 1u : 0u, ok);
    store_byte_if(am + lanes, c2 ? 1u : 0u, ok);
  }
};

template <bool kStatic>
__global__ void __launch_bounds__(32) rans_encode_records_kernel(
    Args a, int padded,
    uint8_t* __restrict__ bytes,        // (n_chunks, padded, 2, lanes)
    uint8_t* __restrict__ mask,         // (n_chunks, padded, 2, lanes)
    int32_t* __restrict__ states) {     // (n_chunks, lanes)
  extern __shared__ __align__(16) uint32_t smem[];
  const Smem sm = smem_of<kStatic>(smem);
  const Cell cl = cell_of(a);
  const long long row_elems = 2LL * a.lanes;
  const long long base =
      static_cast<long long>(cl.c) * padded * row_elems + cl.lane;
  RecordRows out{bytes, mask, base, row_elems, a.lanes,
                 static_cast<int>(threadIdx.x) / kCells, cl.active};
  const uint32_t s =
      run_cell<kStatic>(a, cl, sm.tiles, sm.ring, sm.table, out);
  if (cl.writer) {
    for (int i = cl.n; i < padded; ++i) {
      const long long at = base + i * row_elems;
      bytes[at] = 0;
      bytes[at + a.lanes] = 0;
      mask[at] = 0;
      mask[at + a.lanes] = 0;
    }
    states[static_cast<long long>(cl.c) * a.lanes + cl.lane] =
        static_cast<int32_t>(s);
  }
}

Args args_of(const void* sym, const void* rcp, const void* rshift,
             const void* bias, const void* cmpl, const void* xmax,
             long long stride_t, long long stride_l, int k, int lanes,
             int t_len, int chunk) {
  Args a;
  a.sym = static_cast<const int32_t*>(sym);
  const void* p[kPlanes] = {rcp, rshift, bias, cmpl, xmax};
  for (int i = 0; i < kPlanes; ++i) {
    a.planes[i] = static_cast<const uint32_t*>(p[i]);
  }
  a.stride_t = stride_t;
  a.stride_l = stride_l;
  a.k = k;
  a.lanes = lanes;
  a.t_len = t_len;
  a.chunk = chunk;
  return a;
}

// One warp a block, one block per kCells lanes of a chunk.
struct Launch {
  int grid;
  size_t smem;
  bool is_static;
};

// The largest block (a static table of kSmemTableMax entries) stays under
// the 48 KB a launch may take without the dynamic shared memory opt-in.
static_assert((kTiles * kTileWords + kRingWords +
               kPlanes * (kSmemTableMax + 1)) * sizeof(uint32_t) <= 48 * 1024,
              "shared memory above 48 KB needs cudaFuncSetAttribute");

Launch geometry(const Args& a, int n_chunks) {
  const bool is_static =
      a.stride_t == 0 && a.stride_l == 0 && a.k <= kSmemTableMax;
  const size_t table = is_static ? kPlanes * static_cast<size_t>(a.k + 1)
                                 : 0;
  return Launch{n_chunks * ((a.lanes + kCells - 1) / kCells),
                (kTiles * kTileWords + kRingWords + table) * sizeof(uint32_t),
                is_static};
}

}  // namespace

// B1: fused encode into (n_chunks, lanes, cap) streams; buf need not be
// cleared, overflow is a (n_chunks, lanes) bool tensor.
extern "C" int rans_encode_launch(
    const void* sym, const void* rcp, const void* rshift, const void* bias,
    const void* cmpl, const void* xmax, long long stride_t,
    long long stride_l, int k, int lanes, int t_len, int chunk, int n_chunks,
    int cap, void* buf, void* start, void* length, void* overflow,
    void* stream) {
  const Args a = args_of(sym, rcp, rshift, bias, cmpl, xmax, stride_t,
                         stride_l, k, lanes, t_len, chunk);
  const Launch g = geometry(a, n_chunks);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* b = static_cast<uint8_t*>(buf);
  auto* st = static_cast<int32_t*>(start);
  auto* ln = static_cast<int32_t*>(length);
  auto* ov = static_cast<uint8_t*>(overflow);
  if (g.is_static) {
    rans_encode_kernel<true><<<g.grid, 32, g.smem, s>>>(a, cap, b, st, ln, ov);
  } else {
    rans_encode_kernel<false><<<g.grid, 32, g.smem, s>>>(a, cap, b, st, ln,
                                                         ov);
  }
  return static_cast<int>(cudaGetLastError());
}

// B5: records encode into (n_chunks, padded, 2, lanes) planes + states.
extern "C" int rans_encode_records_launch(
    const void* sym, const void* rcp, const void* rshift, const void* bias,
    const void* cmpl, const void* xmax, long long stride_t,
    long long stride_l, int k, int lanes, int t_len, int chunk, int n_chunks,
    int padded, void* bytes, void* mask, void* states, void* stream) {
  const Args a = args_of(sym, rcp, rshift, bias, cmpl, xmax, stride_t,
                         stride_l, k, lanes, t_len, chunk);
  const Launch g = geometry(a, n_chunks);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* by = static_cast<uint8_t*>(bytes);
  auto* ma = static_cast<uint8_t*>(mask);
  auto* st = static_cast<int32_t*>(states);
  if (g.is_static) {
    rans_encode_records_kernel<true><<<g.grid, 32, g.smem, s>>>(a, padded, by,
                                                                ma, st);
  } else {
    rans_encode_records_kernel<false><<<g.grid, 32, g.smem, s>>>(a, padded,
                                                                 by, ma, st);
  }
  return static_cast<int>(cudaGetLastError());
}

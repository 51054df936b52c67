// Multi-lane chunked rANS encode for Hopper (sm_90a): kernels B1 and B5.
//
// B1 replaces the TPU kernel repro/kernels/rans_encode.py::rans_encode_lanes
// (body _encode_fused_kernel); B5 replaces ::rans_encode_records (body
// _encode_kernel), the records reference datapath.  Both run one thread per
// (chunk, lane) cell that walks that chunk's rows backward (rANS is LIFO),
// from the ragged-aware chunk end down to row 0, through one shared step
// (encode_step): gather the five encoder planes at [t, lane, x], run the
// fixed 2-step masked renorm, then the Barrett two-path update
// s + bias + q * cmpl with q = __umulhi(s, rcp) >> rshift, all mod 2**32.
// The two kernels differ only in what they do with the renorm records:
//
// B1 (fused compaction): an emitted byte lands at --ptr in the cell's own
//   (cap,) row; a cursor past the head still decrements but its writes drop
//   (truncated-but-flagged, never wrapped).  The 4-byte state header is
//   flushed low byte first through the same cursor.  The caller zeroes buf:
//   bytes outside a cell's span stay 0.
// B5 (records): every record is written, bytes[c, t, r, lane] = the state's
//   low byte whatever the mask, mask[c, t, r, lane] = emitted?; rows
//   [n, padded_chunk) of a chunk are written as zeros; the cell's final
//   state goes to states[c, lane].  Neighbouring threads are neighbouring
//   lanes, so each record write is coalesced across the warp.
//
// Table layouts via element strides (K contiguous): static (K,) has
// stride_t = stride_l = 0, per-position (T, K) stride_l = 0, per-lane
// (T, lanes, K) stride_t = lanes * K, stride_l = K.  A static table of at
// most kSmemTableMax symbols is staged in shared memory once per block;
// per-position and per-lane rows are read from device memory.  Symbols
// outside [0, K) are clipped into it.
//
// What bounds them on this card: a serial chain of chunk-length dependent
// steps per thread, with only n_chunks * lanes threads live (512 on the
// ras-pimc main path), so both are latency-bound, far above their byte
// bound (~24 B gathered per (t, lane); <= 2 B written by B1, 4 B of record
// planes by B5).  The design keeps the TPU's one-hot byte ring and VMEM bank
// out: Hopper scatters bytes to global memory directly.  Splitting each
// chunk's chain is impossible (the state is sequential), so more
// parallelism means more chunks: later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kRansL = 1u << 23;
constexpr int kSmemTableMax = 2048;   // 5 planes x 2048 x 4 B = 40 KB
constexpr int kBlock = 128;

struct Planes {
  const uint32_t* rcp;
  const uint32_t* rshift;
  const uint32_t* bias;
  const uint32_t* cmpl;
  const uint32_t* xmax;
};

// Stage a static table in shared memory (all threads of the block call
// this before any returns); other layouts keep their device pointers.
__device__ __forceinline__ Planes stage(const Planes& g, int k,
                                        int static_smem, uint32_t* smem) {
  if (!static_smem) return g;
  const uint32_t* src[5] = {g.rcp, g.rshift, g.bias, g.cmpl, g.xmax};
#pragma unroll
  for (int p = 0; p < 5; ++p)
    for (int i = threadIdx.x; i < k; i += blockDim.x) smem[p * k + i] = src[p][i];
  __syncthreads();
  return Planes{smem, smem + k, smem + 2 * k, smem + 3 * k, smem + 4 * k};
}

// One symbol push at table element `off`.  record(r, byte, emitted) sees
// both renorm records in emission order; returns the updated state.
template <class Record>
__device__ __forceinline__ uint32_t encode_step(uint32_t s, const Planes& p,
                                                long long off,
                                                Record&& record) {
  const uint32_t xm = p.xmax[off];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool cond = s >= xm;
    record(r, s & 0xFFu, cond);
    if (cond) s >>= 8;
  }
  const uint32_t q = __umulhi(s, p.rcp[off]) >> p.rshift[off];
  return s + p.bias[off] + q * p.cmpl[off];
}

// The table element of (row t, lane, symbol) and the clipped symbol read.
__device__ __forceinline__ long long element(const int32_t* srow, int t,
                                             int lane, int k,
                                             long long stride_t,
                                             long long stride_l) {
  const int x = min(max(srow[t], 0), k - 1);
  return t * stride_t + lane * stride_l + x;
}

__device__ __forceinline__ void emit(uint8_t* row, int& ptr, uint32_t byte) {
  --ptr;
  if (ptr >= 0) row[ptr] = static_cast<uint8_t>(byte);
}

__global__ void __launch_bounds__(kBlock) rans_encode_kernel(
    const int32_t* __restrict__ sym,  // (lanes, T)
    Planes planes, long long stride_t, long long stride_l, int k,
    int static_smem, int lanes, int t_len, int chunk, int n_chunks, int cap,
    uint8_t* __restrict__ buf,         // (n_chunks, lanes, cap), zeroed
    int32_t* __restrict__ start, int32_t* __restrict__ length,
    uint8_t* __restrict__ overflow) {  // (n_chunks, lanes)
  extern __shared__ uint32_t smem[];
  const Planes p = stage(planes, k, static_smem, smem);
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= n_chunks * lanes) return;
  const int c = cell / lanes;
  const int lane = cell - c * lanes;
  const int t0 = c * chunk;
  const int n = min(chunk, t_len - t0);
  uint8_t* row = buf + static_cast<long long>(cell) * cap;
  const int32_t* srow = sym + static_cast<long long>(lane) * t_len;
  uint32_t s = kRansL;
  int ptr = cap;
  for (int i = n - 1; i >= 0; --i) {
    const long long off = element(srow, t0 + i, lane, k, stride_t, stride_l);
    s = encode_step(s, p, off, [&](int, uint32_t byte, bool cond) {
      if (cond) emit(row, ptr, byte);
    });
  }
#pragma unroll
  for (int shift = 0; shift < 32; shift += 8) emit(row, ptr, (s >> shift) & 0xFFu);
  start[cell] = max(ptr, 0);
  length[cell] = cap - ptr;
  overflow[cell] = ptr < 0 ? 1 : 0;
}

__global__ void __launch_bounds__(kBlock) rans_encode_records_kernel(
    const int32_t* __restrict__ sym,  // (lanes, T)
    Planes planes, long long stride_t, long long stride_l, int k,
    int static_smem, int lanes, int t_len, int chunk, int n_chunks,
    int padded,
    uint8_t* __restrict__ bytes,       // (n_chunks, padded, 2, lanes)
    uint8_t* __restrict__ mask,        // (n_chunks, padded, 2, lanes)
    int32_t* __restrict__ states) {    // (n_chunks, lanes)
  extern __shared__ uint32_t smem[];
  const Planes p = stage(planes, k, static_smem, smem);
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= n_chunks * lanes) return;
  const int c = cell / lanes;
  const int lane = cell - c * lanes;
  const int t0 = c * chunk;
  const int n = min(chunk, t_len - t0);
  const long long row_elems = 2LL * lanes;          // one (t, :, :) row
  const long long base = static_cast<long long>(c) * padded * row_elems + lane;
  uint8_t* brow = bytes + base;
  uint8_t* mrow = mask + base;
  for (int t = n; t < padded; ++t) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      brow[t * row_elems + r * lanes] = 0;
      mrow[t * row_elems + r * lanes] = 0;
    }
  }
  const int32_t* srow = sym + static_cast<long long>(lane) * t_len;
  uint32_t s = kRansL;
  for (int i = n - 1; i >= 0; --i) {
    const long long off = element(srow, t0 + i, lane, k, stride_t, stride_l);
    const long long at = i * row_elems;
    s = encode_step(s, p, off, [&](int r, uint32_t byte, bool cond) {
      brow[at + r * lanes] = static_cast<uint8_t>(byte);
      mrow[at + r * lanes] = cond ? 1 : 0;
    });
  }
  states[cell] = static_cast<int32_t>(s);
}

struct Launch {
  int grid;
  size_t smem;
  int static_smem;
};

Launch geometry(long long stride_t, long long stride_l, int k, int cells) {
  const int static_smem = stride_t == 0 && stride_l == 0 && k <= kSmemTableMax;
  return Launch{(cells + kBlock - 1) / kBlock,
                static_smem ? 5 * static_cast<size_t>(k) * sizeof(uint32_t) : 0,
                static_smem};
}

Planes planes_of(const void* rcp, const void* rshift, const void* bias,
                 const void* cmpl, const void* xmax) {
  return Planes{static_cast<const uint32_t*>(rcp),
                static_cast<const uint32_t*>(rshift),
                static_cast<const uint32_t*>(bias),
                static_cast<const uint32_t*>(cmpl),
                static_cast<const uint32_t*>(xmax)};
}

}  // namespace

// B1: fused encode into (n_chunks, lanes, cap) streams.
extern "C" int rans_encode_launch(
    const void* sym, const void* rcp, const void* rshift, const void* bias,
    const void* cmpl, const void* xmax, long long stride_t,
    long long stride_l, int k, int lanes, int t_len, int chunk, int n_chunks,
    int cap, void* buf, void* start, void* length, void* overflow,
    void* stream) {
  const Launch g = geometry(stride_t, stride_l, k, n_chunks * lanes);
  rans_encode_kernel<<<g.grid, kBlock, g.smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sym),
      planes_of(rcp, rshift, bias, cmpl, xmax), stride_t, stride_l, k,
      g.static_smem, lanes, t_len, chunk, n_chunks, cap,
      static_cast<uint8_t*>(buf), static_cast<int32_t*>(start),
      static_cast<int32_t*>(length), static_cast<uint8_t*>(overflow));
  return static_cast<int>(cudaGetLastError());
}

// B5: records encode into (n_chunks, padded, 2, lanes) planes + states.
extern "C" int rans_encode_records_launch(
    const void* sym, const void* rcp, const void* rshift, const void* bias,
    const void* cmpl, const void* xmax, long long stride_t,
    long long stride_l, int k, int lanes, int t_len, int chunk, int n_chunks,
    int padded, void* bytes, void* mask, void* states, void* stream) {
  const Launch g = geometry(stride_t, stride_l, k, n_chunks * lanes);
  rans_encode_records_kernel<<<g.grid, kBlock, g.smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sym),
      planes_of(rcp, rshift, bias, cmpl, xmax), stride_t, stride_l, k,
      g.static_smem, lanes, t_len, chunk, n_chunks, padded,
      static_cast<uint8_t*>(bytes), static_cast<uint8_t*>(mask),
      static_cast<int32_t*>(states));
  return static_cast<int>(cudaGetLastError());
}

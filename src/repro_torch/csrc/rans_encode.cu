// Multi-lane chunked rANS encode for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rans_encode.py::rans_encode_lanes
// (body _encode_fused_kernel).  One thread owns one (chunk, lane) cell and
// walks that chunk's rows backward (rANS is LIFO), from the ragged-aware
// chunk end down to row 0.  Per row it gathers the five encoder planes at
// [t, lane, x] straight from global memory, runs the staged renorm (at most
// two bytes) and the Barrett two-path update s + bias + q * cmpl with
// q = __umulhi(s, rcp) >> rshift, all mod 2**32.  Bytes land at --ptr in the
// cell's own (cap,) row; a cursor past the head still decrements but its
// writes drop (truncated-but-flagged, never wrapped).  The 4-byte state
// header is flushed low byte first through the same cursor.  The caller
// zeroes buf: bytes outside a cell's span stay 0.
//
// Table layouts via element strides (K contiguous): static (K,) has
// stride_t = stride_l = 0, per-position (T, K) stride_l = 0, per-lane
// (T, lanes, K) stride_t = lanes * K, stride_l = K.
//
// What bounds it on this card: a serial chain of chunk-length dependent
// steps per thread, with only n_chunks * lanes threads live (512 on the
// ras-pimc main path), so it is latency-bound, far above its byte bound
// (~24 B gathered and <= 2 B written per (t, lane)).  The design keeps the
// TPU's one-hot byte ring and VMEM bank out: Hopper scatters bytes to global
// memory directly.  Splitting each chunk's chain is impossible (the state
// is sequential), so more parallelism means more chunks: later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kRansL = 1u << 23;

__device__ __forceinline__ void emit(uint8_t* row, int& ptr, uint32_t byte) {
  --ptr;
  if (ptr >= 0) row[ptr] = static_cast<uint8_t>(byte);
}

__global__ void rans_encode_kernel(
    const int32_t* __restrict__ sym,  // (lanes, T)
    const uint32_t* __restrict__ rcp, const uint32_t* __restrict__ rshift,
    const uint32_t* __restrict__ bias, const uint32_t* __restrict__ cmpl,
    const uint32_t* __restrict__ xmax, long long stride_t, long long stride_l,
    int k, int lanes, int t_len, int chunk, int n_chunks, int cap,
    uint8_t* __restrict__ buf,         // (n_chunks, lanes, cap), zeroed
    int32_t* __restrict__ start, int32_t* __restrict__ length,
    uint8_t* __restrict__ overflow) {  // (n_chunks, lanes)
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
    const int t = t0 + i;
    const int x = min(max(srow[t], 0), k - 1);
    const long long off = t * stride_t + lane * stride_l + x;
    const uint32_t xm = xmax[off];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (s >= xm) {
        emit(row, ptr, s & 0xFFu);
        s >>= 8;
      }
    }
    const uint32_t q = __umulhi(s, rcp[off]) >> rshift[off];
    s = s + bias[off] + q * cmpl[off];
  }
#pragma unroll
  for (int shift = 0; shift < 32; shift += 8) emit(row, ptr, (s >> shift) & 0xFFu);
  start[cell] = max(ptr, 0);
  length[cell] = cap - ptr;
  overflow[cell] = ptr < 0 ? 1 : 0;
}

}  // namespace

extern "C" int rans_encode_launch(
    const void* sym, const void* rcp, const void* rshift, const void* bias,
    const void* cmpl, const void* xmax, long long stride_t,
    long long stride_l, int k, int lanes, int t_len, int chunk, int n_chunks,
    int cap, void* buf, void* start, void* length, void* overflow,
    void* stream) {
  const int cells = n_chunks * lanes;
  const int block = 128;
  const int grid = (cells + block - 1) / block;
  rans_encode_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sym), static_cast<const uint32_t*>(rcp),
      static_cast<const uint32_t*>(rshift), static_cast<const uint32_t*>(bias),
      static_cast<const uint32_t*>(cmpl), static_cast<const uint32_t*>(xmax),
      stride_t, stride_l, k, lanes, t_len, chunk, n_chunks, cap,
      static_cast<uint8_t*>(buf), static_cast<int32_t*>(start),
      static_cast<int32_t*>(length), static_cast<uint8_t*>(overflow));
  return static_cast<int>(cudaGetLastError());
}

// One rANS symbol pop per lane for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rans_decode.py::rans_decode_step
// (body _decode_step_kernel).  One thread per lane:
//   slot = s & (2**n - 1);
//   candidate verify (each candidate clipped to [0, K-1], one probe while
//   the lane is not yet resolved), then the masked binary search with
//   exactly ceil_log2(K) iterations, counting only active ones and keeping
//   the cdf[mid] == slot early commit (repro/core/search.py);
//   s = f * (s >> n) + slot - start (mod 2**32);
//   a 2-step masked refill where a read outside [0, cap) injects 0 and
//   counts toward `under` when the refill is active.
// Tables are this step's rows, shared (K,) / (K+1,) (lane strides 0) or
// per-lane (lanes, K) / (lanes, K+1); candidates (lanes, topk).  Streams
// are lane-major (lanes, cap) rows.
//
// What bounds it on this card: launch latency.  The work is a few dozen
// dependent loads per lane (~100 B per lane), nanoseconds at the memory
// rate, so one launch per position dominates.  The design reads tables and
// stream bytes straight from global memory (no one-hot gathers); CUDA
// graphs or fusing the SPC and top-k into the step are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kRansL = 1u << 23;

__global__ void rans_decode_step_kernel(
    const uint8_t* __restrict__ buf, int cap,
    const uint32_t* __restrict__ s_in, const int32_t* __restrict__ ptr_in,
    const uint32_t* __restrict__ freq, const uint32_t* __restrict__ cdf,
    long long freq_lane_stride, long long cdf_lane_stride, int k,
    const int32_t* __restrict__ cands, int topk, int lanes, int prob_bits,
    int n_iter, uint32_t* __restrict__ s_out, int32_t* __restrict__ ptr_out,
    int32_t* __restrict__ sym_out, int32_t* __restrict__ probes_out,
    int32_t* __restrict__ under_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const uint32_t* cd = cdf + lane * cdf_lane_stride;
  const uint32_t* fr = freq + lane * freq_lane_stride;
  const uint8_t* row = buf + static_cast<long long>(lane) * cap;
  uint32_t s = s_in[lane];
  int ptr = ptr_in[lane];
  const uint32_t slot = s & ((1u << prob_bits) - 1u);

  int probes = 0;
  bool found = false;
  int x_spec = 0;
  for (int j = 0; j < topk; ++j) {
    const int cand = min(max(cands[lane * topk + j], 0), k - 1);
    const bool ok = cd[cand] <= slot && slot < cd[cand + 1];
    if (!found) {
      ++probes;
      if (ok) x_spec = cand;
    }
    found = found || ok;
  }
  int lo = found ? x_spec : 0;
  int hi = found ? x_spec + 1 : k;
  for (int it = 0; it < n_iter; ++it) {
    if (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      const uint32_t c_mid = cd[mid];
      if (c_mid <= slot) {
        lo = mid;
        if (c_mid == slot) hi = mid + 1;
      } else {
        hi = mid;
      }
      ++probes;
    }
  }
  const int x = lo;
  s = fr[x] * (s >> prob_bits) + slot - cd[x];

  int under = 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (s < kRansL) {
      uint32_t byte = 0;
      if (ptr < 0 || ptr >= cap) {
        ++under;
      } else {
        byte = row[ptr];
      }
      s = (s << 8) | byte;
      ++ptr;
    }
  }
  s_out[lane] = s;
  ptr_out[lane] = ptr;
  sym_out[lane] = x;
  probes_out[lane] = probes;
  under_out[lane] = under;
}

}  // namespace

extern "C" int rans_decode_step_launch(
    const void* buf, int cap, const void* s_in, const void* ptr_in,
    const void* freq, const void* cdf, long long freq_lane_stride,
    long long cdf_lane_stride, int k, const void* cands, int topk, int lanes,
    int prob_bits, int n_iter, void* s_out, void* ptr_out, void* sym_out,
    void* probes_out, void* under_out, void* stream) {
  const int block = 128;
  const int grid = (lanes + block - 1) / block;
  rans_decode_step_kernel<<<grid, block, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), cap,
      static_cast<const uint32_t*>(s_in), static_cast<const int32_t*>(ptr_in),
      static_cast<const uint32_t*>(freq), static_cast<const uint32_t*>(cdf),
      freq_lane_stride, cdf_lane_stride, k,
      static_cast<const int32_t*>(cands), topk, lanes, prob_bits, n_iter,
      static_cast<uint32_t*>(s_out), static_cast<int32_t*>(ptr_out),
      static_cast<int32_t*>(sym_out), static_cast<int32_t*>(probes_out),
      static_cast<int32_t*>(under_out));
  return static_cast<int>(cudaGetLastError());
}

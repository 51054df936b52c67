// Full-stream multi-lane rANS decode for Hopper (sm_90a): kernels B3 and B4.
//
// Replaces the TPU kernels repro/kernels/rans_decode.py::rans_decode_lanes
// (B3) and ::rans_decode_slab (B4), one Pallas body (_decode_kernel) entered
// two ways.  One launch decodes a whole stream: one thread owns one
// (chunk, lane) cell and walks that chunk's rows in order, writing
// sym[lane, c * chunk + t] directly.  Per cell:
//   the 4-byte big-endian state header, each read at or past the cell's
//   read limit counted in `under`;
//   per row: slot = s & (2**n - 1); the candidates (each clipped to
//   [0, K-1], one probe while the lane is unresolved); with a predictor the
//   window verify, lo_w = clip(mu - d, 0, K-1), hi_w = clip(mu + d + 1, 1,
//   K), a hit iff cdf[lo_w] <= slot < cdf[hi_w] on an unresolved lane, one
//   probe for every unresolved lane; then the masked binary search with
//   exactly ceil_log2(K) iterations, counting only active ones, with the
//   cdf[mid] == slot early commit (repro/core/search.py);
//   s = f * (s >> n) + slot - cdf[x] (mod 2**32) and the 2-step masked
//   refill, each active refill at or past the limit counted and fed 0.
// The predictor context lives in registers (at most kMaxWindow entries) and
// resets per chunk: NeighborAverage (init -1, mu = sum of the valid entries
// // their count, or 0; shift-in), LastValue (init 0), ZeroPredictor.
//
// Byte sources.  B3 reads the dense right-aligned (n_chunks, lanes, cap)
// streams: column p of a cell reads buf[cell, p] for 0 <= p < cap and 0
// elsewhere; the read limit is cap.  B4 reads the packed (S,) container
// payload through per-cell windows of cap bytes at `base` (host-clipped to
// [0, S - cap]): column p reads slab[base + p] only when 0 <= p < cap and
// wstart <= p < wstart + wlen, and 0 otherwise; the read limit is
// wstart + wlen.  A hostile index therefore reads zeros inside the slab,
// exactly as the reference's clamped VMEM windows do.
//
// Tables: static (K,) rows sit in shared memory (K <= kSmemTableMax);
// per-position (T, K) and per-lane (T, lanes, K) rows are read from global
// memory through element strides (K contiguous), as the encode kernel does.
//
// What bounds it on this card: the serial chain of dependent loads per
// cell (state -> slot -> ~10 CDF probes -> state), with only
// n_chunks * lanes threads live (64 to 512 on this repository's paths), so
// it is latency-bound far above its byte bound.  The design has no
// one-hot gathers, no VMEM windows and no t_block padding rows; more
// parallelism means more chunks or lanes, which the stream format fixes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kRansL = 1u << 23;
constexpr int kMaxWindow = 16;
constexpr int kSmemTableMax = 4096;
constexpr int kBlock = 64;

enum Predictor : int {
  kNone = 0,
  kNeighborAverage = 1,
  kLastValue = 2,
  kZero = 3,
};

// One cell's byte source: row[p] is readable for lo <= p < hi; reads before
// 0 or at or past `limit` count as underflow.
struct Source {
  const uint8_t* row;
  long long lo;
  long long hi;
  long long limit;

  __device__ __forceinline__ uint32_t read(long long p, int& under) const {
    if (p < 0 || p >= limit) ++under;
    return (p >= lo && p < hi) ? static_cast<uint32_t>(row[p]) : 0u;
  }
};

__global__ void __launch_bounds__(kBlock) rans_decode_lanes_kernel(
    const uint8_t* __restrict__ src, const int32_t* __restrict__ start,
    const int32_t* __restrict__ base, const int32_t* __restrict__ wlen,
    int cap, const uint32_t* __restrict__ freq,
    const uint32_t* __restrict__ cdf, long long f_st, long long f_sl,
    long long c_st, long long c_sl, int k, int static_smem,
    const int32_t* __restrict__ cands, int topk, int lanes, int t_len,
    int chunk, int n_chunks, int prob_bits, int n_iter, int pred,
    int window, int delta, int32_t* __restrict__ sym,
    int32_t* __restrict__ probes_out, int32_t* __restrict__ under_out) {
  extern __shared__ uint32_t smem[];
  const uint32_t* fr_base = freq;
  const uint32_t* cd_base = cdf;
  if (static_smem) {
    for (int i = threadIdx.x; i < k; i += blockDim.x) smem[i] = freq[i];
    for (int i = threadIdx.x; i <= k; i += blockDim.x) smem[k + i] = cdf[i];
    __syncthreads();
    fr_base = smem;
    cd_base = smem + k;
  }
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= n_chunks * lanes) return;
  const int c = cell / lanes;
  const int lane = cell - c * lanes;
  const int t0 = c * chunk;
  const int n = min(chunk, t_len - t0);

  const long long ws = start[cell];
  Source in;
  if (base != nullptr) {
    in.row = src + base[cell];
    in.limit = ws + wlen[cell];
    in.lo = ws > 0 ? ws : 0;
    in.hi = in.limit < cap ? in.limit : cap;
  } else {
    in.row = src + static_cast<long long>(cell) * cap;
    in.lo = 0;
    in.hi = cap;
    in.limit = cap;
  }

  int under = 0;
  long long ptr = ws;
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s = (s << 8) | in.read(ptr, under);
    ++ptr;
  }

  int ctx[kMaxWindow];
#pragma unroll
  for (int w = 0; w < kMaxWindow; ++w) ctx[w] = pred == kNeighborAverage ? -1 : 0;

  const uint32_t mask = (1u << prob_bits) - 1u;
  int32_t* sym_row = sym + static_cast<long long>(lane) * t_len + t0;
  int probes = 0;
  for (int t = 0; t < n; ++t) {
    const long long tp = t0 + t;
    const uint32_t* fr = fr_base + tp * f_st + lane * f_sl;
    const uint32_t* cd = cd_base + tp * c_st + lane * c_sl;
    const uint32_t slot = s & mask;

    bool found = false;
    int x_spec = 0;
    if (topk) {
      const int32_t* row = cands + (tp * lanes + lane) * topk;
      for (int j = 0; j < topk; ++j) {
        const int cand = min(max(row[j], 0), k - 1);
        const bool ok = cd[cand] <= slot && slot < cd[cand + 1];
        if (!found) {
          ++probes;
          if (ok) x_spec = cand;
        }
        found = found || ok;
      }
    }
    int lo = 0;
    int hi = k;
    if (pred != kNone) {
      long long mu = 0;
      if (pred == kNeighborAverage) {
        long long sum = 0;
        int n_valid = 0;
#pragma unroll
        for (int w = 0; w < kMaxWindow; ++w) {
          if (w < window && ctx[w] >= 0) {
            sum += ctx[w];
            ++n_valid;
          }
        }
        mu = n_valid ? sum / n_valid : 0;
      } else if (pred == kLastValue) {
        mu = ctx[0];
      }
      const long long lo_l = mu - delta;
      const long long hi_l = mu + delta + 1;
      const int lo_w = static_cast<int>(lo_l < 0 ? 0 : (lo_l > k - 1 ? k - 1 : lo_l));
      const int hi_w = static_cast<int>(hi_l < 1 ? 1 : (hi_l > k ? k : hi_l));
      const bool hit = !found && cd[lo_w] <= slot && slot < cd[hi_w];
      if (!found) ++probes;
      if (hit) {
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
    sym_row[t] = x;

    if (pred == kNeighborAverage) {
#pragma unroll
      for (int w = 0; w < kMaxWindow - 1; ++w) {
        if (w < window - 1) ctx[w] = ctx[w + 1];
      }
#pragma unroll
      for (int w = 0; w < kMaxWindow; ++w) {
        if (w == window - 1) ctx[w] = x;
      }
    } else if (pred == kLastValue) {
      ctx[0] = x;
    }

    s = fr[x] * (s >> prob_bits) + slot - cd[x];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (s < kRansL) {
        s = (s << 8) | in.read(ptr, under);
        ++ptr;
      }
    }
  }
  probes_out[cell] = probes;
  under_out[cell] = under;
}

int launch(const void* src, const void* start, const void* base,
           const void* wlen, int cap, const void* freq, const void* cdf,
           long long f_st, long long f_sl, long long c_st, long long c_sl,
           int k, const void* cands, int topk, int lanes, int t_len,
           int chunk, int n_chunks, int prob_bits, int n_iter, int pred,
           int window, int delta, void* sym, void* probes, void* under,
           void* stream) {
  if (window < 0 || window > kMaxWindow) return static_cast<int>(cudaErrorInvalidValue);
  const int cells = n_chunks * lanes;
  const int grid = (cells + kBlock - 1) / kBlock;
  const int static_smem = f_st == 0 && f_sl == 0 && k <= kSmemTableMax;
  const size_t smem = static_smem ? (2 * static_cast<size_t>(k) + 1) * sizeof(uint32_t) : 0;
  rans_decode_lanes_kernel<<<grid, kBlock, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const int32_t*>(start),
      static_cast<const int32_t*>(base), static_cast<const int32_t*>(wlen),
      cap, static_cast<const uint32_t*>(freq),
      static_cast<const uint32_t*>(cdf), f_st, f_sl, c_st, c_sl, k,
      static_smem, static_cast<const int32_t*>(cands), topk, lanes, t_len,
      chunk, n_chunks, prob_bits, n_iter, pred, window, delta,
      static_cast<int32_t*>(sym), static_cast<int32_t*>(probes),
      static_cast<int32_t*>(under));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B3: dense right-aligned streams buf (n_chunks, lanes, cap), start
// (n_chunks, lanes).
extern "C" int rans_decode_lanes_launch(
    const void* buf, const void* start, int cap, const void* freq,
    const void* cdf, long long f_st, long long f_sl, long long c_st,
    long long c_sl, int k, const void* cands, int topk, int lanes, int t_len,
    int chunk, int n_chunks, int prob_bits, int n_iter, int pred, int window,
    int delta, void* sym, void* probes, void* under, void* stream) {
  return launch(buf, start, nullptr, nullptr, cap, freq, cdf, f_st, f_sl,
                c_st, c_sl, k, cands, topk, lanes, t_len, chunk, n_chunks,
                prob_bits, n_iter, pred, window, delta, sym, probes, under,
                stream);
}

// B4: the packed (S,) payload slab read through per-cell windows of cap
// bytes at base (n_chunks, lanes), span [wstart, wstart + wlen).
extern "C" int rans_decode_slab_launch(
    const void* slab, const void* base, const void* wstart, const void* wlen,
    int cap, const void* freq, const void* cdf, long long f_st,
    long long f_sl, long long c_st, long long c_sl, int k, const void* cands,
    int topk, int lanes, int t_len, int chunk, int n_chunks, int prob_bits,
    int n_iter, int pred, int window, int delta, void* sym, void* probes,
    void* under, void* stream) {
  return launch(slab, wstart, base, wlen, cap, freq, cdf, f_st, f_sl, c_st,
                c_sl, k, cands, topk, lanes, t_len, chunk, n_chunks,
                prob_bits, n_iter, pred, window, delta, sym, probes, under,
                stream);
}

// SPC quantization for Hopper (sm_90a): kernel B6.
//
// Replaces the TPU kernel repro/kernels/spc_quantize.py::spc_quantize (body
// _spc_quantize_kernel): BF16 probabilities -> fixed-point frequencies that
// sum to 2**n exactly, every f >= 1.  One block per row (B rows, K symbols);
// thread i owns symbols i, i + blockDim, ...:
//   1. p = bf16(p) (round to nearest even, subnormals kept); p = 0 where it
//      is not finite or <= 0;
//   2. scaled = p * 2**n in float32 (exact: the factor is a power of two);
//   3. f0 = max(1, rint(scaled)) (half to even, as jnp.round / torch.round);
//   4. delta = 2**n - sum f0, a block reduction in 64-bit integers;
//   5. resid = scaled - f0, kept in shared memory;
//   6. stable ranks by dense pairwise comparison over shared memory, ties
//      broken by index:
//        rank_desc(i) = #{j : r_j > r_i} + #{j < i : r_j == r_i}
//        rank_asc(i)  = #{j : r_j < r_i} + #{j < i : r_j == r_i};
//   7. delta >= 0: f = f0 + delta / K + (rank_desc < delta % K);
//   8. delta < 0 (the waterfill, smallest residual first, never below 1):
//        cum_excl(i) = sum over rank_asc(j) < rank_asc(i) of (f0_j - 1),
//      in 64-bit integers (the TPU kernel sums in float32, exact only below
//      2**24), take = clamp(-delta - cum_excl, 0, f0 - 1), f = f0 - take.
// Only the branch a row needs is computed.  The result equals the sort-based
// repro_torch.core.spc.quantize_probs on every row.
//
// What bounds it on this card: the dense ranking is O(K**2) compares per
// row (K**2 = 65,536 at K = 256) against a byte bound of 8 B per entry, so
// it is operation-bound far above its bound.  Shared memory holds resid,
// f0 and rank_asc (12 B per symbol, K <= kMaxK).  A block-wide stable sort
// (O(K log K)) is the redesign for a later change.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kMaxK = 16384;  // 12 B x 16384 = 192 KB; MAX_K in spc_quantize.py

__device__ __forceinline__ long long block_sum(long long v, long long* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) scratch[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long total = 0;
    for (int w = 0; w < (blockDim.x >> 5); ++w) total += scratch[w];
    scratch[32] = total;
  }
  __syncthreads();
  return scratch[32];
}

// Stable rank of element i among resid[0, k): `desc` counts the larger
// residuals, otherwise the smaller ones; equal residuals before i count.
__device__ __forceinline__ int stable_rank(const float* resid, int k, int i,
                                           bool desc) {
  const float ri = resid[i];
  int rank = 0;
  for (int j = 0; j < k; ++j) {
    const float rj = resid[j];
    rank += (desc ? rj > ri : rj < ri) || (rj == ri && j < i);
  }
  return rank;
}

__global__ void __launch_bounds__(kBlock) spc_quantize_kernel(
    const float* __restrict__ probs,  // (B, K)
    int k, int prob_bits,
    int32_t* __restrict__ freq) {     // (B, K)
  extern __shared__ unsigned char smem_raw[];
  float* resid = reinterpret_cast<float*>(smem_raw);
  int32_t* f0s = reinterpret_cast<int32_t*>(resid + k);
  int32_t* rank_asc = f0s + k;
  __shared__ long long scratch[33];

  const long long row = static_cast<long long>(blockIdx.x) * k;
  const int total = 1 << prob_bits;
  const float scale = static_cast<float>(total);
  long long sum = 0;
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    float p = __bfloat162float(__float2bfloat16_rn(probs[row + i]));
    p = (isfinite(p) && p > 0.0f) ? p : 0.0f;
    const float scaled = p * scale;
    const int f0 = max(1, __float2int_rn(scaled));
    f0s[i] = f0;
    resid[i] = scaled - static_cast<float>(f0);
    sum += f0;
  }
  const long long delta = total - block_sum(sum, scratch);  // syncs resid

  if (delta >= 0) {
    const long long base = delta / k;
    const long long extra = delta % k;
    for (int i = threadIdx.x; i < k; i += blockDim.x) {
      const int rd = stable_rank(resid, k, i, true);
      freq[row + i] = static_cast<int32_t>(f0s[i] + base + (rd < extra));
    }
    return;
  }
  for (int i = threadIdx.x; i < k; i += blockDim.x)
    rank_asc[i] = stable_rank(resid, k, i, false);
  __syncthreads();
  const long long need = -delta;
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const int ra = rank_asc[i];
    long long cum_excl = 0;
    for (int j = 0; j < k; ++j)
      if (rank_asc[j] < ra) cum_excl += f0s[j] - 1;
    const long long cap = f0s[i] - 1;
    const long long take = min(max(need - cum_excl, 0LL), cap);
    freq[row + i] = static_cast<int32_t>(f0s[i] - take);
  }
}

}  // namespace

extern "C" int spc_quantize_launch(const void* probs, int b, int k,
                                   int prob_bits, void* freq, void* stream) {
  if (b < 1 || k < 1 || k > kMaxK || k > (1 << prob_bits))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 3 * static_cast<size_t>(k) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        spc_quantize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  spc_quantize_kernel<<<b, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(probs), k, prob_bits,
      static_cast<int32_t*>(freq));
  return static_cast<int>(cudaGetLastError());
}

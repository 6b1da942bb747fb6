// EmbeddingBag for Hopper (sm_90a): per bag, the sum over its non-pad
// slots of weight * table row, accumulated in float32.
//
// Replaces the TPU kernel of repro/kernels/embedding_bag/kernel.py:
//   embedding_bag <- embedding_bag_pallas / _bag_kernel (kernel.py:29, :18)
//
// indices (B, L) int32 (-1 pads), weights (B, L) float32, table (N, D)
// float32 or bfloat16 -> out (B, D) in the table's dtype.  An index outside
// [0, N) is read as a pad, so no slot reads outside the table.
//
// One warp per bag.  The warp reads 32 slots at once (an index and a weight
// a lane, coalesced), ballots the non-pad ones and walks them in order,
// broadcasting each slot's index and weight with a shuffle; for each, every
// lane adds weight * row[c] into float32 accumulators for columns c = lane
// + 32 * t of a chunk of 32 * kCols columns (one 128-byte read of a float32
// row per t).  The TPU kernel gathers a (bags, L, D) block into VMEM and
// reduces it; here no block of rows is materialised.
//
// Bound on this card: bytes.  Each slot's 8 bytes, each distinct row the
// bags touch once, and the output; a row shared by many bags is re-read
// from L2 rather than from device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kCols = 4;  // accumulator columns a lane owns per chunk
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_float(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void bag_kernel(const int32_t* __restrict__ indices,
                           const float* __restrict__ weights,
                           const T* __restrict__ table, T* __restrict__ out,
                           int B, int L, int N, int D) {
  const int bag = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (bag >= B) return;  // uniform per warp
  const int32_t* idx = indices + static_cast<size_t>(bag) * L;
  const float* w = weights + static_cast<size_t>(bag) * L;
  for (int c0 = 0; c0 < D; c0 += 32 * kCols) {
    float acc[kCols];
#pragma unroll
    for (int t = 0; t < kCols; ++t) acc[t] = 0.f;
    for (int l0 = 0; l0 < L; l0 += 32) {
      const bool in = l0 + lane < L;
      const int my_idx = in ? idx[l0 + lane] : -1;
      const float my_w = in ? w[l0 + lane] : 0.f;
      unsigned live = __ballot_sync(kFull, my_idx >= 0 && my_idx < N);
      while (live) {
        const int src = __ffs(live) - 1;
        live &= live - 1;
        const int row = __shfl_sync(kFull, my_idx, src);
        const float wt = __shfl_sync(kFull, my_w, src);
        const T* r = table + static_cast<size_t>(row) * D;
#pragma unroll
        for (int t = 0; t < kCols; ++t) {
          const int c = c0 + lane + 32 * t;
          if (c < D) acc[t] += wt * to_float(r[c]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kCols; ++t) {
      const int c = c0 + lane + 32 * t;
      if (c < D) from_float(out + static_cast<size_t>(bag) * D + c, acc[t]);
    }
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (the table's and the output's)
int embedding_bag(const void* indices, const void* weights, const void* table,
                  void* out, int B, int L, int N, int D, int dtype,
                  void* stream) {
  if (B <= 0 || D <= 0) return 0;
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    bag_kernel<float><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        static_cast<const int32_t*>(indices),
        static_cast<const float*>(weights), static_cast<const float*>(table),
        static_cast<float*>(out), B, L, N, D);
  else if (dtype == 1)
    bag_kernel<__nv_bfloat16><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        static_cast<const int32_t*>(indices),
        static_cast<const float*>(weights),
        static_cast<const __nv_bfloat16*>(table),
        static_cast<__nv_bfloat16*>(out), B, L, N, D);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

const char* embedding_bag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// PageRank's contribution sums for Hopper (sm_90a).
//
// Replaces the TPU kernel slab_contrib_sums_pallas
// (repro/kernels/slab_pagerank/kernel.py:23), which runs slab_sweep_pallas
// (repro/kernels/slab_sweep/kernel.py:80) in its sum semiring with no
// frontier; repro/kernels/slab_pagerank/ref.py spells out the function.
//
// For every slab row whose owner is >= 0: the sum of contrib[key] over
// every one of its 128 lanes whose key, read as uint32, is < n.  EMPTY,
// TOMBSTONE and out-of-range keys are dropped wherever they sit in the row,
// so the rows need not be packed (kernel 3, slab_sweep.cu, stops at a row's
// first EMPTY lane and does).  A row whose owner is < 0 writes 0 and reads
// no key.
//
// Design.  A group of kGroup = 8 threads takes kRows = 4 rows (16 rows a
// warp, 128 a block of eight warps).  The owners are one load a row (a
// broadcast), all four issued together.  A row with an owner is read
// whole: each thread loads kQuads = 4 uint4 of keys a row (lanes
// 4j + 32q .. +3 for q = 0..3), the 16 loads of the four rows issued
// before any is used, so a step of the group is one coalesced 128 B
// segment of a row and the four rows' 2 KB are in flight at once.  The
// key loads stream past L1 and are marked evict-first in L2 (__ldcs): each
// key is read once, and the L2 is left to contrib[] (4 MB at V = 2^20),
// whose gathers go through the read-only path (__ldg).  Every lane's
// gather is issued before the sum, so the 16 gathers of a thread's row
// overlap.  The lane reduction is a
// __shfl_xor_sync butterfly within the group that every thread of the warp
// joins, and one thread writes the row: no atomics.  The sum adds in
// another order than the reference's lane reduction, so it agrees with it
// to rounding of the row total (a few float32 ulp).
//
// Bound: bytes.  What the function needs is the whole 512 B of keys of
// every allocated row (it sums every lane), 4 B of owner and 4 B of output
// a row, and contrib[] once: at the serve's transpose (1.1M allocated rows
// of 2.1M) ~0.177 ms at 3.35 TB/s.  The three loads of a row (owner, keys,
// contrib) depend on one another, so the kernel holds many rows in flight
// (768 an SM at its 40 registers a thread) to hide their latency.
// kGroup, kRows and kThreads are the knobs tools/slab_variants.py times
// (``--kernels contrib``): on the serve's RMAT scale-20 transpose four rows
// a group ran 2.4% faster than two and 4.7% faster than one; 4, 16 and 32
// threads a row ran 3-12% slower than 8 (two rows a group), 512-thread
// blocks 0.6% faster, and plain (cached) key loads 4% slower (PERF.md §6).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlabWidth = 128;
constexpr int kGroup = 8;                          // threads a row
constexpr int kRows = 4;                           // rows a group
constexpr int kThreads = 256;
constexpr int kQuads = kSlabWidth / (4 * kGroup);  // uint4 a thread a row
constexpr int kGroupsPerBlock = kThreads / kGroup;
constexpr int kRowsPerBlock = kGroupsPerBlock * kRows;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNoKey = 0xFFFFFFFFu;           // >= every n

__global__ void __launch_bounds__(kThreads)
    contrib_sums_kernel(const uint4* __restrict__ keys,
                        const int32_t* __restrict__ owner,
                        const float* __restrict__ contrib,
                        float* __restrict__ out, int S, uint32_t n) {
  const int j = threadIdx.x % kGroup;              // thread within the group
  const int g = threadIdx.x / kGroup;
  // a group's rows lie kGroupsPerBlock apart, so each round of the block's
  // groups reads consecutive rows
  const long long first =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + g;

  bool own[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long row = first + r * kGroupsPerBlock;
    own[r] = row < S && __ldg(owner + row) >= 0;
  }
  uint4 kv[kRows][kQuads];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const uint4* k4 = keys +
        static_cast<size_t>(first + r * kGroupsPerBlock) * (kSlabWidth / 4) +
        j;
#pragma unroll
    for (int q = 0; q < kQuads; ++q)
      kv[r][q] = own[r] ? __ldcs(k4 + q * kGroup)
                        : make_uint4(kNoKey, kNoKey, kNoKey, kNoKey);
  }
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float v[kQuads * 4];
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      const uint32_t kk[4] = {kv[r][q].x, kv[r][q].y, kv[r][q].z,
                              kv[r][q].w};
#pragma unroll
      for (int l = 0; l < 4; ++l)
        v[4 * q + l] = kk[l] < n ? __ldg(contrib + kk[l]) : 0.0f;
    }
    acc[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < kQuads * 4; ++i) acc[r] += v[i];
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int off = kGroup / 2; off > 0; off >>= 1)
      acc[r] += __shfl_xor_sync(kFull, acc[r], off);
    const long long row = first + r * kGroupsPerBlock;
    if (j == 0 && row < S) out[row] = acc[r];
  }
}

}  // namespace

extern "C" {

// keys (S, 128) uint32 (16-byte aligned), owner (S,) int32, contrib (at
// least n) float32, out (S,) float32.  Returns cudaGetLastError() after the
// launch.
int slab_contrib_sums(const void* keys, const void* owner,
                      const void* contrib, void* out, int S, unsigned int n,
                      void* stream) {
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (static_cast<long long>(S) + kRowsPerBlock - 1) /
                           kRowsPerBlock;
  contrib_sums_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(keys), static_cast<const int32_t*>(owner),
      static_cast<const float*>(contrib), static_cast<float*>(out), S, n);
  return static_cast<int>(cudaGetLastError());
}

const char* slab_contrib_sums_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

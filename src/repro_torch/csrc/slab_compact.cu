// Slab-compaction kernels for Hopper (sm_90a): the live-lane census and the
// chain-rank walk that plan a compaction.
//
// Replaces the TPU kernels of repro/kernels/slab_compact/kernel.py:
//   slab_live       <- slab_live_pallas  / _live_kernel  (kernel.py:60, :47)
//   slab_chain_rank <- chain_rank_pallas / _chain_kernel (kernel.py:137, :95)
//
// Keys are 32-bit words: the port stores them as int32 bit patterns of the
// reference's uint32 keys, and the census reads them as uint32_t.
//
// Census.  One warp per row.  A row is 128 keys = 512 bytes, so each of the
// 32 threads loads one uint4 (four lanes) and forms four live bits (owner
// >= 0 and key < TOMBSTONE as uint32).  A warp inclusive scan of the
// per-thread counts (__shfl_up_sync) gives each thread the live lanes
// before its four; the lane ranks follow, stored as one int4, and the last
// thread's sum is the row's count.  An unallocated row reads its owner only
// and writes zeros.  Bound: bytes.  It reads the keys of allocated rows
// once and writes a rank for every lane (512 B per row), so the rank plane
// it writes is the larger half of its traffic; loads and stores are 16 B a
// thread, coalesced across the warp.
//
// Chain rank.  One thread per bucket walks the bucket's chain from its head
// row b: per visited slab it stores the live lanes before it (base rank),
// b and its chain position, and at the end the bucket's survivor total.
// Chains are disjoint, so no two threads write one row.  Rows no chain
// reaches keep 0 / -1 / -1 from three memsets issued first on the same
// stream.  Bound: neither bytes nor operations.  Each hop is a dependent
// load of next_slab, so a thread's time is its chain's length times the
// DRAM latency, and the kernel lasts as long as the longest chain (a hub's,
// with hashing off).  The two loads of a hop (next and live count) are
// issued together.  A warp per bucket prefetching ahead, or pointer jumping
// over the chains, would shorten that; this kernel is the simple one.  The
// walk stops at -1, at a row outside the pool, or after S hops, so a
// corrupt chain cannot hang the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlabWidth = 128;
constexpr int kWarpsPerBlock = 8;
constexpr uint32_t kTombstone = 0xFFFFFFFDu;

__global__ void live_kernel(const uint32_t* __restrict__ keys,
                            const int32_t* __restrict__ slab_vertex,
                            int32_t* __restrict__ cnt,
                            int32_t* __restrict__ rank, int S) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int t = threadIdx.x & 31;
  if (row >= S) return;  // uniform per warp: row is the same for all 32
  int b0 = 0, b1 = 0, b2 = 0, b3 = 0;
  if (slab_vertex[row] >= 0) {
    const uint4 v = reinterpret_cast<const uint4*>(
        keys + static_cast<size_t>(row) * kSlabWidth)[t];
    b0 = v.x < kTombstone;
    b1 = v.y < kTombstone;
    b2 = v.z < kTombstone;
    b3 = v.w < kTombstone;
  }
  const int c = b0 + b1 + b2 + b3;
  int incl = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (t >= d) incl += y;
  }
  int4 r;
  r.x = incl - c;
  r.y = r.x + b0;
  r.z = r.y + b1;
  r.w = r.z + b2;
  reinterpret_cast<int4*>(rank + static_cast<size_t>(row) * kSlabWidth)[t] =
      r;
  if (t == 31) cnt[row] = incl;
}

__global__ void chain_kernel(const int32_t* __restrict__ next_slab,
                             const int32_t* __restrict__ live_count,
                             int32_t* __restrict__ base_rank,
                             int32_t* __restrict__ bucket_of,
                             int32_t* __restrict__ chain_pos,
                             int32_t* __restrict__ counts, int S,
                             int n_buckets) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_buckets) return;
  int cur = b, run = 0, pos = 0;
  while (static_cast<unsigned>(cur) < static_cast<unsigned>(S) && pos < S) {
    const int nxt = next_slab[cur];
    const int lc = live_count[cur];
    base_rank[cur] = run;
    bucket_of[cur] = b;
    chain_pos[cur] = pos;
    run += lc;
    ++pos;
    cur = nxt;
  }
  counts[b] = run;
}

}  // namespace

extern "C" {

int slab_live(const void* keys, const void* slab_vertex, void* cnt,
              void* rank, int S, void* stream) {
  if (S > 0) {
    const int blocks = (S + kWarpsPerBlock - 1) / kWarpsPerBlock;
    live_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(keys),
        static_cast<const int32_t*>(slab_vertex),
        static_cast<int32_t*>(cnt), static_cast<int32_t*>(rank), S);
  }
  return static_cast<int>(cudaGetLastError());
}

int slab_chain_rank(const void* next_slab, const void* live_count,
                    void* base_rank, void* bucket_of, void* chain_pos,
                    void* counts, int S, int n_buckets, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(S) * sizeof(int32_t);
  cudaError_t err = cudaMemsetAsync(base_rank, 0, bytes, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(bucket_of, 0xFF, bytes, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(chain_pos, 0xFF, bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_buckets > 0) {
    const int threads = 256;
    chain_kernel<<<(n_buckets + threads - 1) / threads, threads, 0, s>>>(
        static_cast<const int32_t*>(next_slab),
        static_cast<const int32_t*>(live_count),
        static_cast<int32_t*>(base_rank), static_cast<int32_t*>(bucket_of),
        static_cast<int32_t*>(chain_pos), static_cast<int32_t*>(counts), S,
        n_buckets);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* slab_compact_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

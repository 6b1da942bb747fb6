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
// Chain rank.  Every bucket's chain is walked from its head row b: each
// visited slab gets the live lanes before it (base rank), b and its chain
// position, and each bucket its survivor total.  Chains are disjoint, so no
// two walks write one row.  Three launches on one stream:
//   1. chain_init_kernel sets every overflow row to 0 / -1 / -1, which rows
//      that no chain reaches keep, and zeroes the queue's count;
//   2. chain_kernel: one thread per bucket walks its own chain for up to
//      kThreadHops rows.  Most of a million buckets hold one or two slabs,
//      and for them a thread is the cheapest walker (a warp per bucket would
//      read a 128 B window per bucket).  A chain still going after that is
//      appended to a queue (one atomic per warp);
//   3. long_chain_kernel: a fixed grid of warps takes the queued chains in
//      turn, each chain whole to one warp.  The warp loads next_slab and
//      live_count at cur .. cur+31 (two coalesced 128 B lines), one ballot
//      of next_slab[cur+i] == cur+i+1 gives the run of consecutive rows that
//      are proven to be on the chain (bulk builds and compaction lay a
//      bucket's overflow slabs out so), an exclusive warp scan of the live
//      counts over the run gives their base ranks, and the three outputs are
//      stored coalesced; the next row is the pointer the window holds after
//      the run.  Up to 32 rows a round trip instead of one; the next
//      window's loads go out before this one's scan and stores.
// Integer sums in any order give the same ranks, so the outputs are the
// serial walk's on any pool.  The walk stops at -1, at a row outside the
// pool, or after S rows, so a corrupt chain cannot hang the card.
// Bound: bytes (the outputs' S rows and the visited rows' two inputs); the
// time is the init pass, one wave of short walks and the longest queued
// chain's round trips (ceil(length / 32) on a consecutive run, one a row
// where the links are scattered).  Weakness: on a pool whose links are
// scattered the long walks are serial again, one round trip a row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlabWidth = 128;
constexpr int kWarpsPerBlock = 8;
constexpr uint32_t kTombstone = 0xFFFFFFFDu;
// rows a thread walks of its own bucket's chain before the chain is queued
constexpr int kThreadHops = 2;
// blocks of long_chain_kernel per SM
constexpr int kLongBlocksPerSM = 4;

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

// Rows from `from` up (rows below it are bucket heads, which every walk
// writes) to 0 / -1 / -1, and the queue's count to 0.
__global__ void chain_init_kernel(int32_t* __restrict__ base_rank,
                                  int32_t* __restrict__ bucket_of,
                                  int32_t* __restrict__ chain_pos,
                                  int* __restrict__ queued, int from, int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lead = min((4 - from % 4) % 4, S - from);  // rows before a quad
  const int quads = (S - from - lead) / 4;
  const int q0 = (from + lead) / 4;
  if (i < quads) {
    reinterpret_cast<int4*>(base_rank)[q0 + i] = make_int4(0, 0, 0, 0);
    reinterpret_cast<int4*>(bucket_of)[q0 + i] = make_int4(-1, -1, -1, -1);
    reinterpret_cast<int4*>(chain_pos)[q0 + i] = make_int4(-1, -1, -1, -1);
  }
  const int tail = (S - from - lead) % 4;
  if (i < lead + tail) {
    const int r = i < lead ? from + i : 4 * (q0 + quads) + i - lead;
    base_rank[r] = 0;
    bucket_of[r] = -1;
    chain_pos[r] = -1;
  }
  if (i == 0) *queued = 0;
}

// The rest of bucket b's chain from row cur, by the whole warp: run live
// lanes and pos rows lie before cur.  The next window's loads are issued
// before this window's scan and stores, so a step costs one load latency.
__device__ void walk_chain(const int32_t* __restrict__ next_slab,
                           const int32_t* __restrict__ live_count,
                           int32_t* __restrict__ base_rank,
                           int32_t* __restrict__ bucket_of,
                           int32_t* __restrict__ chain_pos,
                           int32_t* __restrict__ counts, int b, int cur,
                           int run, int pos, int S) {
  const int t = threadIdx.x & 31;
  int nw = -1, lc = 0;
  if (static_cast<unsigned>(cur) < static_cast<unsigned>(S) &&
      cur + t < S) {
    nw = next_slab[cur + t];
    lc = live_count[cur + t];
  }
  while (static_cast<unsigned>(cur) < static_cast<unsigned>(S) && pos < S) {
    const int w = cur + t;
    // rows cur .. cur+n-1 are on the chain: every link up to them is
    // w -> w + 1 inside the pool
    const unsigned linked =
        __ballot_sync(0xffffffffu, nw == w + 1 && w + 1 < S);
    const int n = min(linked == 0xffffffffu ? 32 : __ffs(~linked), S - pos);
    const int nxt = __shfl_sync(0xffffffffu, nw, n - 1);
    const int x = t < n ? lc : 0;
    nw = -1;
    lc = 0;
    if (static_cast<unsigned>(nxt) < static_cast<unsigned>(S) &&
        nxt + t < S && pos + n < S) {
      nw = next_slab[nxt + t];
      lc = live_count[nxt + t];
    }
    int incl = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (t >= d) incl += y;
    }
    if (t < n) {
      base_rank[w] = run + incl - x;
      bucket_of[w] = b;
      chain_pos[w] = pos + t;
    }
    run += __shfl_sync(0xffffffffu, incl, 31);
    pos += n;
    cur = nxt;
  }
  if (t == 0) counts[b] = run;
}

__global__ void chain_kernel(const int32_t* __restrict__ next_slab,
                             const int32_t* __restrict__ live_count,
                             int32_t* __restrict__ base_rank,
                             int32_t* __restrict__ bucket_of,
                             int32_t* __restrict__ chain_pos,
                             int32_t* __restrict__ counts,
                             int4* __restrict__ queue,
                             int* __restrict__ queued, int S,
                             int n_buckets) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = threadIdx.x & 31;
  // no early return: the whole warp takes part in the ballot below
  int cur = b < n_buckets ? b : -1, run = 0, pos = 0;
  for (int h = 0; h < kThreadHops &&
                  static_cast<unsigned>(cur) < static_cast<unsigned>(S) &&
                  pos < S;
       ++h) {
    const int nxt = next_slab[cur];
    const int lc = live_count[cur];
    base_rank[cur] = run;
    bucket_of[cur] = b;
    chain_pos[cur] = pos;
    run += lc;
    ++pos;
    cur = nxt;
  }
  const bool going =
      static_cast<unsigned>(cur) < static_cast<unsigned>(S) && pos < S;
  if (b < n_buckets && !going) counts[b] = run;
  const unsigned want = __ballot_sync(0xffffffffu, going);
  if (want) {
    const int leader = __ffs(want) - 1;
    int at = 0;
    if (t == leader) at = atomicAdd(queued, __popc(want));
    at = __shfl_sync(0xffffffffu, at, leader) +
         __popc(want & ((1u << t) - 1u));
    if (going) queue[at] = make_int4(b, cur, run, pos);
  }
}

__global__ void long_chain_kernel(const int32_t* __restrict__ next_slab,
                                  const int32_t* __restrict__ live_count,
                                  int32_t* __restrict__ base_rank,
                                  int32_t* __restrict__ bucket_of,
                                  int32_t* __restrict__ chain_pos,
                                  int32_t* __restrict__ counts,
                                  const int4* __restrict__ queue,
                                  const int* __restrict__ queued, int S) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int warps = (gridDim.x * blockDim.x) >> 5;
  const int n = *queued;
  for (int i = warp; i < n; i += warps) {
    const int4 e = queue[i];
    walk_chain(next_slab, live_count, base_rank, bucket_of, chain_pos,
               counts, e.x, e.y, e.z, e.w, S);
  }
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
                    void* counts, void* queue, int S, int n_buckets,
                    void* stream) {
  // queue: n_buckets int4 entries, then the count of entries
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S == 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;
  int* queued = static_cast<int*>(queue) + 4 * static_cast<size_t>(n_buckets);
  const int init_items = (S - n_buckets) / 4 + 6;
  chain_init_kernel<<<(init_items + threads - 1) / threads, threads, 0, s>>>(
      static_cast<int32_t*>(base_rank), static_cast<int32_t*>(bucket_of),
      static_cast<int32_t*>(chain_pos), queued, n_buckets, S);
  if (n_buckets > 0) {
    chain_kernel<<<(n_buckets + threads - 1) / threads, threads, 0, s>>>(
        static_cast<const int32_t*>(next_slab),
        static_cast<const int32_t*>(live_count),
        static_cast<int32_t*>(base_rank), static_cast<int32_t*>(bucket_of),
        static_cast<int32_t*>(chain_pos), static_cast<int32_t*>(counts),
        static_cast<int4*>(queue), queued, S, n_buckets);
    static int sms = 0;
    if (sms == 0) {
      int dev = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    long_chain_kernel<<<sms * kLongBlocksPerSM, threads, 0, s>>>(
        static_cast<const int32_t*>(next_slab),
        static_cast<const int32_t*>(live_count),
        static_cast<int32_t*>(base_rank), static_cast<int32_t*>(bucket_of),
        static_cast<int32_t*>(chain_pos), static_cast<int32_t*>(counts),
        static_cast<const int4*>(queue), queued, S);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* slab_compact_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Triangle-counting kernels for Hopper (sm_90a): the fused intersection
// count and the membership probe over host-materialised candidate rows.
//
// Replaces the TPU kernels of repro/kernels/slab_intersect/kernel.py:
//   slab_count <- slab_count_pallas / _count_kernel (kernel.py:120, :52)
//   probe_hits <- probe_hits_pallas / _probe_kernel (kernel.py:180, :170)
//
// Keys are 32-bit words: the port stores them as int32 bit patterns of the
// reference's uint32 keys, and both kernels read them as uint32_t.  A lane
// holds a neighbour when its key is below TOMBSTONE (EMPTY, TOMBSTONE and
// INVALID are the three largest words).
//
// Count.  A work item is an (edge u-v, bucket of v) pair: its head slab in
// G2 (-1 = inactive) and u.  The item's count is the number of valid lanes
// w along that chain for which (u, w) is in G1.  The warp-cooperative model
// of the paper: one warp owns an item and walks its G2 chain, one uint4 per
// thread per slab.  Each valid lane w is hash-probed into u's bucket chain
// in G1 (bucket_offset[u] + ((w * 2654435761 mod 2^32) >> 8) % bucket_count
// [u]), one uint4 per thread and one __ballot_sync per G1 slab, stopping at
// a hit or at the chain's end.
//
// The dense (edge, bucket) layout the callers build is mostly empty: an
// edge has max_bpv slots but its v has bucket_count[v] buckets, and at the
// serve's RMAT scale-20 graph 97.5% of the slots are inactive.  So a warp
// does not take one slot.  It reads 32 slots at once (one per thread,
// coalesced), ballots the active ones and works through them in turn; an
// inactive slot costs a 4-byte read and a 4-byte store of its zero.
//
// Bound: neither bytes nor operations.  Every candidate costs at least one
// dependent 512 B load of a G1 slab, and the G1 rows of one u are reused by
// its other items only through L1/L2, so the time is set by how many
// probes are in flight.  To keep more of them in flight, a warp probes up
// to kGroup candidates of one G2 slab together: the kGroup row loads are
// independent and issue back to back, then each candidate takes its ballot.
// Weakness: a warp whose 32 slots hold a hub's buckets does 32 items of
// work while its neighbours do none; items are not rebalanced across warps.
//
// Guards: a walk stops at a row outside its pool or after as many hops as
// the pool has rows, so a corrupt chain cannot hang the card.
//
// Membership probe.  One warp per query walks the query's C candidate rows
// (-1 skipped): each thread compares one uint4 of the row with w and one
// __ballot_sync says whether any lane holds it; the walk stops at the first
// hit.  Bound: bytes, one 512 B row per candidate row read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlabWidth = 128;
constexpr int kWarpsPerBlock = 8;
constexpr int kGroup = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kKnuth = 2654435761u;
constexpr uint32_t kTombstone = 0xFFFFFFFDu;

__device__ __forceinline__ uint4 row_quad(const uint32_t* __restrict__ keys,
                                          int row, int t) {
  return reinterpret_cast<const uint4*>(
      keys + static_cast<size_t>(row) * kSlabWidth)[t];
}

__device__ __forceinline__ bool quad_has(const uint4& v, uint32_t w) {
  return (v.x == w) | (v.y == w) | (v.z == w) | (v.w == w);
}

// Probe up to kGroup candidates (lanes whose bit is set in ``cand``, each
// holding its word in ``w``) into the G1 bucket window [boff, boff + bcnt);
// returns the number found and clears the bits it consumed.
__device__ __forceinline__ int probe_group(
    unsigned& cand, uint32_t w, const uint32_t* __restrict__ g1_keys,
    const int32_t* __restrict__ g1_next, int boff, int bcnt, int S1, int t) {
  uint32_t cw[kGroup];
  int pc[kGroup];
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    const int src = cand ? __ffs(cand) - 1 : 0;
    const bool live = cand != 0;
    cand &= cand - 1;
    cw[g] = __shfl_sync(kFull, w, src);
    pc[g] = live ? boff + static_cast<int>(((cw[g] * kKnuth) >> 8) %
                                           static_cast<uint32_t>(bcnt))
                 : -1;
  }
  int found = 0;
  for (int hop = 0; hop < S1; ++hop) {
    bool any = false;
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (static_cast<unsigned>(pc[g]) >= static_cast<unsigned>(S1))
        pc[g] = -1;
      any |= pc[g] != -1;
    }
    if (!any) break;
    uint4 r[kGroup];
    int nx[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      nx[g] = -1;
      if (pc[g] != -1) {
        r[g] = row_quad(g1_keys, pc[g], t);
        if (t == 0) nx[g] = g1_next[pc[g]];
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (pc[g] == -1) continue;  // uniform: pc[g] is the same in the warp
      const unsigned hit = __ballot_sync(kFull, quad_has(r[g], cw[g]));
      if (hit) {
        ++found;
        pc[g] = -1;
      } else {
        pc[g] = __shfl_sync(kFull, nx[g], 0);
      }
    }
  }
  return found;
}

__global__ void count_kernel(const uint32_t* __restrict__ g1_keys,
                             const int32_t* __restrict__ g1_next,
                             const int32_t* __restrict__ g1_boff,
                             const int32_t* __restrict__ g1_bcnt,
                             const uint32_t* __restrict__ g2_keys,
                             const int32_t* __restrict__ g2_next,
                             const int32_t* __restrict__ start,
                             const int32_t* __restrict__ us,
                             int32_t* __restrict__ out, int S1, int V1,
                             int S2, int B) {
  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
       (threadIdx.x >> 5)) * 32;
  const int t = threadIdx.x & 31;
  if (base >= B) return;  // uniform per warp
  const int64_t slot = base + t;
  const int my_start = slot < B ? start[slot] : -1;
  const int my_u = my_start != -1 ? us[slot] : 0;  // u only where active
  unsigned active = __ballot_sync(kFull, my_start != -1);
  int my_count = 0;
  while (active) {
    const int i = __ffs(active) - 1;
    active &= active - 1;
    int cur = __shfl_sync(kFull, my_start, i);
    const int u = __shfl_sync(kFull, my_u, i);
    int boff = 0, bcnt = 0;
    if (static_cast<unsigned>(u) < static_cast<unsigned>(V1)) {
      boff = g1_boff[u];
      bcnt = g1_bcnt[u];
    }
    int total = 0;
    for (int hop = 0;
         static_cast<unsigned>(cur) < static_cast<unsigned>(S2) && hop < S2;
         ++hop) {
      const uint4 v = row_quad(g2_keys, cur, t);
      int nxt = 0;
      if (t == 0) nxt = g2_next[cur];
      if (bcnt > 0) {
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          unsigned cand = __ballot_sync(kFull, w[j] < kTombstone);
          while (cand)
            total += probe_group(cand, w[j], g1_keys, g1_next, boff, bcnt,
                                 S1, t);
        }
      }
      cur = __shfl_sync(kFull, nxt, 0);
    }
    if (t == i) my_count = total;
  }
  if (slot < B) out[slot] = my_count;
}

__global__ void probe_hits_kernel(const uint32_t* __restrict__ ws,
                                  const int32_t* __restrict__ rows,
                                  const uint32_t* __restrict__ keys,
                                  uint8_t* __restrict__ out, int Q, int C,
                                  int S) {
  const int q = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int t = threadIdx.x & 31;
  if (q >= Q) return;  // uniform per warp
  const uint32_t w = ws[q];
  const int32_t* my_rows = rows + static_cast<size_t>(q) * C;
  int hit = 0;
  for (int c = 0; c < C && !hit; ++c) {
    const int r = my_rows[c];
    if (static_cast<unsigned>(r) >= static_cast<unsigned>(S)) continue;
    hit = __ballot_sync(kFull, quad_has(row_quad(keys, r, t), w)) != 0;
  }
  if (t == 0) out[q] = static_cast<uint8_t>(hit);
}

}  // namespace

extern "C" {

int slab_count(const void* g1_keys, const void* g1_next, const void* g1_boff,
               const void* g1_bcnt, const void* g2_keys, const void* g2_next,
               const void* start, const void* us, void* out, int S1, int V1,
               int S2, int B, void* stream) {
  if (B > 0) {
    const int64_t warps = (static_cast<int64_t>(B) + 31) / 32;
    const int blocks =
        static_cast<int>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
    count_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(g1_keys),
        static_cast<const int32_t*>(g1_next),
        static_cast<const int32_t*>(g1_boff),
        static_cast<const int32_t*>(g1_bcnt),
        static_cast<const uint32_t*>(g2_keys),
        static_cast<const int32_t*>(g2_next),
        static_cast<const int32_t*>(start), static_cast<const int32_t*>(us),
        static_cast<int32_t*>(out), S1, V1, S2, B);
  }
  return static_cast<int>(cudaGetLastError());
}

int probe_hits(const void* ws, const void* rows, const void* keys, void* out,
               int Q, int C, int S, void* stream) {
  if (Q > 0) {
    const int blocks = (Q + kWarpsPerBlock - 1) / kWarpsPerBlock;
    probe_hits_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(ws), static_cast<const int32_t*>(rows),
        static_cast<const uint32_t*>(keys), static_cast<uint8_t*>(out), Q, C,
        S);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* slab_intersect_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

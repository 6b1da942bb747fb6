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
// Packed rows.  Every engine path keeps a row's keys a prefix (live and
// TOMBSTONE lanes first, every lane after the first EMPTY lane EMPTY), and
// only a chain's tail row holds an EMPTY lane.  So a row ends at its first
// EMPTY lane, and in practice so does its chain; the kernel still follows
// next_slab from a row that ended early, so it computes what the plain
// version computes on any packed pool.
//
// Count.  A work item is an (edge u-v, bucket of v) pair: its head slab in
// G2 (-1 = inactive) and u.  The item's count is the number of valid lanes
// w along that chain for which (u, w) is in G1.  The callers pass only the
// active items (ops._work_items lists the active slots of the reference's
// dense (edge, bucket) layout, in order), and one warp takes one item.  It
// reads v's G2 chain 32 lanes (128 B, coalesced) at a time, up to each
// row's first EMPTY lane; the valid lanes of a step are the candidates.
// Each thread takes a candidate w and hash-probes it into u's bucket chain
// in G1 (bucket_offset[u] + ((w * 2654435761 mod 2^32) >> 8) %
// bucket_count[u]), reading the bucket's row 16 lanes a step (four uint4
// loads in flight, 64 B) until a hit, or to the row's end (its first EMPTY
// lane, or lane 127) and on along next_slab.  A thread that finishes takes
// the next candidate at once, and the warp reads the next G2 step as soon
// as the current step's candidates are all taken, so 32 probes stay in
// flight a warp.
//
// Bound.  The work is the compares over the filled lanes of each
// (candidate, G1 row) visit up to where the probe stops, and the bytes are
// the filled sectors of each distinct row read once; both take far less
// time than the probes' dependent loads, served from L1 and L2.  So what
// holds the kernel is latency: how many probes are in flight and how many
// round trips each takes.  The static count's candidates are the sum of
// deg(v) over the edges (7.0e10 on the serve's RMAT graph), three quarters
// of them probing a u of several buckets whose rows hold ~90 keys.  A probe
// a thread keeps 32 probes in flight a warp; probes by groups of 4 or 8
// threads reading a row in coalesced steps keep 8 or 4 and took longer,
// and so did steps of one, two or eight uint4 a thread
// (tools/slab_variants.py).  A probe of a single-bucket u reads the row
// every other candidate of the item reads, from L1.
// Imbalance left: a warp's time is its item's candidates (at most a G2
// chain's filled lanes: ~90 a bucket of a hashed hub); an unhashed hub's
// long G2 chain is still one warp's work.
//
// Guards: a walk stops at a row outside its pool or after as many hops as
// the pool has rows, so a corrupt chain cannot hang the card.
//
// Membership probe.  One warp per query walks the query's C candidate rows
// (-1 skipped): each thread compares one uint4 of the row with w and one
// __ballot_sync says whether any lane holds it; the walk stops at the first
// hit.  Bound: bytes, one 512 B row per candidate row read.  After an L2
// flush it is latency: the launch and the id load, then one row round trip
// for a query whose later ids are -1.  Issuing every row of a query before
// one ballot, with several queries a warp, ran no faster on the triangle
// phase's call, whose thousands of warps overlap their round trips anyway
// (tools/slab_variants.py --kernels hits, variant ``grouped``).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlabWidth = 128;
constexpr int kWarpsPerBlock = 8;
constexpr int kProbeGroup = 1;     // threads a probe
constexpr int kProbeQuads = 4;     // uint4 loads a probe thread issues a step
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kKnuth = 2654435761u;
constexpr uint32_t kEmpty = 0xFFFFFFFEu;
constexpr uint32_t kTombstone = 0xFFFFFFFDu;

__device__ __forceinline__ uint4 row_quad(const uint32_t* __restrict__ keys,
                                          int row, int t) {
  return reinterpret_cast<const uint4*>(
      keys + static_cast<size_t>(row) * kSlabWidth)[t];
}

__device__ __forceinline__ bool quad_has(const uint4& v, uint32_t w) {
  return (v.x == w) | (v.y == w) | (v.z == w) | (v.w == w);
}

// Position of the (n + 1)-th set bit of m (n < popc(m)).
__device__ __forceinline__ int nth_set(unsigned m, int n) {
  int pos = 0;
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1)
    if (__popc(m & ((1u << (pos + sh)) - 1)) <= n) pos += sh;
  return pos;
}

// One warp counts one item's hits with probes of T threads each; returns
// this thread's share (each probe's first thread counts the probe's hits).
template <int T, int Q>
__device__ __forceinline__ int count_item(
    const uint32_t* __restrict__ g1_keys, const int32_t* __restrict__ g1_next,
    const uint32_t* __restrict__ g2_keys, const int32_t* __restrict__ g2_next,
    int row2, int boff, int bcnt, int S1, int S2) {
  constexpr int kStep = 4 * T * Q;               // G1 lanes a probe step
  constexpr int kRowSteps = kSlabWidth / kStep;
  const int t = threadIdx.x & 31;
  const int j = t % T;
  const int lead = t - j;
  const unsigned gmask = (T == 32 ? kFull : (1u << (T % 32)) - 1) << lead;

  // the G2 walk: warp-uniform
  int q2 = 0, hops2 = 0;
  unsigned cand = 0;   // candidate lanes of the current G2 step not yet taken
  uint32_t w = 0;      // this lane's key of the current G2 step
  // the probe: uniform within its T threads; pc = -1 when idle
  uint32_t pw = 0;
  int pc = -1, q = 0, hops = 0;
  int found = 0;
  while (true) {
    const bool more2 =
        static_cast<unsigned>(row2) < static_cast<unsigned>(S2) &&
        hops2 < S2;
    if (cand == 0 && more2) {
      w = g2_keys[static_cast<size_t>(row2) * kSlabWidth + q2 * 32 + t];
      cand = __ballot_sync(kFull, w < kTombstone);
      // a step with an EMPTY lane ends the row (it is packed)
      if (__ballot_sync(kFull, w == kEmpty) != 0 ||
          q2 == kSlabWidth / 32 - 1) {
        row2 = g2_next[row2];
        q2 = 0;
        ++hops2;
      } else {
        ++q2;
      }
    }
    // idle probes take the lowest candidates, in lane order
    const unsigned idle = __ballot_sync(kFull, pc < 0 && j == 0);
    if (cand != 0 && idle != 0) {
      const int n = __popc(cand);
      const int rank = __popc(idle & ((1u << lead) - 1));
      const bool take = pc < 0 && rank < n;
      const uint32_t cw =
          __shfl_sync(kFull, w, take ? nth_set(cand, rank) : 0);
      if (take) {
        pw = cw;
        pc = boff + static_cast<int>(((cw * kKnuth) >> 8) %
                                     static_cast<uint32_t>(bcnt));
        if (static_cast<unsigned>(pc) >= static_cast<unsigned>(S1)) pc = -1;
        q = 0;
        hops = 0;
      }
      const int took = min(n, __popc(idle));
      cand = took == n ? 0u : cand & ~((1u << nth_set(cand, took)) - 1);
    }
    if (__ballot_sync(kFull, pc >= 0) == 0) {
      if (cand == 0 && !(static_cast<unsigned>(row2) <
                             static_cast<unsigned>(S2) && hops2 < S2))
        break;
      continue;
    }
    // one step of every busy probe: its T threads read 4TQ lanes of its row
    bool hit = false, empty = false;
    if (pc >= 0) {
      const uint4* r = reinterpret_cast<const uint4*>(
          g1_keys + static_cast<size_t>(pc) * kSlabWidth + q * kStep) + j;
      uint4 kv[Q];
#pragma unroll
      for (int k = 0; k < Q; ++k) kv[k] = r[k * T];
#pragma unroll
      for (int k = 0; k < Q; ++k) {
        hit |= quad_has(kv[k], pw);
        empty |= quad_has(kv[k], kEmpty);
      }
    }
    if constexpr (T > 1) {
      hit = (__ballot_sync(kFull, hit) & gmask) != 0;
      empty = (__ballot_sync(kFull, empty) & gmask) != 0;
    }
    if (pc >= 0) {
      if (hit) {
        found += j == 0;
        pc = -1;
      } else if (empty || q == kRowSteps - 1) {
        const int nx = g1_next[pc];
        ++hops;
        pc = static_cast<unsigned>(nx) < static_cast<unsigned>(S1) &&
                     hops < S1 ? nx : -1;
        q = 0;
      } else {
        ++q;
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
  const int64_t item =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (item >= B) return;  // uniform per warp
  const int u = us[item];
  int boff = 0, bcnt = 0;
  if (static_cast<unsigned>(u) < static_cast<unsigned>(V1)) {
    boff = g1_boff[u];
    bcnt = g1_bcnt[u];
  }
  int found = 0;
  if (bcnt > 0)
    found = count_item<kProbeGroup, kProbeQuads>(
        g1_keys, g1_next, g2_keys, g2_next, start[item], boff, bcnt, S1,
        S2);
  found = __reduce_add_sync(kFull, found);
  if ((threadIdx.x & 31) == 0) out[item] = found;
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
    const int blocks = static_cast<int>(
        (static_cast<int64_t>(B) + kWarpsPerBlock - 1) / kWarpsPerBlock);
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

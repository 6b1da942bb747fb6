// Slab-update kernels for Hopper (sm_90a): the chain-walk probe and the
// fused commit of the batched insert/delete engine.
//
// Replaces the TPU kernels of repro/kernels/slab_update/kernel.py:
//   slab_probe  <- slab_probe_pallas  / _probe_kernel  (kernel.py:81, :40)
//   slab_commit <- slab_commit_pallas / _commit_kernel (kernel.py:160, :122)
//
// Keys are 32-bit words: the port stores them as int32 bit patterns of the
// reference's uint32 keys, and both kernels read them as uint32_t.
//
// Probe.  One warp per query walks the query's chain from its head row and
// stops at the first row holding the key.  A slab row is 128 keys = 512
// bytes, so each of the 32 threads loads one uint4 (four lanes) of a row and
// one __ballot_sync says which threads hold the key; the first hit lane is
// the lowest thread with a hit, then the first of its four lanes
// (jnp.argmax's choice in the reference).
//
// A chain is a linked list, so walking it row by row costs one dependent
// round trip to memory per row.  Two things shorten that.  The row and the
// chain pointers are loaded together: at row cur the warp loads the row and,
// coalesced in one 128 B line, next_slab[cur .. cur+31].  And a chain that
// runs through consecutive rows is read kRunRows rows a step: one ballot of
// next_slab[cur+i] == cur+i+1 over that window gives the run of rows that
// are proven to be on the chain, in chain order (bulk builds and compaction
// lay every bucket's overflow slabs out consecutively, so a hub's chain is a
// few such runs), and the warp then loads those rows with all their uint4
// loads in flight and takes the first row in chain order that holds a hit.
// The next row after the window is a pointer the window already holds.  A
// row is read only where next_slab proves that the chain reaches it, so the
// result is the first hit along the chain on any pool, laid out
// consecutively or not.
//
// The walk ends on a hit, at -1, at a row outside the pool, or after S rows,
// so a corrupt (cyclic) chain cannot hang the card.  Bound: bytes (the rows
// the walks must read), but the kernel lasts as long as its longest walk:
// ~1 + ceil(31 / kRunRows) round trips per 32 consecutive rows, and one per
// row where the links are not consecutive (the head's link to its first
// overflow slab, slabs the update engine appended).  Weakness: on a pool
// whose chains are scattered (after long churn with no compaction) the walk
// is one round trip per row again, half of what it was, but serial.
//
// Commit.  Store the planned key (and weight) at (slab, lane) when slab < S,
// and add the degree delta when idx < V.  The engine plans distinct
// (slab, lane) targets (placement is unique and deletes are dup-collapsed),
// so the stores never race, and integer adds give the same degrees in any
// order: the result is bit-identical to the serial TPU loop.  Bound: bytes
// (a scatter of B words plus an add a vertex), but a plan of 16,384-65,536
// entries is far below what the card needs to reach it: the time is the
// launch, one round trip and the drain of the stores and atomics, and an
// all-parked plan, which stores and adds nothing, takes nearly as long.
// So a thread takes one entry: more entries a thread, or a grid the card
// holds at once striding over B, were no faster on the serve's plans and
// slower on an all-parked one (tools/slab_variants.py --kernels commit).
// The engine sorts a plan by bucket, so a vertex's deltas come in runs
// broken only by parked entries; a segmented scan of shuffles sums each run
// over the warp's threads, and the run's last thread issues a single
// atomicAdd.  A run split by a parked entry or a warp's edge issues one add
// for each part, which is exact; what the design saves rests on the runs
// (tests/test_torch_slab_layout.py checks the engine's plans), not what it
// computes, and on the serve's short runs it measured no gain over an
// atomic a live entry.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlabWidth = 128;
constexpr int kWarpsPerBlock = 8;
// rows of a proven run a warp loads per step, all in flight at once
constexpr int kRunRows = 8;
constexpr int kCommitThreads = 128;

// The four lanes a thread holds that equal d, as bits 0..3.
__device__ __forceinline__ int lanes_equal(const uint4 v, uint32_t d) {
  return (v.x == d) | ((v.y == d) << 1) | ((v.z == d) << 2) |
         ((v.w == d) << 3);
}

// Whether the row whose uint4 this thread holds has the key; if so, its
// first hit lane.  Called by the whole warp.
__device__ __forceinline__ bool row_hit(const uint4 v, uint32_t d, int& lane) {
  const int m = lanes_equal(v, d);
  const unsigned hits = __ballot_sync(0xffffffffu, m != 0);
  if (!hits) return false;
  const int th = __ffs(hits) - 1;
  lane = th * 4 + __ffs(__shfl_sync(0xffffffffu, m, th)) - 1;
  return true;
}

__global__ void probe_kernel(const uint32_t* __restrict__ keys,
                             const int32_t* __restrict__ next_slab,
                             const int32_t* __restrict__ start,
                             const uint32_t* __restrict__ dst,
                             uint8_t* __restrict__ found,
                             int32_t* __restrict__ slab_out,
                             int32_t* __restrict__ lane_out, int S, int B) {
  const int q = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int t = threadIdx.x & 31;
  if (q >= B) return;  // uniform per warp: q is the same for all 32 threads
  const uint4* rows = reinterpret_cast<const uint4*>(keys);
  const uint32_t d = dst[q];
  int cur = start[q];
  int left = S;  // rows the walk may still read
  int s = -1, l = -1;
  while (static_cast<unsigned>(cur) < static_cast<unsigned>(S) && left > 0) {
    // the row and the window of its successors' pointers, in one round trip
    const uint4 v = rows[static_cast<size_t>(cur) * 32 + t];
    const int w = cur + t;
    const int nw = w < S ? next_slab[w] : -1;
    if (row_hit(v, d, l)) {
      s = cur;
      break;
    }
    // rows cur+1 .. cur+run are on the chain: every link up to them is
    // w -> w + 1 inside the pool
    const unsigned linked =
        __ballot_sync(0xffffffffu, nw == w + 1 && w + 1 < S);
    const int run = min(linked == 0xffffffffu ? 31 : __ffs(~linked) - 1,
                        left - 1);
    for (int j = 1; j <= run && s < 0; j += kRunRows) {
      uint4 r[kRunRows];
#pragma unroll
      for (int k = 0; k < kRunRows; ++k)
        if (j + k <= run)
          r[k] = rows[static_cast<size_t>(cur + j + k) * 32 + t];
#pragma unroll
      for (int k = 0; k < kRunRows; ++k)
        if (s < 0 && j + k <= run && row_hit(r[k], d, l)) s = cur + j + k;
    }
    if (s >= 0) break;
    left -= run + 1;
    cur = __shfl_sync(0xffffffffu, nw, run);
  }
  if (t == 0) {
    found[q] = static_cast<uint8_t>(s >= 0);
    slab_out[q] = s;
    lane_out[q] = l;
  }
}

__device__ __forceinline__ void add_degree(int32_t* degree, int key, int sum) {
  if (key >= 0 && sum != 0) atomicAdd(degree + key, sum);
}

__global__ void __launch_bounds__(kCommitThreads)
    commit_kernel(uint32_t* __restrict__ keys, int32_t* __restrict__ degree,
                  float* __restrict__ weights,
                  const int32_t* __restrict__ e_slab,
                  const int32_t* __restrict__ e_lane,
                  const uint32_t* __restrict__ vals,
                  const int32_t* __restrict__ deg_idx,
                  const int32_t* __restrict__ deg_delta,
                  const float* __restrict__ wvals, int S, int V, int B) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  // whole warps stay, so every lane takes the shuffles
  if (i - lane >= B) return;
  // every load of the entry at once, before its stores: one round trip
  int s = -1, ln = 0, key = -1, sum = 0;
  uint32_t val = 0;
  float wv = 0.0f;
  if (i < B) {
    s = __ldg(e_slab + i);
    ln = __ldg(e_lane + i);
    val = __ldg(vals + i);
    key = __ldg(deg_idx + i);
    sum = __ldg(deg_delta + i);
    if (wvals != nullptr) wv = __ldg(wvals + i);
  }
  if (static_cast<unsigned>(s) < static_cast<unsigned>(S)) {
    const size_t at = static_cast<size_t>(s) * kSlabWidth + ln;
    keys[at] = val;
    if (weights != nullptr) weights[at] = wv;
  }
  // parked (outside [0, V)) is -1, which adds nothing
  if (static_cast<unsigned>(key) >= static_cast<unsigned>(V)) key = -1;
  // segmented inclusive scan of the deltas over the warp's runs of one key
  const int prev = __shfl_up_sync(0xffffffffu, key, 1);  // all lanes
  bool starts = lane == 0 || prev != key;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, sum, off);
    const int up_starts =
        __shfl_up_sync(0xffffffffu, static_cast<int>(starts), off);
    if (lane >= off) {
      if (!starts) sum += up;
      starts = starts || up_starts != 0;
    }
  }
  // the run's last lane in the warp adds it
  const int next = __shfl_down_sync(0xffffffffu, key, 1);
  if (lane == 31 || next != key) add_degree(degree, key, sum);
}

}  // namespace

extern "C" {

int slab_probe(const void* keys, const void* next_slab, const void* start,
               const void* dst, void* found, void* slab, void* lane, int S,
               int B, void* stream) {
  if (B > 0) {
    const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
    probe_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(keys),
        static_cast<const int32_t*>(next_slab),
        static_cast<const int32_t*>(start), static_cast<const uint32_t*>(dst),
        static_cast<uint8_t*>(found), static_cast<int32_t*>(slab),
        static_cast<int32_t*>(lane), S, B);
  }
  return static_cast<int>(cudaGetLastError());
}

int slab_commit(void* keys, void* degree, void* weights, const void* e_slab,
                const void* e_lane, const void* vals, const void* deg_idx,
                const void* deg_delta, const void* wvals, int S, int V, int B,
                void* stream) {
  if (B > 0) {
    commit_kernel<<<(B + kCommitThreads - 1) / kCommitThreads, kCommitThreads,
                    0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint32_t*>(keys), static_cast<int32_t*>(degree),
        static_cast<float*>(weights), static_cast<const int32_t*>(e_slab),
        static_cast<const int32_t*>(e_lane),
        static_cast<const uint32_t*>(vals),
        static_cast<const int32_t*>(deg_idx),
        static_cast<const int32_t*>(deg_delta),
        static_cast<const float*>(wvals), S, V, B);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* slab_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

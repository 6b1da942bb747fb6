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
// Probe.  One warp per query.  A slab row is 128 keys = 512 bytes, so each
// of the 32 threads loads one uint4 (four lanes) and one __ballot_sync says
// which threads hold the key.  The first hit lane is the lowest thread with
// a hit, then the first of its four lanes, which is jnp.argmax's choice in
// the reference.  Lane 0 reads next_slab and broadcasts it; the walk ends
// on a hit or at -1.  Bound: bytes.  Every hop reads one 512 B row that is
// scattered across the pool, so the probe is bound by dependent memory
// latency per warp and by DRAM sectors overall; many warps in flight (8 per
// block, one block per 8 queries) hide the latency.  Weakness: with hashing
// off a hub's chain is long and its warp walks it serially while the
// others finish early (splitting long chains across warps would fix that).
//
// Commit.  One thread per batch lane: store the planned key (and weight) at
// (slab, lane) when slab < S, and atomicAdd the degree delta when idx < V.
// The engine plans distinct (slab, lane) targets (placement is unique and
// deletes are dup-collapsed), so the stores never race, and integer atomics
// give the same degrees in any order: the result is bit-identical to the
// serial TPU loop.  Bound: bytes (a scatter of B words plus B atomics).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlabWidth = 128;
constexpr int kWarpsPerBlock = 8;

__global__ void probe_kernel(const uint32_t* __restrict__ keys,
                             const int32_t* __restrict__ next_slab,
                             const int32_t* __restrict__ start,
                             const uint32_t* __restrict__ dst,
                             uint8_t* __restrict__ found,
                             int32_t* __restrict__ slab_out,
                             int32_t* __restrict__ lane_out, int B) {
  const int q = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int t = threadIdx.x & 31;
  if (q >= B) return;  // uniform per warp: q is the same for all 32 threads
  int cur = start[q];
  const uint32_t d = dst[q];
  int f = 0, s = -1, l = -1;
  while (cur != -1) {
    const uint4 v = reinterpret_cast<const uint4*>(
        keys + static_cast<size_t>(cur) * kSlabWidth)[t];
    const int m = (v.x == d) | ((v.y == d) << 1) | ((v.z == d) << 2) |
                  ((v.w == d) << 3);
    const unsigned hits = __ballot_sync(0xffffffffu, m != 0);
    if (hits) {
      const int th = __ffs(hits) - 1;
      const int mm = __shfl_sync(0xffffffffu, m, th);
      f = 1;
      s = cur;
      l = th * 4 + (__ffs(mm) - 1);
      break;
    }
    int nxt = 0;
    if (t == 0) nxt = next_slab[cur];
    cur = __shfl_sync(0xffffffffu, nxt, 0);
  }
  if (t == 0) {
    found[q] = static_cast<uint8_t>(f);
    slab_out[q] = s;
    lane_out[q] = l;
  }
}

__global__ void commit_kernel(uint32_t* __restrict__ keys,
                              int32_t* __restrict__ degree,
                              float* __restrict__ weights,
                              const int32_t* __restrict__ e_slab,
                              const int32_t* __restrict__ e_lane,
                              const uint32_t* __restrict__ vals,
                              const int32_t* __restrict__ deg_idx,
                              const int32_t* __restrict__ deg_delta,
                              const float* __restrict__ wvals, int S, int V,
                              int B) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int s = e_slab[i];
  if (static_cast<unsigned>(s) < static_cast<unsigned>(S)) {
    const size_t at = static_cast<size_t>(s) * kSlabWidth + e_lane[i];
    keys[at] = vals[i];
    if (weights != nullptr) weights[at] = wvals != nullptr ? wvals[i] : 0.0f;
  }
  const int di = deg_idx[i];
  if (static_cast<unsigned>(di) < static_cast<unsigned>(V))
    atomicAdd(degree + di, deg_delta[i]);
}

}  // namespace

extern "C" {

int slab_probe(const void* keys, const void* next_slab, const void* start,
               const void* dst, void* found, void* slab, void* lane, int B,
               void* stream) {
  if (B > 0) {
    const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
    probe_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(keys),
        static_cast<const int32_t*>(next_slab),
        static_cast<const int32_t*>(start), static_cast<const uint32_t*>(dst),
        static_cast<uint8_t*>(found), static_cast<int32_t*>(slab),
        static_cast<int32_t*>(lane), B);
  }
  return static_cast<int>(cudaGetLastError());
}

int slab_commit(void* keys, void* degree, void* weights, const void* e_slab,
                const void* e_lane, const void* vals, const void* deg_idx,
                const void* deg_delta, const void* wvals, int S, int V, int B,
                void* stream) {
  if (B > 0) {
    const int threads = 256;
    commit_kernel<<<(B + threads - 1) / threads, threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
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

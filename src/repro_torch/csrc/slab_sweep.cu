// Semiring slab sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel slab_sweep_pallas / _sweep_kernel of
// repro/kernels/slab_sweep/kernel.py (:80, :34).  Its sum semiring with no
// frontier, slab_contrib_sums_pallas (repro/kernels/slab_pagerank/
// kernel.py:23), has a kernel of its own that reads every lane
// (slab_pagerank.cu).
//
// For every slab row: gather values[key] at each of the 128 lanes, drop
// lanes whose key is not a vertex (key >= n as uint32: EMPTY/TOMBSTONE
// sentinels), rows with a negative owner (unallocated slabs) and lanes whose
// key is outside the frontier, combine under the semiring and reduce the
// lanes to one partial per row.
//
//   sum          values[key] (* weight)              reduce +
//   min          values[key]                          reduce min
//   min_plus     values[key] + weight (1 unweighted)  reduce min
//   arg_min_plus key where values[key] + w <= target  reduce min (int32)
//
// The rows are packed (the pool's invariant, kept by every engine path:
// build, insert, delete, compaction and reclamation): a row's keys form a
// prefix, live and TOMBSTONE lanes first, and every lane after the first
// EMPTY lane is EMPTY.  So a row ends at its first EMPTY lane.
//
// Design.  A group of kGroup = 4 threads takes one row, eight rows a warp,
// eight warps a block.  The owner (and target) is one load per group, and a
// row with no owner (an unallocated slab) reads nothing more and writes the
// identity.  Otherwise the group reads the row in steps of 16 lanes: each
// thread one uint4 of keys (and, when weighted, one float4 of weights), so a
// step is one coalesced 64 B segment of the row.  A group stops after the
// first step that holds an EMPTY key, found by a ballot masked to the group,
// so a row of k keys costs floor(k / 16) + 1 steps (eight at most), not the
// whole 512 B.  The lane reduction is a __shfl_xor_sync butterfly within the
// group.  The min family is exact whatever the order.  The sum adds in
// another order than XLA's lane reduction, so float sums agree with the
// reference to rounding only (a few ulp of the row total).  Groups of 1, 2,
// 8, 16 and 32 threads were timed beside 4 on the serve's pool
// (tools/slab_variants.py): 4 was the fastest for the sum and as fast as 2
// for the frontier's min_plus.
//
// Bound: bytes.  What the inputs need is 4 B of key (and 4 B of weight) per
// filled lane, 4 B of owner and 4 B of output per row, values[] and
// frontier[] once, gathered at random; a vector of V floats fits in the
// 50 MB L2 up to ~12M vertices, so the gathers are served mostly from L2.
// At the serve's fill (16M keys in 1.1M allocated rows of 2.1M) a row holds
// ~15 keys, so the 64 B steps read about 1.5 times the filled lanes' bytes;
// what holds the kernel is latency: the owner load, the key steps and the
// value gathers are dependent round trips to memory for every row.

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kSlabWidth = 128;
constexpr int kGroup = 4;                        // threads per row
constexpr int kRowsPerWarp = 32 / kGroup;
constexpr int kWarpsPerBlock = 8;
constexpr int kRowsPerBlock = kWarpsPerBlock * kRowsPerWarp;
constexpr int kSteps = kSlabWidth / (4 * kGroup);  // steps of a full row
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kEmpty = 0xFFFFFFFEu;

enum Semiring { kSum = 0, kMin = 1, kMinPlus = 2, kArgMinPlus = 3 };

template <typename T>
__device__ __forceinline__ T max_value();
template <>
__device__ __forceinline__ float max_value<float>() { return FLT_MAX; }
template <>
__device__ __forceinline__ int32_t max_value<int32_t>() { return INT_MAX; }

template <typename T, int SEMI>
struct Acc {
  using type = typename std::conditional<SEMI == kArgMinPlus, int32_t, T>::type;
};

template <typename T, int SEMI, bool HAS_W, bool HAS_F>
__global__ void sweep_kernel(const uint32_t* __restrict__ keys,
                             const int32_t* __restrict__ owner,
                             const T* __restrict__ values,
                             const float* __restrict__ weights,
                             const uint8_t* __restrict__ frontier,
                             const T* __restrict__ target,
                             typename Acc<T, SEMI>::type* __restrict__ out,
                             int S, uint32_t n) {
  using A = typename Acc<T, SEMI>::type;
  const int t = threadIdx.x & 31;
  const int j = t % kGroup;                      // thread within the group
  const unsigned gmask =
      (kGroup == 32 ? kFull : (1u << (kGroup % 32)) - 1) << (t - j);
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x / kGroup);

  A acc = (SEMI == kSum) ? A(0) : max_value<A>();
  // an unallocated row has every lane masked: its partial is the identity,
  // and its keys (and target) are never read
  bool open = row < S && owner[row] >= 0;
  T tgt{};
  if constexpr (SEMI == kArgMinPlus) {
    if (open) tgt = target[row];
  }
  const size_t base = static_cast<size_t>(open ? row : 0) * kSlabWidth;
  const uint4* k4 = reinterpret_cast<const uint4*>(keys + base) + j;
  const float4* w4 =
      HAS_W ? reinterpret_cast<const float4*>(weights + base) + j : nullptr;

  for (int s = 0; s < kSteps; ++s) {
    if (!__any_sync(kFull, open)) break;
    bool empty = false;
    if (open) {
      const uint4 kv = k4[s * kGroup];
      const uint32_t kk[4] = {kv.x, kv.y, kv.z, kv.w};
      float ww[4] = {1.0f, 1.0f, 1.0f, 1.0f};
      if constexpr (HAS_W) {
        const float4 wv = w4[s * kGroup];
        ww[0] = wv.x; ww[1] = wv.y; ww[2] = wv.z; ww[3] = wv.w;
      }
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const uint32_t key = kk[l];
        empty |= key == kEmpty;
        bool valid = key < n;
        if constexpr (HAS_F) valid = valid && frontier[key] != 0;
        if (!valid) continue;
        const T v = values[key];
        if constexpr (SEMI == kSum) {
          if constexpr (HAS_W)
            acc = __fadd_rn(acc, __fmul_rn(v, ww[l]));
          else
            acc += v;
        } else if constexpr (SEMI == kMin) {
          acc = v < acc ? v : acc;
        } else {
          T cand;
          if constexpr (HAS_W)
            cand = __fadd_rn(v, ww[l]);
          else
            cand = v + T(1);
          if constexpr (SEMI == kMinPlus) {
            acc = cand < acc ? cand : acc;
          } else {
            const int32_t kid = static_cast<int32_t>(key);
            if (cand <= tgt && kid < acc) acc = kid;
          }
        }
      }
    }
    // the row is packed: past a step with an EMPTY lane every lane is EMPTY
    if (__ballot_sync(kFull, empty) & gmask) open = false;
  }
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1) {
    const A o = __shfl_xor_sync(kFull, acc, off);
    if constexpr (SEMI == kSum)
      acc += o;
    else
      acc = o < acc ? o : acc;
  }
  if (j == 0 && row < S) out[row] = acc;
}

template <typename T, int SEMI>
void launch_semi(const void* keys, const void* owner, const void* values,
                 const void* weights, const void* frontier,
                 const void* target, void* out, int S, uint32_t n,
                 cudaStream_t stream) {
  using A = typename Acc<T, SEMI>::type;
  const int blocks = (S + kRowsPerBlock - 1) / kRowsPerBlock;
  const int threads = kWarpsPerBlock * 32;
  const auto* k = static_cast<const uint32_t*>(keys);
  const auto* o = static_cast<const int32_t*>(owner);
  const auto* v = static_cast<const T*>(values);
  const auto* w = static_cast<const float*>(weights);
  const auto* f = static_cast<const uint8_t*>(frontier);
  const auto* tg = static_cast<const T*>(target);
  auto* out_p = static_cast<A*>(out);
  // weights ride only with float values (the wrapper refuses int values
  // with weights), so the weighted variants exist for float alone
  if constexpr (std::is_same<T, float>::value) {
    if (w != nullptr) {
      if (f != nullptr)
        sweep_kernel<T, SEMI, true, true><<<blocks, threads, 0, stream>>>(
            k, o, v, w, f, tg, out_p, S, n);
      else
        sweep_kernel<T, SEMI, true, false><<<blocks, threads, 0, stream>>>(
            k, o, v, w, f, tg, out_p, S, n);
      return;
    }
  }
  if (f != nullptr)
    sweep_kernel<T, SEMI, false, true><<<blocks, threads, 0, stream>>>(
        k, o, v, nullptr, f, tg, out_p, S, n);
  else
    sweep_kernel<T, SEMI, false, false><<<blocks, threads, 0, stream>>>(
        k, o, v, nullptr, f, tg, out_p, S, n);
}

template <typename T>
int launch_typed(int semiring, const void* keys, const void* owner,
                 const void* values, const void* weights,
                 const void* frontier, const void* target, void* out, int S,
                 uint32_t n, cudaStream_t stream) {
  switch (semiring) {
    case kSum:
      launch_semi<T, kSum>(keys, owner, values, weights, frontier, target,
                           out, S, n, stream);
      return 0;
    case kMin:
      launch_semi<T, kMin>(keys, owner, values, weights, frontier, target,
                           out, S, n, stream);
      return 0;
    case kMinPlus:
      launch_semi<T, kMinPlus>(keys, owner, values, weights, frontier,
                               target, out, S, n, stream);
      return 0;
    case kArgMinPlus:
      launch_semi<T, kArgMinPlus>(keys, owner, values, weights, frontier,
                                  target, out, S, n, stream);
      return 0;
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// value_kind: 0 = float32 values, 1 = int32 values.  weights, frontier and
// target may be null (target is read only by arg_min_plus).  Returns
// cudaGetLastError() after the launch, or -1 for an unknown semiring/kind.
int slab_sweep(int semiring, int value_kind, const void* keys,
               const void* owner, const void* values, const void* weights,
               const void* frontier, const void* target, void* out, int S,
               unsigned int n, void* stream) {
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  int rc;
  if (value_kind == 0)
    rc = launch_typed<float>(semiring, keys, owner, values, weights,
                             frontier, target, out, S, n, s);
  else if (value_kind == 1)
    rc = launch_typed<int32_t>(semiring, keys, owner, values, nullptr,
                               frontier, target, out, S, n, s);
  else
    rc = -1;
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* slab_sweep_error_string(int code) {
  return code < 0 ? "unknown semiring or value kind"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

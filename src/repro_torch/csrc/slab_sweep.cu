// Semiring slab sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel slab_sweep_pallas / _sweep_kernel of
// repro/kernels/slab_sweep/kernel.py (:80, :34), and through it
// slab_contrib_sums_pallas (repro/kernels/slab_pagerank/kernel.py:23),
// which is its sum semiring with no frontier.
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
// Design.  One warp per row, eight rows per block.  Each thread loads one
// uint4 of keys (four lanes) and, when weighted, one float4 of weights, so a
// warp reads its 512 B row in one coalesced pass; the owner (and target) is
// one broadcast load, and a row with no owner (an unallocated slab) reads
// nothing more and writes the identity.  The lane reduction is a
// __shfl_xor_sync butterfly.
// The min family is exact whatever the order.  The sum adds in another
// order than XLA's lane reduction, so float sums agree with the reference
// to rounding only (a few ulp of the row total).
//
// Bound: bytes.  The allocated rows are streamed once (512 B of keys per
// row, 512 B more when weighted), every row costs 4 B of owner and 4 B of
// output, and values[] (and frontier[]) are gathered at random;
// a vector of V floats fits in the 50 MB L2 up to ~12M vertices, so the
// gathers are served mostly from L2 and the pool stream sets the time.

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kSlabWidth = 128;
constexpr int kWarpsPerBlock = 8;

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
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int t = threadIdx.x & 31;
  if (row >= S) return;  // uniform per warp

  A acc = (SEMI == kSum) ? A(0) : max_value<A>();
  // an unallocated row has every lane masked: its partial is the identity,
  // and its keys (and target) are never read
  if (owner[row] < 0) {  // uniform per warp
    if (t == 0) out[row] = acc;
    return;
  }

  const size_t base = static_cast<size_t>(row) * kSlabWidth;
  const uint4 k4 = reinterpret_cast<const uint4*>(keys + base)[t];
  const uint32_t kk[4] = {k4.x, k4.y, k4.z, k4.w};
  float ww[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  if constexpr (HAS_W) {
    const float4 w4 = reinterpret_cast<const float4*>(weights + base)[t];
    ww[0] = w4.x; ww[1] = w4.y; ww[2] = w4.z; ww[3] = w4.w;
  }
  T tgt{};
  if constexpr (SEMI == kArgMinPlus) tgt = target[row];

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t key = kk[j];
    bool valid = key < n;
    if constexpr (HAS_F) valid = valid && frontier[key] != 0;
    if (!valid) continue;
    const T v = values[key];
    if constexpr (SEMI == kSum) {
      if constexpr (HAS_W)
        acc = __fadd_rn(acc, __fmul_rn(v, ww[j]));
      else
        acc += v;
    } else if constexpr (SEMI == kMin) {
      acc = v < acc ? v : acc;
    } else {
      T cand;
      if constexpr (HAS_W)
        cand = __fadd_rn(v, ww[j]);
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
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const A o = __shfl_xor_sync(0xffffffffu, acc, off);
    if constexpr (SEMI == kSum)
      acc += o;
    else
      acc = o < acc ? o : acc;
  }
  if (t == 0) out[row] = acc;
}

template <typename T, int SEMI>
void launch_semi(const void* keys, const void* owner, const void* values,
                 const void* weights, const void* frontier,
                 const void* target, void* out, int S, uint32_t n,
                 cudaStream_t stream) {
  using A = typename Acc<T, SEMI>::type;
  const int blocks = (S + kWarpsPerBlock - 1) / kWarpsPerBlock;
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

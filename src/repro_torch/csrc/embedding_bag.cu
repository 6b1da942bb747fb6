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
// Bound on this card: bytes.  Each slot's 8 bytes, each distinct row the
// bags touch once, and the output.  A row shared by many bags is re-read
// from L2: at MIND's batch of 65,536 the bags gather 1,677,119 rows, ~8.5
// times the distinct rows' bytes.  What held the first design (a warp a
// bag, one slot at a time) was one dependent round trip a slot, so this one
// keeps a bag's loads in flight and the card full:
//
// * A warp takes a bag (or a share of one, below).  It reads kStage slots at
//   once, an index and a weight a lane, ballots the non-pad ones and packs
//   them into shared memory, so pads cost no row load.
// * Each lane loads VEC elements of a row with one 16-byte load (4 float32,
//   8 bfloat16): a row of D is G = D / VEC lanes, rounded up to a power of
//   two, so one warp instruction loads the rows of 32 / G slots (2 float32
//   or 4 bfloat16 slots at D = 64).  The loop over the packed slots loads
//   kRowsInFlight rows, with their weights, before the first FMA.  Rows
//   wider than 32 vectors are read in chunks of 32.
// * The groups of G lanes add their partial sums with shuffles once, after
//   the bag's last slot.
// * The grid is what the card holds at once, and each warp walks its bags
//   in turn, loading the next step's indices and weights before this step's
//   rows, so no block waits on its slowest bag and the index round trip
//   overlaps the rows'.  The card's SMs and the blocks an SM holds are
//   asked of the runtime once a device.  Threads are held to 48 registers
//   (5 blocks an SM) for float32 tables and 64 (4) for bfloat16 ones:
//   occupancy, not rows in flight a warp, sets what reaches L2.
// * At small B a warp a bag leaves SMs idle (B = 512: 64 warps' worth of
//   blocks for 132 SMs), so the host splits each bag's slots over `split`
//   warps of a block (1, 2, 4 or 8), which add their partials in shared
//   memory in a fixed order: no atomics, the same result on every run.
// * A scalar path (VEC = 1) in the same kernel takes widths the vector does
//   not divide and tables or outputs that are not 16-byte aligned.
//
// What holds it (one H100 80GB HBM3 at 700 W, tools/slab_variants.py
// --kernels bag): at B = 65,536 the rate at which the SMs get the rows
// from L2, ~8 TB/s in float32 against the ~12 TB/s a plain gather of the
// same rows reaches, which keeps no sums and packs no slots; at B = 512,
// the launch and a few round trips.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kWarps = 8;           // warps a block
constexpr int kRowsInFlight = 4;    // row loads a warp issues before an FMA
// blocks an SM must be able to hold, which caps a thread's registers (left
// alone, ptxas takes up to 79 at D = 64 and the SM holds 3 blocks): 48 for
// float32 tables, 64 for bfloat16 ones, whose rows take more to widen and
// which lose at 48 (tools/slab_variants.py --kernels bag)
constexpr int kMinBlocksF32 = 5;
constexpr int kMinBlocksBf16 = 4;
constexpr int kStage = 64;          // slots a warp reads and packs at once
// devices whose SM count and occupancy are kept after the first launch
constexpr int kMaxDevices = 64;
// a bag is split over more warps while the card holds fewer than this many
// bag warps an SM, and each warp keeps at least kMinSplitSlots slots
constexpr int kTargetWarpsPerSM = 16;
constexpr int kMinSplitSlots = 8;
constexpr unsigned kFull = 0xffffffffu;

// How a lane loads VEC elements of a row, adds them into float32 sums and
// stores VEC sums in the table's dtype.
template <typename T, int VEC>
struct Pack;

template <>
struct Pack<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void fma(float (&a)[4], Raw r, float w) {
    a[0] += w * r.x;
    a[1] += w * r.y;
    a[2] += w * r.z;
    a[3] += w * r.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&a)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  }
};

// bfloat16 is the high half of a float32, so a 32-bit word of two bf16
// values widens exactly with a shift and a mask
__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

template <>
struct Pack<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw zero() { return make_uint4(0, 0, 0, 0); }
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void fma(float (&a)[8], Raw r, float w) {
    a[0] += w * bf16_lo(r.x);
    a[1] += w * bf16_hi(r.x);
    a[2] += w * bf16_lo(r.y);
    a[3] += w * bf16_hi(r.y);
    a[4] += w * bf16_lo(r.z);
    a[5] += w * bf16_hi(r.z);
    a[6] += w * bf16_lo(r.w);
    a[7] += w * bf16_hi(r.w);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&a)[8]) {
    uint4 v;
    v.x = bf16_bits(a[0]) | (bf16_bits(a[1]) << 16);
    v.y = bf16_bits(a[2]) | (bf16_bits(a[3]) << 16);
    v.z = bf16_bits(a[4]) | (bf16_bits(a[5]) << 16);
    v.w = bf16_bits(a[6]) | (bf16_bits(a[7]) << 16);
    *reinterpret_cast<uint4*>(p) = v;
  }
};

template <>
struct Pack<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw zero() { return 0.f; }
  static __device__ __forceinline__ Raw load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void fma(float (&a)[1], Raw r, float w) {
    a[0] += w * r;
  }
  static __device__ __forceinline__ void store(float* p, const float (&a)[1]) {
    *p = a[0];
  }
};

template <>
struct Pack<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  static __device__ __forceinline__ Raw zero() { return 0; }
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ void fma(float (&a)[1], Raw r, float w) {
    a[0] += w * bf16_lo(r);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&a)[1]) {
    *p = __float2bfloat16_rn(a[0]);
  }
};

// The slots [lo, hi) of bag b from s0 on, kStage of them: an index and a
// weight a lane (-1 past the slots or past the last bag).
__device__ __forceinline__ void load_stage(const int32_t* __restrict__ indices,
                                           const float* __restrict__ weights,
                                           int b, int s0, int hi, int B,
                                           int L, int lane,
                                           int (&my)[kStage / 32],
                                           float (&mw)[kStage / 32]) {
#pragma unroll
  for (int t = 0; t < kStage / 32; ++t) {
    const int l = s0 + 32 * t + lane;
    const bool in = b < B && l < hi;
    const size_t at = static_cast<size_t>(b) * L + l;
    my[t] = in ? indices[at] : -1;
    mw[t] = in ? weights[at] : 0.f;
  }
}

// G lanes a row (a power of two up to 32), VEC elements a lane; a team of
// `split` warps a bag (1, 2, 4 or 8), kWarps / split teams a block.  The
// grid is what the card holds at once, and each team walks bags b, b +
// teams * gridDim.x, ...: in the order (bag, column chunk, stage), each
// step loads the next step's indices and weights before it reads its rows.
template <typename T>
constexpr int min_blocks() {
  return std::is_same<T, float>::value ? kMinBlocksF32 : kMinBlocksBf16;
}

template <typename T, int VEC, int G>
__global__ void __launch_bounds__(kWarps * 32, min_blocks<T>())
    bag_kernel(const int32_t* __restrict__ indices,
               const float* __restrict__ weights,
               const T* __restrict__ table, T* __restrict__ out, int B,
               int L, int N, int D, int split) {
  using P = Pack<T, VEC>;
  constexpr int kGroups = 32 / G;  // slots one warp load instruction reads
  constexpr int kUnroll =
      kRowsInFlight > kGroups ? kRowsInFlight / kGroups : 1;
  __shared__ int s_row[kWarps][kStage];
  __shared__ float s_w[kWarps][kStage];
  __shared__ float s_part[kWarps][G * VEC];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / G, sub = lane % G;
  const int teams = kWarps / split;
  const int team = warp / split, part = warp % split;
  // this warp's share of every bag's slots
  const int per = (L + split - 1) / split;
  const int lo = min(L, part * per);
  const int hi = min(L, lo + per);
  const int stages = (hi - lo + kStage - 1) / kStage;
  const int nvec = D / VEC;
  const int chunks = G < 32 ? 1 : (nvec + G - 1) / G;  // G < 32: nvec <= G
  const int step = teams * gridDim.x;  // bags between a team's turns
  const unsigned below = (1u << lane) - 1u;
  int next_idx[kStage / 32];
  float next_w[kStage / 32];
  load_stage(indices, weights, blockIdx.x * teams + team, lo, hi, B, L, lane,
             next_idx, next_w);
  // the same number of turns for every warp of the block (its barriers)
  for (int base = blockIdx.x * teams; base < B; base += step) {
    const int bag = base + team;  // past the last bag: no slots, no store
    for (int c = 0; c < chunks; ++c) {
      const int col = c * G + sub;  // the vector of the row this lane reads
      const bool mine = col < nvec;
      float acc[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
      for (int st = 0; st < stages; ++st) {
        int my[kStage / 32];
        float mw[kStage / 32];
#pragma unroll
        for (int t = 0; t < kStage / 32; ++t) {
          my[t] = next_idx[t];
          mw[t] = next_w[t];
        }
        // the next step: this bag's next stage, its next chunk's first
        // stage, or the team's next bag's first stage
        const bool last = st + 1 == stages && c + 1 == chunks;
        load_stage(indices, weights, last ? bag + step : bag,
                   st + 1 < stages ? lo + (st + 1) * kStage : lo, hi, B, L,
                   lane, next_idx, next_w);
        // pack the non-pad slots, in order, into shared memory
        int n = 0;
#pragma unroll
        for (int t = 0; t < kStage / 32; ++t) {
          const bool live = my[t] >= 0 && my[t] < N;
          const unsigned m = __ballot_sync(kFull, live);
          if (live) {
            const int at = n + __popc(m & below);
            s_row[warp][at] = my[t];
            s_w[warp][at] = mw[t];
          }
          n += __popc(m);
        }
        __syncwarp();
        for (int r0 = 0; r0 < n; r0 += kGroups * kUnroll) {
          typename P::Raw raw[kUnroll];
          float wt[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int r = r0 + u * kGroups + grp;
            const bool ok = r < n && mine;
            wt[u] = ok ? s_w[warp][r] : 0.f;
            raw[u] = ok ? P::load(table +
                                  static_cast<size_t>(s_row[warp][r]) * D +
                                  static_cast<size_t>(col) * VEC)
                        : P::zero();
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) P::fma(acc, raw[u], wt[u]);
        }
        __syncwarp();  // the next stage overwrites the packed slots
      }
      // the groups' partial sums, once, in a fixed order
#pragma unroll
      for (int off = G; off < 32; off <<= 1)
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          acc[v] += __shfl_xor_sync(kFull, acc[v], off);
      if (split > 1) {  // the same for the whole block
        if (grp == 0)
#pragma unroll
          for (int v = 0; v < VEC; ++v) s_part[warp][sub * VEC + v] = acc[v];
        __syncthreads();
        if (part == 0 && grp == 0)
          for (int j = 1; j < split; ++j)
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              acc[v] += s_part[warp + j][sub * VEC + v];
        __syncthreads();  // the next chunk overwrites the partials
      }
      if (bag < B && part == 0 && grp == 0 && mine)
        P::store(out + static_cast<size_t>(bag) * D +
                     static_cast<size_t>(col) * VEC,
                 acc);
    }
  }
}

// warps a bag: doubled while the card would still hold fewer than
// kTargetWarpsPerSM bag warps an SM and each warp keeps kMinSplitSlots slots
int bag_split(int B, int L, int sms) {
  int split = 1;
  while (split < kWarps &&
         2LL * split * B <= static_cast<long long>(sms) * kTargetWarpsPerSM &&
         L >= 2 * split * kMinSplitSlots)
    split *= 2;
  return split;
}

// A value of the device the runtime is asked for once (0: not asked yet, or
// an answer below 1, which is not kept); devices past kMaxDevices ask on
// every call.  A failed ask leaves its error for cudaGetLastError().
template <typename Ask>
int once_per_device(std::atomic<int> (&kept)[kMaxDevices], int dev, Ask ask) {
  int v = dev < kMaxDevices ? kept[dev].load(std::memory_order_relaxed) : 0;
  if (v > 0) return v;
  if (ask(&v) != cudaSuccess) return 0;
  if (v > 0 && dev < kMaxDevices) kept[dev].store(v, std::memory_order_relaxed);
  return v;
}

template <typename T, int VEC, int G>
void launch_g(const int32_t* indices, const float* weights, const T* table,
              T* out, int B, int L, int N, int D, int dev, int sms,
              cudaStream_t s) {
  const int split = bag_split(B, L, sms);
  const int teams = kWarps / split;  // bags a block takes at once
  const int want = (B + teams - 1) / teams;
  // no more blocks than the card holds at once; they walk the rest
  static std::atomic<int> kept[kMaxDevices];
  const int per_sm = once_per_device(kept, dev, [](int* v) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        v, bag_kernel<T, VEC, G>, kWarps * 32, 0);
  });
  const int held = sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = want < held ? want : held;
  bag_kernel<T, VEC, G><<<blocks, kWarps * 32, 0, s>>>(
      indices, weights, table, out, B, L, N, D, split);
}

template <typename T, int VEC>
void launch(const int32_t* indices, const float* weights, const T* table,
            T* out, int B, int L, int N, int D, cudaStream_t s) {
  static std::atomic<int> kept[kMaxDevices];  // the card's SMs
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return;  // the caller reports it
  const int sms = once_per_device(kept, dev, [dev](int* v) {
    return cudaDeviceGetAttribute(v, cudaDevAttrMultiProcessorCount, dev);
  });
  if (sms < 1) return;
  const int nvec = D / VEC;
  const auto* i = indices;
  const auto* w = weights;
  if (nvec > 16)
    launch_g<T, VEC, 32>(i, w, table, out, B, L, N, D, dev, sms, s);
  else if (nvec > 8)
    launch_g<T, VEC, 16>(i, w, table, out, B, L, N, D, dev, sms, s);
  else if (nvec > 4)
    launch_g<T, VEC, 8>(i, w, table, out, B, L, N, D, dev, sms, s);
  else if (nvec > 2)
    launch_g<T, VEC, 4>(i, w, table, out, B, L, N, D, dev, sms, s);
  else if (nvec > 1)
    launch_g<T, VEC, 2>(i, w, table, out, B, L, N, D, dev, sms, s);
  else
    launch_g<T, VEC, 1>(i, w, table, out, B, L, N, D, dev, sms, s);
}

// the 16-byte path where D is a multiple of the vector and both the table
// and the output are 16-byte aligned (every row then is), else the scalar
template <typename T, int VEC>
void dispatch(const void* indices, const void* weights, const void* table,
              void* out, int B, int L, int N, int D, cudaStream_t s) {
  const auto* i = static_cast<const int32_t*>(indices);
  const auto* w = static_cast<const float*>(weights);
  const auto* t = static_cast<const T*>(table);
  auto* o = static_cast<T*>(out);
  const bool aligned = (reinterpret_cast<uintptr_t>(table) |
                        reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (D % VEC == 0 && aligned)
    launch<T, VEC>(i, w, t, o, B, L, N, D, s);
  else
    launch<T, 1>(i, w, t, o, B, L, N, D, s);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (the table's and the output's)
int embedding_bag(const void* indices, const void* weights, const void* table,
                  void* out, int B, int L, int N, int D, int dtype,
                  void* stream) {
  if (B <= 0 || D <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    dispatch<float, 4>(indices, weights, table, out, B, L, N, D, s);
  else if (dtype == 1)
    dispatch<__nv_bfloat16, 8>(indices, weights, table, out, B, L, N, D, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

const char* embedding_bag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

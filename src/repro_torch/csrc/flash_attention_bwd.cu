// Flash-attention backward for Hopper (sm_90a): (dq, dk, dv) of the blocked
// online-softmax forward of flash_attention.cu, with GQA, causal masking, a
// sliding window, tanh softcap and a kv_len bound.
//
// Replaces no TPU kernel: the TPU kernel (repro/kernels/flash_attention/
// kernel.py:99, flash_attention) has no VJP, and the reference's train step
// differentiates its plain attention_ref by autodiff instead.  On the card
// that would put the plain version on the train path and hold the
// (B, Hq, S, S) float32 scores of every layer, so kernel 10's gradient is a
// kernel too.
//
// Layout (the forward's): q, o, do (B, Hq, Sq, D), k and v (B, Hkv, Skv, D),
// contiguous, float32 or bfloat16; lse (B, Hq, Sq) float32, the forward's
// row log-sum-exp over the scaled, softcapped, masked scores (+inf for a
// row with no visible key); dq, dk, dv in the inputs' dtype.  The masks are
// the forward's: query i sees key j when j < kv_len, i >= j (causal) and
// i - j < window (window > 0), absolute indices from 0.
//
// The math is FlashAttention-2's, recomputing P from lse:
//
//   delta_i = sum_d dO_id O_id
//   x_ij    = sm_scale q_i.k_j, or softcap tanh(sm_scale q_i.k_j / softcap)
//   P_ij    = exp(x_ij - lse_i), exactly 0 where masked
//   dP_ij   = dO_i.v_j
//   dS_ij   = P_ij (dP_ij - delta_i) (1 - tanh^2) sm_scale
//   dQ = dS K,  dK = dS^T Q,  dV = P^T dO
//
// (the tanh the forward's: tanhf of x / softcap, correctly rounded).
//
// Deterministic, no atomics: three kernels on one stream.
// * attn_bwd_delta_kernel: delta, a warp a row, one fixed-order reduction.
// * attn_bwd_dkdv_kernel: a block a (b, kv head, 32-key tile) loops over the
//   group's query heads and the 32-row query tiles of its band, in order,
//   and accumulates dK and dV in registers: GQA's sum over the group (all 8
//   query heads of gemma-2b's one KV head) happens inside the block.
// * attn_bwd_dq_kernel: a block a (b, q head, 32-row query tile) loops over
//   the key tiles of its band and accumulates dQ.
// Each rounds once, from float32, to the output dtype.
//
// Bound on this card: operations.  The least work is 10·D flops a visible
// (q, k) pair (S, dP, dV, dK and dQ at 2·D each); this first form spends
// 14·D (the dQ kernel computes S and dP again) on the CUDA cores in float32
// for both dtypes (67 TFLOP/s), a simple kernel that is right first:
// wgmma and TMA are later work.  Tiles are float32 in shared memory, rows
// padded by 4 floats; a tile pair's S and dP take a 2 x 2 register block a
// thread (16 x 16 threads, float4 loads along the head dims: a quarter warp
// reads 8 distinct K or V rows on distinct banks), P and dS go through
// shared memory, and the products dV, dK (or dQ) take 4 rows x D / 32
// columns a thread (a warp 4 rows, lane + 32 c its columns).  Tiles wholly
// outside the causal / window band or past kv_len are skipped, as the
// forward skips them.  Shared memory: four 32 x (D + 4) tiles, P and dS
// (32 x 48 each) and the rows' lse and delta, 145,664 bytes at D = 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 32;                // query rows a tile
constexpr int kBK = 32;                // keys a tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPS = kBK + 16;          // row stride of the P and dS tiles
constexpr unsigned kFull = 0xffffffffu;
static_assert(kBQ == 32 && kBK == 32 && kWarps * 4 == kBK,
              "the thread layouts below");

template <int D>
struct Smem {
  static constexpr int kStride = D + 4;          // a tile row, padded
  static constexpr int kTile = 32 * kStride;     // one Q, dO, K or V tile
  static constexpr int kFloats = 4 * kTile + 2 * kBQ * kPS + 2 * kBQ;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
  static_assert(D % 32 == 0 && D >= 64, "head dims 64, 128, 256");
  static_assert(kBytes <= 232448, "over the 227 KB a block can use");
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// 8 consecutive elements from global memory (16- or 32-byte aligned) as
// float32
__device__ __forceinline__ void load8(const float* __restrict__ p, float4& a,
                                      float4& b) {
  a = *reinterpret_cast<const float4*>(p);
  b = *reinterpret_cast<const float4*>(p + 4);
}
__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ p,
                                      float4& a, float4& b) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
  const float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
  a = make_float4(f0.x, f0.y, f1.x, f1.y);
  b = make_float4(f2.x, f2.y, f3.x, f3.y);
}

// 32 rows of a head slice from row ``row0`` into a float32 tile of row
// stride D + 4; rows at or past ``n_rows`` are zero-filled
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst,
                                          const T* __restrict__ src,
                                          int row0, int n_rows) {
  constexpr int kChunks = D / 8;
  constexpr int kStride = D + 4;
  static_assert(32 * kChunks % kThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int it = 0; it < 32 * kChunks / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int r = i / kChunks, c = (i % kChunks) * 8;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (row0 + r < n_rows)
      load8(src + static_cast<size_t>(row0 + r) * D + c, a, b);
    *reinterpret_cast<float4*>(dst + r * kStride + c) = a;
    *reinterpret_cast<float4*>(dst + r * kStride + c + 4) = b;
  }
}

// The rows' lse and delta of query tile ``q0`` (a row past Sq: lse +inf,
// so its P is 0)
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          size_t row_base, int q0, int Sq) {
  if (threadIdx.x < kBQ) {
    const int qi = q0 + threadIdx.x;
    lse_s[threadIdx.x] = qi < Sq ? lse[row_base + qi] : INFINITY;
    delta_s[threadIdx.x] = qi < Sq ? delta[row_base + qi] : 0.f;
  }
}

// One (query tile, key tile) pair: S = Q K^T and dP = dO V^T, then P and dS
// into shared memory.  Thread (tq, tk) = (t / 16, t % 16) owns rows
// tq + 16 i and keys tk + 16 j (i, j < 2).
template <int D>
__device__ __forceinline__ void tile_p_ds(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* lse_s, const float* delta_s, float* Ps, float* dSs, int q0,
    int k0, int Sq, int kv_len, int causal, int window, float softcap,
    float inv_cap, float sm_scale) {
  constexpr int kStride = D + 4;
  const int tq = threadIdx.x >> 4, tk = threadIdx.x & 15;
  float s[2][2], dp[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
  const float* qr = Qs + tq * kStride;
  const float* orow = dOs + tq * kStride;
  const float* kr = Ks + tk * kStride;
  const float* vr = Vs + tk * kStride;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 qa = ld4(qr + d), qb = ld4(qr + 16 * kStride + d);
    const float4 ka = ld4(kr + d), kb = ld4(kr + 16 * kStride + d);
    const float4 oa = ld4(orow + d), ob = ld4(orow + 16 * kStride + d);
    const float4 va = ld4(vr + d), vb = ld4(vr + 16 * kStride + d);
    const float4 qs[2] = {qa, qb}, ks[2] = {ka, kb};
    const float4 os[2] = {oa, ob}, vs[2] = {va, vb};
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][j] = fmaf(qs[i].x, ks[j].x, s[i][j]);
        s[i][j] = fmaf(qs[i].y, ks[j].y, s[i][j]);
        s[i][j] = fmaf(qs[i].z, ks[j].z, s[i][j]);
        s[i][j] = fmaf(qs[i].w, ks[j].w, s[i][j]);
        dp[i][j] = fmaf(os[i].x, vs[j].x, dp[i][j]);
        dp[i][j] = fmaf(os[i].y, vs[j].y, dp[i][j]);
        dp[i][j] = fmaf(os[i].z, vs[j].z, dp[i][j]);
        dp[i][j] = fmaf(os[i].w, vs[j].w, dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = tq + 16 * i, c = tk + 16 * j;
      const int qi = q0 + r, kj = k0 + c;
      float x = s[i][j] * sm_scale, dcap = 1.f;
      if (softcap > 0.f) {
        // the forward's x / softcap, correctly rounded without a division
        // (the rounded reciprocal's quotient corrected by its fma residual)
        const float q1 = x * inv_cap;
        const float t = tanhf(fmaf(fmaf(-softcap, q1, x), inv_cap, q1));
        x = softcap * t;
        dcap = 1.f - t * t;
      }
      bool ok = qi < Sq && kj < kv_len;
      if (causal) ok = ok && qi >= kj;
      if (window > 0) ok = ok && (qi - kj) < window;
      const float p = ok ? expf(x - lse_s[r]) : 0.f;
      Ps[r * kPS + c] = p;
      dSs[r * kPS + c] = p * (dp[i][j] - delta_s[r]) * dcap * sm_scale;
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                          float* __restrict__ delta, long long rows) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // a whole warp
  const T* orow = o + row * D;
  const T* drow = dout + row * D;
  float s = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32)
    s = fmaf(to_f(drow[c]), to_f(orow[c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  if (lane == 0) delta[row] = s;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int Hq, int Hkv, int Sq, int Skv,
                         int causal, int window, int kv_len, float softcap,
                         float sm_scale) {
  using L = Smem<D>;
  constexpr int kStride = L::kStride;
  constexpr int kCols = D / 32;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + L::kTile;
  float* Qs = Vs + L::kTile;
  float* dOs = Qs + L::kTile;
  float* Ps = dOs + L::kTile;
  float* dSs = Ps + kBQ * kPS;
  float* lse_s = dSs + kBQ * kPS;
  float* delta_s = lse_s + kBQ;

  // the grid's slow axis walks the key tiles from the first, the longest
  // under a causal mask
  const int k0 = blockIdx.y * kBK;
  const int hk = blockIdx.x % Hkv, b = blockIdx.x / Hkv;
  const int group = Hq / Hkv;
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + hk) * Skv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  // query tiles that hold a row seeing some key of this tile
  int q_lo = causal ? k0 : 0;
  int q_hi = Sq;
  if (window > 0) q_hi = min(q_hi, k0 + kBK - 1 + window);
  if (k0 >= kv_len) q_hi = q_lo;
  const int qt0 = q_lo / kBQ;
  const int qt1 = q_hi > q_lo ? (q_hi + kBQ - 1) / kBQ : qt0;

  if (qt1 > qt0) {
    load_tile<T, D>(Ks, k + kv_base * D, k0, kv_len);
    load_tile<T, D>(Vs, v + kv_base * D, k0, kv_len);
  }
  // dK and dV of keys k0 + 4 warp + i (i < 4), columns lane + 32 c
  float acc_k[4][kCols], acc_v[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int hh = 0; hh < group; ++hh) {
    const size_t row_base = (static_cast<size_t>(b) * Hq + hk * group + hh)
                            * Sq;
    for (int qt = qt0; qt < qt1; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // every thread is done with the last Q, dO, P, dS
      load_tile<T, D>(Qs, q + row_base * D, q0, Sq);
      load_tile<T, D>(dOs, dout + row_base * D, q0, Sq);
      load_rows(lse_s, delta_s, lse, delta, row_base, q0, Sq);
      __syncthreads();
      tile_p_ds<D>(Qs, dOs, Ks, Vs, lse_s, delta_s, Ps, dSs, q0, k0, Sq,
                   kv_len, causal, window, softcap, inv_cap, sm_scale);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q over this tile's rows
#pragma unroll 2
      for (int r = 0; r < kBQ; ++r) {
        const float4 p4 = ld4(Ps + r * kPS + 4 * warp);
        const float4 s4 = ld4(dSs + r * kPS + 4 * warp);
        const float pk[4] = {p4.x, p4.y, p4.z, p4.w};
        const float sk[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float o = dOs[r * kStride + lane + 32 * c];
          const float qq = Qs[r * kStride + lane + 32 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_v[i][c] = fmaf(pk[i], o, acc_v[i][c]);
            acc_k[i][c] = fmaf(sk[i], qq, acc_k[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + 4 * warp + i;
    if (kj >= Skv) continue;
    T* dkr = dk + (kv_base + kj) * D + lane;
    T* dvr = dv + (kv_base + kj) * D + lane;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      from_f(dkr + 32 * c, acc_k[i][c]);
      from_f(dvr + 32 * c, acc_v[i][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq,
                       int Hq, int Hkv, int Sq, int Skv, int causal,
                       int window, int kv_len, float softcap,
                       float sm_scale) {
  using L = Smem<D>;
  constexpr int kStride = L::kStride;
  constexpr int kCols = D / 32;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + L::kTile;
  float* Qs = Vs + L::kTile;
  float* dOs = Qs + L::kTile;
  float* Ps = dOs + L::kTile;
  float* dSs = Ps + kBQ * kPS;
  float* lse_s = dSs + kBQ * kPS;
  float* delta_s = lse_s + kBQ;

  // the grid's slow axis walks the query tiles from the last one down
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int h = blockIdx.x % Hq, b = blockIdx.x / Hq;
  const int hk = h / (Hq / Hkv);
  const size_t row_base = (static_cast<size_t>(b) * Hq + h) * Sq;
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + hk) * Skv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  // key tiles that hold a visible key for some row of this query tile
  int k_hi = kv_len;
  if (causal) k_hi = min(k_hi, q0 + kBQ);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int kt0 = k_lo / kBK;
  const int n_kt = max(0, (k_hi + kBK - 1) / kBK - kt0);

  load_tile<T, D>(Qs, q + row_base * D, q0, Sq);
  load_tile<T, D>(dOs, dout + row_base * D, q0, Sq);
  load_rows(lse_s, delta_s, lse, delta, row_base, q0, Sq);
  // dQ of rows q0 + 4 warp + i (i < 4), columns lane + 32 c
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  for (int it = 0; it < n_kt; ++it) {
    const int k0 = (kt0 + it) * kBK;
    __syncthreads();  // every thread is done with the last K and dS
    load_tile<T, D>(Ks, k + kv_base * D, k0, kv_len);
    load_tile<T, D>(Vs, v + kv_base * D, k0, kv_len);
    __syncthreads();
    tile_p_ds<D>(Qs, dOs, Ks, Vs, lse_s, delta_s, Ps, dSs, q0, k0, Sq,
                 kv_len, causal, window, softcap, inv_cap, sm_scale);
    __syncthreads();
    // dQ += dS K over this tile's keys, 4 at a time
#pragma unroll 1
    for (int c0 = 0; c0 < kBK; c0 += 4) {
      float ds[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 d4 = ld4(dSs + (4 * warp + i) * kPS + c0);
        ds[i][0] = d4.x;
        ds[i][1] = d4.y;
        ds[i][2] = d4.z;
        ds[i][3] = d4.w;
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* kr = Ks + (c0 + t) * kStride + lane;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float kk = kr[32 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[i][c] = fmaf(ds[i][t], kk, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * warp + i;
    if (qi >= Sq) continue;
    T* dqr = dq + (row_base + qi) * D + lane;
#pragma unroll
    for (int c = 0; c < kCols; ++c) from_f(dqr + 32 * c, acc[i][c]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* lse, const void* dout, void* dq, void* dk, void* dv,
           void* delta, int B, int Hq, int Hkv, int Sq, int Skv, int causal,
           int window, int kv_len, float softcap, float sm_scale,
           cudaStream_t stream) {
  const size_t smem = Smem<D>::kBytes;
  const int n_qt = (Sq + kBQ - 1) / kBQ, n_kt = (Skv + kBK - 1) / kBK;
  if (n_qt > 65535 || n_kt > 65535 ||
      static_cast<long long>(B) * Hq > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const float* flse = static_cast<const float*>(lse);
  float* fdelta = static_cast<float*>(delta);
  cudaError_t err;
  if (Sq > 0) {
    const long long rows = static_cast<long long>(B) * Hq * Sq;
    const long long blocks = (rows + kWarps - 1) / kWarps;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    attn_bwd_delta_kernel<T, D><<<static_cast<unsigned>(blocks), kThreads,
                                  0, stream>>>(static_cast<const T*>(o), tdo,
                                               fdelta, rows);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  if (Skv > 0) {
    err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_bwd_dkdv_kernel<T, D><<<dim3(B * Hkv, n_kt), kThreads, smem,
                                 stream>>>(
        tq, tk, tv, tdo, flse, fdelta, static_cast<T*>(dk),
        static_cast<T*>(dv), Hq, Hkv, Sq, Skv, causal, window, kv_len,
        softcap, sm_scale);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  if (Sq > 0) {
    err = cudaFuncSetAttribute(attn_bwd_dq_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_bwd_dq_kernel<T, D><<<dim3(B * Hq, n_qt), kThreads, smem,
                               stream>>>(
        tq, tk, tv, tdo, flse, fdelta, static_cast<T*>(dq), Hq, Hkv, Sq,
        Skv, causal, window, kv_len, softcap, sm_scale);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  return 0;
}

template <int D>
int launch_dtype(int dtype, const void* q, const void* k, const void* v,
                 const void* o, const void* lse, const void* dout, void* dq,
                 void* dk, void* dv, void* delta, int B, int Hq, int Hkv,
                 int Sq, int Skv, int causal, int window, int kv_len,
                 float softcap, float sm_scale, cudaStream_t stream) {
  if (dtype == 0)
    return launch<float, D>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, Hq,
                            Hkv, Sq, Skv, causal, window, kv_len, softcap,
                            sm_scale, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, D>(q, k, v, o, lse, dout, dq, dk, dv,
                                    delta, B, Hq, Hkv, Sq, Skv, causal,
                                    window, kv_len, softcap, sm_scale,
                                    stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  kv_len must be at most Skv.  ``delta`` is
// (B, Hq, Sq) float32 scratch.  Writes every element of dq, dk and dv.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* lse, const void* dout,
                        void* dq, void* dk, void* dv, void* delta, int B,
                        int Hq, int Hkv, int Sq, int Skv, int D, int dtype,
                        int causal, int window, int kv_len, float softcap,
                        float sm_scale, void* stream) {
  if (B <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || B > 65535 || Hq > 65535 || Sq < 0 ||
      Skv < 0 || kv_len < 0 || kv_len > Skv)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dtype<64>(dtype, q, k, v, o, lse, dout, dq, dk, dv, delta,
                              B, Hq, Hkv, Sq, Skv, causal, window, kv_len,
                              softcap, sm_scale, s);
    case 128:
      return launch_dtype<128>(dtype, q, k, v, o, lse, dout, dq, dk, dv,
                               delta, B, Hq, Hkv, Sq, Skv, causal, window,
                               kv_len, softcap, sm_scale, s);
    case 256:
      return launch_dtype<256>(dtype, q, k, v, o, lse, dout, dq, dk, dv,
                               delta, B, Hq, Hkv, Sq, Skv, causal, window,
                               kv_len, softcap, sm_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

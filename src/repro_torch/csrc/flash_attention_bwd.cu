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
// Deterministic, no atomics: four kernels on one stream.
// * attn_bwd_delta_kernel: delta, a warp a row, one fixed-order reduction.
// * the dK/dV pass walks a work list that the host builds
//   (kernels/flash_attention/schedule.py): an item is one key tile of one
//   (b, KV head) and a run of its "units", the (query head of the group,
//   query tile) pairs of the tile's causal / window band, head-major.  The
//   host cuts each tile's units into items of near-equal length, sized from
//   the shape and the SM count, and orders them longest first, so the grid
//   (one block an item) fills the card in balanced waves.  A tile held by
//   one item writes dK and dV itself; the items of a tile held by several
//   write float32 partials to a workspace (a slot an item), and
//   attn_bwd_reduce_kernel sums each such tile's slots in the list's order
//   and rounds once to the output dtype (and writes the zeros of a tile
//   that no query sees).
// * the dQ pass: a block a (b, q head, query tile) loops over the key
//   tiles of its band, longest query tiles first, and accumulates dQ.
// Each output rounds once, from float32.
//
// Bound on this card: operations, 10·D flops a visible (q, k) pair (S, dP,
// dV, dK and dQ at 2·D each).  Float32 spends 14·D: the dQ pass computes S
// and dP again (the price of no atomics); bfloat16 20·D (below).
//
// ---- bfloat16: tensor cores (wgmma) ------------------------------------
//
// attn_bwd_dkdv_tc_kernel: a block of 2 warpgroups owns one 64-key tile.
// Per unit (64 query rows), warpgroup 0 computes S^T = K Q^T and warpgroup
// 1 dP^T = V dO^T, each D / 16 wgmma.m64n64k16 with both operands in
// swizzled shared memory, at once.  Warpgroup 0 turns S^T into P^T on its
// accumulator fragments (the forward's numerics: scale, tanhf softcap with
// the correctly rounded x / softcap, expf against the row's lse, exactly 0
// where masked, the mask applied only where a warp's 16 x 64 block crosses
// the band's edge), hands P (1 - tanh^2) sm_scale to warpgroup 1 through
// 16 KB of shared memory (named barrier 1), and adds dV += P^T dO; warpgroup
// 1 forms dS^T on its dP^T fragments and adds dK += dS^T Q.  Both products
// are the register-A form, N = D: the accumulator layout of two 8-query
// groups is the A fragment of one 16-query step, as the forward's P V.  So
// each warpgroup keeps one 64 x D float32 accumulator (D / 2 registers a
// thread, 128 at D = 256).  P and dS are product operands as two bf16
// terms, hi = bf16(x) and lo = bf16(x - hi), each multiplied in (the
// forward's split_bf16): rounded once, they moved small outputs by more
// than the gate (1e-3 of an output's scale plus 2e-2 of its value) allows
// on a few elements in 10^5 (tools/attention_bwd_probe.py's rounded_bwd,
// PERF.md).  So the backward spends 20·D flops a pair on the tensor cores:
// S, dP, dV (twice), dK (twice) here, S, dP, dQ (twice) in the dQ pass.
// Shared memory: K, V, a 2-stage ring of Q, dO and the rows' lse and
// delta (cp.async, unit u + 1 lands during unit u; warpgroup 1 issues the
// copies while it waits for warpgroup 0's exponentials), and the exchange:
// 215,040 bytes at D = 256.
//
// attn_bwd_dq_tc_kernel: a block of 2 warpgroups owns 128 query rows, 64 a
// warpgroup, with Q and dO resident and a 2-stage ring of K and V tiles (32
// keys at D = 256, so that 227 KB hold it; 64 otherwise).  Per key tile each
// warpgroup computes S = Q K^T and dP = dO V^T (wgmma, N = the key tile),
// dS on the fragments, and dQ += (dS_hi + dS_lo) K in the register-A form
// (N = D).
//
// ---- float32: CUDA cores -----------------------------------------------
//
// Exact float32 (no TF32): 67 TFLOP/s.  32 x 32 tile pairs.  Threads 0-127
// compute S and threads 128-255 dP, a 2 x 4 register block a thread
// (float4 loads along the head dims: per 4 dims 6 loads for 32 fmas, a
// warp's on distinct banks); S's half writes P and P (1 - tanh^2) sm_scale,
// dP's half, once those are written (named barrier 1), dS; the products
// dV, dK (or dQ) take 4 rows x D / 32 columns a thread (a warp 4 rows,
// lane + 32 c its columns).  The
// next unit's Q and dO (the dQ pass: the next key tile's K and V) arrive by
// cp.async during this one's products: two barriers a unit.  Shared
// memory: six 32 x (D + 4) float32 tiles, three 32 x 48 score tiles and the
// rows' lse and delta, 218,624 bytes at D = 256.  The dK/dV pass runs on
// the same work list as bf16's, with 32-key tiles and 32-row units.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// the work list
// ---------------------------------------------------------------------------

// An item of the dK/dV pass, 8 int32 (schedule.py's ITEM_FIELDS): key tile
// ``kt`` of (b, KV head) ``bh`` = b * Hkv + hk, units [u0, u1) of its band
// (unit u is query head hk * group + u / n_band and query tile qt0 +
// u % n_band), and the workspace slot of its partials (-1: the tile's one
// item, which writes dK and dV itself).
struct Item {
  int bh, kt, u0, u1, qt0, n_band, slot, pad;
};

__device__ __forceinline__ Item load_item(const int* __restrict__ items,
                                          int i) {
  const int4* p = reinterpret_cast<const int4*>(items) + 2 * i;
  const int4 a = p[0], b = p[1];
  return Item{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
}

// one float32, zero-filled when ``fill`` is false
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool fill) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(fill ? 4 : 0)
               : "memory");
}

// Named barrier 1 hands P (1 - tanh^2) sm_scale from the threads that
// computed S (threads 0-127) to those that computed dP (128-255) once a
// tile pair: the first arrive once it is written, the others wait for that
// before reading it.
__device__ __forceinline__ void pd_arrive() {
  asm volatile("bar.arrive 1, %0;\n" ::"n"(kThreads) : "memory");
}
__device__ __forceinline__ void pd_wait() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBQ = 32;                // query rows a tile
constexpr int kBK = 32;                // keys a tile
constexpr int kPS = kBK + 16;          // row stride of the score tiles
static_assert(kBQ == 32 && kBK == 32 && kWarps * 4 == kBK,
              "the thread layouts below");

// Shared memory of both float32 passes: six 32-row tiles of row stride
// D + 4 (the dK/dV pass: K, V and 2 stages of Q and dO; the dQ pass: Q, dO
// and 2 stages of K and V), the three score tiles P, P (1 - tanh^2)
// sm_scale and dS (32 x kPS each), and 2 stages of the rows' lse
// and delta
template <int D>
struct Smem {
  static constexpr int kStride = D + 4;          // a tile row, padded
  static constexpr int kTile = 32 * kStride;     // one Q, dO, K or V tile
  static constexpr int kScores = kBQ * kPS;      // one score tile
  static constexpr int kRows = 6 * kTile + 3 * kScores;  // lse, delta
  static constexpr int kFloats = kRows + 2 * 2 * kBQ;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
  static_assert(D % 32 == 0 && D >= 64, "head dims 64, 128, 256");
  static_assert(kBytes <= 232448, "over the 227 KB a block can use");
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// 32 rows of a float32 head slice from row ``row0`` into a tile of row
// stride D + 4 at shared address ``dst``, 16 B a copy; rows at or past
// ``n_rows`` are zero-filled (their source address is the slice's first
// row, which is never read)
template <int D>
__device__ __forceinline__ void load_tile_f32(uint32_t dst,
                                              const float* __restrict__ src,
                                              int row0, int n_rows) {
  constexpr int kChunks = D / 4;
  static_assert(32 * kChunks % kThreads == 0, "whole copies a thread");
#pragma unroll
  for (int it = 0; it < 32 * kChunks / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int r = i / kChunks, c = i % kChunks;
    const bool in = row0 + r < n_rows;
    cp_async16(dst + 4u * static_cast<uint32_t>(r * (D + 4) + 4 * c),
               src + (in ? static_cast<size_t>(row0 + r) * D + 4 * c : 0),
               in);
  }
}

// The lse and delta of query rows q0 .. q0 + 31 into ``dst`` (lse, then
// delta), rows past Sq zero-filled (their scores are masked)
__device__ __forceinline__ void load_rows_f32(uint32_t dst,
                                              const float* __restrict__ lse,
                                              const float* __restrict__ delta,
                                              size_t row_base, int q0,
                                              int Sq) {
  if (threadIdx.x < 2 * kBQ) {
    const int qi = q0 + (threadIdx.x & (kBQ - 1));
    cp_async4(dst + 4 * threadIdx.x,
              (threadIdx.x < kBQ ? lse : delta) + row_base +
                  (qi < Sq ? qi : 0),
              qi < Sq);
  }
}

// One (query tile, key tile) pair's scores.  Threads 0-127 compute S =
// Q K^T and write P (exactly 0 where masked) to ``Ps`` and P (1 - tanh^2)
// sm_scale to ``PDs``; threads 128-255 compute dP = dO V^T and, once the
// first have written (named barrier 1), dS = P (1 - tanh^2) sm_scale
// (dP - delta) to ``DSs``, each from the element its twin 128 threads down
// wrote.  A thread owns rows tq + 16 i (i < 2) and keys tk + 8 j (j < 4),
// (tq, tk) = (t / 8, t % 8) of its half: per 4 head dims it loads 2 float4
// of its rows and 4 of its keys for 32 fmas (a warp's loads: 4 distinct
// rows, 8 distinct keys, each on distinct banks).
template <int D>
__device__ __forceinline__ void tile_scores(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* lse_s, const float* delta_s, float* Ps, float* PDs,
    float* DSs, int q0, int k0, int Sq, int kv_len, int causal, int window,
    float softcap, float inv_cap, float sm_scale) {
  constexpr int kStride = D + 4;
  const bool dp_half = threadIdx.x >= 128;
  const int t = threadIdx.x & 127, tq = t >> 3, tk = t & 7;
  const float* ar = (dp_half ? dOs : Qs) + tq * kStride;
  const float* br = (dp_half ? Vs : Ks) + tk * kStride;
  float acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 a[2] = {ld4(ar + d), ld4(ar + 16 * kStride + d)};
    float4 b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = ld4(br + 8 * j * kStride + d);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
  if (dp_half) {
    pd_wait();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tq + 16 * i, c = tk + 8 * j;
        DSs[r * kPS + c] = PDs[r * kPS + c] * (acc[i][j] - delta_s[r]);
      }
    return;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = tq + 16 * i, c = tk + 8 * j;
      const int qi = q0 + r, kj = k0 + c;
      float x = acc[i][j] * sm_scale, dcap = 1.f;
      if (softcap > 0.f) {
        // the forward's x / softcap, correctly rounded without a division
        // (the rounded reciprocal's quotient corrected by its fma residual)
        const float q1 = x * inv_cap;
        const float th = tanhf(fmaf(fmaf(-softcap, q1, x), inv_cap, q1));
        x = softcap * th;
        dcap = 1.f - th * th;
      }
      bool ok = qi < Sq && kj < kv_len;
      if (causal) ok = ok && qi >= kj;
      if (window > 0) ok = ok && (qi - kj) < window;
      const float p = ok ? expf(x - lse_s[r]) : 0.f;
      Ps[r * kPS + c] = p;
      PDs[r * kPS + c] = p * dcap * sm_scale;
    }
  pd_arrive();
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

// One work-list item: a 32-key tile's dK and dV over the item's units, the
// next unit's Q, dO, lse and delta copied in during this one's products
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const int* __restrict__ items,
                             float* __restrict__ ws, float* __restrict__ dk,
                             float* __restrict__ dv, int Hq, int Hkv, int Sq,
                             int Skv, int causal, int window, int kv_len,
                             float softcap, float sm_scale) {
  using L = Smem<D>;
  constexpr int kStride = L::kStride;
  constexpr int kCols = D / 32;
  extern __shared__ float4 smem4[];
  float* base = reinterpret_cast<float*>(smem4);
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(base));
  // tiles: K, V, then stage s's Q and dO at 2 + 2 s
  const float* Ks = base;
  const float* Vs = base + L::kTile;
  float* Ps = base + 6 * L::kTile;
  float* PDs = Ps + L::kScores;
  float* DSs = PDs + L::kScores;

  const Item item = load_item(items, blockIdx.x);
  const int k0 = item.kt * kBK;
  const int hk = item.bh % Hkv, b = item.bh / Hkv;
  const int group = Hq / Hkv;
  const size_t kv_base = static_cast<size_t>(item.bh) * Skv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  auto load_unit = [&](int u, int s) {
    const int hh = u / item.n_band;
    const int q0 = (item.qt0 + u % item.n_band) * kBQ;
    const size_t row_base =
        (static_cast<size_t>(b) * Hq + hk * group + hh) * Sq;
    const uint32_t qs = sbase + 4u * (2 + 2 * s) * L::kTile;
    load_tile_f32<D>(qs, q + row_base * D, q0, Sq);
    load_tile_f32<D>(qs + 4u * L::kTile, dout + row_base * D, q0, Sq);
    load_rows_f32(sbase + 4u * (L::kRows + s * 2 * kBQ), lse, delta,
                  row_base, q0, Sq);
  };
  load_tile_f32<D>(sbase, k + kv_base * D, k0, kv_len);
  load_tile_f32<D>(sbase + 4u * L::kTile, v + kv_base * D, k0, kv_len);
  load_unit(item.u0, 0);
  cp_async_commit();

  // dK and dV of keys k0 + 4 warp + i (i < 4), columns lane + 32 c
  float acc_k[4][kCols], acc_v[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int u = item.u0; u < item.u1; ++u) {
    const int s = (u - item.u0) & 1;
    cp_async_wait<0>();
    __syncthreads();  // unit u has landed; every thread is done with u - 1
    if (u + 1 < item.u1) load_unit(u + 1, s ^ 1);
    cp_async_commit();
    const int q0 = (item.qt0 + u % item.n_band) * kBQ;
    const float* Qs = base + (2 + 2 * s) * L::kTile;
    const float* dOs = Qs + L::kTile;
    const float* lse_s = base + L::kRows + s * 2 * kBQ;
    tile_scores<D>(Qs, dOs, Ks, Vs, lse_s, lse_s + kBQ, Ps, PDs, DSs, q0,
                   k0, Sq, kv_len, causal, window, softcap, inv_cap,
                   sm_scale);
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q over this tile's rows
#pragma unroll 2
    for (int r = 0; r < kBQ; ++r) {
      const float4 p4 = ld4(Ps + r * kPS + 4 * warp);
      const float4 s4 = ld4(DSs + r * kPS + 4 * warp);
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
  cp_async_wait<0>();

  // the tile's one item writes dK and dV; otherwise the item's slot
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * warp + i, kj = k0 + r;
    float *dkr, *dvr;
    if (item.slot < 0) {
      if (kj >= Skv) continue;
      dkr = dk + (kv_base + kj) * D;
      dvr = dv + (kv_base + kj) * D;
    } else {
      dkr = ws + (static_cast<size_t>(item.slot) * 2 * kBK + r) * D;
      dvr = dkr + kBK * D;
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dkr[lane + 32 * c] = acc_k[i][c];
      dvr[lane + 32 * c] = acc_v[i][c];
    }
  }
}

// dQ of 32 query rows of one (b, q head), the next key tile's K and V
// copied in during this one's products
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_dq_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq, int Hq, int Hkv, int Sq,
                           int Skv, int causal, int window, int kv_len,
                           float softcap, float sm_scale) {
  using L = Smem<D>;
  constexpr int kStride = L::kStride;
  constexpr int kCols = D / 32;
  extern __shared__ float4 smem4[];
  float* base = reinterpret_cast<float*>(smem4);
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(base));
  // tiles: Q, dO, then stage s's K and V at 2 + 2 s
  const float* Qs = base;
  const float* dOs = base + L::kTile;
  float* Ps = base + 6 * L::kTile;
  float* PDs = Ps + L::kScores;
  float* DSs = PDs + L::kScores;
  const float* lse_s = base + L::kRows;

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

  auto load_kv = [&](int kt, int s) {
    const uint32_t ks = sbase + 4u * (2 + 2 * s) * L::kTile;
    load_tile_f32<D>(ks, k + kv_base * D, kt * kBK, kv_len);
    load_tile_f32<D>(ks + 4u * L::kTile, v + kv_base * D, kt * kBK, kv_len);
  };
  load_tile_f32<D>(sbase, q + row_base * D, q0, Sq);
  load_tile_f32<D>(sbase + 4u * L::kTile, dout + row_base * D, q0, Sq);
  load_rows_f32(sbase + 4u * L::kRows, lse, delta, row_base, q0, Sq);
  if (n_kt > 0) load_kv(kt0, 0);
  cp_async_commit();

  // dQ of rows q0 + 4 warp + i (i < 4), columns lane + 32 c
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  for (int it = 0; it < n_kt; ++it) {
    const int s = it & 1, k0 = (kt0 + it) * kBK;
    cp_async_wait<0>();
    __syncthreads();  // tile it has landed; every thread is done with it - 1
    if (it + 1 < n_kt) load_kv(kt0 + it + 1, s ^ 1);
    cp_async_commit();
    const float* Ks = base + (2 + 2 * s) * L::kTile;
    tile_scores<D>(Qs, dOs, Ks, Ks + L::kTile, lse_s, lse_s + kBQ, Ps, PDs,
                   DSs, q0, k0, Sq, kv_len, causal, window, softcap, inv_cap,
                   sm_scale);
    __syncthreads();
    // dQ += dS K over this tile's keys, 4 at a time
#pragma unroll 1
    for (int c0 = 0; c0 < kBK; c0 += 4) {
      float ds[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 d4 = ld4(DSs + (4 * warp + i) * kPS + c0);
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
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * warp + i;
    if (qi >= Sq) continue;
    float* dqr = dq + (row_base + qi) * D + lane;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dqr[32 * c] = acc[i][c];
  }
}

// ---------------------------------------------------------------------------
// the reduction of the dK/dV partials (both dtypes)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void store4(float* p, float4 s) {
  *reinterpret_cast<float4*>(p) = s;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 s) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(s.x, s.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(s.z, s.w);
  uint2 w;
  w.x = *reinterpret_cast<const uint32_t*>(&a);
  w.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = w;
}

// A thread a float4 of one reduced tile's dK or dV (tile t of the list:
// ``red_tiles[t]`` = b * Hkv * n_kt + hk * n_kt + kt, its slots
// red_slots[red_ptr[t] .. red_ptr[t + 1])), summed in the slots' order and
// rounded once; a tile with no slot is written as 0.
template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_reduce_kernel(const float* __restrict__ ws,
                           const int* __restrict__ red_tiles,
                           const int* __restrict__ red_ptr,
                           const int* __restrict__ red_slots,
                           T* __restrict__ dk, T* __restrict__ dv, int n_kt,
                           int Skv, long long n) {
  constexpr int kPer = 2 * BK * D / 4;  // float4s of a tile's dK and dV
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= n) return;
  const int t = static_cast<int>(idx / kPer), e = static_cast<int>(idx % kPer);
  const int which = e / (BK * D / 4), row = (e % (BK * D / 4)) / (D / 4);
  const int tile = red_tiles[t];
  const int bh = tile / n_kt, kj = (tile % n_kt) * BK + row;
  if (kj >= Skv) return;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = red_ptr[t]; i < red_ptr[t + 1]; ++i) {
    const float4 w = *reinterpret_cast<const float4*>(
        ws + static_cast<size_t>(red_slots[i]) * 2 * BK * D + 4 * e);
    s.x += w.x;
    s.y += w.y;
    s.z += w.z;
    s.w += w.w;
  }
  const int col = 4 * (e % (D / 4));
  store4((which ? dv : dk) + (static_cast<size_t>(bh) * Skv + kj) * D + col,
         s);
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcBK = 64;   // keys a dK/dV tile (the M of its products)
constexpr int kTcBQ = 64;   // query rows a dK/dV unit
constexpr int kTcRowsQ = 128;  // query rows a dQ block, 64 a warpgroup

template <int D>
struct DkdvTiles {
  static constexpr uint32_t kTile = 64 * D * 2;  // one 64-row bf16 tile
  // K, V, then per stage Q and dO, then per stage the rows' lse and delta,
  // then the exchange (64 x 64 float32), and room to align the base to 1 KB
  static constexpr uint32_t kStage = 2 * kTile;
  static constexpr uint32_t kRows = 2 * kTile + 2 * kStage;
  static constexpr uint32_t kPd = kRows + 2 * 2 * kTcBQ * 4;
  static constexpr size_t kBytes = kPd + kTcBK * kTcBQ * 4 + 1024;
  static_assert(D % 64 == 0, "tiles are stored in 64-column blocks");
  static_assert(kBytes <= 232448, "over the 227 KB a block can use");
};

template <int D>
struct DqTiles {
  static constexpr int kBK = D == 256 ? 32 : 64;   // keys a tile
  static constexpr uint32_t kQ = kTcRowsQ * D * 2;  // Q or dO
  static constexpr uint32_t kKV = kBK * D * 2;      // one K or V tile
  static constexpr size_t kBytes = 2 * kQ + 2 * 2 * kKV + 1024;
  static_assert(kBytes <= 232448, "over the 227 KB a block can use");
};

// kRows rows of a bf16 head slice from row ``row0`` into a sw128 tile at
// shared address ``dst``, copied by kT threads (``t`` this one's index
// among them); rows at or past ``n_rows`` are zero-filled (their source
// address is the slice's first row, which is never read)
template <int D, int kRows, int kT = kThreads>
__device__ __forceinline__ void load_tile_tc(
    uint32_t dst, const __nv_bfloat16* __restrict__ src, int row0,
    int n_rows, int t = threadIdx.x) {
  constexpr int kChunks = D / 8;
  static_assert(kRows * kChunks % kT == 0, "whole copies a thread");
  auto copy = [&](int it) {
    const int i = it * kT + t;
    const int r = i / kChunks, c = i % kChunks;
    const bool in = row0 + r < n_rows;
    cp_async16(dst + sw128<kRows>(r, c),
               src + (in ? static_cast<size_t>(row0 + r) * D + c * 8 : 0),
               in);
  };
  if constexpr (kT == kThreads) {
#pragma unroll
    for (int it = 0; it < kRows * kChunks / kT; ++it) copy(it);
  } else {
    // a warpgroup's copies, issued beside its accumulators (the dK/dV
    // kernel's, 128 registers at D = 256): unrolled by 4 only, or they
    // spill
#pragma unroll 4
    for (int it = 0; it < kRows * kChunks / kT; ++it) copy(it);
  }
}

__device__ __forceinline__ void async_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}


// the descriptor step to 16-column slice kk of a K-major sw128 tile of
// kRows rows
template <int kRows>
__device__ __forceinline__ uint64_t kstep(int kk) {
  return static_cast<uint64_t>(((kk >> 2) * kRows * 128 + (kk & 3) * 32) >>
                               4);
}

// x (a scaled score) -> (softcapped x, 1 - tanh^2), the forward's numerics
__device__ __forceinline__ float cap_score(float x, float softcap,
                                           float inv_cap, float& dcap) {
  dcap = 1.f;
  if (softcap > 0.f) {
    // x / softcap, correctly rounded without a division (Markstein)
    const float q1 = x * inv_cap;
    const float t = tanhf(fmaf(fmaf(-softcap, q1, x), inv_cap, q1));
    dcap = 1.f - t * t;
    return softcap * t;
  }
  return x;
}

// One work-list item: a 64-key tile's dK (warpgroup 1) and dV (warpgroup 0)
// over the item's units
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_dkdv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            const int* __restrict__ items,
                            float* __restrict__ ws,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int Hq, int Hkv,
                            int Sq, int Skv, int causal, int window,
                            int kv_len, float softcap, float sm_scale) {
  using L = DkdvTiles<D>;
  constexpr int kDT = D / 8;  // 8-column groups of dK and dV
  extern __shared__ uint4 smem_tc[];
  // tiles start on a 1 KB boundary: the swizzle repeats every 8 rows of
  // 128 bytes, and descriptors carry no base offset
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_tc));
  const uint32_t base = (raw + 1023u) & ~1023u;
  char* gbase = reinterpret_cast<char*>(smem_tc) + (base - raw);
  const uint32_t k_s = base, v_s = base + L::kTile;
  float* pd = reinterpret_cast<float*>(gbase + L::kPd);

  const Item item = load_item(items, blockIdx.x);
  const int hk = item.bh % Hkv, b = item.bh / Hkv;
  const int group = Hq / Hkv;
  const int k0 = item.kt * kTcBK;
  const size_t kv_base = static_cast<size_t>(item.bh) * Skv;

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, tl = tid & 127;
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int kw0 = k0 + warp * 16;  // this warp's first key

  // unit u's Q, dO, lse and delta into stage s, copied by the kT threads
  // from ``t0`` on
  auto load_unit = [&](auto kT, int t0, int u, int s) {
    const int hh = u / item.n_band;
    const int q0 = (item.qt0 + u % item.n_band) * kTcBQ;
    const size_t row_base =
        (static_cast<size_t>(b) * Hq + hk * group + hh) * Sq;
    const uint32_t qs = base + 2 * L::kTile + s * L::kStage;
    constexpr int kN = decltype(kT)::value;
    const int t = tid - t0;
    load_tile_tc<D, kTcBQ, kN>(qs, q + row_base * D, q0, Sq, t);
    load_tile_tc<D, kTcBQ, kN>(qs + L::kTile, dout + row_base * D, q0, Sq,
                               t);
    if (t < 2 * kTcBQ) {
      const int r = t & (kTcBQ - 1), qi = q0 + r;
      const float* src = (t < kTcBQ ? lse : delta) + row_base +
                         (qi < Sq ? qi : 0);
      cp_async4(base + L::kRows + s * 2 * kTcBQ * 4 + 4 * t, src, qi < Sq);
    }
  };

  load_tile_tc<D, kTcBK>(k_s, k + kv_base * D, k0, kv_len);
  load_tile_tc<D, kTcBK>(v_s, v + kv_base * D, k0, kv_len);
  load_unit(std::integral_constant<int, kThreads>(), 0, item.u0, 0);
  cp_async_commit();

  // warpgroup 0: dV; warpgroup 1: dK.  Element e of column group dt
  // (acc[4 dt + e]): key k0 + 16 warp + g + 8 (e / 2), column
  // 8 dt + 2 t4 + e % 2.
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  // S^T's A operand is K and dP^T's V (K-major); B is Q or dO (K-major)
  const uint64_t a_desc = sw128_desc(wg == 0 ? k_s : v_s, 16, 1024);

  for (int u = item.u0; u < item.u1; ++u) {
    const int s = (u - item.u0) & 1;
    cp_async_wait<0>();
    // this thread's copies, made visible to the tensor cores' reads
    async_fence();
    __syncthreads();  // unit u has landed; stage s ^ 1 is free

    const int q0 = (item.qt0 + u % item.n_band) * kTcBQ;
    const uint32_t q_st = base + 2 * L::kTile + s * L::kStage;
    const uint32_t do_st = q_st + L::kTile;
    const float* rows =
        reinterpret_cast<const float*>(gbase + L::kRows + s * 2 * kTcBQ * 4);
    // does the band's edge (Sq, kv_len, the causal diagonal, the window's
    // start) cross this warp's 16 keys x 64 queries
    bool edge = q0 + kTcBQ > Sq || kw0 + 16 > kv_len;
    if (causal) edge = edge || q0 < kw0 + 15;
    if (window > 0) edge = edge || q0 + kTcBQ - 1 - kw0 >= window;

    // warpgroup 1, which waits for warpgroup 0's exponentials below, copies
    // unit u + 1 first
    if (wg == 1) {
      if (u + 1 < item.u1)
        load_unit(std::integral_constant<int, 128>(), 128, u + 1, s ^ 1);
      cp_async_commit();
    }

    // element i: key kw0 + g + 8 ((i / 2) % 2), query q0 + 8 (i / 4) +
    // 2 t4 + i % 2
    float st[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = 0.f;
    const uint64_t b_desc = sw128_desc(wg == 0 ? q_st : do_st, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(st, a_desc + kstep<kTcBK>(kk), b_desc + kstep<kTcBQ>(kk));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(st);

    // the product's A operand as hi + lo bf16 terms (split_bf16)
    uint32_t ah[kTcBQ / 16][4], al[kTcBQ / 16][4];
    if (wg == 0) {
      const float* lse_r = rows;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = 8 * (i >> 2) + 2 * t4 + (i & 1);
        float dcap;
        const float x = cap_score(st[i] * sm_scale, softcap, inv_cap, dcap);
        bool ok = true;
        if (edge) {
          const int qi = q0 + c, kj = kw0 + g + 8 * ((i >> 1) & 1);
          ok = qi < Sq && kj < kv_len;
          if (causal) ok = ok && qi >= kj;
          if (window > 0) ok = ok && (qi - kj) < window;
        }
        const float p = ok ? expf(x - lse_r[c]) : 0.f;
        pd[i * 128 + tl] = p * dcap * sm_scale;
        st[i] = p;
      }
      pd_arrive();
#pragma unroll
      for (int j = 0; j < kTcBQ / 16; ++j)
#pragma unroll
        for (int f = 0; f < 4; ++f)
          split_bf16(st[8 * j + 2 * f], st[8 * j + 2 * f + 1], ah[j][f],
                     al[j][f]);
    } else {
      const float* delta_r = rows + kTcBQ;
      pd_wait();
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = 8 * (i >> 2) + 2 * t4 + (i & 1);
        st[i] = pd[i * 128 + tl] * (st[i] - delta_r[c]);
      }
#pragma unroll
      for (int j = 0; j < kTcBQ / 16; ++j)
#pragma unroll
        for (int f = 0; f < 4; ++f)
          split_bf16(st[8 * j + 2 * f], st[8 * j + 2 * f + 1], ah[j][f],
                     al[j][f]);
    }
    // dV += P^T dO (warpgroup 0), dK += dS^T Q (warpgroup 1): B is MN-major,
    // 64-column blocks kTcBQ * 128 bytes apart, 8-row groups 1 KB apart
    const uint64_t mn_desc =
        sw128_desc(wg == 0 ? do_st : q_st, kTcBQ * 128, 1024);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kTcBQ / 16; ++j) {
      wgmma_rs(acc, ah[j], mn_desc + ((j * 16 * 128) >> 4));
      wgmma_rs(acc, al[j], mn_desc + ((j * 16 * 128) >> 4));
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(acc);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r, kj = k0 + row;
    if (item.slot < 0) {
      if (kj >= Skv) continue;
      __nv_bfloat16* out = (wg == 0 ? dv : dk) + (kv_base + kj) * D + 2 * t4;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * dt) =
            __floats2bfloat162_rn(acc[4 * dt + 2 * r],
                                  acc[4 * dt + 2 * r + 1]);
    } else {
      float* out = ws + static_cast<size_t>(item.slot) * 2 * kTcBK * D +
                   (wg == 0 ? kTcBK * D : 0) + row * D + 2 * t4;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
        *reinterpret_cast<float2*>(out + 8 * dt) =
            make_float2(acc[4 * dt + 2 * r], acc[4 * dt + 2 * r + 1]);
    }
  }
}

// dQ of 128 query rows of one (b, q head), 64 a warpgroup
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int Hq, int Hkv,
                          int Sq, int Skv, int causal, int window,
                          int kv_len, float softcap, float sm_scale) {
  using L = DqTiles<D>;
  constexpr int kBKq = L::kBK;
  constexpr int kNT = kBKq / 8;  // 8-key column groups of S and dP
  constexpr int kDT = D / 8;     // 8-column groups of dQ
  extern __shared__ uint4 smem_tc[];
  const uint32_t q_s =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_tc)) + 1023u) &
      ~1023u;
  const uint32_t do_s = q_s + L::kQ;
  const uint32_t kv_s = do_s + L::kQ;  // stage t: K, then V

  // the grid's slow axis walks the query tiles from the last one down
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcRowsQ;
  const int h = blockIdx.x % Hq, b = blockIdx.x / Hq;
  const int hk = h / (Hq / Hkv);
  const size_t row_base = (static_cast<size_t>(b) * Hq + h) * Sq;
  const __nv_bfloat16* kh = k + (static_cast<size_t>(b) * Hkv + hk) * Skv * D;
  const __nv_bfloat16* vh = v + (static_cast<size_t>(b) * Hkv + hk) * Skv * D;

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int gq0 = q0 + wg * 64;     // this warpgroup's first query row
  const int wq0 = gq0 + warp * 16;  // this warp's first query row

  // key tiles that hold a visible key for some row of this query tile
  int k_hi = kv_len;
  if (causal) k_hi = min(k_hi, q0 + kTcRowsQ);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int kt0 = k_lo / kBKq;
  const int n_kt = max(0, (k_hi + kBKq - 1) / kBKq - kt0);

  load_tile_tc<D, kTcRowsQ>(q_s, q + row_base * D, q0, Sq);
  load_tile_tc<D, kTcRowsQ>(do_s, dout + row_base * D, q0, Sq);
  if (n_kt > 0) {
    load_tile_tc<D, kBKq>(kv_s, kh, kt0 * kBKq, kv_len);
    load_tile_tc<D, kBKq>(kv_s + L::kKV, vh, kt0 * kBKq, kv_len);
  }
  cp_async_commit();

  // rows g and g + 8 of this warp: lse and delta
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = wq0 + g + 8 * r;
    lr[r] = qi < Sq ? lse[row_base + qi] : 0.f;
    dr[r] = qi < Sq ? delta[row_base + qi] : 0.f;
  }

  // element e of column group dt (acc[4 dt + e]): row wq0 + g + 8 (e / 2),
  // column 8 dt + 2 t4 + e % 2
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  const uint64_t q_desc = sw128_desc(q_s + wg * 64 * 128, 16, 1024);
  const uint64_t do_desc = sw128_desc(do_s + wg * 64 * 128, 16, 1024);

  for (int it = 0; it < n_kt; ++it) {
    const int k0 = (kt0 + it) * kBKq;
    const uint32_t ks = kv_s + (it & 1) * 2 * L::kKV, vs = ks + L::kKV;
    cp_async_wait<0>();
    async_fence();
    __syncthreads();  // tile it has landed; the other stage is free
    if (it + 1 < n_kt) {
      const uint32_t nks = kv_s + ((it + 1) & 1) * 2 * L::kKV;
      load_tile_tc<D, kBKq>(nks, kh, k0 + kBKq, kv_len);
      load_tile_tc<D, kBKq>(nks + L::kKV, vh, k0 + kBKq, kv_len);
    }
    cp_async_commit();

    // does some row of this warpgroup see a key of this tile (the products
    // are warpgroup-wide), and does the band's edge cross this warp's rows
    bool live = gq0 < Sq, edge = k0 + kBKq > kv_len || wq0 + 16 > Sq;
    if (causal) {
      live = live && k0 <= gq0 + 63;
      edge = edge || k0 + kBKq - 1 > wq0;
    }
    if (window > 0) {
      live = live && gq0 - (k0 + kBKq - 1) < window;
      edge = edge || wq0 + 15 - k0 >= window;
    }
    if (!live) continue;

    // element i of S and dP: row wq0 + g + 8 ((i / 2) % 2), key
    // k0 + 8 (i / 4) + 2 t4 + i % 2
    float s[kNT * 4], dp[kNT * 4];
#pragma unroll
    for (int i = 0; i < kNT * 4; ++i) s[i] = dp[i] = 0.f;
    const uint64_t k_desc = sw128_desc(ks, 16, 1024);
    const uint64_t v_desc = sw128_desc(vs, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if constexpr (kBKq == 32) {
        wgmma_ss_n32(s, q_desc + kstep<kTcRowsQ>(kk),
                     k_desc + kstep<kBKq>(kk));
        wgmma_ss_n32(dp, do_desc + kstep<kTcRowsQ>(kk),
                     v_desc + kstep<kBKq>(kk));
      } else {
        wgmma_ss_n64(s, q_desc + kstep<kTcRowsQ>(kk),
                     k_desc + kstep<kBKq>(kk));
        wgmma_ss_n64(dp, do_desc + kstep<kTcRowsQ>(kk),
                     v_desc + kstep<kBKq>(kk));
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);
    reg_fence(dp);

#pragma unroll
    for (int i = 0; i < kNT * 4; ++i) {
      const int r = (i >> 1) & 1;
      float dcap;
      const float x = cap_score(s[i] * sm_scale, softcap, inv_cap, dcap);
      bool ok = true;
      if (edge) {
        const int qi = wq0 + g + 8 * r;
        const int kj = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        ok = qi < Sq && kj < kv_len;
        if (causal) ok = ok && qi >= kj;
        if (window > 0) ok = ok && (qi - kj) < window;
      }
      const float p = ok ? expf(x - lr[r]) : 0.f;
      s[i] = p * dcap * sm_scale * (dp[i] - dr[r]);
    }
    // dQ += dS K, 16 keys a step: dS's column groups 2j and 2j + 1 are the
    // A fragment, as dS_hi + dS_lo; K is MN-major, 64-column blocks
    // kBKq * 128 bytes apart
    uint32_t ah[kBKq / 16][4], al[kBKq / 16][4];
#pragma unroll
    for (int j = 0; j < kBKq / 16; ++j)
#pragma unroll
      for (int f = 0; f < 4; ++f)
        split_bf16(s[8 * j + 2 * f], s[8 * j + 2 * f + 1], ah[j][f],
                   al[j][f]);
    const uint64_t kmn_desc = sw128_desc(ks, kBKq * 128, 1024);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBKq / 16; ++j) {
      wgmma_rs(acc, ah[j], kmn_desc + ((j * 16 * 128) >> 4));
      wgmma_rs(acc, al[j], kmn_desc + ((j * 16 * 128) >> 4));
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(acc);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = wq0 + g + 8 * r;
    if (qi >= Sq) continue;
    __nv_bfloat16* out = dq + (row_base + qi) * D + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * dt) =
          __floats2bfloat162_rn(acc[4 * dt + 2 * r], acc[4 * dt + 2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// The work list of the dK/dV pass and its reduction (schedule.py)
struct Plan {
  const int* items;
  int n_items;
  const int* red_tiles;
  const int* red_ptr;
  const int* red_slots;
  int n_red;
  float* ws;
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* lse, const void* dout, void* dq, void* dk, void* dv,
           void* delta, int B, int Hq, int Hkv, int Sq, int Skv, int causal,
           int window, int kv_len, float softcap, float sm_scale,
           const Plan& plan, cudaStream_t stream) {
  constexpr bool kTc = sizeof(T) == 2;
  constexpr int BK = kTc ? kTcBK : kBK;
  const int n_kt = (Skv + BK - 1) / BK;
  const int rows_q = kTc ? kTcRowsQ : kBQ;
  const int n_qt = (Sq + rows_q - 1) / rows_q;
  if (n_qt > 65535 || static_cast<long long>(B) * Hq > 0x7fffffffLL ||
      static_cast<long long>(B) * Hkv * n_kt > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  T* tdq = static_cast<T*>(dq);
  T* tdk = static_cast<T*>(dk);
  T* tdv = static_cast<T*>(dv);
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
  if (plan.n_items > 0) {
    if constexpr (kTc) {
      if ((err = allow_smem(attn_bwd_dkdv_tc_kernel<D>,
                            DkdvTiles<D>::kBytes)) != cudaSuccess)
        return static_cast<int>(err);
      attn_bwd_dkdv_tc_kernel<D><<<plan.n_items, kThreads,
                                   DkdvTiles<D>::kBytes, stream>>>(
          tq, tk, tv, tdo, flse, fdelta, plan.items, plan.ws, tdk, tdv, Hq,
          Hkv, Sq, Skv, causal, window, kv_len, softcap, sm_scale);
    } else {
      if ((err = allow_smem(attn_bwd_dkdv_f32_kernel<D>,
                            Smem<D>::kBytes)) != cudaSuccess)
        return static_cast<int>(err);
      attn_bwd_dkdv_f32_kernel<D><<<plan.n_items, kThreads, Smem<D>::kBytes,
                                    stream>>>(
          tq, tk, tv, tdo, flse, fdelta, plan.items, plan.ws, tdk, tdv, Hq,
          Hkv, Sq, Skv, causal, window, kv_len, softcap, sm_scale);
    }
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  if (plan.n_red > 0) {
    const long long n = static_cast<long long>(plan.n_red) * 2 * BK * D / 4;
    const long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    attn_bwd_reduce_kernel<T, D, BK><<<static_cast<unsigned>(blocks),
                                       kThreads, 0, stream>>>(
        plan.ws, plan.red_tiles, plan.red_ptr, plan.red_slots, tdk, tdv, n_kt,
        Skv, n);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  if (Sq > 0) {
    if constexpr (kTc) {
      if ((err = allow_smem(attn_bwd_dq_tc_kernel<D>, DqTiles<D>::kBytes)) !=
          cudaSuccess)
        return static_cast<int>(err);
      attn_bwd_dq_tc_kernel<D><<<dim3(B * Hq, n_qt), kThreads,
                                 DqTiles<D>::kBytes, stream>>>(
          tq, tk, tv, tdo, flse, fdelta, tdq, Hq, Hkv, Sq, Skv, causal,
          window, kv_len, softcap, sm_scale);
    } else {
      if ((err = allow_smem(attn_bwd_dq_f32_kernel<D>, Smem<D>::kBytes)) !=
          cudaSuccess)
        return static_cast<int>(err);
      attn_bwd_dq_f32_kernel<D><<<dim3(B * Hq, n_qt), kThreads,
                                  Smem<D>::kBytes, stream>>>(
          tq, tk, tv, tdo, flse, fdelta, tdq, Hq, Hkv, Sq, Skv, causal,
          window, kv_len, softcap, sm_scale);
    }
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
                 float softcap, float sm_scale, const Plan& plan,
                 cudaStream_t stream) {
  if (dtype == 0)
    return launch<float, D>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, Hq,
                            Hkv, Sq, Skv, causal, window, kv_len, softcap,
                            sm_scale, plan, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, D>(q, k, v, o, lse, dout, dq, dk, dv,
                                    delta, B, Hq, Hkv, Sq, Skv, causal,
                                    window, kv_len, softcap, sm_scale, plan,
                                    stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  kv_len must be at most Skv.  ``delta`` is
// (B, Hq, Sq) float32 scratch.  The dK/dV pass's work list comes last:
// ``items`` (n_items x 8 int32), the reduced tiles ``red_tiles`` (n_red),
// their slot ranges ``red_ptr`` (n_red + 1) into ``red_slots``, and the
// float32 workspace ``ws`` (a slot 2 x key tile x D), as
// kernels/flash_attention/schedule.py builds them for this shape and dtype
// (key tiles of 64 in bfloat16, 32 in float32).  Writes every element of
// dq, dk and dv.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* lse, const void* dout,
                        void* dq, void* dk, void* dv, void* delta, int B,
                        int Hq, int Hkv, int Sq, int Skv, int D, int dtype,
                        int causal, int window, int kv_len, float softcap,
                        float sm_scale, void* stream, const int* items,
                        int n_items, const int* red_tiles, const int* red_ptr,
                        const int* red_slots, int n_red, float* ws) {
  if (B <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || B > 65535 || Hq > 65535 || Sq < 0 ||
      Skv < 0 || kv_len < 0 || kv_len > Skv || n_items < 0 || n_red < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan{items, n_items, red_tiles, red_ptr, red_slots, n_red, ws};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dtype<64>(dtype, q, k, v, o, lse, dout, dq, dk, dv, delta,
                              B, Hq, Hkv, Sq, Skv, causal, window, kv_len,
                              softcap, sm_scale, plan, s);
    case 128:
      return launch_dtype<128>(dtype, q, k, v, o, lse, dout, dq, dk, dv,
                               delta, B, Hq, Hkv, Sq, Skv, causal, window,
                               kv_len, softcap, sm_scale, plan, s);
    case 256:
      return launch_dtype<256>(dtype, q, k, v, o, lse, dout, dq, dk, dv,
                               delta, B, Hq, Hkv, Sq, Skv, causal, window,
                               kv_len, softcap, sm_scale, plan, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Flash-attention forward for Hopper (sm_90a): blocked online softmax with
// GQA, causal masking, a sliding window, tanh softcap and a kv_len bound.
//
// Replaces the TPU kernel of repro/kernels/flash_attention/kernel.py:
//   flash_attention <- flash_attention / _attn_kernel (kernel.py:99, :35)
//
// Layout (the reference's): q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D),
// contiguous, float32 or bfloat16; out (B, Hq, Sq, D) in q's dtype.  Query
// head h reads KV head h / (Hq / Hkv).  Query i sees key j when j < kv_len,
// i >= j (causal) and i - j < window (window > 0), with absolute indices
// from 0 for both, as the reference masks.
//
// Two kernels behind one entry point, chosen by dtype:
//
// * bfloat16 (the served path): attn_bf16_kernel, on the tensor cores.
// * float32 (the float32 oracle of the LM and the float32 tests):
//   attn_f32_kernel, on the CUDA cores, exact float32 products.
//
// Both follow the TPU kernel's schedule: the TPU walks the key blocks of
// one (b, h, q block) in order on one core and carries (acc, m, l) in VMEM
// scratch; here one thread block owns one (b, h, query tile) and a loop
// over key tiles (64 keys in bf16, 32 in float32) takes the place of that
// sequential grid dimension, with (acc, m, l) in registers.  Key tiles
// wholly outside the causal / window band or past kv_len are never loaded,
// as the reference's ``needed`` skips them.  Numerics are the reference's:
// scores scaled by sm_scale in float32, the softcap as softcap *
// tanhf(x / softcap) (tanhf, not a fast approximation; x / softcap
// correctly rounded), expf, a masked score -inf whose exp is exactly 0, a
// running max that starts at NEG_INF = -1e30, a row with no visible key
// (l = 0) written as 0, and the output rounded once.
//
// When ``lse`` is not null, both kernels also write each row's log-sum-exp
// over the scaled, softcapped, masked scores, m + logf(l), once after the
// key loop (lse (B, Hq, Sq) float32, for the backward of
// flash_attention_bwd.cu); a row with no visible key gets +inf, so that
// exp(x - lse) is exactly 0 for every key.  A null ``lse`` leaves the
// kernels as they were but for one untaken branch a row.
//
// ---- bfloat16: tensor cores (wgmma, FlashAttention-3's products) -------
//
// Bound on this card: operations.  The scores and P·V are 4·D flops per
// visible (q, k) pair on the tensor cores (989 TFLOP/s bf16 dense); the
// inputs are read once per 128-row query tile.  Besides the products,
// every score takes a float32 scale, softcap (tanhf, and a division done
// as a product and two fmas), max, expf and sum on the CUDA cores.
//
// A block of 2 warpgroups (8 warps) owns 128 query rows, 64 a warpgroup,
// 16 a warp.  Per 64-key tile, each warpgroup:
// * S = Q·Kᵀ: D / 16 wgmma.m64n64k16 (bf16 operands, float32
//   accumulators), Q and K read by the tensor cores from shared memory
//   through matrix descriptors.  A warp's S is 16 x 64: 32 floats a
//   thread, rows g and g + 8 (g = lane / 4), columns 2 (lane % 4) + {0, 1}
//   of each 8-key group.
// * The online softmax runs on those accumulator fragments: a row's max
//   and sum reduce over the 4 lanes that share it (shuffles by 1 and 2);
//   l is kept per lane and reduced once at the end.  The mask is applied
//   only where a warp's 16 x 64 block crosses the causal diagonal, the
//   window's edge or kv_len; a tile wholly outside a warpgroup's band is
//   skipped.
// * O += P·V: 4 wgmma.m64nDk16 of the register-A form.  The accumulator
//   layout of two 8-key groups is the A fragment of one 16-key step, so P
//   is converted in registers and never goes through shared memory.  P is
//   carried as two bf16 terms, P_hi = bf16(P) and P_lo = bf16(P - P_hi),
//   each multiplied into O: a single bf16 rounding of P moved outputs near
//   0 by more than the phase-5 gate (atol 1e-3) allows.  l is the float32
//   sum of the unrounded P.
// * O (16 x D a warp, D / 2 floats a thread: 128 at D = 256) stays in
//   registers; 8 warps a block leave 255 registers a thread.
// Warpgroup 1 issues its score products once warpgroup 0's are done (a
// named barrier), so one warpgroup's softmax runs beside the other's
// products.
//
// Tiles stay bf16 in shared memory: Q (128 x D) and a 2-stage ring of K
// and V (64 x D each), 192 KB at D = 256, 96 KB at 128, 48 KB at 64.  They
// arrive by cp.async.cg, 16 B a thread, rows past Sq (Q) or kv_len (K, V)
// zero-filled; tile t + 1's copy is issued before tile t's products.  The
// layout is the one wgmma reads with 128-byte swizzling (``sw128``), which
// also keeps each 8-row phase of the copies free of bank conflicts.
// Query tiles launch longest first (the grid's slow axis walks them from
// the last, most causal work, down), so the causal tail balances across
// the SMs.
//
// ---- float32: CUDA cores -----------------------------------------------
//
// Bound on this card: operations, on the CUDA cores (67 TFLOP/s float32;
// a TF32 product would not hold the float32 gates): 4·D flops per visible
// (q, k) pair, two fmas a pair and column.  Measured on an H100 at
// gemma2-9b's shapes (tools/attention_variants.py), each of the two
// products runs at about two thirds of the fma rate however its shared
// loads are laid out (0.19 or 0.5 floats loaded an fma, 8 or 16 warps an
// SM), and everything else (copies, barriers, the softmax's tanhf and
// expf) takes about a sixth of the time.  The design:
//
// * A block of 8 warps owns 128 query rows, 16 a warp, and a loop walks
//   32-key tiles.  A warp owns whole rows, so the online softmax and P stay
//   inside it: P goes through a warp-private strip of shared memory with
//   __syncwarp, no block barrier.
// * Scores: the head dims are split in two: lane (kg, rg, hf) = (lane % 8,
//   lane / 8 % 2, lane / 16) sums an 8 x 4 tile (rows rg + 2 i, keys
//   kg + 8 j) of its warp's 16 x 32 block over half of them, 12 floats
//   loaded for 32 fmas (a 4 x 4 tile over all of them loads 16 for 32),
//   and one shuffle joins the halves; each half then keeps 4 of the 8 rows
//   for the softmax.  A step reads float2s of Q and K, stored row-major
//   with rows padded by 4 floats: a half warp reads 2 rows of Q and 8 of K
//   on distinct banks.
// * P·V: lane (cg, ro) = (lane % 16, lane / 16) owns 8 rows (ro + 2 i) x
//   D/4 columns (4 cg + 64 jj + {0..3}) of O: per 4 keys a float4 of P for
//   each row and, per key, D/64 float4 of V.  Each row's alpha (and, at the
//   end, l) passes from the score lanes to these through the warp's strip.
//   The loop over keys is not unrolled: unrolled, the D = 256 kernel
//   spills.
// * cp.async.cg, 16 B a thread, one K and one V buffer: V_t is issued
//   before S_t's products and K_{t+1} as soon as every warp is done with
//   K_t, so each copy lands during the other product; two barriers a tile.
//   Rows past Sq (Q) or kv_len (K, V) are zero-filled.  Shared memory:
//   Q 128 x (D + 4), K 32 x (D + 4), V 32 x D, and a warp's P 16 x 36 with
//   16 alphas and 16 ls, 218,624 bytes at D = 256.
// * A warp skips a tile none of its rows sees; the mask is applied only
//   where the causal diagonal, the window's start or kv_len crosses the
//   warp's 16 x 32 block.  Query tiles launch longest first.
// * The row max is shared by a row's 8 lanes (3 shuffles); l is kept per
//   lane and summed once at the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tc.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBQ = 128;                  // query rows per block
constexpr int kBK = 32;                   // keys per tile
constexpr int kWarpRows = 16;             // query rows per warp
constexpr int kWarps = kBQ / kWarpRows;
constexpr int kThreads = 32 * kWarps;
constexpr int kPStride = kBK + 4;         // floats a row of a warp's P
static_assert(kWarpRows == 16 && kBK == 32, "the lane layouts below");

template <int D>
struct Tiles {
  static constexpr int kStride = D + 4;   // Q and K rows, padded
  static constexpr int kQ = kBQ * kStride;
  static constexpr int kK = kBK * kStride;
  static constexpr int kV = kBK * D;
  // a warp's P (16 x kPStride), then its rows' alpha and l
  static constexpr int kWarpScratch = kWarpRows * kPStride + 2 * kWarpRows;
  static constexpr int kScratch = kWarps * kWarpScratch;
  static constexpr size_t kBytes =
      sizeof(float) * (kQ + kK + kV + kScratch);
  static_assert(kBytes <= 232448, "over the 227 KB a block can use");
};

// kRows rows of a float32 head slice from row ``row0`` into a tile of row
// stride ``kDst`` floats at shared address ``dst``, 16 B a copy; rows at or
// past ``n_rows`` are zero-filled (their source address is the slice's
// first row, which is never read).
template <int D, int kRows, int kDst>
__device__ __forceinline__ void copy_rows(uint32_t dst,
                                          const float* __restrict__ src,
                                          int row0, int n_rows) {
  constexpr int kChunks = D / 4;
  static_assert(kRows * kChunks % kThreads == 0, "whole copies a thread");
#pragma unroll
  for (int it = 0; it < kRows * kChunks / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int r = i / kChunks, c = i % kChunks;
    const bool in = row0 + r < n_rows;
    cp_async16(dst + 4u * static_cast<uint32_t>(r * kDst + 4 * c),
               src + (in ? static_cast<size_t>(row0 + r) * D + 4 * c : 0),
               in);
  }
}

__device__ __forceinline__ float elem(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    int Hq, int Hkv, int Sq, int Skv, int causal, int window,
                    int kv_len, float softcap, float sm_scale,
                    float* __restrict__ lse) {
  using T = Tiles<D>;
  constexpr int kStride = T::kStride;
  constexpr int kHalf = D / 2;        // head dims of a lane's partial scores
  constexpr int kGroups = D / 64;     // float4 column groups of O a lane owns
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + T::kQ;
  float* Vs = Ks + T::kK;
  const uint32_t qs_s = static_cast<uint32_t>(__cvta_generic_to_shared(Qs));
  const uint32_t ks_s = qs_s + 4u * T::kQ, vs_s = ks_s + 4u * T::kK;

  // the grid's slow axis walks the query tiles from the last one down
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int h = blockIdx.x % Hq, b = blockIdx.x / Hq;
  const int hk = h / (Hq / Hkv);
  const float* qh = q + (static_cast<size_t>(b) * Hq + h) * Sq * D;
  const float* kh = k + (static_cast<size_t>(b) * Hkv + hk) * Skv * D;
  const float* vh = v + (static_cast<size_t>(b) * Hkv + hk) * Skv * D;

  // Scores: lane (kg, rg, hf) = (lane % 8, lane / 8 % 2, lane / 16) sums
  // rows rg + 2 i (i < 8) x keys kg + 8 j (j < 4) of its warp's 16 x 32
  // block over head dims [hf D/2, (hf + 1) D/2); one shuffle joins the two
  // halves, and lane hf keeps rows i = 4 hf + i' (i' < 4) for the softmax.
  // P V: lane (cg, ro) = (lane % 16, lane / 16) owns rows ro + 2 i (i < 8)
  // of O at columns 4 cg + 64 jj + {0..3} (jj < D / 64).  Row rg + 2 i's
  // alpha and l pass between the two layouts at [8 rg + i] of the warp's
  // scratch.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kg = lane & 7, rg = (lane >> 3) & 1, hf = lane >> 4;
  const int cg = lane & 15, ro = lane >> 4;
  const int wq0 = q0 + warp * kWarpRows;
  float* Ps = Vs + T::kV + warp * T::kWarpScratch;
  float* alpha_s = Ps + kWarpRows * kPStride;
  float* l_s = alpha_s + kWarpRows;
  const float* qrow = Qs + (warp * kWarpRows + rg) * kStride + hf * kHalf;
  const float* krow = Ks + kg * kStride + hf * kHalf;

  // key tiles that hold a visible key for some row of this query tile
  int k_hi = kv_len;
  if (causal) k_hi = min(k_hi, q0 + kBQ);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int kt0 = k_lo / kBK;
  const int n_kt = max(0, (k_hi + kBK - 1) / kBK - kt0);

  copy_rows<D, kBQ, kStride>(qs_s, qh, q0, Sq);
  if (n_kt > 0) copy_rows<D, kBK, kStride>(ks_s, kh, kt0 * kBK, kv_len);
  cp_async_commit();

  float acc[8][4 * kGroups];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4 * kGroups; ++c) acc[i][c] = 0.f;
  float m[4], l[4];  // the softmax rows rg + 2 (4 hf + i')
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  for (int it = 0; it < n_kt; ++it) {
    const int k0 = (kt0 + it) * kBK;
    cp_async_wait<0>();
    __syncthreads();  // K_t has landed; every warp is done with V_{t-1}
    copy_rows<D, kBK, D>(vs_s, vh, k0, kv_len);  // lands during S_t
    cp_async_commit();

    // does a row of this warp see a key of this tile, and does the band's
    // edge (causal diagonal, window start, kv_len) cross the warp's rows
    bool live = wq0 < Sq, edge = k0 + kBK > kv_len;
    if (causal) {
      live = live && k0 <= wq0 + kWarpRows - 1;
      edge = edge || k0 + kBK - 1 > wq0;
    }
    if (window > 0) {
      live = live && wq0 - (k0 + kBK - 1) < window;
      edge = edge || wq0 + kWarpRows - 1 - k0 >= window;
    }

    float sm[4][4];  // the softmax rows' scores at keys kg + 8 j
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sm[i][j] = 0.f;
    if (live) {
      // S = Q K^T over this lane's half of the head dims: each step reads
      // a float2 of 8 rows and of 4 keys for 64 fmas
      float s[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < kHalf; d += 2) {
        float2 qv[8], kv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          qv[i] = *reinterpret_cast<const float2*>(qrow + 2 * i * kStride + d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] = *reinterpret_cast<const float2*>(krow + 8 * j * kStride + d);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          }
      }
      // the two halves meet: lane hf sends the rows it does not keep
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float mine = hf ? s[4 + i][j] : s[i][j];
          const float sent = hf ? s[i][j] : s[4 + i][j];
          sm[i][j] = mine + __shfl_xor_sync(kFull, sent, 16);
        }
    }
    cp_async_wait<0>();
    __syncthreads();  // V_t has landed; every warp is done with K_t
    if (it + 1 < n_kt)  // K_{t+1} lands during this tile's softmax and P V
      copy_rows<D, kBK, kStride>(ks_s, kh, k0 + kBK, kv_len);
    cp_async_commit();
    if (!live) continue;

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = sm[i][j] * sm_scale;
        if (softcap > 0.f) {
          // x / softcap, correctly rounded without a division: the
          // quotient through the rounded reciprocal, corrected once by its
          // exact (fma) residual (Markstein)
          const float q1 = x * inv_cap;
          x = softcap * tanhf(fmaf(fmaf(-softcap, q1, x), inv_cap, q1));
        }
        sm[i][j] = x;
      }
    if (edge) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qi = wq0 + rg + 2 * (4 * hf + i), kj = k0 + kg + 8 * j;
          bool ok = kj < kv_len;
          if (causal) ok = ok && qi >= kj;
          if (window > 0) ok = ok && (qi - kj) < window;
          if (!ok) sm[i][j] = -INFINITY;
        }
    }

    // online softmax: a row's 8 lanes (lane bits 0-2) share its max; l is
    // kept per lane and summed once at the end
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) mx = fmaxf(mx, sm[i][j]);
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 4));
      const int r = rg + 2 * (4 * hf + i);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sm[i][j] - mx);  // 0 for a masked score
        sum += p;
        Ps[r * kPStride + kg + 8 * j] = p;
      }
      const float alpha = expf(m[i] - mx);
      l[i] = l[i] * alpha + sum;
      m[i] = mx;
      if (kg == 0) alpha_s[8 * rg + 4 * hf + i] = alpha;
    }
    __syncwarp();

    const float4 a_lo = *reinterpret_cast<const float4*>(alpha_s + 8 * ro);
    const float4 a_hi = *reinterpret_cast<const float4*>(alpha_s + 8 * ro + 4);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a = elem(i < 4 ? a_lo : a_hi, i & 3);
#pragma unroll
      for (int c = 0; c < 4 * kGroups; ++c) acc[i][c] *= a;
    }

    // O += P V: per 4 keys, a float4 of P for each of the lane's 8 rows and,
    // per key, kGroups float4 of V (8 distinct a quarter warp)
#pragma unroll 1
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 p4[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        p4[i] = *reinterpret_cast<const float4*>(Ps + (ro + 2 * i) * kPStride +
                                                 kk);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* vrow = Vs + (kk + t) * D + 4 * cg;
#pragma unroll
        for (int jj = 0; jj < kGroups; ++jj) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + 64 * jj);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float p = elem(p4[i], t);
            acc[i][4 * jj + 0] = fmaf(p, vv.x, acc[i][4 * jj + 0]);
            acc[i][4 * jj + 1] = fmaf(p, vv.y, acc[i][4 * jj + 1]);
            acc[i][4 * jj + 2] = fmaf(p, vv.z, acc[i][4 * jj + 2]);
            acc[i][4 * jj + 3] = fmaf(p, vv.w, acc[i][4 * jj + 3]);
          }
        }
      }
    }
    __syncwarp();  // P and alpha are read before the next tile writes them
  }
  cp_async_wait<0>();

  // each row's l, summed over its 8 lanes, to the P V lanes
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lr = l[i];
    lr += __shfl_xor_sync(kFull, lr, 1);
    lr += __shfl_xor_sync(kFull, lr, 2);
    lr += __shfl_xor_sync(kFull, lr, 4);
    if (kg == 0) l_s[8 * rg + 4 * hf + i] = lr;
    const int qi = wq0 + rg + 2 * (4 * hf + i);
    if (lse != nullptr && kg == 0 && qi < Sq)
      lse[(static_cast<size_t>(b) * Hq + h) * Sq + qi] =
          lr > 0.f ? m[i] + logf(lr) : INFINITY;
  }
  __syncwarp();
  const float4 l_lo = *reinterpret_cast<const float4*>(l_s + 8 * ro);
  const float4 l_hi = *reinterpret_cast<const float4*>(l_s + 8 * ro + 4);
  float* oh = out + (static_cast<size_t>(b) * Hq + h) * Sq * D;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qi = wq0 + ro + 2 * i;
    if (qi >= Sq) continue;
    const float lr = elem(i < 4 ? l_lo : l_hi, i & 3);
    const float safe = lr > 0.f ? lr : 1.f;
    float* orow = oh + static_cast<size_t>(qi) * D + 4 * cg;
#pragma unroll
    for (int jj = 0; jj < kGroups; ++jj)
      *reinterpret_cast<float4*>(orow + 64 * jj) =
          make_float4(acc[i][4 * jj + 0] / safe, acc[i][4 * jj + 1] / safe,
                      acc[i][4 * jj + 2] / safe, acc[i][4 * jj + 3] / safe);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int Hq, int Hkv, int Sq, int Skv, int causal, int window,
               int kv_len, float softcap, float sm_scale, float* lse,
               cudaStream_t stream) {
  const size_t smem = Tiles<D>::kBytes;
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  if (n_qt > 65535 || static_cast<long long>(B) * Hq > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      attn_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * Hq, n_qt);
  attn_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Hq, Hkv, Sq, Skv,
      causal, window, kv_len, softcap, sm_scale, lse);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcWG = 2;                  // warpgroups a block
constexpr int kTcBQ = 64 * kTcWG;         // query rows per block
constexpr int kTcBK = 64;                 // keys per tile
constexpr int kTcThreads = 128 * kTcWG;

template <int D>
struct TcTiles {
  static constexpr uint32_t kQBytes = kTcBQ * D * 2;
  static constexpr uint32_t kKVBytes = kTcBK * D * 2;  // one K or V tile
  // Q, 2 stages of K and V, and room to align the base to 1 KB
  static constexpr size_t kBytes = kQBytes + 2 * 2 * kKVBytes + 1024;
  static_assert(D % 64 == 0, "tiles are stored in 64-column blocks");
  static_assert(kBytes <= 232448, "over the 227 KB a block can use");
};

// kRows rows of a head slice from row ``row0`` into a tile at shared
// address ``dst``; rows at or past ``n_rows`` are zero-filled (their source
// address is the slice's first row, which is never read).
template <int D, int kRows>
__device__ __forceinline__ void load_tile_async(
    uint32_t dst, const __nv_bfloat16* __restrict__ src, int row0,
    int n_rows) {
  constexpr int kChunks = D / 8;
  static_assert(kRows * kChunks % kTcThreads == 0, "whole copies a thread");
#pragma unroll
  for (int it = 0; it < kRows * kChunks / kTcThreads; ++it) {
    const int i = it * kTcThreads + threadIdx.x;
    const int r = i / kChunks, c = i % kChunks;
    const bool in = row0 + r < n_rows;
    cp_async16(dst + sw128<kRows>(r, c),
               src + (in ? static_cast<size_t>(row0 + r) * D + c * 8 : 0),
               in);
  }
}

// Named barrier 1 hands the tensor cores from warpgroup 0 to warpgroup 1
// once a tile: warpgroup 0 arrives (without waiting) when its score
// products are done, or at once when it skips the tile; warpgroup 1 waits
// for that before issuing its own.  Both pass it exactly once a tile.
__device__ __forceinline__ void turn_arrive() {
  asm volatile("bar.arrive 1, %0;\n" ::"n"(kTcThreads) : "memory");
}

__device__ __forceinline__ void turn_wait() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kTcThreads) : "memory");
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    attn_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, int Hq, int Hkv, int Sq,
                     int Skv, int causal, int window, int kv_len,
                     float softcap, float sm_scale, float* __restrict__ lse) {
  constexpr uint32_t kKV = TcTiles<D>::kKVBytes;
  constexpr int kNT = kTcBK / 8;   // 8-key column groups of S
  constexpr int kDT = D / 8;       // 8-column groups of O
  extern __shared__ uint4 smem_tc[];
  // tiles start on a 1 KB boundary: the swizzle repeats every 8 rows of
  // 128 bytes, and descriptors carry no base offset
  const uint32_t q_s =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_tc)) + 1023u) &
      ~1023u;
  const uint32_t kv_s = q_s + TcTiles<D>::kQBytes;  // stage t: K, then V

  // the grid's slow axis walks the query tiles from the last one down
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcBQ;
  const int h = blockIdx.x % Hq, b = blockIdx.x / Hq;
  const int hk = h / (Hq / Hkv);
  const __nv_bfloat16* qh = q + (static_cast<size_t>(b) * Hq + h) * Sq * D;
  const __nv_bfloat16* kh = k + (static_cast<size_t>(b) * Hkv + hk) * Skv * D;
  const __nv_bfloat16* vh = v + (static_cast<size_t>(b) * Hkv + hk) * Skv * D;

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int gq0 = q0 + wg * 64;     // this warpgroup's first query row
  const int wq0 = gq0 + warp * 16;  // this warp's first query row

  // key tiles that hold a visible key for some row of this query tile
  int k_hi = kv_len;
  if (causal) k_hi = min(k_hi, q0 + kTcBQ);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int kt0 = k_lo / kTcBK;
  const int n_kt = max(0, (k_hi + kTcBK - 1) / kTcBK - kt0);

  load_tile_async<D, kTcBQ>(q_s, qh, q0, Sq);
  if (n_kt > 0) {
    load_tile_async<D, kTcBK>(kv_s, kh, kt0 * kTcBK, kv_len);
    load_tile_async<D, kTcBK>(kv_s + kKV, vh, kt0 * kTcBK, kv_len);
  }
  cp_async_commit();

  // descriptors: Q (this warpgroup's 64 rows) and K are K-major, 8-row
  // groups 1 KB apart, a 16-column step 32 bytes into the swizzled row and
  // a 64-column block kRows * 128 bytes on; V is MN-major, 64-column
  // blocks kTcBK * 128 bytes apart (leading), 8-key groups 1 KB apart
  const uint64_t q_desc = sw128_desc(q_s + wg * 64 * 128, 16, 1024);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  for (int it = 0; it < n_kt; ++it) {
    const int k0 = (kt0 + it) * kTcBK;
    const uint32_t ks = kv_s + (it & 1) * 2 * kKV, vs = ks + kKV;
    if (it + 1 < n_kt) {  // the next tile into the other stage
      const uint32_t nks = kv_s + ((it + 1) & 1) * 2 * kKV;
      load_tile_async<D, kTcBK>(nks, kh, k0 + kTcBK, kv_len);
      load_tile_async<D, kTcBK>(nks + kKV, vh, k0 + kTcBK, kv_len);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the group just issued have landed
    // this thread's copies, made visible to the tensor cores' reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // does some row of this warpgroup see a key of this tile (the products
    // are warpgroup-wide), and does the band's edge (causal diagonal,
    // window start, kv_len) cross this warp's rows
    bool live = true, edge = k0 + kTcBK > kv_len;
    if (causal) {
      live = live && k0 <= gq0 + 63;
      edge = edge || k0 + kTcBK - 1 > wq0;
    }
    if (window > 0) {
      live = live && gq0 - (k0 + kTcBK - 1) < window;
      edge = edge || wq0 + 15 - k0 >= window;
    }
    // warpgroup 1 starts its score products once warpgroup 0's are done,
    // so one warpgroup's softmax runs beside the other's products
    if (wg == 1) turn_wait();
    if (live) {
      const uint64_t k_desc = sw128_desc(ks, 16, 1024);
      const uint64_t v_desc = sw128_desc(vs, kTcBK * 128, 1024);
      float s[kNT * 4];
#pragma unroll
      for (int i = 0; i < kNT * 4; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(s,
                     q_desc + (((kk >> 2) * kTcBQ * 128 + (kk & 3) * 32) >> 4),
                     k_desc + (((kk >> 2) * kTcBK * 128 + (kk & 3) * 32) >> 4));
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(s);
      if (wg == 0) turn_arrive();

      // element e of column group nt (s[4 nt + e]): row g + 8 (e / 2), key
      // k0 + 8 nt + 2 t4 + e % 2
#pragma unroll
      for (int i = 0; i < kNT * 4; ++i) {
        float x = s[i] * sm_scale;
        if (softcap > 0.f) {
          // x / softcap, correctly rounded without a division: the
          // quotient through the rounded reciprocal, corrected once by its
          // exact (fma) residual (Markstein)
          const float q1 = x * inv_cap;
          x = softcap * tanhf(fmaf(fmaf(-softcap, q1, x), inv_cap, q1));
        }
        s[i] = x;
      }
      if (edge) {
#pragma unroll
        for (int i = 0; i < kNT * 4; ++i) {
          const int qi = wq0 + g + 8 * ((i >> 1) & 1);
          const int kj = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
          bool ok = kj < kv_len;
          if (causal) ok = ok && qi >= kj;
          if (window > 0) ok = ok && (qi - kj) < window;
          if (!ok) s[i] = -INFINITY;
        }
      }

      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          mx = fmaxf(mx, fmaxf(s[4 * nt + 2 * r], s[4 * nt + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          // 0 for a masked score
          s[4 * nt + 2 * r] = expf(s[4 * nt + 2 * r] - mx);
          s[4 * nt + 2 * r + 1] = expf(s[4 * nt + 2 * r + 1] - mx);
          sum += s[4 * nt + 2 * r] + s[4 * nt + 2 * r + 1];
        }
        alpha[r] = expf(m[r] - mx);
        l[r] = l[r] * alpha[r] + sum;  // this lane's share of the row sum
        m[r] = mx;
      }
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        acc[4 * dt + 0] *= alpha[0];
        acc[4 * dt + 1] *= alpha[0];
        acc[4 * dt + 2] *= alpha[1];
        acc[4 * dt + 3] *= alpha[1];
      }

      // O += P·V, 16 keys a step: S's column groups 2j and 2j + 1 are P's
      // A fragment, as P_hi + P_lo
      uint32_t ph[kTcBK / 16][4], pl[kTcBK / 16][4];
#pragma unroll
      for (int j = 0; j < kTcBK / 16; ++j)
#pragma unroll
        for (int f = 0; f < 4; ++f)
          split_bf16(s[8 * j + 2 * f], s[8 * j + 2 * f + 1], ph[j][f],
                     pl[j][f]);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kTcBK / 16; ++j) {
        wgmma_rs(acc, ph[j], v_desc + ((j * 16 * 128) >> 4));
        wgmma_rs(acc, pl[j], v_desc + ((j * 16 * 128) >> 4));
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(acc);
    } else if (wg == 0) {
      turn_arrive();
    }
    __syncthreads();  // this stage is free for the copy two tiles on
  }
  cp_async_wait<0>();

  __nv_bfloat16* oh = out + (static_cast<size_t>(b) * Hq + h) * Sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(kFull, lr, 1);
    lr += __shfl_xor_sync(kFull, lr, 2);
    const int qi = wq0 + g + 8 * r;
    if (qi >= Sq) continue;
    if (lse != nullptr && t4 == 0)
      lse[(static_cast<size_t>(b) * Hq + h) * Sq + qi] =
          lr > 0.f ? m[r] + logf(lr) : INFINITY;
    const float safe = lr > 0.f ? lr : 1.f;
    __nv_bfloat16* orow = oh + static_cast<size_t>(qi) * D + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * dt) =
          __floats2bfloat162_rn(acc[4 * dt + 2 * r] / safe,
                                acc[4 * dt + 2 * r + 1] / safe);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int Hq, int Hkv, int Sq, int Skv, int causal, int window,
                int kv_len, float softcap, float sm_scale, float* lse,
                cudaStream_t stream) {
  const size_t smem = TcTiles<D>::kBytes;
  const int n_qt = (Sq + kTcBQ - 1) / kTcBQ;
  if (n_qt > 65535 || static_cast<long long>(B) * Hq > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * Hq, n_qt);
  attn_bf16_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      Hq, Hkv, Sq, Skv, causal, window, kv_len, softcap, sm_scale, lse);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           int B, int Hq, int Hkv, int Sq, int Skv, int causal, int window,
           int kv_len, float softcap, float sm_scale, float* lse,
           cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window,
                         kv_len, softcap, sm_scale, lse, stream);
  if (dtype == 1)
    return launch_bf16<D>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window,
                          kv_len, softcap, sm_scale, lse, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  kv_len must be at most Skv.  ``lse``
// (B, Hq, Sq) float32 or null; it comes last, so a caller that passes it
// can also call an earlier build of this entry point, which ignores it.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int B, int Hq, int Hkv, int Sq, int Skv, int D, int dtype,
                    int causal, int window, int kv_len, float softcap,
                    float sm_scale, void* stream, float* lse) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || B > 65535 || Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(dtype, q, k, v, o, B, Hq, Hkv, Sq, Skv, causal,
                        window, kv_len, softcap, sm_scale, lse, s);
    case 128:
      return launch<128>(dtype, q, k, v, o, B, Hq, Hkv, Sq, Skv, causal,
                         window, kv_len, softcap, sm_scale, lse, s);
    case 256:
      return launch<256>(dtype, q, k, v, o, B, Hq, Hkv, Sq, Skv, causal,
                         window, kv_len, softcap, sm_scale, lse, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

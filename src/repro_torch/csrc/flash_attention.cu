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
// Work split.  The TPU kernel walks the key blocks of one (b, h, q block)
// in order on one core and carries (acc, m, l) in VMEM scratch.  Here one
// block of 256 threads owns one (b, h, 64-row query tile) and a loop over
// 64-key tiles takes the place of that sequential grid dimension.  Key
// tiles wholly outside the causal / window band or past kv_len are never
// loaded, as the reference's ``needed`` skips them.
//
// Per key tile: K and V are converted to float32 into shared memory; each
// thread computes a 4 x 4 block of scores (rows rg*4..+3, columns cg +
// 16*j) from float4 reads of Q and K; scale, softcap (tanhf, not a fast
// approximation) and mask; the row max and row sum are reduced over the 16
// threads that share the rows with shuffles; the probabilities go to shared
// memory, and each thread adds P·V into its float32 accumulator of 4 rows x
// D/16 columns (float4 groups cg*4 + 64*jj).  The running max starts at
// NEG_INF = -1e30 as in the reference; a masked score is -inf, whose exp is
// exactly 0, so it adds nothing, as the reference's where(mask, ., 0) does.
// A row with no visible key ends with l = 0 and is written as 0.
//
// Shared memory (float32 tiles, rows padded by 4 floats so that 8 threads
// reading float4 at the same column of 8 rows hit 32 distinct banks): Q, K
// and V tiles of 64 x (D + 4) and a 64 x 68 probability tile: 217,088 bytes
// at D = 256, above the 48 KB static limit, so the launch raises the
// kernel's dynamic shared-memory limit first.  One block fits an SM at
// D = 256.
//
// Bound on this card: operations.  The scores and P·V are 4·D flops per
// visible (q, k) pair; the inputs are read once a query tile, far fewer
// bytes than that work at 295 flops a byte.  This first version multiplies
// on the CUDA cores in float32 (67 TFLOP/s peak), not on the tensor cores
// (989 TFLOP/s bf16), and does not overlap the tile loads with the
// arithmetic; both are the work of a later version (wgmma, TMA).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr int kPStride = kBK + 4;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kBQ == kBK, "load_tile fills kBK rows, for Q tiles too");

template <int D>
struct Tiles {
  static constexpr int kStride = D + 4;
  static constexpr size_t kBytes =
      sizeof(float) * (static_cast<size_t>(kBQ + 2 * kBK) * kStride +
                       static_cast<size_t>(kBQ) * kPStride);
};

// rows x D elements of a head slice from row ``row0`` (rows past ``n_rows``
// read as 0) into a float32 tile of stride D + 4.
template <int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int row0, int n_rows) {
  constexpr int kQuads = D / 4;
  for (int i = threadIdx.x; i < kBK * kQuads; i += kThreads) {
    const int r = i / kQuads, c = (i % kQuads) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows)
      x = *reinterpret_cast<const float4*>(
          src + static_cast<size_t>(row0 + r) * D + c);
    *reinterpret_cast<float4*>(dst + r * Tiles<D>::kStride + c) = x;
  }
}

template <int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const __nv_bfloat16* __restrict__ src,
                                          int row0, int n_rows) {
  constexpr int kOcts = D / 8;
  for (int i = threadIdx.x; i < kBK * kOcts; i += kThreads) {
    const int r = i / kOcts, c = (i % kOcts) * 8;
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
    if (row0 + r < n_rows) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(row0 + r) * D + c);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 a = __bfloat1622float2(h2[0]), b = __bfloat1622float2(h2[1]);
      const float2 e = __bfloat1622float2(h2[2]), f = __bfloat1622float2(h2[3]);
      lo = make_float4(a.x, a.y, b.x, b.y);
      hi = make_float4(e.x, e.y, f.x, f.y);
    }
    float* d = dst + r * Tiles<D>::kStride + c;
    *reinterpret_cast<float4*>(d) = lo;
    *reinterpret_cast<float4*>(d + 4) = hi;
  }
}

__device__ __forceinline__ void store4(float* dst, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, float a, float b,
                                       float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = raw;
}

// max / sum over the 16 lanes that share a row group (lanes 0-15 or 16-31)
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ out, int Hq, int Hkv,
                int Sq, int Skv, int causal, int window, int kv_len,
                float softcap, float sm_scale) {
  constexpr int kStride = Tiles<D>::kStride;
  constexpr int kCols = D / 16;  // accumulator columns a thread owns
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * kStride;
  float* Vs = Ks + kBK * kStride;
  float* Ps = Vs + kBK * kStride;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const T* qh = q + (static_cast<size_t>(b) * Hq + h) * Sq * D;
  const T* kh = k + (static_cast<size_t>(b) * Hkv + hk) * Skv * D;
  const T* vh = v + (static_cast<size_t>(b) * Hkv + hk) * Skv * D;
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;

  load_tile<D>(Qs, qh, q0, Sq);

  // key tiles that hold a visible key for some row of this query tile
  int k_hi = kv_len;
  if (causal) k_hi = min(k_hi, q0 + kBQ);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1);

  float acc[4][kCols];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's P·V is done with Ks, Vs, Ps
    load_tile<D>(Ks, kh, k0, Skv);
    load_tile<D>(Vs, vh, k0, Skv);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (rg * 4 + i) * kStride + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (cg + 16 * j) * kStride + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + rg * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + cg + 16 * j;
        float x = s[i][j] * sm_scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = kj < kv_len;
        if (causal) ok = ok && qi >= kj;
        if (window > 0) ok = ok && (qi - kj) < window;
        s[i][j] = ok ? x : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);  // 0 for a masked score
        sum += p;
        Ps[(rg * 4 + i) * kPStride + cg + 16 * j] = p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(Ps + (rg * 4 + i) * kPStride + kk);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* vrow = Vs + (kk + t) * kStride + cg * 4;
#pragma unroll
        for (int jj = 0; jj < D / 64; ++jj) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + 64 * jj);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = t == 0 ? p4[i].x : t == 1 ? p4[i].y
                          : t == 2 ? p4[i].z : p4[i].w;
            acc[i][jj * 4 + 0] = fmaf(p, vv.x, acc[i][jj * 4 + 0]);
            acc[i][jj * 4 + 1] = fmaf(p, vv.y, acc[i][jj * 4 + 1]);
            acc[i][jj * 4 + 2] = fmaf(p, vv.z, acc[i][jj * 4 + 2]);
            acc[i][jj * 4 + 3] = fmaf(p, vv.w, acc[i][jj * 4 + 3]);
          }
        }
      }
    }
  }

  T* oh = out + (static_cast<size_t>(b) * Hq + h) * Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg * 4 + i;
    if (qi >= Sq) continue;
    const float safe = l[i] > 0.f ? l[i] : 1.f;
#pragma unroll
    for (int jj = 0; jj < D / 64; ++jj)
      store4(oh + static_cast<size_t>(qi) * D + cg * 4 + 64 * jj,
             acc[i][jj * 4 + 0] / safe, acc[i][jj * 4 + 1] / safe,
             acc[i][jj * 4 + 2] / safe, acc[i][jj * 4 + 3] / safe);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Skv, int causal, int window,
           int kv_len, float softcap, float sm_scale, cudaStream_t stream) {
  const size_t smem = Tiles<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  attn_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Skv, causal,
      window, kv_len, softcap, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dim(const void* q, const void* k, const void* v, void* o, int B,
                 int Hq, int Hkv, int Sq, int Skv, int D, int causal,
                 int window, int kv_len, float softcap, float sm_scale,
                 cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window,
                           kv_len, softcap, sm_scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window,
                            kv_len, softcap, sm_scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window,
                            kv_len, softcap, sm_scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  kv_len must be at most Skv.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int B, int Hq, int Hkv, int Sq, int Skv, int D, int dtype,
                    int causal, int window, int kv_len, float softcap,
                    float sm_scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || B > 65535 || Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dim<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal,
                               window, kv_len, softcap, sm_scale, s);
  if (dtype == 1)
    return dispatch_dim<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D,
                                       causal, window, kv_len, softcap,
                                       sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

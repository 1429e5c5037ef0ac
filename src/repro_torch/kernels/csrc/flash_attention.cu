// Flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _flash_kernel): q (B, Sq, H, D) attends over k, v (B, Sk, KV, D)
// with GQA (query head h reads KV head h / (H / KV)), an optional causal mask
// (key j <= query i) and an optional window (i - j < window), positions
// counted from 0 in both. Online softmax in fp32: scores are the fp32 dot
// product times D**-0.5, NEG_INF = -1e30 (not -inf, so exp(m_prev - m_new)
// stays finite), and the output acc / max(l, 1e-30) is written in q's dtype.
// A masked score contributes exactly 0, so a row with no valid key comes out
// as zeros.
//
// Bound: operations. A causal pass does 4 * D operations per (query, key)
// pair it must see: at B 4, S 2,048, H 48, D 128 that is 206 GFLOP, 0.21 ms
// at the bf16 tensor-core rate, against 235 MB of q, k, v and output
// (0.07 ms at 3.35 TB/s). This kernel runs on the CUDA cores in fp32, so it
// cannot come near that bound; it is the simple, right version (mma.sync,
// wgmma and TMA are for a later change).
//
// Design. One block per (q tile of 64 rows, query head, batch); 4 warps.
// The q tile is converted to fp32 in shared memory once. The block walks the
// K/V tiles of its KV head (indexed directly, not repeated per query head as
// the TPU wrapper does) from the first key any of its rows may see (the
// window) to the last one (the causal diagonal), 64 keys at a time: tiles
// wholly above the diagonal or outside the window are never loaded. K and V
// share one fp32 buffer in turn. Thread (r, c) of the 16 x 8 grid owns rows
// 4r .. 4r+3 and, of the 64 x 64 score tile, the columns c, c + 8, ..., so
// a row's max and sum reduce over the 8 lanes of one warp with shuffles; the
// probabilities go through shared memory (written and read by the same warp)
// to the product with V, where the thread owns D / 8 output columns of its 4
// rows. Rows are padded by 4 floats in shared memory so that the float4 reads
// of 8 different rows fall in different banks. Heavy (late) q tiles are
// scheduled first. Every partial S (not a multiple of 64) is masked: keys
// past Sk are zero-filled and never weighted, query rows past Sq are not
// stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;  // query rows per block
constexpr int kBN = 64;  // keys per tile
constexpr int kThreads = 128;
constexpr int kPadP = kBN + 4;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&a);
  raw.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Rows [0, rows) of a tile of kRows x D values of T (row stride `stride`
// elements) into fp32 shared memory with row stride D + 4; zeros past rows.
template <typename T, int D, int kRows>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride, int rows) {
  constexpr int kChunks = D / 4;
  constexpr int kLd = D + 4;
  for (int idx = threadIdx.x; idx < kRows * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) v = load4(src + r * stride + 4 * c);
    store4(dst + r * kLd + 4 * c, v);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int sq,
                       int sk, int heads, int kv_heads, int causal, int window,
                       float scale) {
  constexpr int kLd = D + 4;
  constexpr int kCols = D / 32;  // float4 output columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // kBM x kLd
  float* kvs = qs + kBM * kLd;                  // kBN x kLd
  float* ps = kvs + kBN * kLd;                  // kBM x kPadP

  const int qt = gridDim.x - 1 - blockIdx.x;  // late (heavy) tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (heads / kv_heads);
  const int q0 = qt * kBM;
  const int tr = threadIdx.x / 8;  // rows 4 tr .. 4 tr + 3
  const int tc = threadIdx.x % 8;

  const long long q_stride = static_cast<long long>(heads) * D;
  const long long kv_stride = static_cast<long long>(kv_heads) * D;
  const T* qb = q + (static_cast<long long>(b) * sq + q0) * q_stride +
                static_cast<long long>(h) * D;
  const T* kb = k + static_cast<long long>(b) * sk * kv_stride +
                static_cast<long long>(kh) * D;
  const T* vb = v + static_cast<long long>(b) * sk * kv_stride +
                static_cast<long long>(kh) * D;

  const int q_rows = min(kBM, sq - q0);
  load_tile<T, D, kBM>(qs, qb, q_stride, q_rows);

  // Keys any row of this tile may see: [k_lo, k_hi).
  const int q_last = q0 + q_rows - 1;
  int k_hi = sk;
  if (causal) k_hi = min(sk, q_last + 1);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1);

  float m[4], l[4];
  float4 acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int k0 = k_lo; k0 < k_hi; k0 += kBN) {
    const int k_rows = min(kBN, sk - k0);
    __syncthreads();  // the previous tile's V is no longer read
    load_tile<T, D, kBN>(kvs, kb + k0 * kv_stride, kv_stride, k_rows);
    __syncthreads();

    // S = Q K^T for rows 4 tr + i and keys tc + 8 j.
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = load4(qs + (4 * tr + i) * kLd + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = load4(kvs + (tc + 8 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s[i][j] = fmaf(qv[i].w, kv[j].w,
                         fmaf(qv[i].z, kv[j].z,
                              fmaf(qv[i].y, kv[j].y,
                                   fmaf(qv[i].x, kv[j].x, s[i][j]))));
    }

    // Mask, online softmax, probabilities to shared memory.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * tr + i;
      unsigned ok = 0;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = k0 + tc + 8 * j;
        const bool valid = kj < sk && (!causal || kj <= qi) &&
                           (window <= 0 || qi - kj < window);
        s[i][j] = valid ? s[i][j] * scale : kNegInf;
        ok |= valid ? (1u << j) : 0u;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = (ok >> j) & 1u ? expf(s[i][j] - m_new) : 0.f;
        ps[(4 * tr + i) * kPadP + tc + 8 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        acc[i][c].x *= corr;
        acc[i][c].y *= corr;
        acc[i][c].z *= corr;
        acc[i][c].w *= corr;
      }
    }

    __syncthreads();  // every warp is done with K
    load_tile<T, D, kBN>(kvs, vb + k0 * kv_stride, kv_stride, k_rows);
    __syncthreads();  // V (and this warp's probabilities) visible

    // acc += P V over this tile's keys.
    for (int key = 0; key < kBN; key += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = load4(ps + (4 * tr + i) * kPadP + key);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = kvs + (key + u) * kLd + 4 * tc;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float4 vv = load4(vrow + 32 * c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                          : u == 2 ? pv[i].z : pv[i].w;
            acc[i][c].x += p * vv.x;
            acc[i][c].y += p * vv.y;
            acc[i][c].z += p * vv.z;
            acc[i][c].w += p * vv.w;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = 4 * tr + i;
    if (row >= q_rows) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = out + (static_cast<long long>(b) * sq + q0 + row) * q_stride +
              static_cast<long long>(h) * D + 4 * tc;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const float4 a = acc[i][c];
      store4(orow + 32 * c,
             make_float4(a.x / den, a.y / den, a.z / den, a.w / den));
    }
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int batch,
             int sq, int sk, int heads, int kv_heads, int causal, int window,
             cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((kBM + kBN) * static_cast<size_t>(D + 4) + kBM * kPadP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // D ** -0.5 as the reference computes it, in double, then rounded.
  const float scale = static_cast<float>(pow(static_cast<double>(D), -0.5));
  const dim3 grid(static_cast<unsigned>((sq + kBM - 1) / kBM),
                  static_cast<unsigned>(heads), static_cast<unsigned>(batch));
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, heads, kv_heads,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t(int head_dim, const void* q, const void* k, const void* v,
             void* out, int batch, int sq, int sk, int heads, int kv_heads,
             int causal, int window, cudaStream_t s) {
  if (head_dim == 64) {
    return launch_d<T, 64>(q, k, v, out, batch, sq, sk, heads, kv_heads,
                           causal, window, s);
  }
  if (head_dim == 128) {
    return launch_d<T, 128>(q, k, v, out, batch, sq, sk, heads, kv_heads,
                            causal, window, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, out: (batch, sq, heads, head_dim); k, v: (batch, sk, kv_heads,
// head_dim); all of one dtype (0: float32, 1: bfloat16), contiguous and
// 16-byte aligned. heads a multiple of kv_heads; head_dim 64 or 128.
// causal 0/1; window <= 0 for none. Launches on `stream`; returns
// cudaGetLastError, or cudaErrorInvalidValue for a shape it does not take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int batch,
                                      int sq, int sk, int heads, int kv_heads,
                                      int head_dim, int causal, int window,
                                      int dtype, void* stream) {
  if (batch <= 0 || sq <= 0 || heads <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads != 0 || sk < 0 || batch > 65535 ||
      heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_t<float>(head_dim, q, k, v, out, batch, sq, sk, heads,
                           kv_heads, causal, window, s);
  }
  if (dtype == 1) {
    return launch_t<__nv_bfloat16>(head_dim, q, k, v, out, batch, sq, sk,
                                   heads, kv_heads, causal, window, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

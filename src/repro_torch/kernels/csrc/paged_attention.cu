// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::paged_attention
// (body _paged_kernel): one query token per sequence, q (B, H, D), attends
// over its KV cache, which lies in pages of a pool (P, page, KV, D) named by
// the sequence's row of block_tables (B, max_pages); lengths (B,) counts its
// tokens. Pages p >= ceil(len / page) and entries < 0 are skipped. GQA: query
// head h reads KV head h / (H / KV). Online softmax in fp32 with
// NEG_INF = -1e30 and scale D**-0.5; the output acc / max(l, 1e-30) is written
// in q's dtype, so a row with no token comes out as zeros.
//
// Bound: bytes. Every K and V row of a valid token is read once (K and V of
// 64 sequences x 1,024 tokens x 8 heads x 128 fp32 are 512 MiB, 0.16 ms at
// 3.35 TB/s); the arithmetic, 4 * B * H * len * D operations, is about an
// eighth of that time at the fp32 rate.
//
// Design. One block per (KV head, sequence) holds that KV head's G query
// heads in registers, so each K and V row is loaded once for all G heads (the
// TPU kernel's (KV, g, D) einsum). Its four warps take the sequence's tokens
// in turn, in logical order: a warp loads a token's K and V row for its head
// (4 elements per lane, 16 bytes of fp32 or 8 of bf16), reduces the G dot
// products across the warp with shuffles and updates its own running m, l and
// acc. The warps' states are merged in shared memory in warp order at the
// end. No atomics and a fixed order: two launches over the same logical KV
// give bit-identical output, wherever its pages sit in the pool. The grid
// has B * KV blocks (512 at the main path's shapes) and no cp.async staging,
// so the kernel relies on the warps' independent loads to hide latency.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
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

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float4 axpby(float4 x, float a, float4 y, float b) {
  return make_float4(x.x * a + y.x * b, x.y * a + y.y * b, x.z * a + y.z * b,
                     x.w * a + y.w * b);
}

// G: query heads per KV head. NV: 4-element vectors per lane (D <= 128 * NV).
template <typename T, int G, int NV>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int* __restrict__ tables,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int kv_heads, int head_dim, int page, int max_pages,
                       float scale) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int heads = kv_heads * G;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 qr[G][NV], acc[G][NV];
  float m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qh = q + (static_cast<long long>(b) * heads + kh * G + g) *
                          head_dim;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int e = 4 * (lane + 32 * j);
      qr[g][j] = e < head_dim ? load4(qh + e) : zero;
      acc[g][j] = zero;
    }
    m[g] = kNegInf;
    l[g] = 0.f;
  }

  const int len = lengths[b];
  int num_pages = len > 0 ? (len + page - 1) / page : 0;
  if (num_pages > max_pages) num_pages = max_pages;
  const long long tok_stride = static_cast<long long>(kv_heads) * head_dim;
  const int* row = tables + static_cast<long long>(b) * max_pages;

  for (int p = 0; p < num_pages; ++p) {
    const int phys = row[p];
    if (phys < 0) continue;
    const int left = len - p * page;
    const int ntok = left < page ? left : page;
    const long long base = static_cast<long long>(phys) * page * tok_stride +
                           static_cast<long long>(kh) * head_dim;
    for (int t = warp; t < ntok; t += kWarps) {
      const long long off = base + t * tok_stride;
      float4 kr[NV], vr[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int e = 4 * (lane + 32 * j);
        kr[j] = e < head_dim ? load4(k_pages + off + e) : zero;
        vr[j] = e < head_dim ? load4(v_pages + off + e) : zero;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < NV; ++j) s += dot4(qr[g][j], kr[j]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        s *= scale;
        const float m_new = fmaxf(m[g], s);
        const float corr = expf(m[g] - m_new);
        const float pr = expf(s - m_new);
        l[g] = l[g] * corr + pr;
#pragma unroll
        for (int j = 0; j < NV; ++j) acc[g][j] = axpby(acc[g][j], corr, vr[j], pr);
        m[g] = m_new;
      }
    }
  }

  // Merge the warps' running states, in warp order.
  __shared__ float s_m[kWarps][G];
  __shared__ float s_l[kWarps][G];
  __shared__ float4 s_acc[kWarps][G][32 * NV];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      s_m[warp][g] = m[g];
      s_l[warp][g] = l[g];
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) s_acc[warp][g][lane + 32 * j] = acc[g][j];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * head_dim; idx += kThreads) {
    const int g = idx / head_dim;
    const int e = idx % head_dim;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(s_m[w][g] - mx);
      den += s_l[w][g] * c;
      num += reinterpret_cast<const float*>(s_acc[w][g])[e] * c;
    }
    store(out + (static_cast<long long>(b) * heads + kh * G + g) * head_dim + e,
          num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int G, int NV>
void launch_nv(const void* q, const void* k, const void* v, const void* tables,
               const void* lengths, void* out, int batch, int kv_heads,
               int head_dim, int page, int max_pages, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(kv_heads), static_cast<unsigned>(batch));
  // d ** -0.5 as the reference computes it, in double, then rounded.
  const float scale = static_cast<float>(pow(static_cast<double>(head_dim), -0.5));
  paged_attention_kernel<T, G, NV><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), kv_heads,
      head_dim, page, max_pages, scale);
}

template <typename T, int G>
int launch_g(const void* q, const void* k, const void* v, const void* tables,
             const void* lengths, void* out, int batch, int kv_heads,
             int head_dim, int page, int max_pages, cudaStream_t stream) {
  if (head_dim <= 128) {
    launch_nv<T, G, 1>(q, k, v, tables, lengths, out, batch, kv_heads,
                       head_dim, page, max_pages, stream);
  } else {
    launch_nv<T, G, 2>(q, k, v, tables, lengths, out, batch, kv_heads,
                       head_dim, page, max_pages, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t(int group, const void* q, const void* k, const void* v,
             const void* tables, const void* lengths, void* out, int batch,
             int kv_heads, int head_dim, int page, int max_pages,
             cudaStream_t s) {
#define PA_CASE(G)                                                        \
  case G:                                                                 \
    return launch_g<T, G>(q, k, v, tables, lengths, out, batch, kv_heads, \
                          head_dim, page, max_pages, s);
  switch (group) {
    PA_CASE(1)
    PA_CASE(2)
    PA_CASE(3)
    PA_CASE(4)
    PA_CASE(5)
    PA_CASE(6)
    PA_CASE(7)
    PA_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PA_CASE
}

}  // namespace

// q, out: (batch, kv_heads * group, head_dim); k, v: (pages, page, kv_heads,
// head_dim), all of one dtype (0: float32, 1: bfloat16), contiguous and
// 16-byte aligned. tables: int32 (batch, max_pages); lengths: int32 (batch,).
// group in 1..8, head_dim a multiple of 4 up to 256. Launches on `stream`;
// returns cudaGetLastError, or cudaErrorInvalidValue for a shape it does not
// take.
extern "C" int paged_attention_launch(const void* q, const void* k,
                                      const void* v, const void* tables,
                                      const void* lengths, void* out,
                                      int batch, int kv_heads, int group,
                                      int head_dim, int page, int max_pages,
                                      int dtype, void* stream) {
  if (batch <= 0 || kv_heads <= 0) return 0;
  if (head_dim <= 0 || head_dim % 4 != 0 || head_dim > 256 || page <= 0 ||
      max_pages < 0 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_t<float>(group, q, k, v, tables, lengths, out, batch,
                           kv_heads, head_dim, page, max_pages, s);
  }
  if (dtype == 1) {
    return launch_t<__nv_bfloat16>(group, q, k, v, tables, lengths, out, batch,
                                   kv_heads, head_dim, page, max_pages, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

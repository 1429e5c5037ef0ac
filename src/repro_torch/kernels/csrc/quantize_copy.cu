// Descriptor-driven int8 quantize-dequantize row copy for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/quantize_copy.py::quantize_copy
// (body _quantize_copy_kernel; also reached through quantize_copy_bucketed):
// per descriptor i, every 256-element block of row src[src_idx[i]] makes the
// symmetric int8 round trip
//   scale = max(max|x| / 127, 1e-12); q = clip(round_half_even(x / scale),
//   -127, 127); out = q * scale
// in fp32, and the result is stored to dst[dst_idx[i]] in dst's dtype. A -1
// on either side writes nothing.
//
// Bound: bytes. Each active source row is read once and each destination row
// written once (2 * n_active * row_bytes); the few operations per element
// are far below the card's fp32 rate.
//
// Design: one warp per 256-element block of an active row, through a
// grid-stride loop over (descriptor, block) pairs. Each lane holds 8 values
// (fp32: two 16-byte loads, bf16: one, when the pointers are 16-byte
// aligned; 8 coalesced scalar loads otherwise), the block's max |x| is a warp
// reduction through __shfl_xor_sync, and no shared memory is needed. The
// division and rounding are IEEE round-to-nearest (__fdiv_rn, rintf) so the
// result is bit-identical to the plain PyTorch version; this file must be
// compiled without --use_fast_math.
//
// As for descriptor_copy, the wrapper (repro_torch/kernels/quantize_copy.py)
// resolves duplicate destinations and source/destination aliasing on the
// host before the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlock = 256;  // quantisation block (elements)
constexpr long long kMaxBlocks = 132LL * 16;

template <typename T, bool VEC>
struct Lane;

// fp32, vectorised: elements 4*lane..4*lane+3 and 128+4*lane..128+4*lane+3.
template <>
struct Lane<float, true> {
  static __device__ __forceinline__ void load(const float* p, int lane,
                                              float x[8]) {
    const float4 a = reinterpret_cast<const float4*>(p)[lane];
    const float4 b = reinterpret_cast<const float4*>(p + 128)[lane];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
  static __device__ __forceinline__ void store(float* p, int lane,
                                               const float x[8]) {
    reinterpret_cast<float4*>(p)[lane] = make_float4(x[0], x[1], x[2], x[3]);
    reinterpret_cast<float4*>(p + 128)[lane] =
        make_float4(x[4], x[5], x[6], x[7]);
  }
};

// bf16, vectorised: elements 8*lane..8*lane+7 in one 16-byte access.
template <>
struct Lane<__nv_bfloat16, true> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              int lane, float x[8]) {
    const uint4 v = reinterpret_cast<const uint4*>(p)[lane];
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = __bfloat162float(h[k]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, int lane,
                                               const float x[8]) {
    uint4 v;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
    for (int k = 0; k < 8; ++k) h[k] = __float2bfloat16_rn(x[k]);
    reinterpret_cast<uint4*>(p)[lane] = v;
  }
};

// Any dtype, scalar: element lane + 32*k.
template <typename T>
struct Lane<T, false> {
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ void put(float* p, float v) { *p = v; }
  static __device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ void load(const T* p, int lane,
                                              float x[8]) {
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = to_f(p[lane + 32 * k]);
  }
  static __device__ __forceinline__ void store(T* p, int lane,
                                               const float x[8]) {
#pragma unroll
    for (int k = 0; k < 8; ++k) put(p + lane + 32 * k, x[k]);
  }
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
quantize_copy_kernel(const T* __restrict__ src, T* __restrict__ dst,
                     const int* __restrict__ src_idx,
                     const int* __restrict__ dst_idx, long long n,
                     long long unit) {
  const int lane = threadIdx.x & 31;
  const long long warps = kThreads / 32;
  const long long per_row = unit / kBlock;
  const long long total = n * per_row;
  for (long long w = blockIdx.x * warps + threadIdx.x / 32; w < total;
       w += static_cast<long long>(gridDim.x) * warps) {
    const long long i = w / per_row;
    const long long b = w - i * per_row;
    const int s = src_idx[i];
    const int t = dst_idx[i];
    if (s < 0 || t < 0) continue;  // uniform across the warp
    const T* sp = src + static_cast<size_t>(s) * unit + b * kBlock;
    T* dp = dst + static_cast<size_t>(t) * unit + b * kBlock;
    float x[8];
    Lane<T, VEC>::load(sp, lane, x);
    float m = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) m = fmaxf(m, fabsf(x[k]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float scale = fmaxf(__fdiv_rn(m, 127.0f), 1e-12f);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float q = rintf(__fdiv_rn(x[k], scale));
      q = fminf(fmaxf(q, -127.0f), 127.0f);
      x[k] = __fmul_rn(q, scale);
    }
    Lane<T, VEC>::store(dp, lane, x);
  }
}

template <typename T, bool VEC>
void launch(const void* src, void* dst, const void* sidx, const void* didx,
            long long n, long long unit, cudaStream_t stream) {
  const long long warps = n * (unit / kBlock);
  const long long want = (warps + kThreads / 32 - 1) / (kThreads / 32);
  const int grid = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  quantize_copy_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(src), static_cast<T*>(dst),
      static_cast<const int*>(sidx), static_cast<const int*>(didx), n, unit);
}

}  // namespace

// src, dst: row pools of `unit` elements per row (unit % 256 == 0) of dtype
// 0 = float32, 1 = bfloat16. src_idx, dst_idx: int32 device arrays of n
// entries. Launches on `stream`; returns cudaGetLastError (or
// cudaErrorInvalidValue for an unknown dtype or unit).
extern "C" int quantize_copy_launch(const void* src, void* dst,
                                    const void* src_idx, const void* dst_idx,
                                    long long n, long long unit, int dtype,
                                    void* stream) {
  if (unit <= 0 || unit % kBlock != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  if (dtype == 0) {
    if (vec) launch<float, true>(src, dst, src_idx, dst_idx, n, unit, st);
    else launch<float, false>(src, dst, src_idx, dst_idx, n, unit, st);
  } else {
    if (vec) launch<__nv_bfloat16, true>(src, dst, src_idx, dst_idx, n, unit, st);
    else launch<__nv_bfloat16, false>(src, dst, src_idx, dst_idx, n, unit, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// MoE dispatch gather and combine for Hopper (sm_90a), driven by the
// DispatchPlan descriptor streams of repro_torch/models/moe.py.
//
// Replaces the TPU kernels repro/kernels/moe_dispatch.py::moe_gather (body
// _gather_kernel) and ::moe_combine (body _combine_kernel):
//   gather:  out[s] = tokens[token_idx[s]], or zeros where token_idx[s] < 0;
//   combine: out[t] = sum_j w[t, j] * expert_out[inv_slot[t, j]], skipping
//            inv_slot[t, j] < 0, in fp32, cast once to expert_out's dtype.
// and their derivatives, which the reference leaves to XLA's VJP of the
// gather and the einsum (repro/models/moe.py:_moe_ffn_gspmd):
//   gather's backward:  d_tokens[t] = sum_j d_slots[inv_slot[t, j]] over the
//            kept j, in j order in fp32, cast once (the scatter-add by
//            token_idx, read through the inverse plan: each filled slot is
//            the inv_slot of exactly one kept copy);
//   combine's backward: d_expert_out[inv_slot[t, j]] = w[t, j] * dy[t], the
//            product in fp32 rounded once, zeros in the slots no kept copy
//            points at (token_idx < 0); d_w[t, j] = sum_d dy[t, d] *
//            expert_out[inv_slot[t, j], d] in fp32, 0 for a dropped copy.
//
// Bound: bytes. The gather reads each active slot's token row once and
// writes every slot row once; the combine reads each kept (token, expert)
// row once and writes every token row once. Two operations per element of a
// kept row is far below the card's fp32 rate. The gather's backward moves
// the combine's bytes; the combine's reads dy and each kept expert row once
// and writes every slot row and d_w once.
//
// Design.
// * Gather: one block per slot row (grid-stride over rows). The row moves as
//   raw bytes, so any dtype goes through: 16-byte vectors where the row width
//   and both base pointers allow, 4-byte words, else bytes (as
//   descriptor_copy.cu). An empty slot (-1) writes zeros and does not read
//   any token row; the TPU kernel reads row max(idx, 0) and discards it.
// * Combine: one block per token row; each thread owns 16 bytes of the row
//   (8 bf16 or 4 fp32 values, or one value when the width or the pointers
//   are not aligned) and walks j = 0 .. k-1 in order. A -1 entry is skipped
//   without a read, so a non-finite row 0 cannot leak into the sum (the TPU
//   kernel reads it and multiplies by w = 0). The product and the sum are
//   rounded separately (__fmul_rn, __fadd_rn): nvcc would otherwise contract
//   them into one FMA, and the plain PyTorch version `acc + w * row` rounds
//   twice. Kernel and plain version are bit-identical.
// * Gather's backward: the combine kernel with unit weights (no weight
//   array): w * x is x exactly, so it sums the slot rows as the plain
//   version does, bit for bit.
// * Combine's backward: one block per token row, each thread owning the
//   same 16-byte chunks as the forward. For each chunk it loads dy[t] once
//   and, per kept copy j, the copy's expert row: it writes the chunk of
//   w * dy (one writer per slot row: the plan gives each filled slot one
//   copy) and adds dy . row into its partial dot for j. The block then sums
//   the partials in a fixed order (a warp's xor tree, then the warps in
//   order), so d_w is the same on every launch; no atomics. The same
//   launch writes zeros into every slot row with token_idx < 0. Copies go
//   kMaxK at a time, so any k works.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;

template <typename V>
__device__ __forceinline__ void copy_row(const V* __restrict__ s,
                                         V* __restrict__ d, long long n) {
#pragma unroll 4
  for (long long k = threadIdx.x; k < n; k += kThreads) d[k] = s[k];
}

template <typename V>
__device__ __forceinline__ void zero_row(V* __restrict__ d, long long n) {
  const V z{};
#pragma unroll 4
  for (long long k = threadIdx.x; k < n; k += kThreads) d[k] = z;
}

__global__ void __launch_bounds__(kThreads)
moe_gather_kernel(const char* __restrict__ tokens, char* __restrict__ out,
                  const int* __restrict__ token_idx, long long n,
                  long long row_bytes, int vec) {
  for (long long i = blockIdx.x; i < n; i += gridDim.x) {
    const int s = token_idx[i];  // uniform across the block
    char* dp = out + static_cast<size_t>(i) * row_bytes;
    if (s < 0) {
      if (vec == 16) {
        zero_row(reinterpret_cast<uint4*>(dp), row_bytes / 16);
      } else if (vec == 4) {
        zero_row(reinterpret_cast<uint32_t*>(dp), row_bytes / 4);
      } else {
        zero_row(reinterpret_cast<unsigned char*>(dp), row_bytes);
      }
      continue;
    }
    const char* sp = tokens + static_cast<size_t>(s) * row_bytes;
    if (vec == 16) {
      copy_row(reinterpret_cast<const uint4*>(sp),
               reinterpret_cast<uint4*>(dp), row_bytes / 16);
    } else if (vec == 4) {
      copy_row(reinterpret_cast<const uint32_t*>(sp),
               reinterpret_cast<uint32_t*>(dp), row_bytes / 4);
    } else {
      copy_row(reinterpret_cast<const unsigned char*>(sp),
               reinterpret_cast<unsigned char*>(dp), row_bytes);
    }
  }
}

// N values of T at p, as floats; p is aligned to N * sizeof(T) when N > 1.
template <typename T, int N>
__device__ __forceinline__ void load_n(const T* p, float* x);

template <>
__device__ __forceinline__ void load_n<float, 1>(const float* p, float* x) {
  x[0] = *p;
}

template <>
__device__ __forceinline__ void load_n<float, 4>(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

template <>
__device__ __forceinline__ void load_n<__nv_bfloat16, 1>(
    const __nv_bfloat16* p, float* x) {
  x[0] = __bfloat162float(*p);
}

template <>
__device__ __forceinline__ void load_n<__nv_bfloat16, 8>(
    const __nv_bfloat16* p, float* x) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_n(T* p, const float* x);

template <>
__device__ __forceinline__ void store_n<float, 1>(float* p, const float* x) {
  *p = x[0];
}

template <>
__device__ __forceinline__ void store_n<float, 4>(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

template <>
__device__ __forceinline__ void store_n<__nv_bfloat16, 1>(__nv_bfloat16* p,
                                                          const float* x) {
  *p = __float2bfloat16_rn(x[0]);
}

template <>
__device__ __forceinline__ void store_n<__nv_bfloat16, 8>(__nv_bfloat16* p,
                                                          const float* x) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// N: values per thread chunk (16 bytes, or 1 on the unaligned path).
// Without inv_weight (the gather's backward) every weight is 1.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
moe_combine_kernel(const int* __restrict__ inv_slot,
                   const float* __restrict__ inv_weight,
                   const T* __restrict__ expert_out, T* __restrict__ out,
                   long long tokens, long long d, int k) {
  const long long chunks = d / N;
  for (long long t = blockIdx.x; t < tokens; t += gridDim.x) {
    const int* slots = inv_slot + t * k;
    const float* ws = inv_weight == nullptr ? nullptr : inv_weight + t * k;
    for (long long c = threadIdx.x; c < chunks; c += kThreads) {
      float acc[N];
#pragma unroll
      for (int e = 0; e < N; ++e) acc[e] = 0.f;
      for (int j = 0; j < k; ++j) {
        const int s = slots[j];
        if (s < 0) continue;  // dropped copy: no read
        float x[N];
        load_n<T, N>(expert_out + static_cast<long long>(s) * d + c * N, x);
        if (ws == nullptr) {
#pragma unroll
          for (int e = 0; e < N; ++e) acc[e] = __fadd_rn(acc[e], x[e]);
        } else {
          const float w = ws[j];
#pragma unroll
          for (int e = 0; e < N; ++e) {
            acc[e] = __fadd_rn(acc[e], __fmul_rn(w, x[e]));
          }
        }
      }
      store_n<T, N>(out + t * d + c * N, acc);
    }
  }
}

template <typename T, int N>
void launch_combine(const void* slot, const void* w, const void* eo, void* out,
                    long long tokens, long long d, int k, cudaStream_t s) {
  const int grid = static_cast<int>(tokens < kMaxBlocks ? tokens : kMaxBlocks);
  moe_combine_kernel<T, N><<<grid, kThreads, 0, s>>>(
      static_cast<const int*>(slot), static_cast<const float*>(w),
      static_cast<const T*>(eo), static_cast<T*>(out), tokens, d, k);
}

// Copies of a token that one pass of the combine's backward holds.
constexpr int kMaxK = 8;
constexpr int kWarps = kThreads / 32;

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
moe_combine_bwd_kernel(const int* __restrict__ inv_slot,
                       const float* __restrict__ inv_weight,
                       const T* __restrict__ expert_out,
                       const T* __restrict__ dy,
                       const int* __restrict__ token_idx,
                       T* __restrict__ d_expert_out,
                       float* __restrict__ d_weight, long long tokens,
                       long long rows, long long d, int k) {
  __shared__ float part[kWarps][kMaxK];
  const long long chunks = d / N;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long n = tokens > rows ? tokens : rows;
  for (long long i = blockIdx.x; i < n; i += gridDim.x) {
    if (i < rows && token_idx[i] < 0) {  // an empty slot: zeros
      float z[N];
#pragma unroll
      for (int e = 0; e < N; ++e) z[e] = 0.f;
      for (long long c = threadIdx.x; c < chunks; c += kThreads) {
        store_n<T, N>(d_expert_out + i * d + c * N, z);
      }
    }
    if (i >= tokens) continue;
    const int* slots = inv_slot + i * k;
    const float* ws = inv_weight + i * k;
    for (int j0 = 0; j0 < k; j0 += kMaxK) {
      const int nj = k - j0 < kMaxK ? k - j0 : kMaxK;
      int sl[kMaxK];
      float wl[kMaxK];
      float dot[kMaxK];
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) {
        sl[j] = j < nj ? slots[j0 + j] : -1;
        wl[j] = j < nj ? ws[j0 + j] : 0.f;
        dot[j] = 0.f;
      }
      for (long long c = threadIdx.x; c < chunks; c += kThreads) {
        float g[N];
        load_n<T, N>(dy + i * d + c * N, g);
#pragma unroll
        for (int j = 0; j < kMaxK; ++j) {
          if (sl[j] < 0) continue;  // dropped copy: no read, no write
          const long long off = static_cast<long long>(sl[j]) * d + c * N;
          float x[N];
          float o[N];
          load_n<T, N>(expert_out + off, x);
#pragma unroll
          for (int e = 0; e < N; ++e) {
            dot[j] = fmaf(g[e], x[e], dot[j]);
            o[e] = __fmul_rn(wl[j], g[e]);
          }
          store_n<T, N>(d_expert_out + off, o);
        }
      }
      // Fixed-order block sums of the partial dots.
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) {
        float v = dot[j];
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) {
          v += __shfl_xor_sync(0xffffffffu, v, m);
        }
        if (lane == 0) part[warp][j] = v;
      }
      __syncthreads();
      const int j = static_cast<int>(threadIdx.x);
      if (j < nj) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += part[w][j];
        d_weight[i * k + j0 + j] = slots[j0 + j] < 0 ? 0.f : sum;
      }
      __syncthreads();
    }
  }
}

template <typename T, int N>
void launch_combine_bwd(const void* slot, const void* w, const void* eo,
                        const void* dy, const void* token_idx, void* d_eo,
                        void* d_w, long long tokens, long long rows,
                        long long d, int k, cudaStream_t s) {
  const long long n = tokens > rows ? tokens : rows;
  const int grid = static_cast<int>(n < kMaxBlocks ? n : kMaxBlocks);
  moe_combine_bwd_kernel<T, N><<<grid, kThreads, 0, s>>>(
      static_cast<const int*>(slot), static_cast<const float*>(w),
      static_cast<const T*>(eo), static_cast<const T*>(dy),
      static_cast<const int*>(token_idx), static_cast<T*>(d_eo),
      static_cast<float*>(d_w), tokens, rows, d, k);
}

// The combine's launch over `dtype`, 16-byte chunks where the width and the
// pointers allow, else one value a chunk. `weight` may be null (unit
// weights).
int combine_dispatch(const void* inv_slot, const void* weight,
                     const void* rows, void* out, long long tokens,
                     long long d, long long k, int dtype, cudaStream_t s) {
  if (tokens <= 0 || d <= 0) return 0;
  if (k <= 0 || k > (1 << 20)) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t a = reinterpret_cast<uintptr_t>(rows);
  const uintptr_t b = reinterpret_cast<uintptr_t>(out);
  const bool aligned = a % 16 == 0 && b % 16 == 0;
  const int kk = static_cast<int>(k);
  if (dtype == 0) {
    if (aligned && d % 4 == 0) {
      launch_combine<float, 4>(inv_slot, weight, rows, out, tokens, d, kk, s);
    } else {
      launch_combine<float, 1>(inv_slot, weight, rows, out, tokens, d, kk, s);
    }
  } else if (dtype == 1) {
    if (aligned && d % 8 == 0) {
      launch_combine<__nv_bfloat16, 8>(inv_slot, weight, rows, out, tokens, d,
                                       kk, s);
    } else {
      launch_combine<__nv_bfloat16, 1>(inv_slot, weight, rows, out, tokens, d,
                                       kk, s);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tokens: (T, row_bytes / elem) rows; out: (n, same) rows; token_idx: int32
// device array of n entries, each -1 or < T. Launches on `stream`; returns
// cudaGetLastError.
extern "C" int moe_gather_launch(const void* tokens, void* out,
                                 const void* token_idx, long long n,
                                 long long row_bytes, void* stream) {
  if (n <= 0 || row_bytes <= 0) return 0;
  const uintptr_t a = reinterpret_cast<uintptr_t>(tokens);
  const uintptr_t b = reinterpret_cast<uintptr_t>(out);
  int vec = 1;
  if (row_bytes % 16 == 0 && a % 16 == 0 && b % 16 == 0) {
    vec = 16;
  } else if (row_bytes % 4 == 0 && a % 4 == 0 && b % 4 == 0) {
    vec = 4;
  }
  const int grid = static_cast<int>(n < kMaxBlocks ? n : kMaxBlocks);
  moe_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(tokens), static_cast<char*>(out),
      static_cast<const int*>(token_idx), n, row_bytes, vec);
  return static_cast<int>(cudaGetLastError());
}

// inv_slot: int32 (tokens, k), each -1 or < the rows of expert_out;
// inv_weight: fp32 (tokens, k); expert_out: (rows, d); out: (tokens, d), both
// of one dtype (0: float32, 1: bfloat16). Launches on `stream`; returns
// cudaGetLastError, or cudaErrorInvalidValue for a dtype it does not take.
extern "C" int moe_combine_launch(const void* inv_slot, const void* inv_weight,
                                  const void* expert_out, void* out,
                                  long long tokens, long long d, long long k,
                                  int dtype, void* stream) {
  if (inv_weight == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return combine_dispatch(inv_slot, inv_weight, expert_out, out, tokens, d, k,
                          dtype, static_cast<cudaStream_t>(stream));
}

// The gather's backward. inv_slot: int32 (tokens, k), each -1 or < the rows
// of d_slots; d_slots: (rows, d); d_tokens: (tokens, d), both of one dtype
// (0: float32, 1: bfloat16). Launches on `stream`; returns
// cudaGetLastError, or cudaErrorInvalidValue for a dtype it does not take.
extern "C" int moe_gather_bwd_launch(const void* inv_slot, const void* d_slots,
                                     void* d_tokens, long long tokens,
                                     long long d, long long k, int dtype,
                                     void* stream) {
  return combine_dispatch(inv_slot, nullptr, d_slots, d_tokens, tokens, d, k,
                          dtype, static_cast<cudaStream_t>(stream));
}

// The combine's backward. inv_slot, inv_weight: (tokens, k) int32 and fp32;
// expert_out, d_expert_out: (rows, d); dy: (tokens, d), the three of one
// dtype (0: float32, 1: bfloat16); token_idx: int32 (rows,), the forward
// plan's (each filled slot is the inv_slot of exactly one kept copy, and
// token_idx < 0 marks the others); d_weight: fp32 (tokens, k). Launches on
// `stream`; returns cudaGetLastError, or cudaErrorInvalidValue for a dtype
// it does not take.
extern "C" int moe_combine_bwd_launch(const void* inv_slot,
                                      const void* inv_weight,
                                      const void* expert_out, const void* dy,
                                      const void* token_idx,
                                      void* d_expert_out, void* d_weight,
                                      long long tokens, long long rows,
                                      long long d, long long k, int dtype,
                                      void* stream) {
  if ((tokens <= 0 && rows <= 0) || d <= 0) return 0;
  if (k <= 0 || k > (1 << 20)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t a = reinterpret_cast<uintptr_t>(expert_out);
  const uintptr_t b = reinterpret_cast<uintptr_t>(dy);
  const uintptr_t c = reinterpret_cast<uintptr_t>(d_expert_out);
  const bool aligned = a % 16 == 0 && b % 16 == 0 && c % 16 == 0;
  const int kk = static_cast<int>(k);
  if (dtype == 0) {
    if (aligned && d % 4 == 0) {
      launch_combine_bwd<float, 4>(inv_slot, inv_weight, expert_out, dy,
                                   token_idx, d_expert_out, d_weight, tokens,
                                   rows, d, kk, s);
    } else {
      launch_combine_bwd<float, 1>(inv_slot, inv_weight, expert_out, dy,
                                   token_idx, d_expert_out, d_weight, tokens,
                                   rows, d, kk, s);
    }
  } else if (dtype == 1) {
    if (aligned && d % 8 == 0) {
      launch_combine_bwd<__nv_bfloat16, 8>(inv_slot, inv_weight, expert_out,
                                           dy, token_idx, d_expert_out,
                                           d_weight, tokens, rows, d, kk, s);
    } else {
      launch_combine_bwd<__nv_bfloat16, 1>(inv_slot, inv_weight, expert_out,
                                           dy, token_idx, d_expert_out,
                                           d_weight, tokens, rows, d, kk, s);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

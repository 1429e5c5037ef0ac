// AdamW's update of one leaf, and the sum of squares of one leaf, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the reference's optimizer
// (src/repro/optim/optimizer.py::apply and ::global_norm) is plain jnp that
// XLA fuses. The port's eager body (repro_torch/kernels/adamw.py,
// adamw_update_plain and sum_squares_plain) runs about 22 elementwise kernels
// a piece of a leaf, each writing a full-size fp32 temporary, and casts each
// bf16 gradient to fp32 twice for its norm: about 204 bytes a parameter where
// the work needs 24.
//
// Bound: bytes. The update reads p, g, m and v once and writes p, m and v
// once: 22 bytes an element at bf16 p and g, 32 at fp32. The sum of squares
// reads its leaf once, in the leaf's own dtype. Some 20 operations an element
// are far below the card's fp32 rate.
//
// Design: one launch a leaf, whatever its size (64-bit offsets). Each thread
// takes 8 elements a step in 16-byte loads and stores (one for 8 bf16, two
// for 8 fp32) with streaming cache hints (__ldcs/__stcs: nothing is read
// twice), and a scalar path takes the ragged tail, or the whole leaf when a
// base address is not 16-byte aligned. No temporary goes to device memory.
// The update's grid covers the leaf, one step a thread (a grid-stride loop
// only past 2^22 blocks): on the H100 that read 88.8 % of the bytes bound
// at dbrx-132b's expert leaf, where a grid of 8 blocks an SM striding over
// the leaf read 78.8 % (82.1 % with two steps in flight a thread). The sum
// of squares reads 93 % with at most 8 blocks an SM, each block one partial
// sum.
//
// The update gives the eager body's bits: each eager kernel is one rounding
// here, in the eager order (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn, so
// nothing is contracted into an FMA), and the constants are what PyTorch
// makes of a Python scalar: the double cast to float, with 1 - b1 and 1 - b2
// taken in double first. The step's scalars (clip scale, learning rate, both
// bias corrections) are 0-d fp32 tensors read on the device, so nothing waits
// for the host. This file must be compiled without --use_fast_math.
//
// The sum of squares runs in two stages with no atomics: each block writes
// the fp32 sum of its share of one leaf to its own slot of a table of
// partial sums (one launch a leaf), and one block sums the table (one launch
// a tree). Each thread keeps 8 sums, the block adds them in a fixed tree, so
// the same inputs give the same bits on every call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;                 // elements a vector step
constexpr long long kMaxGrid = 1LL << 22;  // the update's largest grid

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 8 elements at the 16-byte-aligned address p, streamed.
__device__ __forceinline__ void load8(const float* p, float x[kVec]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float x[kVec]) {
  const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float x[kVec]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
  __stcs(reinterpret_cast<float4*>(p) + 1,
         make_float4(x[4], x[5], x[6], x[7]));
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float x[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
  __stcs(reinterpret_cast<uint4*>(p), u);
}

// The optimizer's constants, as PyTorch rounds Python scalars.
struct Consts {
  float b1, c1, b2, c2, eps, wd;
  int decay;  // the eager body adds wd * p only where wd is not 0
};

// The step's 0-d fp32 scalars, read once a thread.
struct Step {
  float scale, lr, b1c, b2c;
};

// One element, in the eager body's order (adamw.py::adamw_update_plain):
//   g = g * scale;  m = m * b1 + c1 * g;  v = v * b2 + c2 * (g * g);
//   delta = (m / b1c) / (sqrt(v / b2c) + eps);  delta += wd * p;
//   p = p - lr * delta.
__device__ __forceinline__ void adamw(float& p, float g, float& m, float& v,
                                      const Consts& k, const Step& s) {
  g = __fmul_rn(g, s.scale);
  m = __fadd_rn(__fmul_rn(m, k.b1), __fmul_rn(k.c1, g));
  v = __fadd_rn(__fmul_rn(v, k.b2), __fmul_rn(k.c2, __fmul_rn(g, g)));
  float delta = __fdiv_rn(
      __fdiv_rn(m, s.b1c),
      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.b2c)), k.eps));
  if (k.decay) delta = __fadd_rn(delta, __fmul_rn(k.wd, p));
  p = __fsub_rn(p, __fmul_rn(s.lr, delta));
}

template <typename P, typename G, bool VEC>
__global__ void __launch_bounds__(kThreads)
adamw_update_kernel(P* __restrict__ p, const G* __restrict__ g,
                    float* __restrict__ m, float* __restrict__ v, long long n,
                    const float* __restrict__ scale,
                    const float* __restrict__ lr,
                    const float* __restrict__ b1c,
                    const float* __restrict__ b2c, Consts k) {
  const Step s{*scale, *lr, *b1c, *b2c};
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  long long head = 0;  // elements the vector path covers
  if (VEC) {
    const long long nv = n / kVec;
    for (long long i = tid; i < nv; i += stride) {
      const long long o = i * kVec;
      float pp[kVec], gg[kVec], mm[kVec], vv[kVec];
      load8(p + o, pp);
      load8(g + o, gg);
      load8(m + o, mm);
      load8(v + o, vv);
#pragma unroll
      for (int e = 0; e < kVec; ++e) adamw(pp[e], gg[e], mm[e], vv[e], k, s);
      store8(p + o, pp);
      store8(m + o, mm);
      store8(v + o, vv);
    }
    head = nv * kVec;
  }
  for (long long i = head + tid; i < n; i += stride) {
    float pp = to_f(p[i]), mm = m[i], vv = v[i];
    adamw(pp, to_f(g[i]), mm, vv, k, s);
    put(p + i, pp);
    m[i] = mm;
    v[i] = vv;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, off));
  return x;
}

// out[blockIdx.x] = the fp32 sum over this block's share of x of x * x
// (SQUARE) or of x.
template <typename T, bool SQUARE, bool VEC>
__global__ void __launch_bounds__(kThreads)
sum_kernel(const T* __restrict__ x, long long n, float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  float acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.0f;
  long long head = 0;
  if (VEC) {
    const long long nv = n / kVec;
    for (long long i = tid; i < nv; i += stride) {
      float xx[kVec];
      load8(x + i * kVec, xx);
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        acc[e] = SQUARE ? __fmaf_rn(xx[e], xx[e], acc[e])
                        : __fadd_rn(acc[e], xx[e]);
    }
    head = nv * kVec;
  }
  for (long long i = head + tid; i < n; i += stride) {
    const float xi = to_f(x[i]);
    acc[0] = SQUARE ? __fmaf_rn(xi, xi, acc[0]) : __fadd_rn(acc[0], xi);
  }
  float t = __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]),
                                __fadd_rn(acc[2], acc[3])),
                      __fadd_rn(__fadd_rn(acc[4], acc[5]),
                                __fadd_rn(acc[6], acc[7])));
  t = warp_sum(t);
  __shared__ float warps[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warps[warp] = t;
  __syncthreads();
  if (warp == 0) {
    t = warp_sum(lane < kThreads / 32 ? warps[lane] : 0.0f);
    if (lane == 0) out[blockIdx.x] = t;
  }
}

bool aligned(const void* a) {
  return reinterpret_cast<uintptr_t>(a) % 16 == 0;
}

int grid_for(long long n) {
  const long long want = (n + kVec * kThreads - 1) / (kVec * kThreads);
  return static_cast<int>(want < kMaxGrid ? want : kMaxGrid);
}

template <typename P, typename G>
void launch_update(void* p, const void* g, void* m, void* v, long long n,
                   const float* const sc[4], const Consts& k,
                   cudaStream_t st) {
  P* pp = static_cast<P*>(p);
  const G* gg = static_cast<const G*>(g);
  float* mm = static_cast<float*>(m);
  float* vv = static_cast<float*>(v);
  const int grid = grid_for(n);
  if (aligned(p) && aligned(g) && aligned(m) && aligned(v))
    adamw_update_kernel<P, G, true><<<grid, kThreads, 0, st>>>(
        pp, gg, mm, vv, n, sc[0], sc[1], sc[2], sc[3], k);
  else
    adamw_update_kernel<P, G, false><<<grid, kThreads, 0, st>>>(
        pp, gg, mm, vv, n, sc[0], sc[1], sc[2], sc[3], k);
}

template <typename T, bool SQUARE>
void launch_sum(const void* x, long long n, float* out, int blocks,
                cudaStream_t st) {
  const T* xx = static_cast<const T*>(x);
  if (aligned(x))
    sum_kernel<T, SQUARE, true><<<blocks, kThreads, 0, st>>>(xx, n, out);
  else
    sum_kernel<T, SQUARE, false><<<blocks, kThreads, 0, st>>>(xx, n, out);
}

}  // namespace

// One AdamW step over a leaf of n elements, in place. p: parameters of dtype
// p_dtype, g: gradients of dtype g_dtype (0 = float32, 1 = bfloat16; the
// pairs (0, 0), (1, 1) and (1, 0)); m, v: fp32 moments; all contiguous.
// scale, lr, b1c, b2c: 0-d fp32 device tensors. b1, b2, eps, wd: the
// optimizer's Python floats. Launches on `stream`; returns cudaGetLastError
// (cudaErrorInvalidValue for another dtype pair or n < 1).
extern "C" int adamw_update_launch(void* p, const void* g, void* m, void* v,
                                   long long n, int p_dtype, int g_dtype,
                                   const void* scale, const void* lr,
                                   const void* b1c, const void* b2c,
                                   double b1, double b2, double eps,
                                   double wd, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Consts k{static_cast<float>(b1),  static_cast<float>(1.0 - b1),
                 static_cast<float>(b2),  static_cast<float>(1.0 - b2),
                 static_cast<float>(eps), static_cast<float>(wd),
                 wd != 0.0};
  const float* sc[4] = {static_cast<const float*>(scale),
                        static_cast<const float*>(lr),
                        static_cast<const float*>(b1c),
                        static_cast<const float*>(b2c)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p_dtype == 0 && g_dtype == 0)
    launch_update<float, float>(p, g, m, v, n, sc, k, st);
  else if (p_dtype == 1 && g_dtype == 1)
    launch_update<__nv_bfloat16, __nv_bfloat16>(p, g, m, v, n, sc, k, st);
  else if (p_dtype == 1 && g_dtype == 0)
    launch_update<__nv_bfloat16, float>(p, g, m, v, n, sc, k, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Stage 1 (square = 1): out[b] for b < blocks = the fp32 sum of x * x over
// block b's share of the n elements of x (dtype 0 = float32, 1 = bfloat16).
// Stage 2 (square = 0, blocks = 1, x the fp32 table): out[0] = the table's
// sum. n may be 0 (the sum is 0). Launches on `stream`; returns
// cudaGetLastError (cudaErrorInvalidValue for another dtype, a bf16 stage 2,
// n < 0 or blocks < 1).
extern "C" int sum_squares_launch(const void* x, long long n, int dtype,
                                  int square, void* out, int blocks,
                                  void* stream) {
  if (n < 0 || blocks < 1 || (dtype != 0 && (dtype != 1 || !square)))
    return static_cast<int>(cudaErrorInvalidValue);
  float* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!square) launch_sum<float, false>(x, n, o, blocks, st);
  else if (dtype == 0) launch_sum<float, true>(x, n, o, blocks, st);
  else launch_sum<__nv_bfloat16, true>(x, n, o, blocks, st);
  return static_cast<int>(cudaGetLastError());
}

// Flash attention backward for Hopper (sm_90a): dQ, dK and dV.
//
// The derivative of flash_attention.cu's forward. The reference trains
// through the jnp blockwise schedule (repro/models/attention.py), which XLA
// differentiates; the Pallas kernel repro/kernels/flash_attention.py::
// flash_attention defines no VJP. The port's attention runs the forward
// kernel on the card, so its derivative there is this kernel.
//
// Inputs: q (B, Sq, H, D), k (B, Sk, KV, D), v (B, Sk, KV, DV), the
// forward's output o (B, Sq, H, DV), the upstream gradient dO of o's shape,
// and the forward's per-row log-sum-exp lse (B, H, Sq) fp32, all contiguous;
// fp32 or bf16 (all but lse of one dtype); GQA (query head h reads KV head
// h / (H / KV)); the forward's mask (key j visible to query i when j < Sk,
// j <= i if causal and i - j < window if window > 0; positions from 0 in
// both). With s = q.k * D**-0.5:
//   P = exp(s - lse) on visible pairs, 0 elsewhere,
//   Delta_i = sum_c dO_ic o_ic                       (preprocess kernel)
//   dV = P^T dO,  dS = P * (dO V^T - Delta),
//   dQ = dS K * D**-0.5,  dK = dS^T Q * D**-0.5,
// dK and dV summed over the H / KV query heads of each KV head. Every sum is
// fp32; dQ, dK and dV are stored in the inputs' dtype. A row with no visible
// key has P = 0, so its dQ is zeros and it adds nothing to dK and dV.
//
// Deterministic: no atomics. Each output element is written by one thread,
// which sums in a fixed order. Three kernels on the caller's stream:
// * delta_kernel: one warp a row of dO and o, a fixed shuffle tree.
// * dkdv_kernel: one block per (32 keys, KV head, batch). K and V stay in
//   shared memory; the block loops over the group's query heads and over
//   their query tiles of 64 rows that can see its keys (causal: from the
//   tile of the first key on; window: up to the last key + window), and
//   keeps dK and dV in registers: thread (r, c) of 16 x 8 owns keys 2r and
//   2r + 1 and the columns 4c + 32 u of each.
// * dq_kernel: one block per (64 query rows, query head, batch), looping
//   over the key tiles of 64 the rows can see, dQ in registers (rows
//   4r .. 4r + 3, columns 4c + 32 u).
// Tiles are fp32 in shared memory, rows padded by 4 floats against bank
// conflicts; P^T and dS^T (dS in dq_kernel) go through shared memory
// between the two products of a tile.
//
// Bound: operations. At qwen2.5-3b's training shape (B 4, S 512, 16 query
// heads over 2 KV heads of 128, causal, bf16) the backward needs 2.5 times
// the forward's 4.29 GFLOP, about 10.7 GFLOP: 0.011 ms at the bf16
// tensor-core rate of 989.4 TFLOP/s, against about 37 MB of q, k, v, o, dO,
// lse, dQ, dK and dV (0.011 ms at 3.35 TB/s). This kernel runs on the CUDA
// cores (67 TFLOP/s of fp32) and recomputes S and dO V^T in both of its
// kernels (7 products where 5 would do), so it is bound far above that; the
// redesign for wgmma and TMA is ROADMAP Queue B row B4.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;   // query rows per tile
constexpr int kBKV = 32;  // keys per dkdv_kernel block
constexpr int kBK = 64;   // keys per dq_kernel tile
constexpr int kPad = 4;   // floats of padding per shared-memory row
constexpr int kLdQ = kBQ + kPad;   // a row of P^T / dS^T (dkdv_kernel)
constexpr int kLdK = kBK + kPad;   // a row of dS (dq_kernel)

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float4 gload4(const float* p) { return ld4(p); }

__device__ __forceinline__ float4 gload4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  *reinterpret_cast<uint32_t*>(&lo) = u.x;
  *reinterpret_cast<uint32_t*>(&hi) = u.y;
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void gstore4(float* p, float4 v) { st4(p, v); }

__device__ __forceinline__ void gstore4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

__device__ __forceinline__ void axpy4(float4& acc, float a, float4 x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

// Rows [0, rows) of kRows x W values of T (row stride `stride` elements)
// into fp32 shared memory with row stride W + kPad; zeros past rows.
template <typename T, int W, int kRows>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long stride, int rows) {
  constexpr int kChunks = W / 4;
  for (int idx = threadIdx.x; idx < kRows * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) v = gload4(src + r * stride + 4 * c);
    st4(dst + r * (W + kPad) + 4 * c, v);
  }
}

__device__ __forceinline__ bool visible(int i, int j, int sq, int sk,
                                        int causal, int window) {
  return i < sq && j < sk && (!causal || j <= i) &&
         (window <= 0 || i - j < window);
}

// delta[b, h, i] = sum_c dO[b, i, h, c] * o[b, i, h, c], one warp a row.
template <typename T, int DV>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
             float* __restrict__ delta, long long rows, int sq, int heads) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
  for (int c = 4 * lane; c < DV; c += 128) {
    acc = dot4(gload4(out + row * DV + c), gload4(dout + row * DV + c), acc);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) {
    // row = (b * sq + i) * heads + h
    const int h = static_cast<int>(row % heads);
    const long long bi = row / heads;
    const int i = static_cast<int>(bi % sq);
    const long long b = bi / sq;
    delta[(b * heads + h) * sq + i] = acc;
  }
}

// dK and dV of kBKV keys of one KV head, summed over its query heads.
template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int heads,
            int kv_heads, int causal, int window, float scale) {
  constexpr int kLdD = D + kPad;
  constexpr int kLdV = DV + kPad;
  constexpr int kColsD = D / 32;   // float4 columns of dK per thread
  constexpr int kColsV = DV / 32;  // float4 columns of dV per thread
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // kBKV x kLdD
  float* vs = ks + kBKV * kLdD;                 // kBKV x kLdV
  float* qs = vs + kBKV * kLdV;                 // kBQ x kLdD
  float* dos = qs + kBQ * kLdD;                 // kBQ x kLdV
  float* pt = dos + kBQ * kLdV;                 // kBKV x kLdQ: P^T
  float* dst = pt + kBKV * kLdQ;                // kBKV x kLdQ: dS^T
  float* lse_s = dst + kBKV * kLdQ;             // kBQ
  float* dl_s = lse_s + kBQ;                    // kBQ

  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * kBKV;
  const int k_rows = min(kBKV, sk - k0);
  const int group = heads / kv_heads;
  const int tr = threadIdx.x / 8;  // keys 2 tr, 2 tr + 1
  const int tc = threadIdx.x % 8;  // queries tc + 8 u; columns 4 tc + 32 u

  const long long q_stride = static_cast<long long>(heads) * D;
  const long long o_stride = static_cast<long long>(heads) * DV;
  const long long k_stride = static_cast<long long>(kv_heads) * D;
  const long long v_stride = static_cast<long long>(kv_heads) * DV;
  const long long k_off =
      (static_cast<long long>(b) * sk + k0) * k_stride +
      static_cast<long long>(kh) * D;
  const long long v_off =
      (static_cast<long long>(b) * sk + k0) * v_stride +
      static_cast<long long>(kh) * DV;
  load_rows<T, D, kBKV>(ks, k + k_off, k_stride, k_rows);
  load_rows<T, DV, kBKV>(vs, v + v_off, v_stride, k_rows);

  // Queries that may see keys [k0, k0 + k_rows): [q_lo, q_hi).
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(sq, k0 + k_rows - 1 + window) : sq;

  float4 acc_k[2][kColsD], acc_v[2][kColsV];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int c = 0; c < kColsD; ++c) acc_k[a][c] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < kColsV; ++c) acc_v[a][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int g = 0; g < group; ++g) {
    const int h = kh * group + g;
    const float* lse_h = lse + (static_cast<long long>(b) * heads + h) * sq;
    const float* dl_h = delta + (static_cast<long long>(b) * heads + h) * sq;
    for (int q0 = q_lo / kBQ * kBQ; q0 < q_hi; q0 += kBQ) {
      const int q_rows = min(kBQ, sq - q0);
      __syncthreads();  // the previous tile is no longer read
      const long long qo = (static_cast<long long>(b) * sq + q0);
      load_rows<T, D, kBQ>(qs, q + qo * q_stride + static_cast<long long>(h) * D,
                           q_stride, q_rows);
      load_rows<T, DV, kBQ>(dos,
                            dout + qo * o_stride + static_cast<long long>(h) * DV,
                            o_stride, q_rows);
      if (threadIdx.x < kBQ) {
        const bool in = threadIdx.x < q_rows;
        lse_s[threadIdx.x] = in ? lse_h[q0 + threadIdx.x] : 0.f;
        dl_s[threadIdx.x] = in ? dl_h[q0 + threadIdx.x] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for keys 2 tr + a, queries tc + 8 u.
      float s[2][8], dp[2][8];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int u = 0; u < 8; ++u) s[a][u] = dp[a][u] = 0.f;
      for (int d = 0; d < D; d += 4) {
        const float4 k0v = ld4(ks + (2 * tr) * kLdD + d);
        const float4 k1v = ld4(ks + (2 * tr + 1) * kLdD + d);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float4 qv = ld4(qs + (tc + 8 * u) * kLdD + d);
          s[0][u] = dot4(k0v, qv, s[0][u]);
          s[1][u] = dot4(k1v, qv, s[1][u]);
        }
      }
      for (int c = 0; c < DV; c += 4) {
        const float4 v0 = ld4(vs + (2 * tr) * kLdV + c);
        const float4 v1 = ld4(vs + (2 * tr + 1) * kLdV + c);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float4 ov = ld4(dos + (tc + 8 * u) * kLdV + c);
          dp[0][u] = dot4(v0, ov, dp[0][u]);
          dp[1][u] = dot4(v1, ov, dp[1][u]);
        }
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int key = 2 * tr + a;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int qi = tc + 8 * u;
          const bool ok = visible(q0 + qi, k0 + key, sq, sk, causal, window);
          const float p = ok ? expf(s[a][u] * scale - lse_s[qi]) : 0.f;
          pt[key * kLdQ + qi] = p;
          dst[key * kLdQ + qi] = p * (dp[a][u] - dl_s[qi]);
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q over this tile's queries.
      for (int i = 0; i < kBQ; i += 4) {
        const float4 p0 = ld4(pt + (2 * tr) * kLdQ + i);
        const float4 p1 = ld4(pt + (2 * tr + 1) * kLdQ + i);
        const float4 g0 = ld4(dst + (2 * tr) * kLdQ + i);
        const float4 g1 = ld4(dst + (2 * tr + 1) * kLdQ + i);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pa = e == 0 ? p0.x : e == 1 ? p0.y : e == 2 ? p0.z : p0.w;
          const float pb = e == 0 ? p1.x : e == 1 ? p1.y : e == 2 ? p1.z : p1.w;
          const float ga = e == 0 ? g0.x : e == 1 ? g0.y : e == 2 ? g0.z : g0.w;
          const float gb = e == 0 ? g1.x : e == 1 ? g1.y : e == 2 ? g1.z : g1.w;
          const float* orow = dos + (i + e) * kLdV + 4 * tc;
          const float* qrow = qs + (i + e) * kLdD + 4 * tc;
#pragma unroll
          for (int c = 0; c < kColsV; ++c) {
            const float4 ov = ld4(orow + 32 * c);
            axpy4(acc_v[0][c], pa, ov);
            axpy4(acc_v[1][c], pb, ov);
          }
#pragma unroll
          for (int c = 0; c < kColsD; ++c) {
            const float4 qv = ld4(qrow + 32 * c);
            axpy4(acc_k[0][c], ga, qv);
            axpy4(acc_k[1][c], gb, qv);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int key = 2 * tr + a;
    if (key >= k_rows) continue;
    T* krow = dk + k_off + key * k_stride + 4 * tc;
    T* vrow = dv + v_off + key * v_stride + 4 * tc;
#pragma unroll
    for (int c = 0; c < kColsD; ++c) {
      const float4 x = acc_k[a][c];
      gstore4(krow + 32 * c,
              make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale));
    }
#pragma unroll
    for (int c = 0; c < kColsV; ++c) gstore4(vrow + 32 * c, acc_v[a][c]);
  }
}

// dQ of kBQ query rows of one query head.
template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int sq, int sk, int heads, int kv_heads,
          int causal, int window, float scale) {
  constexpr int kLdD = D + kPad;
  constexpr int kLdV = DV + kPad;
  constexpr int kColsD = D / 32;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // kBQ x kLdD
  float* dos = qs + kBQ * kLdD;                 // kBQ x kLdV
  float* ks = dos + kBQ * kLdV;                 // kBK x kLdD
  float* vs = ks + kBK * kLdD;                  // kBK x kLdV
  float* dss = vs + kBK * kLdV;                 // kBQ x kLdK: dS
  float* lse_s = dss + kBQ * kLdK;              // kBQ
  float* dl_s = lse_s + kBQ;                    // kBQ

  const int qt = gridDim.x - 1 - blockIdx.x;  // late (heavy) tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (heads / kv_heads);
  const int q0 = qt * kBQ;
  const int q_rows = min(kBQ, sq - q0);
  const int tr = threadIdx.x / 8;  // rows 4 tr .. 4 tr + 3
  const int tc = threadIdx.x % 8;  // keys tc + 8 u; columns 4 tc + 32 u

  const long long q_stride = static_cast<long long>(heads) * D;
  const long long o_stride = static_cast<long long>(heads) * DV;
  const long long k_stride = static_cast<long long>(kv_heads) * D;
  const long long v_stride = static_cast<long long>(kv_heads) * DV;
  const long long qo = static_cast<long long>(b) * sq + q0;
  load_rows<T, D, kBQ>(qs, q + qo * q_stride + static_cast<long long>(h) * D,
                       q_stride, q_rows);
  load_rows<T, DV, kBQ>(dos, dout + qo * o_stride + static_cast<long long>(h) * DV,
                        o_stride, q_rows);
  if (threadIdx.x < kBQ) {
    const long long at = (static_cast<long long>(b) * heads + h) * sq + q0;
    const bool in = threadIdx.x < q_rows;
    lse_s[threadIdx.x] = in ? lse[at + threadIdx.x] : 0.f;
    dl_s[threadIdx.x] = in ? delta[at + threadIdx.x] : 0.f;
  }

  // Keys any row of this tile may see: [k_lo, k_hi).
  const int k_hi = causal ? min(sk, q0 + q_rows) : sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  float4 acc[4][kColsD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kColsD; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int kt = k_lo; kt < k_hi; kt += kBK) {
    const int k_rows = min(kBK, sk - kt);
    __syncthreads();  // the previous tile is no longer read
    const long long ko = static_cast<long long>(b) * sk + kt;
    load_rows<T, D, kBK>(ks, k + ko * k_stride + static_cast<long long>(kh) * D,
                         k_stride, k_rows);
    load_rows<T, DV, kBK>(vs, v + ko * v_stride + static_cast<long long>(kh) * DV,
                          v_stride, k_rows);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for rows 4 tr + i, keys tc + 8 u.
    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < 8; ++u) s[i][u] = dp[i][u] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = ld4(qs + (4 * tr + i) * kLdD + d);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float4 kv = ld4(ks + (tc + 8 * u) * kLdD + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][u] = dot4(qv[i], kv, s[i][u]);
      }
    }
    for (int c = 0; c < DV; c += 4) {
      float4 ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ov[i] = ld4(dos + (4 * tr + i) * kLdV + c);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float4 vv = ld4(vs + (tc + 8 * u) * kLdV + c);
#pragma unroll
        for (int i = 0; i < 4; ++i) dp[i][u] = dot4(ov[i], vv, dp[i][u]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 4 * tr + i;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int key = tc + 8 * u;
        const bool ok = visible(q0 + row, kt + key, sq, sk, causal, window);
        const float p = ok ? expf(s[i][u] * scale - lse_s[row]) : 0.f;
        dss[row * kLdK + key] = p * (dp[i][u] - dl_s[row]);
      }
    }
    __syncthreads();

    // dQ += dS K over this tile's keys.
    for (int j = 0; j < kBK; j += 4) {
      float4 g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) g[i] = ld4(dss + (4 * tr + i) * kLdK + j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* krow = ks + (j + e) * kLdD + 4 * tc;
#pragma unroll
        for (int c = 0; c < kColsD; ++c) {
          const float4 kv = ld4(krow + 32 * c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float gi = e == 0 ? g[i].x : e == 1 ? g[i].y
                           : e == 2 ? g[i].z : g[i].w;
            axpy4(acc[i][c], gi, kv);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = 4 * tr + i;
    if (row >= q_rows) continue;
    T* drow = dq + (qo + row) * q_stride + static_cast<long long>(h) * D +
              4 * tc;
#pragma unroll
    for (int c = 0; c < kColsD; ++c) {
      const float4 x = acc[i][c];
      gstore4(drow + 32 * c,
              make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale));
    }
  }
}

template <typename T, int D, int DV>
int launch_bwd(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int batch, int sq, int sk, int heads,
               int kv_heads, int causal, int window, cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* o_ = static_cast<const T*>(out);
  const T* do_ = static_cast<const T*>(dout);
  // D ** -0.5 as the reference computes it, in double, then rounded.
  const float scale = static_cast<float>(pow(static_cast<double>(D), -0.5));

  const long long rows = static_cast<long long>(batch) * sq * heads;
  const long long delta_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (delta_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  delta_kernel<T, DV><<<static_cast<unsigned>(delta_blocks), kThreads, 0,
                        stream>>>(o_, do_, delta, rows, sq, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr size_t kv_smem =
      sizeof(float) * (kBKV * static_cast<size_t>(D + kPad) +
                       kBKV * static_cast<size_t>(DV + kPad) +
                       kBQ * static_cast<size_t>(D + kPad) +
                       kBQ * static_cast<size_t>(DV + kPad) +
                       2 * kBKV * static_cast<size_t>(kLdQ) + 2 * kBQ);
  err = cudaFuncSetAttribute(dkdv_kernel<T, D, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kv_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 kv_grid(static_cast<unsigned>((sk + kBKV - 1) / kBKV),
                     static_cast<unsigned>(kv_heads),
                     static_cast<unsigned>(batch));
  dkdv_kernel<T, D, DV><<<kv_grid, kThreads, kv_smem, stream>>>(
      q_, k_, v_, do_, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      sq, sk, heads, kv_heads, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr size_t q_smem =
      sizeof(float) * (kBQ * static_cast<size_t>(D + kPad) +
                       kBQ * static_cast<size_t>(DV + kPad) +
                       kBK * static_cast<size_t>(D + kPad) +
                       kBK * static_cast<size_t>(DV + kPad) +
                       kBQ * static_cast<size_t>(kLdK) + 2 * kBQ);
  static_assert(q_smem <= 232448 && kv_smem <= 232448,
                "tiles exceed shared memory");
  err = cudaFuncSetAttribute(dq_kernel<T, D, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(q_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 q_grid(static_cast<unsigned>((sq + kBQ - 1) / kBQ),
                    static_cast<unsigned>(heads),
                    static_cast<unsigned>(batch));
  dq_kernel<T, D, DV><<<q_grid, kThreads, q_smem, stream>>>(
      q_, k_, v_, do_, lse, delta, static_cast<T*>(dq), sq, sk, heads,
      kv_heads, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int DV>
int launch_dtype(const void* q, const void* k, const void* v, const void* out,
                 const void* dout, const float* lse, float* delta, void* dq,
                 void* dk, void* dv, int batch, int sq, int sk, int heads,
                 int kv_heads, int causal, int window, int dtype,
                 cudaStream_t s) {
  if (dtype == 0) {
    return launch_bwd<float, D, DV>(q, k, v, out, dout, lse, delta, dq, dk,
                                    dv, batch, sq, sk, heads, kv_heads,
                                    causal, window, s);
  }
  if (dtype == 1) {
    return launch_bwd<__nv_bfloat16, D, DV>(q, k, v, out, dout, lse, delta,
                                            dq, dk, dv, batch, sq, sk, heads,
                                            kv_heads, causal, window, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (batch, sq, heads, head_dim), k (batch, sk, kv_heads, head_dim), v
// (batch, sk, kv_heads, v_head_dim), out and dout (batch, sq, heads,
// v_head_dim): one dtype (0: float32, 1: bfloat16), contiguous, 16-byte
// aligned; lse (batch, heads, sq) fp32 from the forward; delta a scratch
// of lse's shape; dq, dk, dv of q's, k's and v's shapes and dtype, every
// element written. (head_dim, v_head_dim) one of (64, 64), (96, 96),
// (128, 128) and (192, 128); causal 0/1; window <= 0 for none. Launches
// three kernels on `stream`; returns cudaGetLastError, or
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int batch, int sq, int sk, int heads, int kv_heads,
    int head_dim, int v_head_dim, int causal, int window, int dtype,
    void* stream) {
  if (batch <= 0 || heads <= 0 || (sq <= 0 && sk <= 0)) return 0;
  if (kv_heads <= 0 || heads % kv_heads != 0 || sq < 0 || sk < 0 ||
      batch > 65535 || heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sq == 0 || sk == 0) {
    // No pairs: the gradients that exist are zeros.
    const size_t el = dtype == 0 ? 4 : 2;
    cudaError_t err = cudaSuccess;
    if (sq > 0) {
      err = cudaMemsetAsync(dq, 0,
                            el * batch * static_cast<size_t>(sq) * heads *
                                head_dim, s);
    } else {
      err = cudaMemsetAsync(dk, 0,
                            el * batch * static_cast<size_t>(sk) * kv_heads *
                                head_dim, s);
      if (err == cudaSuccess) {
        err = cudaMemsetAsync(dv, 0,
                              el * batch * static_cast<size_t>(sk) *
                                  kv_heads * v_head_dim, s);
      }
    }
    return static_cast<int>(err);
  }
  const int shape = head_dim * 1000 + v_head_dim;
  switch (shape) {
    case 64064:
      return launch_dtype<64, 64>(q, k, v, out, dout, lse, delta, dq, dk, dv,
                                  batch, sq, sk, heads, kv_heads, causal,
                                  window, dtype, s);
    case 96096:
      return launch_dtype<96, 96>(q, k, v, out, dout, lse, delta, dq, dk, dv,
                                  batch, sq, sk, heads, kv_heads, causal,
                                  window, dtype, s);
    case 128128:
      return launch_dtype<128, 128>(q, k, v, out, dout, lse, delta, dq, dk,
                                    dv, batch, sq, sk, heads, kv_heads,
                                    causal, window, dtype, s);
    case 192128:
      return launch_dtype<192, 128>(q, k, v, out, dout, lse, delta, dq, dk,
                                    dv, batch, sq, sk, heads, kv_heads,
                                    causal, window, dtype, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

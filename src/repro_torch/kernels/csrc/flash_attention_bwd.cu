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
// both). With s = q.k * D**-0.5, or under a logit softcap c > 0 (a runtime
// argument; <= 0 for none) s = c tanh(q.k * D**-0.5 / c), whose derivative
// f = 1 - tanh^2 multiplies dS:
//   P = exp(s - lse) on visible pairs, 0 elsewhere,
//   Delta_i = sum_j P_ij dP_ij (= sum_c dO_ic o_ic, which the CUDA-core
//             design sums from o),
//   dV = P^T dO,  dS = P * (dO V^T - Delta) (* f under the cap),
//   dQ = dS K * D**-0.5,  dK = dS^T Q * D**-0.5,
// dK and dV summed over the H / KV query heads of each KV head. Every sum is
// fp32; dQ, dK and dV are stored in the inputs' dtype. A row with no visible
// key has P = 0, so its dQ is zeros and it adds nothing to dK and dV.
//
// A row of dS sums to 0, so dQ_i = sum_j dS_ij K_j sees only the keys'
// differences: where the keys share a large mean (a cross-attention over
// near-identical memory rows), an error e in a row's dS sum adds e times
// that mean to dQ and can exceed dQ itself. The tensor-core design keeps
// that sum 0 to fp32 rounding. Its Delta is sum_j P_ij dP_ij / sum_j P_ij
// over its own P and dP: Delta from the bf16 o is off by 2**-9 of |dO||o|,
// from an fp32 o it would still be off by the forward's bf16 P, and
// sum_j P_ij is 1 only up to exp2's and lse's rounding. And dQ's product
// runs on dS's bf16 part and again on the bf16 of its residual: dS as one
// bf16 operand is 2**-9 off a term, the pair about 2**-17.
//
// Deterministic: no atomics. Each output element is written by one thread,
// which sums in a fixed order; two launches agree bit for bit. Two designs,
// chosen by dtype in flash_attention_bwd_launch (and mirrored by
// kernels/flash_attention.py::bwd_design):
//
// Tensor cores: bf16 at every (D, DV), the reduced configs' (16, 16),
// (24, 24), (24, 16) and (32, 32) (kernels of their own with boxes as wide
// as the head and tiles of 128 along the sequence: dkdv_narrow_kernel and
// dq_narrow_kernel, below the others'), (64, 64), (96, 96) (phi-3-vision:
// tiles of 64 + 32 columns, below), (128, 128) (the training path:
// qwen2.5-3b, qwen3-14b, starcoder2-15b), MLA's (192, 128)
// (deepseek-v2-236b; no cap: MLA passes none, and dkdv_mla_kernel takes
// none) and gemma3-12b's (256, 256) (its kernels apart, below the
// others'). Under a cap every pass recomputes P from the capped scores
// (tanhf a score) and dS takes f, one uniform branch a tile: the Delta
// pass sums P dP of the capped P, the dQ kernels multiply dS by f from
// the score they hold, dkdv_256_kernel hands P^T f to its key warpgroup,
// and dkdv_tc_kernel (and dkdv_narrow_kernel) reads t back from P^T (t =
// (log2 P^T + lse log2(e)) / (c log2(e))) rather than keep it beside dK
// and dV, which spilled.
// Four launches at 64 to 192 (the narrow pairs and 256 launch kernels of
// their own in the same order, the narrow pairs without lse_kernel):
// * lse_kernel: lse * log2(e) of every row into scratch rows padded to a
//   multiple of 128 queries (zeros past Sq), so that a tile's 64 values
//   are one 256-byte bulk copy, and zeros into Delta's rows.
// * dq_tc_kernel<..., true>, the Delta pass: the dQ kernel's loop below
//   without its dQ product, summing P dP of each row over its key tiles in
//   a fixed order (a thread's columns, then a quad's shuffle), into
//   Delta's rows below Sq.
// * dkdv_tc_kernel: a cluster of 1 or 2 blocks of 384 threads per (64
//   keys, KV head, batch) (at D 96 one block per 128 keys: below), heavy
//   (early, under causality) key tiles first; the launch takes 2 where one
//   block a key tile would give fewer than two
//   blocks an SM (at qwen2.5-3b's training shape: 128 blocks, the heaviest
//   with 32 pairs, where one block a key tile would give 64 blocks, the
//   heaviest with 64; clusters of 4 measured slower, their exchange costing
//   more than their shorter loops gained). In each block a producer
//   warpgroup gives up its registers (setmaxnreg); one of its
//   threads loads K and V once by TMA and then streams the block's share of
//   the key tile's (query head, query tile of 64) pairs, head outer, through
//   a ring of 4 stages (Q, dO, 64 lse and 64 Delta each). Block r of a
//   cluster of n takes pairs 2 n m + 2 r + c, its consumer warpgroup c
//   (c = 0, 1) every other one, so any group size works; each consumer
//   keeps its own fp32 dK and dV of the 64 keys in registers. Per pair:
//   S^T = K Q^T and dP^T = V dO^T on wgmma m64n64 (both operands K-major in
//   shared memory); P^T = exp2(S^T * D**-0.5 * log2(e) - lse * log2(e)),
//   masked per score only on tiles that cross the diagonal, the window's
//   edge, Sq or Sk; dV += P^T dO with P^T converted to bf16 in registers as
//   the A operand (the accumulator fragment is the A fragment) and dO read
//   MN-major (the transpose bit); dS^T = P^T * (dP^T - Delta) in registers,
//   then dK += dS^T Q the same way. At the end the two consumers add their
//   partial sums through shared memory (over the ring), consumer 0's
//   first, each block pushes the half it does not own to the other block
//   of its cluster through distributed shared memory, and each block adds
//   the two blocks' sums of its half, block 0's first, scales dK and
//   stores.
//   At (192, 128) a consumer's fp32 dK (96 registers a thread) and dV (64)
//   beside S^T and dP^T (32 each) would not fit the 240 registers that
//   setmaxnreg gives it, so dkdv_mla_kernel takes its place: one block per
//   (two key tiles of 64, KV head, batch), tile z and tile T - 1 - z so
//   that every block has the same causal work, no cluster, all of a key
//   tile's pairs through a ring of 4 stages. Its two consumers split each
//   pair's work, not the pairs: the score warpgroup runs S^T and dP^T,
//   builds P^T and dS^T as above and stores both in bf16, 128-byte
//   swizzled, into shared memory; the gradient warpgroup holds the whole
//   dK and dV of a key tile and runs dV += P^T dO (n128) and dK += dS^T Q
//   (n128 + n64) with both operands in shared memory (A K-major, B
//   MN-major). The two halves of a pair take about the same tensor-core
//   time (20 k16 steps of n64 each), no product runs twice, P and dS are
//   the same bf16 operands as in the register design, and nothing is left
//   to add at the end: the gradient warpgroup stores its sums as they
//   stand. The blocks of one KV head, and (at G 1) the dQ kernel's and the
//   Delta pass's blocks of one query head, run side by side: at
//   deepseek's training shape Q and dO take 168 MB, K and V as much, far
//   more than L2, and a head's tiles are then read from device memory
//   once, not once a block.
// * dq_tc_kernel: one block of 384 threads per (128 query rows, query head,
//   batch), heavy (late) query tiles first, on a second stream beside
//   dkdv_tc_kernel so that its blocks take the SMs the other leaves; Q and
//   dO of the two consumers' 64 rows each stay resident, K and V tiles of
//   64 keys arrive through a ring of 2 stages. Per tile: S = Q K^T, dP = dO
//   V^T (m64n64, shared operands), P and dS in registers, dQ += dS K with
//   dS as bf16 register A operands (its bf16 part, then its residual's)
//   and K read MN-major. S and dO V^T are computed again here and in the
//   Delta pass: 10 products where 5 would do, the price of having no
//   atomics and of exact row sums of dS.
// Operands arrive by TMA (4-D tensor maps over (D, heads, S, B) with the
// tensors' own strides, boxes of 64 columns by 64 rows, 128-byte swizzle;
// hopper.cuh holds these pieces, shared with the forward). D 96 is a box of
// 64 columns and a tail box of the last 32 (64-byte rows, 64-byte swizzle,
// through tail tensor maps of their own), so that no column is zero-filled:
// a tile is 12 KB, not 16; S^T and dP^T take 4 k16 steps in the first box
// and 2 in the tail, dV, dK and dQ run n64 + n32, and a consumer's dK and
// dV are 48 + 48 registers a thread, not 64 + 64. There a dK/dV block
// takes 128 keys, 64 a consumer, both consumers reading every pair, so it
// needs no cluster and no reduction (kSplitKeys: 233 against 310 us of
// the layout alone at phi-3-vision's training batch on an H100 80GB HBM3
// at 700 W, PERF.md). D 192 is three boxes; its dK and dQ products run as
// n128 over columns 0-127 and n64 over 128-191. Rows past Sq or Sk are
// zero-filled and masked. P and dS in bf16 change each term of dV, dK and
// dQ by at most 2**-9 relative.
//
// CUDA cores: fp32 at every (D, DV), whose 2e-4 tolerance needs exact fp32
// sums that bf16 or TF32 products cannot hold. Shared-memory rows of D and
// DV are padded with zeros to a multiple of 32 columns, so that a thread's
// columns 4c + 32u cover heads of 16 and 24; the stores stop at D and DV.
// Under a cap P and dS take tanhf a score; Delta stays rowsum(dO o), exact
// for the capped softmax too.
// * delta_kernel: one warp a row of dO and o, a fixed shuffle tree.
// * dkdv_kernel: one block per (32 keys, KV head, batch). K and V stay in
//   shared memory; the block loops over the group's query heads and over
//   their query tiles of 64 rows that can see its keys (causal: from the
//   tile of the first key on; window: up to the last key + window), and
//   keeps dK and dV in registers: thread (r, c) of 16 x 8 owns keys 2r and
//   2r + 1 and the columns 4c + 32 u of each.
// * dq_kernel: one block per (64 query rows, query head, batch), looping
//   over the key tiles of 64 the rows can see, dQ in registers (rows
//   4r .. 4r + 3, columns 4c + 32 u). At (256, 256) Q, dO, K and V tiles
//   would take 284 KB, so K and V share one buffer in turn (DqSmem): dO V^T
//   first, then K replaces V for S and dQ.
// Tiles are fp32 in shared memory, rows padded by 4 floats against bank
// conflicts; P^T and dS^T (dS in dq_kernel) go through shared memory
// between the two products of a tile.
//
// Bound: operations and bytes alike. At qwen2.5-3b's training shape (B 4,
// S 512, 16 query heads over 2 KV heads of 128, causal, bf16) the backward
// needs 2.5 times the forward's 4.29 GFLOP, about 10.7 GFLOP: 0.011 ms at
// the bf16 tensor-core rate of 989.4 TFLOP/s, against about 37 MB of q, k,
// v, o, dO, lse, dQ, dK and dV (0.011 ms at 3.35 TB/s). The tensor-core
// design runs 21.5 GFLOP there (S and dO V^T three times: in the dK/dV
// kernel, the Delta pass and the dQ kernel; dQ's product twice). What stands
// between it and the bound: the dK/dV kernel's n64 products, whose shared
// operands take as long to read as to multiply, the waits between a pair's
// dependent products (S^T before P^T before dV, dP^T before dS^T before
// dK), and the few pairs a block has at S 512 (at most 16 here), which its
// fixed costs (K and V, the ring's first fill, the cluster's reduction)
// weigh on. Overlapping a pair's dK with the next pair's products measured
// slower, and was left out (as did, at MLA's shape, running the score
// warpgroup's next products, or the Delta pass's next tile, beside this
// one's softmax: the two register sets hold a stage more of the ring). At
// deepseek-v2-236b's training shape (B 4, S 512, 128 heads of 192 over
// 128, causal) the backward needs about 112 GFLOP and 672 MB (0.20 ms at
// 3.35 TB/s); this design runs 224 GFLOP there. At gemma3-12b's (B 2, S
// 2,048, 16 heads of 256 over 8, causal) it needs 171.9 GFLOP (0.174 ms);
// the design at 256 runs 12 D + 8 DV operations a visible pair, 2.0 times
// that (S and dO V^T in each of its three kernels, dQ's product twice).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernels
// ---------------------------------------------------------------------------

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

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

__device__ __forceinline__ void axpy4(float4& acc, float a, float4 x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

// Rows [0, rows) of kRows x W floats (row stride `stride` elements) into
// shared memory with row stride kW + kPad (kW >= W); zeros past rows and in
// columns W .. kW - 1.
template <int W, int kRows, int kW = W>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int rows) {
  constexpr int kChunks = kW / 4;
  for (int idx = threadIdx.x; idx < kRows * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows && 4 * c < W) v = ld4(src + r * stride + 4 * c);
    st4(dst + r * (kW + kPad) + 4 * c, v);
  }
}

// P of one score s (q.k) of a visible pair (`ok`; 0 otherwise) under a
// logit softcap (<= 0 for none): exp(s' - lse), s' = s * scale, or with the
// cap c tanh(s * scale / c); `f` receives the cap's derivative (1 - t)(1 +
// t), t = tanh(s * scale / c), which dS takes (1 without a cap).
__device__ __forceinline__ float prob(float s, float lse, float scale,
                                      float softcap, bool ok, float& f) {
  float x = s * scale;
  f = 1.f;
  if (softcap > 0.f) {
    const float t = tanhf(x / softcap);
    x = softcap * t;
    f = cap_grad(t);
  }
  return ok ? expf(x - lse) : 0.f;
}

__device__ __forceinline__ bool visible(int i, int j, int sq, int sk,
                                        int causal, int window) {
  return i < sq && j < sk && (!causal || j <= i) &&
         (window <= 0 || i - j < window);
}

// delta[b, h, i] = sum_c dO[b, i, h, c] * o[b, i, h, c], one warp a row.
template <int DV>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const float* __restrict__ out, const float* __restrict__ dout,
             float* __restrict__ delta, long long rows, int sq, int heads) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
  for (int c = 4 * lane; c < DV; c += 128) {
    acc = dot4(ld4(out + row * DV + c), ld4(dout + row * DV + c), acc);
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
template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int sq, int sk,
            int heads, int kv_heads, int causal, int window, float scale,
            float softcap) {
  // Rows of D and DV padded to 32 columns (zeros), so that a thread's
  // columns 4c + 32u cover heads of 16 and 24 too; stored below D, DV.
  constexpr int kDp = pad32(D);
  constexpr int kDVp = pad32(DV);
  constexpr int kLdD = kDp + kPad;
  constexpr int kLdV = kDVp + kPad;
  constexpr int kColsD = kDp / 32;   // float4 columns of dK per thread
  constexpr int kColsV = kDVp / 32;  // float4 columns of dV per thread
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
  load_rows<D, kBKV, kDp>(ks, k + k_off, k_stride, k_rows);
  load_rows<DV, kBKV, kDVp>(vs, v + v_off, v_stride, k_rows);

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
      load_rows<D, kBQ, kDp>(qs,
                             q + qo * q_stride + static_cast<long long>(h) * D,
                             q_stride, q_rows);
      load_rows<DV, kBQ, kDVp>(
          dos, dout + qo * o_stride + static_cast<long long>(h) * DV,
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
          float f;
          const float p = prob(s[a][u], lse_s[qi], scale, softcap, ok, f);
          pt[key * kLdQ + qi] = p;
          dst[key * kLdQ + qi] = p * (dp[a][u] - dl_s[qi]) * f;
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
    float* krow = dk + k_off + key * k_stride + 4 * tc;
    float* vrow = dv + v_off + key * v_stride + 4 * tc;
#pragma unroll
    for (int c = 0; c < kColsD; ++c) {
      if (4 * tc + 32 * c >= D) continue;  // the rows' zero padding
      const float4 x = acc_k[a][c];
      st4(krow + 32 * c,
              make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale));
    }
#pragma unroll
    for (int c = 0; c < kColsV; ++c) {
      if (4 * tc + 32 * c < DV) st4(vrow + 32 * c, acc_v[a][c]);
    }
  }
}

// dq_kernel's shared memory in floats: the Q and dO tiles, the K and V
// tiles, dS, and the tile's lse and Delta. Where K and V would not fit
// beside the rest (D = DV = 256: 284 KB), they take one buffer in turn.
template <int D, int DV>
struct DqSmem {
  static constexpr size_t kLdD = pad32(D) + kPad;   // rows padded as in
  static constexpr size_t kLdV = pad32(DV) + kPad;  // dkdv_kernel
  static constexpr size_t kKv = kBK * kLdD + kBK * kLdV;
  static constexpr size_t kRest =
      kBQ * kLdD + kBQ * kLdV + kBQ * static_cast<size_t>(kLdK) + 2 * kBQ;
  static constexpr bool kOneBuf = sizeof(float) * (kKv + kRest) > 232448;
  static constexpr size_t kFloats = kRest + (kOneBuf ? kBK * kLdD : kKv);
  static_assert(!kOneBuf || D == DV, "one K/V buffer needs D == DV");
  static_assert(sizeof(float) * kFloats <= 232448,
                "tiles exceed shared memory");
};

// dQ of kBQ query rows of one query head.
template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int sq, int sk, int heads, int kv_heads,
          int causal, int window, float scale, float softcap) {
  constexpr int kDp = pad32(D);
  constexpr int kDVp = pad32(DV);
  constexpr int kLdD = kDp + kPad;
  constexpr int kLdV = kDVp + kPad;
  constexpr int kColsD = kDp / 32;
  constexpr bool kOneBuf = DqSmem<D, DV>::kOneBuf;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // kBQ x kLdD
  float* dos = qs + kBQ * kLdD;                 // kBQ x kLdV
  float* ks = dos + kBQ * kLdV;                 // kBK x kLdD
  float* vs = kOneBuf ? ks : ks + kBK * kLdD;   // kBK x kLdV
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
  load_rows<D, kBQ, kDp>(qs, q + qo * q_stride + static_cast<long long>(h) * D,
                         q_stride, q_rows);
  load_rows<DV, kBQ, kDVp>(
      dos, dout + qo * o_stride + static_cast<long long>(h) * DV, o_stride,
      q_rows);
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
    const float* kt_ = k + ko * k_stride + static_cast<long long>(kh) * D;
    if constexpr (!kOneBuf) {
      load_rows<D, kBK, kDp>(ks, kt_, k_stride, k_rows);
    }
    load_rows<DV, kBK, kDVp>(
        vs, v + ko * v_stride + static_cast<long long>(kh) * DV, v_stride,
        k_rows);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for rows 4 tr + i, keys tc + 8 u (with one
    // K/V buffer, dP first, then K loaded over V for S).
    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < 8; ++u) s[i][u] = dp[i][u] = 0.f;
    const auto scores = [&]() {
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
    };
    if constexpr (!kOneBuf) scores();
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
    if constexpr (kOneBuf) {
      __syncthreads();  // every warp is done with V
      load_rows<D, kBK, kDp>(ks, kt_, k_stride, k_rows);
      __syncthreads();
      scores();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 4 * tr + i;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int key = tc + 8 * u;
        const bool ok = visible(q0 + row, kt + key, sq, sk, causal, window);
        float f;
        const float p = prob(s[i][u], lse_s[row], scale, softcap, ok, f);
        dss[row * kLdK + key] = p * (dp[i][u] - dl_s[row]) * f;
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
    float* drow = dq + (qo + row) * q_stride + static_cast<long long>(h) * D +
              4 * tc;
#pragma unroll
    for (int c = 0; c < kColsD; ++c) {
      if (4 * tc + 32 * c >= D) continue;  // the rows' zero padding
      const float4 x = acc[i][c];
      st4(drow + 32 * c,
              make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale));
    }
  }
}

template <int D, int DV>
int launch_bwd(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int batch, int sq, int sk, int heads,
               int kv_heads, int causal, int window, float softcap,
               cudaStream_t stream) {
  const float* q_ = static_cast<const float*>(q);
  const float* k_ = static_cast<const float*>(k);
  const float* v_ = static_cast<const float*>(v);
  const float* o_ = static_cast<const float*>(out);
  const float* do_ = static_cast<const float*>(dout);
  // D ** -0.5 as the reference computes it, in double, then rounded.
  const float scale = static_cast<float>(pow(static_cast<double>(D), -0.5));

  const long long rows = static_cast<long long>(batch) * sq * heads;
  const long long delta_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (delta_blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  delta_kernel<DV><<<static_cast<unsigned>(delta_blocks), kThreads, 0,
                        stream>>>(o_, do_, delta, rows, sq, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr size_t kv_smem =  // rows padded as in dkdv_kernel
      sizeof(float) * ((kBKV + kBQ) * (DqSmem<D, DV>::kLdD +
                                       DqSmem<D, DV>::kLdV) +
                       2 * kBKV * static_cast<size_t>(kLdQ) + 2 * kBQ);
  err = smem_limit(reinterpret_cast<const void*>(dkdv_kernel<D, DV>),
                   kv_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 kv_grid(static_cast<unsigned>((sk + kBKV - 1) / kBKV),
                     static_cast<unsigned>(kv_heads),
                     static_cast<unsigned>(batch));
  dkdv_kernel<D, DV><<<kv_grid, kThreads, kv_smem, stream>>>(
      q_, k_, v_, do_, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv),
      sq, sk, heads, kv_heads, causal, window, scale, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr size_t q_smem = sizeof(float) * DqSmem<D, DV>::kFloats;
  static_assert(kv_smem <= 232448, "tiles exceed shared memory");
  err = smem_limit(reinterpret_cast<const void*>(dq_kernel<D, DV>), q_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 q_grid(static_cast<unsigned>((sq + kBQ - 1) / kBQ),
                    static_cast<unsigned>(heads),
                    static_cast<unsigned>(batch));
  dq_kernel<D, DV><<<q_grid, kThreads, q_smem, stream>>>(
      q_, k_, v_, do_, lse, delta, static_cast<float*>(dq), sq, sk, heads,
      kv_heads, causal, window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernels
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 384;         // 2 consumer warpgroups + 1 producer
constexpr int kTile = 64;               // rows of a box: keys or queries
constexpr uint32_t kBox = kTile * 128;  // bytes of one box of 64 columns
constexpr int kKvStages = 4;            // dkdv_tc_kernel's (Q, dO) ring
constexpr int kQStages = 2;             // dq_tc_kernel's (K, V) ring
constexpr int kQRows = 128;             // query rows per dq_tc_kernel block
constexpr int kMaxCluster = 2;          // dkdv_tc_kernel blocks per cluster
constexpr size_t kSmemMax = 232448;     // a block's dynamic shared memory

// Shared-memory plans of the two kernels for head dims D and DV: a 64-row
// tile of D columns is kDBoxes boxes of 64 and, at 96, a tail box of the
// last 32 (tail_cols: 64-byte rows, 64-byte swizzle), so that no column is
// zero-filled; the dK and dQ products are n kN = D, dV's n kNV = DV.
template <int D, int DV>
struct BwdTiles {
  static constexpr int kTail = tail_cols(D);    // columns of the tail box
  static constexpr int kVTail = tail_cols(DV);  // (0: none)
  static constexpr int kDBoxes = (D - kTail) / kBoxCols;
  static constexpr int kVBoxes = (DV - kVTail) / kBoxCols;
  static constexpr int kN = kDBoxes * kBoxCols + kTail;
  static constexpr int kNV = kVBoxes * kBoxCols + kVTail;
  static constexpr uint32_t kQk = kDBoxes * kBox + kTile * 2 * kTail;
  static constexpr uint32_t kV = kVBoxes * kBox + kTile * 2 * kVTail;
  // dkdv: 64-key tiles of K and V a block (two at D 96, where the
  // consumers split the block's keys: dkdv_tc_kernel), then the ring; a
  // stage is Q, dO, 64 lse * log2(e) and 64 Delta, padded to keep the next
  // stage 1,024-byte aligned.
  static constexpr bool kSplitKeys = kTail > 0;
  static constexpr int kKvTiles = kSplitKeys ? 2 : 1;
  static constexpr uint32_t kStage = kQk + kV + 1024;
  static constexpr size_t kKvSmem = kKvTiles * static_cast<size_t>(kQk + kV) +
                                    kKvStages * static_cast<size_t>(kStage) +
                                    1024;
  // dq: two consumers' Q and dO, then the ring of K and V.
  static constexpr size_t kQSmem =
      (2 + kQStages) * static_cast<size_t>(kQk + kV) + 1024;
  static_assert(kKvSmem <= kSmemMax && kQSmem <= kSmemMax,
                "tiles exceed shared memory");
  static_assert(kTail == kVTail && (kTail == 0 || kTail == 32),
                "a tail box of 32 columns, at D = DV = 96 only");
  // No box is zero-filled past the head and no product is wider than it:
  // at 96 the tiles are 64 + 32 columns and the products n64 + n32.
  static_assert(kN == D && kNV == DV, "boxes cover the heads exactly");
  static_assert(kN <= 192 && kNV <= 128,
                "products are n64, n96 or n128 (n192 as n128 + n64)");
  // dkdv: a consumer's partial dK and dV, kPairs pairs of fp32 accumulator
  // registers a thread; both consumers' go over the ring at the end.
  static constexpr int kPairs = (kN + kNV) / 4;
  static_assert(2 * 128 * kPairs * sizeof(float2) <=
                    kKvStages * static_cast<size_t>(kStage),
                "partial sums exceed the ring");
  static_assert(kPairs % (2 * kMaxCluster) == 0,
                "the reduction splits the pairs over the cluster");
};

// wgmma descriptor of k16 step kk of a K-major 64-row tile at `t`: 32 bytes
// a step into a box, four steps a box.
__device__ __forceinline__ uint64_t kmajor(uint32_t t, int kk) {
  return sw128_desc(t + (kk / 4) * kBox + 32 * (kk % 4), 16, 1024);
}

// wgmma descriptor of k16 step kk (rows 16 kk .. 16 kk + 15) of an MN-major
// 64-row tile at `t`: the next 64 columns are the next box.
__device__ __forceinline__ uint64_t mnmajor(uint32_t t, int kk) {
  return sw128_desc(t + 2048 * kk, kBox, 1024);
}

// d (64 x 64) = A B^T over K columns, A and B 64-row tiles at `a` and `b`,
// both K-major (S = Q K^T, dP = dO V^T and their transposes). K of 96: 4
// steps in the box of 64 columns, then 2 in the tail box after it (64-byte
// rows).
template <int K>
__device__ __forceinline__ void product_abt(float (&d)[32], uint32_t a,
                                            uint32_t b) {
  constexpr int kTail = tail_cols(K);
  constexpr int kFull = (K - kTail) / 16;  // steps in the boxes of 64
  wgmma_m64n64k16_ss_first(d, kmajor(a, 0), kmajor(b, 0));
#pragma unroll
  for (int kk = 1; kk < kFull; ++kk) {
    wgmma_m64n64k16_ss(d, kmajor(a, kk), kmajor(b, kk));
  }
  if constexpr (kTail > 0) {
    constexpr uint32_t kAt = (K - kTail) / kBoxCols * kBox;  // the tail box
#pragma unroll
    for (int kk = 0; kk < kTail / 16; ++kk) {
      wgmma_m64n64k16_ss(d, narrow_kmajor<2 * kTail>(a + kAt, kk),
                         narrow_kmajor<2 * kTail>(b + kAt, kk));
    }
  }
}

// acc (64 x N) += A B: A (64 x 64) in bf16 registers, a[4 kk .. 4 kk + 3]
// its k16 step kk; B the 64-row tile at `b`, MN-major (dV += P^T dO,
// dK += dS^T Q, dQ += dS K).
template <int N>
__device__ __forceinline__ void product_ab(float (&acc)[N / 2],
                                           const uint32_t (&a)[16],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (N == 96) {
      // Columns 0-63 (the box of 64), then 64-95 (the tail box, 64-byte
      // rows): element 32 + i of acc is element i of the n32 fragment, as
      // in an n96 one.
      wgmma_m64n64k16_rs(*reinterpret_cast<float(*)[32]>(acc), a[4 * kk],
                         a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
                         mnmajor(b, kk));
      wgmma_m64n32k16_rs(*reinterpret_cast<float(*)[16]>(acc + 32),
                         a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                         a[4 * kk + 3], narrow_mnmajor<64>(b + kBox, kk));
    } else if constexpr (N == 192) {
      // Columns 0-127 (boxes 0 and 1), then 128-191 (box 2): element
      // 64 + i of acc is element i of the n64 fragment, as in an n192 one.
      wgmma_m64n128k16_rs(*reinterpret_cast<float(*)[64]>(acc), a[4 * kk],
                          a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
                          mnmajor(b, kk));
      wgmma_m64n64k16_rs(*reinterpret_cast<float(*)[32]>(acc + 64),
                         a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                         a[4 * kk + 3], mnmajor(b + 2 * kBox, kk));
    } else if constexpr (N == 128) {
      wgmma_m64n128k16_rs(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                          a[4 * kk + 3], mnmajor(b, kk));
    } else {
      wgmma_m64n64k16_rs(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                         a[4 * kk + 3], mnmajor(b, kk));
    }
  }
}

// The A fragment of a 64 x 2N accumulator fragment: bf16 pairs in order
// (k16 step kk is a[4 kk .. 4 kk + 3]).
template <int N>
__device__ __forceinline__ void to_a_operand(const float (&x)[N],
                                             uint32_t (&a)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) a[i] = pack_bf16(x[2 * i], x[2 * i + 1]);
}

// Whether the tile of kQ queries from q0 and kK keys from k0 needs a
// per-score mask (it crosses Sq, Sk, the diagonal or the window's edge),
// and whether any of its pairs is visible at all.
template <int kQ, int kK>
__device__ __forceinline__ bool tile_masked(int q0, int k0, int sq, int sk,
                                            int causal, int window) {
  return q0 + kQ > sq || k0 + kK > sk || (causal && k0 + kK - 1 > q0) ||
         (window > 0 && q0 + kQ - 1 - k0 >= window);
}

template <int kQ, int kK>
__device__ __forceinline__ bool tile_sees(int q0, int k0, int sq, int sk,
                                          int causal, int window) {
  const int q_last = min(q0 + kQ, sq) - 1;
  const int k_last = min(k0 + kK, sk) - 1;
  return q_last >= q0 && k_last >= k0 && (!causal || k0 <= q_last) &&
         (window <= 0 || q0 - k_last < window);
}

// lse * log2(e) of each row (b, h, i), i < sq_pad, into scratch rows of
// sq_pad (zeros past Sq), and zeros into Delta's rows (the Delta pass of
// dq_tc_kernel fills those below Sq).
__global__ void __launch_bounds__(kThreads)
lse_kernel(const float* __restrict__ lse, float* __restrict__ lse2,
           float* __restrict__ delta, long long rows, int sq, int sq_pad) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= rows) return;
  const int i = static_cast<int>(row % sq_pad);
  const long long bh = row / sq_pad;  // b * heads + h
  lse2[row] = i < sq ? lse[bh * sq + i] * 1.4426950408889634f : 0.f;
  delta[row] = 0.f;
}

// The dQ kernels' pass over one 64 x kKeys tile of S and dP (rows r0 and
// r0 + 8, keys k0 + 8 jj + c0 and + 1 of a thread's fragment): P =
// exp2(S scale log2(e) - lse log2(e)) (of the capped scores under a cap),
// 0 where masked (`masked`: the tile needs a per-score mask); then
// s = dS = P (dP - Delta), times the cap's derivative under a cap; or, in
// the Delta pass (kDelta), dl += P dP and ps += P over the visible pairs.
// The cap is one uniform branch a tile. kMask 0 or 1 fixes `masked` at
// compile time (the narrow kernels branch once a tile, so that a tile
// without a mask tests no score); -1 reads it.
template <bool kDelta, int kKeys = 64, int kMask = -1>
__device__ __forceinline__ void scores_to_ds(
    float (&s)[kKeys / 2], const float (&dp)[kKeys / 2], const float (&l2)[2],
    float (&dl)[2], float (&ps)[2], Scaling sc, bool masked, int r0, int k0,
    int c0, int sq, int sk, int causal, int window) {
  const auto tile = [&](auto cap) {
    constexpr bool kCap = decltype(cap)::value;
#pragma unroll
    for (int jj = 0; jj < kKeys / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        float t;
        const float p =
            exp2_approx(score_arg<kCap>(s[4 * jj + e], l2[r], sc, t));
        const bool ok =
            kMask == 0 || (kMask == -1 && !masked) ||
            visible(r0 + 8 * r, k0 + 8 * jj + c0 + e % 2, sq, sk, causal,
                    window);
        if constexpr (kDelta) {
          if (ok) {
            dl[r] = fmaf(p, dp[4 * jj + e], dl[r]);
            ps[r] += p;
          }
        } else {
          float ds = p * (dp[4 * jj + e] - dl[r]);
          if constexpr (kCap) ds *= cap_grad(t);
          s[4 * jj + e] = ok ? ds : 0.f;
        }
      }
    }
  };
  if (sc.cap_log2 > 0.f) {
    tile(Flag<true>{});
  } else {
    tile(Flag<false>{});
  }
}

// One 64-row tile of a head of d columns into shared memory at `dst` (rows
// from `row` of head `h`, batch `b`; bytes complete on `bar`): its boxes of
// 64 columns through `map`, then at d 96 the tail box of the last 32
// through `tail`.
template <int d>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          const CUtensorMap* tail,
                                          uint32_t bar, int h, int row,
                                          int b) {
  constexpr int kBoxes = (d - tail_cols(d)) / kBoxCols;
  for (int c = 0; c < kBoxes; ++c) {
    tma_load_4d(dst + c * kBox, map, bar, c * kBoxCols, h, row, b);
  }
  if constexpr (tail_cols(d) > 0) {
    tma_load_4d(dst + kBoxes * kBox, tail, bar, kBoxes * kBoxCols, h, row,
                b);
  }
}

// dK and dV of 64 keys of one KV head, summed over its query heads, by a
// cluster of blocks that split the (query head, query tile) pairs. The maps
// tq_t .. tdo_t take the tail boxes at D 96 (unread elsewhere). At D 96
// (kSplitKeys) a block takes 128 keys instead and no cluster: consumer wg
// holds keys k0 + 64 wg .. + 63 and reads every pair (skipping those its
// keys cannot see), so each holds its keys' whole dK and dV and stores them
// as they stand, with nothing to add across consumers or blocks.
template <int D, int DV>
__global__ void __launch_bounds__(kTcThreads, 1)
dkdv_tc_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tq_t,
               const __grid_constant__ CUtensorMap tk_t,
               const __grid_constant__ CUtensorMap tv_t,
               const __grid_constant__ CUtensorMap tdo_t,
               const float* __restrict__ lse2, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               int sq, int sk, int sq_pad, int heads, int kv_heads,
               int causal, int window, Scaling sc, float scale) {
  using Tiles = BwdTiles<D, DV>;
  constexpr int kN = Tiles::kN;
  constexpr int kNV = Tiles::kNV;
  constexpr bool kSplitKeys = Tiles::kSplitKeys;
  constexpr int kKeys = kSplitKeys ? 2 * kTile : kTile;  // keys a block
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kKvStages];
  // Swizzle atoms must be 1024-byte aligned: the launch adds 1 KB of slack.
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_s = base;  // kKvTiles tiles of K, then as many of V
  const uint32_t v_s = base + Tiles::kKvTiles * Tiles::kQk;
  const auto q_s = [&](int st) {
    return base + Tiles::kKvTiles * (Tiles::kQk + Tiles::kV) +
           st * Tiles::kStage;
  };
  const auto do_s = [&](int st) { return q_s(st) + Tiles::kQk; };
  const auto stats_s = [&](int st) { return do_s(st) + Tiles::kV; };
  const uint32_t bar0 = smem_u32(bars);
  const uint32_t kv_full = bar0;
  const auto full = [&](int st) { return bar0 + 8 * (1 + st); };
  const auto empty = [&](int st) { return bar0 + 8 * (1 + kKvStages + st); };

  // The cluster's blocks (along x) share a key tile: block `rank` of `ranks`
  // takes pairs 2 ranks m + 2 rank + c (m = 0, 1, ...), its consumer c
  // (c = 0, 1) every other one of them.
  const int ranks = static_cast<int>(cluster_size());
  const int rank = static_cast<int>(cluster_rank());
  const int kh = blockIdx.x / ranks;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kKeys;  // early key tiles (causal: heavy) first
  const int group = heads / kv_heads;
  // Queries that may see keys [k0, k_last]: [q_lo, q_hi), in tiles of 64.
  const int k_last = min(k0 + kKeys, sk) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(sq, k_last + window) : sq;
  const int qt_lo = q_lo / kTile;
  const int n_qt = q_hi > q_lo ? (q_hi + kTile - 1) / kTile - qt_lo : 0;
  const int n_pairs = group * n_qt;  // pair i: head i / n_qt, tile i % n_qt
  // This block's pair of local index li (its ring index).
  const auto pair_of = [&](int li) {
    return kSplitKeys ? li : 2 * ranks * (li / 2) + 2 * rank + li % 2;
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kKvStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kSplitKeys ? 256 : 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp >= 8) {
    // Producer warpgroup: one thread issues every load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(kv_full, Tiles::kKvTiles * (Tiles::kQk + Tiles::kV));
      for (int c = 0; c < Tiles::kKvTiles; ++c) {
        load_tile<D>(k_s + c * Tiles::kQk, &tk, &tk_t, kv_full, kh,
                     k0 + c * kTile, b);
        load_tile<DV>(v_s + c * Tiles::kV, &tv, &tv_t, kv_full, kh,
                      k0 + c * kTile, b);
      }
      for (int li = 0; pair_of(li) < n_pairs; ++li) {
        const int i = pair_of(li);
        const int st = li % kKvStages;
        const int h = kh * group + i / n_qt;
        const int q0 = (qt_lo + i % n_qt) * kTile;
        mbar_wait(empty(st), ((li / kKvStages) & 1) ^ 1);  // round 0 passes
        mbar_expect_tx(full(st), Tiles::kQk + Tiles::kV + 512);
        load_tile<D>(q_s(st), &tq, &tq_t, full(st), h, q0, b);
        load_tile<DV>(do_s(st), &tdo, &tdo_t, full(st), h, q0, b);
        const long long row =
            (static_cast<long long>(b) * heads + h) * sq_pad + q0;
        bulk_load(stats_s(st), lse2 + row, 256, full(st));
        bulk_load(stats_s(st) + 256, delta + row, 256, full(st));
      }
    }
    // Every block's threads stay for the cluster's two barriers below.
    if constexpr (!kSplitKeys) {
      cluster_sync();
      cluster_sync();
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");

  // Consumers: warpgroup wg takes local pairs wg, wg + 2, ... (kSplitKeys:
  // every pair, for its keys kw .. kw + 63); of the 64 x 64
  // fragments this thread owns rows (keys) kr and kr + 8 and, of every 8
  // columns (queries), c0 and c0 + 1: element 4j + e is key kr + 8 (e / 2),
  // query 8j + c0 + e % 2.
  const int wg = warp / 4;
  const int lane = threadIdx.x % 32;
  const int c0 = 2 * (lane % 4);
  const int kr = 16 * (warp % 4) + lane / 4;
  const int kw = kSplitKeys ? k0 + kTile * wg : k0;  // the consumer's keys
  const uint32_t k_wg = kSplitKeys ? k_s + wg * Tiles::kQk : k_s;
  const uint32_t v_wg = kSplitKeys ? v_s + wg * Tiles::kV : v_s;
  float dk_acc[kN / 2], dv_acc[kNV / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) dk_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kNV / 2; ++i) dv_acc[i] = 0.f;
  mbar_wait(kv_full, 0);

#pragma unroll 1
  for (int li = kSplitKeys ? 0 : wg; pair_of(li) < n_pairs;
       li += kSplitKeys ? 1 : 2) {
    const int st = li % kKvStages;
    const int q0 = (qt_lo + pair_of(li) % n_qt) * kTile;
    mbar_wait(full(st), (li / kKvStages) & 1);
    if (kSplitKeys &&
        !tile_sees<kTile, kTile>(q0, kw, sq, sk, causal, window)) {
      mbar_arrive(empty(st));  // nothing of this pair reaches its keys
      continue;
    }
    const float* stats =
        reinterpret_cast<const float*>(smem_raw + (stats_s(st) - raw));
    float s[32], dp[32];
    wgmma_fence();
    product_abt<D>(s, k_wg, q_s(st));
    wgmma_commit();
    product_abt<DV>(dp, v_wg, do_s(st));
    wgmma_commit();
    wgmma_wait<1>();  // S^T is in
    hold(s);

    // P^T = exp2(S^T scale log2(e) - lse log2(e)), 0 where masked (under
    // the cap, of the capped scores).
    const bool masked =
        tile_masked<kTile, kTile>(q0, kw, sq, sk, causal, window);
    const bool capped = sc.cap_log2 > 0.f;
    const auto probs = [&](auto cap) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(stats + 8 * j + c0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float t;
          const float x = exp2_approx(score_arg<decltype(cap)::value>(
              s[4 * j + e], e % 2 ? l2.y : l2.x, sc, t));
          s[4 * j + e] = masked && !visible(q0 + 8 * j + c0 + e % 2,
                                            kw + kr + 8 * (e / 2), sq, sk,
                                            causal, window)
                             ? 0.f
                             : x;
        }
      }
    };
    if (capped) {
      probs(Flag<true>{});
    } else {
      probs(Flag<false>{});
    }
    uint32_t pa[16];
    to_a_operand(s, pa);
    hold(dv_acc);
    wgmma_fence();
    product_ab<kNV>(dv_acc, pa, do_s(st));  // dV += P^T dO
    wgmma_commit();
    wgmma_wait<0>();  // dP^T and dV are in
    hold(dp);
    hold(dv_acc);
    hold(pa);

    // dS^T = P^T (dP^T - Delta). Under the cap also times its derivative
    // 1 - t^2, t = (log2(P^T) + lse log2(e)) / (c log2(e)) read back from
    // P^T (a P^T of 0 adds nothing): keeping t beside S^T, dP^T and dK
    // and dV would spill.
    if (capped) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dl =
            *reinterpret_cast<const float2*>(stats + 64 + 8 * j + c0);
        const float2 l2 =
            *reinterpret_cast<const float2*>(stats + 8 * j + c0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = s[4 * j + e];
          const float t =
              p > 0.f ? (log2f(p) + (e % 2 ? l2.y : l2.x)) / sc.cap_log2
                      : 0.f;
          s[4 * j + e] =
              p * (dp[4 * j + e] - (e % 2 ? dl.y : dl.x)) * cap_grad(t);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dl =
            *reinterpret_cast<const float2*>(stats + 64 + 8 * j + c0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[4 * j + e] *= dp[4 * j + e] - (e % 2 ? dl.y : dl.x);
        }
      }
    }
    uint32_t da[16];
    to_a_operand(s, da);
    hold(dk_acc);
    wgmma_fence();
    product_ab<kN>(dk_acc, da, q_s(st));  // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    hold(dk_acc);
    hold(da);
    mbar_arrive(empty(st));
  }

  if constexpr (kSplitKeys) {
    // Register pair p of dK is key kw + kr + 8 (p % 2), columns 8 (p / 2)
    // + c0 and + 1; dV's likewise.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = kw + kr + 8 * r;
      if (key >= sk) continue;
      const long long at =
          (static_cast<long long>(b) * sk + key) * kv_heads + kh;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dk + at * D + 8 * j + c0) =
            pack_bf16(dk_acc[4 * j + 2 * r] * scale,
                      dk_acc[4 * j + 2 * r + 1] * scale);
      }
#pragma unroll
      for (int j = 0; j < kNV / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dv + at * DV + 8 * j + c0) =
            pack_bf16(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
      }
    }
    return;
  }

  // The cluster's blocks own equal runs of the kPairs register pairs (dK's
  // kN / 4, then dV's): block r pairs [r P, r P + P) (P = kPairs / ranks).
  // Once every block is done with its ring, consumer 1 hands its dK and
  // consumer 0 its dV to the other through shared memory; consumer 0 adds
  // consumer 1's dK to its own, consumer 1 its dV to consumer 0's, and each
  // pushes the block's sum of pair r P + i of thread t to block r's ring at
  // (q P + i) * 128 + t (q this block's rank). Then each block sums its own
  // pairs over the cluster in rank order and stores them: every output
  // element has one writer and one order of sums.
  constexpr int kPairs = Tiles::kPairs;
  const int per = kPairs / ranks;
  const int t = threadIdx.x % 128;
  const uint32_t handed = q_s(0);                    // kPairs pairs
  const uint32_t recv = handed + kPairs * 128 * 8;   // ranks * P pairs
  const auto slot = [&](uint32_t area, int i) {
    return area + (i * 128 + t) * 8;
  };
  const auto local = [&](uint32_t addr) {
    return reinterpret_cast<float2*>(smem_raw + (addr - raw));
  };
  cluster_sync();  // every ring of the cluster is free
  if (wg == 1) {
#pragma unroll
    for (int p = 0; p < kN / 4; ++p) {
      *local(slot(handed, p)) = make_float2(dk_acc[2 * p], dk_acc[2 * p + 1]);
    }
  } else {
#pragma unroll
    for (int p = 0; p < kNV / 4; ++p) {
      *local(slot(handed, kN / 4 + p)) =
          make_float2(dv_acc[2 * p], dv_acc[2 * p + 1]);
    }
  }
  named_barrier(1, 256);
  const auto push = [&](int p, float2 v) {
    st_cluster_f2(slot(recv, rank * per + p % per), p / per, v);
  };
  if (wg == 0) {
#pragma unroll
    for (int p = 0; p < kN / 4; ++p) {
      const float2 x = *local(slot(handed, p));
      push(p, make_float2(dk_acc[2 * p] + x.x, dk_acc[2 * p + 1] + x.y));
    }
  } else {
#pragma unroll
    for (int p = 0; p < kNV / 4; ++p) {
      const float2 x = *local(slot(handed, kN / 4 + p));
      push(kN / 4 + p,
           make_float2(x.x + dv_acc[2 * p], x.y + dv_acc[2 * p + 1]));
    }
  }
  cluster_sync();  // every push has landed
  // Thread t's fragment rows (keys) kr and kr + 8, columns c0 and c0 + 1 of
  // every 8: register pair p of dK is key kr + 8 (p % 2), columns
  // 8 (p / 2) + c0 and + 1; dV's pair p - kN / 4 likewise.
#pragma unroll 1
  for (int i = wg * per / 2; i < (wg + 1) * per / 2; ++i) {
    float2 sum = *local(slot(recv, i));
    for (int q = 1; q < ranks; ++q) {
      const float2 x = *local(slot(recv, q * per + i));
      sum.x += x.x;
      sum.y += x.y;
    }
    const int p = rank * per + i;
    const bool is_k = p < kN / 4;
    const int pp = is_k ? p : p - kN / 4;
    const int key = k0 + kr + 8 * (pp % 2);
    const int col = 8 * (pp / 2) + c0;
    if (key >= sk || col >= (is_k ? D : DV)) continue;
    const long long at =
        (static_cast<long long>(b) * sk + key) * kv_heads + kh;
    if (is_k) {
      *reinterpret_cast<uint32_t*>(dk + at * D + col) =
          pack_bf16(sum.x * scale, sum.y * scale);
    } else {
      *reinterpret_cast<uint32_t*>(dv + at * DV + col) =
          pack_bf16(sum.x, sum.y);
    }
  }
}

// MLA's (192, 128): dK and dV of two tiles of 64 keys of one KV head (tile
// z and tile T - 1 - z), summed over its query heads, by one block whose
// two consumers split the work of a pair rather than the pairs: the score
// warpgroup (0) runs S^T and dP^T and hands P^T and dS^T in bf16 to the
// gradient warpgroup (1) through shared memory; the gradient warpgroup
// holds the whole fp32 dK (96 registers a thread) and dV (64) of a key tile
// and runs dV += P^T dO and dK += dS^T Q with both operands in shared
// memory. No partial sums to add at the end, and no product runs twice.
// Ring depths as measured best at deepseek-v2's training shape (PERF.md):
// 4 (Q, dO) stages beside one P^T / dS^T stage (3 beside 2, and one key
// tile a block, were 1 % and 4 % slower).
constexpr int kMlaStages = 4;  // dkdv_mla_kernel's (Q, dO) ring
constexpr int kMlaHand = 1;    // its P^T / dS^T stages

template <int D, int DV>
struct MlaTiles {
  using Tiles = BwdTiles<D, DV>;
  // K and V, the (Q, dO, lse, Delta) ring, then the P^T / dS^T stages
  // (two 64 x 64 bf16 tiles each), and 1 KB of alignment slack.
  static constexpr size_t kSmem =
      Tiles::kQk + Tiles::kV + kMlaStages * static_cast<size_t>(Tiles::kStage) +
      kMlaHand * 2 * static_cast<size_t>(kBox) + 1024;
  static_assert(kSmem <= kSmemMax, "tiles exceed shared memory");
  static_assert(Tiles::kN == 192 && Tiles::kNV == 128,
                "the gradient warpgroup's products are n128 + n64 and n128");
};

// Stores x (64 x 64 fp32 accumulator fragment: element 4j + e at row
// kr + 8 (e / 2), column 8j + c0 + e % 2) as bf16 into the 64-row tile at
// `t` (a byte offset from smem_raw), K-major and 128-byte swizzled as TMA
// lays out a box: row r's 16-byte chunk c sits at chunk c ^ (r % 8) of its
// 128-byte line.
__device__ __forceinline__ void store_swizzled(uint8_t* t, const float (&x)[32],
                                               int kr, int c0) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = kr + 8 * r;
      *reinterpret_cast<uint32_t*>(t + (row / 8) * 1024 + (row % 8) * 128 +
                                   ((j ^ (row % 8)) * 16) + 2 * c0) =
          pack_bf16(x[4 * j + 2 * r], x[4 * j + 2 * r + 1]);
    }
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(kTcThreads, 1)
dkdv_mla_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ lse2, const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                int sq, int sk, int sq_pad, int heads, int kv_heads,
                int causal, int window, Scaling sc, float scale) {
  using Tiles = BwdTiles<D, DV>;
  constexpr int kN = Tiles::kN;
  constexpr int kNV = Tiles::kNV;
  (void)MlaTiles<D, DV>::kSmem;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 + 2 * kMlaStages + 2 * kMlaHand];
  // Swizzle atoms must be 1024-byte aligned: the launch adds 1 KB of slack.
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_s = base;
  const uint32_t v_s = base + Tiles::kQk;
  const auto q_s = [&](int st) {
    return base + Tiles::kQk + Tiles::kV + st * Tiles::kStage;
  };
  const auto do_s = [&](int st) { return q_s(st) + Tiles::kQk; };
  const auto stats_s = [&](int st) { return do_s(st) + Tiles::kV; };
  const auto p_s = [&](int hs) {  // P^T, then dS^T one box on
    return q_s(kMlaStages) + hs * 2 * kBox;
  };
  const uint32_t bar0 = smem_u32(bars);
  const uint32_t kv_full = bar0;
  const uint32_t kv_empty = bar0 + 8;
  const auto full = [&](int st) { return bar0 + 8 * (2 + st); };
  const auto empty = [&](int st) { return bar0 + 8 * (2 + kMlaStages + st); };
  const auto handed = [&](int hs) {
    return bar0 + 8 * (2 + 2 * kMlaStages + hs);
  };
  const auto taken = [&](int hs) {
    return bar0 + 8 * (2 + 2 * kMlaStages + kMlaHand + hs);
  };

  // Grid (key tile pairs, KV heads, batch): the blocks of one KV head side
  // by side, so that its query heads' Q and dO tiles, which every key tile
  // reads, come from device memory once.
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = heads / kv_heads;
  // The block's key tiles of 64: tile z, then tile T - 1 - z (one tile
  // where they meet), so that under causality every block has the same
  // pairs, and the second tile's K/V load overlaps the first's last pairs.
  const int z = blockIdx.x;
  const int n_kt = (sk + kTile - 1) / kTile;
  const int n_t = n_kt - 1 - z > z ? 2 : 1;
  struct Keys {
    int k0, qt_lo, n_qt, first;  // first: ring index of its first pair
  };
  const auto keys = [&](int t) {
    Keys ks;
    ks.k0 = (t == 0 ? z : n_kt - 1 - z) * kTile;
    // Queries that may see keys [k0, k_last]: [q_lo, q_hi), in tiles of 64.
    const int k_last = min(ks.k0 + kTile, sk) - 1;
    const int q_lo = causal ? ks.k0 : 0;
    const int q_hi = window > 0 ? min(sq, k_last + window) : sq;
    ks.qt_lo = q_lo / kTile;
    ks.n_qt = q_hi > q_lo ? (q_hi + kTile - 1) / kTile - ks.qt_lo : 0;
    ks.first = 0;
    return ks;
  };
  // Pair i of a tile: head i / n_qt, query tile i % n_qt.
  const Keys first = keys(0);
  Keys second = keys(n_t - 1);
  second.first = group * first.n_qt;
  const auto tile = [&](int t) { return t == 0 ? first : second; };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 128);
    for (int st = 0; st < kMlaStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 256);  // both consumers read every stage
    }
    for (int hs = 0; hs < kMlaHand; ++hs) {
      mbar_init(handed(hs), 128);
      mbar_init(taken(hs), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp >= 8) {
    // Producer warpgroup: one thread loads each tile's K and V (the second
    // once the score warpgroup is done with the first), another streams
    // every pair's Q, dO, lse and Delta through the ring.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (threadIdx.x == 288) {
      for (int t = 0; t < n_t; ++t) {
        if (t > 0) mbar_wait(kv_empty, 0);
        mbar_expect_tx(kv_full, Tiles::kQk + Tiles::kV);
        for (int c = 0; c < Tiles::kDBoxes; ++c) {
          tma_load_4d(k_s + c * kBox, &tk, kv_full, c * kBoxCols, kh,
                      tile(t).k0, b);
        }
        for (int c = 0; c < Tiles::kVBoxes; ++c) {
          tma_load_4d(v_s + c * kBox, &tv, kv_full, c * kBoxCols, kh,
                      tile(t).k0, b);
        }
      }
    }
    if (threadIdx.x != 256) return;
    for (int t = 0; t < n_t; ++t) {
      const Keys ks = tile(t);
      for (int i = 0; i < group * ks.n_qt; ++i) {
        const int g = ks.first + i;  // ring index
        const int st = g % kMlaStages;
        const int h = kh * group + i / ks.n_qt;
        const int q0 = (ks.qt_lo + i % ks.n_qt) * kTile;
        mbar_wait(empty(st), ((g / kMlaStages) & 1) ^ 1);  // round 0 passes
        mbar_expect_tx(full(st), Tiles::kQk + Tiles::kV + 512);
        for (int c = 0; c < Tiles::kDBoxes; ++c) {
          tma_load_4d(q_s(st) + c * kBox, &tq, full(st), c * kBoxCols, h, q0,
                      b);
        }
        for (int c = 0; c < Tiles::kVBoxes; ++c) {
          tma_load_4d(do_s(st) + c * kBox, &tdo, full(st), c * kBoxCols, h,
                      q0, b);
        }
        const long long row =
            (static_cast<long long>(b) * heads + h) * sq_pad + q0;
        bulk_load(stats_s(st), lse2 + row, 256, full(st));
        bulk_load(stats_s(st) + 256, delta + row, 256, full(st));
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");

  // Of the 64 x 64 fragments this thread owns rows (keys) kr and kr + 8
  // and, of every 8 columns, c0 and c0 + 1.
  const int lane = threadIdx.x % 32;
  const int c0 = 2 * (lane % 4);
  const int kr = 16 * (warp % 4) + lane / 4;

  if (warp < 4) {
    // The score warpgroup: per pair S^T = K Q^T and dP^T = V dO^T (m64n64,
    // shared operands), P^T = exp2(S^T scale log2(e) - lse log2(e)),
    // masked per score only on tiles that cross the diagonal, the window's
    // edge, Sq or Sk, and dS^T = P^T (dP^T - Delta), both stored in bf16.
#pragma unroll 1
    for (int t = 0; t < n_t; ++t) {
      const Keys ks = tile(t);
      const int n_pairs = group * ks.n_qt;
      mbar_wait(kv_full, t & 1);
#pragma unroll 1
      for (int i = 0; i < n_pairs; ++i) {
        const int g = ks.first + i;
        const int st = g % kMlaStages;
        const int hs = g % kMlaHand;
        const int q0 = (ks.qt_lo + i % ks.n_qt) * kTile;
        mbar_wait(full(st), (g / kMlaStages) & 1);
        const float* stats =
            reinterpret_cast<const float*>(smem_raw + (stats_s(st) - raw));
        float s[32], dp[32];
        wgmma_fence();
        product_abt<D>(s, k_s, q_s(st));
        wgmma_commit();
        product_abt<DV>(dp, v_s, do_s(st));
        wgmma_commit();
        wgmma_wait<0>();
        hold(s);
        hold(dp);
        // The tile's last products have read K and V: the next tile's may
        // load.
        if (t + 1 < n_t && i == n_pairs - 1) mbar_arrive(kv_empty);
        const bool masked =
            tile_masked<kTile, kTile>(q0, ks.k0, sq, sk, causal, window);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(stats + 8 * j + c0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = exp2_approx(
                fmaf(s[4 * j + e], sc.scale_log2, -(e % 2 ? l2.y : l2.x)));
            s[4 * j + e] = masked && !visible(q0 + 8 * j + c0 + e % 2,
                                              ks.k0 + kr + 8 * (e / 2), sq,
                                              sk, causal, window)
                               ? 0.f
                               : x;
          }
        }
        mbar_wait(taken(hs), ((g / kMlaHand) & 1) ^ 1);  // round 0 passes
        uint8_t* pt = smem_raw + (p_s(hs) - raw);
        store_swizzled(pt, s, kr, c0);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 dl =
              *reinterpret_cast<const float2*>(stats + 64 + 8 * j + c0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[4 * j + e] *= dp[4 * j + e] - (e % 2 ? dl.y : dl.x);
          }
        }
        store_swizzled(pt + kBox, s, kr, c0);
        fence_async_shared();  // the gradient warpgroup's wgmma reads them
        mbar_arrive(handed(hs));
        mbar_arrive(empty(st));
      }
      if (t + 1 < n_t && n_pairs == 0) mbar_arrive(kv_empty);
    }
    return;
  }

  // The gradient warpgroup: dV += P^T dO (n128), dK += dS^T Q (n128 over
  // columns 0-127, n64 over 128-191); A K-major and B MN-major, both in
  // shared memory. Each tile's sums are stored as they stand.
#pragma unroll 1
  for (int t = 0; t < n_t; ++t) {
    const Keys ks = tile(t);
    float dk_acc[kN / 2], dv_acc[kNV / 2];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) dk_acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kNV / 2; ++i) dv_acc[i] = 0.f;
    float(&dk_lo)[64] = *reinterpret_cast<float(*)[64]>(dk_acc);
    float(&dk_hi)[32] = *reinterpret_cast<float(*)[32]>(dk_acc + 64);
#pragma unroll 1
    for (int i = 0; i < group * ks.n_qt; ++i) {
      const int g = ks.first + i;
      const int st = g % kMlaStages;
      const int hs = g % kMlaHand;
      mbar_wait(full(st), (g / kMlaStages) & 1);
      mbar_wait(handed(hs), (g / kMlaHand) & 1);
      hold(dk_acc);
      hold(dv_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_m64n128k16_ss_mn(dv_acc, kmajor(p_s(hs), kk),
                               mnmajor(do_s(st), kk));
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t a = kmajor(p_s(hs) + kBox, kk);
        wgmma_m64n128k16_ss_mn(dk_lo, a, mnmajor(q_s(st), kk));
        wgmma_m64n64k16_ss_mn(dk_hi, a, mnmajor(q_s(st) + 2 * kBox, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      hold(dk_acc);
      hold(dv_acc);
      mbar_arrive(taken(hs));
      mbar_arrive(empty(st));
    }

    // Register pair p of dK is key kr + 8 (p % 2), columns 8 (p / 2) + c0
    // and + 1; dV's likewise. Every element has this one writer.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = ks.k0 + kr + 8 * r;
      if (key >= sk) continue;
      const long long at =
          (static_cast<long long>(b) * sk + key) * kv_heads + kh;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dk + at * D + 8 * j + c0) = pack_bf16(
            dk_acc[4 * j + 2 * r] * scale, dk_acc[4 * j + 2 * r + 1] * scale);
      }
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dv + at * DV + 8 * j + c0) =
            pack_bf16(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

// dQ of 128 query rows of one query head: two consumers of 64 rows each.
// With kDelta, the Delta pass: each row's sum_j P_ij dP_ij into `delta`
// (rows below Sq), and no dQ. The maps tq_t .. tdo_t as dkdv_tc_kernel's.
template <int D, int DV, bool kDelta>
__global__ void __launch_bounds__(kTcThreads, 1)
dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap tdo,
             const __grid_constant__ CUtensorMap tq_t,
             const __grid_constant__ CUtensorMap tk_t,
             const __grid_constant__ CUtensorMap tv_t,
             const __grid_constant__ CUtensorMap tdo_t,
             const float* __restrict__ lse2, float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dq, int sq, int sk, int sq_pad,
             int heads, int kv_heads, int causal, int window,
             Scaling sc, float scale) {
  using Tiles = BwdTiles<D, DV>;
  constexpr int kN = Tiles::kN;
  constexpr uint32_t kKV = Tiles::kQk + Tiles::kV;  // a K and a V tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kQStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const auto q_s = [&](int w) { return base + w * Tiles::kQk; };
  const auto do_s = [&](int w) {
    return base + 2 * Tiles::kQk + w * Tiles::kV;
  };
  const auto k_s = [&](int st) { return base + 2 * kKV + st * kKV; };
  const auto v_s = [&](int st) { return k_s(st) + Tiles::kQk; };
  const uint32_t bar0 = smem_u32(bars);
  const uint32_t q_full = bar0;
  const auto full = [&](int st) { return bar0 + 8 * (1 + st); };
  const auto empty = [&](int st) { return bar0 + 8 * (1 + kQStages + st); };

  // Grid (heads, batch, query tiles), or at MLA's (192, 128) with one
  // query head a KV head (query tiles, heads, batch): see launch_tc.
  const bool tiles_first = D > 128 && heads == kv_heads;
  const int h = tiles_first ? blockIdx.y : blockIdx.x;
  const int b = tiles_first ? blockIdx.z : blockIdx.y;
  const int q_tiles = tiles_first ? gridDim.x : gridDim.z;
  const int q0 =  // late (heavy) tiles first
      (q_tiles - 1 - (tiles_first ? blockIdx.x : blockIdx.z)) * kQRows;
  const int kh = h / (heads / kv_heads);
  // Keys any row of the block may see: [k_lo, k_hi), in tiles of 64 from
  // k_lo.
  const int q_last = min(q0 + kQRows, sq) - 1;
  const int k_hi = causal ? min(sk, q_last + 1) : sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int n_kt = k_hi > k_lo ? (k_hi - k_lo + kTile - 1) / kTile : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kQStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (threadIdx.x != 256) return;
    mbar_expect_tx(q_full, 2 * kKV);
    for (int w = 0; w < 2; ++w) {
      load_tile<D>(q_s(w), &tq, &tq_t, q_full, h, q0 + kTile * w, b);
      load_tile<DV>(do_s(w), &tdo, &tdo_t, q_full, h, q0 + kTile * w, b);
    }
    for (int j = 0; j < n_kt; ++j) {
      const int st = j % kQStages;
      const int k0 = k_lo + j * kTile;
      mbar_wait(empty(st), ((j / kQStages) & 1) ^ 1);  // round 0 passes
      mbar_expect_tx(full(st), kKV);
      load_tile<D>(k_s(st), &tk, &tk_t, full(st), kh, k0, b);
      load_tile<DV>(v_s(st), &tv, &tv_t, full(st), kh, k0, b);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");

  // Consumers: warpgroup wg owns rows r_lo .. r_lo + 63; this thread rows
  // r0 and r0 + 8 and, of every 8 key columns, c0 and c0 + 1.
  const int wg = warp / 4;
  const int lane = threadIdx.x % 32;
  const int c0 = 2 * (lane % 4);
  const int r_lo = q0 + kTile * wg;
  const int r0 = r_lo + 16 * (warp % 4) + lane / 4;
  float l2[2], dl[2], ps[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long at =
        (static_cast<long long>(b) * heads + h) * sq_pad + r0 + 8 * r;
    l2[r] = lse2[at];
    dl[r] = kDelta ? 0.f : delta[at];  // the pass sums P dP into dl
    ps[r] = 0.f;                       // and P into ps
  }
  float acc[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
  mbar_wait(q_full, 0);

#pragma unroll 1
  for (int j = 0; j < n_kt; ++j) {
    const int st = j % kQStages;
    const int k0 = k_lo + j * kTile;
    mbar_wait(full(st), (j / kQStages) & 1);
    if (tile_sees<kTile, kTile>(r_lo, k0, sq, sk, causal, window)) {
      float s[32], dp[32];
      wgmma_fence();
      product_abt<D>(s, q_s(wg), k_s(st));
      wgmma_commit();
      product_abt<DV>(dp, do_s(wg), v_s(st));
      wgmma_commit();
      wgmma_wait<0>();
      hold(s);
      hold(dp);
      // P = exp2(S scale log2(e) - lse log2(e)), 0 where masked (under the
      // cap, of the capped scores); then dS = P (dP - Delta) (under the
      // cap, times its derivative), or in the Delta pass Delta += P dP.
      const bool masked =
          tile_masked<kTile, kTile>(r_lo, k0, sq, sk, causal, window);
      scores_to_ds<kDelta>(s, dp, l2, dl, ps, sc, masked, r0, k0, c0, sq,
                           sk, causal, window);
      if constexpr (!kDelta) {
        // dS's bf16 part and the bf16 of its residual (see the header).
        uint32_t da[16], dr[16];
        to_a_operand(s, da);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          __nv_bfloat162 hi;
          *reinterpret_cast<uint32_t*>(&hi) = da[i];
          const float2 f = __bfloat1622float2(hi);
          dr[i] = pack_bf16(s[2 * i] - f.x, s[2 * i + 1] - f.y);
        }
        hold(acc);
        wgmma_fence();
        product_ab<kN>(acc, da, k_s(st));  // dQ += dS K
        product_ab<kN>(acc, dr, k_s(st));
        wgmma_commit();
        wgmma_wait<0>();
        hold(acc);
        hold(da);
        hold(dr);
      }
    }
    mbar_arrive(empty(st));
  }

  if constexpr (kDelta) {
    // A row's 64 columns a tile lie with the 4 lanes of a quad. Delta is
    // sum P dP over sum P (1 up to exp2's and lse's rounding), so that the
    // row's dS, from these same P, sums to 0 to fp32 rounding.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 1);
      dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 2);
      ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 1);
      ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 2);
      const int qi = r0 + 8 * r;
      if (qi < sq && lane % 4 == 0) {
        delta[(static_cast<long long>(b) * heads + h) * sq_pad + qi] =
            ps[r] > 0.f ? dl[r] / ps[r] : 0.f;
      }
    }
    return;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + 8 * r;
    if (qi >= sq) continue;
    __nv_bfloat16* row =
        dq + ((static_cast<long long>(b) * sq + qi) * heads + h) * D + c0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(row + 8 * j) = pack_bf16(
          acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 at (256, 256): gemma3-12b's heads on the tensor cores
// ---------------------------------------------------------------------------
//
// dK and dV of 64 keys are 64 x 256 fp32 each, 128 registers a thread of a
// warpgroup: one warpgroup cannot hold both, as dkdv_tc_kernel's consumers
// do, and the tiles of dq_tc_kernel's two consumers with its ring of two
// stages would take 256 KB. So at 256:
// * dkdv_256_kernel: one block per (64 keys, KV head, batch), heavy (early)
//   key tiles first; K and V loaded once, every (query head, query tile of
//   64) pair's Q, dO, lse and Delta through a ring of 2 stages (32 + 32 KB
//   and 512 bytes a stage). Both consumers take every pair: the value
//   warpgroup runs S^T = K Q^T, P^T = exp2(S^T scale log2(e) - lse
//   log2(e)) (masked per score only on tiles that cross the diagonal, the
//   window's edge, Sq or Sk), hands P^T in fp32 to the key warpgroup
//   through 16 KB of shared memory and runs dV += P^T dO (P^T as bf16
//   register A operands, dO MN-major, two n128 halves); the key warpgroup
//   runs dP^T = V dO^T, dS^T = P^T (dP^T - Delta) and dK += dS^T Q the same
//   way. Each holds its own sum of the whole key tile and stores it as it
//   stands: one writer an element, no reduction. 211 KB of shared memory.
// * dq_256_kernel: one block of 256 threads per (64 query rows, query
//   head, batch), heavy (late) tiles first: one consumer warpgroup, its Q
//   and dO resident, K and V tiles of 64 keys through a ring of 2 stages
//   (193 KB), dQ's 128 registers beside S, dP and dS's two bf16 parts in
//   the 255 a thread that a block of two warpgroups leaves; the products
//   and sums of dq_tc_kernel, the Delta pass its <true> instantiation.
// The descriptors of the 16 k16 steps over D are derived from opaque base
// descriptors (hopper.cuh), as in the forward at 256.
constexpr int k256Stages = 2;            // both kernels' ring depth
constexpr uint32_t k256Tile = 4 * kBox;  // a 64-row tile of 256 columns

struct Tiles256 {
  // dkdv: K, V, the ring (Q, dO, 64 lse * log2(e), 64 Delta a stage,
  // padded to keep the next stage 1,024-byte aligned), P^T in fp32, and
  // 1 KB of alignment slack.
  static constexpr uint32_t kStage = 2 * k256Tile + 1024;
  static constexpr uint32_t kPt = 64 * 64 * sizeof(float);
  static constexpr size_t kKvSmem =
      2 * static_cast<size_t>(k256Tile) + k256Stages * kStage + kPt + 1024;
  // dq: Q and dO of 64 rows, then the ring of K and V.
  static constexpr size_t kQSmem =
      (2 + 2 * k256Stages) * static_cast<size_t>(k256Tile) + 1024;
  static_assert(kKvSmem <= kSmemMax && kQSmem <= kSmemMax,
                "tiles exceed shared memory");
};

// d (64 x 64) = A B^T over 256 columns, A and B 64-row tiles at `a` and
// `b`, both K-major.
__device__ __forceinline__ void product_abt_256(float (&d)[32], uint32_t a,
                                                uint32_t b) {
  const uint64_t da = opaque(sw128_desc(a, 16, 1024));
  const uint64_t db = opaque(sw128_desc(b, 16, 1024));
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    const uint32_t off = ((kk / 4) * kBox + 32 * (kk % 4)) >> 4;
    if (kk == 0) {
      wgmma_m64n64k16_ss_first(d, da + off, db + off);
    } else {
      wgmma_m64n64k16_ss(d, da + off, db + off);
    }
  }
}

// acc (64 x 256) += A B: A (64 x 64) in bf16 registers, a[4 kk .. 4 kk + 3]
// its k16 step kk; B the 64-row tile at `b`, MN-major, as two n128 halves
// (boxes 0-1 and 2-3; element 64 + i of acc is element i of the second
// half's fragment).
__device__ __forceinline__ void product_ab_256(float (&acc)[128],
                                               const uint32_t (&a)[16],
                                               uint32_t b) {
  const uint64_t db = opaque(sw128_desc(b, kBox, 1024));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_m64n128k16_rs(*reinterpret_cast<float(*)[64]>(acc), a[4 * kk],
                        a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
                        db + ((2048 * kk) >> 4));
    wgmma_m64n128k16_rs(*reinterpret_cast<float(*)[64]>(acc + 64),
                        a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                        a[4 * kk + 3], db + ((2 * kBox + 2048 * kk) >> 4));
  }
}

// dK (key warpgroup) and dV (value warpgroup) of 64 keys of one KV head at
// (256, 256), summed over its query heads.
__global__ void __launch_bounds__(kTcThreads, 1)
dkdv_256_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ lse2,
                const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                int sq, int sk, int sq_pad, int heads, int kv_heads,
                int causal, int window, Scaling sc, float scale) {
  constexpr int D = 256;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[3 + 2 * k256Stages];
  // Swizzle atoms must be 1024-byte aligned: the launch adds 1 KB of slack.
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_s = base;
  const uint32_t v_s = base + k256Tile;
  const auto q_s = [&](int st) {
    return base + 2 * k256Tile + st * Tiles256::kStage;
  };
  const auto do_s = [&](int st) { return q_s(st) + k256Tile; };
  const auto stats_s = [&](int st) { return do_s(st) + k256Tile; };
  float* pt = reinterpret_cast<float*>(
      smem_raw + (q_s(k256Stages) - raw));  // P^T: element e of thread t
                                           // at e * 128 + t
  const uint32_t bar0 = smem_u32(bars);
  const uint32_t kv_full = bar0;
  const uint32_t p_full = bar0 + 8;
  const uint32_t p_empty = bar0 + 16;
  const auto full = [&](int st) { return bar0 + 8 * (3 + st); };
  const auto empty = [&](int st) {
    return bar0 + 8 * (3 + k256Stages + st);
  };

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kTile;  // early key tiles (causal: heavy) first
  const int group = heads / kv_heads;
  // Queries that may see keys [k0, k_last]: [q_lo, q_hi), in tiles of 64.
  const int k_last = min(k0 + kTile, sk) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(sq, k_last + window) : sq;
  const int qt_lo = q_lo / kTile;
  const int n_qt = q_hi > q_lo ? (q_hi + kTile - 1) / kTile - qt_lo : 0;
  const int n_pairs = group * n_qt;  // pair i: head i / n_qt, tile i % n_qt

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(p_full, 128);
    mbar_init(p_empty, 128);
    for (int st = 0; st < k256Stages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 256);  // both consumers read every stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp >= 8) {
    // Producer warpgroup: one thread issues every load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (threadIdx.x != 256) return;
    mbar_expect_tx(kv_full, 2 * k256Tile);
    for (int c = 0; c < 4; ++c) {
      tma_load_4d(k_s + c * kBox, &tk, kv_full, c * kBoxCols, kh, k0, b);
      tma_load_4d(v_s + c * kBox, &tv, kv_full, c * kBoxCols, kh, k0, b);
    }
    for (int i = 0; i < n_pairs; ++i) {
      const int st = i % k256Stages;
      const int h = kh * group + i / n_qt;
      const int q0 = (qt_lo + i % n_qt) * kTile;
      mbar_wait(empty(st), ((i / k256Stages) & 1) ^ 1);  // round 0 passes
      mbar_expect_tx(full(st), 2 * k256Tile + 512);
      for (int c = 0; c < 4; ++c) {
        tma_load_4d(q_s(st) + c * kBox, &tq, full(st), c * kBoxCols, h, q0,
                    b);
        tma_load_4d(do_s(st) + c * kBox, &tdo, full(st), c * kBoxCols, h,
                    q0, b);
      }
      const long long row =
          (static_cast<long long>(b) * heads + h) * sq_pad + q0;
      bulk_load(stats_s(st), lse2 + row, 256, full(st));
      bulk_load(stats_s(st) + 256, delta + row, 256, full(st));
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");

  // Consumers: warpgroup 0 the value one (dV), 1 the key one (dK). Of the
  // 64 x 64 fragments this thread owns rows (keys) kr and kr + 8 and, of
  // every 8 columns (queries), c0 and c0 + 1: element 4j + e is key
  // kr + 8 (e / 2), query 8j + c0 + e % 2.
  const int wg = warp / 4;
  const int t = threadIdx.x % 128;
  const int lane = threadIdx.x % 32;
  const int c0 = 2 * (lane % 4);
  const int kr = 16 * (warp % 4) + lane / 4;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  mbar_wait(kv_full, 0);

#pragma unroll 1
  for (int i = 0; i < n_pairs; ++i) {
    const int st = i % k256Stages;
    const int q0 = (qt_lo + i % n_qt) * kTile;
    mbar_wait(full(st), (i / k256Stages) & 1);
    const float* stats =
        reinterpret_cast<const float*>(smem_raw + (stats_s(st) - raw));
    float x[32];
    uint32_t xa[16];
    wgmma_fence();
    product_abt_256(x, wg == 0 ? k_s : v_s, wg == 0 ? q_s(st) : do_s(st));
    wgmma_commit();
    wgmma_wait<0>();  // S^T (value) or dP^T (key) is in
    hold(x);
    if (wg == 0 && sc.cap_log2 > 0.f) {
      // Under the cap: P^T of the capped scores for dV, and P^T times the
      // cap's derivative handed to the key warpgroup for dS^T.
      const bool masked =
        tile_masked<kTile, kTile>(q0, k0, sq, sk, causal, window);
      mbar_wait(p_empty, (i & 1) ^ 1);  // round 0 passes
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(stats + 8 * j + c0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float th;
          float p = exp2_approx(
              score_arg<true>(x[4 * j + e], e % 2 ? l2.y : l2.x, sc, th));
          if (masked && !visible(q0 + 8 * j + c0 + e % 2,
                                 k0 + kr + 8 * (e / 2), sq, sk, causal,
                                 window)) {
            p = 0.f;
          }
          x[4 * j + e] = p;
          pt[(4 * j + e) * 128 + t] = p * cap_grad(th);
        }
      }
      mbar_arrive(p_full);
    } else if (wg == 0) {
      // P^T = exp2(S^T scale log2(e) - lse log2(e)), 0 where masked.
      const bool masked =
        tile_masked<kTile, kTile>(q0, k0, sq, sk, causal, window);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(stats + 8 * j + c0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_approx(
              fmaf(x[4 * j + e], sc.scale_log2, -(e % 2 ? l2.y : l2.x)));
          x[4 * j + e] =
              masked && !visible(q0 + 8 * j + c0 + e % 2,
                                 k0 + kr + 8 * (e / 2), sq, sk, causal,
                                 window)
                  ? 0.f
                  : p;
        }
      }
      mbar_wait(p_empty, (i & 1) ^ 1);  // round 0 passes
#pragma unroll
      for (int e = 0; e < 32; ++e) pt[e * 128 + t] = x[e];
      mbar_arrive(p_full);
    } else {
      // dS^T = P^T (dP^T - Delta) (P^T times the cap's derivative under a
      // cap).
      mbar_wait(p_full, i & 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dl =
            *reinterpret_cast<const float2*>(stats + 64 + 8 * j + c0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[4 * j + e] = pt[(4 * j + e) * 128 + t] *
                         (x[4 * j + e] - (e % 2 ? dl.y : dl.x));
        }
      }
      mbar_arrive(p_empty);
    }
    to_a_operand(x, xa);
    hold(acc);
    wgmma_fence();
    product_ab_256(acc, xa, wg == 0 ? do_s(st) : q_s(st));  // dV or dK
    wgmma_commit();
    wgmma_wait<0>();
    hold(acc);
    hold(xa);
    mbar_arrive(empty(st));
  }

  // Register pair p of the sum is key kr + 8 (p % 2), columns 8 (p / 2) + c0
  // and + 1. Every element has this one writer.
  __nv_bfloat16* out = wg == 0 ? dv : dk;
  const float f = wg == 0 ? 1.f : scale;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + kr + 8 * r;
    if (key >= sk) continue;
    const long long at =
        (static_cast<long long>(b) * sk + key) * kv_heads + kh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(out + at * D + 8 * j + c0) = pack_bf16(
          acc[4 * j + 2 * r] * f, acc[4 * j + 2 * r + 1] * f);
    }
  }
}

// dQ of 64 query rows of one query head at (256, 256), by one consumer
// warpgroup. With kDelta, the Delta pass: each row's sum_j P_ij dP_ij /
// sum_j P_ij into `delta` (rows below Sq), and no dQ.
template <bool kDelta>
__global__ void __launch_bounds__(256, 1)
dq_256_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const __grid_constant__ CUtensorMap tdo,
              const float* __restrict__ lse2, float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dq, int sq, int sk, int sq_pad,
              int heads, int kv_heads, int causal, int window,
              Scaling sc, float scale) {
  constexpr int D = 256;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * k256Stages];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t do_s = base + k256Tile;
  const auto k_s = [&](int st) {
    return base + 2 * k256Tile + st * 2 * k256Tile;
  };
  const auto v_s = [&](int st) { return k_s(st) + k256Tile; };
  const uint32_t bar0 = smem_u32(bars);
  const uint32_t q_full = bar0;
  const auto full = [&](int st) { return bar0 + 8 * (1 + st); };
  const auto empty = [&](int st) {
    return bar0 + 8 * (1 + k256Stages + st);
  };

  // Grid (heads, batch, query tiles of 64): the query heads of one KV head
  // side by side, so that they find its K and V tiles in L2.
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTile;  // late (heavy) first
  const int kh = h / (heads / kv_heads);
  // Keys any row of the block may see: [k_lo, k_hi), in tiles of 64 from
  // k_lo.
  const int q_last = min(q0 + kTile, sq) - 1;
  const int k_hi = causal ? min(sk, q_last + 1) : sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int n_kt = k_hi > k_lo ? (k_hi - k_lo + kTile - 1) / kTile : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < k256Stages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp >= 4) {
    if (threadIdx.x != 128) return;
    mbar_expect_tx(q_full, 2 * k256Tile);
    for (int c = 0; c < 4; ++c) {
      tma_load_4d(q_s + c * kBox, &tq, q_full, c * kBoxCols, h, q0, b);
      tma_load_4d(do_s + c * kBox, &tdo, q_full, c * kBoxCols, h, q0, b);
    }
    for (int j = 0; j < n_kt; ++j) {
      const int st = j % k256Stages;
      const int k0 = k_lo + j * kTile;
      mbar_wait(empty(st), ((j / k256Stages) & 1) ^ 1);  // round 0 passes
      mbar_expect_tx(full(st), 2 * k256Tile);
      for (int c = 0; c < 4; ++c) {
        tma_load_4d(k_s(st) + c * kBox, &tk, full(st), c * kBoxCols, kh, k0,
                    b);
        tma_load_4d(v_s(st) + c * kBox, &tv, full(st), c * kBoxCols, kh, k0,
                    b);
      }
    }
    return;
  }

  // The consumer: rows q0 .. q0 + 63; this thread rows r0 and r0 + 8 and,
  // of every 8 key columns, c0 and c0 + 1.
  const int lane = threadIdx.x % 32;
  const int c0 = 2 * (lane % 4);
  const int r0 = q0 + 16 * warp + lane / 4;
  float l2[2], dl[2], ps[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long at =
        (static_cast<long long>(b) * heads + h) * sq_pad + r0 + 8 * r;
    l2[r] = lse2[at];
    dl[r] = kDelta ? 0.f : delta[at];  // the pass sums P dP into dl
    ps[r] = 0.f;                       // and P into ps
  }
  float acc[kDelta ? 1 : 128];
#pragma unroll
  for (int i = 0; i < (kDelta ? 1 : 128); ++i) acc[i] = 0.f;
  mbar_wait(q_full, 0);

#pragma unroll 1
  for (int j = 0; j < n_kt; ++j) {
    const int st = j % k256Stages;
    const int k0 = k_lo + j * kTile;
    mbar_wait(full(st), (j / k256Stages) & 1);
    if (tile_sees<kTile, kTile>(q0, k0, sq, sk, causal, window)) {
      float s[32], dp[32];
      wgmma_fence();
      product_abt_256(s, q_s, k_s(st));
      wgmma_commit();
      product_abt_256(dp, do_s, v_s(st));
      wgmma_commit();
      wgmma_wait<0>();
      hold(s);
      hold(dp);
      // As in dq_tc_kernel.
      const bool masked =
        tile_masked<kTile, kTile>(q0, k0, sq, sk, causal, window);
      scores_to_ds<kDelta>(s, dp, l2, dl, ps, sc, masked, r0, k0, c0, sq,
                           sk, causal, window);
      if constexpr (!kDelta) {
        // dS's bf16 part and the bf16 of its residual, as in dq_tc_kernel.
        uint32_t da[16], dr[16];
        to_a_operand(s, da);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          __nv_bfloat162 hi;
          *reinterpret_cast<uint32_t*>(&hi) = da[i];
          const float2 f = __bfloat1622float2(hi);
          dr[i] = pack_bf16(s[2 * i] - f.x, s[2 * i + 1] - f.y);
        }
        hold(acc);
        wgmma_fence();
        product_ab_256(acc, da, k_s(st));  // dQ += dS K
        product_ab_256(acc, dr, k_s(st));
        wgmma_commit();
        wgmma_wait<0>();
        hold(acc);
        hold(da);
        hold(dr);
      }
    }
    mbar_arrive(empty(st));
  }

  if constexpr (kDelta) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 1);
      dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 2);
      ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 1);
      ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 2);
      const int qi = r0 + 8 * r;
      if (qi < sq && lane % 4 == 0) {
        delta[(static_cast<long long>(b) * heads + h) * sq_pad + qi] =
            ps[r] > 0.f ? dl[r] / ps[r] : 0.f;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = r0 + 8 * r;
      if (qi >= sq) continue;
      __nv_bfloat16* row =
          dq + ((static_cast<long long>(b) * sq + qi) * heads + h) * D + c0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(row + 8 * j) = pack_bf16(
            acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 at the narrow pairs: the reduced configs' (16, 16), (24, 24),
// (24, 16) and (32, 32)
// ---------------------------------------------------------------------------
//
// At a head of 16 to 32 a 64 x 64 pair of dkdv_tc_kernel does a quarter of
// D 64's tensor work yet pays what any pair pays, and each of the three
// sweeps (Delta, dK/dV, dQ) takes an exp2 a score. The narrow pairs have
// kernels of their own, with operands as wide as the head, tiles longer
// along the sequence, and the mask tested only where it cuts:
// * Boxes of 16 columns (32-byte rows, 32-byte swizzle) at a head of 16, of
//   32 columns (64-byte swizzle) at 24 and 32 (zero-filled past 24 by the
//   TMA unit), 64 rows each (a tile of 128 rows is two, one after the
//   other). The products whose N is a head dim run at the box's width
//   (n16 or n32), those whose depth is one take ceil(D / 16) k16 steps, and
//   dK's and dV's accumulators are 8 or 16 registers a thread.
// * Each tile branches once on whether it crosses Sq, Sk, the diagonal or
//   the window's edge (and once on the cap), so that a tile inside the
//   visible region tests no score: a runtime test a score cost more than
//   the products (PERF.md, row 7i).
// * dkdv_narrow_kernel: one block of 384 threads per (128 keys, KV head,
//   batch), early (causal: heavy) key tiles first. Its producer loads K
//   and V once and streams every (query head, query tile of 128) pair's Q,
//   dO, 128 lse and 128 Delta through a ring of 4 stages; both consumer
//   warpgroups read every stage, each for its own 64 keys, so each holds
//   the whole dK and dV of its keys and stores them as they stand: no
//   partial sums to add, no cluster. Per pair: S^T and dP^T on m64n128,
//   P^T, dV += P^T dO (n16/n32) issued while dS^T is computed from dP^T,
//   then dK += dS^T Q.
// * dq_narrow_kernel: one block per (128 query rows, query head, batch),
//   late (heavy) query tiles first, K and V through a ring of 4 stages.
//   Its <true> instantiation is the Delta pass (stages of 128 keys, S and
//   dP on m64n128), which also writes lse * log2(e) into the scratch rows
//   (lse_kernel's work at the other pairs: one launch fewer). The dQ
//   kernel (stages of 64 keys, S and dP on m64n64) issues a stage's dQ +=
//   dS K (its bf16 part and its residual's, n16/n32) and goes on to the
//   next stage's S and dP while it runs.
// The numerics are those of the other pairs: the same P, Delta =
// rowsum(P dP) / rowsum(P), dS's split for dQ, the cap read back from P^T
// in the dK/dV kernel, and no atomics.
constexpr int kNarrowRows = 128;    // keys a dK/dV block and queries a pair;
                                    // query rows a dQ block, keys a stage
constexpr int kNarrowKvStages = 4;  // dkdv_narrow_kernel's (Q, dO) ring
constexpr int kNarrowQStages = 4;   // dq_narrow_kernel's (K, V) ring
constexpr int kNarrowDqKeys = 64;   // keys a stage of the dQ kernel
constexpr int kNarrowBox = 64;      // rows of a TMA box

template <int D, int DV>
struct NarrowTiles {
  static constexpr int kN = box_cols(D);    // dK's and dQ's n
  static constexpr int kNV = box_cols(DV);  // dV's n
  static constexpr uint32_t kRow = 2 * kN;     // bytes of a Q or K row
  static constexpr uint32_t kVRow = 2 * kNV;   // of a V or dO row
  static constexpr uint32_t kQk = kNarrowRows * kRow;  // 128 rows of Q or K
  static constexpr uint32_t kV = kNarrowRows * kVRow;  // of V or dO
  // dkdv: K and V, then the ring; a stage is Q, dO, 128 lse * log2(e) and
  // 128 Delta.
  static constexpr uint32_t kStage = kQk + kV + 1024;
  static constexpr size_t kKvSmem =
      kQk + kV + kNarrowKvStages * static_cast<size_t>(kStage) + 1024;
  // dq: the block's Q and dO, then the ring of K and V in stages of kKeys
  // keys.
  template <int kKeys>
  static constexpr size_t q_smem() {
    return kQk + kV +
           kNarrowQStages * static_cast<size_t>(kKeys) * (kRow + kVRow) +
           1024;
  }
  static_assert(kKvSmem <= kSmemMax, "tiles exceed shared memory");
};

// d (64 x kM) = A B^T over K columns, A a 64-row and B a kM-row tile (kM
// 128 or 64) of a narrow head's box (rows of 2 box_cols(K) bytes), both
// K-major: ceil(K / 16) k16 steps, the zeros past K adding nothing.
template <int K, int kM = 128>
__device__ __forceinline__ void narrow_abt(float (&d)[kM / 2], uint32_t a,
                                           uint32_t b) {
  constexpr int kRow = 2 * box_cols(K);
#pragma unroll
  for (int kk = 0; kk < (K + 15) / 16; ++kk) {
    const uint64_t da = narrow_kmajor<kRow>(a, kk);
    const uint64_t db = narrow_kmajor<kRow>(b, kk);
    if constexpr (kM == 128) {
      if (kk == 0) {
        wgmma_m64n128k16_ss_first(d, da, db);
      } else {
        wgmma_m64n128k16_ss(d, da, db);
      }
    } else {
      if (kk == 0) {
        wgmma_m64n64k16_ss_first(d, da, db);
      } else {
        wgmma_m64n64k16_ss(d, da, db);
      }
    }
  }
}

// acc (64 x N) += A B: A (64 x kK) in bf16 registers, a[4 kk .. 4 kk + 3]
// its k16 step kk; B the kK-row tile at `b` (N columns, 2 N bytes a row),
// MN-major (dV += P^T dO, dK += dS^T Q, dQ += dS K).
template <int N, int kK = 128>
__device__ __forceinline__ void narrow_ab(float (&acc)[N / 2],
                                          const uint32_t (&a)[kK / 4],
                                          uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kK / 16; ++kk) {
    wgmma_rs<N>(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
                narrow_mnmajor<2 * N>(b, kk));
  }
}

// dK and dV of 128 keys of one KV head at a narrow pair, summed over its
// query heads: consumer wg holds keys k0 + 64 wg .. + 63.
template <int D, int DV>
__global__ void __launch_bounds__(kTcThreads, 1)
dkdv_narrow_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse2,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int sq, int sk,
                   int sq_pad, int heads, int kv_heads, int causal,
                   int window, Scaling sc, float scale) {
  using Tiles = NarrowTiles<D, DV>;
  constexpr int kN = Tiles::kN;
  constexpr int kNV = Tiles::kNV;
  constexpr int kRows = kNarrowRows;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kNarrowKvStages];
  // Swizzle atoms must be aligned: the launch adds 1 KB of slack.
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_s = base;
  const uint32_t v_s = base + Tiles::kQk;
  const auto q_s = [&](int st) {
    return base + Tiles::kQk + Tiles::kV + st * Tiles::kStage;
  };
  const auto do_s = [&](int st) { return q_s(st) + Tiles::kQk; };
  const auto stats_s = [&](int st) { return do_s(st) + Tiles::kV; };
  const uint32_t bar0 = smem_u32(bars);
  const uint32_t kv_full = bar0;
  const auto full = [&](int st) { return bar0 + 8 * (1 + st); };
  const auto empty = [&](int st) {
    return bar0 + 8 * (1 + kNarrowKvStages + st);
  };

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kRows;  // early key tiles (causal: heavy) first
  const int group = heads / kv_heads;
  // Queries that may see keys [k0, k_last]: [q_lo, q_hi), in tiles of 128.
  const int k_last = min(k0 + kRows, sk) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(sq, k_last + window) : sq;
  const int qt_lo = q_lo / kRows;
  const int n_qt = q_hi > q_lo ? (q_hi + kRows - 1) / kRows - qt_lo : 0;
  const int n_pairs = group * n_qt;  // pair i: head i / n_qt, tile i % n_qt

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kNarrowKvStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 256);  // both consumers read every stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp >= 8) {
    // Producer warpgroup: one thread issues every load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (threadIdx.x != 256) return;
    // 128 rows are two boxes of 64, one after the other: the same bytes as
    // one box of 128 rows.
    mbar_expect_tx(kv_full, Tiles::kQk + Tiles::kV);
    for (int c = 0; c < kRows / kNarrowBox; ++c) {
      tma_load_4d(k_s + c * kNarrowBox * Tiles::kRow, &tk, kv_full, 0, kh,
                  k0 + c * kNarrowBox, b);
      tma_load_4d(v_s + c * kNarrowBox * Tiles::kVRow, &tv, kv_full, 0, kh,
                  k0 + c * kNarrowBox, b);
    }
    for (int i = 0; i < n_pairs; ++i) {
      const int st = i % kNarrowKvStages;
      const int h = kh * group + i / n_qt;
      const int q0 = (qt_lo + i % n_qt) * kRows;
      mbar_wait(empty(st), ((i / kNarrowKvStages) & 1) ^ 1);  // round 0
      mbar_expect_tx(full(st), Tiles::kQk + Tiles::kV + 1024);
      for (int c = 0; c < kRows / kNarrowBox; ++c) {
        tma_load_4d(q_s(st) + c * kNarrowBox * Tiles::kRow, &tq, full(st), 0,
                    h, q0 + c * kNarrowBox, b);
        tma_load_4d(do_s(st) + c * kNarrowBox * Tiles::kVRow, &tdo, full(st),
                    0, h, q0 + c * kNarrowBox, b);
      }
      const long long row =
          (static_cast<long long>(b) * heads + h) * sq_pad + q0;
      bulk_load(stats_s(st), lse2 + row, 512, full(st));
      bulk_load(stats_s(st) + 512, delta + row, 512, full(st));
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");

  // Consumers: warpgroup wg owns keys kw .. kw + 63; of the 64 x 128
  // fragments this thread owns rows (keys) kr and kr + 8 and, of every 8
  // columns (queries), c0 and c0 + 1: element 4j + e is key kr + 8 (e / 2),
  // query 8j + c0 + e % 2.
  const int wg = warp / 4;
  const int lane = threadIdx.x % 32;
  const int c0 = 2 * (lane % 4);
  const int kr = 16 * (warp % 4) + lane / 4;
  const int kw = k0 + 64 * wg;
  const uint32_t k_wg = k_s + 64 * wg * Tiles::kRow;
  const uint32_t v_wg = v_s + 64 * wg * Tiles::kVRow;
  float dk_acc[kN / 2], dv_acc[kNV / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) dk_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kNV / 2; ++i) dv_acc[i] = 0.f;
  mbar_wait(kv_full, 0);

#pragma unroll 1
  for (int i = 0; i < n_pairs; ++i) {
    const int st = i % kNarrowKvStages;
    const int q0 = (qt_lo + i % n_qt) * kRows;
    mbar_wait(full(st), (i / kNarrowKvStages) & 1);
    if (tile_sees<kRows, 64>(q0, kw, sq, sk, causal, window)) {
      const float* stats =
          reinterpret_cast<const float*>(smem_raw + (stats_s(st) - raw));
      float s[64], dp[64];
      wgmma_fence();
      narrow_abt<D>(s, k_wg, q_s(st));  // S^T = K Q^T
      wgmma_commit();
      narrow_abt<DV>(dp, v_wg, do_s(st));  // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait<1>();  // S^T is in
      hold(s);

      // P^T = exp2(S^T scale log2(e) - lse log2(e)), 0 where masked (under
      // the cap, of the capped scores). The cap and the mask are uniform
      // branches a pair: a pair inside the visible region tests no score.
      const auto probs = [&](auto cap, auto mask) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(stats + 8 * j + c0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float t;
            const float x = exp2_approx(score_arg<decltype(cap)::value>(
                s[4 * j + e], e % 2 ? l2.y : l2.x, sc, t));
            s[4 * j + e] = decltype(mask)::value &&
                                   !visible(q0 + 8 * j + c0 + e % 2,
                                            kw + kr + 8 * (e / 2), sq, sk,
                                            causal, window)
                               ? 0.f
                               : x;
          }
        }
      };
      const bool capped = sc.cap_log2 > 0.f;
      const bool masked =
          tile_masked<kRows, 64>(q0, kw, sq, sk, causal, window);
      if (capped && masked) {
        probs(Flag<true>{}, Flag<true>{});
      } else if (capped) {
        probs(Flag<true>{}, Flag<false>{});
      } else if (masked) {
        probs(Flag<false>{}, Flag<true>{});
      } else {
        probs(Flag<false>{}, Flag<false>{});
      }
      uint32_t pa[32];
      to_a_operand(s, pa);
      hold(dv_acc);
      wgmma_fence();
      narrow_ab<kNV>(dv_acc, pa, do_s(st));  // dV += P^T dO
      wgmma_commit();
      wgmma_wait<1>();  // dP^T is in; dV runs on beside dS^T
      hold(dp);

      // dS^T = P^T (dP^T - Delta); under the cap also times its derivative
      // 1 - t^2, t read back from P^T as dkdv_tc_kernel does.
      if (capped) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 dl =
              *reinterpret_cast<const float2*>(stats + 128 + 8 * j + c0);
          const float2 l2 =
              *reinterpret_cast<const float2*>(stats + 8 * j + c0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = s[4 * j + e];
            const float t =
                p > 0.f ? (log2f(p) + (e % 2 ? l2.y : l2.x)) / sc.cap_log2
                        : 0.f;
            s[4 * j + e] =
                p * (dp[4 * j + e] - (e % 2 ? dl.y : dl.x)) * cap_grad(t);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 dl =
              *reinterpret_cast<const float2*>(stats + 128 + 8 * j + c0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[4 * j + e] *= dp[4 * j + e] - (e % 2 ? dl.y : dl.x);
          }
        }
      }
      uint32_t da[32];
      to_a_operand(s, da);
      hold(dk_acc);
      wgmma_fence();
      narrow_ab<kN>(dk_acc, da, q_s(st));  // dK += dS^T Q
      wgmma_commit();
      wgmma_wait<0>();
      hold(dk_acc);
      hold(dv_acc);
      hold(pa);
      hold(da);
    }
    mbar_arrive(empty(st));
  }

  // Register pair p of dK is key kr + 8 (p % 2), columns 8 (p / 2) + c0
  // and + 1; dV's likewise. Every element has this one writer.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw + kr + 8 * r;
    if (key >= sk) continue;
    const long long at =
        (static_cast<long long>(b) * sk + key) * kv_heads + kh;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      if (8 * j + c0 >= D) continue;  // the box's zeros past D
      *reinterpret_cast<uint32_t*>(dk + at * D + 8 * j + c0) = pack_bf16(
          dk_acc[4 * j + 2 * r] * scale, dk_acc[4 * j + 2 * r + 1] * scale);
    }
#pragma unroll
    for (int j = 0; j < kNV / 8; ++j) {
      if (8 * j + c0 >= DV) continue;
      *reinterpret_cast<uint32_t*>(dv + at * DV + 8 * j + c0) =
          pack_bf16(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
    }
  }
}

// dQ of 128 query rows of one query head at a narrow pair: two consumers of
// 64 rows each, K and V through a ring of stages of keys. With
// kDelta, the Delta pass (stages of 128 keys): each row's sum_j P_ij dP_ij /
// sum_j P_ij into `delta` and its lse * log2(e) into `lse2` (zeros past
// Sq), and no dQ. The dQ kernel (stages of kNarrowDqKeys) issues a stage's
// dQ products and goes on to the next stage's S and dP while they run: one
// wait covers both, and the stage is released once its products are in.
template <int D, int DV, bool kDelta>
__global__ void __launch_bounds__(kTcThreads, 1)
dq_narrow_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse, float* __restrict__ lse2,
                 float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, int sq, int sk, int sq_pad,
                 int heads, int kv_heads, int causal, int window,
                 Scaling sc, float scale) {
  using Tiles = NarrowTiles<D, DV>;
  constexpr int kN = Tiles::kN;
  constexpr int kRows = kNarrowRows;
  // Keys a stage: 128 in the Delta pass, kNarrowDqKeys in the dQ kernel,
  // whose in-flight products' operands must fit beside the next S and dP.
  constexpr int kKeys = kDelta ? kNarrowRows : kNarrowDqKeys;
  constexpr uint32_t kKt = kKeys * Tiles::kRow;   // a stage's K
  constexpr uint32_t kVt = kKeys * Tiles::kVRow;  // and V
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kNarrowQStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t do_s = base + Tiles::kQk;
  const auto k_s = [&](int st) {
    return base + Tiles::kQk + Tiles::kV + st * (kKt + kVt);
  };
  const auto v_s = [&](int st) { return k_s(st) + kKt; };
  const uint32_t bar0 = smem_u32(bars);
  const uint32_t q_full = bar0;
  const auto full = [&](int st) { return bar0 + 8 * (1 + st); };
  const auto empty = [&](int st) {
    return bar0 + 8 * (1 + kNarrowQStages + st);
  };

  // Grid (heads, batch, query tiles): the query heads of one KV head side
  // by side, so that they find its K and V tiles in L2.
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;  // late (heavy) first
  const int kh = h / (heads / kv_heads);
  // Keys any row of the block may see: [k_lo, k_hi), in stages of kKeys
  // from k_lo.
  const int q_last = min(q0 + kRows, sq) - 1;
  const int k_hi = causal ? min(sk, q_last + 1) : sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int n_kt = k_hi > k_lo ? (k_hi - k_lo + kKeys - 1) / kKeys : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kNarrowQStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (threadIdx.x != 256) return;
    mbar_expect_tx(q_full, Tiles::kQk + Tiles::kV);
    for (int c = 0; c < kRows / kNarrowBox; ++c) {
      tma_load_4d(q_s + c * kNarrowBox * Tiles::kRow, &tq, q_full, 0, h,
                  q0 + c * kNarrowBox, b);
      tma_load_4d(do_s + c * kNarrowBox * Tiles::kVRow, &tdo, q_full, 0, h,
                  q0 + c * kNarrowBox, b);
    }
    for (int j = 0; j < n_kt; ++j) {
      const int st = j % kNarrowQStages;
      const int k0 = k_lo + j * kKeys;
      mbar_wait(empty(st), ((j / kNarrowQStages) & 1) ^ 1);  // round 0
      mbar_expect_tx(full(st), kKt + kVt);
      for (int c = 0; c < kKeys / kNarrowBox; ++c) {
        tma_load_4d(k_s(st) + c * kNarrowBox * Tiles::kRow, &tk, full(st), 0,
                    kh, k0 + c * kNarrowBox, b);
        tma_load_4d(v_s(st) + c * kNarrowBox * Tiles::kVRow, &tv, full(st),
                    0, kh, k0 + c * kNarrowBox, b);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");

  // Consumers: warpgroup wg owns rows r_lo .. r_lo + 63; this thread rows
  // r0 and r0 + 8 and, of every 8 key columns, c0 and c0 + 1.
  const int wg = warp / 4;
  const int lane = threadIdx.x % 32;
  const int c0 = 2 * (lane % 4);
  const int r_lo = q0 + 64 * wg;
  const int r0 = r_lo + 16 * (warp % 4) + lane / 4;
  const uint32_t q_wg = q_s + 64 * wg * Tiles::kRow;
  const uint32_t do_wg = do_s + 64 * wg * Tiles::kVRow;
  // The Delta pass reads lse and scales it by log2(e) itself (it writes the
  // scratch rows the other two kernels read, as lse_kernel does at the
  // other pairs: one launch fewer); the dQ kernel reads those rows.
  float l2[2], dl[2], ps[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + 8 * r;
    const long long bh = static_cast<long long>(b) * heads + h;
    if constexpr (kDelta) {
      l2[r] = qi < sq ? lse[bh * sq + qi] * 1.4426950408889634f : 0.f;
    } else {
      l2[r] = lse2[bh * sq_pad + qi];
    }
    dl[r] = kDelta ? 0.f : delta[bh * sq_pad + qi];  // the pass sums P dP
    ps[r] = 0.f;                                     // and P
  }
  float acc[kDelta ? 1 : kN / 2];
#pragma unroll
  for (int i = 0; i < (kDelta ? 1 : kN / 2); ++i) acc[i] = 0.f;
  // dS's bf16 part and the bf16 of its residual: the A operands of the
  // stage whose dQ products are in flight (`pending`, -1 for none).
  uint32_t da[kDelta ? 1 : kKeys / 4], dr[kDelta ? 1 : kKeys / 4];
  int pending = -1;
  mbar_wait(q_full, 0);

#pragma unroll 1
  for (int j = 0; j < n_kt; ++j) {
    const int st = j % kNarrowQStages;
    const int k0 = k_lo + j * kKeys;
    mbar_wait(full(st), (j / kNarrowQStages) & 1);
    const bool sees = tile_sees<64, kKeys>(r_lo, k0, sq, sk, causal, window);
    float s[kKeys / 2], dp[kKeys / 2];
    if (sees) {
      wgmma_fence();
      narrow_abt<D, kKeys>(s, q_wg, k_s(st));  // S = Q K^T
      wgmma_commit();
      narrow_abt<DV, kKeys>(dp, do_wg, v_s(st));  // dP = dO V^T
      wgmma_commit();
    }
    wgmma_wait<0>();  // S, dP and the previous stage's dQ products are in
    if constexpr (!kDelta) {
      hold(acc);
      hold(da);
      hold(dr);
      if (pending >= 0) mbar_arrive(empty(pending));
      pending = -1;
    }
    if (sees) {
      hold(s);
      hold(dp);
      // As in dq_tc_kernel; only a tile that crosses Sq, Sk, the diagonal
      // or the window's edge tests each score.
      if (tile_masked<64, kKeys>(r_lo, k0, sq, sk, causal, window)) {
        scores_to_ds<kDelta, kKeys, 1>(s, dp, l2, dl, ps, sc, true, r0, k0,
                                       c0, sq, sk, causal, window);
      } else {
        scores_to_ds<kDelta, kKeys, 0>(s, dp, l2, dl, ps, sc, false, r0, k0,
                                       c0, sq, sk, causal, window);
      }
      if constexpr (!kDelta) {
        // dS's bf16 part and the bf16 of its residual (see the header).
        to_a_operand(s, da);
#pragma unroll
        for (int i = 0; i < kKeys / 4; ++i) {
          __nv_bfloat162 hi;
          *reinterpret_cast<uint32_t*>(&hi) = da[i];
          const float2 f = __bfloat1622float2(hi);
          dr[i] = pack_bf16(s[2 * i] - f.x, s[2 * i + 1] - f.y);
        }
        wgmma_fence();
        narrow_ab<kN, kKeys>(acc, da, k_s(st));  // dQ += dS K
        narrow_ab<kN, kKeys>(acc, dr, k_s(st));
        wgmma_commit();
        pending = st;
      }
    }
    if (kDelta || pending != st) mbar_arrive(empty(st));
  }

  if constexpr (kDelta) {
    // A row's columns of a stage lie with the 4 lanes of a quad. Every
    // scratch row of the block is written: zeros past Sq.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 1);
      dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 2);
      ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 1);
      ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 2);
      const int qi = r0 + 8 * r;
      if (lane % 4 == 0) {
        const long long at =
            (static_cast<long long>(b) * heads + h) * sq_pad + qi;
        lse2[at] = l2[r];
        delta[at] = qi < sq && ps[r] > 0.f ? dl[r] / ps[r] : 0.f;
      }
    }
    return;
  }

  wgmma_wait<0>();  // the last stage's dQ products
  hold(acc);
  hold(da);
  hold(dr);
  if (pending >= 0) mbar_arrive(empty(pending));
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + 8 * r;
    if (qi >= sq) continue;
    __nv_bfloat16* row =
        dq + ((static_cast<long long>(b) * sq + qi) * heads + h) * D + c0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(row + 8 * j) = pack_bf16(
          acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

// A second stream of the current device, created at first use, and two
// events for forking work onto it from the caller's stream and joining it
// back.
struct SideStream {
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr;
  cudaEvent_t join = nullptr;
};

cudaError_t side_stream(SideStream** out) {
  constexpr int kMaxDevices = 64;
  static SideStream sides[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidValue;
  SideStream& side = sides[dev];
  if (side.stream == nullptr) {
    err = cudaStreamCreateWithFlags(&side.stream, cudaStreamNonBlocking);
    if (err == cudaSuccess) {
      err = cudaEventCreateWithFlags(&side.fork, cudaEventDisableTiming);
    }
    if (err == cudaSuccess) {
      err = cudaEventCreateWithFlags(&side.join, cudaEventDisableTiming);
    }
    if (err != cudaSuccess) return err;
  }
  *out = &side;
  return cudaSuccess;
}

// Makes the side stream wait for `stream`'s work so far (`side` receives
// it), and later `stream` for the side stream's: a kernel put between the
// two on the side stream runs beside `stream`'s.
cudaError_t fork_side(cudaStream_t stream, SideStream** side) {
  cudaError_t err = side_stream(side);
  if (err == cudaSuccess) err = cudaEventRecord((*side)->fork, stream);
  if (err == cudaSuccess) {
    err = cudaStreamWaitEvent((*side)->stream, (*side)->fork, 0);
  }
  return err;
}

cudaError_t join_side(cudaStream_t stream, SideStream* side) {
  cudaError_t err = cudaEventRecord(side->join, side->stream);
  if (err == cudaSuccess) err = cudaStreamWaitEvent(stream, side->join, 0);
  return err;
}

// The dK/dV kernel on `stream`: dkdv_mla_kernel at MLA's (192, 128), one
// block a key tile; else dkdv_tc_kernel in clusters of 2 blocks a key tile
// where one would give fewer than two blocks an SM (at D 96 one block two
// key tiles, no cluster). `t` holds the tail maps
// of q, k, v and dO (read at D 96).
template <int D, int DV>
cudaError_t launch_dkdv(const CUtensorMap& tq, const CUtensorMap& tk,
                        const CUtensorMap& tv, const CUtensorMap& tdo,
                        const CUtensorMap (&t)[4], const float* lse2,
                        const float* delta, void* dk, void* dv, int batch,
                        int sq, int sk, int sq_pad, int heads,
                        int kv_heads, int causal, int window, Scaling sc,
                        float scale, cudaStream_t stream) {
  const int k_tiles = (sk + kTile - 1) / kTile;
  __nv_bfloat16* dk_ = static_cast<__nv_bfloat16*>(dk);
  __nv_bfloat16* dv_ = static_cast<__nv_bfloat16*>(dv);
  if constexpr (D > 128) {
    constexpr size_t smem = MlaTiles<D, DV>::kSmem;
    const cudaError_t err =
        smem_limit(reinterpret_cast<const void*>(dkdv_mla_kernel<D, DV>), smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(static_cast<unsigned>((k_tiles + 1) / 2),
                    static_cast<unsigned>(kv_heads),
                    static_cast<unsigned>(batch));
    dkdv_mla_kernel<D, DV><<<grid, kTcThreads, smem, stream>>>(
        tq, tk, tv, tdo, lse2, delta, dk_, dv_, sq, sk, sq_pad, heads,
        kv_heads, causal, window, sc, scale);
    return cudaGetLastError();
  } else {
    using Tiles = BwdTiles<D, DV>;
    cudaError_t err = smem_limit(
        reinterpret_cast<const void*>(dkdv_tc_kernel<D, DV>), Tiles::kKvSmem);
    if (err != cudaSuccess) return err;
    static int sms = 0;
    if (sms == 0) {
      int dev = 0;
      err = cudaGetDevice(&dev);
      if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
      }
      if (err != cudaSuccess) return err;
    }
    const long long kv_blocks =
        static_cast<long long>(kv_heads) * batch * k_tiles;
    int ranks = 1;
    while (!Tiles::kSplitKeys && ranks < kMaxCluster &&
           kv_blocks * ranks < 2LL * sms) {
      ranks *= 2;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(kv_heads * ranks),
                       static_cast<unsigned>(batch),
                       static_cast<unsigned>(Tiles::kSplitKeys
                                                 ? (k_tiles + 1) / 2
                                                 : k_tiles));
    cfg.blockDim = dim3(kTcThreads);
    cfg.dynamicSmemBytes = Tiles::kKvSmem;
    cfg.stream = stream;
    cudaLaunchAttribute cluster;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = ranks;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    cfg.attrs = &cluster;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, dkdv_tc_kernel<D, DV>, tq, tk, tv, tdo,
                             t[0], t[1], t[2], t[3], lse2, delta, dk_, dv_,
                             sq, sk, sq_pad, heads, kv_heads, causal, window,
                             sc, scale);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
}

template <int D, int DV>
int launch_tc(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, float* scratch, void* dq, void* dk, void* dv,
              int batch, int sq, int sk, int heads, int kv_heads, int causal,
              int window, float softcap, cudaStream_t stream) {
  using Tiles = BwdTiles<D, DV>;
  const int sq_pad = (sq + kQRows - 1) / kQRows * kQRows;
  const long long rows = static_cast<long long>(batch) * heads * sq_pad;
  float* lse2 = scratch;
  float* delta = scratch + rows;
  const long long delta_blocks = (rows + kThreads - 1) / kThreads;
  const int q_tiles = sq_pad / kQRows;
  const int k_tiles = (sk + kTile - 1) / kTile;
  if (delta_blocks > 0x7fffffffLL || q_tiles > 65535 || k_tiles > 65535 ||
      kv_heads > 65535 / kMaxCluster) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Contiguous tensors: strides of D (or DV) a head, then a row, a batch;
  // boxes of 64 rows by 64 columns (128-byte swizzle), and at D 96 the tail
  // maps' boxes of the last 32 (64-byte swizzle).
  const auto map = [&](CUtensorMap* m, const void* p, int seq, int nh,
                       int d, int cols) {
    return encode_4d(m, p, batch, seq, nh, d, d,
                     static_cast<long long>(d) * nh,
                     static_cast<long long>(d) * nh * seq, kTile, cols,
                     swizzle_of(cols));
  };
  CUtensorMap tq, tk, tv, tdo, t[4];
  if (!map(&tq, q, sq, heads, D, kBoxCols) ||
      !map(&tk, k, sk, kv_heads, D, kBoxCols) ||
      !map(&tv, v, sk, kv_heads, DV, kBoxCols) ||
      !map(&tdo, dout, sq, heads, DV, kBoxCols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if constexpr (Tiles::kTail > 0) {
    if (!map(&t[0], q, sq, heads, D, Tiles::kTail) ||
        !map(&t[1], k, sk, kv_heads, D, Tiles::kTail) ||
        !map(&t[2], v, sk, kv_heads, DV, Tiles::kVTail) ||
        !map(&t[3], dout, sq, heads, DV, Tiles::kVTail)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    t[0] = tq;
    t[1] = tk;
    t[2] = tv;
    t[3] = tdo;
  }
  lse_kernel<<<static_cast<unsigned>(delta_blocks), kThreads, 0, stream>>>(
      lse, lse2, delta, rows, sq, sq_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // D ** -0.5 as the reference computes it, in double, then rounded.
  const float scale = static_cast<float>(pow(static_cast<double>(D), -0.5));
  const Scaling sc = make_scaling(D, softcap);
  // The query heads of one KV head side by side, so that they find its K
  // and V tiles in L2. At MLA's (192, 128) with one query head a KV head
  // (deepseek-v2) nothing is shared across heads, and the K and V of the
  // heads in flight outgrow L2 (deepseek's training batch: 168 MB), so a
  // head's query tiles go side by side instead: its K and V come from
  // device memory once, not once a query tile.
  const dim3 q_grid =
      D > 128 && heads == kv_heads
          ? dim3(static_cast<unsigned>(q_tiles), static_cast<unsigned>(heads),
                 static_cast<unsigned>(batch))
          : dim3(static_cast<unsigned>(heads), static_cast<unsigned>(batch),
                 static_cast<unsigned>(q_tiles));
  err = smem_limit(reinterpret_cast<const void*>(dq_tc_kernel<D, DV, true>),
                   Tiles::kQSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_tc_kernel<D, DV, true><<<q_grid, kTcThreads, Tiles::kQSmem, stream>>>(
      tq, tk, tv, tdo, t[0], t[1], t[2], t[3], lse2, delta,
      static_cast<__nv_bfloat16*>(dq), sq, sk, sq_pad, heads, kv_heads,
      causal, window, sc, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // The dQ kernel runs on a side stream beside the dK/dV kernel (both read
  // the Delta pass's rows, and they write disjoint outputs), so that its
  // blocks fill the SMs the dK/dV blocks leave; `stream` waits for it.
  SideStream* side = nullptr;
  err = fork_side(stream, &side);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_dkdv<D, DV>(tq, tk, tv, tdo, t, lse2, delta, dk, dv, batch, sq,
                           sk, sq_pad, heads, kv_heads, causal, window,
                           sc, scale, stream);
  if (err != cudaSuccess) return static_cast<int>(err);

  err = smem_limit(reinterpret_cast<const void*>(dq_tc_kernel<D, DV, false>),
                   Tiles::kQSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_tc_kernel<D, DV, false><<<q_grid, kTcThreads, Tiles::kQSmem,
                               side->stream>>>(
      tq, tk, tv, tdo, t[0], t[1], t[2], t[3], lse2, delta,
      static_cast<__nv_bfloat16*>(dq), sq, sk, sq_pad, heads, kv_heads,
      causal, window, sc, scale);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = join_side(stream, side);
  return static_cast<int>(err);
}

// The tensor-core design at (256, 256): lse_kernel, the Delta pass, then
// dkdv_256_kernel on `stream` beside dq_256_kernel on the side stream, as
// launch_tc orders its kernels.
int launch_tc_256(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, float* scratch,
                  void* dq, void* dk, void* dv, int batch, int sq, int sk,
                  int heads, int kv_heads, int causal, int window,
                  float softcap, cudaStream_t stream) {
  constexpr int D = 256;
  const int sq_pad = (sq + kQRows - 1) / kQRows * kQRows;
  const long long rows = static_cast<long long>(batch) * heads * sq_pad;
  float* lse2 = scratch;
  float* delta = scratch + rows;
  const long long delta_blocks = (rows + kThreads - 1) / kThreads;
  const int q_tiles = (sq + kTile - 1) / kTile;
  const int k_tiles = (sk + kTile - 1) / kTile;
  if (delta_blocks > 0x7fffffffLL || q_tiles > 65535 || k_tiles > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Contiguous tensors: strides of D a head, then a row, a batch.
  const auto map = [&](CUtensorMap* m, const void* p, int seq, int nh) {
    return encode_4d(m, p, batch, seq, nh, D, D,
                     static_cast<long long>(D) * nh,
                     static_cast<long long>(D) * nh * seq, kTile);
  };
  CUtensorMap tq, tk, tv, tdo;
  if (!map(&tq, q, sq, heads) || !map(&tk, k, sk, kv_heads) ||
      !map(&tv, v, sk, kv_heads) || !map(&tdo, dout, sq, heads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  lse_kernel<<<static_cast<unsigned>(delta_blocks), kThreads, 0, stream>>>(
      lse, lse2, delta, rows, sq, sq_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // D ** -0.5 as the reference computes it, in double, then rounded.
  const float scale = static_cast<float>(pow(static_cast<double>(D), -0.5));
  const Scaling sc = make_scaling(D, softcap);
  const dim3 q_grid(static_cast<unsigned>(heads), static_cast<unsigned>(batch),
                    static_cast<unsigned>(q_tiles));
  err = smem_limit(reinterpret_cast<const void*>(dq_256_kernel<true>),
                   Tiles256::kQSmem);
  if (err == cudaSuccess) {
    err = smem_limit(reinterpret_cast<const void*>(dq_256_kernel<false>),
                     Tiles256::kQSmem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  err = smem_limit(reinterpret_cast<const void*>(dkdv_256_kernel),
                   Tiles256::kKvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_256_kernel<true><<<q_grid, 256, Tiles256::kQSmem, stream>>>(
      tq, tk, tv, tdo, lse2, delta, static_cast<__nv_bfloat16*>(dq), sq, sk,
      sq_pad, heads, kv_heads, causal, window, sc, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  SideStream* side = nullptr;
  err = fork_side(stream, &side);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 kv_grid(static_cast<unsigned>(kv_heads),
                     static_cast<unsigned>(batch),
                     static_cast<unsigned>(k_tiles));
  dkdv_256_kernel<<<kv_grid, kTcThreads, Tiles256::kKvSmem, stream>>>(
      tq, tk, tv, tdo, lse2, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), sq, sk, sq_pad, heads, kv_heads,
      causal, window, sc, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_256_kernel<false><<<q_grid, 256, Tiles256::kQSmem, side->stream>>>(
      tq, tk, tv, tdo, lse2, delta, static_cast<__nv_bfloat16*>(dq), sq, sk,
      sq_pad, heads, kv_heads, causal, window, sc, scale);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = join_side(stream, side);
  return static_cast<int>(err);
}

// The tensor-core design at a narrow pair: the Delta pass (which also
// writes lse * log2(e), lse_kernel's work at the other pairs), then
// dkdv_narrow_kernel on `stream` beside dq_narrow_kernel on the side
// stream, as launch_tc orders its kernels.
template <int D, int DV>
int launch_narrow(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, float* scratch,
                  void* dq, void* dk, void* dv, int batch, int sq, int sk,
                  int heads, int kv_heads, int causal, int window,
                  float softcap, cudaStream_t stream) {
  using Tiles = NarrowTiles<D, DV>;
  const int sq_pad = (sq + kQRows - 1) / kQRows * kQRows;
  const long long rows = static_cast<long long>(batch) * heads * sq_pad;
  float* lse2 = scratch;
  float* delta = scratch + rows;
  const int q_tiles = sq_pad / kNarrowRows;
  const int k_tiles = (sk + kNarrowRows - 1) / kNarrowRows;
  if (q_tiles > 65535 || k_tiles > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Contiguous tensors: strides of D (or DV) a head, then a row, a batch.
  // Boxes of 64 rows and of the head's box_cols columns, zero-filled
  // past the head.
  const auto map = [&](CUtensorMap* m, const void* p, int seq, int nh,
                       int d) {
    return encode_4d(m, p, batch, seq, nh, d, d,
                     static_cast<long long>(d) * nh,
                     static_cast<long long>(d) * nh * seq, kNarrowBox,
                     box_cols(d), swizzle_of(box_cols(d)));
  };
  CUtensorMap tq, tk, tv, tdo;
  if (!map(&tq, q, sq, heads, D) || !map(&tk, k, sk, kv_heads, D) ||
      !map(&tv, v, sk, kv_heads, DV) || !map(&tdo, dout, sq, heads, DV)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto delta_pass = dq_narrow_kernel<D, DV, true>;
  const auto dq_pass = dq_narrow_kernel<D, DV, false>;
  constexpr size_t delta_smem = Tiles::template q_smem<kNarrowRows>();
  constexpr size_t dq_smem = Tiles::template q_smem<kNarrowDqKeys>();
  static_assert(delta_smem <= kSmemMax && dq_smem <= kSmemMax,
                "tiles exceed shared memory");
  cudaError_t err =
      smem_limit(reinterpret_cast<const void*>(delta_pass), delta_smem);
  if (err == cudaSuccess) {
    err = smem_limit(reinterpret_cast<const void*>(dq_pass), dq_smem);
  }
  if (err == cudaSuccess) {
    err = smem_limit(reinterpret_cast<const void*>(dkdv_narrow_kernel<D, DV>),
                     Tiles::kKvSmem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  // D ** -0.5 as the reference computes it, in double, then rounded.
  const float scale = static_cast<float>(pow(static_cast<double>(D), -0.5));
  const Scaling sc = make_scaling(D, softcap);
  const dim3 q_grid(static_cast<unsigned>(heads), static_cast<unsigned>(batch),
                    static_cast<unsigned>(q_tiles));
  delta_pass<<<q_grid, kTcThreads, delta_smem, stream>>>(
      tq, tk, tv, tdo, lse, lse2, delta, static_cast<__nv_bfloat16*>(dq), sq,
      sk, sq_pad, heads, kv_heads, causal, window, sc, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  SideStream* side = nullptr;
  err = fork_side(stream, &side);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 kv_grid(static_cast<unsigned>(kv_heads),
                     static_cast<unsigned>(batch),
                     static_cast<unsigned>(k_tiles));
  dkdv_narrow_kernel<D, DV><<<kv_grid, kTcThreads, Tiles::kKvSmem, stream>>>(
      tq, tk, tv, tdo, lse2, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), sq, sk, sq_pad, heads, kv_heads,
      causal, window, sc, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_pass<<<q_grid, kTcThreads, dq_smem, side->stream>>>(
      tq, tk, tv, tdo, lse, lse2, delta, static_cast<__nv_bfloat16*>(dq), sq,
      sk, sq_pad, heads, kv_heads, causal, window, sc, scale);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = join_side(stream, side);
  return static_cast<int>(err);
}

template <int D, int DV>
int launch_dtype(const void* q, const void* k, const void* v, const void* out,
                 const void* dout, const float* lse, float* delta, void* dq,
                 void* dk, void* dv, int batch, int sq, int sk, int heads,
                 int kv_heads, int causal, int window, int dtype,
                 float softcap, cudaStream_t s) {
  if (dtype == 0) {
    return launch_bwd<D, DV>(q, k, v, out, dout, lse, delta, dq, dk, dv,
                             batch, sq, sk, heads, kv_heads, causal, window,
                             softcap, s);
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  // bfloat16: the tensor cores. The design sums Delta itself (the Delta
  // pass): it reads no output.
  if constexpr (D == 256) {
    return launch_tc_256(q, k, v, dout, lse, delta, dq, dk, dv, batch, sq,
                         sk, heads, kv_heads, causal, window, softcap, s);
  } else if constexpr (D <= 32) {
    return launch_narrow<D, DV>(q, k, v, dout, lse, delta, dq, dk, dv, batch,
                                sq, sk, heads, kv_heads, causal, window,
                                softcap, s);
  } else {
    return launch_tc<D, DV>(q, k, v, dout, lse, delta, dq, dk, dv, batch,
                            sq, sk, heads, kv_heads, causal, window, softcap,
                            s);
  }
}

}  // namespace

// q (batch, sq, heads, head_dim), k (batch, sk, kv_heads, head_dim), v
// (batch, sk, kv_heads, v_head_dim), out and dout (batch, sq, heads,
// v_head_dim): one dtype (0: float32, 1: bfloat16), contiguous, 16-byte
// aligned (the tensor-core design reads no out: its Delta pass sums
// P dP); lse (batch, heads, sq) fp32 from the forward; delta a scratch
// of 2 * batch * heads * round_up(sq, 128) floats (the CUDA-core kernels
// use the first batch * heads * sq); dq, dk, dv of q's, k's and v's shapes
// and dtype, every element written. (head_dim, v_head_dim) one of (16, 16),
// (24, 24), (24, 16), (32, 32), (64, 64), (96, 96), (128, 128), (192, 128)
// and (256, 256); causal 0/1; window <= 0 for none; softcap <= 0 for none
// (MLA's (192, 128), whose dK/dV kernel takes none, refuses one). Launches
// three kernels (the tensor-core design four), their
// work ordered on `stream` (the tensor-core design runs its dQ kernel on a
// second stream that `stream` waits for);
// returns cudaGetLastError, or cudaErrorInvalidValue for a shape it does
// not take. The design (tensor or CUDA cores) follows dtype and
// (head_dim, v_head_dim) as the header says.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int batch, int sq, int sk, int heads, int kv_heads,
    int head_dim, int v_head_dim, int causal, int window, int dtype,
    float softcap, void* stream) {
  if (batch <= 0 || heads <= 0 || (sq <= 0 && sk <= 0)) return 0;
  if (kv_heads <= 0 || heads % kv_heads != 0 || sq < 0 || sk < 0 ||
      batch > 65535 || heads > 65535 || (softcap > 0.f && head_dim == 192)) {
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
#define FLASH_CASE(D, DV)                                                  \
  case D * 1000 + DV:                                                      \
    return launch_dtype<D, DV>(q, k, v, out, dout, lse, delta, dq, dk, dv, \
                               batch, sq, sk, heads, kv_heads, causal,     \
                               window, dtype, softcap, s);
  switch (shape) {
    FLASH_CASE(16, 16)
    FLASH_CASE(24, 24)
    FLASH_CASE(24, 16)
    FLASH_CASE(32, 32)
    FLASH_CASE(64, 64)
    FLASH_CASE(96, 96)
    FLASH_CASE(128, 128)
    FLASH_CASE(192, 128)
    FLASH_CASE(256, 256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_CASE
}

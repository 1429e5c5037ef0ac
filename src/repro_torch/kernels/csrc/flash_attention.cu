// Flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _flash_kernel): q (B, Sq, H, D) attends over k (B, Sk, KV, D) and
// v (B, Sk, KV, DV) with GQA (query head h reads KV head h / (H / KV)), an optional causal mask
// (key j <= query i) and an optional window (i - j < window), positions
// counted from 0 in both. Online softmax in fp32 over the scores
// s = q.k * D**-0.5, or with a logit softcap c > 0 over c * tanh(s / c)
// (the reference's blockwise_attention caps them so, before the mask); the
// output (B, Sq, H, DV) acc / max(l, 1e-30) is written in q's dtype. (D, DV)
// is one of (16, 16), (24, 24), (24, 16), (32, 32), (64, 64), (96, 96),
// (128, 128), (192, 128) and (256, 256): the reduced configs' heads of 16,
// 24 and 32 (MLA's reduced 24 over 16), phi-3-vision's heads of 96, MLA's
// query/key heads of 192 (128 without position + 64 rotated) over value
// heads of 128 and gemma3-12b's heads of 256, as the reference's
// blockwise_attention takes them (repro/models/attention.py). A masked
// score contributes exactly 0, so a row with no visible key comes out as
// zeros.
//
// Training: with a non-null `lse` (B, H, Sq) fp32 both kernels also write
// each row's log-sum-exp of the scaled (and capped) scores, m + log(l) in
// natural-log
// units, from the epilogue's m and l (one store a row); the backward
// (flash_attention_bwd.cu) rebuilds P from it. A row with no visible key
// writes m (-inf or -1e30): its gradients are zeros whatever the value.
// Serving passes nullptr and the epilogue stores nothing more.
//
// Bound: operations. A causal pass does 4 * D operations per visible
// (query, key) pair: at B 4, S 2,048, H 48, D 128 that is 206 GFLOP, 0.208
// ms at the bf16 tensor-core rate of 989.4 TFLOP/s, against 235 MB of q, k,
// v and output (0.070 ms at 3.35 TB/s).
//
// bfloat16: a tensor-core kernel (flash_attention_tc_kernel). It runs
// every product on wgmma; softmax, loads and the ring's waits are what stand
// between it and the bound.
// * Tiles. A block of 384 threads takes two query tiles of 128 rows of one
//   (query head, batch): tile T - 1 - z and tile z of the T tiles, so every
//   block has the same causal work and the second tile's first loads overlap
//   the first tile's last products and stores. Two consumer warpgroups own
//   64 rows each; a producer warpgroup gives its registers to them
//   (setmaxnreg) and one of its threads issues the loads. Blocks are ordered
//   head fastest, so the G query heads of one KV head run side by side and
//   share its K/V tiles through L2.
// * Loads by TMA. 4-D tensor maps over (D, heads, S, B) with the tensors'
//   own strides (nothing is repacked, K/V are not repeated per query head);
//   boxes of 64 columns (128 bytes, the widest 128-byte-swizzled box) by 128
//   rows, so a D 128 tile is two boxes. D 96 (phi-3-vision) is a box of 64
//   columns and a tail box of the last 32 (64-byte rows and swizzle), each
//   through a tensor map of its own width, so that no column is zero-filled:
//   a Q, K or V tile is 24 KB, not 32; Q K^T runs 4 k16 steps in the first
//   box and 2 in the tail, and P V runs n64 + n32 (O 48 registers a
//   thread, not 64). D 192
//   is three boxes, and its blocks take one query tile instead of two:
//   two tiles of Q, the K ring and the V ring would need 257 KB of shared
//   memory, one Q tile 209 KB. (The two layouts that fit two Q tiles, K/V
//   tiles of 64 keys or a K ring of one stage, both ran slower at
//   deepseek-v2's prefill shape: PERF.md.) Each Q tile has its own buffer;
//   K and V tiles of 128 keys go through a ring of 2 stages, each with a
//   full and an empty mbarrier, so the next tile loads while this one is
//   multiplied. Rows past S are zero-filled by the TMA unit and masked here.
//   D 256 (gemma3-12b) is four boxes a row. K and V tiles of 128 keys would
//   need 64 + 2 (64 + 64) = 320 KB beside one Q tile, so there the K/V
//   tiles hold 64 keys (boxes of 64 rows): one Q tile of 128 rows and a
//   ring of 2 stages take 64 + 2 (32 + 32) = 192 KB. S is then 64 x 64 (32
//   registers a thread) beside O's 64 x 256 fp32 (128 registers).
// * S = Q K^T on wgmma m64n128k16 (m64n64k16 at D 256; bf16 in, fp32 out),
//   both operands read from shared memory through 128-byte-swizzle
//   descriptors (K-major: a k16 step is 32 bytes into a box; the 8-row
//   groups 1,024 bytes apart).
// * Heads narrower than a box (16, 24, 32) take one box as wide as the
//   head: 16 columns (32-byte rows, 32-byte swizzle) or 32 (64-byte rows,
//   64-byte swizzle), zero-filled by the TMA unit past 24 (the tensor map's
//   rows are D long, so a head never reads its neighbour's columns). Q K^T
//   runs ceil(D / 16) k16 steps, P V n16 or n32 (8 or 16 registers of O a
//   thread), and the epilogue stores DV columns. A Q tile is 4 or 8 KB, a
//   K or V tile as much: a quarter or half of D 64's, and so are the bytes
//   P V reads of V.
// * Online softmax in registers on the accumulator fragment: a thread owns
//   2 rows, reduced over its quad with shuffles; exp2 on the special-function
//   unit with D**-0.5 * log2(e) folded in. With a softcap each score is
//   scaled, capped with tanhf and multiplied by log2(e); tanh is
//   increasing, so a row's maximum is capped once, not found again. The
//   cap is a template flag of the kernel (kCap): as a runtime branch a tile
//   it made ptxas serialise the wgmmas (C7513) at every head dim, the
//   uncapped included; the flag doubles the kernel's instantiations but
//   leaves the uncapped kernel as it was. Only tiles that cross the
//   diagonal, the window's edge or Sk are masked per score (to -inf); a row
//   whose maximum is still -inf subtracts 0, so every masked score gives
//   p = 0 and a row without keys ends with l = 0 and zeros.
// * O += P V on wgmma with P converted to bf16 in registers as the A
//   operand (the accumulator fragment is the A fragment: no shared-memory
//   round trip) and V read as the MN-major B operand (transpose bit, no
//   transpose pass; the second box of 64 columns is the leading byte
//   offset; at DV 256 two n128 products, over boxes 0-1 and 2-3; at DV 96
//   n64 over the first box and n32 over the tail). Tile j's
//   S = Q K^T is issued with tile j - 1's P V, so the softmax of tile j
//   overlaps that product; O is rescaled by exp2(m_old - m_new) once it is
//   in, divided once by max(l, 1e-30) and stored as bf16, rows past Sq
//   skipped.
// P in bf16 changes each term of P V by at most 2**-9 relative. The TMA,
// mbarrier and wgmma pieces are in hopper.cuh, shared with the backward.
//
// float32: the CUDA-core kernel (flash_attention_kernel), exact fp32 sums
// within 2e-5 of the plain version, which TF32 or bf16 products could not
// hold. One block per (64 q rows, query head, batch), 4 warps; Q, K and V
// tiles in fp32 shared memory (rows padded by 4 floats against bank
// conflicts), K and V sharing one buffer in turn (rows of max(D, DV'), DV'
// DV rounded up to 32 and zero-filled past DV, so that a thread's output
// columns 4c + 32u cover heads of 16 and 24 too, stored below DV only);
// thread (r, c) of a 16 x 8
// grid owns rows 4r .. 4r+3 and the score columns c, c + 8, ...; a validity
// bit per score keeps masked keys at p = 0; the probabilities go through
// shared memory to the product with V. Tiles wholly above the diagonal or
// outside the window are never loaded; heavy q tiles first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kBM = 64;  // query rows per block
constexpr int kBN = 64;  // keys per tile
constexpr int kThreads = 128;
constexpr int kPadP = kBN + 4;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Rows [0, rows) of a tile of kRows x D values of T (row stride `stride`
// elements) into fp32 shared memory with row stride kW + 4 (kW >= D);
// zeros past rows and in columns D .. kW - 1.
template <typename T, int D, int kRows, int kW = D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride, int rows) {
  constexpr int kChunks = kW / 4;
  constexpr int kLd = kW + 4;
  for (int idx = threadIdx.x; idx < kRows * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows && 4 * c < D) v = load4(src + r * stride + 4 * c);
    store4(dst + r * kLd + 4 * c, v);
  }
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int sq, int sk, int heads,
                       int kv_heads, int causal, int window, float scale,
                       float softcap) {
  constexpr int kLd = D + 4;
  constexpr int kDVp = pad32(DV);  // V's columns in shared memory
  constexpr int kLdV = kDVp + 4;
  constexpr int kLdKV = kLd > kLdV ? kLd : kLdV;
  constexpr int kCols = kDVp / 32;  // float4 output columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // kBM x kLd
  float* kvs = qs + kBM * kLd;                  // kBN x kLdKV: K, then V
  float* ps = kvs + kBN * kLdKV;                // kBM x kPadP

  const int qt = gridDim.x - 1 - blockIdx.x;  // late (heavy) tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (heads / kv_heads);
  const int q0 = qt * kBM;
  const int tr = threadIdx.x / 8;  // rows 4 tr .. 4 tr + 3
  const int tc = threadIdx.x % 8;

  const long long q_stride = static_cast<long long>(heads) * D;
  const long long kv_stride = static_cast<long long>(kv_heads) * D;
  const long long v_stride = static_cast<long long>(kv_heads) * DV;
  const long long o_stride = static_cast<long long>(heads) * DV;
  const T* qb = q + (static_cast<long long>(b) * sq + q0) * q_stride +
                static_cast<long long>(h) * D;
  const T* kb = k + static_cast<long long>(b) * sk * kv_stride +
                static_cast<long long>(kh) * D;
  const T* vb = v + static_cast<long long>(b) * sk * v_stride +
                static_cast<long long>(kh) * DV;

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
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s[i][j] = valid ? x : kNegInf;
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
    load_tile<T, DV, kBN, kDVp>(kvs, vb + k0 * v_stride, v_stride, k_rows);
    __syncthreads();  // V (and this warp's probabilities) visible

    // acc += P V over this tile's keys.
    for (int key = 0; key < kBN; key += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = load4(ps + (4 * tr + i) * kPadP + key);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = kvs + (key + u) * kLdV + 4 * tc;
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
    if (lse != nullptr && tc == 0) {
      lse[(static_cast<long long>(b) * heads + h) * sq + q0 + row] =
          m[i] + logf(den);
    }
    T* orow = out + (static_cast<long long>(b) * sq + q0 + row) * o_stride +
              static_cast<long long>(h) * DV + 4 * tc;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (4 * tc + 32 * c >= DV) continue;  // V's zero padding
      const float4 a = acc[i][c];
      store4(orow + 32 * c,
             make_float4(a.x / den, a.y / den, a.z / den, a.w / den));
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kTcRows = 128;       // query rows per block: 2 warpgroups of 64
constexpr int kTcStages = 2;       // K/V ring depth
constexpr int kTcThreads = 384;    // 2 consumer warpgroups + 1 producer
constexpr size_t kSmemMax = 232448;        // a block's dynamic shared memory

// The tensor-core kernel's tiles for query/key head dim D and value head dim
// DV: boxes of box_cols columns and, at D 96, a last box of the remaining
// 32 (tail_cols); K/V tiles of kKeys keys (128; 64 at D 256, where tiles of
// 128 would not fit), P V as wide as the V boxes (n16 or n32 at a narrow
// DV, n64 + n32 at 96), and two query tiles a block where they fit.
template <int D, int DV>
struct TcTiles {
  static constexpr int kKeys = D > 192 ? 64 : 128;  // keys per K/V tile
  static constexpr int kCols = box_cols(D);         // columns of a Q/K box
  static constexpr int kVCols = box_cols(DV);       // of a V box
  static constexpr int kTail = tail_cols(D);        // of Q/K's last box
  static constexpr int kVTail = tail_cols(DV);      // of V's (0: none)
  static constexpr int kQkBoxes = (D - kTail + kCols - 1) / kCols;
  static constexpr int kVBoxes = (DV - kVTail + kVCols - 1) / kVCols;
  static constexpr int kPv = kVBoxes * kVCols + kVTail;  // n of P V
  static constexpr uint32_t kRow = 2 * kCols;   // bytes of a box row
  static constexpr uint32_t kVRow = 2 * kVCols;
  static constexpr uint32_t kQBox = kTcRows * kRow;  // one box of a Q tile
  static constexpr uint32_t kKBox = kKeys * kRow;    // one box of K
  static constexpr uint32_t kVBox = kKeys * kVRow;   // one box of V
  // A tile: its full boxes, then its tail box (rows of 2 kTail bytes).
  static constexpr uint32_t kQ = kQkBoxes * kQBox + kTcRows * 2 * kTail;
  static constexpr uint32_t kK = kQkBoxes * kKBox + kKeys * 2 * kTail;
  static constexpr uint32_t kV = kVBoxes * kVBox + kKeys * 2 * kVTail;
  // The K and V rings and 1 KB of alignment slack, beside the Q tiles.
  static constexpr size_t kRing =
      kTcStages * (static_cast<size_t>(kK) + kV) + 1024;
  static constexpr int kQTiles =
      2 * static_cast<size_t>(kQ) + kRing <= kSmemMax ? 2 : 1;
  static constexpr size_t kSmem = kQTiles * static_cast<size_t>(kQ) + kRing;
  static_assert(kSmem <= kSmemMax, "tiles exceed shared memory");
  static_assert(kTail == kVTail && (kTail == 0 || kTail == 32),
                "a tail box of 32 columns, at D = DV = 96 only");
  // Above the narrow heads no box is zero-filled past the head, and no
  // product is wider than it: at 96 the tiles are 64 + 32 columns.
  static_assert(D <= 32 || kQkBoxes * kCols + kTail == D,
                "Q and K boxes cover the head exactly");
  static_assert(DV <= 32 || kPv == DV, "P V is as wide as the head");
  static_assert(kPv == 16 || kPv == 32 || kPv == 64 || kPv == 96 ||
                    kPv == 128 || kPv == 256,
                "P V is n16, n32, n64, n64 + n32, n128 or two n128 halves");
};

// At D 256 (kKeys 64) the consumer holds O's 128 registers a thread, and
// ptxas kept every step's descriptors of both products live across the
// loop and spilled (88 bytes a thread); there each product's base
// descriptor is made opaque (hopper.cuh), so that a step's is one add
// from it.
// S (64 x kKeys) = Q K^T for one warpgroup: Q rows at `q_s` in boxes of 128
// rows, the K tile at `k_s` in boxes of kKeys rows, both K-major in boxes of
// 64 columns; a k16 step is 32 bytes into a box, steps 4..7 are in the
// second box, 8..11 (D 192, 256) in the third and 12..15 (D 256) in the
// fourth. A narrow head's one box of kCols columns: a step is 32 bytes into
// its row. At D 96 (kTail 32) steps 4 and 5 are in the tail boxes at `q_t`
// and `k_t` (64-byte rows, 64-byte swizzle).
template <int D, int kKeys, int kCols = kBoxCols, int kTail = 0>
__device__ __forceinline__ void qk_product(float (&s)[kKeys / 2],
                                           uint32_t q_s, uint32_t k_s,
                                           uint32_t q_t = 0,
                                           uint32_t k_t = 0) {
  constexpr int kSteps = (D + 15) / 16;  // zeros past D add nothing
  constexpr uint32_t kQBoxBytes = kTcRows * 128;
  if constexpr (kCols < kBoxCols) {
    static_assert(kKeys == 128, "a narrow head's K/V tiles are 128 keys");
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const uint64_t a = narrow_kmajor<2 * kCols>(q_s, kk);
      const uint64_t b = narrow_kmajor<2 * kCols>(k_s, kk);
      if (kk == 0) {
        wgmma_m64n128k16_ss_first(s, a, b);
      } else {
        wgmma_m64n128k16_ss(s, a, b);
      }
    }
  } else if constexpr (kTail > 0) {
    static_assert(kKeys == 128 && D == kBoxCols + kTail, "D 96: 64 + 32");
#pragma unroll
    for (int kk = 0; kk < kBoxCols / 16; ++kk) {
      const uint64_t a = sw128_desc(q_s + 32 * kk, 16, 1024);
      const uint64_t b = sw128_desc(k_s + 32 * kk, 16, 1024);
      if (kk == 0) {
        wgmma_m64n128k16_ss_first(s, a, b);
      } else {
        wgmma_m64n128k16_ss(s, a, b);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kTail / 16; ++kk) {
      wgmma_m64n128k16_ss(s, narrow_kmajor<2 * kTail>(q_t, kk),
                          narrow_kmajor<2 * kTail>(k_t, kk));
    }
  } else if constexpr (kKeys == 64) {
    const uint64_t qa = opaque(sw128_desc(q_s, 16, 1024));
    const uint64_t kb = opaque(sw128_desc(k_s, 16, 1024));
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const uint32_t col = 32 * (kk % 4);
      const uint64_t a = qa + (((kk / 4) * kQBoxBytes + col) >> 4);
      const uint64_t b = kb + (((kk / 4) * (kKeys * 128) + col) >> 4);
      if (kk == 0) {
        wgmma_m64n64k16_ss_first(s, a, b);
      } else {
        wgmma_m64n64k16_ss(s, a, b);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const uint32_t off = (kk / 4) * kQBoxBytes + 32 * (kk % 4);
      const uint64_t a = sw128_desc(q_s + off, 16, 1024);
      const uint64_t b = sw128_desc(k_s + off, 16, 1024);
      if (kk == 0) {
        wgmma_m64n128k16_ss_first(s, a, b);
      } else {
        wgmma_m64n128k16_ss(s, a, b);
      }
    }
  }
}

// O (64 x N) += P V: P's k16 step kk is registers p[4kk .. 4kk+3]; V is
// MN-major, 16 keys (2 swizzle atoms, 2,048 bytes) per step, the next box
// of 64 columns one box of kKeys rows on (the leading byte offset). N 256
// (with kKeys 64) runs as two n128 halves, boxes 0-1 and 2-3: element
// 64 + i of o is element i of the second half's fragment, as in an n256
// one. A narrow DV's one box of N (16 or 32) columns: n16 or n32, 16 rows
// of 2 N bytes a step. N 96: n64 over the 64-column box, then n32 over the
// tail box at `v_t` (64-byte rows): element 32 + i of o is element i of
// the n32 fragment, as in an n96 one.
template <int N, int kKeys>
__device__ __forceinline__ void pv_product(float (&o)[N / 2],
                                           const uint32_t (&p)[kKeys / 4],
                                           uint32_t v_s, uint32_t v_t = 0) {
  constexpr uint32_t kBox = kKeys * 128;
  if constexpr (N == 96) {
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      wgmma_m64n64k16_rs(*reinterpret_cast<float(*)[32]>(o), p[4 * kk],
                         p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                         sw128_desc(v_s + 2048 * kk, kBox, 1024));
      wgmma_m64n32k16_rs(*reinterpret_cast<float(*)[16]>(o + 32), p[4 * kk],
                         p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                         narrow_mnmajor<64>(v_t, kk));
    }
  } else if constexpr (N < 64) {
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      wgmma_rs<N>(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                  narrow_mnmajor<2 * N>(v_s, kk));
    }
  } else if constexpr (N == 256) {
    const uint64_t vb = opaque(sw128_desc(v_s, kBox, 1024));
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      wgmma_m64n128k16_rs(*reinterpret_cast<float(*)[64]>(o), p[4 * kk],
                          p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                          vb + ((2048 * kk) >> 4));
      wgmma_m64n128k16_rs(*reinterpret_cast<float(*)[64]>(o + 64), p[4 * kk],
                          p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                          vb + ((2 * kBox + 2048 * kk) >> 4));
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint64_t b = sw128_desc(v_s + 2048 * kk, kBox, 1024);
      if constexpr (N == 128) {
        wgmma_m64n128k16_rs(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                            p[4 * kk + 3], b);
      } else {
        wgmma_m64n64k16_rs(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                           p[4 * kk + 3], b);
      }
    }
  }
}

// Whether a tile of kKeys keys from k0 needs a per-score mask for the rows
// of one warpgroup (row_lo .. row_lo + 63): it crosses Sk, the diagonal or
// the window's edge.
template <int kKeys>
__device__ __forceinline__ bool tile_needs_mask(int k0, int row_lo, int sk,
                                                int causal, int window) {
  return k0 + kKeys > sk || (causal && k0 + kKeys - 1 > row_lo) ||
         (window > 0 && row_lo + 63 - k0 >= window);
}

// Bit 4j + e: whether score s[4j + e] (row r0 + 8 (e / 2), key
// k0 + 8j + c0 + e % 2) is visible. Each (row, column parity) sees a run of
// the kKeys / 8 column groups j, which is then spread to every fourth bit.
template <int kKeys>
__device__ __forceinline__ uint64_t visible_bits(int k0, int r0, int c0,
                                                 int sk, int causal,
                                                 int window) {
  uint64_t bits = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int qi = r0 + 8 * (e / 2);
    const int base = k0 + c0 + e % 2;  // key of column group j = base + 8j
    const int lo = window > 0 ? qi - window + 1 - base : 0;
    const int hi = (causal ? min(qi, sk - 1) : sk - 1) - base;
    const int j_lo = max(0, (lo + 7) >> 3);           // ceil(lo / 8)
    const int j_hi = min(kKeys / 8 - 1, hi >> 3);     // floor(hi / 8)
    uint64_t run = j_hi >= j_lo ? (2u << j_hi) - (1u << j_lo) : 0u;
    run = (run | run << 24) & 0x000000FF000000FFull;
    run = (run | run << 12) & 0x000F000F000F000Full;
    run = (run | run << 6) & 0x0303030303030303ull;
    run = (run | run << 3) & 0x1111111111111111ull;
    bits |= run << e;
  }
  return bits;
}

// Turns one tile of scores into bf16 probabilities for rows r0 and r0 + 8
// in the A-operand order (p[2j + r]: row r, columns 8j + c0, + 1), a score
// whose bit in `visible` is clear (kMasked) counting as -inf. Updates the
// running maxima m and this thread's parts l of the row sums; corr is the
// factor by which O must be rescaled before this tile's P V is added. m is
// in score units, or with the cap (kCap) in the capped exp2 units: tanh is
// increasing, so the capped maximum is the cap of the raw one. The
// scores are only read: a register that a wgmma accumulates into is written
// by nothing else, so ptxas need not serialise the products.
template <bool kMasked, bool kCap, int kKeys>
__device__ __forceinline__ void softmax_tile(const float (&s)[kKeys / 2],
                                             uint32_t (&p)[kKeys / 4],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2],
                                             uint64_t visible,
                                             Scaling sc) {
  const auto score = [&](int i) {
    return kMasked && !((visible >> i) & 1) ? -INFINITY : s[i];
  };
  // The exp2 argument of score i, less ms; -inf where masked.
  const auto arg = [&](int i, float ms) {
    float t;
    if constexpr (kCap) {
      return kMasked && !((visible >> i) & 1)
                 ? -INFINITY
                 : score_arg<true>(s[i], ms, sc, t);
    } else {
      return score_arg<false>(score(i), ms, sc, t);
    }
  };
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kCap ? -INFINITY : m[r];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      mx = fmaxf(mx, fmaxf(score(4 * j + 2 * r), score(4 * j + 2 * r + 1)));
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // A row with no visible key yet keeps max -inf: subtract 0, so its -inf
    // scores give exp2(-inf) = 0, never exp2(0) = 1.
    float ms;
    if constexpr (kCap) {
      if (mx != -INFINITY) mx = sc.cap_log2 * tanhf(mx * sc.cap_scale);
      mx = fmaxf(mx, m[r]);
      ms = mx == -INFINITY ? 0.f : mx;
      corr[r] = exp2_approx(m[r] - ms);
    } else {
      ms = mx == -INFINITY ? 0.f : mx * sc.scale_log2;
      corr[r] = exp2_approx(m[r] * sc.scale_log2 - ms);
    }
    m[r] = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      const float a = exp2_approx(arg(4 * j + 2 * r, ms));
      const float c = exp2_approx(arg(4 * j + 2 * r + 1, ms));
      sum += a + c;
      p[2 * j + r] = pack_bf16(a, c);
    }
    l[r] = l[r] * corr[r] + sum;
  }
}

// tq_t, tk_t and tv_t map the tail boxes at D 96 (unread elsewhere).
template <int D, int DV, bool kCap>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tq_t,
                          const __grid_constant__ CUtensorMap tk_t,
                          const __grid_constant__ CUtensorMap tv_t,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, int sq, int sk, int heads,
                          int kv_heads, int causal, int window,
                          const Scaling sc) {
  using Tiles = TcTiles<D, DV>;
  constexpr uint32_t kQ = Tiles::kQ;    // bytes of a Q tile
  constexpr uint32_t kK = Tiles::kK;    // bytes of a K tile
  constexpr uint32_t kV = Tiles::kV;    // bytes of a V tile
  constexpr int kQTiles = Tiles::kQTiles;
  constexpr int kPv = Tiles::kPv;
  constexpr int kKeys = Tiles::kKeys;
  constexpr int kTail = Tiles::kTail;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 + 4 * kTcStages];
  // Swizzle atoms must be 1024-byte aligned: the launch adds 1 KB of slack.
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const auto q_s = [&](int t) { return base + t * kQ; };
  const auto k_s = [&](int st) { return base + kQTiles * kQ + st * kK; };
  const auto v_s = [&](int st) {
    return base + kQTiles * kQ + kTcStages * kK + st * kV;
  };
  const uint32_t bar0 = smem_u32(bars);
  const auto q_full = [&](int t) { return bar0 + 8 * t; };
  const auto k_full = [&](int st) { return bar0 + 8 * (2 + st); };
  const auto k_empty = [&](int st) {
    return bar0 + 8 * (2 + kTcStages + st);
  };
  const auto v_full = [&](int st) {
    return bar0 + 8 * (2 + 2 * kTcStages + st);
  };
  const auto v_empty = [&](int st) {
    return bar0 + 8 * (2 + 3 * kTcStages + st);
  };
  const auto stage = [](int it) { return it % kTcStages; };
  const auto phase = [](int it) { return (it / kTcStages) & 1u; };
  // The tail boxes (D 96): after a tile's full boxes.
  const auto k_t = [&](int st) {
    return k_s(st) + Tiles::kQkBoxes * Tiles::kKBox;
  };
  const auto v_t = [&](int st) {
    return v_s(st) + Tiles::kVBoxes * Tiles::kVBox;
  };

  // Grid (heads, batch, query tiles), or at MLA's (192, 128) with one
  // query head a KV head (query tiles, heads, batch): see launch_tc.
  const bool tiles_first = D > 128 && heads == kv_heads;
  const int h = tiles_first ? blockIdx.y : blockIdx.x;
  const int b = tiles_first ? blockIdx.z : blockIdx.y;
  const int kh = h / (heads / kv_heads);
  // The block's query tiles: tile T - 1 - z, then tile z (one tile where
  // they meet), so every block has the same causal work, the heavy first.
  // With one Q tile a block (kQTiles 1), block z takes tile T - 1 - z.
  const int z = tiles_first ? blockIdx.x : blockIdx.z;
  const int qt_first = (sq + kTcRows - 1) / kTcRows - 1 - z;
  const int n_q = kQTiles == 2 && z < qt_first ? 2 : 1;
  struct Span {
    int q0, k_lo, n_tiles;  // keys [k_lo, k_hi) in tiles from k_lo
  };
  const auto span = [&](int t) {
    Span sp;
    sp.q0 = (t == 0 ? qt_first : z) * kTcRows;
    const int q_last = min(sp.q0 + kTcRows, sq) - 1;
    const int k_hi = causal ? min(sk, q_last + 1) : sk;
    sp.k_lo = window > 0 ? max(0, sp.q0 - window + 1) : 0;
    sp.n_tiles =
        k_hi > sp.k_lo ? (k_hi - sp.k_lo + kKeys - 1) / kKeys : 0;
    return sp;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full(0), 1);
    mbar_init(q_full(1), 1);
    for (int st = 0; st < kTcStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), 2 * 128);
      mbar_init(v_empty(st), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp >= 8) {
    // Producer warpgroup: gives its registers to the consumers; one thread
    // issues every load. Both Q tiles first (a buffer each), then the K/V
    // tiles of both through one ring, so the second tile's first loads
    // overlap the first tile's last products and its output stores.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (threadIdx.x != 256) return;
    for (int t = 0; t < n_q; ++t) {
      const Span sp = span(t);
      if (sp.n_tiles == 0) continue;
      mbar_expect_tx(q_full(t), kQ);
      for (int c = 0; c < Tiles::kQkBoxes; ++c) {
        tma_load_4d(q_s(t) + c * Tiles::kQBox, &tq, q_full(t),
                    c * Tiles::kCols, h, sp.q0, b);
      }
      if constexpr (kTail > 0) {
        tma_load_4d(q_s(t) + Tiles::kQkBoxes * Tiles::kQBox, &tq_t, q_full(t),
                    Tiles::kQkBoxes * Tiles::kCols, h, sp.q0, b);
      }
    }
    int it = 0;
    for (int t = 0; t < n_q; ++t) {
      const Span sp = span(t);
      for (int j = 0; j < sp.n_tiles; ++j, ++it) {
        const int st = stage(it);
        const int k0 = sp.k_lo + j * kKeys;
        mbar_wait(k_empty(st), phase(it) ^ 1);  // the first round passes
        mbar_expect_tx(k_full(st), kK);
        for (int c = 0; c < Tiles::kQkBoxes; ++c) {
          tma_load_4d(k_s(st) + c * Tiles::kKBox, &tk, k_full(st),
                      c * Tiles::kCols, kh, k0, b);
        }
        if constexpr (kTail > 0) {
          tma_load_4d(k_t(st), &tk_t, k_full(st),
                      Tiles::kQkBoxes * Tiles::kCols, kh, k0, b);
        }
        mbar_wait(v_empty(st), phase(it) ^ 1);
        mbar_expect_tx(v_full(st), kV);
        for (int c = 0; c < Tiles::kVBoxes; ++c) {
          tma_load_4d(v_s(st) + c * Tiles::kVBox, &tv, v_full(st),
                      c * Tiles::kVCols, kh, k0, b);
        }
        if constexpr (kTail > 0) {
          tma_load_4d(v_t(st), &tv_t, v_full(st),
                      Tiles::kVBoxes * Tiles::kVCols, kh, k0, b);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");

  // Consumers: warpgroup wg owns rows q0 + 64 wg .. + 63 of each query tile;
  // this thread owns rows r0 and r0 + 8 and, of every 8 columns of a
  // fragment, c0 and c0 + 1.
  const int wg = warp / 4;
  const int lane = threadIdx.x % 32;
  const int c0 = 2 * (lane % 4);
  int it0 = 0;  // ring index of the query tile's first K/V tile
#pragma unroll 1
  for (int t = 0; t < n_q; ++t) {
    const Span sp = span(t);
    const int row_lo = sp.q0 + 64 * wg;
    const int r0 = row_lo + 16 * (warp % 4) + lane / 4;
    const uint32_t q_wg = q_s(t) + wg * 64 * Tiles::kRow;
    const uint32_t q_wg_t =  // this warpgroup's rows of the tail box
        q_s(t) + Tiles::kQkBoxes * Tiles::kQBox + wg * 64 * 2 * kTail;

    float o[kPv / 2];
#pragma unroll
    for (int i = 0; i < kPv / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};

    if (sp.n_tiles > 0) {
      float s[kKeys / 2];
      uint32_t p[kKeys / 4];
      float corr[2];
      mbar_wait(q_full(t), 0);
      mbar_wait(k_full(stage(it0)), phase(it0));
      wgmma_fence();
      qk_product<D, kKeys, Tiles::kCols, kTail>(s, q_wg, k_s(stage(it0)),
                                                q_wg_t, k_t(stage(it0)));
      wgmma_commit();
      wgmma_wait<0>();
      hold(s);
      mbar_arrive(k_empty(stage(it0)));
      // The first tile always takes the masked form (one copy of the
      // softmax fewer); O is 0, so nothing is rescaled.
      softmax_tile<true, kCap, kKeys>(
          s, p, m, l, corr,
          visible_bits<kKeys>(sp.k_lo, r0, c0, sk, causal, window), sc);

      // Tile j's S = Q K^T runs beside tile j - 1's O += P V; its softmax
      // overlaps that product, and O is rescaled once the product is in.
      // Unrolled by 2 so that p and p_next trade registers instead of
      // being copied: a copy into p while a product is in flight would make
      // ptxas serialise the wgmmas.
#pragma unroll 2
      for (int j = 1; j < sp.n_tiles; ++j) {
        const int it = it0 + j;
        mbar_wait(k_full(stage(it)), phase(it));
        mbar_wait(v_full(stage(it - 1)), phase(it - 1));
        hold(o);
        hold(p);
        wgmma_fence();
        qk_product<D, kKeys, Tiles::kCols, kTail>(s, q_wg, k_s(stage(it)),
                                                  q_wg_t, k_t(stage(it)));
        wgmma_commit();
        pv_product<kPv, kKeys>(o, p, v_s(stage(it - 1)),
                               v_t(stage(it - 1)));
        wgmma_commit();
        wgmma_wait<1>();  // S is in
        hold(s);
        mbar_arrive(k_empty(stage(it)));
        uint32_t p_next[kKeys / 4];
        const int k0 = sp.k_lo + j * kKeys;
        if (tile_needs_mask<kKeys>(k0, row_lo, sk, causal, window)) {
          softmax_tile<true, kCap, kKeys>(
              s, p_next, m, l, corr,
              visible_bits<kKeys>(k0, r0, c0, sk, causal, window), sc);
        } else {
          softmax_tile<false, kCap, kKeys>(s, p_next, m, l, corr, 0, sc);
        }
        wgmma_wait<0>();  // O += P V of tile j - 1 is in
        hold(o);
        hold(p);
        mbar_arrive(v_empty(stage(it - 1)));
#pragma unroll
        for (int i = 0; i < kPv / 8; ++i) {
          o[4 * i] *= corr[0];
          o[4 * i + 1] *= corr[0];
          o[4 * i + 2] *= corr[1];
          o[4 * i + 3] *= corr[1];
        }
#pragma unroll
        for (int i = 0; i < kKeys / 4; ++i) p[i] = p_next[i];
      }

      const int last = it0 + sp.n_tiles - 1;
      mbar_wait(v_full(stage(last)), phase(last));
      hold(o);
      hold(p);
      wgmma_fence();
      pv_product<kPv, kKeys>(o, p, v_s(stage(last)), v_t(stage(last)));
      wgmma_commit();
      wgmma_wait<0>();
      hold(o);
      hold(p);
      mbar_arrive(v_empty(stage(last)));
      it0 += sp.n_tiles;
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int qi = r0 + 8 * r;
      if (qi >= sq) continue;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      if (lse != nullptr && c0 == 0) {
        // l is in exp2 units; m in score units of scale_log2, or capped
        // exp2 units.
        const float m2 = kCap ? m[r] : m[r] * sc.scale_log2;
        lse[(static_cast<long long>(b) * heads + h) * sq + qi] =
            m[r] == -INFINITY
                ? -INFINITY
                : (m2 + log2f(l[r])) * 0.6931471805599453f;
      }
      __nv_bfloat16* orow =
          out + ((static_cast<long long>(b) * sq + qi) * heads + h) * DV + c0;
#pragma unroll
      for (int i = 0; i < DV / 8; ++i) {
        *reinterpret_cast<uint32_t*>(orow + 8 * i) =
            pack_bf16(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
      }
    }
  }
}

template <typename T, int D, int DV>
int launch_d(const void* q, const void* k, const void* v, void* out,
             float* lse, int batch, int sq, int sk, int heads, int kv_heads,
             int causal, int window, float softcap, cudaStream_t stream) {
  constexpr int kDVp = pad32(DV);
  const size_t smem =
      sizeof(float) * (kBM * static_cast<size_t>(D + 4) +
                       kBN * static_cast<size_t>((D > kDVp ? D : kDVp) + 4) +
                       kBM * kPadP);
  const cudaError_t err = smem_limit(
      reinterpret_cast<const void*>(flash_attention_kernel<T, D, DV>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // D ** -0.5 as the reference computes it, in double, then rounded.
  const float scale = static_cast<float>(pow(static_cast<double>(D), -0.5));
  const dim3 grid(static_cast<unsigned>((sq + kBM - 1) / kBM),
                  static_cast<unsigned>(heads), static_cast<unsigned>(batch));
  flash_attention_kernel<T, D, DV><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, sq, sk, heads,
      kv_heads, causal, window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int DV>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              float* lse, int batch, int sq, int sk, int heads, int kv_heads,
              int causal, int window, float softcap, cudaStream_t stream) {
  using Tiles = TcTiles<D, DV>;
  if (sk == 0) {  // no keys: every row is zeros (the wrapper sets lse)
    return static_cast<int>(cudaMemsetAsync(
        out, 0, sizeof(__nv_bfloat16) * batch * sq * heads * DV, stream));
  }
  const int q_tiles = (sq + kTcRows - 1) / kTcRows;
  const int blocks_z = (q_tiles + Tiles::kQTiles - 1) / Tiles::kQTiles;
  if (blocks_z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, tq_t, tk_t, tv_t;
  // Contiguous tensors: strides of D (or DV) a head, then a row, a batch
  // (32 bytes and more: multiples of 16, as TMA wants). Boxes of 128 rows
  // for Q, of the tiles' keys for K and V; of box_cols columns, zero-filled
  // past a narrow head's D as past the tensor's edge; at D 96 the tail maps
  // (tq_t, ...) take boxes of the last 32 columns.
  const auto map = [&](CUtensorMap* m, const void* p, int seq, int nh, int d,
                       int rows, int cols) {
    return encode_4d(m, p, batch, seq, nh, d, d,
                     static_cast<long long>(d) * nh,
                     static_cast<long long>(d) * nh * seq, rows, cols,
                     swizzle_of(cols));
  };
  if (!map(&tq, q, sq, heads, D, kTcRows, Tiles::kCols) ||
      !map(&tk, k, sk, kv_heads, D, Tiles::kKeys, Tiles::kCols) ||
      !map(&tv, v, sk, kv_heads, DV, Tiles::kKeys, Tiles::kVCols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if constexpr (Tiles::kTail > 0) {
    if (!map(&tq_t, q, sq, heads, D, kTcRows, Tiles::kTail) ||
        !map(&tk_t, k, sk, kv_heads, D, Tiles::kKeys, Tiles::kTail) ||
        !map(&tv_t, v, sk, kv_heads, DV, Tiles::kKeys, Tiles::kVTail)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    tq_t = tq;
    tk_t = tk;
    tv_t = tv;
  }
  const Scaling sc = make_scaling(D, softcap);
  // Blocks ordered head fastest, so that the G query heads of one KV head
  // run side by side and share its K/V tiles through L2. At MLA's (192,
  // 128) with one query head a KV head (deepseek-v2) nothing is shared
  // across heads and the K and V of the heads in flight outgrow L2, so a
  // head's query tiles go side by side instead: its K and V come from
  // device memory once, not once a query tile. (At phi-3-vision's G 1 and
  // head dim 96 they fit L2, and that order measured 1 % slower.)
  const dim3 grid =
      D > 128 && heads == kv_heads
          ? dim3(static_cast<unsigned>(blocks_z),
                 static_cast<unsigned>(heads), static_cast<unsigned>(batch))
          : dim3(static_cast<unsigned>(heads), static_cast<unsigned>(batch),
                 static_cast<unsigned>(blocks_z));
  const auto run = [&](auto cap) {
    const auto kernel = flash_attention_tc_kernel<D, DV, decltype(cap)::value>;
    const cudaError_t err =
        smem_limit(reinterpret_cast<const void*>(kernel), Tiles::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kTcThreads, Tiles::kSmem, stream>>>(
        tq, tk, tv, tq_t, tk_t, tv_t, static_cast<__nv_bfloat16*>(out), lse,
        sq, sk, heads, kv_heads, causal, window, sc);
    return static_cast<int>(cudaGetLastError());
  };
  if (sc.cap_log2 <= 0.f) return run(Flag<false>{});
  if constexpr (D == 192) {  // MLA passes no cap: no capped instantiation
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return run(Flag<true>{});
  }
}

// The launch for one (D, DV) pair in one dtype (0: float32, 1: bfloat16).
template <int D, int DV>
int launch_dtype(const void* q, const void* k, const void* v, void* out,
                 float* lse, int batch, int sq, int sk, int heads,
                 int kv_heads, int causal, int window, int dtype,
                 float softcap, cudaStream_t s) {
  if (dtype == 0) {
    return launch_d<float, D, DV>(q, k, v, out, lse, batch, sq, sk, heads,
                                  kv_heads, causal, window, softcap, s);
  }
  if (dtype == 1) {
    return launch_tc<D, DV>(q, k, v, out, lse, batch, sq, sk, heads,
                            kv_heads, causal, window, softcap, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q: (batch, sq, heads, head_dim); k: (batch, sk, kv_heads, head_dim); v:
// (batch, sk, kv_heads, v_head_dim); out: (batch, sq, heads, v_head_dim);
// lse: (batch, heads, sq) fp32, or nullptr to write no log-sum-exp;
// all but lse of one dtype (0: float32, 1: bfloat16), contiguous and 16-byte
// aligned. heads a multiple of kv_heads; (head_dim, v_head_dim) one of
// (16, 16), (24, 24), (24, 16), (32, 32), (64, 64), (96, 96), (128, 128),
// (192, 128) and (256, 256). causal 0/1; window <= 0 for none; softcap <= 0
// for none (MLA's (192, 128) takes none). float32 runs the CUDA-core kernel,
// bfloat16 the tensor-core one. Launches on `stream`; returns
// cudaGetLastError, or cudaErrorInvalidValue for a shape it does not take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      int batch,
                                      int sq, int sk, int heads, int kv_heads,
                                      int head_dim, int v_head_dim, int causal,
                                      int window, int dtype, float softcap,
                                      void* stream) {
  if (batch <= 0 || sq <= 0 || heads <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads != 0 || sk < 0 || batch > 65535 ||
      heads > 65535 || (softcap > 0.f && head_dim == 192)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int shape = head_dim * 1000 + v_head_dim;
#define FLASH_CASE(D, DV)                                                   \
  case D * 1000 + DV:                                                       \
    return launch_dtype<D, DV>(q, k, v, out, lse, batch, sq, sk, heads,     \
                               kv_heads, causal, window, dtype, softcap, s);
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

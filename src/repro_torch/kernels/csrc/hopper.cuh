// Hopper (sm_90a) building blocks shared by the tensor-core flash
// attention kernels (flash_attention.cu's forward, flash_attention_bwd.cu's
// backward): mbarriers, TMA loads through 4-D tensor maps and 1-D bulk
// copies, wgmma shared-memory descriptors for 128-, 64- and 32-byte-swizzled
// operands, the wgmma products (bf16 in, fp32 accumulators) with A from
// shared memory or from registers and B K-major or MN-major, the proxy
// fence before a product reads what threads stored, and on the host the
// tensor-map encoder and a kernel's shared-memory limit, set once.
//
// Operand layouts. A tile of R rows by 64 bf16 columns (one TMA box, 128
// bytes a row) is 128-byte swizzled in atoms of 8 rows (1,024 bytes), so a
// tile of D columns is D / 64 boxes of R * 128 bytes, each box 1,024-byte
// aligned. K-major operand (the reduction runs along the row): a k16 step is
// 32 bytes into a box, steps 4..7 in the next box; stride byte offset 1,024.
// MN-major operand (the reduction runs down the rows, the transpose bit set):
// a k16 step is 16 rows (2,048 bytes) down, the next 64 columns are the next
// box (the leading byte offset, R * 128); stride byte offset 1,024.
//
// A head of 96 is a box of 64 columns and a box of its last 32 (the
// narrow layout below), each loaded through a tensor map of its own width.
//
// Narrow heads (the flash kernels' D and DV of 16 to 32) take boxes as wide
// as the head instead: 16 columns (32-byte rows, 32-byte swizzle, atoms of
// 8 rows = 256 bytes) or 32 columns (64-byte rows, 64-byte swizzle, atoms of
// 512 bytes). K-major: a k16 step is 32 bytes into the row (at 16 columns
// the whole row), stride byte offset 8 rows. MN-major: a k16 step is 16
// rows down, stride byte offset 8 rows; the product's N is the box's width,
// so there is no next box.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached at
                   // run time through cudaGetDriverEntryPoint (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace hopper {

constexpr int kBoxCols = 64;  // bf16 columns per TMA box (128 bytes)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of a 4-D tensor map at coordinates (c0 innermost .. c3) into
// shared memory at `dst`; its bytes complete on the mbarrier `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand at `addr`
// (its swizzle atoms, 8 rows of 128 bytes, 1024-byte aligned): `lbo` and
// `sbo` are the leading and stride byte offsets.
// The same for an operand swizzled in rows of kSwizzle bytes (32, 64 or
// 128; atoms of 8 rows aligned to 8 kSwizzle bytes): wgmma's layout type is
// 1 for 128 bytes, 2 for 64 and 3 for 32.
template <int kSwizzle>
__device__ __forceinline__ uint64_t swizzled_desc(uint32_t addr, uint32_t lbo,
                                                  uint32_t sbo) {
  static_assert(kSwizzle == 32 || kSwizzle == 64 || kSwizzle == 128,
                "swizzles of 32, 64 or 128 bytes");
  constexpr uint64_t kLayout = kSwizzle == 128 ? 1 : kSwizzle == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | kLayout << 62;
}

__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return swizzled_desc<128>(addr, lbo, sbo);
}

// The bf16 columns of a box of a head of d: 64 (128-byte rows; the last
// box zero-filled past d), or at a narrow head one box as wide as the head,
// 32 columns at 17 to 32 (zero-filled past 24) and 16 at 16.
__host__ __device__ constexpr int box_cols(int d) {
  return d > 32 ? kBoxCols : d > 16 ? 32 : 16;
}

// The columns of the last box of a head of d wider than a box but not a
// multiple of one (32 at phi-3-vision's 96: 64-byte rows, 64-byte swizzle),
// so that no box is zero-filled past the head; 0 where every box is full.
__host__ __device__ constexpr int tail_cols(int d) {
  return d > kBoxCols ? d % kBoxCols : 0;
}

// Descriptors of k16 step kk of a tile at `t` whose rows are kRow bytes
// (32 or 64: a narrow head's box, swizzled as wide as its rows): K-major,
// 32 bytes a step along the row; MN-major, 16 rows a step.
template <int kRow>
__device__ __forceinline__ uint64_t narrow_kmajor(uint32_t t, int kk) {
  return swizzled_desc<kRow>(t + 32 * kk, 16, 8 * kRow);
}

template <int kRow>
__device__ __forceinline__ uint64_t narrow_mnmajor(uint32_t t, int kk) {
  return swizzled_desc<kRow>(t + 16 * kRow * kk, 16 * kRow, 8 * kRow);
}

// `desc` through an empty asm: the compiler can neither fold nor hoist it,
// so descriptors derived from it by adding a step's offset are computed
// where they are used instead of all held live across a loop (the address
// field is the low 14 bits of address / 16, which no tile's offset
// carries out of).
__device__ __forceinline__ uint64_t opaque(uint64_t desc) {
  asm volatile("" : "+l"(desc));
  return desc;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Waits until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence, commit and wait.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 128, fp32) = A (64 x 16, shared) * B (16 x 128, shared, K-major):
// the first k16 step, which writes d without reading it.
__device__ __forceinline__ void wgmma_m64n128k16_ss_first(float (&d)[64],
                                                          uint64_t a,
                                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(a), "l"(b), "r"(0));
}

// d (64 x 128, fp32) += A (64 x 16, shared) * B (16 x 128, shared, K-major).
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t a,
                                                    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16, bf16 registers a0..a3) * B (16 x 128,
// shared, MN-major: the transpose bit set).
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], uint32_t a0,
                                                   uint32_t a1, uint32_t a2,
                                                   uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b),
        "r"(1));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 registers a0..a3) * B (16 x 64,
// shared, MN-major: the transpose bit set).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], uint32_t a0,
                                                   uint32_t a1, uint32_t a2,
                                                   uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b),
        "r"(1));
}

// d (64 x 16, fp32) += A (64 x 16, bf16 registers a0..a3) * B (16 x 16,
// shared, MN-major: the transpose bit set).
__device__ __forceinline__ void wgmma_m64n16k16_rs(float (&d)[8], uint32_t a0,
                                                  uint32_t a1, uint32_t a2,
                                                  uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b),
        "r"(1));
}

// d (64 x 32, fp32) += A (64 x 16, bf16 registers a0..a3) * B (16 x 32,
// shared, MN-major: the transpose bit set).
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], uint32_t a0,
                                                  uint32_t a1, uint32_t a2,
                                                  uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b),
        "r"(1));
}


// d (64 x N) += A (64 x 16, bf16 registers) * B (16 x N, shared, MN-major)
// for a narrow head's N of 16 or 32.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b) {
  static_assert(N == 16 || N == 32, "n16 or n32");
  if constexpr (N == 16) {
    wgmma_m64n16k16_rs(d, a0, a1, a2, a3, b);
  } else {
    wgmma_m64n32k16_rs(d, a0, a1, a2, a3, b);
  }
}

// 2**x on the special-function unit (flushes subnormal results to 0;
// 2**-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A width rounded up to a multiple of 32: the fp32 flash kernels' thread
// columns 4c + 32u cover it (heads of 16 and 24 padded with zeros).
__host__ __device__ constexpr int pad32(int w) { return (w + 31) / 32 * 32; }

// How the flash kernels turn a score s = q.k into exp2 units: s D**-0.5
// log2(e) (`scale_log2`), or under a logit softcap c (`cap_log2` = c log2(e)
// > 0; 0 for none) c tanh(s D**-0.5 / c) log2(e) (`cap_scale` = D**-0.5 /
// c), as the reference caps its scores before the mask.
struct Scaling {
  float scale_log2, cap_log2, cap_scale;
};

// The Scaling of head dim d under `softcap` (<= 0 for none), from D**-0.5
// in double as the reference computes it.
inline Scaling make_scaling(int d, float softcap) {
  const double scale = pow(static_cast<double>(d), -0.5);
  const double log2e = 1.4426950408889634;
  if (softcap <= 0.f) return {static_cast<float>(scale * log2e), 0.f, 0.f};
  return {static_cast<float>(scale * log2e),
          static_cast<float>(softcap * log2e),
          static_cast<float>(scale / softcap)};
}

// A compile-time flag that a generic lambda can branch on (if constexpr):
// the kernels run a tile's softmax with or without the cap behind one
// uniform branch.
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// The exp2 argument of score s less l2 under sc, capped (kCap) or not; with
// the cap `t` receives tanh(s D**-0.5 / c).
template <bool kCap>
__device__ __forceinline__ float score_arg(float s, float l2, Scaling sc,
                                           float& t) {
  if constexpr (kCap) {
    t = tanhf(s * sc.cap_scale);
    return fmaf(sc.cap_log2, t, -l2);
  } else {
    return fmaf(s, sc.scale_log2, -l2);
  }
}

// The cap's derivative d(c tanh(x / c)) / dx = (1 - t)(1 + t), t = tanh(x /
// c), as autodiff of the reference's tanh gives it.
__device__ __forceinline__ float cap_grad(float t) {
  return (1.f - t) * (1.f + t);
}

// `bytes` (a multiple of 16) from global `src` (16-byte aligned) into
// shared memory at `dst`; they complete on the mbarrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Waits at named barrier `id` (1..15) for `count` threads (a multiple of 32).
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// Makes this thread's shared-memory stores before it visible to the async
// proxy (a wgmma that reads them as an operand after a barrier).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// This block's rank in its cluster, and the cluster's size in blocks (1
// and 1 when the kernel was launched without clusters).
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return n;
}

// Waits until every thread of every block of the cluster has arrived; this
// block's shared-memory writes before it are visible to the cluster's
// reads after it. Threads of a warp may arrive apart (not .aligned).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;" ::: "memory");
}

// Stores two floats at shared address `addr` (8-byte aligned) of the
// cluster's block `rank`; a cluster_sync after it makes them visible there.
__device__ __forceinline__ void st_cluster_f2(uint32_t addr, uint32_t rank,
                                              float2 v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};" ::"r"(remote),
               "f"(v.x), "f"(v.y)
               : "memory");
}

// d (64 x 64, fp32) = A (64 x 16, shared, K-major) * B (16 x 64, shared,
// K-major): the first k16 step, which writes d without reading it.
__device__ __forceinline__ void wgmma_m64n64k16_ss_first(float (&d)[32],
                                                         uint64_t a,
                                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(a), "l"(b), "r"(0));
}

// d (64 x 64, fp32) += A (64 x 16, shared, K-major) * B (16 x 64, shared,
// K-major).
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a,
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16, shared, K-major) * B (16 x 128, shared,
// MN-major: the transpose bit set).
__device__ __forceinline__ void wgmma_m64n128k16_ss_mn(float (&d)[64],
                                                       uint64_t a,
                                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 64, fp32) += A (64 x 16, shared, K-major) * B (16 x 64, shared,
// MN-major: the transpose bit set).
__device__ __forceinline__ void wgmma_m64n64k16_ss_mn(float (&d)[32],
                                                      uint64_t a,
                                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver, looked up once.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map over a bf16 (batch, seq, heads, D) tensor as 4-D (D, heads,
// seq, batch), with the tensor's strides in elements (the innermost 1, the
// others multiples of 8), boxes of `box_cols` columns x 1 head x `box_rows`
// rows, swizzled as `swizzle` says (64 columns take 128 bytes, a narrow
// head's 32 or 16 columns 64 or 32), zeros outside.
inline bool encode_4d(CUtensorMap* map, const void* ptr, int batch, int seq,
                      int heads, int d, long long s_head, long long s_seq,
                      long long s_batch, int box_rows,
                      int box_cols = kBoxCols,
                      CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_head) * 2,
                                 static_cast<cuuint64_t>(s_seq) * 2,
                                 static_cast<cuuint64_t>(s_batch) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols), 1,
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The swizzle of a box of `cols` bf16 columns (16, 32 or 64: rows of 32, 64
// or 128 bytes).
inline CUtensorMapSwizzle swizzle_of(int cols) {
  return cols == 16   ? CU_TENSOR_MAP_SWIZZLE_32B
         : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                      : CU_TENSOR_MAP_SWIZZLE_128B;
}

// Sets `kernel`'s dynamic shared-memory limit to `bytes` the first time a
// launch asks for it on the current device, so that later launches make no
// runtime call for it (each kernel always asks for the same bytes).
inline cudaError_t smem_limit(const void* kernel, size_t bytes) {
  constexpr int kMaxEntries = 512;
  static std::mutex mu;
  static const void* kernels[kMaxEntries];
  static int devices[kMaxEntries];
  static int n = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n; ++i) {
    if (kernels[i] == kernel && devices[i] == dev) return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && n < kMaxEntries) {
    kernels[n] = kernel;
    devices[n] = dev;
    ++n;
  }
  return err;
}

}  // namespace hopper

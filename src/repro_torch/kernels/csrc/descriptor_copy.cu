// Descriptor-driven row copy for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/descriptor_copy.py::descriptor_copy
// (body _copy_kernel; also reached through descriptor_copy_bucketed):
//   dst[dst_idx[i]] = src[src_idx[i]] for each descriptor i; a -1 on either
//   side writes nothing.
//
// Bound: bytes. The kernel reads each active source row once and writes each
// destination row once: 2 * n_active * row_bytes over the card's memory rate,
// with no arithmetic to speak of.
//
// Descriptors. The TPU kernel takes its index streams as scalar-prefetch
// operands; here they ride in the launch too, as a by-value table of int32
// (src, dst) pairs (desc_table.cuh): descriptor_copy_launch reads the
// caller's host int64 streams once, checks every active index against the
// row counts (and launches nothing when one is out of range), drops the -1
// entries, packs the rest, picks the smallest table that holds them (128,
// 512 or 4,088 pairs) and launches. More than 4,088 active descriptors are
// cut into consecutive launches on one stream. No index buffer exists on the
// device, and nothing synchronises.
//
// Last write wins. Blocks run in no order, unlike the TPU's sequential grid,
// so each block stages the destination column in shared memory and a warp
// skips descriptor i when a later descriptor of the launch writes the same
// row: the TPU grid's order, decided on the card. (Across launches, stream
// order does it.) Aliasing is left to the wrapper: when src and dst share
// storage and an active source row is also an active destination row, it
// copies the source rows to scratch first (one more call of this function).
//
// Work split by row width; rows are raw bytes, so any dtype is taken.
// * Wide rows (>= 4 KiB, 16-byte aligned in size and both bases, e.g. the
//   runtime path's 64 KiB K/V pages and the sharded hops' 4 KiB rows): the
//   copy engine. The (descriptor, 16 KiB chunk) items are split evenly over
//   one block per SM; one elected thread per block moves its items through
//   a ring of 8 shared-memory stages with cp.async.bulk: global -> shared
//   completes on the stage's mbarrier by transaction count, shared -> global
//   is a bulk group, and a stage is refilled once its store has read it. Up
//   to 128 KiB per SM in flight and no register spent on the payload. The
//   first loads go out before the block's duplicate check, which they hide;
//   a row that a later descriptor overwrites is read and not stored.
// * Narrower rows (the sweep's 32-256 B rows, the sharded cells' 256 B
//   pages): one warp per descriptor, 8 per block, 16-byte vectors when the
//   row width and both bases are 16-byte aligned, 4-byte words when they are
//   4-byte aligned, single bytes otherwise.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "desc_table.cuh"

using desc_table::DescTable;

namespace {

constexpr int kWarps = 8;                 // narrow path: descriptors / block
constexpr int kChunk = 16384;             // wide path: bytes per item
constexpr int kStages = 8;                // wide path: ring depth
constexpr int kBulkThreads = 128;
// Descriptors one wide block touches: at most n / blocks + 2.
constexpr int kMaxOwned = 64;
constexpr long long kBulkMinRow = 4096;

// ---------------------------------------------------------------------------
// Narrow rows: one warp per descriptor
// ---------------------------------------------------------------------------

template <int CAP, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
rows_kernel(const __grid_constant__ DescTable<CAP> t) {
  __shared__ __align__(16) int col[CAP];
  const int first = blockIdx.x * kWarps;
  desc_table::stage_column(t.dst_idx, first, t.n, col);
  const int i = first + static_cast<int>(threadIdx.x) / 32;
  if (i >= t.n) return;  // uniform across the warp
  const int row = col[i];
  if (desc_table::written_later(col, t.n, i, row)) return;
  using V = typename std::conditional<
      VEC == 16, uint4,
      typename std::conditional<VEC == 4, uint32_t, unsigned char>::type>::type;
  const V* s = reinterpret_cast<const V*>(
      t.src + static_cast<long long>(t.src_idx[i]) * t.row_bytes);
  V* d = reinterpret_cast<V*>(t.dst + static_cast<long long>(row) * t.row_bytes);
  const long long nv = t.row_bytes / VEC;
#pragma unroll 4
  for (long long k = threadIdx.x & 31; k < nv; k += 32) d[k] = s[k];
}

// ---------------------------------------------------------------------------
// Wide rows: cp.async.bulk through a ring of shared-memory stages
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(void* stage, const void* g,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(stage)),
      "l"(g), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* g, const void* stage,
                                           uint32_t bytes) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::
                   "l"(g),
               "r"(smem_addr(stage)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__device__ __forceinline__ void barrier_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Dynamic shared memory: [ring][bars][keep flags][destination column].
constexpr int kRingBytes = kStages * kChunk;
constexpr int kHeadBytes = kRingBytes + kStages * 8 + kMaxOwned * 4;

template <int CAP>
__global__ void __launch_bounds__(kBulkThreads)
bulk_kernel(const __grid_constant__ DescTable<CAP> t) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kRingBytes);
  int* keep = reinterpret_cast<int*>(bars + kStages);
  int* col = keep + kMaxOwned;
  const long long rb = t.row_bytes;
  const long long cpr = (rb + kChunk - 1) / kChunk;   // chunks per row
  const long long total = static_cast<long long>(t.n) * cpr;
  // An even split of the items: blocks differ by at most one item.
  const long long a = total * blockIdx.x / gridDim.x;
  const long long b = total * (blockIdx.x + 1) / gridDim.x;
  const int d0 = static_cast<int>(a / cpr);
  const int d1 = static_cast<int>((b - 1) / cpr);     // d1 - d0 < kMaxOwned

  // Item q (0, 1, ... from a) sits in stage q % kStages, whose barrier
  // completes phase (q / kStages) & 1.
  auto load = [&](long long k) {
    const long long d = k / cpr, off = (k % cpr) * kChunk;
    const int stage = static_cast<int>((k - a) % kStages);
    bulk_load(ring + stage * kChunk,
              t.src + static_cast<long long>(t.src_idx[d]) * rb + off,
              static_cast<uint32_t>(rb - off < kChunk ? rb - off : kChunk),
              &bars[stage]);
  };
  long long lk = a;   // the next item to load
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
          smem_addr(&bars[s])));
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    // The first loads go out before the duplicate check: a row that a
    // later descriptor overwrites is read and then not stored.
    for (; lk < b && lk < a + kStages; ++lk) load(lk);
  }
  desc_table::stage_column(t.dst_idx, d0, t.n, col);
  for (int d = d0 + static_cast<int>(threadIdx.x) / 32; d <= d1;
       d += kBulkThreads / 32) {
    const bool later = desc_table::written_later(col, t.n, d, col[d]);
    if ((threadIdx.x & 31) == 0) keep[d - d0] = !later;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

  for (long long sk = a; sk < b; ++sk) {
    const int stage = static_cast<int>((sk - a) % kStages);
    barrier_wait(&bars[stage],
                 static_cast<uint32_t>(((sk - a) / kStages) & 1));
    const long long d = sk / cpr, off = (sk % cpr) * kChunk;
    const bool stored = keep[d - d0];
    if (stored) {
      bulk_store(t.dst + static_cast<long long>(col[d]) * rb + off,
                 ring + stage * kChunk,
                 static_cast<uint32_t>(rb - off < kChunk ? rb - off : kChunk));
    }
    // Item lk reuses the stage of item lk - kStages <= sk - 1, whose store
    // has read it once every store but item sk's has (wait_group.read 1),
    // or every store, when item sk stored nothing.
    if (lk < b && lk <= sk - 1 + kStages) {
      if (stored) {
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      } else {
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      }
      load(lk);
      ++lk;
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <int CAP>
cudaError_t launch_table(DescTable<CAP>& t, int path, cudaStream_t stream) {
  const int n = t.n;
  if (path == 0) {
    // One block per SM: the split is even across the card.
    static int sms[64] = {0};  // per device
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64) return cudaErrorInvalidDevice;
    const int smem = kHeadBytes + CAP * 4;
    if (sms[dev] == 0) {
      int count = 0;
      err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                   dev);
      if (err != cudaSuccess) return err;
      err = cudaFuncSetAttribute(bulk_kernel<CAP>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return err;
      sms[dev] = count;
    }
    const long long total = n * ((t.row_bytes + kChunk - 1) / kChunk);
    // Enough blocks that none touches more than kMaxOwned descriptors.
    long long grid = (n + kMaxOwned - 3) / (kMaxOwned - 2);
    if (grid < sms[dev]) grid = sms[dev];
    if (grid > total) grid = total;
    bulk_kernel<CAP><<<static_cast<int>(grid), kBulkThreads, smem, stream>>>(
        t);
  } else {
    const int grid = (n + kWarps - 1) / kWarps;
    if (path == 16) {
      rows_kernel<CAP, 16><<<grid, kWarps * 32, 0, stream>>>(t);
    } else if (path == 4) {
      rows_kernel<CAP, 4><<<grid, kWarps * 32, 0, stream>>>(t);
    } else {
      rows_kernel<CAP, 1><<<grid, kWarps * 32, 0, stream>>>(t);
    }
  }
  return cudaGetLastError();
}

}  // namespace

// src, dst: row pools of src_rows / dst_rows rows of row_bytes bytes.
// src_idx, dst_idx: host int64 arrays of n entries (-1 skips). Launches on
// `stream`. Returns the number of launches made (0 when no descriptor is
// active), desc_table::kOutOfRange without launching when an active index
// is out of range, or -1 - the CUDA error of a launch.
extern "C" int descriptor_copy_launch(const void* src, void* dst,
                                      long long src_rows, long long dst_rows,
                                      const long long* src_idx,
                                      const long long* dst_idx, long long n,
                                      long long row_bytes, void* stream) {
  if (n <= 0 || row_bytes <= 0) return 0;
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t b = reinterpret_cast<uintptr_t>(dst);
  int path = 1;
  if (row_bytes % 16 == 0 && a % 16 == 0 && b % 16 == 0) {
    path = row_bytes >= kBulkMinRow ? 0 : 16;
  } else if (row_bytes % 4 == 0 && a % 4 == 0 && b % 4 == 0) {
    path = 4;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return desc_table::launch_tables(
      src, dst, src_rows, dst_rows, src_idx, dst_idx, n, row_bytes, false,
      [&](auto& t) { return launch_table(t, path, st); });
}

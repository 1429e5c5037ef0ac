// The §II-C speculative descriptor prefetch pipeline for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/prefetch_pipeline.py::
// prefetched_chain_copy (body _pipeline_kernel): the row copy
//   dst[dst_idx[i]] = src[src_idx[i]]
// walked in chain order through a ring of `depth` bounce buffers, where the
// fetch for descriptor i+depth is issued as soon as descriptor i's buffer has
// been written out. A negative index reads or writes row 0, as in the TPU
// kernel.
//
// Bound: bytes. Each active source row is read once and each destination row
// written once, 2 * n_active * row_bytes over the card's memory rate.
//
// Descriptors ride in the launch, as the TPU kernel's scalar-prefetch
// operands do: prefetch_pipeline_launch reads the caller's host int64
// streams once, clamps negative indices to row 0, checks every index against
// the row counts (and launches nothing when one is out of range), packs the
// pairs to int32 into a by-value table (desc_table.cuh; 128, 512 or 4,088
// pairs) and launches. A longer chain is cut into consecutive launches on one
// stream, so no index buffer exists on the device and nothing synchronises.
//
// Design. A 64 KiB row times a ring of 4 does not fit in the 227 KB of shared
// memory a block may use, so a ring stage holds a column chunk of a row: one
// 16-byte vector (4-byte word, byte) per thread, blockDim.x threads. The grid
// is (column chunks, lanes): each lane is one engine that walks its own
// contiguous segment of the chain in order, with its own ring of `depth`
// stages in shared memory. The fetch into a stage is a cp.async (16 or 4
// bytes) whose completion arrives on the stage's mbarrier
// (cp.async.mbarrier.arrive.noinc), so a thread waits on the barrier's phase
// parity for the k-th use of a stage (parity k & 1), writes the chunk out,
// and issues the next fetch into the same stage. One lane would keep only
// depth * row_bytes in flight on the whole card; several lanes keep enough
// bytes in flight to approach the memory rate while each lane still runs the
// paper's mechanism. Rows whose width or base is not 4-byte aligned take the
// byte path, where the "fetch" is an ordinary load and store into the stage.
//
// Last write wins on the card: while its first fetches are in flight, each
// block stages the destination column in shared memory and marks which of
// its lane's descriptors a later descriptor of the launch overwrites; those
// pass through the ring without a write. So lanes never write the same row,
// and their order does not matter. They never read a row another lane writes
// either: when src aliases dst, the wrapper
// (repro_torch/kernels/prefetch_pipeline.py) copies the source rows to
// scratch first, with one more call of this function.
#include <cuda_runtime.h>
#include <stdint.h>

#include "desc_table.cuh"

using desc_table::DescTable;

namespace {

constexpr int kMaxThreads = 256;
constexpr long long kTargetBlocks = 132LL * 4;
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block may use

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count));
}

// Arrives on `bar` once every cp.async this thread issued so far has landed.
__device__ __forceinline__ void arrive_after_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
      smem_addr(bar)));
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

template <int VEC>
__device__ __forceinline__ void fetch(unsigned char* stage, const char* g) {
  if constexpr (VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     smem_addr(stage)),
                 "l"(g)
                 : "memory");
  } else if constexpr (VEC == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                     smem_addr(stage)),
                 "l"(g)
                 : "memory");
  } else {
    *stage = *reinterpret_cast<const unsigned char*>(g);
  }
}

template <int VEC>
__device__ __forceinline__ void drain(const unsigned char* stage, char* g) {
  if constexpr (VEC == 16) {
    *reinterpret_cast<uint4*>(g) = *reinterpret_cast<const uint4*>(stage);
  } else if constexpr (VEC == 4) {
    *reinterpret_cast<uint32_t*>(g) = *reinterpret_cast<const uint32_t*>(stage);
  } else {
    *reinterpret_cast<unsigned char*>(g) = *stage;
  }
}

// Dynamic shared memory: [stages mbarriers, padded to 16 bytes]
// [destination column, n rounded up to 4 ints][keep flags, one byte per
// descriptor of the lane, padded to 16 bytes][stages x blockDim.x x VEC ring].
__host__ __device__ constexpr long long round16(long long x) {
  return (x + 15) / 16 * 16;
}

template <int CAP, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
prefetch_pipeline_kernel(const __grid_constant__ DescTable<CAP> t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = t.n;
  const int stages = t.arg[0];
  const int per_lane = t.arg[1];
  const long long row_bytes = t.row_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  int* col = reinterpret_cast<int*>(smem + round16(stages * 8));
  unsigned char* keep = reinterpret_cast<unsigned char*>(col) + (n + 3) / 4 * 16;
  unsigned char* ring = keep + round16(per_lane);
  const long long stage_bytes = static_cast<long long>(blockDim.x) * VEC;
  unsigned char* mine = ring + threadIdx.x * VEC;  // + stage * stage_bytes
  const long long col_off = blockIdx.x * stage_bytes + threadIdx.x * VEC;
  const bool in_row = col_off < row_bytes;
  const int begin = blockIdx.y * per_lane;
  const int count = n - begin < per_lane ? n - begin : per_lane;  // > 0

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) barrier_init(&bars[s], blockDim.x);
  }
  __syncthreads();

  // Issue the fetch of the lane's k-th descriptor into stage k % stages.
  auto issue = [&](int k) {
    const int stage = k % stages;
    if (in_row) {
      fetch<VEC>(mine + stage * stage_bytes,
                 t.src + static_cast<long long>(t.src_idx[begin + k]) *
                             row_bytes + col_off);
    }
    arrive_after_copies(&bars[stage]);
  };

  // Warm-up: the first `stages` speculative fetches back to back, issued
  // before the duplicate check, which they hide (a row that a later
  // descriptor overwrites is fetched and not written).
  for (int k = 0; k < stages && k < count; ++k) issue(k);
  desc_table::stage_column(t.dst_idx, begin, n, col);
  for (int k = static_cast<int>(threadIdx.x) / 32; k < count;
       k += blockDim.x / 32) {
    const bool later =
        desc_table::written_later(col, n, begin + k, col[begin + k]);
    if ((threadIdx.x & 31) == 0) keep[k] = !later;
  }
  __syncthreads();

  for (int k = 0; k < count; ++k) {
    const int stage = k % stages;
    barrier_wait(&bars[stage], static_cast<uint32_t>((k / stages) & 1));
    if (in_row && keep[k]) {
      drain<VEC>(mine + stage * stage_bytes,
                 t.dst + static_cast<long long>(col[begin + k]) * row_bytes +
                     col_off);
    }
    // The stage is drained (this thread's bytes of it are the only ones it
    // reads or refills): refill it with the descriptor `stages` ahead.
    if (k + stages < count) issue(k + stages);
  }
}

template <int CAP, int VEC>
cudaError_t launch_vec(DescTable<CAP>& t, int depth, cudaStream_t stream) {
  const long long n = t.n;
  const long long row_bytes = t.row_bytes;
  const long long vecs = (row_bytes + VEC - 1) / VEC;
  long long threads = ((vecs + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const long long chunks = (vecs + threads - 1) / threads;
  long long lanes = (kTargetBlocks + chunks - 1) / chunks;
  const long long max_lanes = (n + depth - 1) / depth;
  if (lanes > max_lanes) lanes = max_lanes;
  if (lanes < 1) lanes = 1;
  if (lanes > 65535) lanes = 65535;
  const long long per_lane = (n + lanes - 1) / lanes;
  lanes = (n + per_lane - 1) / per_lane;  // every lane has work
  const int stages = static_cast<int>(depth < per_lane ? depth : per_lane);
  const long long head =
      round16(stages * 8LL) + (n + 3) / 4 * 16 + round16(per_lane);
  while (threads > 32 && head + stages * threads * VEC > kMaxSmem) {
    threads -= 32;
  }
  const long long smem = head + stages * threads * VEC;
  const long long grid_x = (vecs + threads - 1) / threads;
  if (smem > kMaxSmem || grid_x > 2147483647LL) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        prefetch_pipeline_kernel<CAP, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  t.arg[0] = stages;
  t.arg[1] = static_cast<int>(per_lane);
  dim3 grid(static_cast<unsigned>(grid_x), static_cast<unsigned>(lanes));
  prefetch_pipeline_kernel<CAP, VEC>
      <<<grid, static_cast<unsigned>(threads), static_cast<size_t>(smem),
         stream>>>(t);
  return cudaGetLastError();
}

// Launches table t with the widest vector the row width and both bases
// allow.
template <int CAP>
cudaError_t launch_table(DescTable<CAP>& t, int depth, int vec,
                         cudaStream_t stream) {
  if (vec == 16) return launch_vec<CAP, 16>(t, depth, stream);
  if (vec == 4) return launch_vec<CAP, 4>(t, depth, stream);
  return launch_vec<CAP, 1>(t, depth, stream);
}

}  // namespace

// src, dst: row pools of src_rows / dst_rows rows of row_bytes bytes.
// src_idx, dst_idx: host int64 arrays of n entries (negative: row 0).
// depth >= 1: the ring's stages. Launches on `stream`. Returns the number of
// launches made (0 when n is 0), desc_table::kOutOfRange without launching
// when an index is out of range, or -1 - the CUDA error of a launch
// (cudaErrorInvalidValue when the ring cannot fit in shared memory).
extern "C" int prefetch_pipeline_launch(const void* src, void* dst,
                                        long long src_rows,
                                        long long dst_rows,
                                        const long long* src_idx,
                                        const long long* dst_idx, long long n,
                                        long long row_bytes, int depth,
                                        void* stream) {
  if (n <= 0 || row_bytes <= 0) return 0;
  if (depth < 1) return desc_table::result(0, cudaErrorInvalidValue);
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t b = reinterpret_cast<uintptr_t>(dst);
  int vec = 1;
  if (row_bytes % 16 == 0 && a % 16 == 0 && b % 16 == 0) {
    vec = 16;
  } else if (row_bytes % 4 == 0 && a % 4 == 0 && b % 4 == 0) {
    vec = 4;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return desc_table::launch_tables(
      src, dst, src_rows, dst_rows, src_idx, dst_idx, n, row_bytes, true,
      [&](auto& t) { return launch_table(t, depth, vec, st); });
}

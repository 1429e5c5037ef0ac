// The §II-C speculative descriptor prefetch pipeline for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/prefetch_pipeline.py::
// prefetched_chain_copy (body _pipeline_kernel): the row copy
//   dst[dst_idx[i]] = src[src_idx[i]]
// walked in chain order through a ring of `depth` bounce buffers, where the
// fetch for descriptor i+depth is issued as soon as descriptor i's buffer has
// been written out. Here a -1 index means "skip": the wrapper
// (repro_torch/kernels/prefetch_pipeline.py) has already clamped the chain's
// negative indices to row 0, as the TPU kernel does, and turned every
// descriptor but the last one per destination row into a skip.
//
// Bound: bytes. Each active source row is read once and each destination row
// written once, 2 * n_active * row_bytes over the card's memory rate.
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
// paper's mechanism. Lanes never write the same row (the wrapper keeps one
// descriptor per destination row) and never read a row another lane writes
// (the wrapper snapshots an aliased source first), so their order does not
// matter. Rows whose width or base is not 4-byte aligned take the byte path,
// where the "fetch" is an ordinary load and store into the stage.
#include <cuda_runtime.h>
#include <stdint.h>

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

template <int VEC>
__global__ void __launch_bounds__(kMaxThreads)
prefetch_pipeline_kernel(const char* __restrict__ src, char* __restrict__ dst,
                         const int* __restrict__ src_idx,
                         const int* __restrict__ dst_idx, long long n,
                         long long row_bytes, int stages, long long per_lane) {
  extern __shared__ __align__(16) unsigned char smem[];
  // [stages mbarriers, padded to 16 bytes][stages x blockDim.x x VEC ring]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + ((stages * 8 + 15) / 16) * 16;
  const long long stage_bytes = static_cast<long long>(blockDim.x) * VEC;
  unsigned char* mine = ring + threadIdx.x * VEC;  // + stage * stage_bytes
  const long long col = blockIdx.x * stage_bytes + threadIdx.x * VEC;
  const bool in_row = col < row_bytes;
  const long long begin = blockIdx.y * per_lane;
  const long long count =
      (n - begin < per_lane ? n - begin : per_lane);  // > 0 by the grid

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) barrier_init(&bars[s], blockDim.x);
  }
  __syncthreads();

  // Issue the fetch of the lane's k-th descriptor into stage k % stages.
  auto issue = [&](long long k) {
    const long long i = begin + k;
    const int s = src_idx[i];
    const int t = dst_idx[i];
    const int stage = static_cast<int>(k % stages);
    if (in_row && s >= 0 && t >= 0) {
      fetch<VEC>(mine + stage * stage_bytes,
                 src + static_cast<long long>(s) * row_bytes + col);
    }
    arrive_after_copies(&bars[stage]);
  };

  // Warm-up: the first `stages` speculative fetches back to back.
  for (long long k = 0; k < stages && k < count; ++k) issue(k);

  for (long long k = 0; k < count; ++k) {
    const long long i = begin + k;
    const int stage = static_cast<int>(k % stages);
    barrier_wait(&bars[stage], static_cast<uint32_t>((k / stages) & 1));
    const int s = src_idx[i];
    const int t = dst_idx[i];
    if (in_row && s >= 0 && t >= 0) {
      drain<VEC>(mine + stage * stage_bytes,
                 dst + static_cast<long long>(t) * row_bytes + col);
    }
    // The stage is drained (this thread's bytes of it are the only ones it
    // reads or refills): refill it with the descriptor `stages` ahead.
    if (k + stages < count) issue(k + stages);
  }
}

template <int VEC>
int launch_vec(const void* src, void* dst, const void* src_idx,
               const void* dst_idx, long long n, long long row_bytes,
               int depth, cudaStream_t stream) {
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
  const long long head = ((stages * 8LL + 15) / 16) * 16;
  while (threads > 32 && head + stages * threads * VEC > kMaxSmem) {
    threads -= 32;
  }
  const long long smem = head + stages * threads * VEC;
  const long long grid_x = (vecs + threads - 1) / threads;
  if (smem > kMaxSmem || grid_x > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        prefetch_pipeline_kernel<VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(static_cast<unsigned>(grid_x), static_cast<unsigned>(lanes));
  prefetch_pipeline_kernel<VEC><<<grid, static_cast<unsigned>(threads), static_cast<size_t>(smem),
           stream>>>(static_cast<const char*>(src), static_cast<char*>(dst),
                     static_cast<const int*>(src_idx),
                     static_cast<const int*>(dst_idx), n, row_bytes, stages,
                     per_lane);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src, dst: row pools of row_bytes bytes per row. src_idx, dst_idx: int32
// device arrays of n entries (-1 skips). depth >= 1: the ring's stages.
// Launches on `stream`; returns cudaGetLastError (or cudaErrorInvalidValue
// when the ring cannot fit in shared memory).
extern "C" int prefetch_pipeline_launch(const void* src, void* dst,
                                        const void* src_idx,
                                        const void* dst_idx, long long n,
                                        long long row_bytes, int depth,
                                        void* stream) {
  if (n <= 0 || row_bytes <= 0) return 0;
  if (depth < 1) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t b = reinterpret_cast<uintptr_t>(dst);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row_bytes % 16 == 0 && a % 16 == 0 && b % 16 == 0) {
    return launch_vec<16>(src, dst, src_idx, dst_idx, n, row_bytes, depth, s);
  }
  if (row_bytes % 4 == 0 && a % 4 == 0 && b % 4 == 0) {
    return launch_vec<4>(src, dst, src_idx, dst_idx, n, row_bytes, depth, s);
  }
  return launch_vec<1>(src, dst, src_idx, dst_idx, n, row_bytes, depth, s);
}

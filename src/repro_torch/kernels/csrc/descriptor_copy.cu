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
// Design: one block per descriptor, through a grid-stride loop over
// descriptors. A block reads its own pair of indices (the TPU's scalar
// prefetch has no counterpart to keep) and skips the row when either is
// negative, so bucket padding costs one index read. The row is moved as raw
// bytes, so the kernel takes any dtype as the TPU kernel does: 16-byte vector
// loads and stores when the row width and both base pointers are 16-byte
// aligned, 4-byte words when they are 4-byte aligned, single bytes
// otherwise. Each thread keeps several 16-byte loads in flight.
//
// Blocks run in no order, unlike the TPU's sequential grid. The wrapper
// (repro_torch/kernels/descriptor_copy.py) therefore resolves duplicate
// destinations on the host (the last occurrence wins, as in the TPU grid)
// and snapshots source rows that another descriptor of the same launch
// overwrites, before it calls this kernel.
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

__global__ void __launch_bounds__(kThreads)
descriptor_copy_kernel(const char* __restrict__ src, char* __restrict__ dst,
                       const int* __restrict__ src_idx,
                       const int* __restrict__ dst_idx, long long n,
                       long long row_bytes, int vec) {
  for (long long i = blockIdx.x; i < n; i += gridDim.x) {
    const int s = src_idx[i];
    const int t = dst_idx[i];
    if (s < 0 || t < 0) continue;  // uniform across the block
    const char* sp = src + static_cast<size_t>(s) * row_bytes;
    char* dp = dst + static_cast<size_t>(t) * row_bytes;
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

}  // namespace

// src, dst: row pools of row_bytes bytes per row. src_idx, dst_idx: int32
// device arrays of n entries. Launches on `stream`; returns cudaGetLastError.
extern "C" int descriptor_copy_launch(const void* src, void* dst,
                                      const void* src_idx,
                                      const void* dst_idx, long long n,
                                      long long row_bytes, void* stream) {
  if (n <= 0 || row_bytes <= 0) return 0;
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t b = reinterpret_cast<uintptr_t>(dst);
  int vec = 1;
  if (row_bytes % 16 == 0 && a % 16 == 0 && b % 16 == 0) {
    vec = 16;
  } else if (row_bytes % 4 == 0 && a % 4 == 0 && b % 4 == 0) {
    vec = 4;
  }
  const int grid = static_cast<int>(n < kMaxBlocks ? n : kMaxBlocks);
  descriptor_copy_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(src), static_cast<char*>(dst),
      static_cast<const int*>(src_idx), static_cast<const int*>(dst_idx), n,
      row_bytes, vec);
  return static_cast<int>(cudaGetLastError());
}

// Descriptor tables passed by value in the launch, shared by the copy
// kernels (descriptor_copy.cu, prefetch_pipeline.cu).
//
// The TPU kernels take their index streams as scalar-prefetch operands: the
// descriptors ride in the launch. Here they ride in the kernel's parameter
// block, which may hold 32,764 bytes (CUDA 12.1 and later): a DescTable of
// kMaxCap int32 (src, dst) pairs fits, so a call needs no device buffer, no
// upload and no stream synchronisation. The table is templated on a few
// capacities so that a launch of a few descriptors does not ship 32 KB of
// parameters; a call with more than kMaxCap descriptors is cut on the host
// into consecutive launches of at most kMaxCap each, in chain order on one
// stream, so stream order keeps the last write across launches.
//
// The host side (launch_tables) reads the caller's int64 streams: it checks
// every active index against the pools' row counts before anything is
// launched, drops inactive descriptors (a -1 on either side; the prefetched
// copy clamps to row 0 instead) in chain order and packs the rest to int32.
// The device side applies the last-write rule (stage_column,
// written_later): a descriptor is skipped when a later descriptor of the
// same launch has the same destination row, the order the TPU's sequential
// grid gives.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace desc_table {

constexpr int kSmallCap = 128;   // the sweep's and the sharded hops' drains
constexpr int kMidCap = 512;     // the runtime path's bursts
constexpr int kMaxCap = 4088;    // the most that fits 32,764 bytes
constexpr int kOutOfRange = -1;  // return code: an index out of range

template <int CAP>
struct alignas(16) DescTable {
  const char* src;
  char* dst;
  long long row_bytes;
  int n;        // descriptors in this launch, <= CAP
  int arg[5];   // the kernel's own launch shape
  int src_idx[CAP];
  int dst_idx[CAP];
};
static_assert(sizeof(DescTable<kMaxCap>) <= 32764,
              "a kernel's parameters may take at most 32,764 bytes");
static_assert(kSmallCap % 4 == 0 && kMidCap % 4 == 0 && kMaxCap % 4 == 0,
              "columns are staged with 16-byte loads");

// Descriptor (a, b) after the clamp to row 0 (with `clamp`); whether it is
// active (without `clamp`: both indices >= 0).
inline bool take(long long& a, long long& b, bool clamp) {
  if (!clamp) return a >= 0 && b >= 0;
  a = a < 0 ? 0 : a;
  b = b < 0 ? 0 : b;
  return true;
}

// Checks every active descriptor of (s, d) against the row counts. Returns
// the number of active descriptors, or kOutOfRange.
inline long long check_streams(const long long* s, const long long* d,
                               long long n, long long src_rows,
                               long long dst_rows, bool clamp) {
  long long active = 0;
  for (long long i = 0; i < n; ++i) {
    long long a = s[i], b = d[i];
    if (!take(a, b, clamp)) continue;
    if (a >= src_rows || b >= dst_rows) return kOutOfRange;
    ++active;
  }
  return active;
}

// Packs up to CAP active descriptors from position *pos on into t; moves
// *pos past the last one read.
template <int CAP>
void pack_table(DescTable<CAP>& t, const long long* s, const long long* d,
                long long n, long long* pos, bool clamp) {
  int k = 0;
  long long i = *pos;
  for (; i < n && k < CAP; ++i) {
    long long a = s[i], b = d[i];
    if (!take(a, b, clamp)) continue;
    t.src_idx[k] = static_cast<int>(a);
    t.dst_idx[k] = static_cast<int>(b);
    ++k;
  }
  *pos = i;
  t.n = k;
}

// Return code of a call that made `launches` launches and then saw `err`.
inline int result(int launches, cudaError_t err) {
  return err == cudaSuccess ? launches : -1 - static_cast<int>(err);
}

// A launch function's host pass: checks (s, d), then packs its active
// descriptors in chain order into tables, each the smallest that holds what
// is left of the call (at most kMaxCap), and calls launch(table) for each,
// in order. Returns the launches made, kOutOfRange (nothing launched), or
// the code of the first failed launch.
template <class Launch>
int launch_tables(const void* src, void* dst, long long src_rows,
                  long long dst_rows, const long long* s, const long long* d,
                  long long n, long long row_bytes, bool clamp,
                  Launch&& launch) {
  long long active = check_streams(s, d, n, src_rows, dst_rows, clamp);
  if (active < 0) return kOutOfRange;
  long long pos = 0;
  int launches = 0;
  auto next = [&](auto& t) {
    t.src = static_cast<const char*>(src);
    t.dst = static_cast<char*>(dst);
    t.row_bytes = row_bytes;
    pack_table(t, s, d, n, &pos, clamp);
    active -= t.n;
    return launch(t);
  };
  while (active > 0) {
    cudaError_t err;
    if (active <= kSmallCap) {
      DescTable<kSmallCap> t;
      err = next(t);
    } else if (active <= kMidCap) {
      DescTable<kMidCap> t;
      err = next(t);
    } else {
      DescTable<kMaxCap> t;
      err = next(t);
    }
    if (err != cudaSuccess) return result(launches, err);
    ++launches;
  }
  return launches;
}

// ---------------------------------------------------------------------------
// Device side
// ---------------------------------------------------------------------------

// Copies col[begin & ~3, n) to out[] at the same positions, 16 bytes a
// thread, then syncs the block. `col` may be the launch's parameter block.
__device__ __forceinline__ void stage_column(const int* col, int begin, int n,
                                             int* out) {
  const int4* c4 = reinterpret_cast<const int4*>(col);
  int4* o4 = reinterpret_cast<int4*>(out);
  for (int k = (begin >> 2) + threadIdx.x; k < (n + 3) >> 2; k += blockDim.x) {
    o4[k] = c4[k];
  }
  __syncthreads();
}

// Warp-collective (all 32 lanes, i uniform): whether a descriptor after i
// writes destination row `row`. col[i + 1, n) must be staged.
__device__ __forceinline__ bool written_later(const int* col, int n, int i,
                                              int row) {
  const int lane = threadIdx.x & 31;
  for (int base = i + 1; base < n; base += 32) {
    const int j = base + lane;
    if (__any_sync(0xffffffffu, j < n && col[j] == row)) return true;
  }
  return false;
}

}  // namespace desc_table

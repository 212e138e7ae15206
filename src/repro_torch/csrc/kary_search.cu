// Batched k-ary descent, the tiered engine's top tier past 256 pages, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/kary_search.py::
// kary_search_tiled (_kernel). Per query, descend `depth` levels of
// separator rows [n_l, wpad]:  j = j * fanout + #{s : level_l[j][s] < q}.
//
// Why a binary search is exact: every row of every level is nondecreasing
// with a sentinel tail (DESIGN.md §2.3; ops.kary_levels pads each node of
// the sorted, linearized tree with the int32-max / +inf sentinel). On such
// a row the predicate row[s] < q is true on a prefix and false after it, so
// the count the TPU kernel takes over the whole row equals the lower bound
// of q. That holds for duplicate keys, for q equal to the sentinel, for
// -0.0 against +0.0 (equal, so neither is below the other) and for a NaN
// query (the predicate is false everywhere: 0, as the count gives). The
// compare is in the key type with no arithmetic on keys, so int32 and
// float32 ranks are bit-identical to the count.
//
// Design:
//   * persistent blocks: occupancy x SMs blocks, each walking the queries
//     with a grid stride (the next query's load in flight during the
//     current search), so the staged levels are loaded once a block, not
//     once per 256 queries;
//   * each block stages the top levels of the flattened tree into dynamic
//     shared memory with 16-byte loads: every level that fits, in order,
//     under kSmemBudget (opting in above 48 KB). At wpad 128 that is levels
//     0-1 (129 rows, 69 KB as padded), which covers trees of up to 16,384
//     pages. Staged rows are padded (one entry in 32, one a row) so that
//     a warp's searches, in one row or in different rows, spread over the
//     banks;
//   * per level one branch-free lower bound over the wpad entries of row j
//     (8 reads at wpad 128, not 128 compares), then j = j * fanout + pos,
//     clamped to the level's rows for queries outside the key domain;
//   * levels past the staged ones (depth 3 and beyond) are binary-searched
//     in device memory through the read-only path (__ldg), so every depth
//     up to kMaxDepth stays correct.
//
// What bounds it on the H100: bytes, the queries in and the ranks out
// (8 B a query; the levels are a few tens of KB). The work is depth
// binary searches a query, ceil(log2(wpad + 1)) compares each.
#include <cuda_runtime.h>
#include <stdint.h>

#include "persistent.cuh"

namespace {

constexpr int kMaxDepth = 8;
constexpr int kThreads = 1024;
constexpr int kSmemBudget = 200 * 1024;   // bytes of staged levels, at most

struct Levels {
  long long offset[kMaxDepth];  // element offset of level l in `levels`
  int rows[kMaxDepth];          // n_l, rows of level l
  int first_row[kMaxDepth];     // offset[l] / wpad: level l's first row
};

// A key from the 32 bits a 16-byte load brought.
template <typename T> __device__ __forceinline__ T from_word(int w);
template <> __device__ __forceinline__ int32_t from_word<int32_t>(int w) {
  return w;
}
template <> __device__ __forceinline__ float from_word<float>(int w) {
  return __int_as_float(w);
}

// Entry i of a staged row: shared rows hold one pad entry after every 32
// (see kary_search_kernel); rows in device memory are read as they are,
// through the read-only path.
template <bool kGlobal, typename T>
__device__ __forceinline__ T entry(const T* row, int i) {
  return kGlobal ? __ldg(row + i) : row[i + (i >> 5)];
}

// #{i < n : row[i] < q} on a nondecreasing row of n >= 1 entries: the
// answer lies in [base, base + n]; each step halves n without a branch.
template <bool kGlobal, typename T>
__device__ __forceinline__ int lower_bound(const T* row, int n, const T q) {
  int base = 0;
  while (n > 1) {
    const int half = n >> 1;
    base = entry<kGlobal>(row, base + half) < q ? base + half : base;
    n -= half;
  }
  return base + (entry<kGlobal>(row, base) < q);
}

// Shared rows: one pad entry after every 32, and rows
// wpad + wpad / 32 + 1 apart. The binary searches of a warp read, at one
// step, entries 2^m (2t + 1) of one row (level 0) or the same entry of
// different rows (level 1); unpadded, both fall in one bank and the warp
// serialises up to 32 ways. Padded, entry i of row r sits in bank
// (r * stride + i + i / 32) mod 32, which spreads both.
__host__ __device__ __forceinline__ int padded_stride(int wpad) {
  return wpad + (wpad >> 5) + 1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
kary_search_kernel(const T* __restrict__ q, int n_q,
                   const T* __restrict__ levels, Levels lv, int depth,
                   int n_staged, int staged_rows, int fanout, int wpad,
                   int* __restrict__ out) {
  extern __shared__ int4 smem4[];
  T* staged = reinterpret_cast<T*>(smem4);
  const int stride = padded_stride(wpad);
  // levels 0 .. n_staged - 1 are the first staged_rows rows: 16-byte
  // loads (wpad % 4 == 0, so the 4 entries of a load share a row and a
  // run of 32)
  const int4* src = reinterpret_cast<const int4*>(levels);
  const int per_row = wpad / 4;
  for (int i = threadIdx.x; i < staged_rows * per_row; i += blockDim.x) {
    const int4 v = __ldg(src + i);
    const int col = (i % per_row) * 4;
    T* dst = staged + (i / per_row) * stride + col + (col >> 5);
    dst[0] = from_word<T>(v.x);
    dst[1] = from_word<T>(v.y);
    dst[2] = from_word<T>(v.z);
    dst[3] = from_word<T>(v.w);
  }
  __syncthreads();
  const int step = gridDim.x * blockDim.x;
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  T qv = t < n_q ? q[t] : T(0);
  for (; t < n_q; t += step) {
    const T q_next = t + step < n_q ? q[t + step] : qv;   // in flight
    int j = 0;
#pragma unroll
    for (int l = 0; l < kMaxDepth; ++l) {   // unrolled: lv indexes statically
      if (l < depth) {
        // j < rows[l] for every query below the sentinel; the clamp only
        // keeps an out-of-domain query inside the tensor
        const int r = min(j, lv.rows[l] - 1);
        const int c =
            l < n_staged
                ? lower_bound<false>(staged + (lv.first_row[l] + r) * stride,
                                     wpad, qv)
                : lower_bound<true>(
                      levels + lv.offset[l] + static_cast<long long>(r) * wpad,
                      wpad, qv);
        j = j * fanout + c;
      }
    }
    out[t] = j;
    qv = q_next;
  }
}

int smem_limit(int dev, int* bytes) {
  persistent::Device d;
  const cudaError_t err = persistent::device(dev, &d);
  *bytes = d.optin < kSmemBudget ? d.optin : kSmemBudget;
  return static_cast<int>(err);
}

template <typename T>
int launch(const void* q, int n_q, const void* levels,
           const long long* offsets, const int* rows, int depth, int fanout,
           int wpad, void* out, void* stream) {
  if (depth < 1 || depth > kMaxDepth || wpad < 4 || wpad % 4 ||
      reinterpret_cast<uintptr_t>(levels) % 16)
    return cudaErrorInvalidValue;
  if (n_q == 0) return cudaSuccess;
  int dev = 0, limit = 0;
  if (const cudaError_t err = cudaGetDevice(&dev)) return err;
  if (const int err = smem_limit(dev, &limit)) return err;
  const long long row_bytes =
      static_cast<long long>(padded_stride(wpad)) * sizeof(T);
  Levels lv = {};
  long long end = 0;       // levels must be contiguous, level-major, from 0
  int n_staged = 0, staged_rows = 0;
  for (int l = 0; l < depth; ++l) {
    if (offsets[l] != end || rows[l] < 1) return cudaErrorInvalidValue;
    lv.offset[l] = offsets[l];
    lv.rows[l] = rows[l];
    lv.first_row[l] = static_cast<int>(offsets[l] / wpad);
    end += static_cast<long long>(rows[l]) * wpad;
    if (n_staged == l &&
        (lv.first_row[l] + static_cast<long long>(rows[l])) * row_bytes <=
            limit) {
      n_staged = l + 1;
      staged_rows = lv.first_row[l] + rows[l];
    }
  }
  if (n_staged == 0) return cudaErrorInvalidValue;   // level 0 does not fit
  const size_t smem = static_cast<size_t>(staged_rows * row_bytes);
  auto kernel = kary_search_kernel<T>;
  int cap = 0;
  if (const cudaError_t err = persistent::resident_blocks(
          kernel, dev, kThreads, smem, limit, &cap))
    return static_cast<int>(err);
  const long long want = (static_cast<long long>(n_q) + kThreads - 1) /
                         kThreads;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), n_q, static_cast<const T*>(levels), lv, depth,
      n_staged, staged_rows, fanout, wpad, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bytes of levels the kernel may stage in shared memory on the current
// device: the device's opt-in limit, capped at kSmemBudget. A tree whose
// level-0 row (padded_stride(wpad) entries as staged) exceeds it cannot be
// searched.
extern "C" int kary_search_smem_limit(int* bytes) {
  int dev = 0;
  if (const cudaError_t err = cudaGetDevice(&dev)) return err;
  return smem_limit(dev, bytes);
}

// offsets and rows are host arrays of `depth` entries; the levels must lie
// contiguous and level-major from element 0 (as flatten_levels lays them).
extern "C" int kary_search_i32(const void* q, int n_q, const void* levels,
                               const long long* offsets, const int* rows,
                               int depth, int fanout, int wpad, void* out,
                               void* stream) {
  return launch<int32_t>(q, n_q, levels, offsets, rows, depth, fanout, wpad,
                         out, stream);
}

extern "C" int kary_search_f32(const void* q, int n_q, const void* levels,
                               const long long* offsets, const int* rows,
                               int depth, int fanout, int wpad, void* out,
                               void* stream) {
  return launch<float>(q, n_q, levels, offsets, rows, depth, fanout, wpad,
                       out, stream);
}

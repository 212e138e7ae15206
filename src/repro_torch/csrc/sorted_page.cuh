// Sorted leaf pages in shared memory: the machinery the bottom tier's
// kernels share (csrc/page_search.cu, csrc/page_scan.cu).
//
// Every leaf page is nondecreasing with a sentinel tail (DESIGN.md §2.3;
// the mutable store keeps its gapped pages sorted too). On such a row
// k[s] < q and k[s] <= q each hold on a prefix, so the TPU kernels'
// counts #{s : k[s] < q} and #{s : k[s] <= q} are a binary search's lower
// and upper bound, found branch-free in log2(n) + 1 shared-memory reads
// (12 at 2048 slots). Keys compare in their type, so each search is
// bit-identical to the count: for duplicate runs, a bound equal to the
// sentinel or +inf, -0.0 against +0.0, and a NaN bound (both counts 0).
//
// The kernels built on it run persistent blocks (occupancy x SMs, at most
// the grid, one thread a lane). Each block walks a contiguous share of
// the steps that run, [0, *steps_used) read from device memory, so blocks
// past it do no work and no step at or past it writes an output. Steps
// come sorted by page, so a block restages its page only when the page
// changes, and loads the next step's page id and bounds while it
// searches. Pages of more than kChunk slots restage chunk by chunk; the
// callers add the chunks' counts (and combine their aggregates).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "persistent.cuh"

namespace sorted_page {

constexpr int kChunk = 2048;           // slots staged at once (8 KB of keys)

// Staged key rows hold one pad slot after every 32: slot i sits at
// i + i / 32, so the lanes of a warp, whose binary searches in one row
// read slots 2^m (2t + 1) apart at the same step, fall in different banks
// (unpadded, those slots share bank 0 and a warp serialises up to 32 ways).
constexpr int kPadded = kChunk + kChunk / 32;

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

template <typename T> __device__ __forceinline__ T from_bits(int bits);
template <> __device__ __forceinline__ int32_t from_bits<int32_t>(int bits) {
  return bits;
}
template <> __device__ __forceinline__ float from_bits<float>(int bits) {
  return __int_as_float(bits);
}

// Loads a thread keeps in flight while it stages a row: a step waits for
// one round of loads, not one a 16-byte piece.
constexpr int kBatch = 4;

// Stage `len` key slots into padded shared memory and, when `vdst`, `len`
// value slots unpadded into 16-byte aligned shared memory: 16-byte loads
// when `vec` (len % 4 == 0 and the rows 16-byte aligned; the 4 slots of a
// load never straddle a pad), kBatch of each row issued before any store;
// else one slot a load.
template <typename K, typename V = int32_t>
__device__ __forceinline__ void stage_rows(K* kdst, const K* __restrict__ ksrc,
                                           int len, bool vec,
                                           V* vdst = nullptr,
                                           const V* __restrict__ vsrc =
                                               nullptr) {
  if (!vec) {
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      kdst[padded(i)] = ksrc[i];
      if (vdst != nullptr) vdst[i] = vsrc[i];
    }
    return;
  }
  const int4* k4 = reinterpret_cast<const int4*>(ksrc);
  const int4* v4 = reinterpret_cast<const int4*>(vsrc);
  const int n4 = len / 4, step = blockDim.x;
  for (int i0 = threadIdx.x; i0 < n4; i0 += kBatch * step) {
    int4 kv[kBatch], vv[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * step;
      if (i < n4) {
        kv[b] = __ldg(k4 + i);
        if (vdst != nullptr) vv[b] = __ldg(v4 + i);
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * step;
      if (i < n4) {
        K* d = kdst + padded(4 * i);
        d[0] = from_bits<K>(kv[b].x);
        d[1] = from_bits<K>(kv[b].y);
        d[2] = from_bits<K>(kv[b].z);
        d[3] = from_bits<K>(kv[b].w);
        if (vdst != nullptr) reinterpret_cast<int4*>(vdst)[i] = vv[b];
      }
    }
  }
}

// #{i < n : row[i] < q} on a nondecreasing staged row of n >= 1 slots: the
// answer lies in [base, base + n]; each step halves n without a branch
// (12 reads at n = 2048, 8 at 128).
template <typename K>
__device__ __forceinline__ int lower_bound(const K* row, int n, const K q) {
  int base = 0;
  while (n > 1) {
    const int half = n >> 1;
    base = row[padded(base + half)] < q ? base + half : base;
    n -= half;
  }
  return base + (row[padded(base)] < q);
}

// #{i < n : row[i] <= q}, the same search with the other predicate.
template <typename K>
__device__ __forceinline__ int upper_bound_le(const K* row, int n,
                                              const K q) {
  int base = 0;
  while (n > 1) {
    const int half = n >> 1;
    base = row[padded(base + half)] <= q ? base + half : base;
    n -= half;
  }
  return base + (row[padded(base)] <= q);
}

// The block's contiguous share of the steps that run: [*g0, *g1) of
// [0, used), used = *steps_used (device memory) or every step.
__device__ __forceinline__ void step_range(const int* steps_used, int grid,
                                           int* g0, int* g1) {
  int used = steps_used != nullptr ? *steps_used : grid;
  used = max(0, min(used, grid));
  *g0 = static_cast<int>(static_cast<long long>(blockIdx.x) * used / gridDim.x);
  *g1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * used /
                         gridDim.x);
}

// The persistent walk over the block's steps. For each step (block-
// uniform, page p) and each chunk [base, base + len) of p's row it calls
// stage(row offset, len) between two barriers unless that chunk is the
// one staged, then chunk(len, x) with this lane's kN bounds x (in[j] is
// the j-th [grid, blockDim.x] bound array); after the last chunk,
// done(lane, p), lane being this thread's output index. One-chunk pages
// stay staged for the next step on the same page.
template <int kN, typename K, typename Stage, typename Chunk, typename Done>
__device__ __forceinline__ void page_walk(const K* const (&in)[kN],
                                          const int* __restrict__ step_pages,
                                          const int* __restrict__ steps_used,
                                          int grid, int lw_pad, Stage stage,
                                          Chunk chunk, Done done) {
  int g0, g1;
  step_range(steps_used, grid, &g0, &g1);
  const size_t tq = blockDim.x;
  int staged = -1;
  int page = 0;
  K x[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) x[j] = K(0);
  if (g0 < g1) {
    page = step_pages[g0];
#pragma unroll
    for (int j = 0; j < kN; ++j) x[j] = in[j][g0 * tq + threadIdx.x];
  }
  for (int g = g0; g < g1; ++g) {
    // the next step's page and bounds load while this step searches
    int page_next = page;
    K x_next[kN];
#pragma unroll
    for (int j = 0; j < kN; ++j) x_next[j] = x[j];
    if (g + 1 < g1) {
      page_next = step_pages[g + 1];
#pragma unroll
      for (int j = 0; j < kN; ++j)
        x_next[j] = in[j][(g + 1) * tq + threadIdx.x];
    }
    const size_t row = static_cast<size_t>(page) * lw_pad;
    for (int base = 0; base < lw_pad; base += kChunk) {
      const int len = min(kChunk, lw_pad - base);
      if (page != staged) {
        __syncthreads();               // every lane is done with the stage
        stage(row + base, len);
        __syncthreads();
        if (lw_pad <= kChunk) staged = page;
      }
      chunk(len, x);
    }
    done(g * tq + threadIdx.x, page);
    page = page_next;
#pragma unroll
    for (int j = 0; j < kN; ++j) x[j] = x_next[j];
  }
}

// out[lane] = page * stride + min(#{k < e}, cap) for each lane's bound e:
// the page-search kernel's global rank or slot address (stride leaf_width
// or lw_pad, cap stride) and the page-prefix count (stride 0, cap lw_pad).
template <typename K>
__global__ void __launch_bounds__(1024)
    lower_bound_kernel(const K* __restrict__ e,
                       const int* __restrict__ step_pages,
                       const K* __restrict__ kpages,
                       const int* __restrict__ steps_used,
                       int* __restrict__ out, int grid, int lw_pad,
                       int stride, int cap, bool vec) {
  __shared__ K kc[kPadded];
  const K* const in[1] = {e};
  int c = 0;
  page_walk<1>(
      in, step_pages, steps_used, grid, lw_pad,
      [&](size_t off, int len) { stage_rows(kc, kpages + off, len, vec); },
      [&](int len, const K* x) { c += lower_bound(kc, len, x[0]); },
      [&](size_t lane, int page) {
        out[lane] = page * stride + min(c, cap);
        c = 0;
      });
}

// 16-byte staging needs every row (page * lw_pad slots) 16-byte aligned.
inline bool vector_rows(int lw_pad, const void* a, const void* b = nullptr) {
  return lw_pad % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

// Launch `kernel` (static shared memory only) on min(grid, occupancy x
// SMs) persistent blocks of `tq` threads; returns the CUDA error, 0 if
// none. grid must be at least 1.
template <typename... P, typename... A>
int launch(void (*kernel)(P...), int grid, int tq, cudaStream_t stream,
           A... args) {
  int dev = 0, cap = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = persistent::resident_blocks(kernel, dev, tq, 0, 0, &cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid < cap ? grid : cap, tq, 0, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sorted_page

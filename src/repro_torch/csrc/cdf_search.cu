// Batched CDF inversion for nucleus (top-p) sampling, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/cdf_search.py::cdf_search
// (_kernel). For each row b it writes
//     out[b] = min(|{v : cdf[b, v] < u[b]}|, V - 1)
// a count and not a binary search, so a row that is not monotone still
// gets the reference's answer; a NaN in cdf or u compares false, as there.
// Built without --use_fast_math.
//
// What bounds it: bytes. It reads each cdf entry once (4 B) and does one
// compare per entry; the H100 moves 3.35 TB/s and issues about 33.5e12
// 32-bit instructions a second, so reading takes 4 / 3.35e12 s an entry
// and comparing 1 / 33.5e12 s, 40x less. At decode batch sizes (B = 8,
// V = 152,064: 4.9 MB, 1.45 us at the byte bound) fixed costs set the
// time: on the H100 a launch takes ~1 us, the rounds of loads ~1.5 us and
// the cluster barrier ~0.8 us (PERF.md §6, row 5).
//
// Design:
//   * one launch a call: the kernel clips and stores every row's count
//     itself, so the output needs no zero fill and no clamp afterwards;
//   * one thread-block cluster a row: grid (kCluster, rows), cluster
//     (kCluster, 1, 1), kCluster = 8, the portable size (on the H100 16,
//     the non-portable limit, is slower from B = 8 up: PERF.md §6 row 5).
//     At B = 8 that is 64 blocks; rank r of a cluster counts the r-th of
//     kCluster equal slices of its row. On the H100, 92 clusters of 8
//     fit at once at this block size, so B = 64 runs in one wave;
//   * enough bytes in flight: each thread issues kLoads 16-byte loads
//     before it compares any of them, a block kThreads * kLoads float4
//     (32 KB) a round. Lanes past the slice load nothing and count NaN,
//     which compares false. Rows that are not 16-byte aligned, or
//     V % 4 != 0, take the same loop with 4-byte loads;
//   * no atomics: a block reduces its count by warp shuffle, then across
//     its warps in shared memory, and stores it into rank 0's shared
//     memory through distributed shared memory (map_shared_rank); after
//     one cluster.sync() rank 0 adds the kCluster counts in one warp,
//     clips and stores. No block reads another's shared memory after the
//     barrier, so every block may exit once past it; the counts alternate
//     between two buffers by row, so a cluster looping over rows needs no
//     second barrier (a rank writes a buffer again only after the next
//     row's barrier, which rank 0 reaches after reading it). Integer adds
//     in a fixed order: the result is deterministic;
//   * rows past 65,535 (the grid's y limit) are reached by a loop over
//     rows in steps of gridDim.y; every block of a cluster takes the same
//     rows, so each cluster.sync() is reached by all of them.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 8;                // loads in flight a thread
constexpr int kCluster = 8;              // blocks a row

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ int below(float4 x, float uv) {
  return (x.x < uv) + (x.y < uv) + (x.z < uv) + (x.w < uv);
}

__device__ __forceinline__ int below(float x, float uv) { return x < uv; }

template <typename T> __device__ __forceinline__ T nan_fill();
template <> __device__ __forceinline__ float nan_fill<float>() {
  return __int_as_float(0x7fc00000);
}
template <> __device__ __forceinline__ float4 nan_fill<float4>() {
  const float n = __int_as_float(0x7fc00000);
  return make_float4(n, n, n, n);
}

// |{i in [s0, s1) : p[i] < uv}| over this thread's share of the slice,
// kLoads loads issued before the first compare.
template <typename T>
__device__ __forceinline__ int count_slice(const T* __restrict__ p, int s0,
                                           int s1, float uv) {
  int cnt = 0;
  for (int i = s0 + static_cast<int>(threadIdx.x); i < s1;
       i += kThreads * kLoads) {
    T x[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int k = i + j * kThreads;
      x[j] = k < s1 ? __ldg(p + k) : nan_fill<T>();
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) cnt += below(x[j], uv);
  }
  return cnt;
}

// At least 1,536 resident threads an SM (six blocks of 256), so ptxas
// keeps to 40 registers and more loads are in flight at large B.
__global__ void __launch_bounds__(kThreads, 1536 / kThreads)
    cdf_search_kernel(const float* __restrict__ cdf,
                      const float* __restrict__ u, int* __restrict__ out,
                      int rows, int V, int vec) {
  __shared__ int warp_counts[kWarps];
  __shared__ int block_counts[2][kCluster];   // read in rank 0 only
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // this block's slice of a row, in loads: rank r takes [s0, s1)
  const int n = vec ? V >> 2 : V;
  const int per = (n + kCluster - 1) / kCluster;
  const int s0 = min(rank * per, n), s1 = min(s0 + per, n);
  for (int b = blockIdx.y, buf = 0; b < rows; b += gridDim.y, buf ^= 1) {
    const float* row = cdf + static_cast<size_t>(b) * V;
    const float uv = __ldg(u + b);
    int cnt = vec ? count_slice(reinterpret_cast<const float4*>(row), s0, s1,
                                uv)
                  : count_slice(row, s0, s1, uv);
    cnt = warp_sum(cnt);
    if (lane == 0) warp_counts[warp] = cnt;
    __syncthreads();
    if (warp == 0) {
      cnt = warp_sum(lane < kWarps ? warp_counts[lane] : 0);
      if (lane == 0)
        *cluster.map_shared_rank(&block_counts[buf][rank], 0) = cnt;
    }
    cluster.sync();                  // every rank's count is in rank 0
    if (rank == 0 && warp == 0) {
      const int total =
          warp_sum(lane < kCluster ? block_counts[buf][lane] : 0);
      if (lane == 0) out[b] = min(total, V - 1);
    }
  }
}

}  // namespace

// cdf: [rows, V] float32, row-major and contiguous; u: [rows] float32;
// out: [rows] int32, every entry written. vec != 0 asserts that cdf is
// 16-byte aligned and V % 4 == 0. rows >= 1, V >= 1. Returns the launch's
// cudaError_t.
extern "C" int cdf_search_f32(const void* cdf, const void* u, void* out,
                              int rows, int V, int vec, void* stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, rows < 65535 ? rows : 65535);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, cdf_search_kernel, static_cast<const float*>(cdf),
      static_cast<const float*>(u), static_cast<int*>(out), rows, V, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

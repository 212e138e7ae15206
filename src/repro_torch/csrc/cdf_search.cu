// Batched CDF inversion for nucleus (top-p) sampling, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/cdf_search.py::cdf_search
// (_kernel). For each row b it writes
//     out[b] = |{v : cdf[b, v] < u[b]}|
// a count and not a binary search, so a row that is not monotone still
// gets the reference's answer; a NaN in cdf or u compares false, as there.
// The wrapper clips the count to V - 1, as the reference clips outside the
// Pallas body. Built without --use_fast_math.
//
// Design (simple first):
//   * the TPU walked the vocabulary chunks in order and carried the count
//     in its output block. Blocks on the H100 run in no order, so the grid
//     is (ceil(V / kChunk), rows): each block counts one chunk of one row
//     and adds its count to the row with one atomicAdd into an output the
//     wrapper zeroed. Integer adds commute, so the result is bit-exact
//     whatever the order of the atomics;
//   * at decode batch sizes this fills the card: B = 8 over V = 152,064 is
//     149 x 8 = 1192 blocks, where one block a row would leave 124 of the
//     132 SMs idle;
//   * a thread loads one float4 of its chunk when the rows are 16-byte
//     aligned (V % 4 == 0 and an aligned base), else walks the chunk in
//     steps of the block size; counts reduce by warp shuffle, then across
//     the block's warps in shared memory;
//   * rows past 65,535 (the grid's y limit) are reached by a loop over
//     rows in steps of gridDim.y.
//
// What bounds it: bytes. It reads each cdf entry once (4 B) and does one
// compare per entry; the H100 moves 3.35 TB/s and issues about 33.5e12
// 32-bit instructions a second, so reading takes 4 / 3.35e12 s an entry
// and comparing 1 / 33.5e12 s, 40x less.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4 * kThreads;     // one float4 per thread

__global__ void cdf_search_kernel(const float* __restrict__ cdf,
                                  const float* __restrict__ u,
                                  int* __restrict__ out, int rows, int V,
                                  int vec) {
  __shared__ int warp_sums[kThreads / 32];
  const int base = blockIdx.x * kChunk;
  const int len = min(kChunk, V - base);
  for (int b = blockIdx.y; b < rows; b += gridDim.y) {
    const float* row = cdf + static_cast<size_t>(b) * V + base;
    const float uv = u[b];
    int cnt = 0;
    if (vec && len == kChunk) {
      const float4 x = reinterpret_cast<const float4*>(row)[threadIdx.x];
      cnt = (x.x < uv) + (x.y < uv) + (x.z < uv) + (x.w < uv);
    } else {
      for (int i = threadIdx.x; i < len; i += kThreads) cnt += row[i] < uv;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      cnt += __shfl_down_sync(0xffffffffu, cnt, off);
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = cnt;
    __syncthreads();
    if (threadIdx.x == 0) {
      int total = 0;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
      if (total) atomicAdd(out + b, total);
    }
    __syncthreads();       // warp_sums is reused by the next row
  }
}

}  // namespace

// cdf: [rows, V] float32, row-major and contiguous; u: [rows] float32;
// out: [rows] int32, zeroed by the caller. vec != 0 asserts that cdf is
// 16-byte aligned and V % 4 == 0. rows >= 1, V >= 1.
extern "C" int cdf_search_f32(const void* cdf, const void* u, void* out,
                              int rows, int V, int vec, void* stream) {
  const dim3 grid((V + kChunk - 1) / kChunk, rows < 65535 ? rows : 65535);
  cdf_search_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cdf), static_cast<const float*>(u),
      static_cast<int*>(out), rows, V, vec);
  return static_cast<int>(cudaGetLastError());
}

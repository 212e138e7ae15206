// Leaf-page search, the tiered engine's bottom tier, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/page_search.py::
// page_search_bucketed (_kernel). Grid step g serves TQ queries that all
// live in leaf page step_pages[g]; each lane returns
//     step_pages[g] * stride + min(#{s : page[s] < q}, stride).
//
// Design (simple first):
//   * one block per grid step, one thread per lane (blockDim.x == TQ);
//   * the block stages the page row through shared memory in fixed chunks
//     of kChunk keys (8 KB), so any lw_pad works without the dynamic
//     shared-memory opt-in that a single-shot stage past 48 KB would need;
//   * each thread counts the staged keys below its query, branch-free, over
//     the whole row: the same arithmetic as the TPU kernel, which is what
//     makes the result bit-identical to it;
//   * the TPU picked the executed grid rung with lax.switch. Here the
//     static worst-case grid launches and every block whose step index is
//     at least *steps_used (read from device memory, no host round trip)
//     returns at once. The outputs of those steps are never read back.
//
// What bounds it: its least time on the H100 is set by bytes (the lanes
// in and out and each touched page row once), at one binary search a
// lane. The kernel does the linear count instead: every lane compares
// against all lw_pad keys of its page (TQ * lw_pad compares a step; the
// shared-memory reads are broadcasts). That those compares, and not
// memory, limit it is a guess that was not measured. A binary search per
// lane would do log2(lw_pad) compares; that is a later change.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 2048;

template <typename T>
__global__ void page_search_kernel(const T* __restrict__ q,
                                   const int* __restrict__ step_pages,
                                   const T* __restrict__ pages,
                                   const int* __restrict__ steps_used,
                                   int* __restrict__ out, int lw_pad,
                                   int stride) {
  const int g = blockIdx.x;
  if (steps_used != nullptr && g >= *steps_used) return;  // uniform per block
  __shared__ T chunk[kChunk];
  const int tq = blockDim.x;
  const int page = step_pages[g];
  const T* row = pages + static_cast<size_t>(page) * lw_pad;
  const size_t lane = static_cast<size_t>(g) * tq + threadIdx.x;
  const T qv = q[lane];
  int cnt = 0;
  for (int base = 0; base < lw_pad; base += kChunk) {
    const int len = min(kChunk, lw_pad - base);
    for (int i = threadIdx.x; i < len; i += tq) chunk[i] = row[base + i];
    __syncthreads();
#pragma unroll 16
    for (int i = 0; i < len; ++i) cnt += chunk[i] < qv;
    __syncthreads();
  }
  out[lane] = page * stride + min(cnt, stride);
}

template <typename T>
int launch(const void* q, const void* step_pages, const void* pages,
           const void* steps_used, void* out, int grid, int tq, int lw_pad,
           int stride, void* stream) {
  page_search_kernel<T><<<grid, tq, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const int*>(step_pages),
      static_cast<const T*>(pages), static_cast<const int*>(steps_used),
      static_cast<int*>(out), lw_pad, stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// steps_used may be null: then every one of the `grid` steps runs.
extern "C" int page_search_i32(const void* q, const void* step_pages,
                               const void* pages, const void* steps_used,
                               void* out, int grid, int tq, int lw_pad,
                               int stride, void* stream) {
  return launch<int32_t>(q, step_pages, pages, steps_used, out, grid, tq,
                         lw_pad, stride, stream);
}

extern "C" int page_search_f32(const void* q, const void* step_pages,
                               const void* pages, const void* steps_used,
                               void* out, int grid, int tq, int lw_pad,
                               int stride, void* stream) {
  return launch<float>(q, step_pages, pages, steps_used, out, grid, tq,
                       lw_pad, stride, stream);
}

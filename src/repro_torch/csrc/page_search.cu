// Leaf-page search, the tiered engine's bottom tier, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/page_search.py::
// page_search_bucketed (_kernel). Grid step g serves TQ queries that all
// live in leaf page step_pages[g]; each lane returns
//     step_pages[g] * stride + min(#{s : page[s] < q}, stride).
//
// The TPU kernel counts: every lane against all lw_pad slots of its page
// (a vector popcount). Every page is nondecreasing with a sentinel tail,
// so the count is the lower bound of q, found here by a branch-free binary
// search in shared memory, bit-identical to it (sorted_page.cuh says why).
// This is the page-prefix count of csrc/page_scan.cu with another store:
// both launch sorted_page::lower_bound_kernel. Its design:
//   * persistent blocks (occupancy x SMs, at most the grid), one thread a
//     lane (blockDim.x == TQ, 1-1024); each walks a contiguous share of
//     [0, *steps_used), read from device memory (no host round trip), so
//     no step at or past it writes an output;
//   * a page is staged (16-byte loads, rows padded one slot in 32 against
//     bank conflicts) only when it changes; pages wider than kChunk slots
//     restage chunk by chunk and add the chunks' lower bounds;
//   * the next step's page id and query load while this step searches.
// What bounds it on the H100: bytes, the lanes in and out and each touched
// page row once; a lane's 12 compares at lw_pad 2048 are far below the
// card's compare rate.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_page.cuh"

namespace {

template <typename T>
int launch(const void* q, const void* step_pages, const void* pages,
           const void* steps_used, void* out, int grid, int tq, int lw_pad,
           int stride, void* stream) {
  if (lw_pad < 1 || tq < 1 || tq > 1024) return cudaErrorInvalidValue;
  if (grid == 0) return cudaSuccess;
  return sorted_page::launch(
      sorted_page::lower_bound_kernel<T>, grid, tq,
      static_cast<cudaStream_t>(stream), static_cast<const T*>(q),
      static_cast<const int*>(step_pages), static_cast<const T*>(pages),
      static_cast<const int*>(steps_used), static_cast<int*>(out), grid,
      lw_pad, stride, stride, sorted_page::vector_rows(lw_pad, pages));
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

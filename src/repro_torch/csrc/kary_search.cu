// Batched k-ary descent, the tiered engine's top tier past 256 pages, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/kary_search.py::
// kary_search_tiled (_kernel). Per query, descend `depth` levels of
// separator rows [n_l, wpad]:  j = j * fanout + #{s : level_l[j][s] < q}.
//
// Design (simple first):
//   * one thread per query, the tail masked, so the queries need no padding
//     to the TPU's (tile_rows, 128) tiles;
//   * the TPU kernel fetched row j through an exact one-hot f32 matmul
//     (_exact_onehot_gather) only to use its matrix unit. Here each thread
//     loads row j itself: 16-byte vector loads through the read-only path.
//     The count compares in the key type, as the reference does, so the
//     result is bit-exact for every int32 and float32 key;
//   * level 0 (one row) sits in shared memory; the deeper levels are read
//     from device memory and stay resident in L2 (a depth-2 tree over 8192
//     pages is 129 rows of 512 B, 66 KB);
//   * all levels come flattened into one tensor; their offsets travel by
//     value, so depth is a kernel argument (at most kMaxDepth).
//
// What bounds it: its least time on the H100 is set by bytes (the queries
// in, the ranks out and the levels, a few MB), at one binary search a
// level. The kernel does depth * wpad compares a query instead; whether
// those or memory limit it was not measured.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDepth = 8;
constexpr int kThreads = 256;

struct Levels {
  long long offset[kMaxDepth];  // element offset of level l in `levels`
  int rows[kMaxDepth];          // n_l, rows of level l
};

template <typename T> struct Vec4;
template <> struct Vec4<int32_t> { using type = int4; };
template <> struct Vec4<float> { using type = float4; };

template <typename T>
__device__ __forceinline__ int count_below(const typename Vec4<T>::type v,
                                           const T q) {
  return (v.x < q) + (v.y < q) + (v.z < q) + (v.w < q);
}

template <typename T>
__global__ void kary_search_kernel(const T* __restrict__ q, int n_q,
                                   const T* __restrict__ levels, Levels lv,
                                   int depth, int fanout, int wpad,
                                   int* __restrict__ out) {
  using V = typename Vec4<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  T* level0 = reinterpret_cast<T*>(smem);
  for (int i = threadIdx.x; i < wpad; i += blockDim.x)
    level0[i] = levels[lv.offset[0] + i];
  __syncthreads();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_q) return;  // after the block's only barrier
  const T qv = q[t];
  int j = 0;
  for (int i = 0; i < wpad; ++i) j += level0[i] < qv;
  for (int l = 1; l < depth; ++l) {
    // j < rows[l] for every key below the sentinel; the clamp only keeps an
    // out-of-domain query (above the sentinel) inside the tensor
    const int r = min(j, lv.rows[l] - 1);
    const V* row = reinterpret_cast<const V*>(
        levels + lv.offset[l] + static_cast<long long>(r) * wpad);
    int c = 0;
#pragma unroll 8
    for (int i = 0; i < wpad / 4; ++i) c += count_below<T>(__ldg(row + i), qv);
    j = j * fanout + c;
  }
  out[t] = j;
}

template <typename T>
int launch(const void* q, int n_q, const void* levels,
           const long long* offsets, const int* rows, int depth, int fanout,
           int wpad, void* out, void* stream) {
  if (depth < 1 || depth > kMaxDepth || wpad % 4) return cudaErrorInvalidValue;
  Levels lv = {};
  for (int l = 0; l < depth; ++l) {
    lv.offset[l] = offsets[l];
    lv.rows[l] = rows[l];
  }
  const int blocks = (n_q + kThreads - 1) / kThreads;
  const size_t smem = static_cast<size_t>(wpad) * sizeof(T);
  kary_search_kernel<T><<<blocks, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), n_q, static_cast<const T*>(levels), lv, depth,
      fanout, wpad, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// offsets and rows are host arrays of `depth` entries.
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

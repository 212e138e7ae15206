// Endpoint-masked leaf-page scan and single-ended page prefix, the range
// scan's bottom tier, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of repro/kernels/page_scan.py:
//   * page_scan_bucketed (_kernel_count, _kernel_values): grid step g
//     serves TQ scan items that all target leaf page step_pages[g]; each
//     lane has inclusive bounds (lo, hi) and returns
//         lt = #{s : k[s] < lo},   le = #{s : k[s] <= hi},
//     and, in the value modes, over the mask
//         m = !(k < lo) && (k <= hi) [&& v != mask_value]
//     vsum = sum of v[m] (int32 wraps) and, in full mode, vmin / vmax of
//     v[m] (dtype max / min, or +inf / -inf, when m is empty);
//   * page_prefix_bucketed (_kernel_prefix_count, _kernel_prefix_sum):
//     each lane has one edge e and returns lt = #{s : k[s] < e} and, with
//     values, psum = sum of v[k < e] [&& v != mask_value].
//
// Design (simple first, as page_search.cu):
//   * one block per grid step, one thread per lane (blockDim.x == TQ);
//   * the block stages the key row, and in the value modes the aligned
//     value row, through shared memory in fixed chunks of kChunk slots
//     (8 KB each), so any lw_pad works without the dynamic shared-memory
//     opt-in;
//   * each thread walks the staged slots branch-free, as the TPU kernel's
//     masked reductions do. Count mode and prefix-count take no value
//     pointer and never read the value page;
//   * one template instance per (key type, value type, mode, mask), so the
//     narrower modes compile to strictly less work;
//   * blocks at or past *steps_used (read from device memory, no host
//     round trip) return at once; their outputs are never read back.
//
// Arithmetic: signed int32 overflow is undefined in C++, so int32 sums
// accumulate in uint32_t and convert at the store; that is the reference's
// two's-complement wrap. Float sums accumulate in double and round to
// float once at the store, so a lane's sum does not drift over lw_pad
// additions in slot order; the reference sums in float32 in its own
// order, so the two agree to rounding, not bit for bit.
//
// What bounds it on the H100: the bytes of the lanes and of the touched
// pages, at the algorithm's least work. The kernel does the linear count
// (every lane against all lw_pad slots of its page), as the TPU kernel
// did; with sorted pages two binary searches a lane would do. Which of
// the two limits this kernel was not measured.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 2048;

template <typename V> struct Acc;
template <> struct Acc<int32_t> { using T = uint32_t; };
template <> struct Acc<float> { using T = double; };

template <typename V> __device__ __forceinline__ V from_bits(int bits);
template <> __device__ __forceinline__ int32_t from_bits<int32_t>(int bits) {
  return bits;
}
template <> __device__ __forceinline__ float from_bits<float>(int bits) {
  return __int_as_float(bits);
}

// identities of the masked min / max: what an empty mask reports
template <typename V> __device__ __forceinline__ V min_identity();
template <typename V> __device__ __forceinline__ V max_identity();
template <> __device__ __forceinline__ int32_t min_identity<int32_t>() {
  return INT32_MAX;
}
template <> __device__ __forceinline__ int32_t max_identity<int32_t>() {
  return INT32_MIN;
}
template <> __device__ __forceinline__ float min_identity<float>() {
  return __int_as_float(0x7f800000);   // +inf
}
template <> __device__ __forceinline__ float max_identity<float>() {
  return __int_as_float(0xff800000);   // -inf
}

template <typename V>
__device__ __forceinline__ V from_acc(typename Acc<V>::T a) {
  return static_cast<V>(a);   // uint32 -> int32 keeps the bits; double
                               // -> float rounds once
}

// ------------------------------------------------------------- page scan
template <typename K>
__global__ void scan_count_kernel(const K* __restrict__ lo,
                                  const K* __restrict__ hi,
                                  const int* __restrict__ step_pages,
                                  const K* __restrict__ kpages,
                                  const int* __restrict__ steps_used,
                                  int* __restrict__ lt_out,
                                  int* __restrict__ le_out, int lw_pad) {
  const int g = blockIdx.x;
  if (steps_used != nullptr && g >= *steps_used) return;  // uniform per block
  __shared__ K kc[kChunk];
  const int tq = blockDim.x;
  const size_t row = static_cast<size_t>(step_pages[g]) * lw_pad;
  const size_t lane = static_cast<size_t>(g) * tq + threadIdx.x;
  const K l = lo[lane], h = hi[lane];
  int lt = 0, le = 0;
  for (int base = 0; base < lw_pad; base += kChunk) {
    const int len = min(kChunk, lw_pad - base);
    for (int i = threadIdx.x; i < len; i += tq) kc[i] = kpages[row + base + i];
    __syncthreads();
#pragma unroll 8
    for (int i = 0; i < len; ++i) {
      const K k = kc[i];
      lt += k < l;
      le += k <= h;
    }
    __syncthreads();
  }
  lt_out[lane] = lt;
  le_out[lane] = le;
}

template <typename K, typename V, bool kFull, bool kMask>
__global__ void scan_values_kernel(const K* __restrict__ lo,
                                   const K* __restrict__ hi,
                                   const int* __restrict__ step_pages,
                                   const K* __restrict__ kpages,
                                   const V* __restrict__ vpages,
                                   const int* __restrict__ steps_used,
                                   int mask_bits, int* __restrict__ lt_out,
                                   int* __restrict__ le_out,
                                   V* __restrict__ sum_out,
                                   V* __restrict__ min_out,
                                   V* __restrict__ max_out, int lw_pad) {
  using A = typename Acc<V>::T;
  const int g = blockIdx.x;
  if (steps_used != nullptr && g >= *steps_used) return;
  __shared__ K kc[kChunk];
  __shared__ V vc[kChunk];
  const int tq = blockDim.x;
  const size_t row = static_cast<size_t>(step_pages[g]) * lw_pad;
  const size_t lane = static_cast<size_t>(g) * tq + threadIdx.x;
  const K l = lo[lane], h = hi[lane];
  const V mask = from_bits<V>(mask_bits);
  int lt = 0, le = 0;
  A sum = A(0);
  V mn = min_identity<V>(), mx = max_identity<V>();
  for (int base = 0; base < lw_pad; base += kChunk) {
    const int len = min(kChunk, lw_pad - base);
    for (int i = threadIdx.x; i < len; i += tq) {
      kc[i] = kpages[row + base + i];
      vc[i] = vpages[row + base + i];
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < len; ++i) {
      const K k = kc[i];
      const V v = vc[i];
      const bool below = k < l;
      const bool in_le = k <= h;
      lt += below;
      le += in_le;
      bool m = !below && in_le;
      if (kMask) m = m && (v != mask);
      sum += m ? static_cast<A>(v) : A(0);
      if (kFull) {
        mn = (m && v < mn) ? v : mn;
        mx = (m && v > mx) ? v : mx;
      }
    }
    __syncthreads();
  }
  lt_out[lane] = lt;
  le_out[lane] = le;
  sum_out[lane] = from_acc<V>(sum);
  if (kFull) {
    min_out[lane] = mn;
    max_out[lane] = mx;
  }
}

// ----------------------------------------------------------- page prefix
template <typename K>
__global__ void prefix_count_kernel(const K* __restrict__ e,
                                    const int* __restrict__ step_pages,
                                    const K* __restrict__ kpages,
                                    const int* __restrict__ steps_used,
                                    int* __restrict__ lt_out, int lw_pad) {
  const int g = blockIdx.x;
  if (steps_used != nullptr && g >= *steps_used) return;
  __shared__ K kc[kChunk];
  const int tq = blockDim.x;
  const size_t row = static_cast<size_t>(step_pages[g]) * lw_pad;
  const size_t lane = static_cast<size_t>(g) * tq + threadIdx.x;
  const K ev = e[lane];
  int lt = 0;
  for (int base = 0; base < lw_pad; base += kChunk) {
    const int len = min(kChunk, lw_pad - base);
    for (int i = threadIdx.x; i < len; i += tq) kc[i] = kpages[row + base + i];
    __syncthreads();
#pragma unroll 16
    for (int i = 0; i < len; ++i) lt += kc[i] < ev;
    __syncthreads();
  }
  lt_out[lane] = lt;
}

template <typename K, typename V, bool kMask>
__global__ void prefix_sum_kernel(const K* __restrict__ e,
                                  const int* __restrict__ step_pages,
                                  const K* __restrict__ kpages,
                                  const V* __restrict__ vpages,
                                  const int* __restrict__ steps_used,
                                  int mask_bits, int* __restrict__ lt_out,
                                  V* __restrict__ sum_out, int lw_pad) {
  using A = typename Acc<V>::T;
  const int g = blockIdx.x;
  if (steps_used != nullptr && g >= *steps_used) return;
  __shared__ K kc[kChunk];
  __shared__ V vc[kChunk];
  const int tq = blockDim.x;
  const size_t row = static_cast<size_t>(step_pages[g]) * lw_pad;
  const size_t lane = static_cast<size_t>(g) * tq + threadIdx.x;
  const K ev = e[lane];
  const V mask = from_bits<V>(mask_bits);
  int lt = 0;
  A sum = A(0);
  for (int base = 0; base < lw_pad; base += kChunk) {
    const int len = min(kChunk, lw_pad - base);
    for (int i = threadIdx.x; i < len; i += tq) {
      kc[i] = kpages[row + base + i];
      vc[i] = vpages[row + base + i];
    }
    __syncthreads();
#pragma unroll 8
    for (int i = 0; i < len; ++i) {
      const V v = vc[i];
      const bool below = kc[i] < ev;
      lt += below;
      bool m = below;
      if (kMask) m = m && (v != mask);
      sum += m ? static_cast<A>(v) : A(0);
    }
    __syncthreads();
  }
  lt_out[lane] = lt;
  sum_out[lane] = from_acc<V>(sum);
}

// ---------------------------------------------------------------- launch
struct ScanArgs {
  const void *lo, *hi, *step_pages, *kpages, *vpages, *steps_used;
  int mask_bits;
  void *lt, *le, *vsum, *vmin, *vmax;
  int grid, tq, lw_pad;
  cudaStream_t stream;
};

template <typename K, typename V, bool kFull, bool kMask>
void launch_values(const ScanArgs& a) {
  scan_values_kernel<K, V, kFull, kMask><<<a.grid, a.tq, 0, a.stream>>>(
      static_cast<const K*>(a.lo), static_cast<const K*>(a.hi),
      static_cast<const int*>(a.step_pages), static_cast<const K*>(a.kpages),
      static_cast<const V*>(a.vpages), static_cast<const int*>(a.steps_used),
      a.mask_bits, static_cast<int*>(a.lt), static_cast<int*>(a.le),
      static_cast<V*>(a.vsum), static_cast<V*>(a.vmin),
      static_cast<V*>(a.vmax), a.lw_pad);
}

template <typename K, typename V>
void dispatch_values(const ScanArgs& a, bool full, bool has_mask) {
  if (full) {
    if (has_mask) launch_values<K, V, true, true>(a);
    else launch_values<K, V, true, false>(a);
  } else {
    if (has_mask) launch_values<K, V, false, true>(a);
    else launch_values<K, V, false, false>(a);
  }
}

template <typename K>
void dispatch_scan(const ScanArgs& a, int val_f32, int mode, bool has_mask) {
  if (mode == 0) {
    scan_count_kernel<K><<<a.grid, a.tq, 0, a.stream>>>(
        static_cast<const K*>(a.lo), static_cast<const K*>(a.hi),
        static_cast<const int*>(a.step_pages),
        static_cast<const K*>(a.kpages),
        static_cast<const int*>(a.steps_used), static_cast<int*>(a.lt),
        static_cast<int*>(a.le), a.lw_pad);
  } else if (val_f32) {
    dispatch_values<K, float>(a, mode == 2, has_mask);
  } else {
    dispatch_values<K, int32_t>(a, mode == 2, has_mask);
  }
}

struct PrefixArgs {
  const void *e, *step_pages, *kpages, *vpages, *steps_used;
  int mask_bits;
  void *lt, *psum;
  int grid, tq, lw_pad;
  cudaStream_t stream;
};

template <typename K, typename V, bool kMask>
void launch_prefix_sum(const PrefixArgs& a) {
  prefix_sum_kernel<K, V, kMask><<<a.grid, a.tq, 0, a.stream>>>(
      static_cast<const K*>(a.e), static_cast<const int*>(a.step_pages),
      static_cast<const K*>(a.kpages), static_cast<const V*>(a.vpages),
      static_cast<const int*>(a.steps_used), a.mask_bits,
      static_cast<int*>(a.lt), static_cast<V*>(a.psum), a.lw_pad);
}

template <typename K, typename V>
void dispatch_prefix_sum(const PrefixArgs& a, bool has_mask) {
  if (has_mask) launch_prefix_sum<K, V, true>(a);
  else launch_prefix_sum<K, V, false>(a);
}

template <typename K>
void dispatch_prefix(const PrefixArgs& a, int with_sum, int val_f32,
                     bool has_mask) {
  if (!with_sum) {
    prefix_count_kernel<K><<<a.grid, a.tq, 0, a.stream>>>(
        static_cast<const K*>(a.e), static_cast<const int*>(a.step_pages),
        static_cast<const K*>(a.kpages),
        static_cast<const int*>(a.steps_used), static_cast<int*>(a.lt),
        a.lw_pad);
  } else if (val_f32) {
    dispatch_prefix_sum<K, float>(a, has_mask);
  } else {
    dispatch_prefix_sum<K, int32_t>(a, has_mask);
  }
}

}  // namespace

// mode: 0 count (vpages, vsum, vmin, vmax unused), 1 sum (vmin, vmax
// unused), 2 full. key_f32 / val_f32 pick float32 over int32; mask_bits is
// the value sentinel's 32 bits, read only when has_mask. steps_used may be
// null: then every one of the `grid` steps runs.
extern "C" int page_scan(int key_f32, int val_f32, int mode, int has_mask,
                         int mask_bits, const void* lo, const void* hi,
                         const void* step_pages, const void* kpages,
                         const void* vpages, const void* steps_used,
                         void* lt, void* le, void* vsum, void* vmin,
                         void* vmax, int grid, int tq, int lw_pad,
                         void* stream) {
  const ScanArgs a{lo, hi, step_pages, kpages, vpages, steps_used,
                   mask_bits, lt, le, vsum, vmin, vmax, grid, tq, lw_pad,
                   static_cast<cudaStream_t>(stream)};
  if (key_f32) dispatch_scan<float>(a, val_f32, mode, has_mask != 0);
  else dispatch_scan<int32_t>(a, val_f32, mode, has_mask != 0);
  return static_cast<int>(cudaGetLastError());
}

// with_sum 0: lt only (vpages, psum unused).
extern "C" int page_prefix(int key_f32, int val_f32, int with_sum,
                           int has_mask, int mask_bits, const void* e,
                           const void* step_pages, const void* kpages,
                           const void* vpages, const void* steps_used,
                           void* lt, void* psum, int grid, int tq,
                           int lw_pad, void* stream) {
  const PrefixArgs a{e, step_pages, kpages, vpages, steps_used, mask_bits,
                     lt, psum, grid, tq, lw_pad,
                     static_cast<cudaStream_t>(stream)};
  if (key_f32) dispatch_prefix<float>(a, with_sum, val_f32, has_mask != 0);
  else dispatch_prefix<int32_t>(a, with_sum, val_f32, has_mask != 0);
  return static_cast<int>(cudaGetLastError());
}

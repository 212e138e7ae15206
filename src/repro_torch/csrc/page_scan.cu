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
// Page scan (simple first, as page_search.cu):
//   * one block per grid step, one thread per lane (blockDim.x == TQ);
//   * the block stages the key row, and in the value modes the aligned
//     value row, through shared memory in fixed chunks of kChunk slots
//     (8 KB each), so any lw_pad works without the dynamic shared-memory
//     opt-in;
//   * each thread walks the staged slots branch-free, as the TPU kernel's
//     masked reductions do (the linear count: every lane against all
//     lw_pad slots of its page). Count mode takes no value pointer and
//     never reads the value page;
//   * one template instance per (key type, value type, mode, mask), so the
//     narrower modes compile to strictly less work;
//   * blocks at or past *steps_used (read from device memory, no host
//     round trip) return at once; their outputs are never read back.
// What bounds it on the H100: the bytes of the lanes and of the touched
// pages. With sorted pages two binary searches a lane would do; the
// linear count is what holds it from that bound.
//
// Page prefix (redesigned for Hopper; a binary search, not a count):
//   * why it is exact: every page is nondecreasing with a sentinel tail
//     (DESIGN.md §2.3; the mutable store keeps its gapped pages sorted
//     too). On such a row k[s] < e holds on a prefix, so #{s : k[s] < e}
//     is the lower bound of e, found branch-free in log2(lw_pad) + 1
//     shared-memory reads (12 at 2048). That holds for duplicate runs, an
//     edge equal to the sentinel, -0.0 against +0.0 and a NaN edge (0);
//     keys compare in their type, so lt is bit-identical to the count;
//   * persistent blocks (occupancy x SMs, at most the grid), one thread a
//     lane; each block walks a contiguous share of the steps that run,
//     [0, *steps_used) read from device memory, so blocks past it do no
//     work and no step at or past it writes an output;
//   * steps come sorted by page, so a block restages its page only when
//     the page changes (pages of at most kChunk slots; wider pages restage
//     chunk by chunk and add the chunks' lower bounds), and loads the next
//     step's page id and edges while it searches. Keys are staged with
//     16-byte loads into rows padded by one slot in 32, so the lanes of a
//     warp, searching one row, read different banks. Count mode never
//     reads the value page;
//   * sum mode stages the values too (16-byte loads) and takes, once a
//     page, one block-wide inclusive scan of the masked sums of groups of
//     kGroup = 8 slots (warp shuffles a segment, plus each warp's offset;
//     values equal to mask_value count 0). A lane's sum is then the scan
//     at its last whole group plus at most 7 slots of the next, where the
//     linear count added lw_pad masked slots a lane every step.
// What bounds it on the H100: bytes, the lanes' edges and outputs and the
// touched pages, each read once.
//
// Arithmetic: signed int32 overflow is undefined in C++, so int32 sums
// accumulate in uint32_t and convert at the store; that is the reference's
// two's-complement wrap, bit-exact in any order. Float sums accumulate in
// double and round to float once at the store. The page scan adds in slot
// order; the prefix scan adds in its scan's order, so its float sums may
// differ from a slot-order double sum in the last bits of the double,
// which the rounding to float almost always hides. The reference sums in
// float32 in its own order: the two agree within its rtol 1e-4
// (tests/test_engine_scan.py), not bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "persistent.cuh"

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
// Staged key rows hold one pad slot after every 32: slot i sits at
// i + i / 32, so the lanes of a warp, whose binary searches in one row
// read slots 2^m (2t + 1) apart at the same step, fall in different banks
// (unpadded, those slots share bank 0 and a warp serialises up to 32 ways).
constexpr int kPadded = kChunk + kChunk / 32;

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// Stage `len` key slots into padded shared memory: 16-byte loads when
// `vec` (len % 4 == 0 and the row 16-byte aligned; the 4 slots of a load
// never straddle a pad), else one slot a load.
template <typename K>
__device__ __forceinline__ void stage_keys(K* dst, const K* __restrict__ src,
                                           int len, bool vec) {
  if (vec) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    for (int i = threadIdx.x; i < len / 4; i += blockDim.x) {
      const int4 v = __ldg(s4 + i);
      K* d = dst + padded(4 * i);
      d[0] = from_bits<K>(v.x);
      d[1] = from_bits<K>(v.y);
      d[2] = from_bits<K>(v.z);
      d[3] = from_bits<K>(v.w);
    }
  } else {
    for (int i = threadIdx.x; i < len; i += blockDim.x)
      dst[padded(i)] = src[i];
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

// The block's contiguous share of the steps that run: [*g0, *g1) of
// [0, used), used = *steps_used (device memory) or every step. Steps come
// sorted by page, so consecutive steps of a block mostly share a page.
__device__ __forceinline__ void step_range(const int* steps_used, int grid,
                                           int* g0, int* g1) {
  int used = steps_used != nullptr ? *steps_used : grid;
  used = max(0, min(used, grid));
  *g0 = static_cast<int>(static_cast<long long>(blockIdx.x) * used / gridDim.x);
  *g1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * used /
                         gridDim.x);
}

template <typename K>
__global__ void prefix_count_kernel(const K* __restrict__ e,
                                    const int* __restrict__ step_pages,
                                    const K* __restrict__ kpages,
                                    const int* __restrict__ steps_used,
                                    int* __restrict__ lt_out, int grid,
                                    int lw_pad, bool vec) {
  __shared__ K kc[kPadded];
  int g0, g1;
  step_range(steps_used, grid, &g0, &g1);
  const int tq = blockDim.x;
  int staged = -1;                      // page held in kc (one-chunk pages)
  // the next step's page and edge are loaded while this step searches
  int page = g0 < g1 ? step_pages[g0] : 0;
  K ev = g0 < g1 ? e[static_cast<size_t>(g0) * tq + threadIdx.x] : K(0);
  for (int g = g0; g < g1; ++g) {       // g and the page are block-uniform
    const bool more = g + 1 < g1;
    const int page_next = more ? step_pages[g + 1] : page;
    const K ev_next =
        more ? e[static_cast<size_t>(g + 1) * tq + threadIdx.x] : ev;
    const size_t row = static_cast<size_t>(page) * lw_pad;
    int lt = 0;
    if (lw_pad <= kChunk) {
      if (page != staged) {
        __syncthreads();                // every lane is done with kc
        stage_keys(kc, kpages + row, lw_pad, vec);
        __syncthreads();
        staged = page;
      }
      lt = lower_bound(kc, lw_pad, ev);
    } else {                            // wide pages: restage chunk by chunk
      for (int base = 0; base < lw_pad; base += kChunk) {
        const int len = min(kChunk, lw_pad - base);
        __syncthreads();
        stage_keys(kc, kpages + row + base, len, vec);
        __syncthreads();
        lt += lower_bound(kc, len, ev);
      }
    }
    lt_out[static_cast<size_t>(g) * tq + threadIdx.x] = lt;
    page = page_next;
    ev = ev_next;
  }
}

// Value slots a scanned group: the block scans group sums, not slots, and
// a lane adds the at most kGroup - 1 slots of its last, partial group.
constexpr int kGroup = 8;
constexpr int kGroups = kChunk / kGroup;

template <typename V, bool kMask>
__device__ __forceinline__ typename Acc<V>::T masked(V v, V mask) {
  using A = typename Acc<V>::T;
  return (kMask && v == mask) ? A(0) : static_cast<A>(v);
}

// The masked sum of slots [s0, s1) of a staged value row, in slot order.
template <typename V, bool kMask>
__device__ __forceinline__ typename Acc<V>::T slot_sum(const V* vc, int s0,
                                                       int s1, V mask) {
  typename Acc<V>::T a(0);
  for (int k = s0; k < s1; ++k) a += masked<V, kMask>(vc[k], mask);
  return a;
}

// The masked sum of group g of a staged value row of `len` slots: two
// 16-byte reads for a whole group (vc is 16-byte aligned), slot by slot
// for the last, partial one.
template <typename V, bool kMask>
__device__ __forceinline__ typename Acc<V>::T group_sum(const V* vc, int g,
                                                        int len, V mask) {
  const int s0 = g * kGroup;
  if (s0 + kGroup > len) return slot_sum<V, kMask>(vc, s0, len, mask);
  const int4* p = reinterpret_cast<const int4*>(vc + s0);
  const int4 x = p[0], y = p[1];
  return masked<V, kMask>(from_bits<V>(x.x), mask) +
         masked<V, kMask>(from_bits<V>(x.y), mask) +
         masked<V, kMask>(from_bits<V>(x.z), mask) +
         masked<V, kMask>(from_bits<V>(x.w), mask) +
         masked<V, kMask>(from_bits<V>(y.x), mask) +
         masked<V, kMask>(from_bits<V>(y.y), mask) +
         masked<V, kMask>(from_bits<V>(y.z), mask) +
         masked<V, kMask>(from_bits<V>(y.w), mask);
}

// Stage `len` key slots and values (16-byte loads when `vec`), and the
// inclusive scan of the masked group sums in the accumulator type. Warp w
// scans groups [w * seg, (w + 1) * seg) in rounds of one group a lane with
// warp shuffles and a carry; woff[w] is the exclusive prefix of the warps'
// totals, so the sum of groups [0, g] is sc[g] + woff[g / seg]. Ends with
// a barrier.
template <typename K, typename V, bool kMask>
__device__ __forceinline__ void stage_scan(
    K* kc, V* vc, typename Acc<V>::T* sc, typename Acc<V>::T* woff,
    const K* __restrict__ krow, const V* __restrict__ vrow, int len,
    bool vec, V mask, int seg) {
  using A = typename Acc<V>::T;
  stage_keys(kc, krow, len, vec);
  if (vec) {
    const int4* s4 = reinterpret_cast<const int4*>(vrow);
    int4* d4 = reinterpret_cast<int4*>(vc);
    for (int i = threadIdx.x; i < len / 4; i += blockDim.x)
      d4[i] = __ldg(s4 + i);
  } else {
    for (int i = threadIdx.x; i < len; i += blockDim.x) vc[i] = vrow[i];
  }
  __syncthreads();
  const int groups = (len + kGroup - 1) / kGroup;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int width = min(32, static_cast<int>(blockDim.x) - warp * 32);
  const unsigned lanes = width == 32 ? 0xffffffffu : (1u << width) - 1u;
  const int s0 = min(warp * seg, groups), s1 = min(s0 + seg, groups);
  A carry = A(0);
  for (int b = s0; b < s1; b += width) {          // warp-uniform bounds
    const int g = b + lane;
    A a = g < s1 ? group_sum<V, kMask>(vc, g, len, mask) : A(0);
    for (int d = 1; d < width; d <<= 1) {
      const A up = __shfl_up_sync(lanes, a, d);
      if (lane >= d) a += up;
    }
    a += carry;
    if (g < s1) sc[g] = a;
    carry = __shfl_sync(lanes, a, width - 1);
  }
  if (lane == 0) woff[warp] = carry;              // the warp's total
  __syncthreads();
  if (threadIdx.x == 0) {                         // totals -> exclusive prefix
    A run = A(0);
    for (int w = 0; w * 32 < static_cast<int>(blockDim.x); ++w) {
      const A t = woff[w];
      woff[w] = run;
      run += t;
    }
  }
  __syncthreads();
}

template <typename K, typename V, bool kMask>
__global__ void prefix_sum_kernel(const K* __restrict__ e,
                                  const int* __restrict__ step_pages,
                                  const K* __restrict__ kpages,
                                  const V* __restrict__ vpages,
                                  const int* __restrict__ steps_used,
                                  int mask_bits, int* __restrict__ lt_out,
                                  V* __restrict__ sum_out, int grid,
                                  int lw_pad, bool vec) {
  using A = typename Acc<V>::T;
  __shared__ K kc[kPadded];
  __shared__ __align__(16) V vc[kChunk];
  __shared__ A sc[kGroups];
  __shared__ A woff[32];
  int g0, g1;
  step_range(steps_used, grid, &g0, &g1);
  const int tq = blockDim.x;
  const int nw = (tq + 31) >> 5;
  const V mask = from_bits<V>(mask_bits);
  int staged = -1;
  int page = g0 < g1 ? step_pages[g0] : 0;
  K ev = g0 < g1 ? e[static_cast<size_t>(g0) * tq + threadIdx.x] : K(0);
  for (int g = g0; g < g1; ++g) {
    const bool more = g + 1 < g1;
    const int page_next = more ? step_pages[g + 1] : page;
    const K ev_next =
        more ? e[static_cast<size_t>(g + 1) * tq + threadIdx.x] : ev;
    const size_t row = static_cast<size_t>(page) * lw_pad;
    int lt = 0;
    A psum = A(0);
    for (int base = 0; base < lw_pad; base += kChunk) {
      const int len = min(kChunk, lw_pad - base);
      const int seg = ((len + kGroup - 1) / kGroup + nw - 1) / nw;
      if (page != staged) {
        __syncthreads();                // every lane is done with kc, sc
        stage_scan<K, V, kMask>(kc, vc, sc, woff, kpages + row + base,
                                vpages + row + base, len, vec, mask, seg);
        // one-chunk pages stay staged for the next step on the same page
        if (lw_pad <= kChunk) staged = page;
      }
      const int c = lower_bound(kc, len, ev);
      const int whole = c / kGroup;     // groups entirely below the edge
      lt += c;
      if (whole > 0) psum += sc[whole - 1] + woff[(whole - 1) / seg];
      psum += slot_sum<V, kMask>(vc, whole * kGroup, c, mask);
    }
    const size_t lane = static_cast<size_t>(g) * tq + threadIdx.x;
    lt_out[lane] = lt;
    sum_out[lane] = from_acc<V>(psum);
    page = page_next;
    ev = ev_next;
  }
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
  bool vec;
  cudaStream_t stream;
};

// Persistent blocks: as many as fit the card at once, but no more than the
// steps. Each walks a contiguous share of the steps that run.
template <typename Kernel>
int prefix_grid(Kernel kernel, const PrefixArgs& a, int* blocks) {
  int dev = 0, cap = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = persistent::resident_blocks(kernel, dev, a.tq, 0, 0, &cap);
  *blocks = a.grid < cap ? a.grid : cap;
  return static_cast<int>(err);
}

template <typename K, typename V, bool kMask>
int launch_prefix_sum(const PrefixArgs& a) {
  auto kernel = prefix_sum_kernel<K, V, kMask>;
  int blocks = 0;
  if (const int err = prefix_grid(kernel, a, &blocks)) return err;
  kernel<<<blocks, a.tq, 0, a.stream>>>(
      static_cast<const K*>(a.e), static_cast<const int*>(a.step_pages),
      static_cast<const K*>(a.kpages), static_cast<const V*>(a.vpages),
      static_cast<const int*>(a.steps_used), a.mask_bits,
      static_cast<int*>(a.lt), static_cast<V*>(a.psum), a.grid, a.lw_pad,
      a.vec);
  return 0;
}

template <typename K, typename V>
int dispatch_prefix_sum(const PrefixArgs& a, bool has_mask) {
  return has_mask ? launch_prefix_sum<K, V, true>(a)
                  : launch_prefix_sum<K, V, false>(a);
}

template <typename K>
int dispatch_prefix(const PrefixArgs& a, int with_sum, int val_f32,
                    bool has_mask) {
  if (with_sum) {
    return val_f32 ? dispatch_prefix_sum<K, float>(a, has_mask)
                   : dispatch_prefix_sum<K, int32_t>(a, has_mask);
  }
  auto kernel = prefix_count_kernel<K>;
  int blocks = 0;
  if (const int err = prefix_grid(kernel, a, &blocks)) return err;
  kernel<<<blocks, a.tq, 0, a.stream>>>(
      static_cast<const K*>(a.e), static_cast<const int*>(a.step_pages),
      static_cast<const K*>(a.kpages), static_cast<const int*>(a.steps_used),
      static_cast<int*>(a.lt), a.grid, a.lw_pad, a.vec);
  return 0;
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
  if (lw_pad < 1 || tq < 1 || tq > 1024) return cudaErrorInvalidValue;
  if (grid == 0) return cudaSuccess;
  // 16-byte staging needs every row (page * lw_pad slots) 16-byte aligned
  const bool vec = lw_pad % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(kpages) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vpages) % 16 == 0;
  const PrefixArgs a{e, step_pages, kpages, vpages, steps_used, mask_bits,
                     lt, psum, grid, tq, lw_pad, vec,
                     static_cast<cudaStream_t>(stream)};
  const int err =
      key_f32 ? dispatch_prefix<float>(a, with_sum, val_f32, has_mask != 0)
              : dispatch_prefix<int32_t>(a, with_sum, val_f32, has_mask != 0);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

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
//     v[m] (dtype max / min, or +inf / -inf, when m is empty; NaN when a
//     NaN value is in m, and -0.0 below +0.0, as jnp.min / jnp.max give);
//   * page_prefix_bucketed (_kernel_prefix_count, _kernel_prefix_sum):
//     each lane has one edge e and returns lt = #{s : k[s] < e} and, with
//     values, psum = sum of v[k < e] [&& v != mask_value].
//
// The TPU kernels count: every lane against all lw_pad slots of its page.
// Every page is nondecreasing with a sentinel tail, so here each count is
// a branch-free binary search in shared memory, bit-identical to it
// (sorted_page.cuh): lt the lower bound of lo (or e), le the upper bound
// of hi. All kernels run sorted_page::page_walk: persistent blocks, one
// thread a lane, each over a contiguous share of [0, *steps_used), a page
// staged only when it changes (wider pages chunk by chunk), the next
// step's page and bounds loaded during the search. Count modes never read
// the value page; the prefix count is sorted_page::lower_bound_kernel.
//
// Page scan, value modes. On a sorted row m is exactly the slots
// [lt, max(lt, le)), less the masked ones (empty for the inert pairs of
// engine/scan.py). Once a page, the block stages its values beside the
// keys and builds, over the masked aggregates of its 256 groups of
// kGroup = 8 slots:
//   * a segment tree of group sums in the accumulator type (uint32 for
//     int32, double for float32), so a lane sums only in-range slots, in
//     O(log) reads: a float sum is never a difference of prefixes, which
//     an infinity or NaN before lt, or a 1e30 cancelling, would spoil;
//   * in full mode, sparse tables of group minima and maxima (8 levels,
//     windows of 1 to 128 groups): two overlapping windows cover any run
//     of whole groups. The combine propagates NaN and ranks -0.0 below
//     +0.0 as jnp.min does, so any fold order gives the reference's bits.
// A lane then reads at most 7 edge slots at each end, the tree and (full)
// two windows of each table. Pages wider than kChunk combine the chunks'
// partial aggregates: a chunk's in-range slots are again one run.
//
// Page prefix, sum mode: once a page, one block-wide inclusive scan of the
// masked group sums (warp shuffles a segment, plus each warp's offset); a
// lane's sum is the scan at its last whole group plus at most 7 slots.
//
// What bounds them on the H100: bytes, the lanes' bounds and outputs and
// each touched page (keys, and values in the value modes) read once.
//
// Arithmetic: signed int32 overflow is undefined in C++, so int32 sums
// accumulate in uint32_t and convert at the store; that is the reference's
// two's-complement wrap, bit-exact in any order. Float sums accumulate in
// double and round to float once at the store. The order of the adds
// (edge slots, tree nodes, scan) differs from a slot-order sum only in
// the last bits of the double, which the rounding to float almost always
// hides. The reference sums in float32 in its own order: the two agree
// within its rtol 1e-4 (tests/test_engine_scan.py), not bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_page.cuh"

namespace {

using sorted_page::from_bits;
using sorted_page::kChunk;
using sorted_page::kPadded;
using sorted_page::lower_bound;
using sorted_page::page_walk;
using sorted_page::stage_rows;
using sorted_page::upper_bound_le;

template <typename V> struct Acc;
template <> struct Acc<int32_t> { using T = uint32_t; };
template <> struct Acc<float> { using T = double; };

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

// min / max as jnp.min / jnp.max combine: NaN propagates (fminf / fmaxf
// would drop it), and for float32 -0.0 ranks below +0.0 in either order
// (a compare alone ties them and keeps whichever came second), so the
// result is the reference's bits whatever order the tree and tables fold
// in. int32: a != a is false, the plain compare.
template <typename V> __device__ __forceinline__ V nan_min(V a, V b) {
  return (a < b || a != a) ? a : b;
}
template <typename V> __device__ __forceinline__ V nan_max(V a, V b) {
  return (a > b || a != a) ? a : b;
}
template <> __device__ __forceinline__ float nan_min<float>(float a, float b) {
  return (a < b || a != a || (a == b && __float_as_int(a) < 0)) ? a : b;
}
template <> __device__ __forceinline__ float nan_max<float>(float a, float b) {
  return (a > b || a != a || (a == b && __float_as_int(a) >= 0)) ? a : b;
}

// Value slots a group: the structures are built over group aggregates,
// and a lane adds the at most kGroup - 1 slots at each end of its run.
constexpr int kGroup = 8;
constexpr int kGroups = kChunk / kGroup;        // 256
constexpr int kLogGroups = 8;                   // log2(kGroups)

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

// ------------------------------------------------------------- page scan
template <typename K>
__global__ void __launch_bounds__(1024)
    scan_count_kernel(const K* __restrict__ lo, const K* __restrict__ hi,
                      const int* __restrict__ step_pages,
                      const K* __restrict__ kpages,
                      const int* __restrict__ steps_used,
                      int* __restrict__ lt_out, int* __restrict__ le_out,
                      int grid, int lw_pad, bool vec) {
  __shared__ K kc[kPadded];
  const K* const in[2] = {lo, hi};
  int lt = 0, le = 0;
  page_walk<2>(
      in, step_pages, steps_used, grid, lw_pad,
      [&](size_t off, int len) { stage_rows(kc, kpages + off, len, vec); },
      [&](int len, const K* x) {
        lt += lower_bound(kc, len, x[0]);
        le += upper_bound_le(kc, len, x[1]);
      },
      [&](size_t lane, int) {
        lt_out[lane] = lt;
        le_out[lane] = le;
        lt = le = 0;
      });
}

// A lane's partial aggregates over the masked values it has taken.
template <typename V, bool kFull, bool kMask>
struct RangeAgg {
  typename Acc<V>::T sum;
  V mn, mx;
  V mask;

  __device__ __forceinline__ void reset() {
    sum = 0;
    mn = min_identity<V>();
    mx = max_identity<V>();
  }
  __device__ __forceinline__ void slot(V v) {
    if (kMask && v == mask) return;
    sum += static_cast<typename Acc<V>::T>(v);
    if (kFull) {
      mn = nan_min(mn, v);
      mx = nan_max(mx, v);
    }
  }
};

// At least one block of 1024 threads a SM: up to 64 registers a thread
// (ptxas capped the full modes at 32, with spills, without the minimum).
template <typename K, typename V, bool kFull, bool kMask>
__global__ void __launch_bounds__(1024, 1)
    scan_values_kernel(const K* __restrict__ lo, const K* __restrict__ hi,
                       const int* __restrict__ step_pages,
                       const K* __restrict__ kpages,
                       const V* __restrict__ vpages,
                       const int* __restrict__ steps_used, int mask_bits,
                       int* __restrict__ lt_out, int* __restrict__ le_out,
                       V* __restrict__ sum_out, V* __restrict__ min_out,
                       V* __restrict__ max_out, int grid, int lw_pad,
                       bool vec) {
  using A = typename Acc<V>::T;
  constexpr int kLevels = kFull ? kLogGroups : 1;   // sparse-table levels
  __shared__ K kc[kPadded];
  __shared__ __align__(16) V vc[kChunk];
  // segment tree: node 1 the root, nodes [kGroups, 2 kGroups) the groups
  __shared__ A tree[2 * kGroups];
  // level j, entry i: min / max of groups [i, i + 2^j)
  __shared__ V tmin[kLevels][kGroups];
  __shared__ V tmax[kLevels][kGroups];
  const K* const in[2] = {lo, hi};
  RangeAgg<V, kFull, kMask> agg;
  agg.mask = from_bits<V>(mask_bits);
  agg.reset();
  int lt = 0, le = 0;

  auto stage = [&](size_t off, int len) {
    stage_rows(kc, kpages + off, len, vec, vc, vpages + off);
    __syncthreads();
    for (int i = threadIdx.x; i < kGroups; i += blockDim.x) {
      RangeAgg<V, kFull, kMask> grp;           // groups past len stay empty
      grp.mask = agg.mask;
      grp.reset();
      for (int s = i * kGroup; s < min(i * kGroup + kGroup, len); ++s)
        grp.slot(vc[s]);
      tree[kGroups + i] = grp.sum;
      if (kFull) {
        tmin[0][i] = grp.mn;
        tmax[0][i] = grp.mx;
      }
    }
    for (int j = 1; j <= kLogGroups; ++j) {      // one barrier a level
      __syncthreads();
      const int n0 = kGroups >> j;
      for (int i = threadIdx.x; i < n0; i += blockDim.x)
        tree[n0 + i] = tree[2 * (n0 + i)] + tree[2 * (n0 + i) + 1];
      if (kFull && j < kLevels) {
        const int w = 1 << (j - 1);
        for (int i = threadIdx.x; i + 2 * w <= kGroups; i += blockDim.x) {
          tmin[j][i] = nan_min(tmin[j - 1][i], tmin[j - 1][i + w]);
          tmax[j][i] = nan_max(tmax[j - 1][i], tmax[j - 1][i + w]);
        }
      }
    }
  };

  auto chunk = [&](int len, const K* x) {
    const int a = lower_bound(kc, len, x[0]);
    const int b = upper_bound_le(kc, len, x[1]);
    lt += a;
    le += b;
    if (b <= a) return;                 // empty run (an inert pair too)
    // whole groups [ga, gb), edge slots [a, kGroup ga) and [kGroup gb, b)
    const int ga = (a + kGroup - 1) / kGroup, gb = b / kGroup;
    const bool whole = ga < gb;
    for (int s = a; s < (whole ? ga * kGroup : b); ++s) agg.slot(vc[s]);
    if (!whole) return;
    for (int s = gb * kGroup; s < b; ++s) agg.slot(vc[s]);
    A t = 0;
    for (int l = ga + kGroups, r = gb + kGroups; l < r; l >>= 1, r >>= 1) {
      if (l & 1) t += tree[l++];
      if (r & 1) t += tree[--r];
    }
    agg.sum += t;
    if (kFull) {                        // two windows of 2^k cover the run
      const int k = min(31 - __clz(gb - ga), kLevels - 1);
      const int b2 = gb - (1 << k);
      agg.mn = nan_min(agg.mn, nan_min(tmin[k][ga], tmin[k][b2]));
      agg.mx = nan_max(agg.mx, nan_max(tmax[k][ga], tmax[k][b2]));
    }
  };

  page_walk<2>(in, step_pages, steps_used, grid, lw_pad, stage, chunk,
               [&](size_t lane, int) {
                 lt_out[lane] = lt;
                 le_out[lane] = le;
                 sum_out[lane] = static_cast<V>(agg.sum);  // double rounds
                 if (kFull) {                              // once here
                   min_out[lane] = agg.mn;
                   max_out[lane] = agg.mx;
                 }
                 lt = le = 0;
                 agg.reset();
               });
}

// ----------------------------------------------------------- page prefix
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

// The inclusive scan of the masked group sums of a staged value row, in
// the accumulator type. Warp w scans groups [w * seg, (w + 1) * seg) in
// rounds of one group a lane with warp shuffles and a carry; woff[w] is
// the exclusive prefix of the warps' totals, so the sum of groups [0, g]
// is sc[g] + woff[g / seg]. Starts and ends with a barrier.
template <typename V, bool kMask>
__device__ __forceinline__ void group_scan(const V* vc,
                                           typename Acc<V>::T* sc,
                                           typename Acc<V>::T* woff, int len,
                                           V mask, int seg) {
  using A = typename Acc<V>::T;
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
}

template <typename K, typename V, bool kMask>
__global__ void __launch_bounds__(1024)
    prefix_sum_kernel(const K* __restrict__ e,
                      const int* __restrict__ step_pages,
                      const K* __restrict__ kpages,
                      const V* __restrict__ vpages,
                      const int* __restrict__ steps_used, int mask_bits,
                      int* __restrict__ lt_out, V* __restrict__ sum_out,
                      int grid, int lw_pad, bool vec) {
  using A = typename Acc<V>::T;
  __shared__ K kc[kPadded];
  __shared__ __align__(16) V vc[kChunk];
  __shared__ A sc[kGroups];
  __shared__ A woff[32];
  const K* const in[1] = {e};
  const int nw = (blockDim.x + 31) >> 5;
  const V mask = from_bits<V>(mask_bits);
  int lt = 0;
  A psum = A(0);
  page_walk<1>(
      in, step_pages, steps_used, grid, lw_pad,
      [&](size_t off, int len) {
        stage_rows(kc, kpages + off, len, vec, vc, vpages + off);
        group_scan<V, kMask>(vc, sc, woff, len, mask,
                             ((len + kGroup - 1) / kGroup + nw - 1) / nw);
      },
      [&](int len, const K* x) {
        const int seg = ((len + kGroup - 1) / kGroup + nw - 1) / nw;
        const int c = lower_bound(kc, len, x[0]);
        const int whole = c / kGroup;     // groups entirely below the edge
        lt += c;
        if (whole > 0) psum += sc[whole - 1] + woff[(whole - 1) / seg];
        psum += slot_sum<V, kMask>(vc, whole * kGroup, c, mask);
      },
      [&](size_t lane, int) {
        lt_out[lane] = lt;
        sum_out[lane] = static_cast<V>(psum);
        lt = 0;
        psum = A(0);
      });
}

// ---------------------------------------------------------------- launch
struct ScanArgs {
  const void *lo, *hi, *step_pages, *kpages, *vpages, *steps_used;
  int mask_bits;
  void *lt, *le, *vsum, *vmin, *vmax;
  int grid, tq, lw_pad;
  bool vec;
  cudaStream_t stream;
};

template <typename K, typename V, bool kFull, bool kMask>
int launch_values(const ScanArgs& a) {
  return sorted_page::launch(
      scan_values_kernel<K, V, kFull, kMask>, a.grid, a.tq, a.stream,
      static_cast<const K*>(a.lo), static_cast<const K*>(a.hi),
      static_cast<const int*>(a.step_pages), static_cast<const K*>(a.kpages),
      static_cast<const V*>(a.vpages), static_cast<const int*>(a.steps_used),
      a.mask_bits, static_cast<int*>(a.lt), static_cast<int*>(a.le),
      static_cast<V*>(a.vsum), static_cast<V*>(a.vmin),
      static_cast<V*>(a.vmax), a.grid, a.lw_pad, a.vec);
}

template <typename K, typename V>
int dispatch_values(const ScanArgs& a, bool full, bool has_mask) {
  if (full)
    return has_mask ? launch_values<K, V, true, true>(a)
                    : launch_values<K, V, true, false>(a);
  return has_mask ? launch_values<K, V, false, true>(a)
                  : launch_values<K, V, false, false>(a);
}

template <typename K>
int dispatch_scan(const ScanArgs& a, int val_f32, int mode, bool has_mask) {
  if (mode == 0)
    return sorted_page::launch(
        scan_count_kernel<K>, a.grid, a.tq, a.stream,
        static_cast<const K*>(a.lo), static_cast<const K*>(a.hi),
        static_cast<const int*>(a.step_pages),
        static_cast<const K*>(a.kpages),
        static_cast<const int*>(a.steps_used), static_cast<int*>(a.lt),
        static_cast<int*>(a.le), a.grid, a.lw_pad, a.vec);
  return val_f32 ? dispatch_values<K, float>(a, mode == 2, has_mask)
                 : dispatch_values<K, int32_t>(a, mode == 2, has_mask);
}

struct PrefixArgs {
  const void *e, *step_pages, *kpages, *vpages, *steps_used;
  int mask_bits;
  void *lt, *psum;
  int grid, tq, lw_pad;
  bool vec;
  cudaStream_t stream;
};

template <typename K, typename V, bool kMask>
int launch_prefix_sum(const PrefixArgs& a) {
  return sorted_page::launch(
      prefix_sum_kernel<K, V, kMask>, a.grid, a.tq, a.stream,
      static_cast<const K*>(a.e), static_cast<const int*>(a.step_pages),
      static_cast<const K*>(a.kpages), static_cast<const V*>(a.vpages),
      static_cast<const int*>(a.steps_used), a.mask_bits,
      static_cast<int*>(a.lt), static_cast<V*>(a.psum), a.grid, a.lw_pad,
      a.vec);
}

template <typename K, typename V>
int dispatch_prefix_sum(const PrefixArgs& a, bool has_mask) {
  return has_mask ? launch_prefix_sum<K, V, true>(a)
                  : launch_prefix_sum<K, V, false>(a);
}

template <typename K>
int dispatch_prefix(const PrefixArgs& a, int with_sum, int val_f32,
                    bool has_mask) {
  if (with_sum)
    return val_f32 ? dispatch_prefix_sum<K, float>(a, has_mask)
                   : dispatch_prefix_sum<K, int32_t>(a, has_mask);
  // the count: page * 0 + min(lt, lw_pad) = lt
  return sorted_page::launch(
      sorted_page::lower_bound_kernel<K>, a.grid, a.tq, a.stream,
      static_cast<const K*>(a.e), static_cast<const int*>(a.step_pages),
      static_cast<const K*>(a.kpages), static_cast<const int*>(a.steps_used),
      static_cast<int*>(a.lt), a.grid, a.lw_pad, 0, a.lw_pad, a.vec);
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
  if (lw_pad < 1 || tq < 1 || tq > 1024 || mode < 0 || mode > 2)
    return cudaErrorInvalidValue;
  if (grid == 0) return cudaSuccess;
  const ScanArgs a{lo, hi, step_pages, kpages, vpages, steps_used,
                   mask_bits, lt, le, vsum, vmin, vmax, grid, tq, lw_pad,
                   sorted_page::vector_rows(lw_pad, kpages, vpages),
                   static_cast<cudaStream_t>(stream)};
  return key_f32 ? dispatch_scan<float>(a, val_f32, mode, has_mask != 0)
                 : dispatch_scan<int32_t>(a, val_f32, mode, has_mask != 0);
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
  const PrefixArgs a{e, step_pages, kpages, vpages, steps_used, mask_bits,
                     lt, psum, grid, tq, lw_pad,
                     sorted_page::vector_rows(lw_pad, kpages, vpages),
                     static_cast<cudaStream_t>(stream)};
  return key_f32 ? dispatch_prefix<float>(a, with_sum, val_f32, has_mask != 0)
                 : dispatch_prefix<int32_t>(a, with_sum, val_f32,
                                            has_mask != 0);
}

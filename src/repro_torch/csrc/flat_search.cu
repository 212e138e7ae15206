// The paper's flat index kinds searched on Hopper (sm_90a): one launch a
// search, in place of the port's eager chain of PyTorch ops (about three
// launches and a [Q, w] row gather a level, core/util.py take_rows).
//
// Replaces no pallas_call. Each kernel twins the XLA program that jax.jit
// makes of one of the reference's searchers:
//   flat_binary   src/repro/core/sorted_array.py:53  _search_pad
//   flat_descent  src/repro/core/css_tree.py:112     _search
//                 src/repro/core/kary.py:78          _search
//                 src/repro/core/fast_tree.py:109    _descend, with
//                 fast_tree.search's leaf count, or alone for leaf_page_of
//   csb_search    src/repro/core/csb_tree.py:213     _search
//
// Exactness. Every count compares keys with `<` (or `==`) in their own
// type and does no arithmetic on them, so a rank is bit-identical to the
// plain version's for duplicate runs, the int32-max / +inf sentinel, a NaN
// query (below nothing: rank 0), -0.0 against +0.0 and subnormals (IEEE;
// the build has no fast-math or flush-to-zero flag). Index arithmetic is
// the plain version's int32 arithmetic (wrapping, done in unsigned), and
// every row index is clamped into its array as util.take clamps it; only
// the byte offset of a row is formed in 64 bits (a css w128 leaf array at
// 2^24 keys holds 129^3 x 129 slots, over 4 GB as bytes).
//
// Design (a simple one that is right first):
//   * flat_binary: one thread a query runs the branch-free lower bound over
//     the power-of-two padded array, steps n_pad / 2 down to `cutoff`, then
//     counts the `cutoff`-key tail block and clamps to n;
//   * flat_descent, intra="vector" (css; kary and FAST always): a group of
//     G lanes a query, G the power of two near w / 4, at most 4 (w <= 4:
//     1; w 5-8: 2; wider: 4). At each level the group reads the query's
//     node, lane s keys s, s + G, ... (four rounds of loads in flight: a
//     w 16 node in one round trip, a w 128 node in eight), and counts the
//     keys below q by __popc of the group's bits of __ballot_sync: the
//     k-ary SIMD compare. Few lanes a query keep many queries in flight,
//     which is what sets the time: on an H100 a css w 128 search of 2^20
//     queries took 0.67 ms with a warp a query, 0.38 with 4 lanes
//     (experiments/flat_variants.py). intra="binary" (css) is the paper's
//     binary range search: one thread a query, kernel 2's lower bound
//     (sorted_row.cuh) in each node and in the leaf block. The rows and
//     the leaf blocks are sorted by construction, so both give the plain
//     version's count. Then j = j * fanout + c.
//     Where a node lies is a table of the index's levels, built once an
//     index on the host and passed by value: css and kary take
//     row = level_offsets[l] / w + j; FAST starts a page at each
//     page-level group, row = page_row[g] + j * page_rows[g]
//     + level_row[l] + j_local. The ending: j itself (kary), the leaf
//     block's count (css, FAST: rank = j * leaf_width + count), or the
//     descent alone (FAST's leaf_page_of);
//   * csb_search: a group of lanes a query (as above: 2 at w 8) follows
//     `child`, keeps its node on a ragged path (base < 0) and returns
//     whether the leaf holds q (a count of the keys equal to it).
// The level loop is warp-uniform (one index a launch), so every ballot has
// the whole warp; lanes past the batch take part with a false predicate.
//
// What bounds it on the H100: bytes. Each query is read once and its rank
// written once, and each level reads a node (w keys) the queries share
// near the root and scatter near the leaves; the compares are a few
// hundred a query against the card's 33.5e12 a second.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_row.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 64;       // any tree of fanout >= 2 over < 2^63 keys
constexpr long long kMaxBlocks = 1 << 20;   // a grid-stride loop does the rest
constexpr unsigned kFull = 0xffffffffu;
// rounds of a group's loads in flight at once (the wrapper's ROUNDS)
constexpr int kRounds = 4;

enum Ending { kRank = 0, kLeafCount = 1, kDescent = 2 };

// Where each level's node lies, in rows of w keys. A level whose bit is
// set in `starts` begins a page: page = page_row[l] + j * page_rows[l],
// and the in-page node index j_local restarts at 0. The node is row
// page + level_row[l] + j_local. (css and kary: every level starts a page
// of one row, page_row[l] = level_offsets[l] / w.)
struct Levels {
  int page_row[kMaxLevels];
  int page_rows[kMaxLevels];
  int level_row[kMaxLevels];
  unsigned long long starts;
};

// util.take's clamp of a row index into [0, rows - 1].
__device__ __forceinline__ int clamp_row(int r, int rows) {
  return r < 0 ? 0 : (r >= rows ? rows - 1 : r);
}

// The lanes of a query's group: `group` lanes of one warp, aligned.
struct Group {
  int sub;          // this lane's place in the group
  unsigned mask;    // the group's bits in a ballot
  __device__ explicit Group(int group) {
    const int lane = threadIdx.x & 31;
    sub = lane & (group - 1);
    mask = (group == 32 ? kFull : (1u << group) - 1u) << (lane - sub);
  }
};

// #{i < width : pred(row[i])}, counted by the group: lane `sub` reads keys
// sub, sub + G, ... and the group adds its bits of each round's ballot,
// kRounds rounds' loads in flight before their ballots. Every lane of the
// warp calls it with the same width (the ballot takes the whole warp); a
// lane with `live` false counts nothing and reads nothing.
template <typename T, typename Pred>
__device__ __forceinline__ int group_count(const T* row, int width,
                                           bool live, const Group& g,
                                           int group, Pred pred) {
  int c = 0;
  for (int k = 0; k < width; k += kRounds * group) {
    bool hit[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int i = k + r * group + g.sub;
      hit[r] = live && i < width && pred(__ldg(row + i));
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r)
      c += __popc(__ballot_sync(kFull, hit[r]) & g.mask);
  }
  return c;
}

// First query of this warp, and the warps of the grid, for a grid-stride
// loop whose condition is the same on every lane of a warp.
__device__ __forceinline__ long long warp_first(int per_warp) {
  return ((static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >>
          5) * per_warp;
}
__device__ __forceinline__ long long grid_queries(int per_warp) {
  return ((static_cast<long long>(gridDim.x) * blockDim.x) >> 5) * per_warp;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flat_binary_kernel(const T* __restrict__ q, long long n_q,
                   const T* __restrict__ keys, int n_keys, int n_pad,
                   int cutoff, int n, int* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int last = cutoff > 1 ? cutoff : 1;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < n_q; t += stride) {
    const T qv = q[t];
    unsigned pos = 0;
    for (int step = n_pad / 2; step >= last; step /= 2) {
      const int at = clamp_row(static_cast<int>(pos + step - 1), n_keys);
      pos = __ldg(keys + at) < qv ? pos + step : pos;
    }
    if (cutoff > 1) {          // the tail block, counted key by key
      unsigned c = 0;
      for (int i = 0; i < cutoff; ++i)
        c += __ldg(keys + clamp_row(static_cast<int>(pos + i), n_keys)) < qv;
      pos += c;
    }
    const int rank = static_cast<int>(pos);
    out[t] = rank < n ? rank : n;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flat_descent_kernel(const T* __restrict__ q, long long n_q,
                    const T* __restrict__ nodes, int n_rows, int w,
                    unsigned fanout, int depth,
                    const __grid_constant__ Levels lv, int binary, int group,
                    const T* __restrict__ leaves, int n_leaves,
                    int leaf_width, int ending, int n,
                    int* __restrict__ out) {
  const Group g(group);
  const int per_warp = 32 / group;
  const long long stride = grid_queries(per_warp);
  for (long long base = warp_first(per_warp); base < n_q; base += stride) {
    const long long qi = base + (threadIdx.x & 31) / group;
    const bool live = qi < n_q;
    const T qv = live ? q[qi] : T(0);
    unsigned j = 0, j_local = 0, page = 0;
    for (int l = 0; l < depth; ++l) {
      if ((lv.starts >> l) & 1ull) {
        page = static_cast<unsigned>(lv.page_row[l]) +
               j * static_cast<unsigned>(lv.page_rows[l]);
        j_local = 0;
      }
      const int r = clamp_row(
          static_cast<int>(page + static_cast<unsigned>(lv.level_row[l]) +
                           j_local),
          n_rows);
      const T* row = nodes + static_cast<long long>(r) * w;
      const unsigned c =
          binary ? (live ? sorted_row::lower_bound<true>(row, w, qv) : 0)
                 : group_count(row, w, live, g, group,
                               [qv](T k) { return k < qv; });
      j = j * fanout + c;
      j_local = j_local * fanout + c;
    }
    int rank = static_cast<int>(j);
    if (ending == kLeafCount) {
      const T* blk =
          leaves + static_cast<long long>(clamp_row(rank, n_leaves)) *
                       leaf_width;
      // a leaf block is sorted too: one lane's lower bound (binary), or
      // the group's count
      const unsigned c =
          binary ? (live ? sorted_row::lower_bound<true>(blk, leaf_width, qv)
                         : 0)
                 : group_count(blk, leaf_width, live, g, group,
                               [qv](T k) { return k < qv; });
      rank = static_cast<int>(j * static_cast<unsigned>(leaf_width) + c);
    }
    if (ending != kDescent && rank > n) rank = n;
    if (live && g.sub == 0) out[qi] = rank;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
csb_search_kernel(const T* __restrict__ q, long long n_q,
                  const T* __restrict__ keys, const int* __restrict__ child,
                  const T* __restrict__ leaf_keys, int n_nodes, int w,
                  int root, int height, int group, bool* __restrict__ out) {
  const Group g(group);
  const int per_warp = 32 / group;
  const long long stride = grid_queries(per_warp);
  for (long long base = warp_first(per_warp); base < n_q; base += stride) {
    const long long qi = base + (threadIdx.x & 31) / group;
    const bool live = qi < n_q;
    const T qv = live ? q[qi] : T(0);
    int nid = root;
    for (int h = 0; h < height - 1; ++h) {
      const int r = clamp_row(nid, n_nodes);
      const unsigned c =
          group_count(keys + static_cast<long long>(r) * w, w, live, g,
                      group, [qv](T k) { return k < qv; });
      const int b = __ldg(child + r);
      nid = b < 0 ? nid : static_cast<int>(static_cast<unsigned>(b) + c);
    }
    const T* leaf =
        leaf_keys + static_cast<long long>(clamp_row(nid, n_nodes)) * w;
    const int hits = group_count(leaf, w, live, g, group,
                                 [qv](T k) { return k == qv; });
    if (live && g.sub == 0) out[qi] = hits != 0;
  }
}

bool is_group(int group) {
  return group >= 1 && group <= 32 && (group & (group - 1)) == 0;
}

int blocks_for(long long threads) {
  const long long want = (threads + kThreads - 1) / kThreads;
  return static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
}

template <typename T>
int launch_binary(const void* q, long long n_q, const void* keys,
                  int n_keys, int n_pad, int cutoff, int n, void* out,
                  void* stream) {
  if (n_q < 0 || n_keys < 1 || n_pad < 1 || cutoff < 1) {
    return cudaErrorInvalidValue;
  }
  if (n_q == 0) return cudaSuccess;
  flat_binary_kernel<T><<<blocks_for(n_q), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), n_q, static_cast<const T*>(keys), n_keys,
      n_pad, cutoff, n, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_descent(const void* q, long long n_q, const void* nodes,
                   int n_rows, int w, int fanout, int depth,
                   const int* page_row, const int* page_rows,
                   const int* level_row, unsigned long long starts,
                   int binary_intra, int group, const void* leaves,
                   int n_leaves, int leaf_width, int ending, int n, void* out,
                   void* stream) {
  if (n_q < 0 || w < 1 || fanout < 2 || depth < 0 || depth > kMaxLevels ||
      (depth > 0 && n_rows < 1) || !is_group(group) || ending < kRank ||
      ending > kDescent ||
      (ending == kLeafCount && (n_leaves < 1 || leaf_width < 1))) {
    return cudaErrorInvalidValue;
  }
  if (n_q == 0) return cudaSuccess;
  Levels lv = {};
  for (int l = 0; l < depth; ++l) {
    lv.page_row[l] = page_row[l];
    lv.page_rows[l] = page_rows[l];
    lv.level_row[l] = level_row[l];
  }
  lv.starts = starts;
  flat_descent_kernel<T><<<blocks_for(n_q * group), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), n_q, static_cast<const T*>(nodes), n_rows, w,
      static_cast<unsigned>(fanout), depth, lv, binary_intra, group,
      static_cast<const T*>(leaves), n_leaves, leaf_width, ending, n,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_csb(const void* q, long long n_q, const void* keys,
               const void* child, const void* leaf_keys, int n_nodes, int w,
               int root, int height, int group, void* out, void* stream) {
  if (n_q < 0 || n_nodes < 1 || w < 1 || height < 1 || !is_group(group)) {
    return cudaErrorInvalidValue;
  }
  if (n_q == 0) return cudaSuccess;
  csb_search_kernel<T><<<blocks_for(n_q * group), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), n_q, static_cast<const T*>(keys),
      static_cast<const int*>(child), static_cast<const T*>(leaf_keys),
      n_nodes, w, root, height, group, static_cast<bool*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, one a key type (i32, f32, i64, f64). Pointers are device
// pointers, except the level table of flat_descent (`depth` entries each,
// host memory, copied into the launch's arguments); the stream is the
// caller's. Each returns cudaGetLastError() after the launch (0: launched;
// nothing is launched for n_q == 0).
#define FLAT_SEARCH_ENTRIES(SUFFIX, T)                                       \
  extern "C" int flat_binary_##SUFFIX(const void* q, long long n_q,          \
                                      const void* keys, int n_keys,          \
                                      int n_pad, int cutoff, int n,          \
                                      void* out, void* stream) {             \
    return launch_binary<T>(q, n_q, keys, n_keys, n_pad, cutoff, n, out,     \
                            stream);                                         \
  }                                                                          \
  extern "C" int flat_descent_##SUFFIX(                                      \
      const void* q, long long n_q, const void* nodes, int n_rows, int w,    \
      int fanout, int depth, const int* page_row, const int* page_rows,      \
      const int* level_row, unsigned long long starts, int binary_intra,     \
      int group, const void* leaves, int n_leaves, int leaf_width,           \
      int ending, int n, void* out, void* stream) {                          \
    return launch_descent<T>(q, n_q, nodes, n_rows, w, fanout, depth,        \
                             page_row, page_rows, level_row, starts,         \
                             binary_intra, group, leaves, n_leaves,          \
                             leaf_width, ending, n, out, stream);            \
  }                                                                          \
  extern "C" int csb_search_##SUFFIX(                                        \
      const void* q, long long n_q, const void* keys, const void* child,     \
      const void* leaf_keys, int n_nodes, int w, int root, int height,       \
      int group, void* out, void* stream) {                                  \
    return launch_csb<T>(q, n_q, keys, child, leaf_keys, n_nodes, w, root,   \
                         height, group, out, stream);                        \
  }

FLAT_SEARCH_ENTRIES(i32, int32_t)
FLAT_SEARCH_ENTRIES(f32, float)
FLAT_SEARCH_ENTRIES(i64, long long)
FLAT_SEARCH_ENTRIES(f64, double)

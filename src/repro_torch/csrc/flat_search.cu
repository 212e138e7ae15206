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
// plain version's for duplicate runs, the int-max / +inf sentinel, a NaN
// query (below nothing: rank 0), -0.0 against +0.0 and subnormals (IEEE;
// the build has no fast-math or flush-to-zero flag). Index arithmetic is
// the plain version's int32 arithmetic (wrapping, done in unsigned), and
// every row index is clamped into its array as util.take clamps it; only
// the offset of a row is formed in 64 bits. Every array the searches read
// is sorted and padded with the sentinel (a node row, a leaf block,
// keys_pad), so `k < q` holds on a prefix of it: a row's count is its
// lower bound, and a sorted sample of the row picks the one block of it
// that holds the bound. A key below no query (the int max; +inf or NaN)
// is dead: a node whose first key is dead counts 0 for every query.
//
// What bounds them on the H100: the round trips of a query's dependent
// loads, and the sectors each one touches. One thread a query, so a warp's
// loads scatter over 32 rows, each its own transaction; a sector past the
// 50 MB L2 comes from device memory. The first design read every key of
// every node (a css w 128 search: 3 directory rows of 512 B and a leaf
// block of 516 B, 16 sectors a level, 4 lanes a query) and staged nothing:
// 0.38 ms for 2^20 queries at 2^24 keys, 2.5x torch.searchsorted. This
// design reads a few sectors a level and keeps more queries in flight:
//   * flat_descent: the first levels (the largest prefix of `nodes` that
//     holds whole levels, or FAST's whole page groups, within the
//     wrapper's STAGE_BYTES) are copied once a block into shared memory,
//     rows padded against bank conflicts (sorted_row::padded_stride), by a
//     persistent grid whose blocks walk the queries a grid apart; a batch
//     too small to fill that grid reads them in place, in blocks of whole
//     warps small enough to reach every SM. Below them a node
//     wider than whole_keys (a 64-byte block and a key) is read in two
//     steps: its row of `sample` (the last key of every block but the
//     row's last: 32 bytes at w 128, L2-resident) counts the blocks
//     wholly below q, then that one block is counted: 2-3 sectors in place
//     of 16. A narrower node, and the block, is read in one round of
//     16-byte loads through the aligned pieces that cover it, masked to it
//     (rows of w 127 or 15 keys and leaf blocks of 129 or 17 are not
//     16-byte aligned); a staged one by independent loads from shared
//     memory. The leaf block of css and FAST is read the same way through
//     its own sample rows; a block j with j * leaf_width >= n is not read
//     (the clamp gives n), nor a node past its level's live nodes (count
//     0). intra="binary" keeps the paper's binary range search: one
//     thread's lower bound in each node and leaf block. The ending: j
//     itself (kary), the leaf block's count (css, FAST: rank = j *
//     leaf_width + count), or the descent alone (FAST's leaf_page_of).
//     Each thread keeps two queries in flight: 0.10-0.11 ms at w 127-128;
//   * flat_binary: kernel 6's scheme, through the steps both kernels take
//     from staged_bound.cuh (nitrogen_template.cuh ng_lower_bound), over
//     keys_pad: the probe keys of the first levels, in Eytzinger order,
//     copied into shared memory by a persistent grid; then one
//     probe a level of `sample` (the last key of every 32-byte window of
//     keys_pad up to its first dead key: 8 MB at 2^24 int32 keys,
//     L2-resident), one 32-byte window of the sample for the next levels,
//     and one of keys_pad for the last: one sector of the keys a query
//     from device memory. A cutoff wider than the window counts its tail
//     block 16 bytes a load: 0.073 ms, half of searchsorted's;
//   * csb_search: one thread a query follows `child`, keeps its node on a
//     ragged path (base < 0) and returns whether the leaf holds q (a count
//     of the keys equal to it). The tree's first inner levels are copied
//     once a snapshot into a stage in breadth-first order (each staged
//     node's key row, sentinel padded to whole 16-byte pieces, and its
//     link: its first child's place in the stage, or at the last staged
//     level its child group's id), which a persistent grid copies into
//     shared memory (five levels, 128 KB, of a 2^20-key tree at w 8) and a
//     smaller batch reads in place. Below the stage a level issues the
//     node's row (16-byte loads: two at w 8 and 4-byte keys) and its
//     `child` entry together: one round trip a level, then one for the
//     leaf: 0.040 ms for 2^20 queries against 0.066 for the first design.
// flat_descent keeps two queries a thread in flight under the persistent
// grid (kDescentQueries) and one in place, flat_binary and csb_search one:
// the faster on the H100; lane groups of 4 a query, or 4 queries a thread,
// were slower at every width, and csb_search's register cap for a second
// resident block spilled and lost (PERF.md §6). Past that, each query's
// chain of dependent loads bounds them: a few round trips to L2 a level,
// and the sectors of the last levels and the leaf blocks from device
// memory (PERF.md §7).
#include <cuda_runtime.h>
#include <stdint.h>

#include "persistent.cuh"
#include "sorted_row.cuh"
#include "staged_bound.cuh"

namespace {

constexpr int kThreads = 256;        // a block of a grid-stride launch
constexpr int kStageThreads = 512;   // a block of a persistent launch
constexpr int kMaxLevels = 64;       // any tree of fanout >= 2 over < 2^63 keys
constexpr long long kMaxBlocks = 1 << 20;   // a grid-stride loop does the rest
constexpr int kUnroll = 5;           // 16-byte loads a lane issues at once
constexpr int kDescentQueries = 2;   // queries a thread keeps in flight
constexpr int kCsbBlocks = 1;        // csb_search's resident blocks an SM

enum Ending { kRank = 0, kLeafCount = 1, kDescent = 2 };

// Where each level's node lies, in rows of w keys. A level whose bit is
// set in `starts` begins a page: page = page_row[l] + j * page_rows[l],
// and the in-page node index j_local restarts at 0. The node is row
// page + level_row[l] + j_local. (css and kary: every level starts a page
// of one row, page_row[l] = level_offsets[l] / w.) Node j of level l (j the
// descent's index before the level) counts 0 unless j < live[l]; its
// sample row is sample_row[l] + j. Levels below stage_levels lie in the
// first stage_rows rows.
struct Levels {
  int page_row[kMaxLevels];
  int page_rows[kMaxLevels];
  int level_row[kMaxLevels];
  int live[kMaxLevels];
  int sample_row[kMaxLevels];
  unsigned long long starts;
  int stage_levels;
  int stage_rows;
};

// util.take's clamp of a row index into [0, rows - 1].
__device__ __forceinline__ int clamp_row(int r, int rows) {
  return r < 0 ? 0 : (r >= rows ? rows - 1 : r);
}

template <typename T>
struct alignas(16) Vec {
  T k[16 / sizeof(T)];
};

// the 16 bytes of keys at p (16-byte aligned), through the read-only path
template <typename T>
__device__ __forceinline__ Vec<T> load_vec(const T* p) {
  union {
    int4 raw;
    Vec<T> v;
  } u;
  u.raw = __ldg(reinterpret_cast<const int4*>(p));
  return u.v;
}

// k < q, or k == q for kEqual
template <bool kEqual, typename T>
__device__ __forceinline__ bool hit(T k, T q) {
  return kEqual ? k == q : k < q;
}

// #{x in [from[i], to[i]) : a[x] < q[i]} (kEqual: a[x] == q[i]) for each
// of a thread's I queries (ranges of at most `most` keys, a bound the whole
// warp shares): the aligned 16-byte pieces that cover a range, masked to
// it, counted by __popc; a piece that would run past the array's `size`
// keys is read key by key. The loads of kUnroll pieces a query (a block of
// kBlock keys at any alignment) are issued before their compares. `a` is
// 16-byte aligned.
template <typename T, int I, bool kEqual = false>
__device__ __forceinline__ void count_range(const T* __restrict__ a,
                                            long long size,
                                            const long long (&from)[I],
                                            const long long (&to)[I],
                                            int most, const T (&q)[I],
                                            const bool (&on)[I],
                                            int (&c)[I]) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  long long base[I];
#pragma unroll
  for (int i = 0; i < I; ++i) {
    c[i] = 0;
    base[i] = from[i] - from[i] % V;
  }
  const int pieces = (most + 2 * V - 2) / V;    // at any alignment
  for (int h0 = 0; h0 < pieces; h0 += kUnroll) {
    Vec<T> v[kUnroll][I];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int i = 0; i < I; ++i) {
        const long long at = base[i] + static_cast<long long>(h0 + u) * V;
        if (on[i] && at < to[i] && at + V <= size) v[u][i] = load_vec(a + at);
      }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int i = 0; i < I; ++i) {
        const long long at = base[i] + static_cast<long long>(h0 + u) * V;
        if (!on[i] || at >= to[i]) continue;
        // the piece's keys t in [lo, hi) lie in the range
        const int lo = from[i] > at ? static_cast<int>(from[i] - at) : 0;
        const int hi = to[i] - at < V ? static_cast<int>(to[i] - at) : V;
        const unsigned mask = ((1u << hi) - 1u) & ~((1u << lo) - 1u);
        unsigned below = 0;
        if (at + V <= size) {
#pragma unroll
          for (int t = 0; t < V; ++t)
            below |= static_cast<unsigned>(hit<kEqual>(v[u][i].k[t], q[i]))
                     << t;
        } else {
          for (int t = 0; t < V; ++t)
            if (at + t < size && (mask >> t & 1u))
              below |= static_cast<unsigned>(hit<kEqual>(__ldg(a + at + t),
                                                         q[i]))
                       << t;
        }
        c[i] += __popc(below & mask);
      }
  }
}

// Keys of a row counted whole, in one round of loads: kUnroll pieces
// cover kBlock + 1 keys at any alignment. A wider row is read through its
// sample.
template <typename T>
__host__ __device__ constexpr int whole_keys() {
  return 64 / static_cast<int>(sizeof(T)) + 1;
}

// #{x < width : a[row[i] + x] < q[i]} of each query's sorted row. A row
// wider than whole_keys reads its sample row first (sample_width keys at
// samp[i]: the last key of each of its kBlock-key blocks but the last,
// then dead pads), whose count b is the number of blocks wholly below q;
// the bound lies in block b, which is counted next. A narrower row is
// counted whole.
template <typename T, int I>
__device__ __forceinline__ void row_count(
    const T* __restrict__ a, long long size, const long long (&row)[I],
    int width, const T* __restrict__ sample, long long sample_size,
    const long long (&samp)[I], int sample_width, const T (&q)[I],
    const bool (&on)[I], int (&c)[I]) {
  constexpr int kBlock = 64 / static_cast<int>(sizeof(T));
  long long from[I], to[I];
  if (width > whole_keys<T>()) {
    int b[I];
#pragma unroll
    for (int i = 0; i < I; ++i) {
      from[i] = samp[i];
      to[i] = samp[i] + sample_width;
    }
    count_range<T, I>(sample, sample_size, from, to, sample_width, q, on, b);
#pragma unroll
    for (int i = 0; i < I; ++i) {
      from[i] = row[i] + static_cast<long long>(b[i]) * kBlock;
      to[i] = from[i] + kBlock < row[i] + width ? from[i] + kBlock
                                                : row[i] + width;
    }
    count_range<T, I>(a, size, from, to, kBlock, q, on, c);
#pragma unroll
    for (int i = 0; i < I; ++i) c[i] += b[i] * kBlock;
  } else {
#pragma unroll
    for (int i = 0; i < I; ++i) {
      from[i] = row[i];
      to[i] = row[i] + width;
    }
    count_range<T, I>(a, size, from, to, width, q, on, c);
  }
}

// sorted_row::lower_bound over I rows at once (the same length), each
// query's loads in flight together; a query with `on` false reads nothing
// and counts 0
template <bool kGlobal, typename T, int I>
__device__ __forceinline__ void lower_bounds(const T* const (&rows)[I],
                                             int n, const T (&q)[I],
                                             const bool (&on)[I],
                                             int (&c)[I]) {
  int base[I];
#pragma unroll
  for (int i = 0; i < I; ++i) base[i] = 0;
  while (n > 1) {
    const int half = n >> 1;
#pragma unroll
    for (int i = 0; i < I; ++i)
      base[i] = on[i] && sorted_row::entry<kGlobal>(rows[i], base[i] + half) <
                             q[i]
                    ? base[i] + half
                    : base[i];
    n -= half;
  }
#pragma unroll
  for (int i = 0; i < I; ++i)
    c[i] = on[i] ? base[i] + (sorted_row::entry<kGlobal>(rows[i], base[i]) <
                              q[i])
                 : 0;
}

// #{x < n : row[x] < q} over I staged rows (padded as sorted_row pads
// them) of at most whole_keys keys: every load independent
template <typename T, int I>
__device__ __forceinline__ void staged_counts(const T* const (&rows)[I],
                                              int n, const T (&q)[I],
                                              const bool (&on)[I],
                                              int (&c)[I]) {
#pragma unroll
  for (int i = 0; i < I; ++i) c[i] = 0;
#pragma unroll
  for (int x = 0; x < whole_keys<T>(); ++x)
#pragma unroll
    for (int i = 0; i < I; ++i)
      c[i] += on[i] && x < n && sorted_row::entry<false>(rows[i], x) < q[i];
}

// ------------------------------------------------------------ flat_binary
// The uniform search's levels are k = top .. last (a step of 2^k), top =
// log2(n_pad) - 1 and last = ceil(log2(cutoff)); none when top < last.
// One query a thread. The first stage_levels of them read `stage` (their
// probe keys in Eytzinger order: entry h - 1 is heap node h, so a level's
// probes lie side by side in shared memory, on different banks); below
// them, through staged_bound.cuh's steps (kernel 6's), the levels k >=
// 2 * kWinLog2 read one entry each of `sample` (every 32-byte window's
// last key, up to keys_pad's first dead key: an entry past it is dead),
// the levels down to the window (k >= kWinLog2) one window of the sample,
// and the levels below it, and the cutoff's tail, one window of keys_pad
// (a tail wider than the window: its `cutoff` keys at pos).
template <typename T>
__global__ void __launch_bounds__(kStageThreads)
flat_binary_kernel(const T* __restrict__ q, long long n_q,
                   const T* __restrict__ keys, int n_pad,
                   const T* __restrict__ stage, int stage_levels,
                   const T* __restrict__ sample, int n_sample, int top,
                   int last, int cutoff, int n, int staging,
                   int* __restrict__ out) {
  constexpr int kWin = 32 / static_cast<int>(sizeof(T));
  constexpr int kWinLog2 = sizeof(T) == 4 ? 3 : 2;
  const T* st = stage;
  extern __shared__ int4 smem[];
  if (staging) {
    const int pieces =
        (((1 << stage_levels) - 1) * static_cast<int>(sizeof(T)) + 15) / 16;
    const int4* src = reinterpret_cast<const int4*>(stage);
    for (int t = threadIdx.x; t < pieces; t += blockDim.x)
      smem[t] = __ldg(src + t);
    __syncthreads();
    st = reinterpret_cast<const T*>(smem);
  }
  const int single = 2 * kWinLog2 > last ? 2 * kWinLog2 : last;
  const int lo = kWinLog2 > last ? kWinLog2 : last;
  const bool on[1] = {true};
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n_q; i += stride) {
    const T qv[1] = {q[i]};
    unsigned pos = 0;
    int k = top;
    if (stage_levels > 0) {
      unsigned h = 1;
      for (int s = 0; s < stage_levels; ++s)
        h = 2 * h + (st[h - 1] < qv[0] ? 1u : 0u);
      pos = (h - (1u << stage_levels)) << (top + 1 - stage_levels);
      k = top - stage_levels;
    }
    pos = staged_bound::sample_levels(
        pos, k, single, kWinLog2, [&](unsigned m) {
          return m < static_cast<unsigned>(n_sample) &&
                 __ldg(sample + m) < qv[0];
        });
    if (k >= single) k = single - 1;
    int c[1];
    long long from[1], to[1];
    if (k >= lo) {       // levels k .. lo: one window of the sample
      pos = staged_bound::sample_window<kWinLog2>(
          pos, k, lo, [&](unsigned first, int len) {
            from[0] = first;
            to[0] = from[0] + len;
            count_range<T, 1>(sample, n_sample, from, to, len, qv, on, c);
            return c[0];
          });
      k = lo - 1;
    }
    from[0] = pos;
    if (k >= last) {     // levels k .. last and the tail: a window of keys
      const int span = 1 << (k + 1);
      to[0] = from[0] + span;
      count_range<T, 1>(keys, n_pad, from, to, kWin, qv, on, c);
      const int most = (span >> last) - 1;
      const int b = c[0] >> last;
      const unsigned p = pos + (static_cast<unsigned>(b < most ? b : most)
                                << last);
      const int rest = c[0] - static_cast<int>(p - pos);
      pos = cutoff > 1 ? p + (rest < cutoff ? rest : cutoff) : p;
    } else if (cutoff > 1) {   // the tail block alone
      to[0] = from[0] + cutoff;
      count_range<T, 1>(keys, n_pad, from, to, cutoff, qv, on, c);
      pos += c[0];
    }
    const int rank = static_cast<int>(pos);
    out[i] = rank < n ? rank : n;
  }
}

// ----------------------------------------------------------- flat_descent
// One thread a query, I queries a thread in flight.
template <typename T, int I>
__global__ void __launch_bounds__(kStageThreads)
flat_descent_kernel(const T* __restrict__ q, long long n_q,
                    const T* __restrict__ nodes, int n_rows, int w,
                    unsigned fanout, int depth,
                    const __grid_constant__ Levels lv, int binary,
                    const T* __restrict__ sample, long long sample_size,
                    int sample_width, const T* __restrict__ leaves,
                    int n_leaves, int leaf_width, long long leaf_sample_at,
                    int leaf_sample_width, int ending, int n, int staging,
                    int* __restrict__ out) {
  const int stride = sorted_row::padded_stride(w);
  extern __shared__ int4 smem[];
  T* staged = reinterpret_cast<T*>(smem);
  const bool use_stage = staging && lv.stage_levels > 0;
  if (use_stage) {    // rows [0, stage_rows) of nodes, entry x at x + x / 32
    constexpr int V = 16 / static_cast<int>(sizeof(T));
    const long long keys = static_cast<long long>(lv.stage_rows) * w;
    const long long size = static_cast<long long>(n_rows) * w;
    for (long long p = threadIdx.x; p * V < keys; p += blockDim.x) {
      T k[V];
      if (p * V + V <= size) {
        const Vec<T> v = load_vec(nodes + p * V);
#pragma unroll
        for (int t = 0; t < V; ++t) k[t] = v.k[t];
      } else {
        for (int t = 0; t < V; ++t)
          k[t] = p * V + t < size ? nodes[p * V + t] : T(0);
      }
#pragma unroll
      for (int t = 0; t < V; ++t) {
        const long long g = p * V + t;
        if (g < keys) {
          const int r = static_cast<int>(g / w), x = static_cast<int>(g % w);
          staged[r * stride + x + (x >> 5)] = k[t];
        }
      }
    }
    __syncthreads();
  }
  const long long size = static_cast<long long>(n_rows) * w;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x * I;
  for (long long first =
           (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * I;
       first < n_q; first += step) {
    long long qi[I];
    bool live[I];
    T qv[I];
    unsigned j[I], j_local[I], page[I];
#pragma unroll
    for (int i = 0; i < I; ++i) {
      qi[i] = first + i;
      live[i] = qi[i] < n_q;
      qv[i] = live[i] ? q[qi[i]] : T(0);
      j[i] = j_local[i] = page[i] = 0;
    }
    for (int l = 0; l < depth; ++l) {
      const bool starts = (lv.starts >> l) & 1ull;
      int r[I], c[I];
      bool on[I];
#pragma unroll
      for (int i = 0; i < I; ++i) {
        if (starts) {
          page[i] = static_cast<unsigned>(lv.page_row[l]) +
                    j[i] * static_cast<unsigned>(lv.page_rows[l]);
          j_local[i] = 0;
        }
        r[i] = clamp_row(
            static_cast<int>(page[i] + static_cast<unsigned>(lv.level_row[l]) +
                             j_local[i]),
            n_rows);
        on[i] = live[i] && j[i] < static_cast<unsigned>(lv.live[l]);
      }
      if (use_stage && l < lv.stage_levels) {
        const T* rows[I];
#pragma unroll
        for (int i = 0; i < I; ++i)
          rows[i] = staged + (r[i] < lv.stage_rows ? r[i] : lv.stage_rows - 1) *
                                 stride;
        if (w <= whole_keys<T>() && !binary)
          staged_counts<T, I>(rows, w, qv, on, c);
        else
          lower_bounds<false, T, I>(rows, w, qv, on, c);
      } else if (binary) {
        const T* rows[I];
#pragma unroll
        for (int i = 0; i < I; ++i)
          rows[i] = nodes + static_cast<long long>(r[i]) * w;
        lower_bounds<true, T, I>(rows, w, qv, on, c);
      } else {
        long long row[I], samp[I];
#pragma unroll
        for (int i = 0; i < I; ++i) {
          row[i] = static_cast<long long>(r[i]) * w;
          samp[i] = (static_cast<long long>(lv.sample_row[l]) +
                     (on[i] ? j[i] : 0)) * sample_width;
        }
        row_count<T, I>(nodes, size, row, w, sample, sample_size, samp,
                        sample_width, qv, on, c);
      }
#pragma unroll
      for (int i = 0; i < I; ++i) {
        const unsigned ci = on[i] ? static_cast<unsigned>(c[i]) : 0u;
        j[i] = j[i] * fanout + ci;
        j_local[i] = j_local[i] * fanout + ci;
      }
    }
    int rank[I];
#pragma unroll
    for (int i = 0; i < I; ++i) rank[i] = static_cast<int>(j[i]);
    if (ending == kLeafCount) {
      // block j holds keys only while j * leaf_width < n; past it the
      // rank is at least n, which the clamp makes n
      bool on[I];
      int c[I];
#pragma unroll
      for (int i = 0; i < I; ++i)
        on[i] = live[i] && static_cast<long long>(j[i]) * leaf_width < n;
      if (binary) {
        const T* rows[I];
#pragma unroll
        for (int i = 0; i < I; ++i)
          rows[i] = leaves + static_cast<long long>(clamp_row(
                                 static_cast<int>(j[i]), n_leaves)) *
                                 leaf_width;
        lower_bounds<true, T, I>(rows, leaf_width, qv, on, c);
      } else {
        long long row[I], samp[I];
#pragma unroll
        for (int i = 0; i < I; ++i) {
          row[i] = static_cast<long long>(
                       clamp_row(static_cast<int>(j[i]), n_leaves)) *
                   leaf_width;
          samp[i] = leaf_sample_at +
                    static_cast<long long>(on[i] ? j[i] : 0) *
                        leaf_sample_width;
        }
        row_count<T, I>(leaves,
                        static_cast<long long>(n_leaves) * leaf_width, row,
                        leaf_width, sample, sample_size, samp,
                        leaf_sample_width, qv, on, c);
      }
#pragma unroll
      for (int i = 0; i < I; ++i)
        rank[i] = on[i] ? static_cast<int>(
                              j[i] * static_cast<unsigned>(leaf_width) +
                              static_cast<unsigned>(c[i]))
                        : n;
    }
#pragma unroll
    for (int i = 0; i < I; ++i) {
      if (ending != kDescent && rank[i] > n) rank[i] = n;
      if (live[i]) out[qi[i]] = rank[i];
    }
  }
}

// ------------------------------------------------------------- csb_search
// #{x < pieces * V : row[x] < q} (kEqual: == q) of row s of `rows`, rows
// of `pieces` 16-byte pieces of V keys: kUnroll pieces issued before their
// compares, from shared memory (kShared) or through the read-only path
template <bool kShared, bool kEqual, typename T>
__device__ __forceinline__ int piece_count(const T* rows, int s, int pieces,
                                           T q) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  int c = 0;
  for (int h0 = 0; h0 < pieces; h0 += kUnroll) {
    Vec<T> v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (h0 + u < pieces) {
        const T* at = rows + (static_cast<long long>(s) * pieces + h0 + u) * V;
        v[u] = kShared ? *reinterpret_cast<const Vec<T>*>(at) : load_vec(at);
      }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (h0 + u < pieces)
#pragma unroll
        for (int t = 0; t < V; ++t) c += hit<kEqual>(v[u].k[t], q);
  }
  return c;
}

// #{x < w : row[x] < q} (kEqual: == q) of node row r of w keys in `a`
// (`size` keys): a row of whole 16-byte pieces (every row aligned: two at
// w 8 and 4-byte keys) piece by piece, any other row through count_range's
// aligned pieces, masked to the row.
template <bool kEqual, typename T>
__device__ __forceinline__ int node_count(const T* __restrict__ a,
                                          long long size, int r, int w, T q) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  if (w % V == 0) return piece_count<false, kEqual>(a, r, w / V, q);
  const long long from[1] = {static_cast<long long>(r) * w},
                  to[1] = {from[0] + w};
  const T qv[1] = {q};
  const bool on[1] = {true};
  int c[1];
  count_range<T, 1, kEqual>(a, size, from, to, w, qv, on, c);
  return c[0];
}

// One thread a query. The stage (`chunks` 16-byte pieces: stage_nodes rows
// of `pieces` pieces, then their int32 links) holds the first stage_levels
// inner levels: stage node 0 is the root; below a staged node of an upper
// level the query goes to stage node link + c, below one of the last
// staged level to node id link + c. Every staged node is inner, and each
// node's whole child group (c up to the keys of its row below the
// sentinel) is staged, so the query leaves the stage on the node the plain
// descent reaches. Below the stage a level issues the node's row and its
// child id together.
template <typename T, bool kStaged>
__global__ void __launch_bounds__(kStageThreads, kCsbBlocks)
csb_search_kernel(const T* __restrict__ q, long long n_q,
                  const T* __restrict__ keys, const int* __restrict__ child,
                  const T* __restrict__ leaf_keys, int n_nodes, int w,
                  int root, int height, const int4* __restrict__ stage,
                  int stage_levels, int stage_nodes, int pieces,
                  bool* __restrict__ out) {
  const int row_chunks = stage_nodes * pieces;
  const int4* st = stage;
  if (kStaged) {
    extern __shared__ int4 smem[];
    const int chunks = row_chunks + (stage_nodes + 3) / 4;
    for (int t = threadIdx.x; t < chunks; t += blockDim.x)
      smem[t] = __ldg(stage + t);
    __syncthreads();
    st = smem;
  }
  const T* rows = reinterpret_cast<const T*>(st);
  const int* links = reinterpret_cast<const int*>(st + row_chunks);
  const long long size = static_cast<long long>(n_nodes) * w;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n_q; i += step) {
    const T qv = q[i];
    int nid = stage_levels > 0 ? 0 : root;
    for (int l = 0; l < stage_levels; ++l) {
      const int link = kStaged ? links[nid] : __ldg(links + nid);
      const int c = piece_count<kStaged, false>(rows, nid, pieces, qv);
      nid = static_cast<int>(static_cast<unsigned>(link) +
                             static_cast<unsigned>(c));
    }
    for (int h = stage_levels; h < height - 1; ++h) {
      const int r = clamp_row(nid, n_nodes);
      const int b = __ldg(child + r);          // beside the row's loads
      const int c = node_count<false>(keys, size, r, w, qv);
      if (b >= 0)
        nid = static_cast<int>(static_cast<unsigned>(b) +
                               static_cast<unsigned>(c));
    }
    out[i] = node_count<true>(leaf_keys, size, clamp_row(nid, n_nodes), w,
                              qv) != 0;
  }
}

// ---------------------------------------------------------------- launches
bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The launch of `kernel` over `threads` threads' work: with `smem` > 0
// bytes to stage and a batch that fills a persistent grid (as many
// kStageThreads blocks as fit the SMs), that grid with staging; else a
// grid-stride launch that reads the stage in place, in blocks of whole
// warps small enough that the batch reaches every SM (kThreads once it
// fills them). Sets *staging, *blocks, *block_threads and *bytes.
template <typename Kernel>
cudaError_t plan_launch(Kernel kernel, long long threads, size_t smem,
                        int* staging, int* blocks, int* block_threads,
                        size_t* bytes) {
  *staging = 0;
  *bytes = 0;
  int dev = 0;
  if (const cudaError_t err = cudaGetDevice(&dev)) return err;
  persistent::Device d;
  if (const cudaError_t err = persistent::device(dev, &d)) return err;
  if (smem > 0 && smem <= static_cast<size_t>(d.optin)) {
    int cap = 0;   // the kernel may take up to the opt-in limit, set once
    if (const cudaError_t err = persistent::resident_blocks(
            kernel, dev, kStageThreads, smem, d.optin, &cap))
      return err;
    if (threads >= static_cast<long long>(cap) * kStageThreads) {
      *staging = 1;
      *blocks = cap;
      *block_threads = kStageThreads;
      *bytes = smem;
      return cudaSuccess;
    }
  }
  const long long per_sm = (threads + d.sms - 1) / d.sms;
  *block_threads =
      per_sm >= kThreads ? kThreads : static_cast<int>((per_sm + 31) / 32 * 32);
  const long long want = (threads + *block_threads - 1) / *block_threads;
  *blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  return cudaSuccess;
}

// shared memory for `keys` staged keys of `size` bytes, whole 16-byte pieces
size_t stage_bytes(long long keys, size_t size) {
  return (static_cast<size_t>(keys) * size + 15) / 16 * 16;
}

template <typename T>
int launch_binary(const void* q, long long n_q, const void* keys, int n_pad,
                  const void* stage, int stage_levels, const void* sample,
                  int n_sample, int top, int last, int cutoff, int n,
                  void* out, void* stream) {
  if (n_q < 0 || n_pad < 1 || cutoff < 1 || cutoff > n_pad ||
      stage_levels < 0 || stage_levels > 24 || n_sample < 0 || last < 0 ||
      (top >= last && stage_levels > top - last + 1) || !aligned(keys) ||
      !aligned(stage) || !aligned(sample))
    return cudaErrorInvalidValue;
  if (n_q == 0) return cudaSuccess;
  auto kernel = flat_binary_kernel<T>;
  const size_t smem = stage_bytes((1ll << stage_levels) - 1, sizeof(T));
  int staging, blocks, threads;
  size_t bytes;
  if (const cudaError_t err = plan_launch(kernel, n_q, smem,
                                          &staging, &blocks, &threads,
                                          &bytes))
    return static_cast<int>(err);
  kernel<<<blocks, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), n_q, static_cast<const T*>(keys), n_pad,
      static_cast<const T*>(stage), stage_levels,
      static_cast<const T*>(sample), n_sample, top, last, cutoff, n, staging,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

struct DescentArgs {
  const void* q;
  long long n_q;
  const void* nodes;
  int n_rows, w, fanout, depth;
  const Levels* lv;
  int binary;
  const void* sample;
  long long sample_size;
  int sample_width;
  const void* leaves;
  int n_leaves, leaf_width;
  long long leaf_sample_at;
  int leaf_sample_width, ending, n;
  void* out;
  void* stream;
};

// kDescentQueries queries a thread under the persistent grid; in place,
// one a thread (a small batch's time is one query's chain of loads and
// the instructions between them)
template <typename T>
int launch_descent(const DescentArgs& a) {
  constexpr int I = kDescentQueries;
  auto kernel = flat_descent_kernel<T, I>;
  const size_t smem =
      a.lv->stage_levels
          ? stage_bytes(static_cast<long long>(a.lv->stage_rows) *
                            sorted_row::padded_stride(a.w),
                        sizeof(T))
          : 0;
  int staging, blocks, threads;
  size_t bytes;
  if (const cudaError_t err = plan_launch(kernel, (a.n_q + I - 1) / I,
                                          smem, &staging, &blocks, &threads,
                                          &bytes))
    return static_cast<int>(err);
  if (!staging) {
    kernel = flat_descent_kernel<T, 1>;
    if (const cudaError_t err = plan_launch(kernel, a.n_q, 0, &staging,
                                            &blocks, &threads, &bytes))
      return static_cast<int>(err);
  }
  kernel<<<blocks, threads, bytes, static_cast<cudaStream_t>(a.stream)>>>(
      static_cast<const T*>(a.q), a.n_q, static_cast<const T*>(a.nodes),
      a.n_rows, a.w, static_cast<unsigned>(a.fanout), a.depth, *a.lv,
      a.binary, static_cast<const T*>(a.sample), a.sample_size,
      a.sample_width, static_cast<const T*>(a.leaves), a.n_leaves,
      a.leaf_width, a.leaf_sample_at, a.leaf_sample_width, a.ending, a.n,
      staging, static_cast<int*>(a.out));
  return static_cast<int>(cudaGetLastError());
}



template <typename T>
int launch_descent_checked(
    const void* q, long long n_q, const void* nodes, int n_rows, int w,
    int fanout, int depth, const int* table, unsigned long long starts,
    int stage_levels, int stage_rows, int binary_intra,
    const void* sample, long long sample_size,
    int sample_width, const void* leaves, int n_leaves, int leaf_width,
    long long leaf_sample_at, int leaf_sample_width, int ending, int n,
    void* out, void* stream) {
  const bool leaf = ending == kLeafCount;
  if (n_q < 0 || w < 1 || fanout < 2 || depth < 0 || depth > kMaxLevels ||
      (depth > 0 && n_rows < 1) || ending < kRank || ending > kDescent ||
      (leaf && (n_leaves < 1 || leaf_width < 1)) || stage_levels < 0 ||
      stage_levels > depth || stage_rows < 0 || stage_rows > n_rows ||
      (stage_levels > 0 && stage_rows < 1) || !aligned(nodes) ||
      (leaf && !aligned(leaves)) || !aligned(sample) ||
      (w > whole_keys<T>() && !binary_intra &&
       (sample_width < 1 || (sample_width * sizeof(T)) % 16)) ||
      (leaf && leaf_width > whole_keys<T>() && !binary_intra &&
       (leaf_sample_width < 1 || (leaf_sample_width * sizeof(T)) % 16)))
    return cudaErrorInvalidValue;
  if (n_q == 0) return cudaSuccess;
  Levels lv = {};
  for (int l = 0; l < depth; ++l) {
    lv.page_row[l] = table[l];
    lv.page_rows[l] = table[depth + l];
    lv.level_row[l] = table[2 * depth + l];
    lv.live[l] = table[3 * depth + l];
    lv.sample_row[l] = table[4 * depth + l];
  }
  lv.starts = starts;
  lv.stage_levels = stage_levels;
  lv.stage_rows = stage_rows;
  const DescentArgs a{q, n_q, nodes, n_rows, w, fanout, depth, &lv,
                      binary_intra, sample, sample_size, sample_width,
                      leaves, n_leaves, leaf_width, leaf_sample_at,
                      leaf_sample_width, ending, n, out, stream};
  return launch_descent<T>(a);
}

// A persistent grid that stages when the batch fills it, else in place.
// *staged (host memory, may be null) says which.
template <typename T>
int launch_csb(const void* q, long long n_q, const void* keys,
               const void* child, const void* leaf_keys, int n_nodes, int w,
               int root, int height, const void* stage, int stage_levels,
               int stage_nodes, int stride, bool* out, void* stream,
               int* staged) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  if (n_q < 0 || n_nodes < 1 || w < 1 || height < 1 || stage_levels < 0 ||
      stage_levels > height - 1 || stage_nodes < 0 ||
      (stage_levels > 0 &&
       (stage_nodes < 1 || stride < w || stride % V ||
        static_cast<long long>(stage_nodes) * (stride / V) > (1 << 24))) ||
      !aligned(keys) || !aligned(leaf_keys) || !aligned(stage))
    return cudaErrorInvalidValue;
  if (staged) *staged = 0;
  if (n_q == 0) return cudaSuccess;
  if (stage_levels == 0) stage_nodes = 0;
  const int pieces = stage_levels ? stride / V : 0;
  const size_t smem =
      stage_levels ? 16 * static_cast<size_t>(stage_nodes * pieces +
                                              (stage_nodes + 3) / 4)
                   : 0;
  int staging, blocks, threads;
  size_t bytes;
  auto kernel = csb_search_kernel<T, true>;
  if (const cudaError_t err = plan_launch(kernel, n_q, smem, &staging,
                                          &blocks, &threads, &bytes))
    return static_cast<int>(err);
  if (!staging) kernel = csb_search_kernel<T, false>;
  kernel<<<blocks, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), n_q, static_cast<const T*>(keys),
      static_cast<const int*>(child), static_cast<const T*>(leaf_keys),
      n_nodes, w, root, height, static_cast<const int4*>(stage),
      stage_levels, stage_nodes, pieces, out);
  if (staged) *staged = staging;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, one a key type (i32, f32, i64, f64). Pointers are device
// pointers (16-byte aligned: the index's arrays), except flat_descent's
// level table `table` (host memory, 5 x depth ints: page_row, page_rows,
// level_row, live, sample_row, copied into the launch's arguments) and
// csb_search's `staged` (host memory, or null: 1 if the launch staged); the
// stream is the caller's. Each returns cudaGetLastError() after the launch
// (0: launched; nothing is launched for n_q == 0).
#define FLAT_SEARCH_ENTRIES(SUFFIX, T)                                       \
  extern "C" int flat_binary_##SUFFIX(                                       \
      const void* q, long long n_q, const void* keys, int n_pad,             \
      const void* stage, int stage_levels, const void* sample, int n_sample, \
      int top, int last, int cutoff, int n, void* out, void* stream) {       \
    return launch_binary<T>(q, n_q, keys, n_pad, stage, stage_levels,       \
                            sample, n_sample, top, last, cutoff, n, out,     \
                            stream);                                         \
  }                                                                          \
  extern "C" int flat_descent_##SUFFIX(                                      \
      const void* q, long long n_q, const void* nodes, int n_rows, int w,    \
      int fanout, int depth, const int* table, unsigned long long starts,    \
      int stage_levels, int stage_rows, int binary_intra,                    \
      const void* sample, long long sample_size,                             \
      int sample_width, const void* leaves, int n_leaves, int leaf_width,    \
      long long leaf_sample_at, int leaf_sample_width, int ending, int n,    \
      void* out, void* stream) {                                             \
    return launch_descent_checked<T>(                                        \
        q, n_q, nodes, n_rows, w, fanout, depth, table, starts,              \
        stage_levels, stage_rows, binary_intra, sample,                      \
        sample_size, sample_width, leaves, n_leaves, leaf_width,             \
        leaf_sample_at, leaf_sample_width, ending, n, out, stream);          \
  }                                                                          \
  extern "C" int csb_search_##SUFFIX(                                        \
      const void* q, long long n_q, const void* keys, const void* child,     \
      const void* leaf_keys, int n_nodes, int w, int root, int height,       \
      const void* stage, int stage_levels, int stage_nodes, int stride,      \
      void* out, void* stream, int* staged) {                                \
    return launch_csb<T>(q, n_q, keys, child, leaf_keys, n_nodes, w, root,   \
                         height, stage, stage_levels, stage_nodes, stride,   \
                         static_cast<bool*>(out), stream, staged);           \
  }

FLAT_SEARCH_ENTRIES(i32, int32_t)
FLAT_SEARCH_ENTRIES(f32, float)
FLAT_SEARCH_ENTRIES(i64, long long)
FLAT_SEARCH_ENTRIES(f64, double)

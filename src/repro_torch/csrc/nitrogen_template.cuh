// The fixed part of every generated NitroGen kernel, for Hopper (sm_90a).
//
// NitroGen compiles an index into code (thesis Ch. 4): the top levels'
// separators become literals in the instruction stream and the selected
// block is searched by a data-resident bottom. kernels/nitrogen_codegen.py
// generates one source an index: it defines the constants below, includes
// this header, and defines ng_network(q), the compiled top, in which every
// separator is an immediate. This header holds the rest, written once:
// the bottoms over block_pad / css_dirs, the rank and the kernel (one
// launch a search). nvcc builds it as a cubin, which kernels/_driver.py
// loads and launches (min(rank, clip) of n_q queries).
//
// Replaces no pallas_call: it twins the executable that jax.jit makes of
// the reference's constant network plus its bottom (repro/core/nitrogen.py
// searcher). What bounds it on the H100: operations for the top (every
// separator is compared, branch-free, as the reference's select network
// does) and, for the bottom, the loads a query scatters: one thread a
// query, so the 32 lanes of a warp read 32 unrelated rows, each lane's
// load a transaction of its own, and past the 50 MB L2 each probe of a
// large block drags a 32-byte sector in from device memory. The bottoms
// are designed to make few loads and touch few sectors:
//   - every bottom row is sorted and padded with the key type's largest
//     value (core/nitrogen.py build), so |{k < q}| over a row is a lower
//     bound. The binary bottom's uniform search over its padded row, and
//     the vector bottom's count over a wide row, are one lower bound:
//     log2(row) probes in place of the vector bottom's row-long stream;
//   - its first levels read a sorted sample of every row (`stage`), copied
//     into shared memory once a block of threads when the batch fills a
//     persistent grid (as many blocks as fit on the SMs), else read where
//     it lies; the next levels, down to the last two windows, read a
//     sample of every row at every window's width (`sample`: an eighth of
//     the rows for 4-byte keys, small enough to stay in L2); the last
//     levels read one aligned 32-byte window of the sample, then one of
//     the row (two 16-byte loads each): one sector of the row a query;
//   - short rows, CSS directory rows and CSS leaves are counted 16 bytes a
//     load (a leaf through an aligned window with a mask).
// Built without --use_fast_math: float compares keep subnormals, as IEEE
// has them.
//
// The same text builds with a host C++ compiler (no __CUDACC__): the
// per-query functions are plain inline ones, the staged levels are read
// from the `stage` array itself, and nitrogen_search_host loops over the
// queries, so the search the card runs is tested without a card; it
// reports a 16-byte load from an address that is not 16-byte aligned,
// which the card would fault on.
//
// Constants the generated source defines before including this header:
//   NG_KEY              the key type: int, long long, float or double
//   NG_THREADS          the most threads a block (a staging launch's)
//   NG_BOTTOM           NG_BOTTOM_BINARY, NG_BOTTOM_VECTOR or NG_BOTTOM_CSS
//   NG_N                keys in the index
//   NG_BLOCK_WIDTH      keys a bottom block holds before padding
//   NG_BLOCK_PAD_WIDTH  slots a block holds after padding (a row)
//   NG_BLOCK_PAD_LEN    slots of block_pad in all
//   NG_ROW_LOG2         ceil(log2(NG_BLOCK_PAD_WIDTH)): the lower bound's
//                       levels (binary and vector rows)
//   NG_LINEAR           1: a short binary or vector row, counted key by key
//   NG_VEC_ROWS         1: rows start 16-byte aligned (a whole number of
//                       16-byte pieces a row)
//   NG_WIN_LOG2         log2 of the lower bound's window (0: none)
//   NG_STAGE_LEVELS     levels read from the stage array (0: none)
//   NG_STAGE_BYTES      its bytes (every block's 2^levels - 1 keys, rounded
//                       up to 16 bytes): the shared memory of a staging block
//   NG_SAMPLE           1: the levels below read the sample array and its
//                       window
//   NG_CSS_W, NG_CSS_LEAF_WIDTH, NG_CSS_DEPTH, NG_CSS_DIR_LEN,
//   NG_CSS_LEAF_LEN, NG_CSS_DIRS_LEN, NG_CSS_OFFSETS ({...}, one a level),
//   NG_CSS_VEC          1: directory rows are whole 16-byte pieces
#pragma once

#include <string.h>

#include "staged_bound.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define NG_FN __host__ __device__ __forceinline__
#else
#include <stdint.h>
#define NG_FN inline
#endif

#define NG_BOTTOM_BINARY 0
#define NG_BOTTOM_VECTOR 1
#define NG_BOTTOM_CSS 2

// keys in a 16-byte load, and a lower bound's row padded to a power of two
#define NG_VEC (16 / static_cast<int>(sizeof(NG_KEY)))
#define NG_ROW_SLOTS (1 << NG_ROW_LOG2)

// A float separator is written by its bits: exact for -0.0, subnormals
// and the +inf sentinel. On the device the bit move folds into the
// compare's immediate.
NG_FN float ng_f32(unsigned int bits) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(bits);
#else
  float f;
  memcpy(&f, &bits, sizeof f);
  return f;
#endif
}

NG_FN double ng_f64(unsigned long long bits) {
#ifdef __CUDA_ARCH__
  return __longlong_as_double(static_cast<long long>(bits));
#else
  double f;
  memcpy(&f, &bits, sizeof f);
  return f;
#endif
}

NG_FN NG_KEY ng_load(const NG_KEY* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

struct alignas(16) ng_vec {
  NG_KEY k[NG_VEC];
};

#ifndef __CUDA_ARCH__
// set by a host build's 16-byte load from an address the card would fault on
static int ng_host_misaligned = 0;
#endif

// the 16 bytes of keys at p (16-byte aligned), through the read-only path
NG_FN ng_vec ng_load_vec(const NG_KEY* p) {
#ifdef __CUDA_ARCH__
  union {
    int4 raw;
    ng_vec v;
  } u;
  u.raw = __ldg(reinterpret_cast<const int4*>(p));
  return u.v;
#else
  if (reinterpret_cast<uintptr_t>(p) % 16) ng_host_misaligned = 1;
  ng_vec v;
  memcpy(&v, p, sizeof v);
  return v;
#endif
}

// |{k in v's first `len` keys : k < q}|
NG_FN int ng_below(const ng_vec& v, NG_KEY q, int len = NG_VEC) {
  int c = 0;
#pragma unroll
  for (int t = 0; t < NG_VEC; ++t) c += t < len && v.k[t] < q ? 1 : 0;
  return c;
}

// an index clamped into [0, len - 1], as the plain version's gathers are
NG_FN long long ng_clip(long long i, long long len) {
  return i < 0 ? 0 : (i >= len ? len - 1 : i);
}

// |{k in p[0, len) : k < q}|, 16 bytes a load when `vec` (p 16-byte
// aligned, len a multiple of NG_VEC)
NG_FN int ng_count_below(const NG_KEY* p, int len, NG_KEY q, bool vec) {
  int c = 0;
  if (vec) {
#pragma unroll
    for (int j = 0; j < len; j += NG_VEC) c += ng_below(ng_load_vec(p + j), q);
    return c;
  }
#pragma unroll 8
  for (int j = 0; j < len; ++j) c += ng_load(p + j) < q ? 1 : 0;
  return c;
}

// The compiled top: q -> block id. Generated, after this header.
NG_FN int ng_network(NG_KEY q);

// Slot s (< NG_ROW_SLOTS) of a lower bound's row is below q; the slots
// past the row's NG_BLOCK_PAD_WIDTH read as the sentinel, never below.
NG_FN bool ng_slot_below(const NG_KEY* row, int s, NG_KEY q) {
  return (NG_BLOCK_PAD_WIDTH == NG_ROW_SLOTS || s < NG_BLOCK_PAD_WIDTH) &&
         ng_load(row + s) < q;
}

// The keys below q among the `len` first of the 2 x 16 bytes at p (a
// window), reading only pieces that start before `limit`.
NG_FN int ng_count_window(const NG_KEY* p, NG_KEY q, int len, int limit) {
  int c = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (h * NG_VEC < limit) c += ng_below(ng_load_vec(p + h * NG_VEC), q,
                                          len - h * NG_VEC);
  return c;
}

// |{k < q}| over a sorted, sentinel-padded row of NG_BLOCK_PAD_WIDTH keys:
// a lower bound over the row padded to NG_ROW_SLOTS. The binary bottom's
// uniform search over its power-of-two row gives the same offset (it
// never reads the last slot, which is padding), the vector bottom's count
// the same count. `staged`: the row's slots at every
// 2^(NG_ROW_LOG2 - NG_STAGE_LEVELS)-th place (the first levels);
// `sample`: at every window's width (the levels down to the last two
// windows).
NG_FN int ng_lower_bound(NG_KEY q, const NG_KEY* row, const NG_KEY* staged,
                         const NG_KEY* sample) {
  // the steps are staged_bound.cuh's, shared with flat_search.cu
  constexpr int kShift = NG_ROW_LOG2 - NG_STAGE_LEVELS;
  unsigned pos = staged_bound::sample_levels(
      0u, NG_ROW_LOG2 - 1, kShift, kShift,
      [&](unsigned m) { return staged[m] < q; });
#if NG_SAMPLE
  // slot pos + 2^k - 1 is the sample's entry (pos + 2^k) / window - 1
  pos = staged_bound::sample_levels(
      pos, kShift - 1, 2 * NG_WIN_LOG2, NG_WIN_LOG2,
      [&](unsigned m) { return ng_load(sample + m) < q; });
  // a window of the sample: the search at this level reads all but its
  // last entry
  pos = staged_bound::sample_window<NG_WIN_LOG2>(
      pos, 2 * NG_WIN_LOG2 - 1, NG_WIN_LOG2, [&](unsigned first, int len) {
        return ng_count_window(sample + first, q, len, 1 << NG_WIN_LOG2);
      });
#else
  (void)sample;
  pos = staged_bound::sample_levels(
      pos, kShift - 1, NG_WIN_LOG2, 0,
      [&](unsigned m) { return ng_slot_below(row, static_cast<int>(m), q); });
#endif
#if NG_WIN_LOG2 > 0
  // the last levels: a window of the row, counted whole (its last slot,
  // unread by the search above it, is the one slot not known to be >= q
  // only in the row's last window); pieces past the row are not read
  const int at = static_cast<int>(pos);
  return at + ng_count_window(row + at, q, 1 << NG_WIN_LOG2,
                              NG_BLOCK_PAD_WIDTH - at);
#else
  const int at = static_cast<int>(pos);
  return at == NG_ROW_SLOTS - 1 && ng_slot_below(row, at, q) ? at + 1 : at;
#endif
}

// |{k in block_pad[s, s + NG_CSS_LEAF_WIDTH) : k < q}| through the aligned
// 16-byte pieces that hold the leaf, masked to it; a piece that would run
// past the array's end is read key by key
NG_FN int ng_count_leaf(const NG_KEY* block_pad, long long s, NG_KEY q) {
  const long long a = s - s % NG_VEC, e = s + NG_CSS_LEAF_WIDTH;
  int c = 0;
#pragma unroll
  for (int h = 0; h < (NG_CSS_LEAF_WIDTH + 2 * NG_VEC - 2) / NG_VEC; ++h) {
    const long long at = a + static_cast<long long>(h) * NG_VEC;
    if (at >= e) continue;
    if (at + NG_VEC <= NG_BLOCK_PAD_LEN) {
      const ng_vec v = ng_load_vec(block_pad + at);
#pragma unroll
      for (int t = 0; t < NG_VEC; ++t)
        c += at + t >= s && at + t < e && v.k[t] < q ? 1 : 0;
    } else {
      for (long long x = at < s ? s : at; x < e; ++x)
        c += ng_load(block_pad + x) < q ? 1 : 0;
    }
  }
  return c;
}

// The data-resident bottom: q's offset inside block b. `staged` and
// `sample`: the block's rows of the stage and sample arrays.
NG_FN int ng_bottom(NG_KEY q, int b, const NG_KEY* block_pad,
                    const NG_KEY* css_dirs, const NG_KEY* staged,
                    const NG_KEY* sample) {
#if NG_BOTTOM != NG_BOTTOM_CSS
  (void)css_dirs;
  const long long row =
      ng_clip(b, NG_BLOCK_PAD_LEN / NG_BLOCK_PAD_WIDTH) * NG_BLOCK_PAD_WIDTH;
#if NG_LINEAR
  (void)staged;
  (void)sample;
  return ng_count_below(block_pad + row, NG_BLOCK_PAD_WIDTH, q, NG_VEC_ROWS);
#else
  return ng_lower_bound(q, block_pad + row, staged, sample);
#endif
#else
  // the block's CSS directory: a row of NG_CSS_W keys a level, then a leaf
  (void)staged;
  (void)sample;
  const int offsets[] = NG_CSS_OFFSETS;
  const long long dir_rows = NG_CSS_DIRS_LEN / NG_CSS_W;
  const long long drow = static_cast<long long>(b) * (NG_CSS_DIR_LEN / NG_CSS_W);
  long long j = 0;
#pragma unroll
  for (int l = 0; l < NG_CSS_DEPTH; ++l) {
    const long long row = ng_clip(drow + offsets[l] / NG_CSS_W + j, dir_rows);
    j = j * (NG_CSS_W + 1) +
        ng_count_below(css_dirs + row * NG_CSS_W, NG_CSS_W, q, NG_CSS_VEC);
  }
  const long long leaf_rows = NG_BLOCK_PAD_LEN / NG_CSS_LEAF_WIDTH;
  const long long row = ng_clip(
      static_cast<long long>(b) * (NG_CSS_LEAF_LEN / NG_CSS_LEAF_WIDTH) + j,
      leaf_rows);
  return static_cast<int>(j * NG_CSS_LEAF_WIDTH) +
         ng_count_leaf(block_pad, row * NG_CSS_LEAF_WIDTH, q);
#endif
}

// min(b * NG_BLOCK_WIDTH + min(offset, NG_BLOCK_WIDTH), NG_N, clip);
// `stage`: every block's staged keys, 2^NG_STAGE_LEVELS - 1 a block;
// `sample`: every block's sample, NG_ROW_SLOTS >> NG_WIN_LOG2 a block
NG_FN int ng_search(NG_KEY q, const NG_KEY* block_pad, const NG_KEY* css_dirs,
                    const NG_KEY* stage, const NG_KEY* sample, int clip) {
  const int b = ng_network(q);
  const long long sb = b;
  const int off = ng_bottom(
      q, b, block_pad, css_dirs, stage + sb * ((1 << NG_STAGE_LEVELS) - 1),
      sample + (NG_SAMPLE ? sb * (NG_ROW_SLOTS >> NG_WIN_LOG2) : 0));
  int r = b * NG_BLOCK_WIDTH + (off < NG_BLOCK_WIDTH ? off : NG_BLOCK_WIDTH);
  r = r < NG_N ? r : NG_N;
  return r < clip ? r : clip;
}

#ifdef __CUDACC__

// Launched through the driver API (kernels/_driver.py), a query a thread.
// A kernel with a stage array walks the queries a grid's worth apart: with
// `staging` (a batch that fills a persistent grid: NG_THREADS threads a
// block, as many blocks as the SMs hold, NG_STAGE_BYTES of dynamic shared
// memory) each block first copies the stage array into shared memory, 16
// bytes a load; else the stage array is read where it lies.
extern "C" __global__ void __launch_bounds__(NG_THREADS)
    ng_search_kernel(const NG_KEY* __restrict__ q,
                     const NG_KEY* __restrict__ block_pad,
                     const NG_KEY* __restrict__ css_dirs,
                     const NG_KEY* __restrict__ stage,
                     const NG_KEY* __restrict__ sample, int* __restrict__ out,
                     int n_q, int clip, int staging) {
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
#if NG_STAGE_LEVELS > 0
  const NG_KEY* staged = stage;
  extern __shared__ int4 ng_smem[];
  if (staging) {
    const int4* src = reinterpret_cast<const int4*>(stage);
    for (int t = threadIdx.x; t < NG_STAGE_BYTES / 16; t += blockDim.x)
      ng_smem[t] = __ldg(src + t);
    __syncthreads();
    staged = reinterpret_cast<const NG_KEY*>(ng_smem);
  }
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = first; i < n_q; i += step)
    out[i] = ng_search(ng_load(q + i), block_pad, css_dirs, staged, sample,
                       clip);
#else
  (void)staging;
  if (first < n_q)
    out[first] = ng_search(ng_load(q + first), block_pad, css_dirs, stage,
                           sample, clip);
#endif
}

#else

// The host build: returns 1 when a 16-byte load was misaligned, else 0.
extern "C" int nitrogen_search_host(const void* q, const void* block_pad,
                                    const void* css_dirs, const void* stage,
                                    const void* sample, void* out, int n_q,
                                    int clip) {
  ng_host_misaligned = 0;
  const NG_KEY* qs = static_cast<const NG_KEY*>(q);
  for (int i = 0; i < n_q; ++i)
    static_cast<int*>(out)[i] =
        ng_search(qs[i], static_cast<const NG_KEY*>(block_pad),
                  static_cast<const NG_KEY*>(css_dirs),
                  static_cast<const NG_KEY*>(stage),
                  static_cast<const NG_KEY*>(sample), clip);
  return ng_host_misaligned;
}

#endif

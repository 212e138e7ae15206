// The fixed part of every generated NitroGen kernel, for Hopper (sm_90a).
//
// NitroGen compiles an index into code (thesis Ch. 4): the top levels'
// separators become literals in the instruction stream and the selected
// block is searched by a data-resident bottom. kernels/nitrogen_codegen.py
// generates one source an index: it defines the constants below, includes
// this header, and defines ng_network(q), the compiled top, in which every
// separator is an immediate. This header holds the rest, written once:
// the bottoms over block_pad / css_dirs, the rank and the kernel (one
// thread a query, one launch a search). nvcc builds it as a cubin, which
// kernels/_driver.py loads and launches (min(rank, clip) of n_q queries).
//
// Replaces no pallas_call: it twins the executable that jax.jit makes of
// the reference's constant network plus its bottom (repro/core/nitrogen.py
// searcher). What bounds it on the H100: operations for the top (every
// separator is compared, branch-free, as the reference's select network
// does) and bytes for the bottom (the queries in, the ranks out, and the
// block rows a query reads). Built without --use_fast_math: float compares
// keep subnormals, as IEEE has them.
//
// The same text builds with a host C++ compiler (no __CUDACC__): the
// functions are then plain inline ones and nitrogen_search_host loops over
// the queries, so the generated code is tested without a card.
//
// Constants the generated source defines before including this header:
//   NG_KEY              the key type: int, long long, float or double
//   NG_THREADS          threads a block
//   NG_BOTTOM           NG_BOTTOM_BINARY, NG_BOTTOM_VECTOR or NG_BOTTOM_CSS
//   NG_N                keys in the index
//   NG_BLOCK_WIDTH      keys a bottom block holds before padding
//   NG_BLOCK_PAD_WIDTH  slots a block holds after padding
//   NG_BLOCK_PAD_LEN    slots of block_pad in all
//   NG_BLOCK_PAD_LOG2   log2(NG_BLOCK_PAD_WIDTH) (the binary bottom's steps)
//   NG_CSS_W, NG_CSS_LEAF_WIDTH, NG_CSS_DEPTH, NG_CSS_DIR_LEN,
//   NG_CSS_LEAF_LEN, NG_CSS_DIRS_LEN, NG_CSS_OFFSETS ({...}, one a level)
#pragma once

#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define NG_FN __host__ __device__ __forceinline__
#else
#define NG_FN inline
#endif

#define NG_BOTTOM_BINARY 0
#define NG_BOTTOM_VECTOR 1
#define NG_BOTTOM_CSS 2

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

// an index clamped into [0, len - 1], as the plain version's gathers are
NG_FN long long ng_clip(long long i, long long len) {
  return i < 0 ? 0 : (i >= len ? len - 1 : i);
}

// |{k in p[0, len) : k < q}|
NG_FN int ng_count_below(const NG_KEY* p, int len, NG_KEY q) {
  int c = 0;
#pragma unroll 8
  for (int j = 0; j < len; ++j) c += ng_load(p + j) < q ? 1 : 0;
  return c;
}

// The compiled top: q -> block id. Generated, after this header.
NG_FN int ng_network(NG_KEY q);

// The data-resident bottom: q's offset inside block b.
NG_FN int ng_bottom(NG_KEY q, int b, const NG_KEY* block_pad,
                    const NG_KEY* css_dirs) {
#if NG_BOTTOM == NG_BOTTOM_BINARY
  // the uniform lower_bound over the block padded to a power of two
  (void)css_dirs;
  const long long base = static_cast<long long>(b) * NG_BLOCK_PAD_WIDTH;
  int pos = 0;
#pragma unroll
  for (int k = NG_BLOCK_PAD_LOG2 - 1; k >= 0; --k) {
    const int step = 1 << k;
    const NG_KEY probe =
        ng_load(block_pad + ng_clip(base + pos + step - 1, NG_BLOCK_PAD_LEN));
    pos = probe < q ? pos + step : pos;
  }
  return pos;
#elif NG_BOTTOM == NG_BOTTOM_VECTOR
  // one compare against the whole block
  (void)css_dirs;
  const long long row = ng_clip(b, NG_BLOCK_PAD_LEN / NG_BLOCK_PAD_WIDTH);
  return ng_count_below(block_pad + row * NG_BLOCK_PAD_WIDTH,
                        NG_BLOCK_PAD_WIDTH, q);
#else
  // the block's CSS directory: a row of NG_CSS_W keys a level, then a leaf
  const int offsets[] = NG_CSS_OFFSETS;
  const long long dir_rows = NG_CSS_DIRS_LEN / NG_CSS_W;
  const long long drow = static_cast<long long>(b) * (NG_CSS_DIR_LEN / NG_CSS_W);
  long long j = 0;
#pragma unroll
  for (int l = 0; l < NG_CSS_DEPTH; ++l) {
    const long long row = ng_clip(drow + offsets[l] / NG_CSS_W + j, dir_rows);
    j = j * (NG_CSS_W + 1) +
        ng_count_below(css_dirs + row * NG_CSS_W, NG_CSS_W, q);
  }
  const long long leaf_rows = NG_BLOCK_PAD_LEN / NG_CSS_LEAF_WIDTH;
  const long long row = ng_clip(
      static_cast<long long>(b) * (NG_CSS_LEAF_LEN / NG_CSS_LEAF_WIDTH) + j,
      leaf_rows);
  return static_cast<int>(j * NG_CSS_LEAF_WIDTH) +
         ng_count_below(block_pad + row * NG_CSS_LEAF_WIDTH,
                        NG_CSS_LEAF_WIDTH, q);
#endif
}

// min(b * NG_BLOCK_WIDTH + min(offset, NG_BLOCK_WIDTH), NG_N, clip)
NG_FN int ng_search(NG_KEY q, const NG_KEY* block_pad, const NG_KEY* css_dirs,
                    int clip) {
  const int b = ng_network(q);
  const int off = ng_bottom(q, b, block_pad, css_dirs);
  int r = b * NG_BLOCK_WIDTH + (off < NG_BLOCK_WIDTH ? off : NG_BLOCK_WIDTH);
  r = r < NG_N ? r : NG_N;
  return r < clip ? r : clip;
}

#ifdef __CUDACC__

// One thread a query; launched through the driver API
// (kernels/_driver.py) with NG_THREADS threads a block.
extern "C" __global__ void __launch_bounds__(NG_THREADS)
    ng_search_kernel(const NG_KEY* __restrict__ q,
                     const NG_KEY* __restrict__ block_pad,
                     const NG_KEY* __restrict__ css_dirs, int* __restrict__ out,
                     int n_q, int clip) {
  const long long i =
      static_cast<long long>(blockIdx.x) * NG_THREADS + threadIdx.x;
  if (i < n_q) out[i] = ng_search(ng_load(q + i), block_pad, css_dirs, clip);
}

#else

extern "C" int nitrogen_search_host(const void* q, const void* block_pad,
                                    const void* css_dirs, void* out, int n_q,
                                    int clip) {
  const NG_KEY* qs = static_cast<const NG_KEY*>(q);
  for (int i = 0; i < n_q; ++i)
    static_cast<int*>(out)[i] =
        ng_search(qs[i], static_cast<const NG_KEY*>(block_pad),
                  static_cast<const NG_KEY*>(css_dirs), clip);
  return 0;
}

#endif

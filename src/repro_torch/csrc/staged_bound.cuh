// The steps of a staged lower bound over a sorted, sentinel-padded array,
// written once for the two kernels that run one: flat_search.cu's
// flat_binary (over a sorted array's keys_pad) and the generated NitroGen
// kernel's binary bottom (nitrogen_template.cuh ng_lower_bound, over each
// block's row). The generated source includes this header through
// nitrogen_template.cuh, and its host build (no __CUDACC__) too.
//
// A uniform lower bound at level k (a step of 2^k) probes slot
// pos + 2^k - 1. A sample of the array that holds the key of every
// 2^shift-th slot (entry m: slot (m + 1) * 2^shift - 1) holds the probe
// of every level k >= shift: entry (pos + 2^k) / 2^shift - 1. So the
// levels below a stage read a sample of every window's last key (shift W,
// 2^W keys a window: 32 bytes; it stays in L2), and then one window of
// that sample decides the levels down to W at once; the caller counts the
// last window of the array itself. Kernel 6 reads its staged levels the
// same way, from a sample at a wider stride in shared memory; flat_binary
// stages its first levels' probe keys in Eytzinger order instead, so that
// a warp's probes of one level lie side by side, on different banks (at a
// wide stride they would all fall on one). The loads are the caller's
// (the read-only path on the card, plain or checked reads on the host),
// passed as functions of an entry; levels whose bounds are constants
// unroll.
#pragma once

#ifdef __CUDACC__
#define SB_FN __host__ __device__ __forceinline__
#else
#define SB_FN inline
#endif

namespace staged_bound {

// Levels k = hi down to lo (none when hi < lo), each through the sample
// of every 2^shift-th slot (shift <= lo): below(m) says whether sample
// entry m lies below the query.
template <typename Below>
SB_FN unsigned sample_levels(unsigned pos, int hi, int lo, int shift,
                             Below below) {
#pragma unroll
  for (int k = hi; k >= lo; --k)
    if (below(((pos + (1u << k)) >> shift) - 1)) pos += 1u << k;
  return pos;
}

// Levels k down to lo (k >= lo >= W) at once, through the sample of every
// 2^W-th slot: its 2^(k + 1 - W) - 1 entries from pos / 2^W hold their
// probes, and count(first, len) is how many of entries [first, first +
// len) lie below the query; every 2^(lo - W) of them move pos 2^lo on.
template <int W, typename Count>
SB_FN unsigned sample_window(unsigned pos, int k, int lo, Count count) {
  const int c = count(pos >> W, (1 << (k + 1 - W)) - 1);
  return pos + (static_cast<unsigned>(c >> (lo - W)) << lo);
}

}  // namespace staged_bound

// The lower bound of a query in one sorted row: kernel 2's row count
// (csrc/kary_search.cu), shared with the flat kinds' descent
// (csrc/flat_search.cu, intra="binary").
//
// On a row that is nondecreasing with a sentinel tail (DESIGN.md §2.3)
// the predicate row[s] < q holds on a prefix, so #{s : row[s] < q} is the
// lower bound of q. That holds for duplicate keys, for q equal to the
// sentinel, for -0.0 against +0.0 (equal, so neither is below the other)
// and for a NaN query (the predicate is false everywhere: 0). Keys compare
// in their type with no arithmetic on them, so the bound is bit-identical
// to the count.
#pragma once

#include <cuda_runtime.h>

namespace sorted_row {

// Entry i of a row: shared rows hold one pad entry after every 32 (see
// padded_stride); rows in device memory are read as they are, through the
// read-only path.
template <bool kGlobal, typename T>
__device__ __forceinline__ T entry(const T* row, int i) {
  return kGlobal ? __ldg(row + i) : row[i + (i >> 5)];
}

// #{i < n : row[i] < q} on a nondecreasing row of n >= 1 entries: the
// answer lies in [base, base + n]; each step halves n without a branch.
template <bool kGlobal, typename T>
__device__ __forceinline__ int lower_bound(const T* row, int n, const T q) {
  int base = 0;
  while (n > 1) {
    const int half = n >> 1;
    base = entry<kGlobal>(row, base + half) < q ? base + half : base;
    n -= half;
  }
  return base + (entry<kGlobal>(row, base) < q);
}

// Shared rows: one pad entry after every 32, and rows
// wpad + wpad / 32 + 1 apart. The binary searches of a warp read, at one
// step, entries 2^m (2t + 1) of one row (level 0) or the same entry of
// different rows (level 1); unpadded, both fall in one bank and the warp
// serialises up to 32 ways. Padded, entry i of row r sits in bank
// (r * stride + i + i / 32) mod 32, which spreads both.
__host__ __device__ __forceinline__ int padded_stride(int wpad) {
  return wpad + (wpad >> 5) + 1;
}

}  // namespace sorted_row

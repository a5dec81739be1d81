// The run steps of a sorted key array, shared by spectrum23 (K5) and
// spectrummerge (K13): flag the first key of every run (the "new run"
// flags, whose exclusive scan numbers the unique keys), then write each
// run's key and first position at its unique number.
#pragma once

#include "dna13.cuh"

namespace runs {

__global__ void run_flags(const unsigned long long* __restrict__ s, const int* __restrict__ n_ptr,
                          long long cap, int* __restrict__ flags) {
  const long long n = *n_ptr;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < cap;
       i += step)
    flags[i] = (i < n && (i == 0 || s[i] != s[i - 1])) ? 1 : 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) flags[cap] = 0;
}

__global__ void run_write(const unsigned long long* __restrict__ s, const int* __restrict__ n_ptr,
                          const int* __restrict__ idx, unsigned long long* __restrict__ keys_out,
                          int* __restrict__ start) {
  const long long n = *n_ptr;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step) {
    if (i == 0 || s[i] != s[i - 1]) {
      const int u = idx[i];
      keys_out[u] = s[i];
      start[u] = static_cast<int>(i);
    }
  }
}

}  // namespace runs

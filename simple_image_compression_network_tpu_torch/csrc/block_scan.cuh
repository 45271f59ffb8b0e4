// Block-wide exclusive prefix sum for the rANS kernels (one thread per lane).
#pragma once
#include <cuda_runtime.h>

// Exclusive scan of v over the block; *total receives the block sum.
// blockDim.x must be a multiple of 32 and at most 1024; every thread of the
// block must call it (it synchronises).  sh holds at least 32 ints.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total, int* sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) sh[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int ws = lane < n_warps ? sh[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, ws, o);
      if (lane >= o) ws += y;
    }
    sh[lane] = ws;  // inclusive sums of the warp totals
  }
  __syncthreads();
  const int before = warp ? sh[warp - 1] : 0;
  *total = sh[n_warps - 1];
  __syncthreads();  // sh is reused by the next call
  return before + incl - v;
}

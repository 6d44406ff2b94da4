// Block-wide integer scans and reductions shared by the kernels of this
// directory. Every function must be called by all threads of the block
// (blockDim.x a multiple of 32, at most 1024). `warp_buf` is 32 ints of
// shared memory; block_reduce leaves the block in step, block_prefix_max
// does not (it saves a barrier per DP row): the caller puts a
// __syncthreads() between it and the next use of `warp_buf`.
#pragma once

#include <climits>

namespace vk {

constexpr unsigned kFull = 0xffffffffu;

// inclusive prefix max over threadIdx.x: warp __shfl_up_sync scan, then one
// pass over the warp totals in shared memory
__device__ __forceinline__ int block_prefix_max(int v, int* warp_buf) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v = max(v, u);
  }
  if (lane == 31) warp_buf[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int t = lane < nwarps ? warp_buf[lane] : INT_MIN;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int u = __shfl_up_sync(kFull, t, o);
      if (lane >= o) t = max(t, u);
    }
    if (lane < nwarps) warp_buf[lane] = t;
  }
  __syncthreads();
  if (warp > 0) v = max(v, warp_buf[warp - 1]);
  return v;
}

// block-wide max (is_min = false) or min (is_min = true), result in every thread
__device__ __forceinline__ int block_reduce(int v, int* warp_buf, bool is_min) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    int u = __shfl_xor_sync(kFull, v, o);
    v = is_min ? min(v, u) : max(v, u);
  }
  if (lane == 0) warp_buf[warp] = v;
  __syncthreads();
  int t = warp_buf[0];
  for (int w = 1; w < nwarps; ++w) t = is_min ? min(t, warp_buf[w]) : max(t, warp_buf[w]);
  __syncthreads();
  return t;
}

}  // namespace vk

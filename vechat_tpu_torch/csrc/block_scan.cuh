// A block-wide integer reduction shared by the kernels of this directory.
// It must be called by all threads of the block (blockDim.x a multiple of
// 32, at most 1024). `warp_buf` is 32 ints of shared memory; it leaves the
// block in step.
#pragma once

#include <climits>

namespace vk {

constexpr unsigned kFull = 0xffffffffu;

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

// Block-wide integer reductions and prefix sums shared by the kernels of
// this directory. Each must be called by all threads of the block
// (blockDim.x a multiple of 32, at most 1024) and leaves the block in step.
#pragma once

#include <climits>

namespace vk {

constexpr unsigned kFull = 0xffffffffu;

// block-wide max (is_min = false) or min (is_min = true), result in every
// thread; `warp_buf` is 32 ints of shared memory
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

// Inclusive prefix sums of a[0, n) in place, a contiguous run of elements
// a thread; `tot` is a shared int a warp
__device__ inline void block_scan(int* a, int n, int* tot) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(tid * per, n), hi = min(lo + per, n);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += a[i];
  int x = s;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) tot[w] = x;
  __syncthreads();
  int run = x - s;
  for (int k = 0; k < w; ++k) run += tot[k];
  for (int i = lo; i < hi; ++i) {
    run += a[i];
    a[i] = run;
  }
  __syncthreads();
}

}  // namespace vk

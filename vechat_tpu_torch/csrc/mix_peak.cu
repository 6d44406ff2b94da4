// The integer mix-peak kernel (K7) for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// Replaces scripts/roofline.py: mix_kernel (the pallas_call in
// measure_mix_peak). It runs the operation mix of the POA DP kernels:
// four chains a, b, c, d in a ring, each advanced `iters` times by one round
// of 12 int32 operations (roll by one lane, add, max, compare, select, shift,
// and, add, max, min, or, subtract) over [64, 512] tiles that stay in
// registers: no memory traffic inside the loop, so the rate it sustains is
// the card's ceiling for this mix. It is bound by operations by construction.
//
// Where the TPU has one core and one tile, this card has 132 SMs: the grid is
// T tiles x 4 blocks, a block of 16 warps takes 16 rows of a tile, one warp a
// whole 512-lane row, 16 elements a thread (column k*32 + lane, so loads and
// stores coalesce). With the four chains a thread holds 64 values, which puts
// one block on an SM: T a multiple of the SM count fills every wave.
//
// The roll along the row with wrap-around is the one operation of the twelve
// that is no ALU work here: one __shfl_sync an element from lane - 1, where
// lane 31 offers its previous column's element so that lane 0 receives
// column k*32 - 1 (for k = 0: column 511, the wrap).
//
// As nvcc 12.8 compiles it for sm_90a, an element's round is 9 instruction slots
// on the INT32 pipe (2 VIADDMNMX: each add-then-max fused; ISETP and SEL for
// the compare and select, one more SEL for lane 31's offer; SHF; 2 LOP3;
// VIMNMX), the subtract as an IMAD on the FMA pipe, and the SHFL: 12 counted
// operations in 9 INT32 instruction slots, which is how the mix's rate can pass
// the card's INT32 lanes x clock.
//
// The chains are inputs and the final tiles are outputs (the TPU kernel
// reads its scratch uninitialised), and `iters` and `seed` are run-time
// arguments, so the plain PyTorch version can hold every lane and the
// compiler cannot fold the loop.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;
constexpr int kCols = 512;
constexpr int kPer = kCols / 32;  // elements of a row a thread holds
constexpr int kWarps = 16;        // rows a block takes

__device__ __forceinline__ int wadd(int p, int q) { return (int)((unsigned)p + (unsigned)q); }
__device__ __forceinline__ int wsub(int p, int q) { return (int)((unsigned)p - (unsigned)q); }

// x <- round(x, y), the 12 operations of roofline.py:88-100
__device__ __forceinline__ void mix_round(int (&x)[kPer], const int (&y)[kPer], int kk, int lane) {
  int r[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int v = lane == 31 ? x[(k + kPer - 1) % kPer] : x[k];
    r[k] = __shfl_sync(0xffffffffu, v, (lane + 31) & 31);  // roll
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int s = wadd(r[k], y[k]);           // add
    const int m = max(s, x[k]);               // max
    const int sel = m > y[k] ? m : x[k];      // compare, select
    const int an = (sel >> 2) & 0x7FFF;       // shift, and
    const int ad = wadd(an, kk);              // add
    const int mn = min(max(ad, y[k]), 0x3FFFFFF);  // max, min
    x[k] = wsub(mn | 1, y[k]);                // or, subtract
  }
}

__global__ void __launch_bounds__(kWarps * 32, 1) mix_peak_kernel(
    const int* __restrict__ a_in, const int* __restrict__ b_in,
    const int* __restrict__ c_in, const int* __restrict__ d_in,  // [T, 64, 512]
    int* __restrict__ a_out, int* __restrict__ b_out,
    int* __restrict__ c_out, int* __restrict__ d_out,            // [T, 64, 512]
    int* __restrict__ checksum,                                  // [T]
    int iters, int seed) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int blocks_per_tile = kRows / kWarps;
  const int tile = blockIdx.x / blocks_per_tile;
  const int row = (blockIdx.x % blocks_per_tile) * kWarps + warp;
  const size_t base = ((size_t)tile * kRows + row) * kCols + lane;
  int a[kPer], b[kPer], c[kPer], d[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    a[k] = a_in[base + k * 32];
    b[k] = b_in[base + k * 32];
    c[k] = c_in[base + k * 32];
    d[k] = d_in[base + k * 32];
  }
  for (int it = 0; it < iters; ++it) {
    const int kk = wadd(it, seed);
    mix_round(a, b, kk, lane);
    mix_round(b, c, kk, lane);
    mix_round(c, d, kk, lane);
    mix_round(d, a, kk, lane);
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    a_out[base + k * 32] = a[k];
    b_out[base + k * 32] = b[k];
    c_out[base + k * 32] = c[k];
    d_out[base + k * 32] = d[k];
  }
  if (row == 0 && lane == 0) checksum[tile] = wadd(wadd(a[0], b[0]), wadd(c[0], d[0]));
}

}  // namespace

extern "C" {

const char* cuda_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

int mix_peak_launch(const int* a_in, const int* b_in, const int* c_in, const int* d_in,
                    int* a_out, int* b_out, int* c_out, int* d_out, int* checksum, int T,
                    int iters, int seed, void* stream) {
  mix_peak_kernel<<<T * (kRows / kWarps), kWarps * 32, 0, (cudaStream_t)stream>>>(
      a_in, b_in, c_in, d_in, a_out, b_out, c_out, d_out, checksum, iters, seed);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Row machinery of the sequence-to-graph DP kernels with gap channels
// (poa_affine.cu, poa_convex.cu): a sequence's W lanes over a block of
// W / LPT threads, thread t owning the LPT contiguous lanes
// [t*LPT, (t+1)*LPT) in registers.
//
//  - GraphRows: the graph's rows (code, in-degree, sink, the first PMAX
//    in-edge words) fetched 32 at a time, a batch ahead, lane k of every
//    warp holding row r0 + k's; the row loop takes them by shuffle.
//  - load_row16 / store_row16 / store_words: a thread's lanes of an int16
//    ring row and of an int32 direction row, in vector accesses where LPT
//    allows.
//  - RowExchange: what a warp's last thread publishes to the warps on its
//    right in one DP row, double-buffered by row parity, so that the row's
//    single __syncthreads both publishes this row's values and frees the
//    buffer the previous row read. A value published before barrier r and
//    read after it by another warp needs nothing more.
//  - warp_prefix_max: the 5-step shuffle scan of a row's running max (K5).
//  - MpPowers / mp_acc / mp_mul / warp_scan_mp: max-plus 2x2 algebra of a
//    coupled pair of gap channels (K6's (E, Q)), and its 5-step shuffle
//    scan over the warp with powers computed once, on the host.
//  - pin: a per-block constant kept in a register.
//  - h16: a cell value as an int16 ring holds it, for registers that stand
//    in for the ring (the previous row) so that both give the same bits.
//  - ThreadBest / store_best_lanes: the best cell over a thread's lanes,
//    then over the block.
#pragma once

#include <cuda_runtime.h>

#include <climits>

#include "poa_gap.cuh"

namespace vk {

// keeps v in a register: the compiler would otherwise recompute a constant
// in every row, or copy it out of a uniform register for each lane's select
__device__ __forceinline__ void pin(int& v) { asm volatile("" : "+r"(v)); }

// a value as the int16 rings store it: the poison floor, then the int16 cast
__device__ __forceinline__ int h16(int v) { return (int)(short)max(v, kNeg16); }

// inclusive prefix max over the warp's lanes (a lane below the offset gets
// its own value back from the shuffle, which leaves its max unchanged)
__device__ __forceinline__ int warp_prefix_max(int v) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) v = max(v, __shfl_up_sync(kFull, v, o));
  return v;
}

// Max-plus powers of a 2x2 matrix M = [[m11, m12], [m21, m22]] that a
// kernel with LPT lanes a thread needs, each {m11, m12, m21, m22}, from the
// host (the matrix is the scores' and never changes in a launch)
struct MpPowers {
  int seg[6][4];   // M^1 .. M^6: a thread's lane i from its carry, M^(i+1)
  int step[5][4];   // M^(LPT * 2^s): step s of the scan over a warp's threads
  int xstep[5][4];  // M^(32 * LPT * 2^s): step s of the scan over the warps
  int warp1[4];     // M^(32 * LPT - 1): to a warp's second-to-last lane
};

// (a, b) = max((a, b), m (x) (x, y)), max-plus: four DPX add-then-max
__device__ __forceinline__ void mp_acc(const int (&m)[4], int x, int y, int& a, int& b) {
  a = __viaddmax_s32(x, m[0], __viaddmax_s32(y, m[1], a));
  b = __viaddmax_s32(x, m[2], __viaddmax_s32(y, m[3], b));
}

// out = a (x) b, max-plus (out may be a)
__device__ __forceinline__ void mp_mul(const int (&a)[4], const int (&b)[4], int (&out)[4]) {
  const int o0 = max(a[0] + b[0], a[1] + b[2]), o1 = max(a[0] + b[1], a[1] + b[3]);
  const int o2 = max(a[2] + b[0], a[3] + b[2]), o3 = max(a[2] + b[1], a[3] + b[3]);
  out[0] = o0;
  out[1] = o1;
  out[2] = o2;
  out[3] = o3;
}

// Inclusive max-plus scan of (a, b) over the warp's first 2^S lanes (the
// rest take values from lanes they do not own), each lane's value the total
// of a segment of k DP lanes: after step s a lane holds v_l (+) M^(k 2^s)
// v_(l - 2^s) of the step before, `step[s]` being M^(k 2^s). A lane below
// the offset keeps its value: unlike a plain max, v (+) M^k v can exceed v.
template <int S = 5>
__device__ __forceinline__ void warp_scan_mp(const int (&step)[5][4], int lane, int& a, int& b) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int o = 1 << s;
    const int x = __shfl_up_sync(kFull, a, o), y = __shfl_up_sync(kFull, b, o);
    if (lane >= o) mp_acc(step[s], x, y, a, b);
  }
}

// The thread's LPT int16 lanes at p (p + LPT shorts from a 4-byte boundary
// when LPT is even: j0 = t * LPT), sign-extended.
template <int LPT>
__device__ __forceinline__ void load_row16(const short* p, int (&v)[LPT]) {
  if constexpr (LPT % 2 == 0) {
    int w[LPT / 2];
    if constexpr (LPT % 8 == 0) {
#pragma unroll
      for (int k = 0; k < LPT / 8; ++k) {
        const int4 q = reinterpret_cast<const int4*>(p)[k];
        w[4 * k] = q.x;
        w[4 * k + 1] = q.y;
        w[4 * k + 2] = q.z;
        w[4 * k + 3] = q.w;
      }
    } else if constexpr (LPT % 4 == 0) {
#pragma unroll
      for (int k = 0; k < LPT / 4; ++k) {
        const int2 q = reinterpret_cast<const int2*>(p)[k];
        w[2 * k] = q.x;
        w[2 * k + 1] = q.y;
      }
    } else {
#pragma unroll
      for (int k = 0; k < LPT / 2; ++k) w[k] = reinterpret_cast<const int*>(p)[k];
    }
#pragma unroll
    for (int k = 0; k < LPT / 2; ++k) {
      v[2 * k] = (int)((unsigned)w[k] << 16) >> 16;
      v[2 * k + 1] = w[k] >> 16;
    }
  } else {
#pragma unroll
    for (int i = 0; i < LPT; ++i) v[i] = p[i];
  }
}

// the low halves of v to the thread's LPT int16 lanes at p
template <int LPT>
__device__ __forceinline__ void store_row16(short* p, const int (&v)[LPT]) {
  if constexpr (LPT % 2 == 0) {
    int w[LPT / 2];
#pragma unroll
    for (int k = 0; k < LPT / 2; ++k) w[k] = (int)__byte_perm(v[2 * k], v[2 * k + 1], 0x5410);
    if constexpr (LPT % 8 == 0) {
#pragma unroll
      for (int k = 0; k < LPT / 8; ++k)
        reinterpret_cast<int4*>(p)[k] =
            make_int4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
    } else if constexpr (LPT % 4 == 0) {
#pragma unroll
      for (int k = 0; k < LPT / 4; ++k)
        reinterpret_cast<int2*>(p)[k] = make_int2(w[2 * k], w[2 * k + 1]);
    } else {
#pragma unroll
      for (int k = 0; k < LPT / 2; ++k) reinterpret_cast<int*>(p)[k] = w[k];
    }
  } else {
#pragma unroll
    for (int i = 0; i < LPT; ++i) p[i] = (short)v[i];
  }
}

// the thread's LPT int32 words at p: 16-byte stores when LPT % 4 == 0, 8-byte
// ones when it is even (rows start at multiples of W = 32k words)
template <int LPT>
__device__ __forceinline__ void store_words(int* p, const int (&v)[LPT]) {
  if constexpr (LPT % 4 == 0) {
#pragma unroll
    for (int k = 0; k < LPT / 4; ++k)
      reinterpret_cast<int4*>(p)[k] = make_int4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  } else if constexpr (LPT % 2 == 0) {
#pragma unroll
    for (int k = 0; k < LPT / 2; ++k)
      reinterpret_cast<int2*>(p)[k] = make_int2(v[2 * k], v[2 * k + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < LPT; ++i) p[i] = v[i];
  }
}

// The graph's rows, 32 a batch, one batch ahead: lane k of every warp holds
// row r0 + k's code, in-degree | sink << 8 and its first PMAX in-edge words
// (slots past PMAX are read in the row loop). Every warp fetches its own
// copy; they share the lines in L1.
template <int PMAX>
struct GraphRows {
  const int* codes;  // [N] of this graph
  const int* deg;
  const int* sink;
  const int* aux;    // [P, N]
  int N, P, nn, lane;
  int nc, nm, na[PMAX];  // the next batch
  int cc, cm, ca[PMAX];  // the current one

  __device__ __forceinline__ void fetch(int r0) {
    const int r = r0 + lane;
    const bool ok = r < nn;
    nc = ok ? codes[r] : 0;
    nm = ok ? deg[r] | (sink[r] != 0 ? 1 << 8 : 0) : 0;
#pragma unroll
    for (int p = 0; p < PMAX; ++p) na[p] = ok && p < P ? aux[(size_t)p * N + r] : 0;
  }
  // make the fetched batch (rows r0..) current and fetch the one after it
  __device__ __forceinline__ void advance(int r0) {
    cc = nc;
    cm = nm;
#pragma unroll
    for (int p = 0; p < PMAX; ++p) ca[p] = na[p];
    if (r0 + 32 < nn) fetch(r0 + 32);
  }
  __device__ __forceinline__ int code(int k) const { return __shfl_sync(kFull, cc, k); }
  __device__ __forceinline__ int meta(int k) const { return __shfl_sync(kFull, cm, k); }
  __device__ __forceinline__ int edge(int p, int k) const { return __shfl_sync(kFull, ca[p], k); }
  // in-edge word of slot p >= PMAX of row r (0-based)
  __device__ __forceinline__ int edge_far(int p, int r) const { return aux[(size_t)p * N + r]; }
};

// NV ints a warp publishes a row, [2 parities][NV][32 warps] in shared memory
template <int NV>
struct RowExchange {
  int* buf;
  static constexpr int kInts = 2 * NV * 32;
  __device__ __forceinline__ int* row(int hr) const { return buf + (hr & 1) * NV * 32; }
};

// The best cell over the thread's lanes: highest packed score (score *
// kTie + kTie - 1 - row), then the lowest lane.
struct ThreadBest {
  int best, lane;
  template <int LPT>
  __device__ __forceinline__ void update(const int (&h)[LPT], unsigned cmask, int hr, int j0) {
    int rm = INT_MIN;
#pragma unroll
    for (int i = 0; i < LPT; ++i)
      if ((cmask >> i) & 1u) rm = max(rm, h[i]);
    const int pack = rm * kTie + (kTie - 1 - hr);
    if (pack > best) {
      best = pack;
#pragma unroll
      for (int i = LPT - 1; i >= 0; --i)
        if (((cmask >> i) & 1u) && h[i] == rm) lane = j0 + i;
    }
  }
};

// best cell of the block from every thread's ThreadBest: highest score,
// then lowest row (packed), then lowest lane. Called by every thread.
__device__ __forceinline__ void store_best_lanes(const ThreadBest& tb, int mode, int* warp_buf,
                                                 int bd, int* maxi, int* maxj, int* score) {
  const int best = block_reduce(tb.best, warp_buf, false);
  const int jpick = block_reduce(tb.best == best ? tb.lane : INT_MAX, warp_buf, true);
  if (threadIdx.x == 0) {
    const int s = best >> 12;
    const int ipick = (kTie - 1) - (best & (kTie - 1));
    const bool empty = mode == kSW ? s <= 0 : ipick == 0;
    maxi[bd] = empty ? 0 : ipick;
    maxj[bd] = empty ? 0 : jpick;
    score[bd] = s;
  }
}

}  // namespace vk

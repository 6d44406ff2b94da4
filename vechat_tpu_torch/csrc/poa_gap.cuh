// Pieces shared by the affine (poa_affine.cu) and convex (poa_convex.cu)
// sequence-to-graph DP kernels: the code fields, the boundary rows, the
// best-cell pick and the three-state traceback walk.
//
// A direction word is one int32 per DP cell: chain << 16 | hcode.
//   hcode = prio << 9 | delta: the move that formed H. With K gap-channel
//     pairs (affine 1, convex 2) and idx = (2K+1)(P+1) - 1 - prio, first-true
//     order of the reference dispatch: idx < P diagonal through slot idx;
//     then per slot 2K vertical codes (extend, open per channel); then 2K
//     sequence-gap codes (extend, open per channel); last the sw stop.
//   chain = bit 14 (the sequence-gap chain continues to the left) | the
//     vertical chain's code (prio << 9 | delta) for the row above.
#pragma once

#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace vk {

constexpr int kDeltaBits = 9;
constexpr int kDmask = (1 << kDeltaBits) - 1;
constexpr int kTie = 4096;
constexpr int kNegV = -(1 << 30);
constexpr int kNeg16 = -16000;
constexpr int kChainBit = 14;
enum { kNW = 0, kSW = 1, kOV = 2 };

// initial value of the packed best cell (score * kTie + (kTie - 1 - row))
__device__ __forceinline__ int best_init(int mode) {
  return mode == kSW ? 0 : kNeg16 * kTie + (kTie - 1);
}

// best cell of the block: highest score, then lowest row (packed), then
// lowest lane. Called by every thread after the row loop.
__device__ __forceinline__ void store_best(int bestc, int mode, int* warp_buf, int bd,
                                           int* maxi, int* maxj, int* score) {
  const int j = threadIdx.x;
  const int best = block_reduce(bestc, warp_buf, false);
  const int jpick = block_reduce(bestc == best ? j : INT_MAX, warp_buf, true);
  if (j == 0) {
    const int s = best >> 12;
    const int ipick = (kTie - 1) - (best & (kTie - 1));
    const bool empty = mode == kSW ? s <= 0 : ipick == 0;
    maxi[bd] = empty ? 0 : ipick;
    maxj[bd] = empty ? 0 : jpick;
    score[bd] = s;
  }
}

// Three-state walk (H / vertical chain / sequence-gap chain), one thread per
// walk and one int32 load per step. Pairs go out back to front: step s of
// walk w writes column L-1-s of pn[w], pp[w] (both pre-filled with -2), the
// reference's layout; pn holds DP ranks. Bound by the dependent load. An nw
// walk ends at cell (0, 0) in any state: a start node's lane 0 enters the
// vertical chain towards row 0, and nothing lies beyond the origin.
template <int K>
__global__ void walk3_kernel(
    const int* __restrict__ dirs,  // [B, N1, D, W]
    const int* __restrict__ maxi, const int* __restrict__ maxj,  // [B, D]
    int* __restrict__ pn, int* __restrict__ pp,  // [B*D, L] filled with -2
    int* __restrict__ count,                     // [B, D]
    int B, int N1, int D, int W, int L, int P, int mode) {
  const int BD = B * D;
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= BD) return;
  const int b = w / D, d = w % D;
  const int NPRIO = (2 * K + 1) * (P + 1);
  const int VEND = (2 * K + 1) * P;  // first sequence-gap code
  const int* base = dirs + (size_t)b * N1 * D * W + (size_t)d * W;
  const size_t row_stride = (size_t)D * W;
  int* pn_w = pn + (size_t)w * L;
  int* pp_w = pp + (size_t)w * L;
  int i = maxi[w], j = maxj[w];
  const bool started = !(i == 0 && j == 0);
  bool active = mode == kOV ? (started && i != 0 && j != 0) : started;
  enum { ST_H = 0, ST_V = 1, ST_S = 2 };
  int state = ST_H, cnt = 0, step = 0;
  while (active && step < L) {
    const int word = base[(size_t)i * row_stride + j];
    const int hcode = word & 0xFFFF, chain = (word >> 16) & 0xFFFF;
    const int hidx = NPRIO - 1 - (hcode >> kDeltaBits);
    const int ccode = chain & ((1 << kChainBit) - 1);
    const int cidx = (2 * P - 1) - (ccode >> kDeltaBits);
    const bool in_h = state == ST_H, in_v = state == ST_V, in_s = state == ST_S;
    if (mode == kSW && in_h && hidx == VEND + 2 * K) break;  // the stop code
    const bool is_diag = in_h && hidx < P;
    const bool v_enter = in_h && hidx >= P && hidx < VEND;
    const bool v_ext_enter = v_enter && ((hidx - P) & 1) == 0;
    const bool s_move = in_h && hidx >= VEND && hidx < VEND + 2 * K;
    const bool s_ext = s_move && ((hidx - VEND) & 1) == 0;
    // affine chain codes: 2p open, 2p+1 extend; convex: p continue, P+p stop
    const bool v_cont = in_v && (K == 1 ? (cidx & 1) == 1 : cidx < P);
    const bool node = is_diag || v_enter || in_v;
    const bool seq = is_diag || s_move || in_s;
    const int delta = in_v ? (ccode & kDmask) : (hcode & kDmask);
    const int col = L - 1 - step;
    pn_w[col] = node ? i - 1 : -1;
    pp_w[col] = seq ? j - 1 : -1;
    if (node) i = delta == 0 ? 0 : i - delta;
    if (seq) j -= 1;
    state = (v_ext_enter || v_cont) ? ST_V
            : (s_ext || (in_s && ((chain >> kChainBit) & 1))) ? ST_S : ST_H;
    ++cnt;
    ++step;
    if (mode == kNW) active = !(i == 0 && j == 0);
    else if (mode == kOV) active = !(i == 0 || j == 0);
  }
  count[w] = started ? cnt : 0;
}

template <int K>
inline int launch_walk3(const int* dirs, const int* maxi, const int* maxj, int* pn, int* pp,
                        int* count, int B, int N1, int D, int W, int L, int P, int mode,
                        void* stream) {
  const int threads = 128;
  const int blocks = (B * D + threads - 1) / threads;
  walk3_kernel<K><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      dirs, maxi, maxj, pn, pp, count, B, N1, D, W, L, P, mode);
  return (int)cudaGetLastError();
}

}  // namespace vk

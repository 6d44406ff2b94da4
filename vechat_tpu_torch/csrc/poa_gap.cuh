// Pieces shared by the affine (poa_affine.cu) and convex (poa_convex.cu)
// sequence-to-graph DP kernels: the code fields, the boundary rows, the
// best-cell pick and the three-state traceback walk (K5w / K6w: one warp a
// walk over tiles of its direction words staged in shared memory).
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

#include <cuda_pipeline.h>
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

// K5w / K6w: the three-state walk (H / vertical chain / sequence-gap
// chain), one warp a walk, kWalk3Warps walks a block. It replaced one
// thread a walk, each of whose steps was a dependent int32 load from device
// memory (a walk's consecutive rows lie D*W*4 bytes apart). Now the warp
// stages a tile of its walk's words in shared memory: rows [i-63, i] of
// dirs[b, :, d, :] by the 32 columns that end with the 16-byte piece holding
// j, both clamped at 0, copied with cp.async in 16-byte pieces, every piece
// in flight at once, so a tile costs about one device-memory latency. A walk
// never moves to a higher row or column, so it steps from shared memory
// until it leaves the tile through its top or left edge; a vertical move of
// the chain code's delta (up to 511, or to row 0 for delta 0) leaves it from
// its middle. The warp then restages at that cell. Every lane runs the step
// on the same broadcast word, so the step has no branch; the decode is the
// reference's: the hidx / cidx dispatch, K's chain codes, sw's stop code and
// the nw / ov end tests. Lane k % 32 keeps the pair of step k; every 32
// steps, and once at the end, the warp writes those 32 pairs into 32
// consecutive columns, back to front (step s to column L-1-s); their node
// ids (node_id != nullptr) are loaded then and stored with the next chunk,
// so that the load stays off the chain of steps. Then the warp writes the
// -2 columns before its pairs. pn holds node ids, or DP ranks without
// node_id; -1 stays -1. What bounds it is the chain of dependent steps, each
// a shared-memory load and the decode, plus one device-memory latency a
// tile. No block barrier: a spare warp leaves. An nw walk ends at cell
// (0, 0) in any state: a start node's lane 0 enters the vertical chain
// towards row 0, and nothing lies beyond the origin.
constexpr int kWalk3Warps = 4;
constexpr int kWalk3Rows = 64;
// a 64 x 32 tile: 8 KB a warp, 32 KB a block of static shared memory (64 x
// 64 was no faster and needs the dynamic opt-in: PERF.md)
constexpr int kWalk3Cols = 32;

// Columns [0, n) of an int32 row to -2, by the warp: 16 bytes a lane
// between the row's first 16-byte boundary and its last, one column a lane
// before and after (rows start wherever w * L * 4 bytes puts them).
__device__ __forceinline__ void fill_neg2_i32(int* row, int n, int lane) {
  const int head = min(n, (int)(((16 - (reinterpret_cast<size_t>(row) & 15)) & 15) >> 2));
  if (lane < head) row[lane] = -2;
  const int pieces = (n - head) >> 2;
  int4* body = reinterpret_cast<int4*>(row + head);
  for (int c = lane; c < pieces; c += 32) body[c] = make_int4(-2, -2, -2, -2);
  const int tail = head + (pieces << 2);  // fewer than 4 columns left
  if (tail + lane < n) row[tail + lane] = -2;
}

// MODE (kNW, kSW, kOV) is a template parameter: tested at run time it made a
// step 15-23% slower (PERF.md, k1_probe.py time-walk3)
template <int K, int MODE>
__global__ void __launch_bounds__(32 * kWalk3Warps) walk3_kernel(
    const int* __restrict__ dirs,  // [B, N1, D, W], W % 4 == 0, 16-byte aligned
    const int* __restrict__ maxi, const int* __restrict__ maxj,  // [B, D]
    const int* __restrict__ node_id,  // [B, N1 - 1] or nullptr
    int* __restrict__ pn, int* __restrict__ pp,  // [B*D, L]
    int* __restrict__ count,                     // [B, D]
    int* __restrict__ tiles,                     // [B, D] tiles a walk staged, or nullptr
    int B, int N1, int D, int W, int L, int P) {
  __shared__ __align__(16) int walk3_smem[kWalk3Warps][kWalk3Rows * kWalk3Cols];
  constexpr int kPieces = kWalk3Cols / 4;  // 16-byte pieces a tile row
  constexpr int kRowsPass = 32 / kPieces;  // tile rows the warp copies at a time
  const int BD = B * D;
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int w = blockIdx.x * kWalk3Warps + wi;
  if (w >= BD) return;  // no block barrier: a spare warp just leaves
  const int b = w / D, d = w % D;
  const size_t row_stride = (size_t)D * W;
  int* tile = walk3_smem[wi];
  // this lane's piece of row 0 and of the tile
  const int* src0 = dirs + (size_t)b * N1 * row_stride + (size_t)d * W + (lane % kPieces) * 4 +
                    (size_t)(lane / kPieces) * row_stride;
  int* dst0 = tile + (lane / kPieces) * kWalk3Cols + (lane % kPieces) * 4;
  const int* nid = node_id ? node_id + (size_t)b * (N1 - 1) : nullptr;
  int* pn_w = pn + (size_t)w * L;
  int* pp_w = pp + (size_t)w * L;
  const int NPRIO = (2 * K + 1) * (P + 1);
  const int VEND = (2 * K + 1) * P;  // first sequence-gap code
  int i = maxi[w], j = maxj[w];
  bool active = MODE == kOV ? (i != 0 && j != 0) : !(i == 0 && j == 0);
  int r0 = i + 1, c0 = 0, n_tiles = 0;  // the tile's first row and column: none staged yet
  enum { ST_H = 0, ST_V = 1, ST_S = 2 };
  int state = ST_H, cnt = 0;
  int k = 0, hn = 0, hp = 0;      // pairs held; lane k's pair
  int qcol = -1, qn = 0, qp = 0;  // the lane's pair of the chunk before, and its column
  // store the chunk before; take this chunk's pairs (steps cnt-k .. cnt-1),
  // loading their node ids now and storing them at the next call
  auto chunk = [&]() {
    if (qcol >= 0) {
      pn_w[qcol] = qn;
      pp_w[qcol] = qp;
    }
    const bool mine = lane < k;
    qcol = mine ? L - 1 - (cnt - k + lane) : -1;
    qn = mine && hn >= 0 && nid ? nid[hn] : hn;
    qp = hp;
    k = 0;
  };
  while (active && cnt < L) {
    if (i < r0 || j < c0) {  // stage the tile that ends at (i, j)
      r0 = max(i - kWalk3Rows + 1, 0);
      c0 = max(((j + 4) & ~3) - kWalk3Cols, 0);
      __syncwarp();  // every lane has read its last word of the previous tile
      if ((lane % kPieces) * 4 < W - c0) {
        const int* src = src0 + (size_t)r0 * row_stride + c0;
        int* dst = dst0;
        for (int rr = lane / kPieces; rr <= i - r0; rr += kRowsPass) {
          __pipeline_memcpy_async(dst, src, 16);
          src += kRowsPass * row_stride;
          dst += kRowsPass * kWalk3Cols;
        }
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncwarp();  // every lane's pieces are in
      ++n_tiles;
    }
    const int word = tile[(i - r0) * kWalk3Cols + (j - c0)];
    const int hcode = word & 0xFFFF, chain = (word >> 16) & 0xFFFF;
    const int hidx = NPRIO - 1 - (hcode >> kDeltaBits);
    const int ccode = chain & ((1 << kChainBit) - 1);
    const int cidx = (2 * P - 1) - (ccode >> kDeltaBits);
    const bool in_h = state == ST_H, in_v = state == ST_V, in_s = state == ST_S;
    if (MODE == kSW && in_h && hidx == VEND + 2 * K) break;  // the stop code
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
    if (lane == k) {
      hn = node ? i - 1 : -1;
      hp = seq ? j - 1 : -1;
    }
    if (node) i = delta == 0 ? 0 : i - delta;
    if (seq) j -= 1;
    state = (v_ext_enter || v_cont) ? ST_V
            : (s_ext || (in_s && ((chain >> kChainBit) & 1))) ? ST_S : ST_H;
    ++cnt;
    if (++k == 32) chunk();
    if (MODE == kNW) active = !(i == 0 && j == 0);
    else if (MODE == kOV) active = !(i == 0 || j == 0);
  }
  if (k) chunk();
  if (qcol >= 0) {
    pn_w[qcol] = qn;
    pp_w[qcol] = qp;
  }
  fill_neg2_i32(pn_w, L - cnt, lane);
  fill_neg2_i32(pp_w, L - cnt, lane);
  if (lane == 0) {
    count[w] = cnt;
    if (tiles) tiles[w] = n_tiles;
  }
}

// K5w / K6w on walks [B, D]; tiles, if not null, gets the tiles each walk
// staged
template <int K>
inline int launch_walk3(const int* dirs, const int* maxi, const int* maxj, const int* node_id,
                        int* pn, int* pp, int* count, int* tiles, int B, int N1, int D, int W,
                        int L, int P, int mode, void* stream) {
  // the tiles are copied in 16-byte pieces: every row must start on one
  if (W % 4 != 0 || reinterpret_cast<size_t>(dirs) % 16 != 0 || mode < kNW || mode > kOV)
    return (int)cudaErrorInvalidValue;
  if (B * D == 0) return 0;
  auto kern = mode == kSW   ? &walk3_kernel<K, kSW>
              : mode == kOV ? &walk3_kernel<K, kOV>
                            : &walk3_kernel<K, kNW>;
  const int blocks = (B * D + kWalk3Warps - 1) / kWalk3Warps;
  kern<<<blocks, 32 * kWalk3Warps, 0, (cudaStream_t)stream>>>(dirs, maxi, maxj, node_id, pn, pp,
                                                               count, tiles, B, N1, D, W, L, P);
  return (int)cudaGetLastError();
}

}  // namespace vk

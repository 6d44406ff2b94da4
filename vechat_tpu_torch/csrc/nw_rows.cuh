// Row and walk machinery shared by the edit-distance NW kernels of
// pairwise_nw.cu, K3 (banded_kernel) and K4 (tiled_kernel): a thread owns
// LPT consecutive lanes of a DP row in registers and a row's values are
// kept as x = H + lane, in which the horizontal (insertion) chain is a plain
// prefix max. What lives here:
//   - the carry chain of that prefix max across a warp's threads, and the
//     carry into a warp from the totals of the warps before it;
//   - the direction codes' shift register, 2 bits a lane, and its store as
//     one 16-byte piece a thread every CR rows (a chunk);
//   - the staging of the rows a walk needs into shared memory, 64 rows at a
//     time, double-buffered with cp.async while thread 0 walks, and the
//     read of a cell's code there (K4's walk; K3's keeps a cursor).
#pragma once

#include <climits>

#include <cuda_pipeline.h>

namespace nw {

constexpr unsigned kFull = 0xffffffffu;
// below every x value a row can hold
constexpr int kLow = -(1 << 30);

// The direction codes of a thread's LPT lanes, 2*LPT bits a row, fill a
// slot of SB bits (8 up to LPT 4, else 16: 14 of them used at LPT 7); a 16-byte piece
// holds CR = 128 / SB rows (a chunk). Scratch layout, private to the
// kernels: [pair][chunk][thread] pieces, row k of a chunk at bit k * SB of
// the piece (word k / RPW), lane j of the thread 2 bits above. A walk stage
// holds 64 rows.
constexpr int chunk_rows(int lpt) { return lpt <= 4 ? 16 : 8; }

template <int LPT>
struct Layout {
  static constexpr int CR = chunk_rows(LPT);
  static constexpr int SB = 128 / CR;
  static constexpr int RPW = 32 / SB;
  static constexpr int STAGE = 64;
  static constexpr int SC = STAGE / CR;           // chunks a stage
  static constexpr int MAXW = LPT >= 3 ? 4 : 32;  // warps a block can have
};

// The carry into thread `lane` of its warp's prefix max, given its own total
// `tot` (the max over its lanes) and its left neighbour's `tl`. Where every
// lane is a cell of an edit-distance DP, x is nondecreasing along a row and
// each cell is at most 1 above its own candidates, so a thread's prefix from
// the left is tl or tl + 1: a carry bit, generated where tl is 1 above tot
// and passed on where they are equal, which two ballots and one add settle
// for all 32 threads. Lane 0 gets kLow.
__device__ __forceinline__ int carry_excl(int tot, int tl, int lane) {
  const unsigned gen = __ballot_sync(kFull, lane > 0 && tl - tot == 1);
  const unsigned pro = __ballot_sync(kFull, lane > 0 && tl == tot) | gen;
  const unsigned cin = (pro + gen) ^ pro ^ gen;  // bit t: the carry into thread t
  return lane == 0 ? kLow : tl + (int)((cin >> lane) & 1u);
}

// The carry into warp w: the max of the totals of the warps before it,
// which each warp's lane 0 published in xb[0, MAXW) behind a barrier
// (cap[v] passes warp v's total only for v < w).
template <int MAXW>
struct WarpCarry {
  int cap[MAXW];
  __device__ __forceinline__ explicit WarpCarry(int w) {
#pragma unroll
    for (int v = 0; v < MAXW; ++v) cap[v] = v < w ? INT_MAX : kLow;
  }
  __device__ __forceinline__ int before(const int* xb) const {
    int carry = kLow;
#pragma unroll
    for (int v = 0; v < MAXW; v += 4) {
      const int4 q = *reinterpret_cast<const int4*>(xb + v);
      carry = max(carry, max(max(min(q.x, cap[v]), min(q.y, cap[v + 1])),
                             max(min(q.z, cap[v + 2]), min(q.w, cap[v + 3]))));
    }
    return carry;
  }
};

// A 128-bit shift register of SB-bit row slots, the oldest row lowest; full
// after 128 / SB rows.
template <int SB>
struct CodeShift {
  unsigned r0 = 0, r1 = 0, r2 = 0, r3 = 0;
  __device__ __forceinline__ void push(unsigned bits) {
    r0 = __funnelshift_r(r0, r1, SB);
    r1 = __funnelshift_r(r1, r2, SB);
    r2 = __funnelshift_r(r2, r3, SB);
    r3 = __funnelshift_r(r3, bits, SB);
  }
  __device__ __forceinline__ void store(uint4* piece) const { *piece = make_uint4(r0, r1, r2, r3); }
};

// The rows a walk needs, rows 0..lt of a pair's pieces at dirp (NT a
// chunk), staged 64 at a time (SC chunks) into the two buffers at `stage`
// from the last stage down: the stage below is copied while thread 0 walks
// the current one (its pieces at pieces(), its first row base()). Every
// thread of the block makes it and calls next(), each time the walk goes on
// into the stage below.
template <int LPT>
struct Stages {
  using Lay = Layout<LPT>;
  const uint4* dirp;
  uint4* stage;
  int NT, used, sg;
  __device__ __forceinline__ Stages(const uint4* d, uint4* s, int nt, int lt)
      : dirp(d), stage(s), NT(nt), used(lt / Lay::CR + 1), sg(lt / Lay::STAGE) {
    __syncthreads();  // every thread's direction rows are in global memory
    load(sg);
    load(sg - 1);
    __pipeline_wait_prior(1);
    __syncthreads();
  }
  __device__ __forceinline__ void load(int g) {
    if (g >= 0) {
      const int t = threadIdx.x;
      uint4* dst = stage + (size_t)(g & 1) * Lay::SC * NT;
      for (int c = g * Lay::SC; c < min(g * Lay::SC + Lay::SC, used); ++c)
        __pipeline_memcpy_async(dst + (size_t)(c - g * Lay::SC) * NT + t,
                                dirp + (size_t)c * NT + t, sizeof(uint4));
    }
    __pipeline_commit();
  }
  __device__ __forceinline__ const uint4* pieces() const {
    return stage + (size_t)(sg & 1) * Lay::SC * NT;
  }
  __device__ __forceinline__ int base() const { return sg * Lay::STAGE; }
  // the code of row base() + ri, lane rl (in [0, NT * LPT)), read as its
  // cell's 32-bit word, the address from (ri, rl) alone: K4's walk, which
  // leaves a piece's lanes every 4th step, takes a third of the time a step
  // this way that a cursor kept in registers took; K3's, whose diagonal
  // steps keep the lane, keeps the cursor: this read took 12-17% longer
  // there (PERF.md)
  __device__ __forceinline__ int code(unsigned ri, unsigned rl) const {
    const unsigned* w = reinterpret_cast<const unsigned*>(pieces());
    const unsigned tt = rl / LPT;
    const unsigned word = w[((ri / Lay::CR) * NT + tt) * 4 + ri % Lay::CR / Lay::RPW];
    return (word >> (ri % Lay::RPW * Lay::SB + 2 * (rl - tt * LPT))) & 3;
  }
  __device__ __forceinline__ void next() {
    --sg;          // the walk went up into the stage below
    load(sg - 1);  // into the buffer just walked
    __pipeline_wait_prior(1);
    __syncthreads();
  }
};

// Thread 0's walk wrote its `wk` pairs at the end of the rows ptp, pqp of
// length L: the block fills the rest, their head, with -2. `wk_s` is an int
// of shared memory other than the flag the walk's stages were passed by.
template <class P>
__device__ __forceinline__ void fill_head(P* ptp, P* pqp, int L, int* wk_s, int wk) {
  if (threadIdx.x == 0) *wk_s = wk;
  __syncthreads();
  const int fill = L - *wk_s;
  for (int x = threadIdx.x; x < fill; x += blockDim.x) {
    ptp[x] = -2;
    pqp[x] = -2;
  }
}

}  // namespace nw

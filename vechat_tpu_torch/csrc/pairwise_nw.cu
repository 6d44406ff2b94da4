// Pairwise global edit-distance NW with in-kernel traceback for Hopper
// (sm_90a), with a plain C interface for ctypes: the banded exact mode (K3)
// and the 512x512 tiles of the anchor-tiled mode (K4).
//
// Replaces vechat_tpu/ops/kernels/pairwise_pallas.py: _kernel_banded
// (pallas_call in _pairwise_banded_impl) and _kernel (pallas_call in
// _pairwise_nw_pallas_impl). Scores are edit-distance (match 0, mismatch and
// gaps -1, maximised); ties break diagonal > vertical > horizontal (M > D >
// I). The plain PyTorch versions in ops/kernels/pairwise_nw.py compute the
// same outputs.
//
// Both kernels keep a thread's LPT lanes of a row in registers, a row's
// values as x = H + lane, one block barrier a row, 2-bit direction codes in
// a scratch buffer of their own layout and a traceback walk fed from shared
// memory: the machinery they share is csrc/nw_rows.cuh.
//
// K3, banded_kernel: one block per pair, 4 warps when BW is a multiple of
// 128 (both production buckets; BW / 128 band lanes a thread, 7 at BW 896),
// else BW / LPT threads for LPT 2 or 1; thread t owns lanes [t*LPT,
// (t+1)*LPT) in registers. It replaced a thread per lane whose rows each
// waited at three block barriers (two in a block-wide scan) behind global
// loads, and a direction byte a cell that thread 0 walked back alone from
// global memory. Now a row is: the lanes' diagonal and vertical candidates
// (the right neighbour's previous value by shuffle, one value a warp
// boundary through shared memory); the horizontal (insertion) chain as a
// serial max over the thread's lanes, then across the warp a carry bit that
// two ballots and an add settle (see the row loop), then one carry a warp
// from the warps' totals, double-buffered in shared memory behind the row's
// single __syncthreads; the direction codes, 2 bits a cell, shifted into a
// 128-bit register and written as one 16-byte piece a thread every 16 rows
// (8 from LPT 5 on: 16-bit row slots, 14 bits used at LPT 7). The target
// codes and the query code entering each warp's window come 32 rows at a
// time, fetched a batch ahead and taken by shuffle; the window slides by
// shuffle. Rows whose lanes all lie inside the DP matrix (1 <= j <= qlen)
// skip the band-edge selects (a choice per warp). After the rows the block
// stages the direction rows the walk needs into shared memory, 64 rows at
// a time, double-buffered with cp.async, and thread 0 walks them with the
// current 16-byte piece in registers; the block then fills pt/pq's unused
// head with -2. What bounds
// it is latency: a row's chain of dependent steps (shuffle, ballots, the
// barrier, the carry's shared-memory load) at one or two warps to a
// scheduler, and the walk's dependent steps in one thread (k1_probe.py
// time-k3 times the rows alone; PERF.md).
//
// K4, tiled_kernel: the full NW of one 512x512 tile (lane j = query
// position j - 1), K3's structure without the band edges; described above
// its kernel.

#include <cuda_runtime.h>

#include "nw_rows.cuh"

namespace {

constexpr int kNeg = -(1 << 28);
using nw::kFull;
using nw::kLow;  // below every x value a row can hold (kNeg - 2 at the least)

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

struct K3Args {
  const int* tcodes;  // [NP, T]
  const int* ext;     // [NP, BW + T]: ext[x] = q[lo + x], 0xFF outside q
  const int* tlen;
  const int* qlen;
  const int* lo;      // [NP] band low diagonal
  uint4* dir;         // [NP, nchunk, BW / LPT] packed direction codes (scratch)
  short* pt;          // [NP, T + BW]
  short* pq;
  int* count;         // [NP]
  int* dist;
  int T, BW, nchunk;
};


// Row r = target position (row 0 the boundary), lane l = diagonal offset,
// query position j = r + lo + l; the plain version's H[l] is kept as x =
// H[l] + l, in which the horizontal chain is a plain prefix max and every
// tie test is unchanged. Rows past the target length are never computed.
template <int LPT>
__global__ void __launch_bounds__(LPT >= 3 ? 128 : 1024) banded_kernel(const K3Args a) {
  using Lay = nw::Layout<LPT>;
  constexpr int SB = Lay::SB, MAXW = Lay::MAXW;
  // per row parity, the warps' totals [0, 32) and their first
  // lanes' x [32, 64); then the walk's state
  __shared__ __align__(16) int xs[2 * 64 + 4];
  extern __shared__ __align__(16) uint4 stage[];  // the walk's two stages
  const int T = a.T, BW = a.BW, L = T + BW;
  const int NT = BW / LPT;
  int t = threadIdx.x;
  asm volatile("" : "+r"(t));  // kept in a register, not re-read from SR_TID in the row loop
  const int lane = t & 31, w = t >> 5;
  const int l0 = t * LPT;          // the thread's first lane
  const int lw0 = w * 32 * LPT;    // the warp's first lane
  const int ln = lw0 + 32 * LPT;   // the next warp's first lane
  const int p = blockIdx.x;
  const int lt = a.tlen[p], lq = a.qlen[p], lod = a.lo[p];
  const int* tc = a.tcodes + (size_t)p * T;
  const int* E = a.ext + (size_t)p * (BW + T);
  uint4* dirp = a.dir + (size_t)p * a.nchunk * NT;

  // row 0: H = -j inside the matrix, kNeg outside; every code 2
  int G[LPT], qc[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int l = l0 + j, jv = lod + l;
    G[j] = (jv >= 0 && jv <= lq) ? -lod : kNeg + l;
    qc[j] = E[l];
  }
  // the next warp's first lane in the previous row (lane BW has H = kNeg)
  int nextG;
  {
    const int jv = lod + ln;
    nextG = ln >= BW ? kNeg + BW : ((jv >= 0 && jv <= lq) ? -lod : kNeg + ln);
  }
  nw::CodeShift<Lay::SB> codes;
  codes.push(0xAAAAAAAAu >> (32 - 2 * LPT));

  // target codes and the query code entering the warp's window, 32 rows a
  // batch: lane k holds row r0 + k's
  int ntc = 0, nqin = 0;
  auto fetch = [&](int r0) {
    const int i = r0 + lane;
    ntc = i < lt ? tc[i] : 0;
    nqin = i < lt && ln < BW + T - i ? E[i + ln] : 0xFF;
  };
  fetch(0);

  int gdown = __shfl_down_sync(kFull, G[0], 1);
  const nw::WarpCarry<MAXW> wc(w);
  int s[LPT], dg[LPT], vt[LPT];
  for (int r0 = 0; r0 < lt; r0 += 32) {
    const int ctc = ntc, cqin = nqin;
    if (r0 + 32 < lt) fetch(r0 + 32);
    const int rows = min(32, lt - r0);
    for (int k = 0; k < rows; ++k) {
      const int r = r0 + k + 1;
      const int e0 = r + lod + l0;  // j of the thread's first lane
      const int code = __shfl_sync(kFull, ctc, k);
      const int qnew = __shfl_sync(kFull, cqin, k);
      // warp-uniform: every lane of the warp inside the matrix, 1 <= j <= lq
      const bool inner = r + lod + lw0 >= 1 && r + lod + ln - 1 <= lq;
      const int gn = lane == 31 ? nextG : gdown;
      // candidates and the serial scan over the thread's lanes
      auto cand = [&](auto edge) {
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
          const int vx = (j + 1 < LPT ? G[j + 1] : gn) - 2;
          int dx = G[j] + (qc[j] == code ? 0 : -1);
          int x;
          if constexpr (decltype(edge)::value) {
            const int jv = e0 + j;
            if (jv < 1) dx = kNeg + l0 + j;
            x = jv == 0 ? -r + l0 + j : max(dx, vx);
          } else {
            x = max(dx, vx);
          }
          dg[j] = dx;
          vt[j] = vx;
          s[j] = j == 0 ? x : max(s[j - 1], x);
        }
      };
      if (inner) cand(Flag<false>());
      else cand(Flag<true>());
      // the horizontal chain across the warp's threads by the carry bit of
      // nw::carry_excl, which holds within the band (0 <= j <= qlen); lanes
      // outside the matrix are masked below, whatever their carry. The
      // warp's total goes to the other warps first, and the carry bits are
      // settled behind the barrier
      const int tot = s[LPT - 1];
      const int tl = __shfl_up_sync(kFull, tot, 1);
      const int wtot = __reduce_max_sync(kFull, tot);
      int* xb = xs + (r & 1) * 64;
      if (lane == 0) {
        xb[w] = wtot;
        xb[32 + w] = s[0];
      }
      __syncthreads();  // the row's one barrier: xb is read below, rewritten two rows on
      int excl = nw::carry_excl(tot, tl, lane);
      const int carry = wc.before(xb);
      excl = max(excl, carry);
      if (ln < BW) {
        const int jv = r + lod + ln;
        nextG = (jv >= 0 && jv <= lq) ? max(max(carry, wtot), xb[32 + w + 1]) : kNeg + ln;
      }
      // the row's values and direction codes (diagonal > vertical > horizontal)
      unsigned bits = 0;
      auto fin = [&](auto edge) {
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
          int R = max(s[j], excl);
          if constexpr (decltype(edge)::value) {
            const int jv = e0 + j;
            if (jv < 0 || jv > lq) R = kNeg + l0 + j;
          }
          const unsigned c = R == dg[j] ? 0u : (R == vt[j] ? 1u : 2u);
          bits |= c << (2 * j);
          G[j] = R;
        }
      };
      if (inner) fin(Flag<false>());
      else fin(Flag<true>());
      gdown = __shfl_down_sync(kFull, G[0], 1);  // the next row's right neighbour
      codes.push(bits);
      if (((r + 1) & (Lay::CR - 1)) == 0) codes.store(dirp + (size_t)(r / Lay::CR) * NT + t);
      // slide the query window: lane l's code at row r+1 is lane l+1's at r
      const int qn = __shfl_down_sync(kFull, qc[0], 1);
#pragma unroll
      for (int j = 0; j + 1 < LPT; ++j) qc[j] = qc[j + 1];
      qc[LPT - 1] = lane == 31 ? qnew : qn;
    }
  }
  // the last, partial chunk
  if (((lt + 1) & (Lay::CR - 1)) != 0) {
    for (int k = (lt + 1) & (Lay::CR - 1); k < Lay::CR; ++k) codes.push(0);
    codes.store(dirp + (size_t)(lt / Lay::CR) * NT + t);
  }
  const int ls = lq - lt - lod;  // lane of (tlen, qlen)
  if (ls < 0 || ls >= BW) {
    if (t == 0) a.dist[p] = -kNeg;
  } else {
#pragma unroll
    for (int j = 0; j < LPT; ++j)
      if (l0 + j == ls) a.dist[p] = ls - G[j];
  }
#ifdef K3_ROWS_ONLY
  return;  // k1_probe.py times the rows alone with this build
#endif

  // the walk: diag -> (i-1, l); vert -> (i-1, l+1); horiz -> (i, l-1). The
  // step bound and the clipping stop the walks of pairs that overflow the
  // band
  int* ws = xs + 128;  // the walk's state
  short* ptp = a.pt + (size_t)p * L;
  short* pqp = a.pq + (size_t)p * L;
  const bool started = !(lt == 0 && lq == 0);
  int wi = lt, wl = ls, wk = 0;
  short* opt = ptp + L;  // the walk's next pair goes just below these
  short* opq = pqp + L;
  bool ok = started;
  nw::Stages<LPT> st(dirp, stage, NT, lt);
  while (true) {
    if (t == 0) {
      const uint4* sp = st.pieces();
      const int base = st.base();
      // the walker's cell: the 16-byte piece holding it, in registers; its
      // word wd, row kr in the word, lane sub of the piece's thread, and bit
      // = kr * SB + 2 * sub. A step inside the piece moves these by
      // increments (a diagonal step keeps the lane); one that leaves it, or
      // a clipped lane, places it anew
      uint4 pc;
      unsigned word;
      int wd, kr, sub, bit;
      auto place = [&]() {
        wl = min(max(wl, 0), BW - 1);
        const int ri = wi - base, kk = ri % Lay::CR, tt = wl / LPT;
        pc = sp[(ri / Lay::CR) * NT + tt];
        wd = kk / Lay::RPW;
        kr = kk % Lay::RPW;
        sub = wl - tt * LPT;
        bit = kr * SB + 2 * sub;
        word = wd == 0 ? pc.x : (wd == 1 ? pc.y : (wd == 2 ? pc.z : pc.w));
      };
      bool on = ok && wk < L;  // i stays in [0, tlen]: row 0's codes are all horizontal
      if (on) place();
      while (on) {
        // one step, branch-free but for leaving the piece
        const int dv = (word >> bit) & 3;
        const bool up = dv < 2, vtv = dv == 1;  // diagonal or vertical: up a row
        const int dl = vtv ? 1 : (up ? 0 : -1);  // the lane's move
        *--opt = (short)(up ? wi - 1 : -1);
        *--opq = (short)(vtv ? -1 : wi + lod + wl - 1);
        ++wk;
        const bool wrap = up && kr == 0;  // up into the word before
        const bool left = (wrap && wd == 0) || (unsigned)(sub + dl) >= (unsigned)LPT;
        bit += (up ? (wrap ? SB * (Lay::RPW - 1) : -SB) : 0) + 2 * dl;
        kr = up ? (wrap ? Lay::RPW - 1 : kr - 1) : kr;
        wd -= wrap;
        sub += dl;
        if (wrap) word = wd == 0 ? pc.x : (wd == 1 ? pc.y : pc.z);
        wi -= up;
        wl += dl;
        ok = !(wi == 0 && wi + lod + wl == 0);
        on = ok && wk < L && wi >= base;
        if (on && left) place();
      }
      ws[0] = ok && wk < L;
    }
    __syncthreads();
    if (!ws[0]) break;  // every thread leaves together
    st.next();
  }
  // thread 0's state: the walk's length; the rest of pt/pq is -2
  if (t == 0) a.count[p] = started ? wk : 0;
  nw::fill_head(ptp, pqp, L, ws + 1, wk);
}

// lanes a thread of K3 at band width BW: 4 warps a pair where BW is a
// multiple of 128, else BW / LPT threads in whole warps
int k3_lanes(int BW) { return BW % 128 == 0 ? BW / 128 : (BW % 64 == 0 ? 2 : 1); }

// two walk stages of NT pieces a chunk: above 48 KB (over 384 threads, at
// widths that are not multiples of 128) only after opting in
template <int LPT>
size_t walk_stage_bytes(int NT) {
  return 2 * (size_t)nw::Layout<LPT>::SC * NT * sizeof(uint4);
}

template <class Kernel>
int launch_staged(Kernel kernel, int NP, int NT, size_t smem, cudaStream_t stream,
                  const void* args) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  void* argv[] = {const_cast<void*>(args)};
  return (int)cudaLaunchKernel((const void*)kernel, dim3(NP), dim3(NT), argv, smem, stream);
}

template <int LPT>
int k3_launch(const K3Args& a, int NP, cudaStream_t stream) {
  const int NT = a.BW / LPT;
  return launch_staged(banded_kernel<LPT>, NP, NT, walk_stage_bytes<LPT>(NT), stream, &a);
}

// K4: the full NW of one tile. Lane j = query position j - 1 (lane 0 the
// j = 0 column, every lane past qlen a cell of the pad 0xFF, which no target
// code matches); row r = target position r - 1; rows past the target length
// are never computed. One block a tile, W / LPT threads (4 warps of 4 lanes
// at W = 512), K3's row machinery without the band edges: x = H + j, so the
// diagonal is the left lane's previous x + 1 + profile (by __shfl_up_sync,
// at a warp boundary the carry into the warp of the row before, which is
// that lane's x), the vertical the lane's own previous x - 1, and the
// horizontal chain a prefix max: serial over the thread's lanes, the carry
// bit across the warp (every lane is a cell of an edit-distance DP, so it
// holds on all of them), the warps' totals behind the row's one barrier.
// The target codes come 32 rows a batch by shuffle; a lane's query code is
// fixed. 2-bit codes a cell (68 KB a 512x512 tile in scratch, against a
// byte a cell before), and the walk from 64-row stages in shared memory, as
// K3's; the block writes the -2 head. It replaced a thread a lane: the H
// row in shared memory, a block-wide scan a row (three barriers), a
// direction byte a cell in global scratch, pt/pq filled with -2 by the
// wrapper. What bounds it is latency: a row's chain of dependent steps
// (~0.17 us a row) and the walk's (~0.03 us a step), at one warp to a
// scheduler (k1_probe.py time-k4; PERF.md). One warp a tile of 16 lanes a
// thread, without the barrier, took 1.4x as long at 64 tiles and 0.68x at
// 456, and more launches on the main path carry few tiles (PERF.md).
struct K4Args {
  const int* tcodes;  // [NP, T]
  const int* qcodes;  // [NP, W] lane j = q[j - 1]
  const int* tlen;
  const int* qlen;
  uint4* dir;         // [NP, nchunk, W / LPT] packed direction codes (scratch)
  int* pt;            // [NP, T + W]
  int* pq;
  int* count;         // [NP]
  int* dist;
  int T, W, nchunk;
};

template <int LPT>
__global__ void __launch_bounds__(LPT >= 3 ? 128 : 1024) tiled_kernel(const K4Args a) {
  using Lay = nw::Layout<LPT>;
  // per row parity the warps' totals [0, 32); then the walk's state
  __shared__ __align__(16) int xs[2 * 32 + 4];
  extern __shared__ __align__(16) uint4 stage[];  // the walk's two stages
  const int T = a.T, W = a.W, L = T + W;
  const int NT = W / LPT;
  int t = threadIdx.x;
  asm volatile("" : "+r"(t));  // kept in a register, not re-read from SR_TID in the row loop
  const int lane = t & 31, w = t >> 5;
  const int l0 = t * LPT;  // the thread's first lane
  const int p = blockIdx.x;
  const int lt = a.tlen[p], lq = a.qlen[p];
  const int* tc = a.tcodes + (size_t)p * T;
  uint4* dirp = a.dir + (size_t)p * a.nchunk * NT;

  // row 0: H = -j, so x = 0 on every lane; every code 2
  int G[LPT], qc[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    G[j] = 0;
    qc[j] = a.qcodes[(size_t)p * W + l0 + j];
  }
  nw::CodeShift<Lay::SB> codes;
  codes.push(0xAAAAAAAAu >> (32 - 2 * LPT));

  // target codes 32 rows a batch: lane k holds row r0 + k's
  int ntc = 0;
  auto fetch = [&](int r0) { ntc = r0 + lane < lt ? tc[r0 + lane] : 0; };
  fetch(0);

  // the left lane's previous x: from the thread to the left, and at the
  // warp's first thread the previous warp's last lane (none for warp 0)
  int gl = __shfl_up_sync(kFull, G[LPT - 1], 1);
  int leftw = w == 0 ? kLow : 0;
  const nw::WarpCarry<Lay::MAXW> wc(w);
  int s[LPT], dg[LPT];
  for (int r0 = 0; r0 < lt; r0 += 32) {
    const int ctc = ntc;
    if (r0 + 32 < lt) fetch(r0 + 32);
    const int rows = min(32, lt - r0);
    for (int k = 0; k < rows; ++k) {
      const int r = r0 + k + 1;
      const int code = __shfl_sync(kFull, ctc, k);
      const int left = lane == 0 ? leftw : gl;
      // candidates and the serial scan over the thread's lanes
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int dx = (j == 0 ? left : G[j - 1]) + (qc[j] == code ? 1 : 0);
        const int x = max(dx, G[j] - 1);
        dg[j] = dx;
        s[j] = j == 0 ? x : max(s[j - 1], x);
      }
      const int tot = s[LPT - 1];
      const int tl = __shfl_up_sync(kFull, tot, 1);
      const int wtot = __reduce_max_sync(kFull, tot);
      int* xb = xs + (r & 1) * 32;
      if (lane == 0) xb[w] = wtot;
      __syncthreads();  // the row's one barrier: xb is read below, rewritten two rows on
      const int carry = wc.before(xb);  // also the previous warp's last lane's x in this row
      const int excl = max(nw::carry_excl(tot, tl, lane), carry);
      leftw = carry;
      // the row's values and direction codes (diagonal > vertical > horizontal)
      unsigned bits = 0;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int R = max(s[j], excl);
        const unsigned c = R == dg[j] ? 0u : (R == G[j] - 1 ? 1u : 2u);
        bits |= c << (2 * j);
        G[j] = R;
      }
      gl = __shfl_up_sync(kFull, G[LPT - 1], 1);
      codes.push(bits);
      if (((r + 1) & (Lay::CR - 1)) == 0) codes.store(dirp + (size_t)(r / Lay::CR) * NT + t);
    }
  }
  // the last, partial chunk
  if (((lt + 1) & (Lay::CR - 1)) != 0) {
    for (int k = (lt + 1) & (Lay::CR - 1); k < Lay::CR; ++k) codes.push(0);
    codes.store(dirp + (size_t)(lt / Lay::CR) * NT + t);
  }
  if (lq < 0 || lq >= W) {
    if (t == 0) a.dist[p] = -kNeg;
  } else {
#pragma unroll
    for (int j = 0; j < LPT; ++j)
      if (l0 + j == lq) a.dist[p] = lq - G[j];
  }
#ifdef K4_ROWS_ONLY
  return;  // k1_probe.py times the rows alone with this build
#endif

  // the walk from (tlen, qlen): diag -> (i-1, j-1); vert -> (i-1, j);
  // horiz -> (i, j-1). It ends at (0, 0), within tlen + qlen < L steps; a
  // qlen outside the row reads its nearest lane, as the plain version does
  int* ws = xs + 64;  // the walk's state
  int* ptp = a.pt + (size_t)p * L;
  int* pqp = a.pq + (size_t)p * L;
  const bool started = !(lt == 0 && lq == 0);
  int wi = lt, wl = lq, wk = 0;
  int* opt = ptp + L;  // the walk's next pair goes just below these
  int* opq = pqp + L;
  bool ok = started;
  nw::Stages<LPT> st(dirp, stage, NT, lt);
  while (true) {
    if (t == 0) {
      const int base = st.base();
      bool on = ok && wk < L;
      while (on) {
        const int dv = st.code(wi - base, min(max(wl, 0), W - 1));
        const bool up = dv < 2, vtv = dv == 1;  // diagonal or vertical: up a row
        *--opt = up ? wi - 1 : -1;
        *--opq = vtv ? -1 : wl - 1;
        ++wk;
        wi -= up;
        wl -= !vtv;  // diagonal or horizontal: a lane left
        ok = !(wi == 0 && wl == 0);
        on = ok && wk < L && wi >= base;
      }
      ws[0] = ok && wk < L;
    }
    __syncthreads();
    if (!ws[0]) break;  // every thread leaves together
    st.next();
  }
  if (t == 0) a.count[p] = started ? wk : 0;
  nw::fill_head(ptp, pqp, L, ws + 1, wk);
}

template <int LPT>
int k4_launch(const K4Args& a, int NP, cudaStream_t stream) {
  const int NT = a.W / LPT;
  return launch_staged(tiled_kernel<LPT>, NP, NT, walk_stage_bytes<LPT>(NT), stream, &a);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

long long banded_scratch_bytes(int T, int BW) {
  const int lpt = k3_lanes(BW);
  return (long long)(T / nw::chunk_rows(lpt) + 1) * (BW / lpt) * (long long)sizeof(uint4);
}

int banded_launch(const int* tcodes, const int* ext, const int* tlen, const int* qlen,
                  const int* lo, void* dir, short* pt, short* pq, int* count, int* dist,
                  int NP, int T, int BW, void* stream) {
  if (BW % 32 != 0 || BW < 32 || BW > 1024 || T < 0) return (int)cudaErrorInvalidValue;
  const int lpt = k3_lanes(BW);
  const K3Args a{tcodes, ext, tlen, qlen, lo, static_cast<uint4*>(dir), pt, pq, count, dist,
                 T, BW, T / nw::chunk_rows(lpt) + 1};
  cudaStream_t st = (cudaStream_t)stream;
  switch (lpt) {
    case 1: return k3_launch<1>(a, NP, st);
    case 2: return k3_launch<2>(a, NP, st);
    case 3: return k3_launch<3>(a, NP, st);
    case 4: return k3_launch<4>(a, NP, st);
    case 5: return k3_launch<5>(a, NP, st);
    case 6: return k3_launch<6>(a, NP, st);
    case 7: return k3_launch<7>(a, NP, st);
    default: return k3_launch<8>(a, NP, st);
  }
}

long long tiled_scratch_bytes(int T, int W) { return banded_scratch_bytes(T, W); }

// K4 takes K3's lanes a thread at W (4 warps of W / 128 lanes where W is a
// multiple of 128) and so its scratch layout
int tiled_launch(const int* tcodes, const int* qcodes, const int* tlen, const int* qlen,
                 void* dir, int* pt, int* pq, int* count, int* dist, int NP, int T, int W,
                 void* stream) {
  if (W % 32 != 0 || W < 32 || W > 1024 || T < 0) return (int)cudaErrorInvalidValue;
  const int lpt = k3_lanes(W);
  const K4Args a{tcodes, qcodes, tlen, qlen, static_cast<uint4*>(dir), pt, pq, count, dist,
                 T, W, T / nw::chunk_rows(lpt) + 1};
  cudaStream_t st = (cudaStream_t)stream;
  switch (lpt) {
    case 1: return k4_launch<1>(a, NP, st);
    case 2: return k4_launch<2>(a, NP, st);
    case 3: return k4_launch<3>(a, NP, st);
    case 4: return k4_launch<4>(a, NP, st);
    case 5: return k4_launch<5>(a, NP, st);
    case 6: return k4_launch<6>(a, NP, st);
    case 7: return k4_launch<7>(a, NP, st);
    default: return k4_launch<8>(a, NP, st);
  }
}

}  // extern "C"

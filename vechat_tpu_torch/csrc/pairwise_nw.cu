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
// a time, double-buffered
// with cp.async, and thread 0 walks them with the current 16-byte piece in
// registers; the block then fills pt/pq's unused head with -2. What bounds
// it is latency: a row's chain of dependent steps (shuffle, ballots, the
// barrier, the carry's shared-memory load) at one or two warps to a
// scheduler, and the walk's dependent steps in one thread (k1_probe.py
// time-k3 times the rows alone; PERF.md).
//
// K4 is described above its kernel.

#include <climits>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr int kNeg = -(1 << 28);
constexpr unsigned kFull = 0xffffffffu;
// below every x value a row can hold (kNeg - 2 at the least)
constexpr int kLow = -(1 << 30);

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// The direction codes of a thread's LPT lanes, 2*LPT bits a row, fill a
// slot of SB bits (8 up to LPT 4, else 16: 14 of them used at LPT 7); a
// 16-byte piece holds CR = 128 / SB rows (a chunk). Scratch layout, private
// to the kernel: [pair][chunk][thread] pieces, row k of a chunk at bit k *
// SB of the piece (word k / RPW), lane j of the thread 2 bits above. A walk
// stage holds 64 rows.
constexpr int k3_chunk_rows(int lpt) { return lpt <= 4 ? 16 : 8; }

template <int LPT>
struct K3Layout {
  static constexpr int CR = k3_chunk_rows(LPT);
  static constexpr int SB = 128 / CR;
  static constexpr int RPW = 32 / SB;
  static constexpr int STAGE = 64;
  static constexpr int MAXW = LPT >= 3 ? 4 : 32;  // warps a block can have
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
  using Lay = K3Layout<LPT>;
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
  // the codes: a 128-bit shift register of SB-bit row slots, the oldest
  // row lowest; full after CR rows
  unsigned sr0 = 0, sr1 = 0, sr2 = 0, sr3 = 0;
  auto push = [&](unsigned bits) {
    sr0 = __funnelshift_r(sr0, sr1, SB);
    sr1 = __funnelshift_r(sr1, sr2, SB);
    sr2 = __funnelshift_r(sr2, sr3, SB);
    sr3 = __funnelshift_r(sr3, bits, SB);
  };
  auto store = [&](int r) {  // the chunk ending at row r
    dirp[(size_t)(r / Lay::CR) * NT + t] = make_uint4(sr0, sr1, sr2, sr3);
  };
  push(0xAAAAAAAAu >> (32 - 2 * LPT));

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
  int cap[MAXW];
#pragma unroll
  for (int v = 0; v < MAXW; ++v) cap[v] = v < w ? INT_MAX : kLow;
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
      // the horizontal chain across the warp's threads. Within the band
      // (0 <= j <= qlen) the edit-distance DP keeps x nondecreasing along a
      // row and each cell at most 1 above its own candidates, so a thread's
      // prefix from the left is its left neighbour's total T or T + 1: a
      // carry bit, generated where the neighbour's total is 1 above this
      // thread's and passed on where they are equal, which two ballots and
      // one add settle for all 32 threads (lanes outside the matrix are
      // masked below, whatever their carry). The warp's total goes to the
      // other warps first, and the carry bits are settled behind the barrier
      const int tot = s[LPT - 1];
      const int tl = __shfl_up_sync(kFull, tot, 1);
      const int wtot = __reduce_max_sync(kFull, tot);
      int* xb = xs + (r & 1) * 64;
      if (lane == 0) {
        xb[w] = wtot;
        xb[32 + w] = s[0];
      }
      __syncthreads();  // the row's one barrier: xb is read below, rewritten two rows on
      const unsigned gen = __ballot_sync(kFull, lane > 0 && tl - tot == 1);
      const unsigned pro = __ballot_sync(kFull, lane > 0 && tl == tot) | gen;
      const unsigned cin = (pro + gen) ^ pro ^ gen;  // bit t: the carry into thread t
      int excl = lane == 0 ? kLow : tl + (int)((cin >> lane) & 1u);
      // the carry into the warp: the max of the totals of the warps before
      // it (cap[v] passes warp v's total only for v < w)
      int carry = kLow;
#pragma unroll
      for (int v = 0; v < MAXW; v += 4) {
        const int4 q = *reinterpret_cast<const int4*>(xb + v);
        carry = max(carry, max(max(min(q.x, cap[v]), min(q.y, cap[v + 1])),
                               max(min(q.z, cap[v + 2]), min(q.w, cap[v + 3]))));
      }
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
      push(bits);
      if (((r + 1) & (Lay::CR - 1)) == 0) store(r);
      // slide the query window: lane l's code at row r+1 is lane l+1's at r
      const int qn = __shfl_down_sync(kFull, qc[0], 1);
#pragma unroll
      for (int j = 0; j + 1 < LPT; ++j) qc[j] = qc[j + 1];
      qc[LPT - 1] = lane == 31 ? qnew : qn;
    }
  }
  // the last, partial chunk
  if (((lt + 1) & (Lay::CR - 1)) != 0) {
    for (int k = (lt + 1) & (Lay::CR - 1); k < Lay::CR; ++k) push(0);
    store(lt);
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
  // band. Rows are staged 64 at a time (SC chunks), the next stage copied
  // while thread 0 walks the current one
  __syncthreads();  // every thread's direction rows are in global memory
  int* ws = xs + 128;  // the walk's state
  constexpr int SC = Lay::STAGE / Lay::CR;
  const int used = lt / Lay::CR + 1;  // chunks holding rows 0..lt
  auto load = [&](int sg) {
    if (sg >= 0) {
      uint4* dst = stage + (size_t)(sg & 1) * SC * NT;
      for (int c = sg * SC; c < min(sg * SC + SC, used); ++c)
        __pipeline_memcpy_async(dst + (size_t)(c - sg * SC) * NT + t, dirp + (size_t)c * NT + t,
                                sizeof(uint4));
    }
    __pipeline_commit();
  };
  int sg = lt / Lay::STAGE;
  load(sg);
  load(sg - 1);
  __pipeline_wait_prior(1);
  short* ptp = a.pt + (size_t)p * L;
  short* pqp = a.pq + (size_t)p * L;
  const bool started = !(lt == 0 && lq == 0);
  int wi = lt, wl = ls, wk = 0;
  short* opt = ptp + L;  // the walk's next pair goes just below these
  short* opq = pqp + L;
  bool ok = started;
  __syncthreads();
  while (true) {
    if (t == 0) {
      const uint4* sp = stage + (size_t)(sg & 1) * SC * NT;
      const int base = sg * Lay::STAGE;
      // the walker's cell: the 16-byte piece holding it, in registers; its
      // word wd, row kr in the word, lane sub of the piece's thread, and bit
      // = kr * SB + 2 * sub. A step inside the piece moves these by
      // increments; one that leaves it, or a clipped lane, places it anew
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
    --sg;               // the walk went up into the stage below
    load(sg - 1);       // into the buffer just walked
    __pipeline_wait_prior(1);
    __syncthreads();
  }
  // thread 0's state: the walk's length; the rest of pt/pq is -2
  if (t == 0) {
    a.count[p] = started ? wk : 0;
    ws[1] = wk;
  }
  __syncthreads();
  const int fill = L - ws[1];
  for (int x = t; x < fill; x += blockDim.x) {
    ptp[x] = -2;
    pqp[x] = -2;
  }
}

// lanes a thread of K3 at band width BW: 4 warps a pair where BW is a
// multiple of 128, else BW / LPT threads in whole warps
int k3_lanes(int BW) { return BW % 128 == 0 ? BW / 128 : (BW % 64 == 0 ? 2 : 1); }

template <int LPT>
int k3_launch(const K3Args& a, int NP, cudaStream_t stream) {
  using Lay = K3Layout<LPT>;
  const int NT = a.BW / LPT;
  // two walk stages: above 48 KB (BW / LPT over 384 threads, at widths
  // that are not multiples of 128) only after opting in
  const size_t smem = 2 * (size_t)(Lay::STAGE / Lay::CR) * NT * sizeof(uint4);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        banded_kernel<LPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  banded_kernel<LPT><<<NP, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// K4: full NW of one tile, lane j = query position j-1 (lane 0 = the j = 0
// boundary column). Rows past the target length are never read. One block
// per tile, one thread per lane: the H row in shared memory, a block-wide
// max-scan per row (two barriers) and a third barrier, a direction byte a
// cell in global scratch that one thread walks back. Bound by the row's
// barriers and the walk's dependent loads; K3's structure would suit it.
__global__ void tiled_kernel(
    const int* __restrict__ tcodes,  // [NP, T]
    const int* __restrict__ qcodes,  // [NP, W] lane j = q[j-1]
    const int* __restrict__ tlen, const int* __restrict__ qlen,
    signed char* __restrict__ dir,   // [NP, T+1, W] scratch
    int* __restrict__ pt, int* __restrict__ pq,  // [NP, T + W] -2-filled
    int* __restrict__ count, int* __restrict__ dist,
    int T, int W) {
  extern __shared__ int smem[];
  int* warp_buf = smem;
  int* Hs = smem + 32;  // [W] the current row
  const int p = blockIdx.x, j = threadIdx.x, L = T + W;
  const int lt = tlen[p], lq = qlen[p];
  const int* tc = tcodes + (size_t)p * T;
  const int qc = qcodes[(size_t)p * W + j];
  signed char* Dp = dir + (size_t)p * (T + 1) * W;

  Hs[j] = -j;
  Dp[j] = 2;
  __syncthreads();
  for (int r = 0; r < lt; ++r) {
    const int prof = qc == tc[r] ? 0 : -1;
    const int diag = (j == 0 ? kNeg : Hs[j - 1]) + prof;
    const int vert = Hs[j] - 1;
    const int val = j == 0 ? vert : max(diag, vert);
    const int run = vk::block_prefix_max(val + j, warp_buf) - j;
    // every read of Hs in this row happened before the scan's barriers
    Hs[j] = run;
    Dp[(size_t)(r + 1) * W + j] = run == diag ? 0 : (run == vert ? 1 : 2);
    __syncthreads();
  }
  if (j != 0) return;
  dist[p] = -((lq >= 0 && lq < W) ? Hs[lq] : kNeg);
  int* ptp = pt + (size_t)p * L;
  int* pqp = pq + (size_t)p * L;
  const bool started = !(lt == 0 && lq == 0);
  bool ok = started;
  int i = lt, jj = lq, k = 0;
  // a walk from (tlen, qlen) ends within tlen + qlen < L steps; the bound
  // only keeps malformed input inside the buffers
  while (ok && k < L) {
    const int dv = Dp[(size_t)i * W + jj];
    const bool dg = dv == 0, vt = dv == 1;
    const int pi = (dg || vt) ? i - 1 : i;
    const int pj = (dg || !vt) ? jj - 1 : jj;
    ptp[L - 1 - k] = i == pi ? -1 : i - 1;
    pqp[L - 1 - k] = jj == pj ? -1 : jj - 1;
    i = pi;
    jj = pj;
    ++k;
    ok = !(i == 0 && jj == 0);
  }
  count[p] = started ? k : 0;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

long long banded_scratch_bytes(int T, int BW) {
  const int lpt = k3_lanes(BW);
  return (long long)(T / k3_chunk_rows(lpt) + 1) * (BW / lpt) * (long long)sizeof(uint4);
}

int banded_launch(const int* tcodes, const int* ext, const int* tlen, const int* qlen,
                  const int* lo, void* dir, short* pt, short* pq, int* count, int* dist,
                  int NP, int T, int BW, void* stream) {
  if (BW % 32 != 0 || BW < 32 || BW > 1024 || T < 0) return (int)cudaErrorInvalidValue;
  const int lpt = k3_lanes(BW);
  const K3Args a{tcodes, ext, tlen, qlen, lo, static_cast<uint4*>(dir), pt, pq, count, dist,
                 T, BW, T / k3_chunk_rows(lpt) + 1};
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

int tiled_launch(const int* tcodes, const int* qcodes, const int* tlen, const int* qlen,
                 signed char* dir, int* pt, int* pq, int* count, int* dist, int NP, int T,
                 int W, void* stream) {
  const size_t smem = (32 + (size_t)W) * sizeof(int);
  tiled_kernel<<<NP, W, smem, (cudaStream_t)stream>>>(
      tcodes, qcodes, tlen, qlen, dir, pt, pq, count, dist, T, W);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Convex (dual-affine) sequence-to-graph DP (K6) and its three-state
// traceback walk (K6w) for Hopper (sm_90a), with a plain C interface for
// ctypes.
//
// Replaces vechat_tpu/ops/kernels/poa_pallas_convex.py: _dp_kernel_convex
// (pallas_call in _poa_dp_pallas_convex) and _traceback_walk_convex. The
// direction words, the priority orders, the lane-0 rules, the int16 clamp
// and the best-cell pack are the reference's bit for bit; the plain PyTorch
// versions in ops/kernels/poa_convex.py compute the same outputs.
//
//   F[i][j] = max_p max(H[p][j] + g, F[p][j] + e)
//   O[i][j] = max_p max(H[p][j] + q, O[p][j] + c)
//   E[i][j] = max(H[i][j-1] + g, E[i][j-1] + e)
//   Q[i][j] = max(H[i][j-1] + q, Q[i][j-1] + c)
//   H[i][j] = max(diag, F, O, E, Q [, 0])
//
// K6: one block per (graph b, sequence d) of W / LPT threads, thread t
// owning lanes [t*LPT, (t+1)*LPT) in registers (LPT, 1-6, chosen per W by
// the wrapper), a loop over DP rows, on K5's row machinery (gap_rows.cuh).
// It replaced a thread per lane whose rows each waited at ceil(log2 W) + 3
// block barriers: a Hillis-Steele scan of (E, Q) through shared memory
// that squared the scan's matrix in every thread at every step. Now a row
// is:
//  - the in-edges, block-uniform: one from the row just above takes H, F
//    and O from the thread's registers (the diagonal's left lane by
//    shuffle; at a warp's first lane a value rebuilt from what the left
//    warp published, below); others read the three int16 rings. Per lane
//    and in-edge three scalings and nine DPX add-then-max into packed
//    maxes: the diagonal, H's four vertical candidates, and the four
//    channel winners of the vertical-chain code, all at H's shift (their
//    codes fit below it); a winner that reaches its channel's value has
//    its code as the excess over it, so two maxes give the chain code. A
//    row of one in-edge (most rows) needs none of the winners' maxes: the
//    chain code compares the channels' extend and open values.
//  - (E, Q) as the max-plus recurrence u_j = (A0[j] + g, A0[j] + q) (+)
//    M u_(j-1), M = [[e, g], [q, c]], read one lane to the right (E and Q
//    of lane j are u_(j-1)): serial over the thread's lanes from nothing,
//    a 5-step shuffle scan of the threads' totals applying M^(LPT 2^s),
//    the carry from the totals of the warps to the left (published before
//    the row's single __syncthreads, double-buffered by row parity), read
//    one warp a lane and scanned with M^(32 LPT 2^s), then each lane from
//    the thread's incoming vector with M^(i+1); the thread's M^(lane LPT)
//    is set before the row loop and every other power comes from the host.
//    No power is formed in a row.
//  - EBe / QBq compare E and Q with the lane to the left's: the thread's
//    own, the left thread's by shuffle, or at a warp's first lane the left
//    warp's second-to-last lane, rebuilt from its published prefix there
//    and the carry into it. The same value and the left warp's published
//    A0 give the H of the left warp's last lane, which the next row's
//    diagonal needs and which a ring slot written after the barrier could
//    not give without a race.
//  - the thread's LPT direction words and ring lanes out as vector stores.
// The graph rows come 32 at a time, fetched a batch ahead in registers and
// taken by shuffle a row ahead. The rings are read only by edges of delta
// >= 2 or 0 and are written after the row's barrier: a slot written after
// barrier r is read at row r + 2 or later, behind barrier r + 1; slot R,
// the boundary row, is written before the loop. They sit in shared memory
// up to K6's own limit (227 KB with the exchange), else in a global scratch
// ring (a template parameter, as is sw's clamp). What bounds it is the
// latency of a row's chain at one warp to a scheduler: the spoa path
// launches one block, B = D = 1 (PERF.md, k1_probe.py time-k6).
// K6w: vk::walk3_kernel<2, MODE>, one warp a walk over tiles of its
// direction words staged in shared memory with cp.async, its pairs written
// 32 columns at a time with node ids and the -2 columns (poa_gap.cuh).

#include <cstring>

#include "gap_rows.cuh"

namespace {

using namespace vk;

struct K6Args {
  const int* codes;    // [B, N] node codes, rank order
  const int* aux;      // [B, P, N] hslot << 16 | delta
  const int* deg;      // [B, N] true in-degree (>= 1)
  const int* sink;     // [B, N] 1 = no out-edges
  const int* n_nodes;  // [B]
  const int* seqp;     // [B, D, W] lane j = code of position j-1
  const int* slen;     // [B, D]
  int* dirs;           // [B, N+1, D, W] out: FOCB << 16 | Hcode
  int* maxi;           // [B, D] out
  int* maxj;
  int* score;
  short* rings;        // [B*D, 3, R+1, W] scratch when the rings are not in shared memory
  int N, P, D, W, R, mode, m, x, g, e, q, c, SH;
  MpPowers pw;         // of M = [[e, g], [q, c]] at the launch's LPT
};

// in-edge slots fetched ahead in registers, as K5's
constexpr int kK6Pmax = 2;
// a warp publishes its (E, Q) total, its (E, Q) prefix at its second-to-last
// lane and A0 of its last lane
using K6Exchange = RowExchange<5>;
// dynamic shared memory before the rings: the exchange and the reductions' 32
constexpr int kK6HeadInts = K6Exchange::kInts + 32;
// steps of the scan over a block's warps: 2^S >= its most warps at LPT
template <int LPT>
constexpr int kScanSteps = (1024 / LPT + 31) / 32 > 16 ? 5
                           : (1024 / LPT + 31) / 32 > 8 ? 4
                           : (1024 / LPT + 31) / 32 > 4 ? 3 : 2;

template <int LPT, bool SW, bool SMEM>
__global__ void __launch_bounds__((1024 / LPT + 31) / 32 * 32)
    poa_dp_convex_kernel(const K6Args a) {
  extern __shared__ __align__(16) int k6_smem[];
  const int N = a.N, P = a.P, D = a.D, W = a.W, R = a.R;
  const int g = a.g, e = a.e, q = a.q, c = a.c;
  const bool nw = a.mode == kNW;
  int t = threadIdx.x;
  pin(t);
  const int lane = t & 31, w = t >> 5;
  const int j0 = t * LPT;
  const int bd = blockIdx.x, b = bd / D, d = bd % D;
  const K6Exchange xch{k6_smem};
  int* warp_buf = k6_smem + K6Exchange::kInts;
  const size_t ring = (size_t)(R + 1) * W;
  short* H = SMEM ? reinterpret_cast<short*>(k6_smem + kK6HeadInts)
                   : a.rings + (size_t)bd * 3 * ring;
  short* F = H + ring;
  short* O = F + ring;
  const int SH = a.SH, VSH = 1 << SH;
  const int MASK = VSH - 1;
  const int NPRIO = 5 * P + 5;
  int MS = a.m * VSH, XS = a.x * VSH;
  // sequence-gap codes; slot p's codes are formed per in-edge
  int EEXT = (NPRIO - 1 - 5 * P) << kDeltaBits;
  int EOPEN = (NPRIO - 1 - (5 * P + 1)) << kDeltaBits;
  int QEXT = (NPRIO - 1 - (5 * P + 2)) << kDeltaBits;
  int QOPEN = (NPRIO - 1 - (5 * P + 3)) << kDeltaBits;
  // slot 0's codes without the delta, each with its gap score: the
  // diagonal; H's F-extend, F-open, O-extend, O-open; the chain's channel
  // winners (slot priority P - 1 - p) F-extend, F-open, O-extend, O-open
  int KD0 = (NPRIO - 1) << kDeltaBits;
  int KFE0 = e * VSH + ((NPRIO - 1 - P) << kDeltaBits);
  int KFO0 = g * VSH + ((NPRIO - 2 - P) << kDeltaBits);
  int KOE0 = c * VSH + ((NPRIO - 3 - P) << kDeltaBits);
  int KOO0 = q * VSH + ((NPRIO - 4 - P) << kDeltaBits);
  int KGE0 = e * VSH + ((P - 1) << kDeltaBits);
  int KGO0 = g * VSH + ((P - 1) << kDeltaBits);
  int KCE0 = c * VSH + ((P - 1) << kDeltaBits);
  int KCO0 = q * VSH + ((P - 1) << kDeltaBits);
  // a continue's chain code is its winner's code plus this; a stop's is
  // its winner's code, below every continue's
  int PC = P << kDeltaBits;
  pin(MS);
  pin(XS);
  pin(EEXT);
  pin(EOPEN);
  pin(QEXT);
  pin(QOPEN);
  pin(KD0);
  pin(KFE0);
  pin(KFO0);
  pin(KOE0);
  pin(KOO0);
  pin(KGE0);
  pin(KGO0);
  pin(KCE0);
  pin(KCO0);
  pin(PC);
  const int sl = a.slen[bd];
  const size_t row_stride = (size_t)D * W;
  int* drow = a.dirs + ((size_t)b * (N + 1) * D + d) * W + j0;

  // M^(lane LPT): from the thread's carry in the warp to its lane j0 - 1
  // (lane 0 takes the warp's carry as it is; the max-plus identity's
  // off-diagonal kNegV never wins)
  int ml[4] = {0, kNegV, kNegV, 0};
#pragma unroll
  for (int s = 0; s < 5; ++s)
    if ((lane >> s) & 1) mp_mul(ml, a.pw.step[s], ml);
#pragma unroll
  for (int k = 0; k < 4; ++k) pin(ml[k]);

  // per lane: the query code and whether the lane may hold the best cell;
  // hp, fp, op: H, F and O of the previous row, as the rings hold them;
  // first the boundary row, which ring slot R pins: H row 0 is the higher
  // of the two gap lines (zeros in sw), F and O row 0 = [g - e | q - c,
  // -inf, ...]
  int qc[LPT];
  unsigned cmask = 0;
  int hp[LPT], fp[LPT], op[LPT], w0[LPT];
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const int j = j0 + i;
    qc[i] = a.seqp[(size_t)bd * W + j];
    cmask |= (unsigned)(nw ? j == sl : (j != 0 && j <= sl)) << i;
    const int e_init = g + (j - 1) * e, q_init = q + (j - 1) * c;
    hp[i] = SW ? 0 : (int)(short)(j == 0 ? 0 : max(e_init, q_init));
    fp[i] = (int)(short)(j == 0 ? g - e : kNeg16);
    op[i] = (int)(short)(j == 0 ? q - c : kNeg16);
    // direction row 0: E-open into lane 1; beyond it E-extend where the E
    // line carries the max, else Q-extend
    w0[i] = SW ? 0
               : (((j >= 2 ? 1 << kChainBit : 0) << 16) |
                  (j == 1 ? EOPEN : (e_init >= q_init ? EEXT : QEXT)));
  }
  store_row16<LPT>(H + (size_t)R * W + j0, hp);
  store_row16<LPT>(F + (size_t)R * W + j0, fp);
  store_row16<LPT>(O + (size_t)R * W + j0, op);
  store_words<LPT>(drow, w0);
  const int wl = max(w - 1, 0);  // the warp to the left (warp 0: itself, unused)
  ThreadBest tb{best_init(a.mode), j0};
  GraphRows<kK6Pmax> gr{a.codes + (size_t)b * N, a.deg + (size_t)b * N, a.sink + (size_t)b * N,
                        a.aux + (size_t)b * P * N, N, P, a.n_nodes[b], lane};
  const int nn = gr.nn;
  gr.fetch(0);
  gr.advance(0);
  // this row's graph words, taken by shuffle during the row before
  int code = gr.code(0), meta = gr.meta(0), a0 = gr.edge(0, 0), a1 = gr.edge(1, 0);
  // a warp's first lane (w > 0): H of lane j0 - 1 in the previous row,
  // rebuilt from the left warp's published values (no edge of row 1 reads it)
  int hl_warp = 0;
  int wslot = 0;  // ring slot of row hr: (hr - 1) % R
  __syncthreads();  // slot R before any row reads it

  for (int hr = 1; hr <= nn; ++hr) {
    const int dg = meta & 0xff;
    // the previous row's H one lane to the left of the thread's first lane
    int hl1 = __shfl_up_sync(kFull, hp[LPT - 1], 1);
    if (lane == 0) hl1 = hl_warp;
    // Per lane: dmax, the diagonal without the profile; acc, H's vertical
    // candidates in its dispatch order (per slot F-ext, F-open, O-ext,
    // O-open), both packed maxes; vc, the vertical-chain code (the first
    // slot whose F or O extends to the final value, every continue ranking
    // before every stop, else the first that opens it); fp and op become
    // this row's F and O as the rings hold them.
    int dmax[LPT], acc[LPT], vc[LPT];
    // one in-edge (most rows): its packs need no max, and the chain code
    // compares the channels' extend and open values themselves
    auto one_edge = [&](const int (&h)[LPT], const int (&f)[LPT], const int (&o)[LPT], int hl,
                        int av) {
      const int delta = av & 0xFFFF;
      const int kd = KD0 + delta;
      const int kfe = KFE0 + delta, kfo = KFO0 + delta, koe = KOE0 + delta, koo = KOO0 + delta;
      const int stop = ((P - 1) << kDeltaBits) + delta;
      int hv = hl * VSH;
#pragma unroll
      for (int i = 0; i < LPT; ++i) {
        dmax[i] = hv + kd;
        hv = h[i] * VSH;
        acc[i] = max(max(f[i] * VSH + kfe, hv + kfo), max(o[i] * VSH + koe, hv + koo));
        // no opens at lane 0: column-0 F and O values are pure extends
        const bool op0 = i == 0 && j0 == 0;
        const int fE = f[i] + e, fO = op0 ? kNegV : h[i] + g;
        const int oE = o[i] + c, oO = op0 ? kNegV : h[i] + q;
        vc[i] = fE >= fO || oE >= oO ? stop + PC : stop;
        fp[i] = h16(max(fE, fO));
        op[i] = h16(max(oE, oO));
      }
    };
    if (dg == 1) {
      // from the row just above (registers) or a ring slot
      if ((a0 & 0xFFFF) == 1) {
        one_edge(hp, fp, op, hl1, a0);
      } else {
        const size_t off = (size_t)(a0 >> 16) * W + j0;
        int h[LPT], f[LPT], o[LPT];
        load_row16<LPT>(H + off, h);
        load_row16<LPT>(F + off, f);
        load_row16<LPT>(O + off, o);
        one_edge(h, f, o, j0 > 0 ? (int)H[off - 1] : 0, a0);
      }
    } else {
      // fe/fo/oe/oo: each channel's extend and open winners, slot priority
      // descending so that a packed max picks the first slot on ties.
      // Padding slots repeat slot 0 at lower priorities: skipping them
      // leaves every max unchanged.
      int fe[LPT], fo[LPT], oe[LPT], oo[LPT];
#pragma unroll
      for (int i = 0; i < LPT; ++i) dmax[i] = acc[i] = fe[i] = fo[i] = oe[i] = oo[i] = kNegV;
      auto add_edge = [&](const int (&h)[LPT], const int (&f)[LPT], const int (&o)[LPT], int hl,
                          int av, int p) {
        // slot p's codes: the diagonal's and the chains' prio fall by one a
        // slot, H's vertical ones by four
        const int delta = av & 0xFFFF;
        const int u1 = delta - (p << kDeltaBits), u4 = delta - (p << (kDeltaBits + 2));
        const int kd = KD0 + u1;
        const int kfe = KFE0 + u4, kfo = KFO0 + u4, koe = KOE0 + u4, koo = KOO0 + u4;
        const int kge = KGE0 + u1, kgo = KGO0 + u1, kce = KCE0 + u1, kco = KCO0 + u1;
        int hv = hl * VSH;
#pragma unroll
        for (int i = 0; i < LPT; ++i) {
          dmax[i] = __viaddmax_s32(hv, kd, dmax[i]);
          hv = h[i] * VSH;
          const int fv = f[i] * VSH, ov = o[i] * VSH;
          acc[i] = __viaddmax_s32(fv, kfe, acc[i]);
          acc[i] = __viaddmax_s32(hv, kfo, acc[i]);
          acc[i] = __viaddmax_s32(ov, koe, acc[i]);
          acc[i] = __viaddmax_s32(hv, koo, acc[i]);
          fe[i] = __viaddmax_s32(fv, kge, fe[i]);
          fo[i] = __viaddmax_s32(hv, kgo, fo[i]);
          oe[i] = __viaddmax_s32(ov, kce, oe[i]);
          oo[i] = __viaddmax_s32(hv, kco, oo[i]);
        }
      };
#pragma unroll 1
      for (int p = 0; p < dg; ++p) {
        const int av = p == 0 ? a0 : (p == 1 ? a1 : gr.edge_far(p, hr - 1));
        if ((av & 0xFFFF) == 1) {
          add_edge(hp, fp, op, hl1, av, p);
        } else {  // an in-edge from a ring slot
          const size_t off = (size_t)(av >> 16) * W + j0;
          int h[LPT], f[LPT], o[LPT];
          load_row16<LPT>(H + off, h);
          load_row16<LPT>(F + off, f);
          load_row16<LPT>(O + off, o);
          add_edge(h, f, o, j0 > 0 ? (int)H[off - 1] : 0, av, p);
        }
      }
#pragma unroll
      for (int i = 0; i < LPT; ++i) {
        if (i == 0 && j0 == 0) fo[0] = oo[0] = kNegV;  // no opens at lane 0
        // each channel's final value with its code bits cleared: a winner
        // reaches it iff it is at least that, and then its code is the
        // excess; one that does not gives a negative code, and one of F's
        // two winners always reaches it
        const int mF = max(fe[i], fo[i]) & ~MASK, mO = max(oe[i], oo[i]) & ~MASK;
        const int cont = max(fe[i] - mF, oe[i] - mO), stop = max(fo[i] - mF, oo[i] - mO);
        vc[i] = cont >= 0 ? cont + PC : stop;
        fp[i] = h16(mF >> SH);
        op[i] = h16(mO >> SH);
      }
    }

    const int rcode = code, rmeta = meta;
    {
      // the next row's graph words (a new batch every 32 rows; its
      // other in-edge slots' lines into L1)
      const int kn = hr & 31;
      if (kn == 0 && hr < nn) {
        gr.advance(hr);
        if (lane >= 2 && lane < P && hr + 32 < nn)
          asm volatile("prefetch.global.L1 [%0];" ::"l"(gr.aux + (size_t)lane * N + hr + 32));
      }
      code = gr.code(kn);
      meta = gr.meta(kn);
      a0 = gr.edge(0, kn);
      a1 = gr.edge(1, kn);
    }

    // per lane: A0 and its code, and the serial pass of the (E, Q)
    // recurrence from nothing: t_i = (A0[i] + g, A0[i] + q) (+) M t_(i-1)
    int A0[LPT], hc[LPT], tE[LPT], tQ[LPT];
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      // lane 0 has no diagonal; there acc alone equals the reference's max
      const int v = (i == 0 && j0 == 0) ? acc[i]
                                        : __viaddmax_s32(dmax[i], qc[i] == rcode ? MS : XS, acc[i]);
      int A = v >> SH, hcode = v & MASK;
      if (i == 0 && j0 == 0 && !nw) {  // sw/ov: H[i][0] = 0, never walked through
        A = 0;
        hcode = 0;
      }
      A0[i] = SW ? max(A, 0) : A;
      hc[i] = hcode;
      if (i == 0) {
        tE[0] = A0[0] + g;
        tQ[0] = A0[0] + q;
      } else {
        tE[i] = __viaddmax_s32(tE[i - 1], e, max(A0[i], tQ[i - 1]) + g);
        tQ[i] = __viaddmax_s32(tQ[i - 1], c, max(A0[i], tE[i - 1]) + q);
      }
    }
    // across the warp, then across the warps behind the row's one barrier
    int se = tE[LPT - 1], sq = tQ[LPT - 1];
    warp_scan_mp<5>(a.pw.step, lane, se, sq);
    // the warp's prefix at lane j0 - 1 (lane 0: none, unused)
    const int xe = __shfl_up_sync(kFull, se, 1), xq = __shfl_up_sync(kFull, sq, 1);
    int* xb = xch.row(hr);
    if (lane == 31) {
      // the warp's prefix at its second-to-last lane
      int qe = xe, qq = xq;
      if constexpr (LPT >= 2) {
        qe = tE[LPT >= 2 ? LPT - 2 : 0];
        qq = tQ[LPT >= 2 ? LPT - 2 : 0];
        mp_acc(a.pw.seg[LPT >= 2 ? LPT - 2 : 0], xe, xq, qe, qq);
      }
      xb[w] = se;
      xb[32 + w] = sq;
      xb[64 + w] = qe;
      xb[96 + w] = qq;
      xb[128 + w] = A0[LPT - 1];
    }
    __syncthreads();  // the row's one barrier: xb is read below, rewritten two rows on
    // the carry into warp w (u at its lane 32 LPT w - 1) and into warp
    // w - 1: a scan over the warps' published totals, lane v holding warp
    // v's, over as many lanes as the block can have warps (lanes past the
    // block's warps hold stale values, which no lane below them reads)
    int te = xb[lane], tq = xb[32 + lane];
    warp_scan_mp<kScanSteps<LPT>>(a.pw.xstep, lane, te, tq);
    int ce = __shfl_sync(kFull, te, max(w - 1, 0)), cq = __shfl_sync(kFull, tq, max(w - 1, 0));
    int pe = __shfl_sync(kFull, te, max(w - 2, 0)), pq = __shfl_sync(kFull, tq, max(w - 2, 0));
    if (w < 1) ce = cq = kNegV;
    if (w < 2) pe = pq = kNegV;
    // u at lane j0 - 1: the carry into the thread (lane 0: the warp's)
    int ue = ce, uq = cq;
    if (lane > 0) {
      ue = xe;
      uq = xq;
      mp_acc(ml, ce, cq, ue, uq);
    }
    // u at the thread's lanes
    int uE[LPT], uQ[LPT];
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      uE[i] = tE[i];
      uQ[i] = tQ[i];
      mp_acc(a.pw.seg[i], ue, uq, uE[i], uQ[i]);
    }
    // u at lane j0 - 2: the left thread's at its second-to-last lane, or
    // at a warp's first lane the left warp's, from its published prefix
    // there and the carry into it
    int le = __shfl_up_sync(kFull, LPT >= 2 ? uE[LPT >= 2 ? LPT - 2 : 0] : ue, 1);
    int lq = __shfl_up_sync(kFull, LPT >= 2 ? uQ[LPT >= 2 ? LPT - 2 : 0] : uq, 1);
    if (lane == 0) {
      le = xb[64 + wl];
      lq = xb[96 + wl];
      mp_acc(a.pw.warp1, pe, pq, le, lq);
      // H of the left warp's last lane, for the next row's diagonal
      const int hv = max(xb[128 + wl], max(le, lq));
      hl_warp = h16(SW ? max(hv, 0) : hv);
      // lane 0 of the block: no lane -1, so that no EBe / QBq below holds
      // at lanes 0 and 1 (u at lane -1, this thread's carry, is kNegV too)
      if (w == 0) le = lq = kNegV;
    }

    int hf[LPT], wd[LPT];
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      // E and Q of lane j = j0 + i are u at j - 1; of lane j - 1, u at j - 2
      int Ev = i == 0 ? ue : uE[i >= 1 ? i - 1 : 0];
      int Qv = i == 0 ? uq : uQ[i >= 1 ? i - 1 : 0];
      const int pE = i == 0 ? le : (i == 1 ? ue : uE[i >= 2 ? i - 2 : 0]);
      const int pQ = i == 0 ? lq : (i == 1 ? uq : uQ[i >= 2 ? i - 2 : 0]);
      if (i == 0 && j0 == 0) Ev = Qv = kNeg16;
      // EBe / QBq: E (Q) extends the lane to the left; lanes 0 and 1 have
      // none, and their pE, pQ (u at lanes -2 and -1) are kNegV
      const bool EBe = Ev == pE + e, QBq = Qv == pQ + c;
      const int EQ = max(Ev, Qv);
      // among the sequence-gap candidates the dispatch order is E-ext,
      // E-open, Q-ext, Q-open: E's codes win a tie
      const int eqcode = Ev >= Qv ? (EBe ? EEXT : EOPEN) : (QBq ? QEXT : QOPEN);
      int Hf = max(A0[i], EQ);
      int hcode = EQ > A0[i] ? eqcode : hc[i];
      if (SW) {
        Hf = max(Hf, 0);
        if (Hf == 0) hcode = 0;
      }
      hf[i] = Hf;
      hp[i] = h16(Hf);  // the clamp keeps dead lanes inside int16
      wd[i] = (vc[i] | (EBe || QBq ? 1 << kChainBit : 0)) * 65536 + hcode;
    }
    store_row16<LPT>(H + (size_t)wslot * W + j0, hp);
    store_row16<LPT>(F + (size_t)wslot * W + j0, fp);
    store_row16<LPT>(O + (size_t)wslot * W + j0, op);
    wslot = wslot + 1 == R ? 0 : wslot + 1;
    store_words<LPT>(drow + (size_t)hr * row_stride, wd);
    if (cmask != 0 && (SW || (rmeta >> 8) != 0)) tb.update<LPT>(hf, cmask, hr, j0);
  }
  store_best_lanes(tb, a.mode, warp_buf, bd, a.maxi, a.maxj, a.score);
}

template <bool SW, bool SMEM>
int launch_k6(const K6Args& a, int BD, int lpt, cudaStream_t stream) {
  void (*kernel)(const K6Args);
  switch (lpt) {
    case 1: kernel = poa_dp_convex_kernel<1, SW, SMEM>; break;
    case 2: kernel = poa_dp_convex_kernel<2, SW, SMEM>; break;
    case 3: kernel = poa_dp_convex_kernel<3, SW, SMEM>; break;
    case 4: kernel = poa_dp_convex_kernel<4, SW, SMEM>; break;
    case 5: kernel = poa_dp_convex_kernel<5, SW, SMEM>; break;
    case 6: kernel = poa_dp_convex_kernel<6, SW, SMEM>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  const size_t smem = kK6HeadInts * sizeof(int) +
                      (SMEM ? 3 * (size_t)(a.R + 1) * a.W * sizeof(short) : 0);
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<BD, a.W / lpt, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// lpt: lanes a thread, 1-6, with W a multiple of 32 * lpt; pows: the
// MpPowers of M = [[e, g], [q, c]] at lpt, as ints in its field order
// (poa_convex.py: k6_powers)
int poa_dp_convex_launch(const int* codes, const int* aux, const int* deg, const int* sink,
                         const int* n_nodes, const int* seqp, const int* slen, int* dirs,
                         int* maxi, int* maxj, int* score, short* rings, int B, int N, int P,
                         int D, int W, int R, int mode, int m, int x, int g, int e, int q, int c,
                         int use_smem, int SH, const int* pows, int lpt, void* stream) {
  if (lpt < 1 || W % (32 * lpt) != 0) return (int)cudaErrorInvalidValue;
  K6Args a{codes, aux, deg, sink, n_nodes, seqp, slen, dirs, maxi, maxj, score, rings,
           N, P, D, W, R, mode, m, x, g, e, q, c, SH, {}};
  std::memcpy(&a.pw, pows, sizeof(MpPowers));
  const int BD = B * D;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == kSW)
    return use_smem ? launch_k6<true, true>(a, BD, lpt, s) : launch_k6<true, false>(a, BD, lpt, s);
  return use_smem ? launch_k6<false, true>(a, BD, lpt, s) : launch_k6<false, false>(a, BD, lpt, s);
}

// K6w: node_id [B, N1 - 1] or null (pn then holds DP ranks); tiles [B, D]
// or null
int poa_walk_convex_launch(const int* dirs, const int* maxi, const int* maxj, const int* node_id,
                           int* pn, int* pp, int* count, int* tiles, int B, int N1, int D, int W,
                           int L, int P, int mode, void* stream) {
  return launch_walk3<2>(dirs, maxi, maxj, node_id, pn, pp, count, tiles, B, N1, D, W, L, P,
                          mode, stream);
}

}  // extern "C"

// Affine-gap sequence-to-graph DP (K5) and its three-state traceback walk
// (K5w) for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces vechat_tpu/ops/kernels/poa_pallas_affine.py: _dp_kernel_affine
// (pallas_call in _poa_dp_pallas_affine) and _traceback_walk_affine. The
// direction words, both priority orders, the boundary pins, the int16 clamp
// and the best-cell pack are the reference's bit for bit; the plain PyTorch
// versions in ops/kernels/poa_affine.py compute the same outputs.
//
//   F[i][j] = max_p max(H[p][j] + g, F[p][j] + e)     (graph-gap channel)
//   E[i][j] = max(H[i][j-1] + g, E[i][j-1] + e)       (sequence-gap channel)
//   H[i][j] = max(diag_p + prof, F[i][j], E[i][j] [, 0])
//
// K5: one block per (graph b, sequence d) of W / LPT threads, thread t
// owning lanes [t*LPT, (t+1)*LPT) in registers (LPT, 1-6, chosen per W by
// the wrapper: 6 at the spoa path's W=576, three warps), a loop over DP
// rows. It replaced a thread per lane whose rows each waited at four block
// barriers (two in a block-wide scan, one for an exchange of the scan
// through shared memory, one at the row's end) behind dependent loads of
// the graph row and of both int16 rings. Now a row is:
//  - the in-edges, block-uniform: the common row, one in-edge from the row
//    just above, takes H and F from the thread's registers (the diagonal's
//    left lane by shuffle; at a warp's first lane a value rebuilt from what
//    the left warp published, below); one in-edge from a ring slot, or
//    several, read the rings. Per lane and in-edge two scalings and five
//    DPX add-then-max into the packed maxes; the profile is added once,
//    after the diagonal's max; H's and the F chain's packs share one shift.
//  - E as the prefix max of A0[k] - k*e: serial over the thread's lanes, a
//    5-step shuffle scan across the warp, then the carry from the totals
//    of the warps to the left, published before the row's single
//    __syncthreads (double-buffered by row parity, gap_rows.cuh) and
//    reduced with one __reduce_max_sync. EB needs the prefix at lanes j-1
//    and j-2: the thread's own lanes, the left thread by shuffle, or the
//    left warp's published prefix at its second-to-last lane.
//  - the H of the left warp's last lane, which the diagonal of the next row
//    needs, is final only after this row's barrier, and a ring slot written
//    then would race with the next row's read. So each warp's first lane
//    rebuilds it from values published before the barrier: that lane's A0
//    and the left warp's prefix at its second-to-last lane (with the carry
//    into the left warp, which every warp has after the barrier).
//  - the thread's LPT direction words and ring lanes out as vector stores.
// The graph rows come 32 at a time, fetched a batch ahead in registers and
// taken by shuffle a row ahead; per-lane constants are pinned in registers.
// The rings are read only by edges of delta >= 2 or 0: a slot written
// after barrier r is read at row r + 2 or later, behind barrier r + 1;
// slot R, the boundary row, is written before the loop. They sit in shared
// memory up to K5's own limit (227 KB with the exchange), else in a global
// scratch ring (a template parameter, as is sw's clamp). What bounds it is
// the latency of a row's chain at one warp to a scheduler (the in-edges,
// the serial and shuffle scans, the barrier, the carry's load and reduce,
// the lanes' final pass), and issuing ~330 instructions a warp a row
// at half rate on the integer pipes: the spoa path launches one block, B = D
// = 1 (PERF.md, k1_probe.py time-k5).
// K5w: vk::walk3_kernel<1, MODE>, one warp a walk over tiles of its
// direction words staged in shared memory with cp.async, its pairs written
// 32 columns at a time with node ids and the -2 columns (poa_gap.cuh).

#include "gap_rows.cuh"

namespace {

using namespace vk;

struct K5Args {
  const int* codes;    // [B, N] node codes, rank order
  const int* aux;      // [B, P, N] hslot << 16 | delta
  const int* deg;      // [B, N] true in-degree (>= 1)
  const int* sink;     // [B, N] 1 = no out-edges
  const int* n_nodes;  // [B]
  const int* seqp;     // [B, D, W] lane j = code of position j-1
  const int* slen;     // [B, D]
  int* dirs;           // [B, N+1, D, W] out: FE << 16 | Hcode
  int* maxi;           // [B, D] out
  int* maxj;
  int* score;
  short* rings;        // [B*D, 2, R+1, W] scratch when the rings are not in shared memory
  int N, P, D, W, R, mode, m, x, g, e, SH;
};

// in-edge slots fetched ahead in registers: slot 0, which every row has,
// and slot 1; a row's other slots are read in the row loop (their lines
// fetched into L1 a batch ahead)
constexpr int kK5Pmax = 2;
// a warp publishes its running max's total, its prefix at its second-to-last
// lane and A0 of its last lane
using K5Exchange = RowExchange<3>;
// dynamic shared memory before the rings: the exchange and the reductions' 32
constexpr int kK5HeadInts = K5Exchange::kInts + 32;

// The packed maxes (value << SH | prio << 9 | delta) of H's candidates and
// of the F chain both use H's shift SH: the F chain's codes are below 2^SH
// too, so its max and code are those of the reference's narrower pack.

template <int LPT, bool SW, bool SMEM>
__global__ void __launch_bounds__((1024 / LPT + 31) / 32 * 32)
    poa_dp_affine_kernel(const K5Args a) {
  extern __shared__ __align__(16) int k5_smem[];
  const int N = a.N, P = a.P, D = a.D, W = a.W, R = a.R, g = a.g, e = a.e;
  const bool nw = a.mode == kNW;
  int t = threadIdx.x;
  pin(t);
  const int lane = t & 31, w = t >> 5;
  const int j0 = t * LPT;
  const int bd = blockIdx.x, b = bd / D, d = bd % D;
  const K5Exchange xch{k5_smem};
  int* warp_buf = k5_smem + K5Exchange::kInts;
  const size_t ring = (size_t)(R + 1) * W;
  short* H = SMEM ? reinterpret_cast<short*>(k5_smem + kK5HeadInts)
                   : a.rings + (size_t)bd * 2 * ring;
  short* F = H + ring;
  const int SH = a.SH, VSH = 1 << SH;
  const int NPRIO = 3 * P + 3;
  const int MASK = VSH - 1;
  int MS = a.m * VSH, XS = a.x * VSH;
  // sequence-gap and stop codes; slot p's codes are formed per in-edge
  int EEXT = (NPRIO - 1 - 3 * P) << kDeltaBits;
  int EOPEN = (NPRIO - 1 - (3 * P + 1)) << kDeltaBits;
  // slot 0's codes without the delta (diagonal; F-extend, F-open in H's
  // order; F-open, F-extend in the F chain's), each with its gap score
  int KD0 = (NPRIO - 1) << kDeltaBits;
  int KFE0 = e * VSH + ((NPRIO - 1 - P) << kDeltaBits);
  int KFO0 = g * VSH + ((NPRIO - 2 - P) << kDeltaBits);
  int KGE0 = e * VSH + ((2 * P - 2) << kDeltaBits);
  int KGO0 = g * VSH + ((2 * P - 1) << kDeltaBits);
  pin(MS);
  pin(XS);
  pin(EEXT);
  pin(EOPEN);
  pin(KD0);
  pin(KFE0);
  pin(KFO0);
  pin(KGE0);
  pin(KGO0);
  const int sl = a.slen[bd];
  const size_t row_stride = (size_t)D * W;
  int* drow = a.dirs + ((size_t)b * (N + 1) * D + d) * W + j0;

  // per lane: the query code, -j*e (the scan's offset) and g - e + j*e
  // (E's); at lane 0 of the block, whose prefix to the left is kNegV,
  // kNeg16 - kNegV, so that E is kNeg16 there as in the reference
  int qc[LPT], mje[LPT], ce[LPT];
  unsigned cmask = 0;  // the lanes that may hold the best cell
  // hp, fp: H and F of the previous row, as the rings hold them; first the
  // boundary row, which ring slot R pins: H row 0 = [0, g, g+e, ...] (zeros
  // in sw), F row 0 = [g - e, -inf, ...], so that the uniform recurrence
  // gives a start node F = g at lane 0 and -inf beyond
  int hp[LPT], fp[LPT], w0[LPT];
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const int j = j0 + i;
    qc[i] = a.seqp[(size_t)bd * W + j];
    mje[i] = -j * e;
    ce[i] = j == 0 ? kNeg16 - kNegV : g - e + j * e;
    cmask |= (unsigned)(nw ? j == sl : (j != 0 && j <= sl)) << i;
    hp[i] = SW ? 0 : (int)(short)(j == 0 ? 0 : g + (j - 1) * e);
    fp[i] = (int)(short)(j == 0 ? g - e : kNeg16);
    // direction row 0: E-open into lane 1, E-extend further right
    w0[i] = SW ? 0 : (((j >= 2 ? 1 << kChainBit : 0) << 16) | (j == 1 ? EOPEN : EEXT));
    pin(mje[i]);
    pin(ce[i]);
  }
  store_row16<LPT>(H + (size_t)R * W + j0, hp);
  store_row16<LPT>(F + (size_t)R * W + j0, fp);
  store_words<LPT>(drow, w0);
  const int wl = max(w - 1, 0);  // the warp to the left (warp 0: itself, unused)
  ThreadBest tb{best_init(a.mode), j0};
  GraphRows<kK5Pmax> gr{a.codes + (size_t)b * N, a.deg + (size_t)b * N, a.sink + (size_t)b * N,
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
    // packed maxes over the in-edge slots: the diagonal without the
    // profile, `acc` the vertical codes in the dispatch order of H (per
    // slot F-extend then F-open), `facc` the F chain's order (F-open then
    // F-extend). Padding slots repeat slot 0 at lower priorities: skipping
    // them leaves every max unchanged.
    int dmax[LPT], acc[LPT], facc[LPT];
#pragma unroll
    for (int i = 0; i < LPT; ++i) dmax[i] = acc[i] = facc[i] = kNegV;
    auto add_edge = [&](const int (&h)[LPT], const int (&f)[LPT], int hl, int av, int p) {
      // slot p's codes: the diagonal's prio falls by one a slot, the
      // vertical and F-chain ones by two
      const int delta = av & 0xFFFF;
      const int kd = KD0 + delta - (p << kDeltaBits);
      const int u = delta - (p << (kDeltaBits + 1));
      const int kfe = KFE0 + u, kfo = KFO0 + u, kge = KGE0 + u, kgo = KGO0 + u;
      int hv = hl * VSH;
#pragma unroll
      for (int i = 0; i < LPT; ++i) {
        dmax[i] = __viaddmax_s32(hv, kd, dmax[i]);
        hv = h[i] * VSH;
        const int fv = f[i] * VSH;
        acc[i] = __viaddmax_s32(fv, kfe, acc[i]);
        acc[i] = __viaddmax_s32(hv, kfo, acc[i]);
        facc[i] = __viaddmax_s32(fv, kge, facc[i]);
        facc[i] = __viaddmax_s32(hv, kgo, facc[i]);
      }
    };
    auto ring_edge = [&](int av, int p) {  // an in-edge from a ring slot
      const size_t off = (size_t)(av >> 16) * W + j0;
      int h[LPT], f[LPT];
      load_row16<LPT>(H + off, h);
      load_row16<LPT>(F + off, f);
      add_edge(h, f, j0 > 0 ? (int)H[off - 1] : 0, av, p);
    };
    if (dg == 1) {
      // most rows: one in-edge, from the row just above (registers) or a ring
      if ((a0 & 0xFFFF) == 1) add_edge(hp, fp, hl1, a0, 0);
      else ring_edge(a0, 0);
    } else {
#pragma unroll 1
      for (int p = 0; p < dg; ++p) {
        const int av = p == 0 ? a0 : (p == 1 ? a1 : gr.edge_far(p, hr - 1));
        if ((av & 0xFFFF) == 1) add_edge(hp, fp, hl1, av, p);
        else ring_edge(av, p);
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

    // A0 and the serial prefix max of A0[j] - j*e over the thread's lanes
    int A0[LPT], hc[LPT], s[LPT];
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
      s[i] = i == 0 ? A0[i] + mje[i] : __viaddmax_s32(A0[i], mje[i], s[i - 1]);
    }
    // the F channel's ring value and code need no scan: done while it runs
    int fcw[LPT];
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      fp[i] = h16(facc[i] >> SH);
      fcw[i] = facc[i] & MASK;
    }
    // across the warp, then across the warps behind the row's one barrier
    const int incl = warp_prefix_max(s[LPT - 1]);
    int wex = __shfl_up_sync(kFull, incl, 1);  // the warp's prefix at lane j0 - 1
    if (lane == 0) wex = kNegV;
    // the warp's prefix at the thread's second-to-last lane
    const int q = LPT >= 2 ? max(wex, s[LPT >= 2 ? LPT - 2 : 0]) : wex;
    const int ql = __shfl_up_sync(kFull, q, 1);
    int* xb = xch.row(hr);
    if (lane == 31) {
      xb[w] = incl;
      xb[32 + w] = q;
      xb[64 + w] = A0[LPT - 1];
    }
    __syncthreads();  // the row's one barrier: xb is read below, rewritten two rows on
    // the carry into warp w - 1: the max of the totals of the warps before
    // it, lane v of the warp reading warp v's
    const int tv = xb[lane];
    const int cl = __reduce_max_sync(kFull, lane + 1 < w ? tv : kNegV);
    const int qw = xb[32 + wl], aw = xb[64 + wl];  // the left warp's
    const int carry = w > 0 ? max(cl, xb[wl]) : kNegV;
    const int excl = max(carry, wex);  // the prefix at lane j0 - 1
    // ... and at lane j0 - 2; at lane 0 of the block one above kNegV, so
    // that EB (below) is false there as at lane 1 (no lane to extend)
    const int t2w = w > 0 ? max(cl, qw) : kNegV + 1;
    const int t2 = lane == 0 ? t2w : max(carry, ql);
    {
      // H of the left warp's last lane, for the next row's diagonal
      const int hv = max(aw, t2w + (g - e) + (j0 - 1) * e);
      hl_warp = h16(SW ? max(hv, 0) : hv);
    }

    int hf[LPT], wd[LPT];
    int tp2 = t2;
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int tp = i == 0 ? excl : max(excl, s[i >= 1 ? i - 1 : 0]);  // prefix at j - 1
      // E[j] = max_{k<j} A0[k] + g + (j-1-k)*e; every A0 - j*e is far above
      // the reference scan's -2^30 fill, so this plain prefix max equals it
      const int E = tp + ce[i];
      // EB: E extends E of the lane to the left (prefix at j-1 == at j-2)
      const bool EB = tp == tp2;
      tp2 = tp;
      int Hf = max(A0[i], E);
      int hcode = E > A0[i] ? (EB ? EEXT : EOPEN) : hc[i];
      if (SW) {
        Hf = max(Hf, 0);
        if (Hf == 0) hcode = 0;
      }
      hf[i] = Hf;
      hp[i] = h16(Hf);  // the clamp keeps dead lanes inside int16
      wd[i] = (fcw[i] | (EB ? 1 << kChainBit : 0)) * 65536 + hcode;
    }
    store_row16<LPT>(H + (size_t)wslot * W + j0, hp);
    store_row16<LPT>(F + (size_t)wslot * W + j0, fp);
    wslot = wslot + 1 == R ? 0 : wslot + 1;
    store_words<LPT>(drow + (size_t)hr * row_stride, wd);
    if (cmask != 0 && (SW || (rmeta >> 8) != 0)) tb.update<LPT>(hf, cmask, hr, j0);
  }
  store_best_lanes(tb, a.mode, warp_buf, bd, a.maxi, a.maxj, a.score);
}

template <bool SW, bool SMEM>
int launch_k5(const K5Args& a, int BD, int lpt, cudaStream_t stream) {
  void (*kernel)(const K5Args);
  switch (lpt) {
    case 1: kernel = poa_dp_affine_kernel<1, SW, SMEM>; break;
    case 2: kernel = poa_dp_affine_kernel<2, SW, SMEM>; break;
    case 3: kernel = poa_dp_affine_kernel<3, SW, SMEM>; break;
    case 4: kernel = poa_dp_affine_kernel<4, SW, SMEM>; break;
    case 5: kernel = poa_dp_affine_kernel<5, SW, SMEM>; break;
    case 6: kernel = poa_dp_affine_kernel<6, SW, SMEM>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  const size_t smem = kK5HeadInts * sizeof(int) +
                      (SMEM ? 2 * (size_t)(a.R + 1) * a.W * sizeof(short) : 0);
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

// lpt: lanes a thread, 1-6, with W a multiple of 32 * lpt
int poa_dp_affine_launch(const int* codes, const int* aux, const int* deg, const int* sink,
                         const int* n_nodes, const int* seqp, const int* slen, int* dirs,
                         int* maxi, int* maxj, int* score, short* rings, int B, int N, int P,
                         int D, int W, int R, int mode, int m, int x, int g, int e,
                         int use_smem, int SH, int lpt, void* stream) {
  if (lpt < 1 || W % (32 * lpt) != 0) return (int)cudaErrorInvalidValue;
  const K5Args a{codes, aux, deg, sink, n_nodes, seqp, slen, dirs, maxi, maxj, score, rings,
                 N, P, D, W, R, mode, m, x, g, e, SH};
  const int BD = B * D;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == kSW)
    return use_smem ? launch_k5<true, true>(a, BD, lpt, s) : launch_k5<true, false>(a, BD, lpt, s);
  return use_smem ? launch_k5<false, true>(a, BD, lpt, s) : launch_k5<false, false>(a, BD, lpt, s);
}

// K5w: node_id [B, N1 - 1] or null (pn then holds DP ranks); tiles [B, D]
// or null
int poa_walk_affine_launch(const int* dirs, const int* maxi, const int* maxj, const int* node_id,
                           int* pn, int* pp, int* count, int* tiles, int B, int N1, int D, int W,
                           int L, int P, int mode, void* stream) {
  return launch_walk3<1>(dirs, maxi, maxj, node_id, pn, pp, count, tiles, B, N1, D, W, L, P,
                          mode, stream);
}

}  // extern "C"

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
// K6: one block per (graph b, sequence d), one thread per lane j, a loop
// over DP rows. The in-row pair (E, Q) is coupled through H: a max-plus
// linear recurrence with the constant matrix M = [[e, g], [q, c]]. It is
// solved as the reference solves it, by a Hillis-Steele scan over the whole
// row that applies M^(2^s) at offset 2^s, here through a double-buffered
// row in shared memory, one barrier per step; the powers come from repeated
// squaring in registers. (A warp-then-block scan combines prefixes at
// offsets that are no powers of two and would need a table of M^k.) Bound
// by the serial row chain: ceil(log2 W) + 3 barriers per row. The three
// int16 rings (H, F, O) sit in shared memory when they fit, else in a
// global scratch ring.
// K6w: vk::walk3_kernel<2>, one thread per walk (poa_gap.cuh).

#include "poa_gap.cuh"

namespace {

using namespace vk;

__global__ void poa_dp_convex_kernel(
    const int* __restrict__ codes,    // [B, N] node codes, rank order
    const int* __restrict__ aux,      // [B, P, N] hslot << 16 | delta
    const int* __restrict__ deg,      // [B, N] true in-degree (>= 1)
    const int* __restrict__ sink,     // [B, N] 1 = no out-edges
    const int* __restrict__ n_nodes,  // [B]
    const int* __restrict__ seqp,     // [B, D, W] lane j = code of position j-1
    const int* __restrict__ slen,     // [B, D]
    int* __restrict__ dirs,           // [B, N+1, D, W] out: FOCB << 16 | Hcode
    int* __restrict__ maxi, int* __restrict__ maxj, int* __restrict__ score,  // [B, D]
    short* __restrict__ rings,        // [B*D, 3, R+1, W] scratch when !use_smem
    int N, int P, int D, int W, int R, int mode, int m, int x, int g, int e, int q, int c,
    int use_smem, int SH, int SHF, int log_w) {
  extern __shared__ int smem[];
  int* warp_buf = smem;                             // 32
  int2* eq = reinterpret_cast<int2*>(smem + 32);    // [2, W] (E, Q) of the scan
  const int bd = blockIdx.x;
  const int b = bd / D, d = bd % D;
  const int j = threadIdx.x;
  const size_t ring = (size_t)(R + 1) * W;
  short* H = use_smem ? reinterpret_cast<short*>(smem + 32 + 4 * W)
                      : rings + (size_t)bd * 3 * ring;
  short* F = H + ring;
  short* O = F + ring;
  const int NPRIO = 5 * P + 5;
  const int MASKC = (1 << SH) - 1;
  const int VSH = 1 << SH, VSHF = 1 << SHF;
  const int SLOTMASK = (1 << (SHF - kDeltaBits)) - 1;
  const int BIGS = 1 << 20;
  const int EEXT = (NPRIO - 1 - 5 * P) << kDeltaBits;
  const int EOPEN = (NPRIO - 1 - (5 * P + 1)) << kDeltaBits;
  const int QEXT = (NPRIO - 1 - (5 * P + 2)) << kDeltaBits;
  const int QOPEN = (NPRIO - 1 - (5 * P + 3)) << kDeltaBits;
  const int HSTOP = 0;
  const int sl = slen[bd];
  const int qc = seqp[(size_t)bd * W + j];
  const int nn = n_nodes[b];
  const bool cell = mode == kNW ? (j == sl) : (j != 0 && j <= sl);
  const size_t row_stride = (size_t)D * W;
  int* drow = dirs + ((size_t)b * (N + 1) * D + d) * W + j;
  const int* aux_b = aux + (size_t)b * P * N;

  // ring slot R pins the boundary row: H row 0 is the higher of the two gap
  // lines (zeros in sw); F and O row 0 = [g - e | q - c, -inf, ...]
  const int e_init = g + (j - 1) * e, q_init = q + (j - 1) * c;
  H[R * W + j] = mode == kSW ? 0 : (short)(j == 0 ? 0 : max(e_init, q_init));
  F[R * W + j] = (short)(j == 0 ? g - e : kNeg16);
  O[R * W + j] = (short)(j == 0 ? q - c : kNeg16);
  // direction row 0: E-open into lane 1; beyond it E-extend where the E
  // line carries the max, else Q-extend
  if (mode == kSW) {
    drow[0] = HSTOP;
  } else {
    const int cb = j >= 2 ? 1 << kChainBit : 0;
    drow[0] = (cb << 16) | (j == 1 ? EOPEN : (e_init >= q_init ? EEXT : QEXT));
  }
  int bestc = best_init(mode);
  __syncthreads();

  for (int hr = 1; hr <= nn; ++hr) {
    const int r = hr - 1;
    const int code = codes[(size_t)b * N + r];
    const int dg = deg[(size_t)b * N + r];
    const int prof = (qc == code ? m : x) * VSH;
    // `acc`: H's dispatch order (diag; per slot F-ext, F-open, O-ext,
    // O-open). fe/fo/oe/oo: each channel's extend and open winners, slot
    // priority descending so a packed max picks the first slot on ties.
    // Padding slots repeat slot 0 at lower priorities: skipped.
    int acc = kNegV, fe_ = kNegV, fo_ = kNegV, oe_ = kNegV, oo_ = kNegV;
    for (int p = 0; p < dg; ++p) {
      const int a = aux_b[(size_t)p * N + r];
      const int delta = a & 0xFFFF;
      const size_t off = (size_t)(a >> 16) * W;
      const int rowH = H[off + j];
      const int vfe = (int)F[off + j] + e, vfo = rowH + g;
      const int voe = (int)O[off + j] + c, voo = rowH + q;
      const int hp = NPRIO - 1 - (P + 4 * p);  // F-ext; the next three follow
      const int diag = j == 0 ? kNegV
                              : (int)H[off + j - 1] * VSH +
                                    (prof + ((NPRIO - 1 - p) << kDeltaBits) + delta);
      acc = max(acc, max(max(diag, vfe * VSH + ((hp << kDeltaBits) + delta)),
                         max(max(vfo * VSH + (((hp - 1) << kDeltaBits) + delta),
                                 voe * VSH + (((hp - 2) << kDeltaBits) + delta)),
                             voo * VSH + (((hp - 3) << kDeltaBits) + delta))));
      const int sp = ((P - 1 - p) << kDeltaBits) + delta;
      fe_ = max(fe_, vfe * VSHF + sp);
      oe_ = max(oe_, voe * VSHF + sp);
      // opens are masked at lane 0: column-0 F/O values are pure extends
      if (j != 0) {
        fo_ = max(fo_, vfo * VSHF + sp);
        oo_ = max(oo_, voo * VSHF + sp);
      }
    }
    const int Fr = max(fe_, fo_) >> SHF, Or = max(oe_, oo_) >> SHF;
    int A = acc >> SH, hcode = acc & MASKC;

    // vertical-chain code: the first slot whose F or O EXTENDS to the final
    // value (all continues rank before all stops), else the first slot that
    // opens it
    const int fe_slot = (fe_ >> SHF) == Fr ? (P - 1) - ((fe_ >> kDeltaBits) & SLOTMASK) : BIGS;
    const int oe_slot = (oe_ >> SHF) == Or ? (P - 1) - ((oe_ >> kDeltaBits) & SLOTMASK) : BIGS;
    const int fo_slot = (fo_ >> SHF) == Fr ? (P - 1) - ((fo_ >> kDeltaBits) & SLOTMASK) : BIGS;
    const int oo_slot = (oo_ >> SHF) == Or ? (P - 1) - ((oo_ >> kDeltaBits) & SLOTMASK) : BIGS;
    const int cont_slot = min(fe_slot, oe_slot), stop_slot = min(fo_slot, oo_slot);
    const bool has_cont = cont_slot < BIGS;
    const int chain_prio = has_cont ? 2 * P - 1 - cont_slot : max(2 * P - 1 - (P + stop_slot), 0);
    const int chain_delta = (has_cont ? (fe_slot <= oe_slot ? fe_ : oe_)
                                      : (fo_slot <= oo_slot ? fo_ : oo_)) & kDmask;
    const int focode = (chain_prio << kDeltaBits) | chain_delta;

    if (mode != kNW && j == 0) {  // sw/ov: H[i][0] = 0, never walked through
      A = 0;
      hcode = HSTOP;
    }
    const int A0 = mode == kSW ? max(A, 0) : A;

    // coupled (E, Q) scan. v_j = b_j (+) M v_{j-1} with b_j = A0[j-1] +
    // (g, q); after step s lane j holds max_{k < 2^(s+1)} M^k b_{j-k}.
    // Lane 0 has no cell to its left: the reference gives it A0[W-1] - 2^30,
    // here it is -2^30. Either stays below every real candidate (all above
    // -2^17 under fits_int16), so no lane's max ever takes it.
    int cur = 0;
    eq[j] = make_int2(A0 + g, A0 + q);
    __syncthreads();
    int Ev = kNegV, Qv = kNegV;
    if (j != 0) {
      const int2 left = eq[j - 1];
      Ev = left.x;
      Qv = left.y;
    }
    int m11 = e, m12 = g, m21 = q, m22 = c;
    for (int s = 0; s < log_w; ++s) {
      const int sh = 1 << s;
      cur ^= 1;
      eq[cur * W + j] = make_int2(Ev, Qv);
      __syncthreads();
      if (j >= sh) {
        const int2 v = eq[cur * W + j - sh];
        Ev = max(Ev, max(v.x + m11, v.y + m12));
        Qv = max(Qv, max(v.x + m21, v.y + m22));
      }
      // M^(2^(s+1)) = M^(2^s) (x) M^(2^s)
      const int n11 = max(m11 + m11, m12 + m21), n12 = max(m11 + m12, m12 + m22);
      const int n21 = max(m21 + m11, m22 + m21), n22 = max(m21 + m12, m22 + m22);
      m11 = n11; m12 = n12; m21 = n21; m22 = n22;
    }
    if (j == 0) Ev = Qv = kNeg16;
    // EBe / QBq: E (Q) extends the lane to the left; lanes 0 and 1 have none
    cur ^= 1;
    eq[cur * W + j] = make_int2(Ev, Qv);
    __syncthreads();
    bool EBe = false, QBq = false;
    if (j >= 2) {
      const int2 left = eq[cur * W + j - 1];
      EBe = Ev == left.x + e;
      QBq = Qv == left.y + c;
    }
    const int EQ = max(Ev, Qv);
    // among the sequence-gap candidates the dispatch order is E-ext,
    // E-open, Q-ext, Q-open: one packed max over the two channels
    const int eqcode = max(Ev * VSH + (EBe ? EEXT : EOPEN), Qv * VSH + (QBq ? QEXT : QOPEN)) & MASKC;
    int Hfin = max(A0, EQ);
    if (EQ > A0) hcode = eqcode;
    if (mode == kSW) {
      Hfin = max(Hfin, 0);
      if (Hfin == 0) hcode = HSTOP;
    }
    // every read of the ring slot overwritten here happened before the
    // barriers above; the clamp keeps dead lanes inside int16
    const size_t slot = (size_t)((hr - 1) % R) * W + j;
    H[slot] = (short)max(Hfin, kNeg16);
    F[slot] = (short)max(Fr, kNeg16);
    O[slot] = (short)max(Or, kNeg16);
    drow[(size_t)hr * row_stride] =
        ((focode | ((int)(EBe || QBq) << kChainBit)) << 16) | hcode;
    if (cell && (mode == kSW || sink[(size_t)b * N + r] != 0))
      bestc = max(bestc, Hfin * kTie + (kTie - 1 - hr));
    __syncthreads();
  }
  store_best(bestc, mode, warp_buf, bd, maxi, maxj, score);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

int poa_dp_convex_launch(const int* codes, const int* aux, const int* deg, const int* sink,
                         const int* n_nodes, const int* seqp, const int* slen, int* dirs,
                         int* maxi, int* maxj, int* score, short* rings, int B, int N, int P,
                         int D, int W, int R, int mode, int m, int x, int g, int e, int q, int c,
                         int use_smem, int SH, int SHF, int log_w, void* stream) {
  const size_t smem = (32 + 4 * (size_t)W) * sizeof(int) +
                      (use_smem ? 3 * (size_t)(R + 1) * W * sizeof(short) : 0);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        poa_dp_convex_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  poa_dp_convex_kernel<<<B * D, W, smem, (cudaStream_t)stream>>>(
      codes, aux, deg, sink, n_nodes, seqp, slen, dirs, maxi, maxj, score, rings, N, P, D, W,
      R, mode, m, x, g, e, q, c, use_smem, SH, SHF, log_w);
  return (int)cudaGetLastError();
}

int poa_walk_convex_launch(const int* dirs, const int* maxi, const int* maxj, int* pn, int* pp,
                           int* count, int B, int N1, int D, int W, int L, int P, int mode,
                           void* stream) {
  return launch_walk3<2>(dirs, maxi, maxj, pn, pp, count, B, N1, D, W, L, P, mode, stream);
}

}  // extern "C"

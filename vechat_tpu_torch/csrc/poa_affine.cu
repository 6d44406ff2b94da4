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
// K5: one block per (graph b, sequence d), one thread per lane j, a loop
// over DP rows. Bound by the serial row chain: per row the in-edge loads
// from the H and F rings, one block-wide prefix max and four barriers. The
// two int16 rings sit in shared memory when they fit, else in a global
// scratch ring; each direction row goes out as one coalesced int32 store.
// K5w: vk::walk3_kernel<1>, one thread per walk (poa_gap.cuh).

#include "poa_gap.cuh"

namespace {

using namespace vk;

__global__ void poa_dp_affine_kernel(
    const int* __restrict__ codes,    // [B, N] node codes, rank order
    const int* __restrict__ aux,      // [B, P, N] hslot << 16 | delta
    const int* __restrict__ deg,      // [B, N] true in-degree (>= 1)
    const int* __restrict__ sink,     // [B, N] 1 = no out-edges
    const int* __restrict__ n_nodes,  // [B]
    const int* __restrict__ seqp,     // [B, D, W] lane j = code of position j-1
    const int* __restrict__ slen,     // [B, D]
    int* __restrict__ dirs,           // [B, N+1, D, W] out: FE << 16 | Hcode
    int* __restrict__ maxi, int* __restrict__ maxj, int* __restrict__ score,  // [B, D]
    short* __restrict__ rings,        // [B*D, 2, R+1, W] scratch when !use_smem
    int N, int P, int D, int W, int R, int mode, int m, int x, int g, int e,
    int use_smem, int SH, int SHF) {
  extern __shared__ int smem[];
  int* warp_buf = smem;  // 32
  int* ts = smem + 32;   // [W] the row's prefix max, for the lanes to the right
  const int bd = blockIdx.x;
  const int b = bd / D, d = bd % D;
  const int j = threadIdx.x;
  const size_t ring = (size_t)(R + 1) * W;
  short* H = use_smem ? reinterpret_cast<short*>(smem + 32 + W) : rings + (size_t)bd * 2 * ring;
  short* F = H + ring;
  const int NPRIO = 3 * P + 3;
  const int MASKC = (1 << SH) - 1, MASKF = (1 << SHF) - 1;
  const int VSH = 1 << SH, VSHF = 1 << SHF;
  // sequence-gap and stop codes; slot p's codes are computed in the loop
  const int EEXT = (NPRIO - 1 - 3 * P) << kDeltaBits;
  const int EOPEN = (NPRIO - 1 - (3 * P + 1)) << kDeltaBits;
  const int HSTOP = 0;
  const int sl = slen[bd];
  const int qc = seqp[(size_t)bd * W + j];
  const int nn = n_nodes[b];
  const int je = j * e;
  const bool cell = mode == kNW ? (j == sl) : (j != 0 && j <= sl);
  const size_t row_stride = (size_t)D * W;
  int* drow = dirs + ((size_t)b * (N + 1) * D + d) * W + j;
  const int* aux_b = aux + (size_t)b * P * N;

  // ring slot R pins the boundary row: H row 0 = [0, g, g+e, ...] (zeros in
  // sw), F row 0 = [g - e, -inf, ...] so the uniform recurrence gives a
  // start node F = g at lane 0 and -inf beyond
  H[R * W + j] = mode == kSW ? 0 : (short)(j == 0 ? 0 : g + (j - 1) * e);
  F[R * W + j] = (short)(j == 0 ? g - e : kNeg16);
  // direction row 0: E-open into lane 1, E-extend further right
  if (mode == kSW) {
    drow[0] = HSTOP;
  } else {
    const int fe = j >= 2 ? 1 << kChainBit : 0;
    drow[0] = (fe << 16) | (j == 1 ? EOPEN : EEXT);
  }
  int bestc = best_init(mode);
  __syncthreads();

  for (int hr = 1; hr <= nn; ++hr) {
    const int r = hr - 1;
    const int code = codes[(size_t)b * N + r];
    const int dg = deg[(size_t)b * N + r];
    const int prof = (qc == code ? m : x) * VSH;
    // two packed maxes over the in-edge slots: `acc` ranks, per slot,
    // F-extend then F-open (the dispatch order of H); `facc` ranks F-open
    // then F-extend (the order of the F chain). Padding slots repeat slot 0
    // at lower priorities: skipping them leaves both maxes unchanged.
    int acc = kNegV, facc = kNegV;
    for (int p = 0; p < dg; ++p) {
      const int a = aux_b[(size_t)p * N + r];
      const int delta = a & 0xFFFF;
      const short* hs = H + (size_t)(a >> 16) * W;
      const short* fs = F + (size_t)(a >> 16) * W;
      const int vext = (int)fs[j] + e, vopen = (int)hs[j] + g;
      const int diag = j == 0 ? kNegV
                              : (int)hs[j - 1] * VSH + (prof + ((NPRIO - 1 - p) << kDeltaBits) + delta);
      const int fext = vext * VSH + (((NPRIO - 1 - (P + 2 * p)) << kDeltaBits) + delta);
      const int fopen = vopen * VSH + (((NPRIO - 1 - (P + 2 * p + 1)) << kDeltaBits) + delta);
      acc = max(acc, max(diag, max(fext, fopen)));
      facc = max(facc, max(vext * VSHF + (((2 * P - 1 - (2 * p + 1)) << kDeltaBits) + delta),
                           vopen * VSHF + (((2 * P - 1 - 2 * p) << kDeltaBits) + delta)));
    }
    const int Fr = facc >> SHF, fcode = facc & MASKF;
    int A = acc >> SH, hcode = acc & MASKC;
    if (mode != kNW && j == 0) {  // sw/ov: H[i][0] = 0, never walked through
      A = 0;
      hcode = HSTOP;
    }
    const int A0 = mode == kSW ? max(A, 0) : A;
    // E[j] = max_{k<j} A0[k] + g + (j-1-k)*e: a prefix max of A0[k] - k*e,
    // read one lane to the left. Every A0 - j*e is far above the reference
    // scan's -2^30 fill, so this plain prefix max equals it on every lane.
    const int t = block_prefix_max(A0 - je, warp_buf);
    ts[j] = t;
    __syncthreads();
    const int Erow = j == 0 ? kNeg16 : ts[j - 1] + (g - e) + je;
    // EB: E extends E of the lane to the left (lanes 0 and 1 have none)
    const bool EB = j >= 2 && Erow == ts[j - 2] + (g - e) + (je - e) + e;
    int Hfin = max(A0, Erow);
    if (Erow > A0) hcode = EB ? EEXT : EOPEN;
    if (mode == kSW) {
      Hfin = max(Hfin, 0);
      if (Hfin == 0) hcode = HSTOP;
    }
    // every read of the ring slot overwritten here happened before the
    // barriers above; the clamp keeps dead lanes inside int16
    const size_t slot = (size_t)((hr - 1) % R) * W + j;
    H[slot] = (short)max(Hfin, kNeg16);
    F[slot] = (short)max(Fr, kNeg16);
    drow[(size_t)hr * row_stride] = ((fcode | ((int)EB << kChainBit)) << 16) | hcode;
    if (cell && (mode == kSW || sink[(size_t)b * N + r] != 0))
      bestc = max(bestc, Hfin * kTie + (kTie - 1 - hr));
    __syncthreads();
  }
  store_best(bestc, mode, warp_buf, bd, maxi, maxj, score);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

int poa_dp_affine_launch(const int* codes, const int* aux, const int* deg, const int* sink,
                         const int* n_nodes, const int* seqp, const int* slen, int* dirs,
                         int* maxi, int* maxj, int* score, short* rings, int B, int N, int P,
                         int D, int W, int R, int mode, int m, int x, int g, int e,
                         int use_smem, int SH, int SHF, void* stream) {
  const size_t smem = (32 + (size_t)W) * sizeof(int) +
                      (use_smem ? 2 * (size_t)(R + 1) * W * sizeof(short) : 0);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        poa_dp_affine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  poa_dp_affine_kernel<<<B * D, W, smem, (cudaStream_t)stream>>>(
      codes, aux, deg, sink, n_nodes, seqp, slen, dirs, maxi, maxj, score, rings, N, P, D, W,
      R, mode, m, x, g, e, use_smem, SH, SHF);
  return (int)cudaGetLastError();
}

int poa_walk_affine_launch(const int* dirs, const int* maxi, const int* maxj, int* pn, int* pp,
                           int* count, int B, int N1, int D, int W, int L, int P, int mode,
                           void* stream) {
  return launch_walk3<1>(dirs, maxi, maxj, pn, pp, count, B, N1, D, W, L, P, mode, stream);
}

}  // extern "C"

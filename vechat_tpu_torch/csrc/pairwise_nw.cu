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
// One block per pair, one thread per lane. The H rows live in shared
// memory (two rolling rows); the direction matrix, one int8 per cell, goes
// to a global scratch buffer the wrapper allocates, and one thread walks it
// back from the end cell. Bound by the serial row chain (a block-wide
// max-scan per row, two barriers) and by the walk's dependent loads.

#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr int kNeg = -(1 << 28);

// K3: row i = target position, lane l = diagonal offset, query position
// j = i + lo + l. Rows past the target length are never read.
__global__ void banded_kernel(
    const int* __restrict__ tcodes,  // [NP, T]
    const int* __restrict__ ext,     // [NP, BW + T]: ext[x] = q[lo + x], 0xFF outside q
    const int* __restrict__ tlen, const int* __restrict__ qlen,
    const int* __restrict__ lo,      // [NP] band low diagonal
    signed char* __restrict__ dir,   // [NP, T+1, BW] scratch
    short* __restrict__ pt, short* __restrict__ pq,  // [NP, T + BW] -2-filled
    int* __restrict__ count, int* __restrict__ dist,  // [NP]
    int T, int BW) {
  extern __shared__ int smem[];
  int* warp_buf = smem;
  int* Hs = smem + 32;  // [2, BW] rolling rows
  const int p = blockIdx.x, l = threadIdx.x, L = T + BW;
  const int lt = tlen[p], lq = qlen[p], lod = lo[p];
  const int* tc = tcodes + (size_t)p * T;
  const int* E = ext + (size_t)p * (BW + T);
  signed char* Dp = dir + (size_t)p * (T + 1) * BW;

  const int j0 = lod + l;
  Hs[l] = (j0 >= 0 && j0 <= lq) ? -j0 : kNeg;
  Dp[l] = 2;
  __syncthreads();
  for (int i = 0; i < lt; ++i) {
    const int r = i + 1;
    const int* prev = Hs + (i & 1) * BW;
    const int jv = r + lod + l;
    const int prof = E[i + l] == tc[i] ? 0 : -1;
    const int diag = jv >= 1 ? prev[l] + prof : kNeg;               // (i-1, j-1)
    const int vert = (l == BW - 1 ? kNeg : prev[l + 1]) - 1;        // (i-1, j)
    const int acc = jv == 0 ? -r : max(diag, vert);
    int run = vk::block_prefix_max(acc + l, warp_buf) - l;          // (i, j-1) chain
    if (jv < 0 || jv > lq) run = kNeg;
    // the buffer written here was last read in row i-1
    Hs[(r & 1) * BW + l] = run;
    Dp[(size_t)r * BW + l] = run == diag ? 0 : (run == vert ? 1 : 2);
    __syncthreads();
  }
  if (l != 0) return;
  const int ls = lq - lt - lod;  // lane of (tlen, qlen)
  const int* fin = Hs + (lt & 1) * BW;
  dist[p] = -((ls >= 0 && ls < BW) ? fin[ls] : kNeg);
  // walk: diag -> (i-1, l); vert -> (i-1, l+1); horiz -> (i, l-1). The step
  // bound and the clipping stop the walks of pairs that overflow the band
  short* ptp = pt + (size_t)p * L;
  short* pqp = pq + (size_t)p * L;
  const bool started = !(lt == 0 && lq == 0);
  bool ok = started;
  int i = lt, ll = ls, k = 0;
  while (ok && k < L) {
    i = min(max(i, 0), T);
    ll = min(max(ll, 0), BW - 1);
    const int dv = Dp[(size_t)i * BW + ll];
    const bool dg = dv == 0, vt = dv == 1;
    const int jq = i + lod + ll;
    const int pi = (dg || vt) ? i - 1 : i;
    const int pl = dg ? ll : (vt ? ll + 1 : ll - 1);
    ptp[L - 1 - k] = (short)(i == pi ? -1 : i - 1);
    pqp[L - 1 - k] = (short)(vt ? -1 : jq - 1);
    i = pi;
    ll = pl;
    ++k;
    ok = !(i == 0 && i + lod + ll == 0);
  }
  count[p] = started ? k : 0;
}

// K4: full NW of one tile, lane j = query position j-1 (lane 0 = the j = 0
// boundary column). Rows past the target length are never read.
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

int banded_launch(const int* tcodes, const int* ext, const int* tlen, const int* qlen,
                  const int* lo, signed char* dir, short* pt, short* pq, int* count,
                  int* dist, int NP, int T, int BW, void* stream) {
  const size_t smem = (32 + 2 * (size_t)BW) * sizeof(int);
  banded_kernel<<<NP, BW, smem, (cudaStream_t)stream>>>(
      tcodes, ext, tlen, qlen, lo, dir, pt, pq, count, dist, T, BW);
  return (int)cudaGetLastError();
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

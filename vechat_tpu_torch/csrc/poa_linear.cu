// Linear-gap sequence-to-graph DP (K1) and its traceback walks, run-length
// (K2) and dense, for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces vechat_tpu/ops/kernels/poa_pallas.py: _dp_kernel (pallas_call in
// _poa_dp_pallas), _traceback_walk_rle and _traceback_walk. The direction codes, run markers,
// best-cell pack and run headers are the reference's bit for bit; the plain
// PyTorch versions in ops/kernels/poa_linear.py compute the same outputs.
//
// K1: one block per (window b, sequence d), one thread per lane j. Bound by
// the serial row chain (in-edge loads, then a block-wide max-scan): three
// barriers per row. The int16 H ring sits in shared memory when it fits,
// else in a global scratch ring; direction rows go out as coalesced int16
// stores.
// K2: one thread per walk; bound by one dependent dirs load per step.
// The dense walk (poa_walk_dense_kernel, the sharded route's walk) replaces
// _traceback_walk: see the note above the kernel.

#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr int kDeltaBits = 9;
constexpr int kDmask = (1 << kDeltaBits) - 1;
constexpr int kTie = 4096;
constexpr int kNegV = -(1 << 30);
constexpr int kNeg16 = -16000;
constexpr int kRunRBits = 9;
constexpr int kRunPnShift = 19;
enum { kNW = 0, kSW = 1, kOV = 2 };

__global__ void poa_dp_kernel(
    const int* __restrict__ codes,    // [B, N] node codes, rank order
    const int* __restrict__ aux,      // [B, P, N] hslot << 16 | prio << 9 | delta
    const int* __restrict__ deg,      // [B, N] true in-degree (>= 1)
    const int* __restrict__ sink,     // [B, N] 1 = no out-edges
    const int* __restrict__ n_nodes,  // [B]
    const int* __restrict__ seqp,     // [B, D, W] lane j = code of position j-1
    const int* __restrict__ slen,     // [B, D]
    short* __restrict__ dirs,         // [B, N+1, D, W] out
    int* __restrict__ maxi, int* __restrict__ maxj, int* __restrict__ score,  // [B, D]
    short* __restrict__ hring,        // [B*D, R+1, W] scratch when !use_smem
    int N, int P, int D, int W, int R, int mode, int m, int x, int g,
    int use_smem, int SH) {
  extern __shared__ int smem[];
  int* warp_buf = smem;      // 32
  int* rld_s = smem + 32;    // [2, W] run lengths of the last two rows
  const int bd = blockIdx.x;
  const int b = bd / D, d = bd % D;
  const int j = threadIdx.x;
  short* H = use_smem ? reinterpret_cast<short*>(smem + 32 + 2 * W)
                      : hring + (size_t)bd * (R + 1) * W;
  const int MASKC = (1 << SH) - 1;
  const int HORIZ = 1 << kDeltaBits;
  const int MARKER_D = (1 << (SH - kDeltaBits)) - 1;
  const int MARKER_V = MARKER_D - 1;
  const int VADJ = g * (1 << SH) - (P << kDeltaBits);
  const int sl = slen[bd];
  const int qc = seqp[(size_t)bd * W + j];
  const int nn = n_nodes[b];
  const int jg = j * g;
  const bool cell = mode == kNW ? (j == sl) : (j != 0 && j <= sl);
  const size_t row_stride = (size_t)D * W;
  short* drow = dirs + ((size_t)b * (N + 1) * D + d) * W + j;
  const int* aux_b = aux + (size_t)b * P * N;

  // slot R pins the row-0 boundary: start nodes at any rank read row 0
  H[R * W + j] = mode == kSW ? 0 : (short)jg;
  drow[0] = mode == kSW ? 0 : HORIZ;
  int bestc = mode == kSW ? 0 : kNeg16 * kTie + (kTie - 1);
  rld_s[j] = 0;
  rld_s[W + j] = 0;
  int rlv = 0;
  __syncthreads();

  for (int hr = 1; hr <= nn; ++hr) {
    const int r = hr - 1;
    const int code = codes[(size_t)b * N + r];
    const int dg = deg[(size_t)b * N + r];
    const int prof = (qc == code ? m : x) * (1 << SH);
    // padding slots repeat slot 0 at a lower priority: skipping them
    // leaves the max unchanged
    int acc = kNegV;
    for (int p = 0; p < dg; ++p) {
      const int a = aux_b[(size_t)p * N + r];
      const int dpack = a & 0xFFFF;
      const short* hs = H + (size_t)(a >> 16) * W;
      const int diag = j == 0 ? kNegV : (int)hs[j - 1] * (1 << SH) + (prof + dpack);
      const int vert = (int)hs[j] * (1 << SH) + (VADJ + dpack);
      acc = max(acc, max(diag, vert));
    }
    if (mode != kNW && j == 0) acc = 0;
    const int lv = acc >> SH;
    const int lc = acc & MASKC;
    // in-row gap: run[j] = max_{k<=j} val[k] + (j-k)*g
    int run = vk::block_prefix_max(lv - jg, warp_buf) + jg;
    if (mode == kSW) run = max(run, 0);
    // horizontal loses every tie (last in reference priority order)
    int dcode = run == lv ? lc : HORIZ;
    if (mode == kSW && run == 0) dcode = 0;
    // run markers: a diagonal unit-delta chain continues the previous
    // row's chain one lane to the left, a vertical one the same lane
    const int pr = dcode >> kDeltaBits, dl = dcode & kDmask;
    const bool isd1 = pr >= P + 2 && dl == 1;
    const bool isv1 = pr >= 2 && pr <= P + 1 && dl == 1;
    const int* rld_prev = rld_s + ((hr - 1) & 1) * W;
    const int rld = isd1 ? min(rld_prev[j == 0 ? W - 1 : j - 1] + 1, kDmask) : 0;
    rlv = isv1 ? min(rlv + 1, kDmask) : 0;
    if (isd1) dcode = (MARKER_D << kDeltaBits) | rld;
    if (isv1) dcode = (MARKER_V << kDeltaBits) | rlv;
    // every read of the ring slot overwritten here happened before the
    // scan's barriers
    H[(size_t)((hr - 1) % R) * W + j] = (short)run;
    rld_s[(hr & 1) * W + j] = rld;
    drow[(size_t)hr * row_stride] = (short)dcode;
    if (cell && (mode == kSW || sink[(size_t)b * N + r] != 0))
      bestc = max(bestc, run * kTie + (kTie - 1 - hr));
    __syncthreads();
  }

  // best cell: highest score, then lowest row (packed), then lowest lane
  const int best = vk::block_reduce(bestc, warp_buf, false);
  const int jpick = vk::block_reduce(bestc == best ? j : INT_MAX, warp_buf, true);
  if (j == 0) {
    const int s = best >> 12;
    const int ipick = (kTie - 1) - (best & (kTie - 1));
    const bool empty = mode == kSW ? s <= 0 : ipick == 0;
    maxi[bd] = empty ? 0 : ipick;
    maxj[bd] = empty ? 0 : jpick;
    score[bd] = s;
  }
}

__global__ void poa_walk_kernel(
    const short* __restrict__ dirs,  // [B, N1, D, W]
    const int* __restrict__ maxi, const int* __restrict__ maxj,  // [B, D]
    int* __restrict__ runs,          // [L, B*D] zero-filled
    int* __restrict__ count,         // [B, D]
    int* __restrict__ steps,         // [1] zero-filled: max headers per walk
    int B, int N1, int D, int W, int L, int P, int mode) {
  const int BD = B * D;
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= BD) return;
  const int b = w / D, d = w % D;
  const int pb = 32 - __clz(2 * P + 3);  // ceil(log2(2P + 4))
  const int MARKER_D = (1 << pb) - 1, MARKER_V = MARKER_D - 1;
  const short* base = dirs + (size_t)b * N1 * D * W + (size_t)d * W;
  const size_t row_stride = (size_t)D * W;
  int i = maxi[w], j = maxj[w];
  const bool started = !(i == 0 && j == 0);
  bool active = mode == kOV ? (started && i != 0 && j != 0) : started;
  int cnt = 0, step = 0;
  while (active && step < L) {
    const int code = base[(size_t)i * row_stride + j];
    const int pr = code >> kDeltaBits, dl = code & kDmask;
    if (mode == kSW && pr == 0) break;
    const bool mrkd = pr == MARKER_D, mrkv = pr == MARKER_V;
    const bool is_run = mrkd || mrkv;
    const bool is_diag = (pr >= P + 2 && pr < MARKER_V) || mrkd;
    const bool is_vert = (pr >= 2 && pr <= P + 1) || mrkv;
    const bool moves = is_diag || is_vert;
    const int delta = is_run ? 1 : dl;
    const int rl = is_run ? dl : 1;
    int pi1 = moves ? i - delta : i;
    if (delta == 0) pi1 = moves ? 0 : i;
    const int pj1 = (is_diag || !is_vert) ? j - 1 : j;
    const int pn0 = pi1 == i ? -1 : i - 1;
    const int pp0 = pj1 == j ? -1 : j - 1;
    runs[(size_t)step * BD + w] = ((pn0 + 2) << kRunPnShift) | ((pp0 + 2) << kRunRBits) | rl;
    i = is_run ? i - rl : pi1;
    j = (is_run && is_diag) ? j - rl : pj1;
    cnt += rl;
    ++step;
    if (mode == kNW) active = !(i == 0 && j == 0);
    else if (mode == kOV) active = !(i == 0 || j == 0);
  }
  count[w] = started ? cnt : 0;
  if (step) atomicMax(steps, step);
}

// The dense walk: one (rank, position) pair a step, written back to front
// into pn/pp [B*D, L] int16, so that walk w's pairs are its last count[w]
// columns; every column before them holds -2. Replaces _traceback_walk of
// poa_pallas.py (all walks stepping together, one gather a step). One thread
// per walk, one warp per block: the walk is a chain of dependent int16 loads
// (bound by load latency, not by bytes), so the blocks are small to spread
// the chains over the SMs, and the warp then fills its 32 walks' unused
// columns with coalesced stores. A run marker is read as the unit move it
// stands for. With node_id != nullptr pn holds node ids, else DP ranks.
constexpr int kDenseThreads = 32;

__global__ void poa_walk_dense_kernel(
    const short* __restrict__ dirs,  // [B, N1, D, W]
    const int* __restrict__ maxi, const int* __restrict__ maxj,  // [B, D]
    const int* __restrict__ node_id,  // [B, N1 - 1] or nullptr
    short* __restrict__ pn, short* __restrict__ pp,  // [B*D, L]
    int* __restrict__ count,                         // [B, D]
    int B, int N1, int D, int W, int L, int P, int mode) {
  __shared__ int used[kDenseThreads];
  const int BD = B * D;
  const int w = blockIdx.x * kDenseThreads + threadIdx.x;
  int step = 0;
  if (w < BD) {
    const int b = w / D, d = w % D;
    const int pb = 32 - __clz(2 * P + 3);  // ceil(log2(2P + 4))
    const int MARKER_D = (1 << pb) - 1, MARKER_V = MARKER_D - 1;
    const short* base = dirs + (size_t)b * N1 * D * W + (size_t)d * W;
    const int* nid = node_id ? node_id + (size_t)b * (N1 - 1) : nullptr;
    const size_t row_stride = (size_t)D * W;
    short* pn_w = pn + (size_t)w * L;
    short* pp_w = pp + (size_t)w * L;
    int i = maxi[w], j = maxj[w];
    const bool started = !(i == 0 && j == 0);
    bool active = mode == kOV ? (started && i != 0 && j != 0) : started;
    while (active && step < L) {
      const int code = base[(size_t)i * row_stride + j];
      const int pr = code >> kDeltaBits, dl = code & kDmask;
      if (mode == kSW && pr == 0) break;
      const bool mrkd = pr == MARKER_D, mrkv = pr == MARKER_V;
      const bool is_diag = (pr >= P + 2 && pr < MARKER_V) || mrkd;
      const bool is_vert = (pr >= 2 && pr <= P + 1) || mrkv;
      const bool moves = is_diag || is_vert;
      const int delta = (mrkd || mrkv) ? 1 : dl;
      int pi = moves ? i - delta : i;
      if (delta == 0) pi = moves ? 0 : i;  // delta 0: the predecessor is row 0
      const int pj = (is_diag || !is_vert) ? j - 1 : j;
      const int rank = i - 1;
      pn_w[L - 1 - step] = pi == i ? -1 : (short)(nid && rank >= 0 ? nid[rank] : rank);
      pp_w[L - 1 - step] = pj == j ? -1 : (short)(j - 1);
      i = pi;
      j = pj;
      ++step;
      if (mode == kNW) active = !(i == 0 && j == 0);
      else if (mode == kOV) active = !(i == 0 || j == 0);
    }
    count[w] = started ? step : 0;
  }
  used[threadIdx.x] = step;
  __syncthreads();
  const int w0 = blockIdx.x * kDenseThreads;
  for (int k = 0; k < kDenseThreads && w0 + k < BD; ++k) {
    const int fill = L - used[k];
    short* pn_k = pn + (size_t)(w0 + k) * L;
    short* pp_k = pp + (size_t)(w0 + k) * L;
    for (int c = threadIdx.x; c < fill; c += kDenseThreads) {
      pn_k[c] = -2;
      pp_k[c] = -2;
    }
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

int poa_dp_launch(const int* codes, const int* aux, const int* deg, const int* sink,
                  const int* n_nodes, const int* seqp, const int* slen, short* dirs,
                  int* maxi, int* maxj, int* score, short* hring, int B, int N, int P,
                  int D, int W, int R, int mode, int m, int x, int g, int use_smem, int SH,
                  void* stream) {
  const size_t smem = (32 + 2 * (size_t)W) * sizeof(int) +
                      (use_smem ? (size_t)(R + 1) * W * sizeof(short) : 0);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        poa_dp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  poa_dp_kernel<<<B * D, W, smem, (cudaStream_t)stream>>>(
      codes, aux, deg, sink, n_nodes, seqp, slen, dirs, maxi, maxj, score, hring, N, P, D,
      W, R, mode, m, x, g, use_smem, SH);
  return (int)cudaGetLastError();
}

int poa_walk_launch(const short* dirs, const int* maxi, const int* maxj, int* runs,
                    int* count, int* steps, int B, int N1, int D, int W, int L, int P,
                    int mode, void* stream) {
  const int threads = 128;
  const int blocks = (B * D + threads - 1) / threads;
  poa_walk_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      dirs, maxi, maxj, runs, count, steps, B, N1, D, W, L, P, mode);
  return (int)cudaGetLastError();
}

int poa_walk_dense_launch(const short* dirs, const int* maxi, const int* maxj,
                          const int* node_id, short* pn, short* pp, int* count, int B,
                          int N1, int D, int W, int L, int P, int mode, void* stream) {
  const int blocks = (B * D + kDenseThreads - 1) / kDenseThreads;
  poa_walk_dense_kernel<<<blocks, kDenseThreads, 0, (cudaStream_t)stream>>>(
      dirs, maxi, maxj, node_id, pn, pp, count, B, N1, D, W, L, P, mode);
  return (int)cudaGetLastError();
}

}  // extern "C"

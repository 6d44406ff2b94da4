// The full-matrix linear-gap sequence-to-graph DP of B10 and its traceback
// for Hopper (sm_90a), with a plain C interface for ctypes: F1, the int32 H
// matrix of one window a block; F2, the best cell and the walk of one
// window a warp.
//
// Replaces vechat_tpu/ops/kernels/poa_jax.py: poa_align_batch_device, plain
// XLA there (no pallas_call): a fori_loop over the DP rows with the in-row
// gap as a cummax, the best-cell selection as masked argmaxes, and a
// batched traceback fori_loop of L steps with an active mask. The plain
// PyTorch versions in ops/kernels/poa_full.py follow those loops; both give
// the same pairs, counts and scores, word for word.
//
// F1 (poa_full_dp_kernel): thread j of the block owns column j of every
// row (blockDim = S + 1 rounded up to a warp). Row n + 1 (rank n):
//   * each predecessor slot's row p (rank + 1; slots equal to slot 0 are
//     repeats and skipped): diag = H[p][j-1] + (seq[j-1] == code ? m : x),
//     vert = H[p][j] + g; column 0 takes max_p H[p][0] + g in nw, 0 else
//   * the in-row gap H[j] = max(H[j-1] + g, cand[j]) as an inclusive
//     max-scan of t[j] = cand[j] - j*g: five __shfl_up_sync steps in the
//     warp, lane 31 publishes the warp's total in shared memory, one
//     __syncthreads, each warp takes the maximum of the totals to its left
//     (one shared load a lane and five __shfl_xor_sync); H[j] = max(scan,
//     carry) + j*g, clamped at 0 in sw
//   * the row just computed stays in registers: the thread's own column
//     and its left neighbour's (a shuffle, or at lane 0 the carry, which
//     is that column's scan). A predecessor that is the row before takes
//     them; any older row is read from global memory, where it was stored
//     at least one barrier ago. So the block passes one barrier a row, the
//     warps' totals double-buffered by the row's parity.
// Rows past n_nodes and columns past seq_len are not computed: no result
// reads them (a column depends on columns to its left only, a row on
// earlier rows only).
//
// F2 (poa_full_walk_kernel): one warp a window. The best cell is the first
// maximal one in (rank, column) order among the mode's cells (nw: the sink
// rows at column seq_len; ov: the sink rows' cells 1..seq_len; sw: every
// cell of the real rows); lane l scans the columns l + 1, l + 33, ... of
// each row (rank by rank: its cells in flat order) keeping its first strict
// maximum, then five shuffle steps keep the larger value, the
// lower flat index (rank * S + column - 1) on a tie. With no cell above the
// reference's -2^30 the best is cell 0 at -2^30, as its argmax gives; in
// sw a best score <= 0 starts no walk. A walk step: lane s < P tests
// diagonal slot s (h == H[p][j-1] + match) and vertical slot s (h == H[p][j]
// + g), a ballot of each, __ffs picks the first true slot, diagonal before
// vertical before horizontal (h == H[i][j-1] + g); none gives diagonal
// slot 0, the reference's argmax. Lane 0 writes the pair (node id | -1,
// j - 1 | -1) at L - 1 - k. The walk ends when (0, 0) is reached (nw), i or
// j is 0 (ov) or H is 0 (sw), at its exact step count; then the lanes
// write -2 over the columns before its pairs.
//
// What bounds them: F1 is one chain a row (the predecessors' loads, the
// five shuffle steps, the barrier, the carry's reduction), n_nodes rows a
// window, one block (at most 24 warps) a window: a batch of 64 windows
// fills 64 of the 132 SMs. F2 is one chain of dependent loads a step (the
// cell, the node's predecessors, their cells). Neither bytes nor
// operations come near the card's rates (chip_smoke.py, phase 9).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNeg = -(1 << 30);  // the reference's NEG
constexpr int kMaxThreads = 1024;

template <int MODE>  // 0 nw, 1 sw, 2 ov
__global__ void __launch_bounds__(kMaxThreads)
poa_full_dp_kernel(const uint8_t* __restrict__ codes, const int* __restrict__ preds,
                   const int* __restrict__ n_nodes, const uint8_t* __restrict__ seq,
                   const int* __restrict__ seq_len, int* __restrict__ H, int N, int P, int S,
                   int m, int x, int g) {
  __shared__ int totals[2][32];
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5;
  const int W = S + 1;
  const int nn = min(max(n_nodes[b], 0), N);
  const int slen = min(max(seq_len[b], 0), S);
  const bool live = j <= slen;
  int* Hb = H + (size_t)b * (N + 1) * W;
  const int* pb = preds + (size_t)b * N * P;
  const uint8_t* cb = codes + (size_t)b * N;
  const int jg = j * g;
  const int sq = (j >= 1 && live) ? (int)seq[(size_t)b * S + j - 1] : -1;

  // row 0; `cur` and `left` hold the previous row's H[j] and H[j-1]
  int cur = MODE == 1 ? 0 : jg;
  int left = (MODE == 1 || j == 0) ? 0 : jg - g;
  if (live) Hb[j] = cur;
  __syncthreads();

  for (int n = 0; n < nn; ++n) {
    const int* pr = pb + (size_t)n * P;
    int t = INT_MIN;
    if (live) {
      const int prof = sq == (int)cb[n] ? m : x;
      const int p0 = min(max(pr[0], 0), N);
      int best = INT_MIN;
      for (int s = 0; s < P; ++s) {
        const int p = s == 0 ? p0 : min(max(pr[s], 0), N);
        if (s > 0 && p == p0) continue;  // a repeat of slot 0
        int a, v;
        if (p == n) {  // the row before: in registers
          a = left;
          v = cur;
        } else {
          const int* row = Hb + (size_t)p * W;
          v = row[j];
          a = j ? row[j - 1] : 0;
        }
        best = j ? max(best, max(a + prof, v + g)) : max(best, v);
      }
      const int full = j ? best : (MODE == 0 ? best + g : 0);
      t = full - jg;
    }
    // the in-row gap: an inclusive max-scan of t over the block
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, t, o);
      if (lane >= o) t = max(t, u);
    }
    int* tot = totals[n & 1];
    if (lane == 31) tot[warp] = t;
    __syncthreads();
    int carry = lane < warp ? tot[lane] : INT_MIN;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) carry = max(carry, __shfl_xor_sync(kFull, carry, o));
    int run = max(t, carry) + jg;
    if (MODE == 1) run = max(run, 0);
    if (live) Hb[(size_t)(n + 1) * W + j] = run;
    // this row becomes the previous one: its H[j - 1] from the left lane,
    // or at lane 0 from the carry (the scan through column j - 1)
    const int up = __shfl_up_sync(kFull, run, 1);
    if (lane > 0) {
      left = up;
    } else if (warp > 0) {
      left = carry + jg - g;
      if (MODE == 1) left = max(left, 0);
    }
    cur = run;
  }
}

template <int MODE>
__global__ void poa_full_walk_kernel(const int* __restrict__ H, const uint8_t* __restrict__ codes,
                                     const int* __restrict__ preds,
                                     const int* __restrict__ node_id,
                                     const uint8_t* __restrict__ is_sink,
                                     const int* __restrict__ n_nodes,
                                     const uint8_t* __restrict__ seq,
                                     const int* __restrict__ seq_len, int* __restrict__ pairs,
                                     int* __restrict__ count, int* __restrict__ score, int B,
                                     int N, int P, int S, int m, int x, int g) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;
  const int W = S + 1;
  const int L = N + S + 1;
  const int nn = min(max(n_nodes[b], 0), N);
  const int slen = min(max(seq_len[b], 0), S);
  const int* Hb = H + (size_t)b * (N + 1) * W;
  const uint8_t* sink = is_sink + (size_t)b * N;
  const uint8_t* cb = codes + (size_t)b * N;
  const uint8_t* sb = seq + (size_t)b * S;
  const int* pb = preds + (size_t)b * N * P;
  const int* nid = node_id + (size_t)b * N;
  int* out = pairs + (size_t)b * L * 2;

  // the best cell: each lane's first strict maximum over its cells, then
  // the warp's largest value at the lowest flat index
  int bv = kNeg;
  long long bi = 0;
  if (MODE == 0) {
    for (int r = lane; r < nn; r += 32) {
      if (!sink[r]) continue;
      const int v = Hb[(size_t)(r + 1) * W + slen];
      if (v > bv) { bv = v; bi = r; }
    }
  } else {
    // a lane's cells in flat order: row by row, its columns of each
    for (int r = 0; r < nn; ++r) {
      if (MODE == 2 && !sink[r]) continue;
      const int* row = Hb + (size_t)(r + 1) * W;
      for (int jj = lane + 1; jj <= slen; jj += 32) {
        const int v = row[jj];
        if (v > bv) { bv = v; bi = (long long)r * S + jj - 1; }
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int ov = __shfl_xor_sync(kFull, bv, o);
    const long long oi = __shfl_xor_sync(kFull, bi, o);
    if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
  }
  int i, j;
  if (MODE == 0) {
    i = (int)bi + 1;
    j = slen;
  } else {
    i = (int)(bi / S) + 1;
    j = (int)(bi % S) + 1;
    if (MODE == 1 && bv <= 0) i = j = 0;  // no positive cell: no walk
  }
  const bool empty = i == 0 && j == 0;

  int k = 0;
  int h = Hb[(size_t)i * W + j];
  bool active = !empty && (MODE == 0 ? true : MODE == 2 ? (i != 0 && j != 0) : h != 0);
  while (active && k < L) {
    const int node = max(i - 1, 0);
    const int jm1 = max(j - 1, 0);
    const int mc = sb[jm1] == cb[node] ? m : x;
    const int* rowi = Hb + (size_t)i * W;
    int p = 0;
    bool d_ok = false, v_ok = false;
    if (lane < P) {
      p = min(max(pb[(size_t)node * P + lane], 0), N);
      const int* row = Hb + (size_t)p * W;
      d_ok = i != 0 && j != 0 && h == row[jm1] + mc;
      v_ok = i != 0 && h == row[j] + g;
    }
    const unsigned bd = __ballot_sync(kFull, d_ok);
    const unsigned bvv = __ballot_sync(kFull, v_ok);
    int pi, pj;
    if (bd) {
      pi = __shfl_sync(kFull, p, __ffs(bd) - 1);
      pj = j - 1;
    } else if (bvv) {
      pi = __shfl_sync(kFull, p, __ffs(bvv) - 1);
      pj = j;
    } else if (j != 0 && h == rowi[jm1] + g) {
      pi = i;
      pj = j - 1;
    } else {  // none: diagonal slot 0, as the reference's argmax
      pi = __shfl_sync(kFull, p, 0);
      pj = j - 1;
    }
    if (lane == 0) {
      int2 pr;
      pr.x = pi == i ? -1 : nid[node];
      pr.y = pj == j ? -1 : j - 1;
      reinterpret_cast<int2*>(out)[L - 1 - k] = pr;
    }
    ++k;
    i = pi;
    j = max(pj, 0);
    if (MODE == 0) {
      active = !(i == 0 && j == 0);
      h = Hb[(size_t)i * W + j];
    } else if (MODE == 2) {
      active = i != 0 && j != 0;
      h = Hb[(size_t)i * W + j];
    } else {
      h = Hb[(size_t)i * W + j];
      active = h != 0;
    }
  }
  for (int c = lane; c < L - k; c += 32) reinterpret_cast<int2*>(out)[c] = make_int2(-2, -2);
  if (lane == 0) {
    count[b] = k;
    score[b] = bv;
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// F1 on one window a block; mode 0 nw, 1 sw, 2 ov. Refuses S + 1 > 1024.
int poa_full_dp_launch(const uint8_t* codes, const int* preds, const int* n_nodes,
                       const uint8_t* seq, const int* seq_len, int* H, int B, int N, int P, int S,
                       int mode, int m, int x, int g, void* stream) {
  if (S + 1 > kMaxThreads || P < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const int threads = (S + 1 + 31) / 32 * 32;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 0)
    poa_full_dp_kernel<0><<<B, threads, 0, st>>>(codes, preds, n_nodes, seq, seq_len, H, N, P, S,
                                                 m, x, g);
  else if (mode == 1)
    poa_full_dp_kernel<1><<<B, threads, 0, st>>>(codes, preds, n_nodes, seq, seq_len, H, N, P, S,
                                                 m, x, g);
  else
    poa_full_dp_kernel<2><<<B, threads, 0, st>>>(codes, preds, n_nodes, seq, seq_len, H, N, P, S,
                                                 m, x, g);
  return (int)cudaGetLastError();
}

// F2 on one window a warp, 4 warps a block. Refuses P > 32.
int poa_full_walk_launch(const int* H, const uint8_t* codes, const int* preds, const int* node_id,
                         const uint8_t* is_sink, const int* n_nodes, const uint8_t* seq,
                         const int* seq_len, int* pairs, int* count, int* score, int B, int N,
                         int P, int S, int mode, int m, int x, int g, void* stream) {
  if (P < 1 || P > 32 || B < 1) return (int)cudaErrorInvalidValue;
  const int warps = 4;
  const int blocks = (B + warps - 1) / warps;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 0)
    poa_full_walk_kernel<0><<<blocks, warps * 32, 0, st>>>(H, codes, preds, node_id, is_sink,
                                                           n_nodes, seq, seq_len, pairs, count,
                                                           score, B, N, P, S, m, x, g);
  else if (mode == 1)
    poa_full_walk_kernel<1><<<blocks, warps * 32, 0, st>>>(H, codes, preds, node_id, is_sink,
                                                           n_nodes, seq, seq_len, pairs, count,
                                                           score, B, N, P, S, m, x, g);
  else
    poa_full_walk_kernel<2><<<blocks, warps * 32, 0, st>>>(H, codes, preds, node_id, is_sink,
                                                           n_nodes, seq, seq_len, pairs, count,
                                                           score, B, N, P, S, m, x, g);
  return (int)cudaGetLastError();
}

}  // extern "C"
